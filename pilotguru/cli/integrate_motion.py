"""integrate_motion CLI: naive dead-reckoning velocity magnitudes.

Flag- and format-compatible with the reference binary
(/root/reference/src/integrate_motion.cc): integrates the raw merged IMU
streams with no calibration, debiases assuming zero start/end velocity, and
writes {"frames": [{time_usec, speed_m_s}, ...]}.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--rotations_json", required=True)
    parser.add_argument("--accelerations_json", required=True)
    parser.add_argument("--out_json", required=True)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    dtype = setup_backend(args.dtype)

    from pilotguru.calib.integrate import integrate_motion_debiased
    from pilotguru.formats import json_io, keys

    rot_times, rot_rates = json_io.read_timestamped_3d(
        args.rotations_json, keys.ROTATIONS
    )
    acc_times, accs = json_io.read_timestamped_3d(
        args.accelerations_json, keys.ACCELERATIONS
    )
    times, speeds = integrate_motion_debiased(
        rot_times, rot_rates, acc_times, accs, dtype=dtype
    )
    # The reference writes this series under the "frames" root
    # (integrate_motion.cc:113-121).
    json_io.write_timestamped_values(
        times, speeds, args.out_json, keys.FRAMES, keys.SPEED_M_S
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
