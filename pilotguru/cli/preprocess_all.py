"""preprocess_all CLI: per-ride wrapper over fit_motion (+ CAN conversion).

Flag-compatible with the reference (/root/reference/python/preprocess_all.py);
the sub-tools run in-process instead of as subprocesses. --binary_dir is
accepted and ignored.
"""

from __future__ import annotations

import os
import sys

from pilotguru.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument(
        "--binary_dir", default="", help="Accepted for compatibility; unused."
    )
    parser.add_argument("--in_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--process_can_data", type=bool, default=False)
    args = parser.parse_args(argv)

    out_dir = args.out_dir or os.path.join(args.in_dir, "postprocessed")
    os.makedirs(out_dir, exist_ok=True)

    from pilotguru.cli import fit_motion, process_can_frames

    fit_motion.main(
        [
            f"--rotations_json={os.path.join(args.in_dir, 'rotations.json')}",
            f"--accelerations_json={os.path.join(args.in_dir, 'accelerations.json')}",
            f"--locations_json={os.path.join(args.in_dir, 'locations.json')}",
            f"--velocities_out_json={os.path.join(out_dir, 'velocities-imu.json')}",
            f"--steering_out_json={os.path.join(out_dir, 'steering-imu.json')}",
            f"--forward_axis_out_json={os.path.join(out_dir, 'forward.json')}",
        ]
    )
    if args.process_can_data:
        process_can_frames.main(
            [
                f"--can_frames_json={os.path.join(args.in_dir, 'can_frames.json')}",
                f"--velocities_out_json={os.path.join(out_dir, 'velocities-can.json')}",
                f"--steering_out_json={os.path.join(out_dir, 'steering-can.json')}",
            ]
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
