"""interpolate_velocity CLI: upsample GPS speeds to frame timestamps.

Flag- and format-compatible with the reference binary
(/root/reference/src/interpolate_velocity.cc): penalized L1/L2 objective
(distance match + acceleration magnitude + acceleration smoothness) solved
with clipped gradient descent; writes a copy of frames.json entries with an
added speed_m_s field.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--locations_json", required=True)
    parser.add_argument("--frames_json", required=True)
    parser.add_argument("--out_json", required=True)
    parser.add_argument("--l1_weight", type=float, default=0.0)
    parser.add_argument("--l2_weight", type=float, default=0.0)
    parser.add_argument("--distance_weight", type=float, default=1.0)
    parser.add_argument("--accelerations_weight", type=float, default=1.0)
    parser.add_argument(
        "--accelerations_smoothness_weight", type=float, default=1.0
    )
    parser.add_argument("--lr", type=float, default=1e-1)
    parser.add_argument("--decay", type=float, default=1.0)
    parser.add_argument("--iters", type=int, default=1000)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    dtype = setup_backend(args.dtype)

    from pilotguru.calib.interpolate import (
        InterpolationSettings,
        interpolate_gps_velocities,
    )
    from pilotguru.formats import json_io, keys

    gps_times, gps_speeds = json_io.read_gps_velocities(args.locations_json)
    frames_root = json_io.read_json(args.frames_json)
    frames = frames_root[keys.FRAMES]
    frame_times = [f[keys.TIME_USEC] for f in frames]

    velocities = interpolate_gps_velocities(
        gps_times,
        gps_speeds,
        frame_times,
        InterpolationSettings(
            l1_weight=args.l1_weight,
            l2_weight=args.l2_weight,
            distance_weight=args.distance_weight,
            accelerations_weight=args.accelerations_weight,
            accelerations_smoothness_weight=args.accelerations_smoothness_weight,
            learning_rate=args.lr,
            learning_rate_decay=args.decay,
            iters=args.iters,
        ),
        dtype=dtype,
    )

    out_frames = []
    for frame, v in zip(frames, velocities):
        entry = dict(frame)
        entry[keys.SPEED_M_S] = float(v)
        out_frames.append(entry)
    json_io.write_json({keys.FRAMES: out_frames}, args.out_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
