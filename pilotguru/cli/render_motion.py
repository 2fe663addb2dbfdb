"""render_motion CLI: tile a ride video with steering wheel + speedometer.

Flag-compatible with the reference binary
(/root/reference/src/render_motion.cc:20-62): separate left/right channels
for comparing two steering/velocity sources side by side.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--vertical_flip", action="store_true")
    parser.add_argument("--horizontal_flip", action="store_true")
    parser.add_argument("--target_video_height", type=int, default=-1)
    parser.add_argument("--target_video_width", type=int, default=-1)
    parser.add_argument("--steering_left_json", default="")
    parser.add_argument("--steering_left_units", default="steering")
    parser.add_argument("--steering_left_scale", type=float, default=90.0)
    parser.add_argument("--steering_right_json", default="")
    parser.add_argument("--steering_right_units", default="steering")
    parser.add_argument("--steering_right_scale", type=float, default=90.0)
    parser.add_argument("--velocities_json_left", default="")
    parser.add_argument("--velocities_json_right", default="")
    parser.add_argument("--steering_wheel", required=True)
    parser.add_argument("--out_video", required=True)
    parser.add_argument("--frames_to_skip", type=int, default=0)
    parser.add_argument("--max_out_frames", type=int, default=-1)
    args = parser.parse_args(argv)

    import cv2
    import numpy as np

    from pilotguru.video.io import VideoWriterRgb, read_video_rgb
    from pilotguru.video.render import MotionRenderer, load_per_frame_series

    wheel_bgr = cv2.imread(args.steering_wheel, cv2.IMREAD_COLOR)
    if wheel_bgr is None:
        raise ValueError(f"cannot read steering wheel image {args.steering_wheel}")
    wheel = cv2.cvtColor(wheel_bgr, cv2.COLOR_BGR2RGB)

    def maybe_steering(name, units, scale):
        return (
            load_per_frame_series(name, "steering", units, scale) if name else None
        )

    ms_to_kmh = 3.6
    renderer = MotionRenderer(
        wheel,
        steering_left=maybe_steering(
            args.steering_left_json, args.steering_left_units,
            args.steering_left_scale,
        ),
        steering_right=maybe_steering(
            args.steering_right_json, args.steering_right_units,
            args.steering_right_scale,
        ),
        velocities_left=(
            load_per_frame_series(
                args.velocities_json_left, "velocities", "speed_m_s", ms_to_kmh
            )
            if args.velocities_json_left
            else None
        ),
        velocities_right=(
            load_per_frame_series(
                args.velocities_json_right, "velocities", "speed_m_s", ms_to_kmh
            )
            if args.velocities_json_right
            else None
        ),
    )

    total = 0
    skipped = 0
    with VideoWriterRgb(args.out_video) as sink:
        for frame_idx, frame in read_video_rgb(
            args.in_video, args.vertical_flip, args.horizontal_flip
        ):
            if args.max_out_frames >= 0 and total >= args.max_out_frames:
                break
            if skipped < args.frames_to_skip:
                skipped += 1
                continue
            h = args.target_video_height if args.target_video_height > 0 else frame.shape[0]
            w = args.target_video_width if args.target_video_width > 0 else frame.shape[1]
            if (h, w) != frame.shape[:2]:
                frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_CUBIC)
            sink.consume(renderer.render(np.asarray(frame), frame_idx))
            total += 1
    print(f"Total rendered frames: {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
