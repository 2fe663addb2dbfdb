"""optical_trajectories CLI: monocular visual odometry over a ride video.

Flag-compatible with the reference binary
(/root/reference/src/optical_trajectories.cc:36-62). Differences:
--vocabulary_file is parsed and validated but its index is unused (DBoW2
vocabulary indexing is replaced by exhaustive descriptor matching, and
the substitution is logged); --visualize writes an
offline overlay video per segment (tracked features + status) instead of
the reference's live Pangolin windows (headless image).
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument(
        "--vocabulary_file",
        default="",
        help=(
            "DBoW2 ORB vocabulary (ORBvoc.txt). Parsed and VALIDATED for "
            "compatibility with the reference CLI; its index is replaced "
            "by exhaustive Hamming matching, so the content is unused "
            "(vo/vocabulary.py)."
        ),
    )
    parser.add_argument("--camera_settings", required=True)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--vertical_flip", action="store_true")
    parser.add_argument("--horizontal_flip", action="store_true")
    parser.add_argument(
        "--visualize",
        action="store_true",
        help=(
            "Write a visualize-NNNN.mp4 overlay video per segment (tracked "
            "features + tracker status) — offline stand-in for the "
            "reference's live viewer (optical_trajectories.cc:47)."
        ),
    )
    parser.add_argument(
        "--output_per_segment_videos",
        action="store_true",
        help=(
            "Write trajectory-NNNN.mp4 per tracked segment; JSON frame ids "
            "then index into the segment video "
            "(optical_trajectories.cc:53-57)."
        ),
    )
    parser.add_argument(
        "--visualize_live_port",
        type=int,
        default=None,
        help=(
            "Serve a LIVE tracking view over HTTP while the ride tracks "
            "(MJPEG overlay stream + top-down map, vo/viewer.py) — the "
            "runtime equivalent of the reference's Pangolin FrameDrawer/"
            "MapDrawer windows (Viewer.cc) in a headless image. 0 binds "
            "an ephemeral port (printed on startup)."
        ),
    )
    parser.add_argument("--rotation_smooth_sigma", type=int, default=0)
    parser.add_argument(
        "--image_scale",
        type=float,
        default=1.0,
        help="Optional downscale factor applied before tracking.",
    )
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    setup_backend(args.dtype)

    if args.vocabulary_file:
        # Honor the reference flag's contract: a given vocabulary must load
        # (bad paths/files fail, System.cc "Wrong path to vocabulary"), but
        # its index is replaced by exhaustive matching — say so loudly
        # rather than silently voiding the flag.
        from pilotguru.vo.vocabulary import validate_dbow2_vocabulary

        info = validate_dbow2_vocabulary(args.vocabulary_file, max_nodes=512)
        print(
            f"vocabulary {args.vocabulary_file}: valid DBoW2 "
            f"(k={info.branching_factor}, L={info.depth_levels}, "
            f"{info.num_nodes} nodes). NOTE: the index is NOT used — loop "
            "detection/relocalization run exhaustive Hamming matching "
            "instead (design cut, see pilotguru/vo/vocabulary.py).",
            file=sys.stderr,
        )

    from pilotguru.vo.camera import read_camera_settings
    from pilotguru.vo.pipeline import track_video_segments, video_frames

    settings = read_camera_settings(args.camera_settings)
    frames = video_frames(
        args.in_video,
        vertical_flip=args.vertical_flip,
        horizontal_flip=args.horizontal_flip,
        scale=args.image_scale,
    )
    segments, consumed = track_video_segments(
        frames,
        settings,
        args.out_dir,
        rotation_smooth_sigma=args.rotation_smooth_sigma,
        image_scale=args.image_scale,
        per_segment_videos=args.output_per_segment_videos,
        visualize=args.visualize,
        live_view_port=args.visualize_live_port,
    )
    print(f"{segments} trajectory segment(s) from {consumed} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
