"""predict_live CLI: realtime steering inference published over ZeroMQ.

Flag-compatible with the reference (/root/reference/python/predict_live.py):
camera or video frames -> crop/resize -> ensemble mean -> EMA -> {"s":
degrees} on a ZMQ PUB socket with CONFLATE=1 (latest-value-only), the same
wire contract the kia_steering_nn controller consumes
(src/kia_steering_nn.cc:22-35, src/nn_comm/nn_comm.cc:53-55).

Differences: the preview window (--show_preview) is off by default for
headless use; ride logging writes via cv2 instead of scikit-video; camera
capture runs on a daemon thread through a latest-value cell (conflation on
the input side, matching the CONFLATE output socket), while file sources
process every frame synchronously.
"""

from __future__ import annotations

import sys
import time

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend
from pilotguru.cli.predict_video import add_crop_args, load_predictor


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video_device_id", type=int, default=None)
    parser.add_argument("--in_video_file", default=None)
    parser.add_argument("--delay_max_fps", type=float, default=-1)
    parser.add_argument("--skip_max_fps", type=float, default=-1)
    parser.add_argument("--forward_axis_json", required=True)
    parser.add_argument("--net_settings_json", required=True)
    parser.add_argument("--in_model_weights", required=True)
    parser.add_argument("--convert_to_yuv", type=bool, default=False)
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--trajectory_frame_update_rate", type=float, default=1.0)
    parser.add_argument(
        "--prediction_units_to_degrees_scale", type=float, default=90.0
    )
    parser.add_argument(
        "--steering_prediction_socket", default="ipc:///tmp/steering-predict"
    )
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--show_preview", type=bool, default=False)
    parser.add_argument(
        "--max_frames", type=int, default=-1,
        help="Stop after N frames (testing hook; <0 = run forever).",
    )
    add_crop_args(parser)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    setup_backend(args.dtype)

    import cv2
    import numpy as np
    import zmq

    from pilotguru.formats import json_io
    from pilotguru.ml import models
    from pilotguru.ml.prediction import (
        frame_to_model_input,
        update_future_trajectory_prediction,
    )

    context = zmq.Context()
    socket = context.socket(zmq.PUB)
    # Latest-value-only: a stale prediction must never queue behind a fresh
    # one (predict_live.py:52-59).
    socket.setsockopt(zmq.CONFLATE, 1)
    socket.bind(args.steering_prediction_socket)

    net_settings = json_io.read_json(args.net_settings_json)
    predictor = load_predictor(net_settings, args.in_model_weights.split(","))
    forward_axis = json_io.read_forward_axis(args.forward_axis_json).astype(
        np.float32
    )[None, :]

    if args.in_video_device_id is not None:
        capture = cv2.VideoCapture(args.in_video_device_id)
    elif args.in_video_file:
        capture = cv2.VideoCapture(args.in_video_file)
    else:
        parser.error("one of --in_video_device_id / --in_video_file is required")
    if not capture.isOpened():
        raise ValueError("cannot open video source")

    log_writer = None
    log_frames = []
    if args.log_dir:
        import os

        os.makedirs(args.log_dir, exist_ok=True)

    # Camera sources capture on a daemon thread into a latest-value cell:
    # inference always sees the FRESHEST frame instead of draining the
    # capture queue with stale ones (same conflation semantics as the ZMQ
    # socket; reference threading_helpers.py:3-27). File sources stay
    # synchronous so every frame is processed deterministically.
    live_camera = args.in_video_device_id is not None
    latest_frame = None
    if live_camera:
        import threading

        from pilotguru.utils.latest_value import SynchronizedLatestValue

        latest_frame = SynchronizedLatestValue()

        def capture_loop():
            while True:
                ok, bgr = capture.read()
                if not ok:
                    latest_frame.set(None)
                    return
                latest_frame.set(bgr)

        threading.Thread(target=capture_loop, daemon=True).start()

    trajectory = None
    frame_interval = 1.0 / args.delay_max_fps if args.delay_max_fps > 0 else 0.0
    skip_interval = 1.0 / args.skip_max_fps if args.skip_max_fps > 0 else 0.0
    last_time = 0.0
    last_kept = 0.0
    frames_done = 0
    last_update_id = 0
    print("Live prediction started.")
    while args.max_frames < 0 or frames_done < args.max_frames:
        if live_camera:
            bgr, last_update_id = latest_frame.get_next(
                last_update_id, timeout=5.0
            )
            ok = bgr is not None
        else:
            ok, bgr = capture.read()
        if not ok:
            break
        now = time.time()
        if frame_interval > 0:
            remaining = frame_interval - (now - last_time)
            if remaining > 0:
                time.sleep(remaining)
            now = time.time()
        last_time = now
        if skip_interval > 0 and (now - last_kept) < skip_interval:
            continue
        last_kept = now

        frame = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        model_input, display = frame_to_model_input(
            frame,
            crop_top=args.crop_top,
            crop_bottom=args.crop_bottom,
            crop_left=args.crop_left,
            crop_right=args.crop_right,
            target_height=net_settings.get("target_height"),
            target_width=net_settings.get("target_width"),
            convert_to_yuv=args.convert_to_yuv,
        )
        prediction = predictor(
            {models.FRAME_IMG: model_input, models.FORWARD_AXIS: forward_axis}
        )
        trajectory = update_future_trajectory_prediction(
            trajectory, prediction, args.trajectory_frame_update_rate
        )
        degrees = float(trajectory[0, 0]) * args.prediction_units_to_degrees_scale
        socket.send_json({"s": degrees})
        frames_done += 1

        if args.log_dir:
            if log_writer is None:
                from pilotguru.video.io import VideoWriterRgb

                log_writer = VideoWriterRgb(f"{args.log_dir}/video.mp4", 30.0)
            log_writer.consume(frame)
            log_frames.append(
                {"frame_id": len(log_frames), "time_usec": int(now * 1e6)}
            )
        if args.show_preview:
            cv2.imshow("frame", cv2.cvtColor(display, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break

    capture.release()
    if log_writer is not None:
        log_writer.close()
        json_io.write_json({"frames": log_frames}, f"{args.log_dir}/frames.json")
    if args.show_preview:
        cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
