"""render_input_pixel_importance CLI: saliency-overlay video.

Flag-compatible with the reference
(/root/reference/python/render_input_pixel_importance.py): batches of video
frames run through the (first) model, |d prediction / d input| is reduced by
a channel max, bilinearly upsampled to the crop size, and blended into the
green channel. Gradients come from one jitted jax.grad program instead of
torch.autograd.
"""

from __future__ import annotations

import sys

from pilotguru.cli._common import add_dtype_flag, make_parser, setup_backend
from pilotguru.cli.predict_video import add_crop_args, load_predictor


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--out_video", required=True)
    parser.add_argument("--forward_axis_json", required=True)
    parser.add_argument("--net_settings_json", required=True)
    parser.add_argument("--in_model_weights", required=True)
    parser.add_argument("--convert_to_yuv", type=bool, default=False)
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--frames_to_skip", type=int, default=0)
    parser.add_argument("--max_out_frames", type=int, default=-1)
    parser.add_argument(
        "--saturation_gradient_magnitude", type=float, default=0.5
    )
    add_crop_args(parser)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    setup_backend(args.dtype)

    import cv2
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pilotguru.formats import json_io
    from pilotguru.ml import models
    from pilotguru.video.io import VideoWriterRgb, read_video_rgb

    net_settings = json_io.read_json(args.net_settings_json)
    predictor = load_predictor(net_settings, args.in_model_weights.split(","))
    forward_axis = json_io.read_forward_axis(args.forward_axis_json).astype(
        np.float32
    )

    variables = predictor._variables
    model = predictor._model

    @jax.jit
    def saliency(images):
        axis = jnp.broadcast_to(forward_axis, (images.shape[0], 3))

        def total_prediction(imgs):
            def one(p, s):
                return model.apply(
                    {"params": p, "batch_stats": s},
                    {models.FRAME_IMG: imgs, models.FORWARD_AXIS: axis},
                    train=False,
                )

            outs = jax.vmap(one)(variables["params"], variables["batch_stats"])
            return jnp.sum(jnp.mean(outs, axis=0))

        grad = jax.grad(total_prediction)(images)
        return jnp.max(jnp.abs(grad), axis=-1)  # [B, H, W]

    th = net_settings.get("target_height")
    tw = net_settings.get("target_width")
    crop_batch, model_batch = [], []
    rendered = 0
    with VideoWriterRgb(args.out_video) as sink:

        def flush():
            nonlocal rendered
            if not model_batch:
                return
            grads = np.asarray(saliency(jnp.asarray(np.stack(model_batch))))
            for crop_frame, g in zip(crop_batch, grads):
                g_up = cv2.resize(
                    g, (crop_frame.shape[1], crop_frame.shape[0]),
                    interpolation=cv2.INTER_LINEAR,
                )
                overlay = np.clip(
                    g_up / args.saturation_gradient_magnitude * 255.0, 0, 255
                ).astype(np.uint8)
                out = crop_frame.copy()
                out[:, :, 1] = np.maximum(out[:, :, 1], overlay)
                sink.consume(out)
                rendered += 1
            crop_batch.clear()
            model_batch.clear()

        for frame_idx, frame in read_video_rgb(args.in_video):
            if frame_idx < args.frames_to_skip:
                continue
            if args.max_out_frames > 0 and rendered >= args.max_out_frames:
                break
            h, w = frame.shape[:2]
            cropped = frame[
                args.crop_top : h - args.crop_bottom if args.crop_bottom else h,
                args.crop_left : w - args.crop_right if args.crop_right else w,
            ]
            resized = (
                cv2.resize(cropped, (tw, th), interpolation=cv2.INTER_AREA)
                if (th and tw and cropped.shape[:2] != (th, tw))
                else cropped
            )
            if args.convert_to_yuv:
                resized = cv2.cvtColor(resized, cv2.COLOR_RGB2YUV)
            crop_batch.append(cropped)
            model_batch.append(resized.astype(np.float32) / 255.0)
            if len(model_batch) == args.batch_size:
                flush()
        flush()
    print(f"Total rendered frames: {rendered}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
