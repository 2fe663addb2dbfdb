"""train CLI: steering-model ensemble training on npz datasets.

Flag-compatible with the reference (/root/reference/python/train.py:13-70),
including the JSON-encoded nested settings flags (--net_options,
--linear_bias_options, --sample_weighter_options). Differences:

- checkpoints are flax msgpack with the reference naming stem
  (model-{i}-{best,last}.msgpack instead of .pth);
- the --num_nets_to_train ensemble trains as one vmapped device program;
- augmentation runs on-device inside the jitted train step;
- --cuda_device_id is accepted and ignored (device placement is JAX's).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from pilotguru.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--data_dirs", required=True)
    parser.add_argument("--validation_data_dirs", required=True)
    parser.add_argument("--data_file_suffix", default="data.npz")
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--batch_use_prob", type=float, default=1.0)
    parser.add_argument("--epochs", type=int, required=True)
    parser.add_argument("--optimizer", default="sgd")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--loss_norm_pow", type=float, default=2.0)
    parser.add_argument("--plateau_patience_epochs", type=int, default=0)
    parser.add_argument("--in_channels", type=int, default=3)
    parser.add_argument("--target_height", type=int, required=True)
    parser.add_argument("--target_width", type=int, required=True)
    parser.add_argument("--net_name", default="nvidia")
    parser.add_argument("--net_input_names", default="frame_img,forward_axis")
    parser.add_argument("--net_label_names", default="steering")
    parser.add_argument("--net_head_dims", type=int, default=10)
    parser.add_argument(
        "--linear_bias_options",
        default=json.dumps([{"input_name": "forward_axis", "input_dims": 3}]),
    )
    parser.add_argument("--num_nets_to_train", type=int, default=1)
    parser.add_argument(
        "--net_options",
        default=json.dumps(
            {
                "conv": {"batchnorm": True, "activation": "relu", "dropout": "2d"},
                "fc": {"batchnorm": True, "activation": "relu", "dropout": "vanilla"},
            }
        ),
    )
    parser.add_argument("--label_dimensions", type=int, default=1)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--log_dir", default="")
    parser.add_argument("--base_preload_dir", default=None)
    parser.add_argument("--dropout_prob", type=float, default=0.0)
    parser.add_argument("--max_horizontal_shift_pixels", type=int, default=0)
    parser.add_argument("--horizontal_label_shift_rate", default="0.0")
    parser.add_argument("--train_blur_sigma", type=float, default=2.0)
    parser.add_argument("--train_blur_prob", type=float, default=0.0)
    parser.add_argument("--do_pca_random_shifts", type=bool, default=False)
    parser.add_argument("--grayscale_interpolate_prob", type=float, default=0.0)
    parser.add_argument(
        "--sample_weighter_options", default=json.dumps({"name": "uniform"})
    )
    parser.add_argument("--dry_run", type=bool, default=False)
    parser.add_argument("--settings_id", default="")
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from pilotguru.ml import augmentation as aug
    from pilotguru.ml import data as data_lib
    from pilotguru.ml import models, training, weighting

    input_names = args.net_input_names.split(",")
    label_names = args.net_label_names.split(",")
    if len(label_names) != 1:
        parser.error("exactly one label name is supported")
    label_name = label_names[0]

    options = {
        models.NET_NAME: args.net_name,
        models.NET_HEAD_DIMS: args.net_head_dims,
        models.LABEL_DIMENSIONS: args.label_dimensions,
        models.DROPOUT_PROB: args.dropout_prob,
        models.LAYER_BLOCKS_OPTIONS: json.loads(args.net_options),
    }
    bias_options = json.loads(args.linear_bias_options)
    shift_rate = tuple(
        float(x) for x in args.horizontal_label_shift_rate.split(",")
    )

    if args.dry_run:
        print(json.dumps(options, indent=2, sort_keys=True))
        return 0

    element_names = input_names + label_names
    train_data = data_lib.load_dataset(
        args.data_dirs.split(","), element_names, args.data_file_suffix
    )
    val_data = data_lib.load_dataset(
        args.validation_data_dirs.split(","), element_names, args.data_file_suffix
    )

    shift_dirs = None
    if args.do_pca_random_shifts:
        shift_dirs = aug.pca_rgb_directions(
            data_lib.images_to_float(train_data[models.FRAME_IMG])
        )

    settings = training.TrainSettings(
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        loss_norm_pow=args.loss_norm_pow,
        batch_use_prob=args.batch_use_prob,
        plateau_patience_epochs=args.plateau_patience_epochs,
        augment=aug.AugmentSettings(
            target_width=args.target_width,
            max_horizontal_shift_pixels=args.max_horizontal_shift_pixels,
            horizontal_label_shift_rate=shift_rate,
            blur_sigma=args.train_blur_sigma,
            blur_prob=args.train_blur_prob,
            grayscale_interpolate_prob=args.grayscale_interpolate_prob,
            random_shift_directions=shift_dirs,
        ),
        seed=args.seed,
    )

    model = models.make_network(options, bias_options)
    tx = training.make_optimizer(settings.optimizer, settings.learning_rate)

    example = {}
    for name in input_names:
        arr = train_data[name][:1]
        if name == models.FRAME_IMG:
            arr = data_lib.images_to_float(arr)
            arr = np.asarray(arr[:, :, : args.target_width])  # width crop shape
            arr = arr[:, : args.target_height]
        example[name] = np.asarray(arr, np.float32)
    state = training.init_ensemble(
        model, example, args.num_nets_to_train, tx, seed=args.seed
    )

    if args.base_preload_dir:
        paths = data_lib.preload_model_names(
            args.base_preload_dir, args.num_nets_to_train
        )
        restored = training.load_ensemble_params(paths)
        state = state._replace(
            params=restored["params"], batch_stats=restored["batch_stats"]
        )

    steering_mags = np.mean(
        np.abs(train_data[label_name].reshape(train_data[label_name].shape[0], -1)),
        axis=1,
    )
    weighters = [
        weighting.make_sample_weighter(
            json.loads(args.sample_weighter_options), steering_mags
        )
        for _ in range(args.num_nets_to_train)
    ]

    training.train_models(
        model,
        state,
        tx,
        train_data,
        val_data,
        input_names=input_names,
        label_name=label_name,
        weighters=weighters,
        settings=settings,
        out_dir=args.out_dir,
        # Scalars always persist: --log_dir if given, else next to the
        # checkpoints, so every run leaves a plottable train_log.jsonl.
        log_path=os.path.join(args.log_dir or args.out_dir, "train_log.jsonl"),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
