import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pilotguru.ml import augmentation as aug
from pilotguru.ml import data as data_lib
from pilotguru.ml import models, training, weighting

# Heavy e2e tier: excluded from the quick loop via `pytest -m "not slow"`.
pytestmark = pytest.mark.slow


def conv_out(size, kernel, stride):
    return (size - kernel) // stride + 1


def nvidia_param_count(h, w, c, head, labels, batchnorm=True):
    """Analytic parameter count for NvidiaSingleFrameNet."""
    total = 0
    shapes = [(h, w, c)]
    for features, kernel, stride in (
        (24, 5, 2), (36, 5, 2), (48, 5, 2), (64, 3, 1), (64, 3, 1),
    ):
        ph, pw, pc = shapes[-1]
        total += kernel * kernel * pc * features + features
        if batchnorm:
            total += 2 * features
        shapes.append((conv_out(ph, kernel, stride), conv_out(pw, kernel, stride), features))
    flat = shapes[-1][0] * shapes[-1][1] * shapes[-1][2]
    dims = [flat, 1164, max(100, head), max(50, head), head]
    for i in range(len(dims) - 1):
        total += dims[i] * dims[i + 1] + dims[i + 1]
        if batchnorm:
            total += 2 * dims[i + 1]
    total += dims[-1] * labels + labels
    return total


def _options(net_name=models.NVIDIA_NET_NAME, head=10, labels=1, dropout=0.0):
    return {
        models.NET_NAME: net_name,
        models.NET_HEAD_DIMS: head,
        models.LABEL_DIMENSIONS: labels,
        models.DROPOUT_PROB: dropout,
        models.LAYER_BLOCKS_OPTIONS: models.DEFAULT_LAYER_BLOCKS_OPTIONS,
    }


def _init(model, h=66, w=200, c=3, extra=None):
    inputs = {models.FRAME_IMG: jnp.zeros((2, h, w, c))}
    if extra:
        inputs.update(extra)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        inputs,
        train=False,
    )
    return inputs, variables


class TestModels:
    def test_nvidia_param_count_matches_reference_architecture(self):
        model = models.make_network(_options())
        _, variables = _init(model)
        count = sum(
            int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(variables["params"])
        )
        assert count == nvidia_param_count(66, 200, 3, 10, 1)

    @pytest.mark.parametrize(
        "name",
        [
            models.NVIDIA_NET_NAME,
            models.RAMBO_COMMA_NET_NAME,
            models.RAMBO_NVIDIA_DEEP_NET_NAME,
            models.RAMBO_NVIDIA_SHALLOW_NET_NAME,
            models.DEEP_NVIDIA_NET_NAME,
            models.RAMBO_NET_NAME,
        ],
    )
    def test_all_nets_forward_shape(self, name):
        model = models.make_network(_options(net_name=name))
        # rambo and deep variants need the taller 100x300 crop preset
        # (data/crop-settings.json); the 8-conv deep net shrinks 66x200 to
        # nothing, as in the reference.
        h, w = (100, 300) if ("rambo" in name or "deep" in name) else (66, 200)
        inputs, variables = _init(model, h=h, w=w)
        out = model.apply(variables, inputs, train=False)
        assert out.shape == (2, 1)

    def test_linear_bias_zero_init_is_identity(self):
        bias_inputs = [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]
        model = models.make_network(_options(), bias_inputs)
        extra = {models.FORWARD_AXIS: jnp.ones((2, 3))}
        inputs, variables = _init(model, extra=extra)
        plain = models.make_network(_options())
        p_inputs, p_vars = _init(plain)
        out_bias = model.apply(variables, inputs, train=False)
        out_plain = plain.apply(p_vars, p_inputs, train=False)
        np.testing.assert_allclose(
            np.asarray(out_bias), np.asarray(out_plain), atol=1e-6
        )

    def test_dropout_active_only_in_train(self):
        model = models.make_network(_options(dropout=0.5))
        inputs, variables = _init(model)
        inputs = {models.FRAME_IMG: jnp.ones((2, 66, 200, 3))}
        out_eval = model.apply(variables, inputs, train=False)
        out_eval2 = model.apply(variables, inputs, train=False)
        np.testing.assert_array_equal(np.asarray(out_eval), np.asarray(out_eval2))


class TestAugmentation:
    def test_shifted_crop_adjusts_labels(self):
        rng = jax.random.PRNGKey(0)
        images = jnp.asarray(np.random.default_rng(0).normal(size=(8, 10, 40, 3)))
        labels = jnp.zeros((8, 1))
        cropped, new_labels = aug.random_shifted_crop(
            rng, images, labels, target_width=20, max_shift=5, shift_rate=jnp.asarray([2.0])
        )
        assert cropped.shape == (8, 10, 20, 3)
        # Labels shifted linearly with the same fraction used for the crop.
        fraction = jax.random.uniform(rng, (8,), minval=-1.0, maxval=1.0)
        np.testing.assert_allclose(
            np.asarray(new_labels[:, 0]), np.asarray(fraction) * 2.0, rtol=1e-6
        )
        # Each cropped image is a contiguous slice of the original.
        shifts = np.round(np.asarray(fraction) * 5).astype(int)
        for i in range(8):
            left = 10 + shifts[i]
            np.testing.assert_array_equal(
                np.asarray(cropped[i]), np.asarray(images[i, :, left : left + 20])
            )

    def test_center_crop(self):
        images = jnp.arange(40.0).reshape(1, 1, 40, 1)
        out = aug.center_crop_width(images, 20)
        np.testing.assert_array_equal(
            np.asarray(out[0, 0, :, 0]), np.arange(10.0, 30.0)
        )

    def test_grayscale_matches_reference_weights(self):
        images = jnp.asarray(np.random.default_rng(1).uniform(size=(2, 4, 4, 3)))
        gray = np.asarray(aug.grayscale(images))
        want = np.sum(
            np.asarray(images) * np.array([0.2989, 0.5870, 0.1140]), axis=-1
        )
        for c in range(3):
            np.testing.assert_allclose(gray[..., c], want, rtol=1e-6)

    def test_blur_preserves_mean_roughly(self):
        images = jnp.asarray(np.random.default_rng(2).uniform(size=(1, 32, 32, 3)))
        blurred = np.asarray(aug.gaussian_blur(images, 2.0))
        assert blurred.shape == images.shape
        np.testing.assert_allclose(blurred.mean(), np.asarray(images).mean(), rtol=0.05)
        assert blurred.std() < np.asarray(images).std()

    def test_pca_directions_shape_and_scale(self):
        rng = np.random.default_rng(3)
        base = rng.normal(size=(1000, 3)) * np.array([3.0, 1.0, 0.1])
        images = base.reshape(10, 10, 10, 3)
        dirs = aug.pca_rgb_directions(images)
        assert dirs.shape == (3, 3)
        norms = np.linalg.norm(dirs, axis=1)
        assert norms[0] > norms[1] > norms[2]


class TestWeighters:
    def test_uniform(self):
        w = weighting.make_sample_weighter({"name": "uniform"}, np.zeros(5))
        np.testing.assert_array_equal(w.get_weights(np.array([0, 3])), [1.0, 1.0])

    def test_label_l1_normalized(self):
        labels = np.array([0.0, 1.0, 2.0, 3.0])
        w = weighting.make_sample_weighter(
            {"name": "label_l1", "label_l1_weight_scale": 2.0}, labels
        )
        weights = w.get_weights(np.arange(4))
        np.testing.assert_allclose(weights.mean(), 1.0, rtol=1e-6)
        assert weights[3] > weights[0]

    def test_exp_recent_loss_updates(self):
        w = weighting.make_sample_weighter(
            {
                "name": "exp_recent_loss",
                "recent_loss_lr": 0.5,
                "recent_loss_exp_scale": 1.0,
                "raw_weight_clip": 10.0,
            },
            np.zeros(4),
        )
        np.testing.assert_allclose(w.get_weights(np.arange(4)), np.ones(4))
        w.register_losses(np.array([0]), np.array([5.0]))
        w.step()
        weights = w.get_weights(np.arange(4))
        assert weights[0] > weights[1]
        np.testing.assert_allclose(weights.mean(), 1.0, rtol=1e-6)


class TestTraining:
    @pytest.fixture(scope="class")
    def dataset(self):
        rng = np.random.default_rng(0)
        n, h, w = 256, 36, 80  # stored wider than the 72 target for crops
        images = rng.integers(0, 255, size=(n, h, w, 3), dtype=np.uint8)
        # Strongly learnable spatial signal: left-right brightness contrast.
        f = images.astype(np.float64) / 255.0
        contrast = f[:, :, : w // 2].mean(axis=(1, 2, 3)) - f[:, :, w // 2 :].mean(
            axis=(1, 2, 3)
        )
        steering = ((contrast - contrast.mean()) * 300.0)[:, None].astype(np.float32)
        axis = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 1))
        return {
            models.FRAME_IMG: images,
            models.STEERING: steering,
            models.FORWARD_AXIS: axis,
        }

    def test_end_to_end_training_improves_and_checkpoints(self, dataset, tmp_path):
        settings = training.TrainSettings(
            epochs=16,
            batch_size=32,
            learning_rate=3e-3,
            optimizer=training.ADAM,
            augment=aug.AugmentSettings(
                target_width=72,
                max_horizontal_shift_pixels=3,
                horizontal_label_shift_rate=(0.05,),
            ),
        )
        options = _options(net_name="toy")
        bias_inputs = [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]
        model = models.make_network(options, bias_inputs)
        tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
        example = {
            models.FRAME_IMG: np.zeros((1, 36, 72, 3), np.float32),
            models.FORWARD_AXIS: np.zeros((1, 3), np.float32),
        }
        state = training.init_ensemble(model, example, num_nets=2, tx=tx)
        weighters = [weighting.UniformWeighter() for _ in range(2)]
        log = training.train_models(
            model,
            state,
            tx,
            dataset,
            dataset,
            input_names=[models.FRAME_IMG, models.FORWARD_AXIS],
            label_name=models.STEERING,
            weighters=weighters,
            settings=settings,
            out_dir=str(tmp_path),
            print_log=False,
            log_path=str(tmp_path / "log.jsonl"),
        )
        assert len(log) == 16
        assert log[-1].val_loss < 0.5 * log[0].val_loss
        for n in range(2):
            for tag in (data_lib.BEST, data_lib.LAST):
                assert os.path.exists(data_lib.model_file_name(str(tmp_path), n, tag))
        # Checkpoints reload into a stacked ensemble.
        restored = training.load_ensemble_params(
            [data_lib.model_file_name(str(tmp_path), n, data_lib.LAST) for n in (0, 1)]
        )
        leaves = jax.tree_util.tree_leaves(restored["params"])
        assert all(leaf.shape[0] == 2 for leaf in leaves)

    def test_batch_use_prob_skips_updates(self, dataset, tmp_path):
        settings = training.TrainSettings(
            epochs=1,
            batch_size=32,
            batch_use_prob=0.0,  # never update
            augment=aug.AugmentSettings(target_width=72),
        )
        model = models.make_network(_options(net_name="toy"))
        tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
        example = {models.FRAME_IMG: np.zeros((1, 36, 72, 3), np.float32)}
        state = training.init_ensemble(model, example, num_nets=1, tx=tx)
        before = jax.tree_util.tree_map(np.asarray, state.params)
        training.train_models(
            model, state, tx, dataset, dataset,
            input_names=[models.FRAME_IMG],
            label_name=models.STEERING,
            weighters=[weighting.UniformWeighter()],
            settings=settings,
            out_dir=str(tmp_path),
            print_log=False,
        )
        # With use prob 0 nothing should have been counted as trained.
        # (state is donated; compare via the saved last checkpoint)
        saved = training.load_net(
            data_lib.model_file_name(str(tmp_path), 0, data_lib.LAST)
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(before),
            jax.tree_util.tree_leaves(saved["params"]),
        ):
            np.testing.assert_array_equal(a[0], b)  # a has the ensemble axis

    def test_fold_lr_scales_survive_across_epochs(self, dataset, tmp_path):
        """Round-2 HIGH regression tripwire (training.py lr_scale seeding):
        caller-installed per-fold LR ratios (the grouped hyperparams
        search's mechanism, cli/hyperparams_search.py) must persist across
        the epoch-end write-back. A re-seed from ones mid-run would
        silently equalize the folds — here net 1 carries lr_scale 0, so a
        wipe would start training it from epoch 2 and change its params."""
        settings = training.TrainSettings(
            epochs=3,
            batch_size=32,
            learning_rate=3e-3,
            augment=aug.AugmentSettings(target_width=72),
        )
        model = models.make_network(_options(net_name="toy"))
        tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
        example = {models.FRAME_IMG: np.zeros((1, 36, 72, 3), np.float32)}
        state = training.init_ensemble(model, example, num_nets=2, tx=tx)
        state = state._replace(lr_scale=jnp.asarray([1.0, 0.0], jnp.float32))
        before = jax.tree_util.tree_map(np.asarray, state.params)
        log = training.train_models(
            model, state, tx, dataset, dataset,
            input_names=[models.FRAME_IMG],
            label_name=models.STEERING,
            weighters=[weighting.UniformWeighter() for _ in range(2)],
            settings=settings,
            out_dir=str(tmp_path),
            print_log=False,
        )
        # Installed ratios visible (not wiped to ones) at EVERY epoch.
        for event in log:
            assert event.lr_scale_per_net == [1.0, 0.0]
        saved = [
            training.load_net(
                data_lib.model_file_name(str(tmp_path), n, data_lib.LAST)
            )
            for n in (0, 1)
        ]
        frozen_same = moving_same = True
        for leaf_b, leaf_0, leaf_1 in zip(
            jax.tree_util.tree_leaves(before),
            jax.tree_util.tree_leaves(saved[0]["params"]),
            jax.tree_util.tree_leaves(saved[1]["params"]),
        ):
            moving_same &= bool(np.array_equal(leaf_b[0], leaf_0))
            frozen_same &= bool(np.array_equal(leaf_b[1], leaf_1))
        assert frozen_same, "lr_scale=0 net must stay at its initialization"
        assert not moving_same, "lr_scale=1 net must actually train"

    def test_plateau_decay_composes_with_fold_lr_ratios(self, dataset, tmp_path):
        """ReduceLROnPlateau-per-net parity (training_helpers.py:130-135)
        composed with caller-installed fold ratios: plateau halving must
        MULTIPLY the installed scale, not replace it."""
        settings = training.TrainSettings(
            epochs=3,
            batch_size=32,
            batch_use_prob=0.0,  # fully frozen (even batch-norm stats):
            # val loss repeats exactly, so the plateau schedule is
            # deterministic — epoch 0 improves from inf, epochs 1-2 plateau.
            plateau_patience_epochs=1,
            augment=aug.AugmentSettings(target_width=72),
        )
        model = models.make_network(_options(net_name="toy"))
        tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
        example = {models.FRAME_IMG: np.zeros((1, 36, 72, 3), np.float32)}
        state = training.init_ensemble(model, example, num_nets=2, tx=tx)
        state = state._replace(lr_scale=jnp.asarray([0.8, 0.2], jnp.float32))
        log = training.train_models(
            model, state, tx, dataset, dataset,
            input_names=[models.FRAME_IMG],
            label_name=models.STEERING,
            weighters=[weighting.UniformWeighter() for _ in range(2)],
            settings=settings,
            out_dir=str(tmp_path),
            print_log=False,
        )
        # Epoch 0 improves (min inf); epochs 1-2 plateau exactly (frozen
        # nets); patience 1 -> one halving lands at epoch 2, composed onto
        # the installed ratios.
        assert log[0].lr_scale_per_net == pytest.approx([0.8, 0.2])
        assert log[-1].lr_scale_per_net == pytest.approx([0.4, 0.1])
