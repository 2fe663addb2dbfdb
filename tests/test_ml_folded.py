"""Folded-ensemble training parity (PARITY.md §training-roofline follow-up).

The folded path (ml/folded.py) is an execution LAYOUT for the same math the
vmapped per-net path runs: grouped convs are block-diagonal, batch norm is
per-channel, FC matmuls are batched per net. These tests pin exact parity
(to float tolerance) between the two paths for the full train step —
losses, per-example losses, updated parameters, and batch-norm statistics —
plus shape/selection behavior the folded path must preserve.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pilotguru.ml import augmentation as aug
from pilotguru.ml import folded, models, training

pytestmark = pytest.mark.slow


def _flagship(num_nets=2, dropout=0.0):
    options = {
        models.NET_NAME: models.NVIDIA_NET_NAME,
        models.NET_HEAD_DIMS: 10,
        models.LABEL_DIMENSIONS: 1,
        models.DROPOUT_PROB: dropout,
        models.LAYER_BLOCKS_OPTIONS: models.DEFAULT_LAYER_BLOCKS_OPTIONS,
    }
    bias = [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]
    model = models.make_network(options, bias)
    example = {
        models.FRAME_IMG: np.zeros((1, 66, 200, 3), np.float32),
        models.FORWARD_AXIS: np.zeros((1, 3), np.float32),
    }
    settings = training.TrainSettings(
        epochs=1,
        batch_size=8,
        augment=aug.AugmentSettings(
            target_width=200,
            max_horizontal_shift_pixels=3,
            horizontal_label_shift_rate=(0.1,),
        ),
    )
    tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
    state = training.init_ensemble(model, example, num_nets, tx)
    return model, tx, settings, state


def _batch(batch=8, seed=0, width=210):
    # width 210 feeds the train step (augmentation crops to 200); direct
    # forward-parity tests must pass width=200, the model's input width.
    rng = np.random.default_rng(seed)
    inputs = {
        models.FRAME_IMG: rng.uniform(size=(batch, 66, width, 3)).astype(
            np.float32
        ),
        models.FORWARD_AXIS: rng.normal(size=(batch, 3)).astype(np.float32),
    }
    labels = rng.normal(size=(batch, 1)).astype(np.float32)
    return inputs, labels


class TestFoldedForwardParity:
    def test_foldable_detects_flagship(self):
        model, _, _, _ = _flagship()
        assert folded.foldable(model)

    def test_forward_matches_vmapped_eval(self):
        """Eval-mode folded forward == per-net model.apply."""
        model, _, _, state = _flagship()
        inputs, _ = _batch(width=200)

        out_folded, _ = folded.folded_forward(
            model, state.params, state.batch_stats, inputs,
            train=False, dropout_key=jax.random.PRNGKey(0),
        )

        def per_net(params, stats):
            return model.apply(
                {"params": params, "batch_stats": stats}, inputs, train=False
            )

        out_vmap = jax.vmap(per_net)(state.params, state.batch_stats)
        np.testing.assert_allclose(
            np.asarray(out_folded), np.asarray(out_vmap), atol=1e-4
        )

    def test_train_mode_stats_match(self):
        """Train-mode folded forward: outputs AND mutated batch-norm
        statistics match the per-net path."""
        model, _, _, state = _flagship()
        inputs, _ = _batch(seed=3, width=200)

        out_folded, stats_folded = folded.folded_forward(
            model, state.params, state.batch_stats, inputs,
            train=True, dropout_key=jax.random.PRNGKey(0),
        )

        def per_net(params, stats):
            out, mutated = model.apply(
                {"params": params, "batch_stats": stats},
                inputs,
                train=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)},
            )
            return out, mutated["batch_stats"]

        out_vmap, stats_vmap = jax.vmap(per_net)(
            state.params, state.batch_stats
        )
        np.testing.assert_allclose(
            np.asarray(out_folded), np.asarray(out_vmap), atol=1e-4
        )
        flat_f = jax.tree_util.tree_leaves_with_path(stats_folded)
        flat_v = dict(
            (jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(stats_vmap)
        )
        assert flat_f and len(flat_f) == len(flat_v)
        for path, leaf in flat_f:
            np.testing.assert_allclose(
                np.asarray(leaf),
                np.asarray(flat_v[jax.tree_util.keystr(path)]),
                atol=1e-5,
                err_msg=jax.tree_util.keystr(path),
            )


class TestFoldedTrainStepParity:
    def test_full_step_matches_vmapped(self, monkeypatch):
        """One full train step (augment + fwd/bwd + optimizer): the folded
        and vmapped paths produce the same losses, per-example losses,
        parameters and batch stats (dropout 0 so randomness can't differ)."""
        model, tx, settings, state0 = _flagship()
        inputs, labels = _batch(seed=5)
        num_nets = 2
        weights = jnp.asarray(
            np.random.default_rng(1).uniform(0.5, 1.5, size=(num_nets, 8)),
            jnp.float32,
        )
        use = jnp.ones((num_nets,), bool)
        key = jax.random.PRNGKey(7)

        results = {}
        for mode, env in (("folded", "1"), ("vmapped", "0")):
            monkeypatch.setenv("PGTPU_FOLDED_ENSEMBLE", env)
            state = jax.tree_util.tree_map(jnp.copy, state0)
            step = training.make_train_step(model, tx, settings)
            new_state, losses, per_example = step(
                state, inputs, labels, weights, use, key
            )
            results[mode] = (new_state, losses, per_example)

        (fs, fl, fp), (vs, vl, vp) = results["folded"], results["vmapped"]
        np.testing.assert_allclose(np.asarray(fl), np.asarray(vl), atol=1e-5)
        np.testing.assert_allclose(np.asarray(fp), np.asarray(vp), atol=1e-4)
        for got, want, what in (
            (fs.params, vs.params, "params"),
            (fs.batch_stats, vs.batch_stats, "batch_stats"),
        ):
            flat_g = jax.tree_util.tree_leaves_with_path(got)
            flat_w = dict(
                (jax.tree_util.keystr(p), leaf)
                for p, leaf in jax.tree_util.tree_leaves_with_path(want)
            )
            assert flat_g and len(flat_g) == len(flat_w), what
            for path, leaf in flat_g:
                np.testing.assert_allclose(
                    np.asarray(leaf),
                    np.asarray(flat_w[jax.tree_util.keystr(path)]),
                    atol=2e-5,
                    err_msg=f"{what}{jax.tree_util.keystr(path)}",
                )

    def test_use_mask_still_freezes_nets(self, monkeypatch):
        monkeypatch.setenv("PGTPU_FOLDED_ENSEMBLE", "1")
        model, tx, settings, state0 = _flagship()
        inputs, labels = _batch(seed=9)
        weights = jnp.ones((2, 8), jnp.float32)
        use = jnp.asarray([True, False])
        step = training.make_train_step(model, tx, settings)
        state1, _, _ = step(
            jax.tree_util.tree_map(jnp.copy, state0),
            inputs, labels, weights, use, jax.random.PRNGKey(0),
        )
        k0 = "ConvBlock_0"
        before = np.asarray(state0.params[k0]["Conv_0"]["kernel"])
        after = np.asarray(state1.params[k0]["Conv_0"]["kernel"])
        assert not np.allclose(before[0], after[0])  # net 0 trained
        np.testing.assert_array_equal(before[1], after[1])  # net 1 frozen

    def test_dropout_runs_on_folded_path(self, monkeypatch):
        monkeypatch.setenv("PGTPU_FOLDED_ENSEMBLE", "1")
        model, tx, settings, state0 = _flagship(dropout=0.25)
        inputs, labels = _batch(seed=11)
        weights = jnp.ones((2, 8), jnp.float32)
        use = jnp.ones((2,), bool)
        step = training.make_train_step(model, tx, settings)
        _, losses, _ = step(
            state0, inputs, labels, weights, use, jax.random.PRNGKey(0)
        )
        assert np.all(np.isfinite(np.asarray(losses)))
