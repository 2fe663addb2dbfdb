"""Ensemble steering-model training as one jitted device program.

Reference: /root/reference/python/optimize.py + training_helpers.py. The
reference trains N identical nets sequentially per batch on one GPU
(optimize.py:108-132); here the ensemble is a *vmapped axis over stacked
parameters*, so all N nets train in a single device program per batch, and
augmentation runs on-device inside the same program (see ml/augmentation).

Semantics preserved:
  - PowerLoss |pred - label|^p averaged over non-batch dims (optimize.py:37-47)
  - per-example weights from pluggable weighters, weighted-mean loss
    (optimize.py:110-120)
  - per-net Bernoulli batch skipping via --batch_use_prob (optimize.py:109):
    skipped nets keep parameters AND optimizer state unchanged (exact skip,
    not a zero-gradient step)
  - SGD(momentum 0.9) / Adam (training_helpers.py:85-92)
  - ReduceLROnPlateau(factor 0.5) per net on validation loss
  - best/last checkpoints per net with the reference naming contract
  - console epoch lines with the reference's ``***`` improvement markers
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax

from pilotguru.ml import data as data_lib
from pilotguru.ml import models as models_lib
from pilotguru.ml.augmentation import AugmentSettings, augment_batch, center_crop_width

ADAM = "adam"
SGD = "sgd"


class EnsembleState(NamedTuple):
    params: Any  # pytree, leading axis = net index
    batch_stats: Any  # pytree, leading axis = net index (may be empty)
    opt_state: Any  # pytree, leading axis = net index
    lr_scale: jnp.ndarray  # [N] multiplicative LR factors (plateau scheduler)


@dataclass
class TrainSettings:
    epochs: int
    batch_size: int
    learning_rate: float = 1e-3
    optimizer: str = SGD
    loss_norm_pow: float = 2.0
    batch_use_prob: float = 1.0
    plateau_patience_epochs: int = 0
    augment: AugmentSettings = field(default_factory=AugmentSettings)
    seed: int = 0


def power_loss(predicted, labels, p):
    """|pred - label|^p, mean over non-batch dims (optimize.py:37-47)."""
    per_example = jnp.abs(predicted - labels) ** p
    return jnp.mean(
        per_example.reshape(per_example.shape[0], -1), axis=1
    )


def make_optimizer(name: str, learning_rate: float):
    if name == SGD:
        return optax.sgd(learning_rate, momentum=0.9)
    if name == ADAM:
        return optax.adam(learning_rate)
    raise ValueError(f"unknown optimizer name: {name}")


def init_ensemble(
    model, example_inputs: Dict[str, np.ndarray], num_nets: int, tx, seed: int = 0
) -> EnsembleState:
    """Initialize N independently-seeded parameter sets, stacked on axis 0."""

    def init_one(key):
        variables = model.init(
            {"params": key, "dropout": key}, example_inputs, train=False
        )
        return variables["params"], variables.get("batch_stats", {})

    keys = jax.random.split(jax.random.PRNGKey(seed), num_nets)
    params, batch_stats = jax.vmap(init_one)(keys)
    opt_state = jax.vmap(tx.init)(params)
    return EnsembleState(
        params, batch_stats, opt_state, jnp.ones((num_nets,), jnp.float32)
    )


def _select_per_net(mask, new_tree, old_tree):
    """Per-net selection between updated and previous pytrees."""

    def pick(new, old):
        shape = (mask.shape[0],) + (1,) * (new.ndim - 1)
        return jnp.where(mask.reshape(shape), new, old)

    return jax.tree_util.tree_map(pick, new_tree, old_tree)


def make_train_step(model, tx, settings: TrainSettings):
    """Build the jitted ensemble train step.

    When the model supports it (folded.foldable: the PilotNet trunk), the
    ensemble forward/backward runs as ONE folded program — the ensemble
    axis concatenated into conv channels (grouped convs) and batched FC
    matmuls — instead of a vmap of per-net programs, widening convs whose
    per-net channel counts (24-64) are small. Per-net math is exact; set
    PGTPU_FOLDED_ENSEMBLE=0 to force the vmapped path.
    """
    import os

    from pilotguru.ml import folded as folded_lib

    use_folded = folded_lib.foldable(model) and os.environ.get(
        "PGTPU_FOLDED_ENSEMBLE", "1"
    ) != "0"

    def step(state: EnsembleState, inputs, labels, weights, use_mask, rng):
        """inputs: dict of [B, ...]; labels [B, L]; weights [N, B];
        use_mask [N] bool; returns (state, mean_loss [N], per_example [N, B]).

        Images may arrive uint8: conversion to float happens ON DEVICE so
        the host->device batch transfer moves a quarter of the bytes (the
        reference converts on host, io_helpers.py ImageFrameDataset)."""
        aug_rng, dropout_rng = jax.random.split(rng)
        images = inputs[models_lib.FRAME_IMG]
        if images.dtype == jnp.uint8:
            images = images.astype(jnp.float32) / 255.0
        images, labels = augment_batch(
            aug_rng, images, labels, settings.augment
        )
        net_inputs = dict(inputs)
        net_inputs[models_lib.FRAME_IMG] = images
        dropout_keys = jax.random.split(dropout_rng, weights.shape[0])

        def per_net(params, batch_stats, opt_state, w, lr_scale, key):
            def loss_fn(p):
                out, mutated = model.apply(
                    {"params": p, "batch_stats": batch_stats},
                    net_inputs,
                    train=True,
                    mutable=["batch_stats"],
                    rngs={"dropout": key},
                )
                per_example = power_loss(out, labels, settings.loss_norm_pow)
                return jnp.mean(per_example * w), (
                    per_example,
                    mutated.get("batch_stats", {}),
                )

            (loss, (per_example, new_stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
            new_params = optax.apply_updates(params, updates)
            return new_params, new_stats, new_opt, loss, per_example

        if use_folded:
            num_nets = weights.shape[0]

            def folded_loss(stacked_params):
                out, new_stats = folded_lib.folded_forward(
                    model, stacked_params, state.batch_stats, net_inputs,
                    train=True, dropout_key=dropout_keys[0],
                )  # out: [N, B, L]
                per_example = jax.vmap(
                    lambda o: power_loss(o, labels, settings.loss_norm_pow)
                )(out)  # [N, B]
                per_net_loss = jnp.mean(per_example * weights, axis=1)  # [N]
                # Per-net params are independent, so the gradient of the SUM
                # equals each net's own gradient (identical to the vmapped
                # per-net value_and_grad).
                return jnp.sum(per_net_loss), (
                    per_net_loss, per_example, new_stats,
                )

            (_, (losses, per_example, new_stats)), grads = jax.value_and_grad(
                folded_loss, has_aux=True
            )(state.params)
            updates, new_opt = jax.vmap(tx.update)(
                grads, state.opt_state, state.params
            )
            scale = state.lr_scale.reshape(
                (num_nets,)
            )
            updates = jax.tree_util.tree_map(
                lambda u: u * scale.reshape((num_nets,) + (1,) * (u.ndim - 1)),
                updates,
            )
            new_params = optax.apply_updates(state.params, updates)
        else:
            new_params, new_stats, new_opt, losses, per_example = jax.vmap(
                per_net
            )(
                state.params,
                state.batch_stats,
                state.opt_state,
                weights,
                state.lr_scale,
                dropout_keys,
            )
        new_state = EnsembleState(
            _select_per_net(use_mask, new_params, state.params),
            _select_per_net(use_mask, new_stats, state.batch_stats),
            _select_per_net(use_mask, new_opt, state.opt_state),
            state.lr_scale,
        )
        return new_state, losses, per_example

    return jax.jit(step, donate_argnums=(0,))


def make_eval_step(model, settings: TrainSettings):
    target_width = settings.augment.target_width

    def step(state: EnsembleState, inputs, labels):
        images = inputs[models_lib.FRAME_IMG]
        if images.dtype == jnp.uint8:
            images = images.astype(jnp.float32) / 255.0
        if target_width > 0:
            images = center_crop_width(images, target_width)
        net_inputs = dict(inputs)
        net_inputs[models_lib.FRAME_IMG] = images

        def per_net(params, batch_stats):
            out = model.apply(
                {"params": params, "batch_stats": batch_stats},
                net_inputs,
                train=False,
            )
            return power_loss(out, labels, settings.loss_norm_pow)

        per_example = jax.vmap(per_net, in_axes=(0, 0))(
            state.params, state.batch_stats
        )
        return jnp.mean(per_example, axis=1)  # [N]

    return jax.jit(step)


def save_net(state: EnsembleState, net_idx: int, path: str) -> None:
    """Serialize one ensemble member (flax msgpack)."""
    payload = {
        "params": jax.tree_util.tree_map(lambda x: np.asarray(x[net_idx]), state.params),
        "batch_stats": jax.tree_util.tree_map(
            lambda x: np.asarray(x[net_idx]), state.batch_stats
        ),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(payload))


def load_net(path: str):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def load_ensemble_params(paths: List[str]) -> Dict[str, Any]:
    """Stack per-net checkpoint files back into ensemble pytrees."""
    loaded = [load_net(p) for p in paths]
    params = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[l["params"] for l in loaded])
    stats = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[l["batch_stats"] for l in loaded]
    )
    return {"params": params, "batch_stats": stats}


@dataclass
class TrainLogEvent:
    """Per-epoch scalars, streamed to ``log_path`` as JSONL — the durable
    equivalent of the reference's tensorboard_logger train/val curves
    (optimize.py:88-89, 201-203) plus its console line fields."""

    epoch: int
    train_loss: float
    val_loss: float
    epoch_duration_sec: float
    examples_per_sec: float
    # Per-net curves (reference logs one tensorboard scalar pair per
    # learner: train_loss/{i}, val_loss/{i}).
    train_loss_per_net: Optional[List[float]] = None
    val_loss_per_net: Optional[List[float]] = None
    improvement_marker: str = ""
    # Effective per-net LR multipliers AFTER this epoch's plateau update —
    # makes caller-installed fold ratios (grouped hyperparams search) and
    # plateau decay composition observable (regression tripwire for the
    # round-2 per-fold LR wipe at the epoch-end write-back).
    lr_scale_per_net: Optional[List[float]] = None


def train_models(
    model,
    state: EnsembleState,
    tx,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    input_names: List[str],
    label_name: str,
    weighters: List,
    settings: TrainSettings,
    out_dir: str,
    print_log: bool = True,
    log_path: Optional[str] = None,
    net_out_specs: Optional[List[tuple]] = None,
) -> List[TrainLogEvent]:
    """Full training loop mirroring TrainModels (optimize.py:77-212).

    ``net_out_specs``: optional per-net (directory, local_index) checkpoint
    routing — used by the grouped hyperparameter search, where one vmapped
    super-ensemble trains several grid folds at once and each fold's nets
    must land in that fold's output directory under fold-local names.
    """
    num_nets = len(weighters)
    if net_out_specs is None:
        net_out_specs = [(out_dir, n) for n in range(num_nets)]
    train_step = make_train_step(model, tx, settings)
    eval_step = make_eval_step(model, settings)
    host_rng = np.random.default_rng(settings.seed)
    step_key = jax.random.PRNGKey(settings.seed + 1)

    num_train = train_data[label_name].shape[0]
    num_val = val_data[label_name].shape[0]

    def gather_batch(dataset, idx):
        inputs = {}
        for name in input_names:
            # Frame images stay uint8 through the host->device copy (a
            # quarter of the bandwidth); the jitted steps convert on device.
            inputs[name] = dataset[name][idx]
        labels = np.asarray(dataset[label_name][idx], np.float32)
        if labels.ndim == 1:
            labels = labels[:, None]
        return inputs, labels

    log: List[TrainLogEvent] = []
    min_val_losses = np.full((num_nets,), np.inf)
    min_val_loss = np.inf
    # Seed from the incoming state so per-fold LR ratios installed by callers
    # (e.g. hyperparams_search grouped folds) compose with plateau decay
    # instead of being wiped back to 1.0 at the first epoch-end write-back.
    lr_scale = np.asarray(state.lr_scale, np.float32).copy()
    plateau_counters = np.zeros((num_nets,), np.int64)
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    log_file = open(log_path, "a") if log_path else None

    def stage_batch(idx):
        """Assemble batch k+1 on host and START its device transfer while
        the device still runs batch k (device_put is asynchronous): the
        input pipeline double-buffers against compute instead of feeding
        the step synchronously like the reference's per-batch .cuda() copy
        (optimize.py:104-105)."""
        inputs, labels = gather_batch(train_data, idx)
        weights = np.stack([w.get_weights(idx) for w in weighters])
        use_mask = host_rng.uniform(size=num_nets) < settings.batch_use_prob
        staged = jax.device_put(
            (inputs, labels, weights.astype(np.float32))
        )
        return staged, use_mask, idx

    for epoch in range(settings.epochs):
        epoch_start = time.time()
        running = np.zeros((num_nets,))
        seen = np.zeros((num_nets,), np.int64)
        # Per-step results stay on device during the epoch; pulls and
        # weighter registration happen once at epoch end (registration
        # order preserved — weighter.get_weights only changes at step(),
        # so deferral is exact) instead of blocking every step.
        pending: List[tuple] = []
        batch_iter = data_lib.batches(num_train, settings.batch_size, host_rng)
        nxt = next(batch_iter, None)
        staged = stage_batch(nxt) if nxt is not None else None
        while staged is not None:
            (inputs, labels, weights), use_mask, idx = staged
            nxt = next(batch_iter, None)
            staged = stage_batch(nxt) if nxt is not None else None
            if not use_mask.any():
                continue
            step_key, sub = jax.random.split(step_key)
            state, losses, per_example = train_step(
                state, inputs, labels, weights, jnp.asarray(use_mask), sub
            )
            pending.append((idx, use_mask, losses, per_example))
        for idx, use_mask, losses, per_example in pending:
            losses_np = np.asarray(losses)
            per_example_np = np.asarray(per_example)
            for n, w in enumerate(weighters):
                if use_mask[n]:
                    w.register_losses(idx, per_example_np[n])
                    running[n] += losses_np[n] * len(idx)
                    seen[n] += len(idx)
        epoch_duration = time.time() - epoch_start
        examples_per_sec = float(seen.sum()) / max(epoch_duration, 1e-9)
        avg_loss = float(running.sum() / max(seen.sum(), 1))

        for w in weighters:
            w.step()

        val_total = np.zeros((num_nets,))
        for idx in data_lib.batches(num_val, settings.batch_size, None):
            inputs, labels = gather_batch(val_data, idx)
            val_losses = np.asarray(eval_step(state, inputs, jnp.asarray(labels)))
            val_total += val_losses * len(idx)
        val_avg = val_total / max(num_val, 1)
        val_avg_all = float(val_avg.mean())

        marker = ""
        if val_avg_all < min_val_loss:
            marker = " ***"
            min_val_loss = val_avg_all
        elif val_avg_all * 0.9 < min_val_loss:
            marker = " *"

        for n in range(num_nets):
            if val_avg[n] < min_val_losses[n]:
                min_val_losses[n] = val_avg[n]
                plateau_counters[n] = 0
                spec_dir, spec_idx = net_out_specs[n]
                save_net(
                    state, n,
                    data_lib.model_file_name(spec_dir, spec_idx, data_lib.BEST),
                )
            elif settings.plateau_patience_epochs > 0:
                plateau_counters[n] += 1
                if plateau_counters[n] > settings.plateau_patience_epochs:
                    lr_scale[n] *= 0.5
                    plateau_counters[n] = 0
        state = state._replace(lr_scale=jnp.asarray(lr_scale))

        event = TrainLogEvent(
            epoch, avg_loss, val_avg_all, epoch_duration, examples_per_sec,
            train_loss_per_net=list(
                np.round(running / np.maximum(seen, 1), 8)
            ),
            val_loss_per_net=list(np.round(val_avg, 8)),
            improvement_marker=marker.strip(),
            lr_scale_per_net=[float(s) for s in lr_scale],
        )
        log.append(event)
        if print_log:
            print(
                f"Epoch {epoch};  loss {avg_loss:g};  val loss: {val_avg_all:g};  "
                f"{epoch_duration:0.2f} sec/epoch; "
                f"{examples_per_sec:0.2f} examples/sec{marker}"
            )
        if log_file:
            log_file.write(json.dumps(event.__dict__) + "\n")
            log_file.flush()

    for n in range(num_nets):
        spec_dir, spec_idx = net_out_specs[n]
        save_net(
            state, n, data_lib.model_file_name(spec_dir, spec_idx, data_lib.LAST)
        )
    if log_file:
        log_file.close()
    return log
