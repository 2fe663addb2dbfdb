"""Ensemble-folded PilotNet forward: the ensemble axis in the channels.

The vmapped ensemble (training.py make_train_step) runs each net's convs
separately, each with tiny channel counts (PilotNet Cout 24-64) that fill
little of a matrix unit's tile. Folding the ensemble axis INTO the channel
axis keeps per-net math exact while widening every conv (whether that
pays on the GPU: not measured):

- conv1 sees the SAME image for every net, so folding is a plain conv with
  N*24 output channels (kernels concatenated — no masking needed);
- conv2..5 become grouped convs (feature_group_count=N): block-diagonal by
  construction, each net's channels only feed its own net;
- batch norm is per-channel, so folded BN over N*C channels computes exactly
  the per-net statistics;
- FC layers become batched per-net matmuls (einsum over the net axis).

Parameters stay in the EXISTING stacked-per-net layout ([N, ...] leaves of
EnsembleState) — the fold happens inside the forward as cheap reshapes, so
init, checkpoints (save_net), eval, and the optimizer are untouched, and
gradients flow back through the fold to the per-net leaves.

Randomness caveat: the vmapped path draws a dropout mask per net; the
folded path draws one mask over the folded channels. Distributions are
identical (independent Bernoulli per channel either way), but realizations
differ from the vmapped path for the same key, so exact-parity tests run
with dropout 0 (tests/test_ml_folded.py).

Reference architecture contract: python/models.py:245-279 (PilotNet
24-36-48-64-64 / 1164-100-50-head) — the same contract models.py's
NvidiaSingleFrameNet implements; this module is an execution layout for it,
not a different model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pilotguru.ml import models as models_lib

# Conv strides per block for each foldable trunk (kernel sizes and channel
# counts are read off the parameter shapes; strides are architecture).
_FOLDABLE_STRIDES = {
    models_lib.NVIDIA_NET_NAME: (2, 2, 2, 1, 1),
}

_BN_EPS = 1e-5  # flax nn.BatchNorm default
_BN_MOMENTUM = 0.9  # torch 0.1 == flax 0.9 (ConvBlock/FcBlock)


def foldable(model) -> bool:
    """True when the folded fast path reproduces this model exactly."""
    return (
        type(model).__name__ == "NvidiaSingleFrameNet"
        and model.options.get(models_lib.NET_NAME) in _FOLDABLE_STRIDES
    )


def _fold_conv_kernel(k):
    """[N, kh, kw, cin, cout] -> [kh, kw, cin, N*cout] (group-major)."""
    n, kh, kw, cin, cout = k.shape
    return jnp.transpose(k, (1, 2, 3, 0, 4)).reshape(kh, kw, cin, n * cout)


def _bn_train(x, reduce_axes, scale, bias, mean_ra, var_ra):
    """Folded BatchNorm in train mode over folded channels (f32 statistics,
    flax semantics: biased batch variance for both the normalization and the
    running update). Returns (y, new_mean_ra, new_var_ra)."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=reduce_axes)
    mean2 = jnp.mean(jnp.square(xf), axis=reduce_axes)
    var = jnp.maximum(mean2 - jnp.square(mean), 0.0)
    y = (xf - mean) * jax.lax.rsqrt(var + _BN_EPS) * scale + bias
    new_mean = _BN_MOMENTUM * mean_ra + (1.0 - _BN_MOMENTUM) * mean
    new_var = _BN_MOMENTUM * var_ra + (1.0 - _BN_MOMENTUM) * var
    return y, new_mean, new_var


def _bn_eval(x, scale, bias, mean_ra, var_ra):
    xf = x.astype(jnp.float32)
    return (xf - mean_ra) * jax.lax.rsqrt(var_ra + _BN_EPS) * scale + bias


def _dropout_mask(key, shape, rate, dtype):
    keep = jax.random.bernoulli(key, 1.0 - rate, shape)
    return jnp.where(keep, 1.0 / (1.0 - rate), 0.0).astype(dtype)


def folded_forward(model, params, batch_stats, inputs, train, dropout_key):
    """Run the stacked-[N]-leaf ensemble as ONE folded program.

    Args:
      model: the (foldable) flax model — used for its options only.
      params / batch_stats: stacked per-net pytrees ([N, ...] leaves), the
        exact layout EnsembleState holds.
      inputs: dict with FRAME_IMG [B, H, W, C] and LinearBias inputs.
      train: batch-norm/dropout mode.
      dropout_key: PRNG key (used when dropout_prob > 0 and train).

    Returns (out [N, B, label_dims], new_batch_stats stacked like input).
    """
    options = model.options
    blocks = options.get(
        models_lib.LAYER_BLOCKS_OPTIONS, models_lib.DEFAULT_LAYER_BLOCKS_OPTIONS
    )
    conv_bn = blocks[models_lib.CONV][models_lib.BATCHNORM]
    fc_bn = blocks[models_lib.FC][models_lib.BATCHNORM]
    if (
        blocks[models_lib.CONV][models_lib.ACTIVATION] != models_lib.RELU
        or blocks[models_lib.FC][models_lib.ACTIVATION] != models_lib.RELU
    ):
        raise NotImplementedError("folded path supports relu trunks only")
    p_drop = options.get(models_lib.DROPOUT_PROB, 0.0)
    dtype = models_lib.resolve_compute_dtype(options)
    strides = _FOLDABLE_STRIDES[options[models_lib.NET_NAME]]

    conv_names = sorted(
        (k for k in params if k.startswith("ConvBlock_")),
        key=lambda s: int(s.split("_")[1]),
    )
    fc_names = sorted(
        (k for k in params if k.startswith("FcBlock_")),
        key=lambda s: int(s.split("_")[1]),
    )
    assert len(conv_names) == len(strides), (conv_names, strides)
    n = params[conv_names[0]]["Conv_0"]["kernel"].shape[0]

    def _mutable(tree):
        # Deep-copy the dict spine (leaves shared) so in-place assignment
        # below works for dict and FrozenDict inputs alike.
        if hasattr(tree, "items"):
            return {k: _mutable(v) for k, v in tree.items()}
        return tree

    new_stats = _mutable(batch_stats)

    def bn_apply(x, block_name, reduce_axes, folded_c):
        """Folded BatchNorm for block `block_name`; mutates new_stats."""
        scale = params[block_name]["BatchNorm_0"]["scale"].reshape(folded_c)
        bias = params[block_name]["BatchNorm_0"]["bias"].reshape(folded_c)
        stats = batch_stats[block_name]["BatchNorm_0"]
        mean_ra = stats["mean"].reshape(folded_c)
        var_ra = stats["var"].reshape(folded_c)
        if train:
            y, new_mean, new_var = _bn_train(
                x, reduce_axes, scale, bias, mean_ra, var_ra
            )
            per_net = stats["mean"].shape
            new_stats[block_name]["BatchNorm_0"]["mean"] = new_mean.reshape(
                per_net
            )
            new_stats[block_name]["BatchNorm_0"]["var"] = new_var.reshape(
                per_net
            )
        else:
            y = _bn_eval(x, scale, bias, mean_ra, var_ra)
        return y

    # ------------------------------------------------------- conv trunk
    x = inputs[models_lib.FRAME_IMG].astype(dtype)
    key = dropout_key
    for i, (name, stride) in enumerate(zip(conv_names, strides)):
        k = params[name]["Conv_0"]["kernel"]  # [N, kh, kw, cin, cout]
        b = params[name]["Conv_0"]["bias"]  # [N, cout]
        cout = k.shape[-1]
        folded_k = _fold_conv_kernel(k).astype(dtype)
        x = jax.lax.conv_general_dilated(
            x,
            folded_k,
            window_strides=(stride, stride),
            padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            # Layer 1: every net reads the SAME image -> plain dense conv
            # with concatenated kernels. Layers >=1: block-diagonal groups.
            feature_group_count=1 if i == 0 else n,
        )
        x = x + b.reshape(n * cout).astype(dtype)
        if conv_bn:
            x = bn_apply(x, name, (0, 1, 2), n * cout).astype(dtype)
        x = jax.nn.relu(x)
        if p_drop > 0 and train:
            key, sub = jax.random.split(key)
            # DROPOUT_2D: drop whole channels (broadcast over H, W).
            x = x * _dropout_mask(
                sub, (x.shape[0], 1, 1, x.shape[-1]), p_drop, x.dtype
            )

    # ------------------------------------------------- flatten per net
    bsz, h, w, _ = x.shape
    cout = x.shape[-1] // n
    # Channel layout is group-major [n, c]; per-net flatten must match the
    # unfolded net's (h, w, c) ordering.
    x = x.reshape(bsz, h, w, n, cout)
    x = jnp.transpose(x, (0, 3, 1, 2, 4)).reshape(bsz, n, h * w * cout)

    # ------------------------------------------------------- FC trunk
    for j, name in enumerate(fc_names):
        wk = params[name]["Dense_0"]["kernel"].astype(dtype)  # [N, F, G]
        wb = params[name]["Dense_0"]["bias"].astype(dtype)  # [N, G]
        g = wk.shape[-1]
        x = jnp.einsum("bnf,nfg->bng", x.astype(dtype), wk) + wb[None]
        if fc_bn:
            x = (
                bn_apply(x.reshape(bsz, n * g), name, (0,), n * g)
                .reshape(bsz, n, g)
                .astype(dtype)
            )
        x = jax.nn.relu(x)
        # Only FcBlock_0 carries dropout (NvidiaSingleFrameNet passes 0.0
        # to the rest), vanilla elementwise.
        if p_drop > 0 and train and j == 0:
            key, sub = jax.random.split(key)
            x = x * _dropout_mask(sub, x.shape, p_drop, x.dtype)

    # ------------------------------------------- label head + LinearBias
    wk = params["Dense_0"]["kernel"].astype(dtype)  # [N, head, L]
    wb = params["Dense_0"]["bias"].astype(dtype)  # [N, L]
    out = jnp.einsum("bnf,nfl->bnl", x.astype(dtype), wk) + wb[None]
    for idx, meta in enumerate(model.linear_bias_inputs):
        lb = params[f"LinearBias_{idx}"]["Dense_0"]["kernel"]  # [N, D, L]
        cond = inputs[meta["input_name"]].astype(dtype)  # [B, D]
        out = out + jnp.einsum("bd,ndl->bnl", cond, lb.astype(dtype))

    return jnp.transpose(out, (1, 0, 2)).astype(jnp.float32), new_stats
