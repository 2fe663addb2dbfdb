"""Flax steering-model zoo, mirroring the reference PyTorch nets.

Reference: /root/reference/python/models.py. Same architectures, options
dictionary keys, and network names, so settings JSONs written for the
reference CLI work unchanged. Differences by design:

- NHWC layout (XLA's preferred layout; the reference is NCHW) and VALID conv padding
  (torch's default padding=0).
- Inputs are a dict {input_name: array}, not a positional list.
- The ensemble axis (--num_nets_to_train) is realized by vmapping one
  module over stacked parameters rather than instantiating N objects
  (see ml/training.py).
- UdacityRamboNet: the reference's class as written is not runnable (it
  calls an undefined MakeRelu, models.py:399); this implementation uses
  ReLU in those blocks, which is the evident intent.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

# Options dict keys (match the reference so settings JSONs round-trip).
CONV = "conv"
FC = "fc"
ACTIVATION = "activation"
RELU = "relu"
SELU = "selu"
DROPOUT = "dropout"
DROPOUT_VANILLA = "vanilla"
DROPOUT_2D = "2d"
DROPOUT_ALPHA = "alpha"
DROPOUT_PROB = "dropout_prob"
BATCHNORM = "batchnorm"

FORWARD_AXIS = "forward_axis"
FRAME_IMG = "frame_img"
STEERING = "steering"
RECORDING_ID = "recording_id"

NET_NAME = "net_name"
NET_HEAD_DIMS = "net_head_dims"
LABEL_DIMENSIONS = "label_dimensions"
LAYER_BLOCKS_OPTIONS = "layer_blocks_options"
# Extension (not in the reference): matmul/conv compute precision.
# Parameters, optimizer state, batch-norm statistics and the loss stay
# float32; conv / dense COMPUTE runs in this dtype ("bfloat16" with f32
# accumulation halves activation memory traffic — the reference's torch
# path is f32-only). Unset = float32 on every platform; whether bfloat16
# pays on the GPU is not measured.
COMPUTE_DTYPE = "compute_dtype"

TOY_NET_NAME = "toy"  # extension: the reference never registered ToyConvNet
NVIDIA_NET_NAME = "nvidia"
RAMBO_NET_NAME = "rambo"
RAMBO_COMMA_NET_NAME = "rambo-comma"
RAMBO_NVIDIA_DEEP_NET_NAME = "rambo-nvidia-deep"
RAMBO_NVIDIA_SHALLOW_NET_NAME = "rambo-nvidia-shallow"
DEEP_NVIDIA_NET_NAME = "nvidia-deep"

# train.py:43-53 defaults.
DEFAULT_LAYER_BLOCKS_OPTIONS = {
    CONV: {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_2D},
    FC: {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_VANILLA},
}


def resolve_compute_dtype(options: Dict[str, Any]):
    """Computation dtype for conv/dense blocks (see COMPUTE_DTYPE)."""
    name = options.get(COMPUTE_DTYPE, "float32")
    return {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[name]


def _activation(name: str):
    if name == RELU:
        return nn.relu
    if name == SELU:
        return jax.nn.selu
    raise ValueError(f"unknown activation type: {name}")


class AlphaDropout(nn.Module):
    """SELU-compatible dropout (torch nn.AlphaDropout semantics)."""

    rate: float

    @nn.compact
    def __call__(self, x, deterministic: bool):
        if deterministic or self.rate == 0.0:
            return x
        alpha_prime = -1.7580993408473766  # -scale * alpha of SELU
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(
            self.make_rng("dropout"), keep, shape=x.shape
        )
        a = (keep + alpha_prime**2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_prime * (1 - keep)
        return a * jnp.where(mask, x, alpha_prime) + b


def _dropout(kind: str, rate: float):
    if kind == DROPOUT_VANILLA:
        return nn.Dropout(rate)
    if kind == DROPOUT_2D:
        # Drop whole channels: broadcast the mask over H, W (NHWC dims 1, 2).
        return nn.Dropout(rate, broadcast_dims=(1, 2))
    if kind == DROPOUT_ALPHA:
        return AlphaDropout(rate)
    raise ValueError(f"unknown dropout type: {kind}")


class ConvBlock(nn.Module):
    """Conv -> [BatchNorm] -> activation -> [dropout] (models.py:133-143).

    ``dtype``: compute precision for the conv (params stay float32 via
    flax's param_dtype default); batch-norm statistics always run float32.
    """

    features: int
    kernel: int
    stride: int
    options: Dict[str, Any]
    dropout_prob: float
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool):
        x = nn.Conv(
            self.features,
            (self.kernel, self.kernel),
            strides=(self.stride, self.stride),
            padding="VALID",
            dtype=self.dtype,
        )(x)
        if self.options[BATCHNORM]:
            # torch BatchNorm default momentum 0.1 == flax momentum 0.9.
            x = nn.BatchNorm(
                use_running_average=not train, momentum=0.9, dtype=jnp.float32
            )(x)
            x = x.astype(self.dtype)
        x = _activation(self.options[ACTIVATION])(x)
        if self.dropout_prob > 0:
            x = _dropout(self.options[DROPOUT], self.dropout_prob)(
                x, deterministic=not train
            )
        return x


class FcBlock(nn.Module):
    """Linear -> [BatchNorm] -> activation -> [dropout] (models.py:145-155)."""

    features: int
    options: Dict[str, Any]
    dropout_prob: float
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool):
        x = nn.Dense(self.features, dtype=self.dtype)(x)
        if self.options[BATCHNORM]:
            # torch BatchNorm default momentum 0.1 == flax momentum 0.9.
            x = nn.BatchNorm(
                use_running_average=not train, momentum=0.9, dtype=jnp.float32
            )(x)
            x = x.astype(self.dtype)
        x = _activation(self.options[ACTIVATION])(x)
        if self.dropout_prob > 0:
            x = _dropout(self.options[DROPOUT], self.dropout_prob)(
                x, deterministic=not train
            )
        return x


class LinearBias(nn.Module):
    """Zero-initialized linear conditioning added to the net output.

    Matches models.py:170-183: out += W @ inputs[input_name], W init 0, no
    bias term. Used to condition steering on the ride's forward axis.
    """

    out_dims: int
    input_name: str

    @nn.compact
    def __call__(self, pre_bias, inputs):
        w = nn.Dense(
            self.out_dims, use_bias=False, kernel_init=nn.initializers.zeros
        )
        return pre_bias + w(inputs[self.input_name])


def _flatten(x):
    return x.reshape((x.shape[0], -1))


class _ImageNetBase(nn.Module):
    """Shared plumbing: image trunk + LinearBias post-transforms."""

    options: Dict[str, Any]
    linear_bias_inputs: Sequence[Dict[str, Any]] = ()

    def input_names(self) -> List[str]:
        return [FRAME_IMG] + [m["input_name"] for m in self.linear_bias_inputs]

    def label_names(self) -> List[str]:
        return [STEERING]

    def _apply_post_transforms(self, out, inputs):
        for m in self.linear_bias_inputs:
            out = LinearBias(
                self.options[LABEL_DIMENSIONS], m["input_name"]
            )(out, inputs)
        return out

    @property
    def _blocks(self):
        return self.options.get(
            LAYER_BLOCKS_OPTIONS, DEFAULT_LAYER_BLOCKS_OPTIONS
        )

    @property
    def _dropout_prob(self):
        return self.options.get(DROPOUT_PROB, 0.0)

    @property
    def _cdtype(self):
        return resolve_compute_dtype(self.options)


class ToyConvNet(_ImageNetBase):
    """3-conv + 3-fc debugging net (models.py:218-242)."""

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        blocks, p, dt = self._blocks, 0.0, self._cdtype
        x = inputs[FRAME_IMG]
        for features in (6, 16, 1):
            x = ConvBlock(features, 5, 1, blocks[CONV], p, dtype=dt)(x, train)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = _flatten(x)
        act = _activation(blocks[FC][ACTIVATION])
        x = act(nn.Dense(120)(x))
        x = act(nn.Dense(84)(x))
        x = nn.Dense(1)(x)
        return self._apply_post_transforms(x, inputs)


class NvidiaSingleFrameNet(_ImageNetBase):
    """NVIDIA PilotNet: conv 24-36-48-64-64, fc 1164-100-50-head-labels
    (models.py:245-279)."""

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        blocks, p, dt = self._blocks, self._dropout_prob, self._cdtype
        head = self.options[NET_HEAD_DIMS]
        x = inputs[FRAME_IMG]
        x = ConvBlock(24, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(36, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(48, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(64, 3, 1, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(64, 3, 1, blocks[CONV], p, dtype=dt)(x, train)
        x = _flatten(x)
        x = FcBlock(1164, blocks[FC], p, dtype=dt)(x, train)
        x = FcBlock(max(100, head), blocks[FC], 0.0, dtype=dt)(x, train)
        x = FcBlock(max(50, head), blocks[FC], 0.0, dtype=dt)(x, train)
        x = FcBlock(head, blocks[FC], 0.0, dtype=dt)(x, train)
        x = nn.Dense(self.options[LABEL_DIMENSIONS])(x)
        return self._apply_post_transforms(x, inputs)


class RamboCommaNet(_ImageNetBase):
    """comma.ai-style branch of the Udacity Rambo model (models.py:423-454)."""

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        blocks, p, dt = self._blocks, self._dropout_prob, self._cdtype
        x = inputs[FRAME_IMG]
        x = ConvBlock(16, 8, 4, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(32, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(64, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = _flatten(x)
        x = FcBlock(512, blocks[FC], p, dtype=dt)(x, train)
        x = nn.relu(nn.Dense(self.options[NET_HEAD_DIMS])(x))
        x = nn.Dense(self.options[LABEL_DIMENSIONS])(x)
        return self._apply_post_transforms(x, inputs)


class RamboNVidiaNet(_ImageNetBase):
    """NVIDIA-style Rambo branch, all-stride-2 convs (models.py:457-498)."""

    skip_first_conv_layer: bool = False

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        blocks, p, dt = self._blocks, self._dropout_prob, self._cdtype
        head = self.options[NET_HEAD_DIMS]
        x = inputs[FRAME_IMG]
        if not self.skip_first_conv_layer:
            x = ConvBlock(24, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(36, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(48, 5, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(64, 3, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = ConvBlock(64, 3, 2, blocks[CONV], p, dtype=dt)(x, train)
        x = _flatten(x)
        x = FcBlock(1164, blocks[FC], p, dtype=dt)(x, train)
        x = FcBlock(max(100, head), blocks[FC], 0.0, dtype=dt)(x, train)
        x = nn.relu(nn.Dense(head)(x))
        x = nn.Dense(self.options[LABEL_DIMENSIONS])(x)
        return self._apply_post_transforms(x, inputs)


class DeepNVidiaNet(_ImageNetBase):
    """8-conv deep PilotNet variant (models.py:501-542)."""

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        blocks, p, dt = self._blocks, self._dropout_prob, self._cdtype
        head = self.options[NET_HEAD_DIMS]
        x = inputs[FRAME_IMG]
        for features, kernel, stride in (
            (36, 5, 2), (48, 5, 2), (48, 5, 1), (64, 3, 1),
            (64, 3, 2), (64, 3, 1), (64, 3, 1), (64, 3, 1),
        ):
            x = ConvBlock(features, kernel, stride, blocks[CONV], p, dtype=dt)(x, train)
        x = _flatten(x)
        x = FcBlock(1164, blocks[FC], p, dtype=dt)(x, train)
        x = FcBlock(max(100, head), blocks[FC], p, dtype=dt)(x, train)
        x = _activation(blocks[FC][ACTIVATION])(nn.Dense(head)(x))
        x = nn.Dense(self.options[LABEL_DIMENSIONS])(x)
        return self._apply_post_transforms(x, inputs)


class UdacityRamboNet(_ImageNetBase):
    """Three-branch ensemble-in-one (comma + 2 NVIDIA-ish) (models.py:282-420).

    The reference's torch class is not runnable as committed (undefined
    MakeRelu); this follows its evident structure with ReLU blocks. Branch
    outputs concat into one linear merge layer.
    """

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        p, dt = self._dropout_prob, self._cdtype
        head = self.options[NET_HEAD_DIMS]
        rambo_blocks = {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_2D}
        rambo_fc = {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_VANILLA}
        x = inputs[FRAME_IMG]

        comma = x
        for f, k, s in ((16, 8, 4), (32, 5, 2), (64, 5, 2)):
            comma = ConvBlock(f, k, s, rambo_blocks, p, dtype=dt)(comma, train)
        comma = _flatten(comma)
        comma = FcBlock(512, rambo_fc, p, dtype=dt)(comma, train)
        comma = nn.Dense(head)(comma)

        nv1 = x
        for f, k, s in ((24, 5, 2), (36, 5, 2), (48, 5, 2), (64, 3, 2), (64, 3, 2)):
            nv1 = ConvBlock(f, k, s, rambo_blocks, p, dtype=dt)(nv1, train)
        nv1 = _flatten(nv1)
        nv1 = FcBlock(100, rambo_fc, p, dtype=dt)(nv1, train)
        nv1 = FcBlock(50, rambo_fc, 0.0, dtype=dt)(nv1, train)
        nv1 = nn.Dense(head)(nv1)

        nv2 = x
        for f, k, s in ((36, 5, 2), (48, 5, 2), (64, 3, 2), (64, 3, 2)):
            nv2 = ConvBlock(f, k, s, rambo_blocks, p, dtype=dt)(nv2, train)
        nv2 = _flatten(nv2)
        nv2 = FcBlock(100, rambo_fc, p, dtype=dt)(nv2, train)
        nv2 = FcBlock(50, rambo_fc, 0.0, dtype=dt)(nv2, train)
        nv2 = nn.Dense(head)(nv2)

        merged = jnp.concatenate([comma, nv1, nv2], axis=1)
        out = nn.Dense(self.options[LABEL_DIMENSIONS])(merged)
        return self._apply_post_transforms(out, inputs)


def make_network(options: Dict[str, Any], linear_bias_inputs=()) -> _ImageNetBase:
    """Factory matching MakeNetwork (models.py:552-572), same net names."""
    net_name = options[NET_NAME]
    classes = {
        TOY_NET_NAME: ToyConvNet,
        NVIDIA_NET_NAME: NvidiaSingleFrameNet,
        RAMBO_NET_NAME: UdacityRamboNet,
        RAMBO_COMMA_NET_NAME: RamboCommaNet,
        DEEP_NVIDIA_NET_NAME: DeepNVidiaNet,
    }
    if net_name in classes:
        return classes[net_name](
            options=options, linear_bias_inputs=tuple(linear_bias_inputs)
        )
    if net_name == RAMBO_NVIDIA_DEEP_NET_NAME:
        return RamboNVidiaNet(
            options=options,
            linear_bias_inputs=tuple(linear_bias_inputs),
            skip_first_conv_layer=False,
        )
    if net_name == RAMBO_NVIDIA_SHALLOW_NET_NAME:
        return RamboNVidiaNet(
            options=options,
            linear_bias_inputs=tuple(linear_bias_inputs),
            skip_first_conv_layer=True,
        )
    raise ValueError(f"Unknown network name: {net_name}")
