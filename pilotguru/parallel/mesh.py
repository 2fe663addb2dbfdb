"""Device-mesh helpers for multi-chip scaling.

The reference has no multi-device numeric workload (SURVEY.md section 2.8):
its concurrency is a sequential sliding-window loop, N-nets-on-one-GPU, and
a process pool for grid search. This rebuild's parallel axes are:

  - windows  : the sliding-window calibration batch (pure data parallel) —
               sharded across all devices, psum-free (windows are independent;
               only the final per-event segment-sums reduce across them).
  - data     : training batch data-parallelism.
  - ensemble : the --num_nets_to_train axis (independent nets).

Model sizes here (~1.6M-param PilotNet) warrant no tensor or pipeline
parallelism; scaling is DP/ensemble over ICI via NamedSharding + jit, with
XLA inserting the (few) collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    With no explicit sizes, all devices go to the first axis and remaining
    axes get size 1.
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = [len(devices)] + [1] * (len(axis_names) - 1)
    total = int(np.prod(axis_sizes))
    if total != len(devices):
        raise ValueError(
            f"axis sizes {axis_sizes} do not cover {len(devices)} devices"
        )
    mesh_devices = np.asarray(devices).reshape(axis_sizes)
    return Mesh(mesh_devices, axis_names)


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad an axis up to a multiple (for even sharding). Returns (array, n)."""
    n = array.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - n)
    return np.pad(array, pad), n


def shard_leading_axis(tree, mesh: Mesh, axis_name: str):
    """device_put a pytree with each leaf's leading axis sharded on the mesh."""

    def put(leaf):
        spec = P(axis_name, *([None] * (np.ndim(leaf) - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    """device_put a pytree fully replicated across the mesh."""
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, NamedSharding(mesh, P())), tree
    )
