"""Sim(3) pose-graph optimization for loop closing.

Replaces Optimizer::OptimizeEssentialGraph (/root/reference/thirdparty/
orb-slam2/src/Optimizer.cc): the reference optimizes keyframe Sim3 poses
over spanning-tree + covisibility + loop edges with g2o's sparse LM. Here
the graph is small (keyframe chain + loop edges, tens to a few hundred
nodes), so one dense fixed-iteration LM over the flattened [K*7] parameter
vector is the right accelerator shape — no sparse machinery, one jitted program.

Conventions: node k holds S_k, the world->camera Sim(3) of keyframe k.
An edge (i, j) carries the measured relative transform M_ij ~= S_i o S_j^-1
(camera j frame -> camera i frame). Sequential edges take M from the
pre-correction poses (the odometry is locally right); loop edges take M
from the RANSAC-Umeyama Sim3 fit (vo/sim3.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pilotguru.vo.pose import geo_jit

from pilotguru.solvers.levenberg_marquardt import levenberg_marquardt
from pilotguru.vo import sim3


class PoseGraphResult(NamedTuple):
    nodes7: jnp.ndarray  # [K, 7] optimized Sim(3) poses
    final_loss: jnp.ndarray  # []


def _edge_residuals(flat, num_nodes, edge_i, edge_j, edge_meas, edge_weight,
                    anchor):
    nodes = flat.reshape(num_nodes, 7)

    def one(i, j, meas, w):
        rel = sim3.compose(nodes[i], sim3.inverse(nodes[j]))
        return w * sim3.error_vector(rel, meas)

    res = jax.vmap(one)(edge_i, edge_j, edge_meas, edge_weight)  # [E, 7]
    # Gauge: pin node 0 (rotation+translation+scale) to its initial pose.
    prior = 1e3 * (nodes[0] - anchor)
    return jnp.concatenate([res.ravel(), prior])


@partial(geo_jit, static_argnames=("num_iters",))
def optimize_pose_graph(
    nodes7,  # [K, 7]
    edge_i,  # [E] int32
    edge_j,  # [E] int32
    edge_meas7,  # [E, 7]
    edge_valid,  # [E] bool (padding support: invalid edges weigh zero)
    num_iters: int = 30,
) -> PoseGraphResult:
    num_nodes = nodes7.shape[0]
    weights = edge_valid.astype(nodes7.dtype)
    anchor = nodes7[0]
    result = levenberg_marquardt(
        lambda f: _edge_residuals(
            f, num_nodes, edge_i, edge_j, edge_meas7, weights, anchor
        ),
        nodes7.ravel(),
        num_iters=num_iters,
    )
    return PoseGraphResult(result.x.reshape(num_nodes, 7), result.loss)


def chain_edges(nodes7):
    """Sequential-odometry edge measurements M_{k,k+1} = S_k o S_{k+1}^-1
    from the current node estimates (host-side helper)."""
    import numpy as np

    k = np.asarray(nodes7).shape[0]
    edge_i = np.arange(0, k - 1, dtype=np.int32)
    edge_j = edge_i + 1
    meas = jax.vmap(
        lambda i, j: sim3.compose(nodes7[i], sim3.inverse(nodes7[j]))
    )(edge_i, edge_j)
    return edge_i, edge_j, np.asarray(meas)
