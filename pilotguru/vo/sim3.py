"""Sim(3) algebra + weighted Umeyama alignment for monocular loop closing.

Monocular SLAM drifts in 7 DOF (rotation, translation, scale), so loop
constraints and the pose graph live in Sim(3), not SE(3) — the reference
computes loop transforms with a dedicated Sim3 solver and optimizes the
essential graph over Sim3 nodes (/root/reference/thirdparty/orb-slam2/src/
Sim3Solver.cc, Optimizer::OptimizeEssentialGraph, Optimizer.cc). Here a
Sim(3) element is a 7-vector [rotvec(3), t(3), log_s(1)] acting on points as
x -> exp(log_s) * R x + t, and the closed-form scaled alignment is the
weighted Umeyama solve on 3D-3D correspondences, RANSAC-wrapped as a fixed
K-hypothesis vmap (same fixed shape as vo/twoview.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pilotguru.vo.pose import geo_jit, matrix_to_rotvec, rotvec_to_matrix


def identity(dtype=jnp.float64):
    return jnp.zeros(7, dtype)


def from_pose6(pose6):
    """Lift an SE(3) 6-vector to Sim(3) with unit scale."""
    return jnp.concatenate([pose6, jnp.zeros(1, pose6.dtype)])


def to_pose6(sim7):
    """Project Sim(3) back to SE(3): [R, t, s] -> [R, t/s].

    This is how the reference folds optimized Sim3 keyframe poses back into
    SE3 after essential-graph optimization (LoopClosing.cc: eigt *= (1./s)).
    """
    s = jnp.exp(sim7[6])
    return jnp.concatenate([sim7[:3], sim7[3:6] / s])


def act(sim7, points):
    """Apply x -> s R x + t to [..., 3] points."""
    r = rotvec_to_matrix(sim7[:3])
    s = jnp.exp(sim7[6])
    return s * (points @ r.T) + sim7[3:6]


def compose(a, b):
    """Sim(3) composition: (a o b)(x) = a(b(x)) =
    (s_a s_b)(R_a R_b) x + s_a R_a t_b + t_a."""
    ra = rotvec_to_matrix(a[:3])
    rb = rotvec_to_matrix(b[:3])
    sa = jnp.exp(a[6])
    rot = matrix_to_rotvec(ra @ rb)
    t = sa * (ra @ b[3:6]) + a[3:6]
    return jnp.concatenate([rot, t, (a[6] + b[6])[None]])


def inverse(a):
    """Sim(3) inverse: x -> (1/s) R^T (x - t)."""
    r = rotvec_to_matrix(a[:3])
    s = jnp.exp(a[6])
    rot = matrix_to_rotvec(r.T)
    t = -(r.T @ (a[3:6] / s))
    return jnp.concatenate([rot, t, (-a[6])[None]])


def error_vector(a, b):
    """7-vector local error between two Sim(3) elements (zero iff a == b):
    [rotvec(Ra Rb^T), ta - tb (in the common frame), log(sa/sb)].

    A first-order proxy for log(a o b^-1) — exact in rotation and scale,
    linear in translation — which is what a least-squares pose graph needs
    (residuals vanish exactly at the measurement, Jacobians well-behaved).
    """
    ra = rotvec_to_matrix(a[:3])
    rb = rotvec_to_matrix(b[:3])
    rot_err = matrix_to_rotvec(ra @ rb.T)
    return jnp.concatenate([rot_err, a[3:6] - b[3:6], (a[6] - b[6])[None]])


class UmeyamaResult(NamedTuple):
    sim7: jnp.ndarray  # [7] maps A-frame points into B-frame
    valid: jnp.ndarray  # [] bool — enough spread to be well-posed


def umeyama_sim3(points_a, points_b, weights) -> UmeyamaResult:
    """Weighted scaled orthogonal Procrustes: find s, R, t minimizing
    sum_i w_i ||b_i - (s R a_i + t)||^2 (Umeyama 1991, closed form)."""
    w = weights / jnp.maximum(jnp.sum(weights), 1e-12)
    mu_a = jnp.sum(points_a * w[:, None], axis=0)
    mu_b = jnp.sum(points_b * w[:, None], axis=0)
    ca = points_a - mu_a
    cb = points_b - mu_b
    cov = (cb * w[:, None]).T @ ca  # [3, 3] = sum w (b-mub)(a-mua)^T
    u, sv, vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(u) * jnp.linalg.det(vt))
    diag = jnp.asarray([1.0, 1.0, 1.0], cov.dtype).at[2].set(d)
    r = u @ jnp.diag(diag) @ vt
    var_a = jnp.sum(w * jnp.sum(ca * ca, axis=1))
    scale = jnp.sum(sv * diag) / jnp.maximum(var_a, 1e-12)
    t = mu_b - scale * (r @ mu_a)
    log_s = jnp.log(jnp.maximum(scale, 1e-12))
    sim7 = jnp.concatenate([matrix_to_rotvec(r), t, log_s[None]])
    # Degenerate when the source points are (near-)collinear: second singular
    # value collapses relative to the first.
    valid = (sv[1] > 1e-9 * jnp.maximum(sv[0], 1e-30)) & (var_a > 1e-12)
    return UmeyamaResult(sim7, valid)


class Sim3RansacResult(NamedTuple):
    sim7: jnp.ndarray  # [7]
    inliers: jnp.ndarray  # [N] bool
    num_inliers: jnp.ndarray  # []


@partial(geo_jit, static_argnames=("num_hypotheses",))
def ransac_umeyama(
    points_a,  # [N, 3]
    points_b,  # [N, 3]
    valid,  # [N] bool
    rng_key,
    num_hypotheses: int = 64,
    inlier_threshold: float = 0.05,
) -> Sim3RansacResult:
    """Fixed-K batched RANSAC over 3-point Umeyama solves, polished with one
    all-inlier weighted solve (Sim3Solver::iterate semantics as a vmap).

    ``inlier_threshold`` is relative: a correspondence is an inlier when the
    alignment residual is below threshold * RMS point spread (loop-closure
    point clouds have arbitrary monocular scale, so an absolute threshold
    would be meaningless).
    """
    n = points_a.shape[0]
    w = valid.astype(points_a.dtype)
    spread = jnp.sqrt(
        jnp.sum(w * jnp.sum((points_b - jnp.sum(points_b * w[:, None], 0)
                             / jnp.maximum(jnp.sum(w), 1e-12)) ** 2, 1))
        / jnp.maximum(jnp.sum(w), 1e-12)
    )
    threshold = inlier_threshold * jnp.maximum(spread, 1e-9)

    def hypothesis(key):
        idx = jax.random.choice(
            key, n, shape=(3,), replace=False,
            p=w / jnp.maximum(jnp.sum(w), 1e-12),
        )
        fit = umeyama_sim3(points_a[idx], points_b[idx], w[idx] + 1e-9)
        err = jnp.linalg.norm(act(fit.sim7, points_a) - points_b, axis=-1)
        good = valid & (err < threshold) & fit.valid
        return fit.sim7, jnp.sum(good)

    keys = jax.random.split(rng_key, num_hypotheses)
    sims, scores = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(scores)

    # Polish: weighted Umeyama on the winning hypothesis' inliers.
    err0 = jnp.linalg.norm(act(sims[best], points_a) - points_b, axis=-1)
    good0 = valid & (err0 < threshold)
    polish = umeyama_sim3(points_a, points_b, good0.astype(points_a.dtype) + 1e-12)
    err = jnp.linalg.norm(act(polish.sim7, points_a) - points_b, axis=-1)
    inliers = valid & (err < threshold)
    return Sim3RansacResult(polish.sim7, inliers, jnp.sum(inliers))
