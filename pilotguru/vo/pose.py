"""SE(3) utilities and robust pose-only optimization.

Replaces Optimizer::PoseOptimization (the reference's g2o wrapper,
thirdparty/orb-slam2/src/Optimizer.cc): the camera pose is a 6-vector
(so(3) rotation vector + translation, world->camera), residuals are
normalized-plane reprojection errors with Huber IRLS weights, minimized by
the batched dense Levenberg-Marquardt from pilotguru.solvers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pilotguru.solvers.levenberg_marquardt import levenberg_marquardt


# GPU matmuls at default precision may compute f32 inputs in TF32 (10-bit
# mantissa). That is fine for descriptor scoring, but catastrophic for
# chained pose composition: a per-frame motion delta is ~3e-3 rad, and a
# reduced-precision product of two near-identity rotations carries an
# absolute error of the order of the motion itself. Inside
# fused_track_chunk's carry this compounds into predictions drifting by
# pixels within a few frames, collapsing tracking inliers on the device
# only (CPU f32 matmuls are exact-f32, so no CPU test can catch it). All
# geometry matmuls here therefore pin precision=HIGHEST; the 3x3 shapes
# make this free.
_HI = jax.lax.Precision.HIGHEST


def geo_jit(fun, **jit_kwargs):
    """jax.jit for GEOMETRY device programs: the whole trace runs under
    ``jax.default_matmul_precision("float32")``.

    Covers every matmul/einsum a geometry program contains (two-view
    essential/triangulation, BA Jacobian products and Schur assembly,
    Sim(3)/pose-graph algebra, DLT relocalization) without per-site
    precision= plumbing. Descriptor matching (bf16 +-1 operands, exact in
    any precision) and the int8 BRIEF product are unaffected; only f32
    geometry pays the (negligible at 3x3/Nx6 shapes) exact-f32 cost. The precision config is part of jit's trace
    cache key, so wrapping the call site is sound."""
    import functools

    jfun = jax.jit(fun, **jit_kwargs)

    @functools.wraps(fun)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return jfun(*args, **kwargs)

    return wrapped


def rotvec_to_matrix(w):
    """Rodrigues formula, Taylor-safe near zero."""
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2 + 1e-30)
    k = jnp.asarray(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], w.dtype
    )
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    kk = jnp.matmul(k, k, precision=_HI)
    return jnp.eye(3, dtype=w.dtype) + a * k + b * kk


def matrix_to_rotvec(r):
    """Inverse Rodrigues (principal branch)."""
    cos = jnp.clip((jnp.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos)
    axis_raw = jnp.asarray(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]], r.dtype
    )
    sin = jnp.linalg.norm(axis_raw) / 2.0
    scale = jnp.where(sin > 1e-9, theta / (2.0 * sin), 0.5)
    return axis_raw * scale


def matrix_to_quat(r):
    """Rotation matrix -> (w, x, y, z) quaternion (stable branch-free form)."""
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    tr = m00 + m11 + m22
    qw = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-12)) / 2.0
    qx = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) / 2.0
    qy = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) / 2.0
    qz = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) / 2.0
    qx = qx * jnp.sign(jnp.where(m21 - m12 == 0, 1.0, m21 - m12))
    qy = qy * jnp.sign(jnp.where(m02 - m20 == 0, 1.0, m02 - m20))
    qz = qz * jnp.sign(jnp.where(m10 - m01 == 0, 1.0, m10 - m01))
    q = jnp.stack([qw, qx, qy, qz])
    return q / jnp.linalg.norm(q)


def inv3x3(mats):
    """Batched closed-form 3x3 inverse via the adjugate ([..., 3, 3]).

    Accelerator-friendly replacement for per-matrix LU/SVD factorizations: pure
    elementwise arithmetic that vectorizes over any batch shape."""
    a = mats[..., 0, 0]
    b = mats[..., 0, 1]
    c = mats[..., 0, 2]
    d = mats[..., 1, 0]
    e = mats[..., 1, 1]
    f = mats[..., 1, 2]
    g = mats[..., 2, 0]
    h = mats[..., 2, 1]
    i = mats[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack(
        [
            jnp.stack([co_a, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([co_b, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([co_c, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)[..., None, None]


def transform(pose6, points):
    """Apply world->camera pose: R x + t. pose6 = [rotvec(3), t(3)]."""
    r = rotvec_to_matrix(pose6[:3])
    return jnp.matmul(points, r.T, precision=_HI) + pose6[3:]


def compose_pose(delta6, pose6):
    """delta o pose for world->camera 6-vectors (device twin of
    MonocularTracker._compose): R = R_d R_p, t = R_d t_p + t_d."""
    r_d = rotvec_to_matrix(delta6[:3])
    r_p = rotvec_to_matrix(pose6[:3])
    r = jnp.matmul(r_d, r_p, precision=_HI)
    t = jnp.matmul(r_d, pose6[3:], precision=_HI) + delta6[3:]
    return jnp.concatenate([matrix_to_rotvec(r), t])


def pose_delta(prev6, curr6):
    """delta such that curr = delta o prev (device twin of
    MonocularTracker._pose_delta)."""
    r_prev = rotvec_to_matrix(prev6[:3])
    r_curr = rotvec_to_matrix(curr6[:3])
    r_d = jnp.matmul(r_curr, r_prev.T, precision=_HI)
    t_d = curr6[3:] - jnp.matmul(r_d, prev6[3:], precision=_HI)
    return jnp.concatenate([matrix_to_rotvec(r_d), t_d])


def project(points_cam):
    """Pinhole projection to the normalized plane, z-guarded."""
    z = jnp.maximum(points_cam[..., 2:3], 1e-6)
    return points_cam[..., :2] / z


def reprojection_residuals(pose6, points_world, observations, weights):
    """[N, 2] weighted residuals (weights fold in validity and Huber IRLS)."""
    cam = transform(pose6, points_world)
    res = project(cam) - observations
    # Points behind the camera contribute a large fixed penalty direction.
    behind = cam[..., 2] <= 1e-6
    res = jnp.where(behind[..., None], 1.0, res)
    return res * weights[..., None]


def huber_weights(residual_norms, delta: float):
    """sqrt of the Huber IRLS weight: 1 inside delta, sqrt(delta/|r|) outside."""
    return jnp.where(
        residual_norms <= delta,
        1.0,
        jnp.sqrt(delta / jnp.maximum(residual_norms, 1e-12)),
    )


class PoseOptimizationResult(NamedTuple):
    pose6: jnp.ndarray  # [6]
    inliers: jnp.ndarray  # [N] bool
    num_inliers: jnp.ndarray  # []


def optimize_pose(
    pose6_init,
    points_world,
    observations,
    valid,
    huber_delta: float = 0.006,  # ~ sqrt(5.99) px at f ~ 400px, like g2o's chi2
    inlier_threshold: float = 0.01,
    irls_rounds: int = 3,
    lm_iters: int = 10,
    obs_invsigma=None,
) -> PoseOptimizationResult:
    """Robust pose-only refinement (PoseOptimization semantics: 4 rounds of
    optimize + outlier reclassification become IRLS reweighting rounds).

    ``obs_invsigma``: optional [N] per-observation inverse noise scale. A
    keypoint detected at pyramid level L carries positional noise
    ~ scale**L (in level-0 units), so invsigma = scale**-L both downweights
    coarse observations in the normal equations (the reference's invSigma2
    information matrix, Optimizer.cc:126-127) and widens their effective
    inlier gate (the reference's per-level chi2 thresholds): residual norms
    are compared against the threshold AFTER scaling by invsigma.
    """
    dtype = points_world.dtype
    pose = jnp.asarray(pose6_init, dtype)
    if obs_invsigma is None:
        obs_invsigma = jnp.ones(observations.shape[:-1], dtype)
    base_w = valid.astype(dtype) * obs_invsigma

    def round_body(pose, _):
        res = project(transform(pose, points_world)) - observations
        norms = jnp.linalg.norm(res, axis=-1) * obs_invsigma
        w = base_w * huber_weights(norms, huber_delta)
        result = levenberg_marquardt(
            lambda p: reprojection_residuals(
                p, points_world, observations, w
            ).ravel(),
            pose,
            num_iters=lm_iters,
        )
        return result.x, None

    pose, _ = jax.lax.scan(round_body, pose, None, length=irls_rounds)

    def classify(pose):
        res = project(transform(pose, points_world)) - observations
        norms = jnp.linalg.norm(res, axis=-1) * obs_invsigma
        cam_z = transform(pose, points_world)[..., 2]
        return valid & (norms < inlier_threshold) & (cam_z > 0)

    # Final polish on hard inliers only (the reference's g2o loop excludes
    # chi2 outliers between rounds rather than merely downweighting them,
    # Optimizer::PoseOptimization); Huber leaves a residual bias otherwise.
    inliers = classify(pose)
    w_hard = inliers.astype(dtype) * obs_invsigma
    result = levenberg_marquardt(
        lambda p: reprojection_residuals(
            p, points_world, observations, w_hard
        ).ravel(),
        pose,
        num_iters=lm_iters,
    )
    pose = result.x
    inliers = classify(pose)
    return PoseOptimizationResult(pose, inliers, jnp.sum(inliers))
