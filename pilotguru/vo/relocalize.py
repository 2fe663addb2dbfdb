"""Relocalization: recover the camera pose from scratch against the map.

Reference behavior (Tracking::Relocalization, thirdparty/orb-slam2/src/
Tracking.cc): when both motion-model and reference-keyframe tracking fail,
candidate keyframes come from the DBoW2 inverted index, PnP-RANSAC proposes
poses, and pose optimization + guided matching confirm one before the state
falls to LOST.

Fixed-shape design: the DBoW2 index is unnecessary — one exhaustive Hamming
match against ALL map-point descriptors replaces candidate retrieval; pose
hypotheses come from a fixed-K batched RANSAC over 6-point DLT solutions
(vmapped tiny SVDs), polished by the robust pose optimizer.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pilotguru.vo import matching
from pilotguru.vo.pose import (
    geo_jit,
    matrix_to_rotvec,
    optimize_pose,
    project,
    transform,
)


class RelocalizationResult(NamedTuple):
    pose6: jnp.ndarray  # [6]
    inliers: jnp.ndarray  # [M] over map points
    num_inliers: jnp.ndarray  # []
    observations: jnp.ndarray  # [M, 2] matched normalized coords
    matched: jnp.ndarray  # [M] bool


def dlt_pose(points3d, obs, weights):
    """Weighted DLT estimate of [R|t] from 2D-3D correspondences.

    Builds the 2n x 12 system for the projection matrix P (normalized
    camera), solves by SVD, then projects the 3x3 block onto SO(3) and
    fixes scale/sign by cheirality. Weights zero-out padded rows exactly.
    """
    n = points3d.shape[0]
    x = points3d
    ones = jnp.ones((n, 1), x.dtype)
    xh = jnp.concatenate([x, ones], axis=1)  # [n, 4]
    zeros = jnp.zeros_like(xh)
    u = obs[:, 0:1]
    v = obs[:, 1:2]
    rows_u = jnp.concatenate([xh, zeros, -u * xh], axis=1)  # [n, 12]
    rows_v = jnp.concatenate([zeros, xh, -v * xh], axis=1)
    a = jnp.concatenate([rows_u * weights[:, None], rows_v * weights[:, None]])
    _, _, vt = jnp.linalg.svd(a, full_matrices=False)
    p = vt[-1].reshape(3, 4)

    m = p[:, :3]
    # Scale/sign: make det positive and rows unit-ish.
    sign = jnp.sign(jnp.linalg.det(m) + 1e-30)
    scale = sign / (jnp.abs(jnp.linalg.det(m)) ** (1.0 / 3.0) + 1e-30)
    m = m * scale
    t = p[:, 3] * scale
    # Project onto SO(3).
    um, _, vmt = jnp.linalg.svd(m)
    r = um @ vmt
    r = r * jnp.sign(jnp.linalg.det(r))
    return jnp.concatenate([matrix_to_rotvec(r), t])


@partial(geo_jit, static_argnames=("num_hypotheses",))
def relocalize(
    map_points,  # [M, 3]
    map_desc,  # [M, 256] uint8
    map_valid,  # [M] bool
    kp_norm,  # [K, 2]
    kp_desc,  # [K, 256] uint8
    kp_valid,  # [K] bool
    rng_key,
    num_hypotheses: int = 64,
    inlier_threshold: float = 0.01,
) -> RelocalizationResult:
    """Global match + batched-RANSAC DLT + robust pose polish."""
    m = matching.match_descriptors(
        jnp.asarray(map_desc),
        jnp.asarray(kp_desc),
        valid_a=jnp.asarray(map_valid),
        valid_b=jnp.asarray(kp_valid),
        max_distance=matching.HAMMING_LOW,
        ratio=0.8,
    )
    matched = m.valid  # [M]
    obs = jnp.where(
        matched[:, None], kp_norm[jnp.clip(m.index, 0, None)], 0.0
    )
    weights = matched.astype(map_points.dtype) + 1e-9

    num_map = map_points.shape[0]

    def hypothesis(key):
        idx = jax.random.choice(
            key, num_map, shape=(6,), replace=False,
            p=weights / jnp.sum(weights),
        )
        pose = dlt_pose(map_points[idx], obs[idx], matched[idx].astype(
            map_points.dtype))
        cam = transform(pose, map_points)
        err = jnp.linalg.norm(project(cam) - obs, axis=-1)
        good = matched & (err < inlier_threshold) & (cam[:, 2] > 0)
        return pose, jnp.sum(good)

    keys = jax.random.split(rng_key, num_hypotheses)
    poses, scores = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(scores)
    pose0 = poses[best]

    result = optimize_pose(pose0, map_points, obs, matched)
    return RelocalizationResult(
        result.pose6, result.inliers, result.num_inliers, obs, matched
    )
