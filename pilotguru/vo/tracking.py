"""Monocular visual-odometry tracker: host state machine + device compute.

Replaces the reference's ORB_SLAM2 Tracking/LocalMapping/LoopClosing
pipeline (thirdparty/orb-slam2/src/Tracking.cc:272-498, LocalMapping.cc,
LoopClosing.cc) for the odometry use-case that optical_trajectories
consumes: per-frame camera poses until tracking is LOST.

Accelerator-first structure: all per-frame numerics (feature extraction, dense
Hamming matching, RANSAC initialization, robust pose refinement, local BA,
loop detection scoring, Sim3 fitting, pose-graph optimization) are
fixed-shape jitted device programs; the host keeps only the map bookkeeping
(fixed-capacity arrays) and the keyframe policy, mirroring how the
reference splits Tracking math from the map-maintenance threads.

Map maintenance mirrors LocalMapping (LocalMapping.cc):
  - recent map points are culled when their found-ratio drops below 0.25 or
    they fail to gather >2 keyframe observations (MapPointCulling, :170-206)
  - duplicate points are fused into the new keyframe (SearchInNeighbors,
    :454-525)
  - keyframes whose points are >=90% redundantly observed are dropped
    (KeyFrameCulling, :631-695)
  - when the fixed point arena fills, the worst off-window points are
    recycled (reported, never silent).

Per-frame poses are stored RELATIVE to their reference keyframe and the
absolute trajectory is reconstructed at the end from the current keyframe
poses (final_trajectory), matching System::GetTrajectory's
keyframe-relative reconstruction (System.cc:371-413) — so local-BA and
loop-closure keyframe corrections propagate to every frame.

States mirror the reference enum: NOT_INITIALIZED -> OK -> LOST
(Tracking.h eTrackingState).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.vo import matching
from pilotguru.vo.ba import BAProblem, bundle_adjust
from pilotguru.vo.features import extract_orb_features
from pilotguru.vo.pose import (
    geo_jit,
    compose_pose,
    matrix_to_quat,
    matrix_to_rotvec,
    optimize_pose,
    pose_delta,
    project,
    rotvec_to_matrix,
    transform,
)
from pilotguru.vo.relocalize import relocalize
from pilotguru.vo.twoview import triangulate, two_view_reconstruction

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"

# Distinct "caller did not pre-dispatch" marker for the split
# dispatch/commit keyframe-maintenance methods (None is a legitimate
# dispatch result meaning "nothing to do on device").
_NOT_DISPATCHED = object()


# Host-side 3x3 rotation helpers (numpy twins of vo/pose.py): pose
# composition runs several times per frame on scalars-and-3-vectors, where
# a device dispatch + result pull costs far more than the microseconds
# these take on the host. Same Taylor-safe formulas as the jax
# versions (kept in sync; the jax ones serve the jitted programs).
def np_rotvec_to_matrix(w):
    theta2 = float(w @ w)
    theta = np.sqrt(theta2 + 1e-30)
    k = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )
    if theta2 < 1e-12:
        a = 1.0 - theta2 / 6.0
        b = 0.5 - theta2 / 24.0
    else:
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta2
    return np.eye(3) + a * k + b * (k @ k)


def np_matrix_to_rotvec(r):
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    axis_raw = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    )
    sin = np.linalg.norm(axis_raw) / 2.0
    scale = theta / (2.0 * sin) if sin > 1e-9 else 0.5
    return axis_raw * scale


def np_matrix_to_quat(r):
    qw = np.sqrt(max(1.0 + r[0, 0] + r[1, 1] + r[2, 2], 1e-12)) / 2.0
    qx = np.sqrt(max(1.0 + r[0, 0] - r[1, 1] - r[2, 2], 1e-12)) / 2.0
    qy = np.sqrt(max(1.0 - r[0, 0] + r[1, 1] - r[2, 2], 1e-12)) / 2.0
    qz = np.sqrt(max(1.0 - r[0, 0] - r[1, 1] + r[2, 2], 1e-12)) / 2.0
    qx *= np.sign(r[2, 1] - r[1, 2]) or 1.0
    qy *= np.sign(r[0, 2] - r[2, 0]) or 1.0
    qz *= np.sign(r[1, 0] - r[0, 1]) or 1.0
    q = np.array([qw, qx, qy, qz])
    return q / np.linalg.norm(q)

# Jitted device programs (shape-keyed compile cache; the tracker feeds
# fixed/bucketed shapes so each compiles a handful of times per ride).
_match_descriptors = jax.jit(
    matching.match_descriptors, static_argnames=("max_distance", "ratio", "mutual")
)
_match_projected = jax.jit(
    matching.match_projected,
    static_argnames=("search_radius", "max_distance", "ratio"),
)
_two_view = geo_jit(
    two_view_reconstruction,
    static_argnames=("num_hypotheses", "inlier_threshold"),
)
_optimize_pose = geo_jit(
    optimize_pose,
    static_argnames=(
        "huber_delta", "inlier_threshold", "irls_rounds", "lm_iters",
    ),
)
_bundle_adjust = geo_jit(
    bundle_adjust,
    static_argnames=(
        "huber_delta", "inlier_threshold", "irls_rounds", "lm_iters", "solver",
    ),
)
_triangulate = geo_jit(triangulate)
_transform = geo_jit(transform)
_project = jax.jit(project)


@partial(
    geo_jit,
    static_argnames=(
        "search_radius", "refine_radius", "max_distance", "scale",
        "level_window", "huber_delta", "inlier_threshold",
    ),
)
def fused_track_step(
    points,  # [M, 3] map points (device-resident)
    point_desc,  # [M, 256]
    cand_mask,  # [M] bool — valid & local
    point_level,  # [M] int32 — creating keypoint's pyramid level
    predicted,  # [6] pose guess
    kp_norm,  # [K, 2]
    kp_desc,  # [K, 256]
    kp_valid,  # [K] bool
    kp_level,  # [K] int32
    search_radius: float,
    max_distance: int,
    scale: float = 1.2,
    level_window: int = 2,
    refine_radius: float = 0.0,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
):
    """One whole tracking attempt as a SINGLE device program: frustum test,
    projected matching (octave-aware), robust pose refinement with
    per-level information weights, and visibility stats — run TWICE: a
    wide-window motion-model pass (the reference's TrackWithMotionModel,
    15 px x sigma) followed by a tight-window re-match + re-refine around
    the optimized pose (TrackLocalMap's ~4 px x sigma SearchByProjection).
    The tight second pass is what disambiguates repetitive texture: a wide
    window around an uncertain prediction contains many near-identical
    descriptors (the ratio test then kills the match or, worse, aliases
    it), while a few-pixel window around an already-refined pose contains
    almost always exactly one. ``refine_radius`` <= 0 disables the second
    pass.

    No rotation-consistency filter here: the reference's map-point
    SearchByProjection (TrackLocalMap) has no orientation histogram either
    — a map point's creation-time angle drifts from the current frame's
    keypoint angle as the viewpoint changes, so the check would steadily
    reject true matches. Orientation checks apply only to frame<->frame /
    frame<->keyframe matching (init, ref-KF track, triangulation).

    Every dispatch and result pull pays host<->device latency, so the
    per-frame hot path is one call with the map already resident in device
    memory — only the frame's keypoints ride up and a few small vectors
    ride back. The fusion also removes per-op dispatch overhead.
    """
    # Field-of-view bounds for the found-ratio statistic, from this frame's
    # keypoint extent (Frame::isInFrustum checks image bounds).
    big = jnp.asarray(jnp.inf, kp_norm.dtype)
    lo = jnp.min(jnp.where(kp_valid[:, None], kp_norm, big), axis=0)
    hi = jnp.max(jnp.where(kp_valid[:, None], kp_norm, -big), axis=0)
    any_kp = jnp.any(kp_valid)

    def attempt(pose6, radius):
        cam = transform(pose6, points)
        in_front = (cam[:, 2] > 0.05) & cand_mask
        proj = project(cam)
        proj = jnp.where(in_front[:, None], proj, 1e3)
        in_view = in_front & jnp.all(
            (proj >= lo - radius) & (proj <= hi + radius), axis=1
        )
        in_view = jnp.where(any_kp, in_view, in_front)
        m = matching.match_projected(
            point_desc, proj, kp_desc, kp_norm,
            search_radius=radius,
            valid_a=in_front, valid_b=kp_valid,
            max_distance=max_distance,
            level_a=point_level, level_b=kp_level,
            scale=scale, level_window=level_window,
        )
        idx = jnp.clip(m.index, 0, None)
        obs = jnp.where(m.valid[:, None], kp_norm[idx], 0.0)
        # Information weights from the CURRENT frame's matched keypoint
        # level (the reference weighs each edge by invSigma2 of the
        # observing keypoint's octave, Optimizer.cc:126-127).
        inv_s = jnp.where(
            m.valid,
            (1.0 / scale) ** kp_level[idx].astype(kp_norm.dtype),
            1.0,
        )
        res = optimize_pose(
            pose6, points, obs, m.valid, obs_invsigma=inv_s,
            huber_delta=huber_delta, inlier_threshold=inlier_threshold,
        )
        return res, m, in_view

    res, m, in_view = attempt(predicted, search_radius)
    if refine_radius > 0.0:
        res2, m2, in_view2 = attempt(res.pose6, refine_radius)
        # Keep the refined result unless the tight window collapsed the
        # match set (a bad first pose would take everything down with it).
        better = res2.num_inliers >= jnp.minimum(res.num_inliers, 10)
        res = jax.tree_util.tree_map(
            lambda a, b: jnp.where(better, a, b), res2, res
        )
        m = matching.Matches(
            index=jnp.where(better, m2.index, m.index),
            distance=jnp.where(better, m2.distance, m.distance),
            valid=jnp.where(better, m2.valid, m.valid),
        )
        in_view = jnp.where(better, in_view2, in_view)
    # ONE packed f32 result vector: every host<->device round trip has a
    # fixed latency, so the whole per-frame result rides back in a single
    # array pull —
    # [pose6, num_inliers, match_idx[M], inliers[M], in_view[M]]. f32
    # represents the small integer indices exactly.
    f32 = jnp.float32
    packed = jnp.concatenate(
        [
            res.pose6.astype(f32),
            res.num_inliers.astype(f32)[None],
            m.index.astype(f32),
            res.inliers.astype(f32),
            in_view.astype(f32),
        ]
    )
    return packed


@partial(
    geo_jit,
    static_argnames=(
        "search_radius", "refine_radius", "max_distance", "scale",
        "level_window", "huber_delta", "inlier_threshold",
        "min_track_inliers",
    ),
)
def fused_track_chunk(
    points,  # [B, 3] compact local-map mirror (see fused_track_step)
    point_desc,  # [B, 256]
    cand_mask,  # [B] bool
    point_level,  # [B] int32
    pose0,  # [6] last tracked pose
    motion0,  # [6] motion-model delta (curr = motion o prev)
    kp_norm,  # C-tuple of [K, 2] (stacked in-trace; device slices fine)
    kp_desc,  # C-tuple of [K, 256]
    kp_valid,  # C-tuple of [K] bool
    kp_level,  # C-tuple of [K] int32
    search_radius: float,
    max_distance: int,
    scale: float = 1.2,
    level_window: int = 2,
    refine_radius: float = 0.0,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
    min_track_inliers: int = 25,
):
    """C consecutive tracking attempts as ONE device program (lax.scan over
    fused_track_step), carrying the pose + constant-velocity motion model
    on device between frames.

    This is the chunked-tracking shape the reference's per-frame
    Tracking::Track loop (Tracking.cc:272-498) maps to on a latency-bound
    accelerator: between keyframe decisions the map is immutable, so the
    only sequential state is (pose, motion) — scan it on device and let the
    host inspect the whole chunk's per-frame results from a single pull
    (one round trip buys C frames instead of one). A frame whose inlier count falls below ``min_track_inliers``
    freezes the carry (``failed``): later frames in the chunk would track
    from a broken pose, so the host discards them and re-runs the event
    frame through the full fallback path (ref-KF track / relocalization).

    Returns [C, 7 + 3B]: per frame the fused_track_step packed vector
    [pose6, num_inliers, match_idx[B], inliers[B], in_view[B]].
    """
    kp = jnp.stack(kp_norm)
    kd = jnp.stack(kp_desc)
    kv = jnp.stack(kp_valid)
    kl = jnp.stack(kp_level)
    dtype = jnp.asarray(pose0).dtype

    def step(carry, frame):
        pose, motion, failed = carry
        f_kp, f_kd, f_kv, f_kl = frame
        predicted = compose_pose(motion, pose)
        packed = fused_track_step(
            points, point_desc, cand_mask, point_level,
            predicted, f_kp, f_kd, f_kv, f_kl,
            search_radius=search_radius, max_distance=max_distance,
            scale=scale, level_window=level_window,
            refine_radius=refine_radius, huber_delta=huber_delta,
            inlier_threshold=inlier_threshold,
        )
        new_pose = packed[:6].astype(dtype)
        ok = (packed[6] >= min_track_inliers) & ~failed
        new_motion = pose_delta(pose, new_pose)
        pose = jnp.where(ok, new_pose, pose)
        motion = jnp.where(ok, new_motion, motion)
        return (pose, motion, failed | ~ok), packed

    init = (
        jnp.asarray(pose0, dtype),
        jnp.asarray(motion0, dtype),
        jnp.asarray(False),
    )
    _, packs = jax.lax.scan(step, init, (kp, kd, kv, kl))
    return packs


@partial(
    geo_jit,
    static_argnames=(
        "scale", "use_rotation_check", "huber_delta", "inlier_threshold",
    ),
)
def fused_ref_kf_track(
    kf_points,  # [K, 3] map-point positions per reference-keyframe keypoint
    kf_has_point,  # [K] bool — keypoint observes a valid map point
    kf_desc,  # [K, 256]
    kf_angle,  # [K]
    kf_point_ids,  # [K] int32 — map-point slot per keypoint (or 0)
    pose0,  # [6] starting pose (last tracked pose, NOT motion-extrapolated)
    kp_norm,  # [Kc, 2] current frame
    kp_desc,  # [Kc, 256]
    kp_valid,  # [Kc] bool
    kp_level,  # [Kc] int32
    kp_angle,  # [Kc]
    scale: float = 1.2,
    use_rotation_check: bool = True,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
):
    """TrackReferenceKeyFrame as ONE device program (Tracking.cc:317-323,
    748 — tried when motion-model tracking fails, BEFORE relocalization):
    descriptor-only matching against the reference keyframe's map-point
    observations (the reference's SearchByBoW — no projection window, so a
    wrong motion prediction cannot hide the true matches), then robust pose
    refinement from the LAST pose. Packed result:
    [pose6, num_inliers, point_id[Kc], inlier[Kc]] over CURRENT keypoints.
    """
    m = matching.match_descriptors(
        kp_desc, kf_desc,
        valid_a=kp_valid, valid_b=kf_has_point,
        max_distance=matching.HAMMING_LOW, ratio=0.7,  # SearchByBoW mfNNratio
    )
    if use_rotation_check:
        # Rows are CURRENT keypoints; m.index points into the reference
        # keyframe, so the histogram is over (kf_angle[match] - kp_angle).
        m = matching.rotation_consistency(kp_angle, kf_angle, m)
    idx = jnp.clip(m.index, 0, None)
    pts = kf_points[idx]
    inv_s = jnp.where(
        m.valid, (1.0 / scale) ** kp_level.astype(kp_norm.dtype), 1.0
    )
    res = optimize_pose(
        pose0, pts, kp_norm, m.valid, obs_invsigma=inv_s,
        huber_delta=huber_delta, inlier_threshold=inlier_threshold,
    )
    f32 = jnp.float32
    return jnp.concatenate(
        [
            res.pose6.astype(f32),
            res.num_inliers.astype(f32)[None],
            jnp.where(m.valid, kf_point_ids[idx], -1).astype(f32),
            res.inliers.astype(f32),
        ]
    )


def _create_points_impl(
    prev_desc,  # [K, 256]
    prev_un,  # [K] bool — unmatched & valid in previous keyframe
    prev_kp,  # [K, 2]
    prev_level,  # [K] int32
    prev_angle,  # [K]
    curr_desc,  # [K, 256]
    curr_un,  # [K] bool
    curr_kp,  # [K, 2]
    curr_level,  # [K] int32
    curr_angle,  # [K]
    delta6,  # [6] prev->curr relative pose
    prev_pose6,  # [6] world->prev camera
    min_parallax_cos: float,
    scale: float = 1.2,
    use_rotation_check: bool = True,
    reproj_gate: float = 0.01,
    epipolar_gate: float = 0.0,
):
    """LocalMapping::CreateNewMapPoints as ONE device program: descriptor
    matching + epipolar gating + rotation-consistency filter + two-view
    triangulation + cheirality/parallax/reprojection gating + world-frame
    transform, returning a single packed result vector (same round-trip
    rationale as fused_track_step). Reprojection gates scale with each
    observing keypoint's pyramid level (the reference gates on per-octave
    chi2, LocalMapping.cc CreateNewMapPoints).

    ``epipolar_gate`` > 0 enables the reference's epipolar-distance check
    on candidate pairs (ORBmatcher SearchForTriangulation ->
    CheckDistEpipolarLine): with repetitive texture, descriptor-only
    matching between two keyframes aliases onto lookalike corners; the
    known relative pose pins true matches to within ~2 px x sigma of the
    epipolar line and kills the rest before they become bogus map points.
    """
    m = matching.match_descriptors(
        prev_desc, curr_desc, valid_a=prev_un, valid_b=curr_un,
        max_distance=matching.HAMMING_LOW, ratio=0.85,
    )
    if use_rotation_check:
        m = matching.rotation_consistency(prev_angle, curr_angle, m)
    idx = jnp.clip(m.index, 0, None)
    p1 = prev_kp
    p2 = curr_kp[idx]
    if epipolar_gate > 0.0:
        r21 = rotvec_to_matrix(delta6[:3])
        t21 = delta6[3:]
        t_cross = jnp.asarray(
            [
                [0.0, -t21[2], t21[1]],
                [t21[2], 0.0, -t21[0]],
                [-t21[1], t21[0], 0.0],
            ],
            delta6.dtype,
        )
        essential = t_cross @ r21
        ones = jnp.ones(p1.shape[:-1] + (1,), p1.dtype)
        x1 = jnp.concatenate([p1, ones], axis=-1)
        x2 = jnp.concatenate([p2, ones], axis=-1)
        ex1 = x1 @ essential.T.astype(p1.dtype)
        etx2 = x2 @ essential.astype(p1.dtype)
        sampson_sq = jnp.sum(x2 * ex1, axis=-1) ** 2 / (
            ex1[:, 0] ** 2 + ex1[:, 1] ** 2
            + etx2[:, 0] ** 2 + etx2[:, 1] ** 2 + 1e-18
        )
        sigma2_gate = scale ** curr_level[idx].astype(p1.dtype)
        epi_ok = sampson_sq < (epipolar_gate * sigma2_gate) ** 2
        m = matching.Matches(
            index=jnp.where(epi_ok, m.index, -1),
            distance=m.distance,
            valid=m.valid & epi_ok,
        )
        idx = jnp.clip(m.index, 0, None)
        p2 = curr_kp[idx]
    r21 = rotvec_to_matrix(delta6[:3])
    t21 = delta6[3:]
    pts_prev = triangulate(r21, t21, p1, p2)

    z1 = pts_prev[:, 2]
    cam2 = pts_prev @ r21.T + t21
    z2 = cam2[:, 2]
    norm1 = jnp.linalg.norm(pts_prev, axis=1, keepdims=True) + 1e-12
    ray1 = pts_prev / norm1
    c2_in_prev = -(r21.T @ t21)
    ray2 = pts_prev - c2_in_prev
    ray2 = ray2 / (jnp.linalg.norm(ray2, axis=1, keepdims=True) + 1e-12)
    parallax_cos = jnp.sum(ray1 * ray2, axis=1)
    reproj1 = jnp.linalg.norm(pts_prev[:, :2] / z1[:, None] - p1, axis=1)
    reproj2 = jnp.linalg.norm(
        cam2[:, :2] / jnp.maximum(z2, 1e-9)[:, None] - p2, axis=1
    )
    sigma1 = scale ** prev_level.astype(p1.dtype)
    sigma2 = scale ** curr_level[idx].astype(p1.dtype)
    # Scale consistency (LocalMapping.cc:427-432): the point's distance
    # ratio to the two camera centers must agree with the octave ratio of
    # the two observing keypoints within ratioFactor = 1.5 * scaleFactor —
    # an aliased match between different-scale corners fails this even when
    # it slips past descriptor distance and the epipolar gate.
    dist1 = jnp.linalg.norm(pts_prev, axis=1)
    dist2 = jnp.linalg.norm(pts_prev - c2_in_prev, axis=1)
    ratio_dist = dist2 / jnp.maximum(dist1, 1e-12)
    ratio_octave = sigma1 / sigma2
    ratio_factor = 1.5 * scale
    scale_ok = (ratio_dist * ratio_factor >= ratio_octave) & (
        ratio_dist <= ratio_octave * ratio_factor
    )
    good = (
        m.valid
        & (z1 > 0.05) & (z2 > 0.05)
        & (parallax_cos < min_parallax_cos)
        & (reproj1 < reproj_gate * sigma1) & (reproj2 < reproj_gate * sigma2)
        & scale_ok
        & jnp.all(jnp.isfinite(pts_prev), axis=1)
    )
    r_prev = rotvec_to_matrix(prev_pose6[:3])
    pts_world = (pts_prev - prev_pose6[3:]) @ r_prev  # R^T (x - t)

    f32 = jnp.float32
    return jnp.concatenate(
        [
            m.index.astype(f32),
            good.astype(f32),
            pts_world.astype(f32).ravel(),
        ]
    )


fused_create_points = partial(
    geo_jit,
    static_argnames=(
        "min_parallax_cos", "scale", "use_rotation_check", "reproj_gate",
        "epipolar_gate",
    ),
)(_create_points_impl)


@partial(
    geo_jit,
    static_argnames=(
        "min_parallax_cos", "scale", "use_rotation_check", "reproj_gate",
        "epipolar_gate",
    ),
)
def fused_create_points_multi(
    prev_desc,  # [P, K, 256] — stacked neighbor keyframes
    prev_un,  # [P, K]
    prev_kp,  # [P, K, 2]
    prev_level,  # [P, K]
    prev_angle,  # [P, K]
    curr_desc,  # [K, 256] — the one new keyframe, shared across pairs
    curr_un,  # [K]
    curr_kp,  # [K, 2]
    curr_level,  # [K]
    curr_angle,  # [K]
    delta6,  # [P, 6]
    prev_pose6,  # [P, 6]
    min_parallax_cos: float,
    scale: float = 1.2,
    use_rotation_check: bool = True,
    reproj_gate: float = 0.01,
    epipolar_gate: float = 0.0,
):
    """All of a keyframe's triangulation pairs as ONE device program
    (vmapped _create_points_impl over the stacked neighbor axis): one
    dispatch and one packed [P, 5K] result instead of P round trips. Inactive
    (padding / degenerate-baseline) pairs ride along with an all-False
    ``prev_un`` mask."""

    def one(pd, pu, pk, pl, pa, d6, pp6):
        return _create_points_impl(
            pd, pu, pk, pl, pa,
            curr_desc, curr_un, curr_kp, curr_level, curr_angle,
            d6, pp6,
            min_parallax_cos=min_parallax_cos, scale=scale,
            use_rotation_check=use_rotation_check, reproj_gate=reproj_gate,
            epipolar_gate=epipolar_gate,
        )

    return jax.vmap(one)(
        prev_desc, prev_un, prev_kp, prev_level, prev_angle, delta6, prev_pose6
    )


@partial(
    geo_jit,
    static_argnames=("search_radius", "max_distance", "scale", "level_window"),
)
def fused_project_match(
    points,  # [M, 3]
    point_desc,  # [M, 256]
    cand_mask,  # [M] bool
    point_level,  # [M] int32
    pose6,  # [6]
    kp_desc,  # [K, 256]
    kp_norm,  # [K, 2]
    kp_valid,  # [K] bool
    kp_level,  # [K] int32
    search_radius: float,
    max_distance: int,
    scale: float = 1.2,
    level_window: int = 2,
):
    """Project candidate map points into a keyframe and match (the fusion
    search), packed into one result pull: [match_idx M, ok M]."""
    cam = transform(pose6, points)
    in_front = (cam[:, 2] > 0.05) & cand_mask
    proj = project(cam)
    proj = jnp.where(in_front[:, None], proj, 1e3)
    m = matching.match_projected(
        point_desc, proj, kp_desc, kp_norm,
        search_radius=search_radius,
        valid_a=in_front, valid_b=kp_valid,
        max_distance=max_distance,
        level_a=point_level, level_b=kp_level,
        scale=scale, level_window=level_window,
    )
    f32 = jnp.float32
    return jnp.concatenate([m.index.astype(f32), m.valid.astype(f32)])


@dataclass(frozen=True)
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    # Radial/tangential lens distortion (OpenCV convention). The reference
    # undistorts every keypoint before any geometry
    # (thirdparty/orb-slam2/src/Frame.cc:408 UndistortKeyPoints) and its
    # calibrate tool writes these for real phone lenses
    # (src/calibrate.cc:508-516); k1 ~ -0.28 is typical, so skipping this
    # biases every triangulation and turn angle on real rides.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def has_distortion(self) -> bool:
        return any(abs(c) > 1e-12 for c in (self.k1, self.k2, self.p1, self.p2))

    def _undistort_normalized(self, xy):
        """Invert the OpenCV distortion model on the normalized plane.

        Fixed-point iteration (the cv2.undistortPoints scheme): start at the
        distorted coordinates and repeatedly divide out the radial factor /
        subtract the tangential shift. Convergence is geometric with rate
        ~|d(radial)/dr * r|; at image corners of a k1 ~ -0.3 lens that is
        ~0.5 per round, so 40 rounds reach float64 noise (cv2 uses the same
        scheme with a 40-iteration cap). Runs on host once per frame over
        ~2000 keypoints — vectorized numpy is microseconds.
        """
        xd = xy[..., 0]
        yd = xy[..., 1]
        x, y = xd, yd
        for _ in range(40):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + self.k2 * r2)
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return np.stack([x, y], axis=-1)

    def normalize(self, xy):
        """Pixel -> undistorted normalized-plane coordinates."""
        norm = np.stack(
            [(xy[..., 0] - self.cx) / self.fx, (xy[..., 1] - self.cy) / self.fy],
            axis=-1,
        )
        if self.has_distortion():
            norm = self._undistort_normalized(norm)
        return norm

    def denormalize(self, xy_norm):
        """Undistorted normalized-plane -> pixel coordinates (exact forward
        distortion model; inverse of :meth:`normalize`). Used by the
        visualization overlay to place tracked features back on the frame."""
        x = xy_norm[..., 0]
        y = xy_norm[..., 1]
        if self.has_distortion():
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + self.k2 * r2)
            xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            x, y = xd, yd
        return np.stack(
            [x * self.fx + self.cx, y * self.fy + self.cy], axis=-1
        )


@partial(jax.jit, static_argnames=("camera",))
def normalize_keypoints_device(xy, camera: "CameraModel"):
    """Device twin of CameraModel.normalize (pixel -> undistorted
    normalized-plane coordinates): the batched prefetcher normalizes on
    device so keypoint arrays never detour through the host on the chunked
    tracking path. Same fixed-point undistortion scheme (40 rounds, the
    cv2.undistortPoints iteration) as the host version."""
    x = (xy[..., 0] - camera.cx) / camera.fx
    y = (xy[..., 1] - camera.cy) / camera.fy
    if camera.has_distortion():
        xd, yd = x, y

        def body(_, pair):
            px, py = pair
            r2 = px * px + py * py
            radial = 1.0 + r2 * (camera.k1 + camera.k2 * r2)
            dx = 2.0 * camera.p1 * px * py + camera.p2 * (r2 + 2.0 * px * px)
            dy = camera.p1 * (r2 + 2.0 * py * py) + 2.0 * camera.p2 * px * py
            return ((xd - dx) / radial, (yd - dy) / radial)

        x, y = jax.lax.fori_loop(0, 40, body, (xd, yd))
    return jnp.stack([x, y], axis=-1)


@dataclass(frozen=True)
class TrackerConfig:
    # Reference feature budget: 2000 features over 8 pyramid levels
    # (/root/reference/src/calibrate.cc:518-531).
    total_budget: int = 2000
    num_levels: int = 8
    scale: float = 1.2  # pyramid scale factor (ORBextractor_scaleFactor)
    fast_threshold: float = 20.0 / 255.0
    max_map_points: int = 4096
    # Octave-aware matching (ORBmatcher mvScaleFactors semantics): search
    # radii scale with the map point's creation level, candidates must sit
    # within this many octaves, and residuals are information-weighted by
    # the observing keypoint's level.
    level_window: int = 2
    # Rotation-consistency filtering (ORBmatcher CheckOrientation).
    rotation_consistency: bool = True
    # --- Pixel-calibrated geometric gates -------------------------------
    # The reference expresses every search window and chi2 gate in PIXELS
    # scaled by the octave sigma (ORBmatcher th * mvScaleFactors,
    # Optimizer 5.991-chi2); a normalized-plane constant silently loosens
    # with focal length (0.08 normalized = 20 px at fx 250 but 56 px at a
    # phone camera's fx 700 — wide enough to swallow dozens of aliased
    # corner candidates and corrupt the map). These are converted to
    # normalized units with the camera's fx at tracker construction; the
    # explicit *_radius overrides below win when set (unit-test scenes
    # feed normalized coordinates directly).
    track_search_px: float = 15.0  # motion-model window (ORBmatcher th=15 mono)
    track_refine_px: float = 4.0  # post-refinement local-map window (th~1 x 2.5-4)
    fuse_search_px: float = 5.0  # duplicate-fusion projection window
    reproj_gate_px: float = 2.5  # triangulation reprojection gate (~sqrt(5.991))
    epipolar_gate_px: float = 2.0  # triangulation epipolar gate (~sqrt(3.84))
    inlier_px: float = 2.5  # pose/BA chi2 inlier gate
    huber_px: float = 1.5  # robust-loss knee
    # Monocular initialization matches only the finest pyramid levels
    # (the reference's SearchForInitialization restricts to octave 0).
    init_max_level: int = 0
    # Minimum initial-map size below which init retries with ALL levels
    # (the reference avoids this by doubling the init feature budget).
    init_rich_points: int = 100
    # TrackReferenceKeyFrame fallback before relocalization
    # (Tracking.cc:317-323): descriptor-only re-track against the reference
    # keyframe when motion-model tracking fails.
    track_ref_kf_fallback: bool = True
    # Frames tracked per device call in the chunked path (process_chunk):
    # between keyframe decisions the map is immutable, so C frames ride one
    # host<->device round trip instead of C. TWO keyframe_max_gap
    # intervals: chunk_through_keyframes consumes through the first
    # keyframe insertion and stops at the second trigger, so one dispatch
    # covers a whole keyframe cycle plus the run-up to the next. Whether
    # chunking pays on the GPU is not measured. 0 disables chunking.
    track_chunk_frames: int = 16
    # Consume the WHOLE chunk even when a keyframe lands mid-chunk: frames
    # after the insertion keep their device results, i.e. they tracked
    # against the pre-keyframe map. This is the reference's real execution
    # model — Tracking never waits for LocalMapping, so frames following a
    # keyframe run against the not-yet-updated map (LocalMapping.cc
    # integrates the keyframe concurrently) — and it halves the device
    # round trips per keyframe cycle. False reverts to rewind-at-keyframe
    # (exact per-frame-path equivalence, used by the parity test).
    chunk_through_keyframes: bool = True
    # Triangulate each new keyframe against its N most recent predecessors
    # (closest first). The reference's CreateNewMapPoints walks up to 20
    # covisibility-ordered neighbor keyframes (LocalMapping.cc:454-525,
    # GetBestCovisibilityKeyFrames(20)); recency is the covisibility proxy
    # for a forward-moving monocular rig, and the extra (older) pairs carry
    # the larger baselines that actually pass the parallax gate.
    create_neighbor_kfs: int = 3
    local_window: int = 6  # keyframes in local BA
    min_init_matches: int = 60
    min_init_inliers: int = 40
    min_track_inliers: int = 25
    keyframe_inlier_ratio: float = 0.75
    keyframe_max_gap: int = 8
    # Normalized-plane override for the motion-model search window; None
    # derives track_search_px / camera.fx (unit-test scenes that feed
    # normalized coordinates directly set this explicitly).
    match_search_radius: Optional[float] = None
    min_parallax_cos: float = 0.9999
    ba_every_keyframe: bool = True
    # Run the per-keyframe local BA asynchronously (the reference's
    # LocalMapping-thread model): dispatch at the keyframe, finish the
    # keyframe's host work while it runs, fold the landed result in at the
    # next track dispatch (or closure attempt / finalize). Removes the BA
    # round trip from the tracking critical path; False restores the
    # synchronous apply-at-insertion behavior.
    ba_async: bool = True
    # --- map maintenance (LocalMapping parity) ---
    cull_found_ratio: float = 0.25  # MapPointCulling GetFoundRatio threshold
    cull_min_observations: int = 2  # monocular cnThObs (LocalMapping.cc:177)
    fuse_search_radius: Optional[float] = None  # normalized override (see above)
    keyframe_cull_redundancy: float = 0.9  # KeyFrameCulling 90% rule
    keyframe_cull_min_obs: int = 3  # "seen in at least other 3 keyframes"
    # --- loop closing ---
    enable_loop_closing: bool = True
    loop_exclude_recent: int = 10  # don't match against this many recent KFs
    loop_min_match_count: int = 50  # descriptor votes to become a candidate
    loop_min_inliers: int = 20  # Sim3-RANSAC inliers to accept the loop
    loop_cooldown_keyframes: int = 10  # min KFs between accepted closures
    # Post-closure bundle adjustment scope: "global" re-optimizes the whole
    # map against the fused seam (RunGlobalBundleAdjustment parity — the
    # accuracy winner, one big dense solve that suits an accelerator but
    # is slow to compile on a 1-core CPU), "seam" optimizes the candidate + current
    # neighborhoods only (cheap, most of the benefit lands at the seam),
    # "none" relies on the pose graph alone.
    loop_ba: str = "global"


@dataclass
class FramePose:
    frame_id: int
    time_usec: int
    pose6: np.ndarray  # world->camera [rotvec, t] at track time
    is_lost: bool = False
    # Reference-keyframe anchoring (System::GetTrajectory semantics): the
    # final pose is rel6 composed onto the CURRENT pose of keyframe
    # ref_kf_id, so keyframe corrections (BA, loop closure) propagate.
    ref_kf_id: int = -1
    rel6: Optional[np.ndarray] = None

    def camera_to_world_quat(self) -> np.ndarray:
        return np_matrix_to_quat(np_rotvec_to_matrix(self.pose6[:3]).T)

    def camera_center(self) -> np.ndarray:
        r = np_rotvec_to_matrix(self.pose6[:3])
        return -(r.T @ self.pose6[3:])


class _FrameFeatures(NamedTuple):
    """One frame's extracted features as fed to the tracker."""

    kp_norm: np.ndarray  # [K, 2]
    desc: np.ndarray  # [K, 256] (may be device-resident until keyframed)
    valid: np.ndarray  # [K] bool
    level: np.ndarray  # [K] int32
    angle: np.ndarray  # [K] float32


class Keyframe:
    """One keyframe's host-side state (plain class: identity semantics —
    loop/cull bookkeeping compares keyframes BY OBJECT, see kf_id).

    ``descriptors`` may be constructed from a DEVICE array (the batched
    prefetcher keeps descriptors device-resident): the host copy starts
    asynchronously at construction and materializes lazily on first host
    access — by then (the triangulation pull, ~50 ms later on the keyframe
    path) the transfer has landed, so keyframe insertion never blocks on a
    full 512 KB descriptor pull. The original device array stays
    available via ``device_descriptors`` so the per-keyframe device cache
    reuses it instead of re-uploading the bytes it just pulled."""

    def __init__(
        self, pose6, kp_norm, descriptors, kp_valid, map_point,
        num_inliers=0, kf_id=-1, kp_level=None, kp_angle=None,
    ):
        self.pose6 = pose6
        self.kp_norm = kp_norm  # [K, 2] normalized coords
        self._descriptors = descriptors  # [K, 256] uint8 (host or device)
        if hasattr(descriptors, "copy_to_host_async"):
            self._descriptors_dev = descriptors
            descriptors.copy_to_host_async()
        else:
            self._descriptors_dev = None
        self.kp_valid = kp_valid  # [K] bool
        self.map_point = map_point  # [K] int32 — map point index or -1
        self.num_inliers = num_inliers
        self.kf_id = kf_id  # stable id (survives keyframe culling)
        k = kp_norm.shape[0]
        self.kp_level = (
            kp_level if kp_level is not None else np.zeros(k, np.int32)
        )
        self.kp_angle = (
            kp_angle if kp_angle is not None else np.zeros(k, np.float32)
        )

    @property
    def descriptors(self) -> np.ndarray:
        if not isinstance(self._descriptors, np.ndarray):
            self._descriptors = np.asarray(self._descriptors)
        return self._descriptors

    def device_descriptors(self):
        """The construction-time device array, or None (host-built frames)."""
        return self._descriptors_dev


class MonocularTracker:
    """Feature-based monocular odometry over a frame stream."""

    def __init__(
        self,
        camera: CameraModel,
        config: TrackerConfig = TrackerConfig(),
        feature_fn=None,
    ):
        self.camera = camera
        self.config = config
        self.state = NOT_INITIALIZED
        self._feature_fn = feature_fn or self._extract
        # Pixel-calibrated gates -> normalized-plane units via the camera
        # focal (the reference's windows/chi2 gates are all pixel x octave-
        # sigma quantities; see TrackerConfig). Explicit normalized
        # overrides win. Unit-test rigs feed normalized coordinates through
        # an fx=1 identity camera; for those, convert at the 250 px focal
        # the legacy normalized defaults were tuned at (2.5 px / 250 px
        # reproduces the old 0.01 gate exactly).
        fx = float(camera.fx)
        if fx <= 10.0:
            fx = 250.0
        self._search_rad = (
            config.match_search_radius
            if config.match_search_radius is not None
            else config.track_search_px / fx
        )
        self._refine_rad = (
            min(self._search_rad, config.track_refine_px / fx)
            if config.match_search_radius is None
            else self._search_rad
        )
        self._fuse_rad = (
            config.fuse_search_radius
            if config.fuse_search_radius is not None
            else config.fuse_search_px / fx
        )
        self._reproj_gate = config.reproj_gate_px / fx
        self._epi_gate = config.epipolar_gate_px / fx
        self._inlier_thresh = config.inlier_px / fx
        self._huber = config.huber_px / fx
        # Map storage (fixed capacity).
        m = config.max_map_points
        self.points = np.zeros((m, 3), np.float64)
        self.point_desc = np.zeros((m, 256), np.uint8)
        self.point_valid = np.zeros((m,), bool)
        # Creating observation's pyramid level and orientation: drive
        # octave-aware search radii / level gating and the rotation-
        # consistency filter (ORB-SLAM2 keeps these on MapPoint via its
        # reference keypoint).
        self.point_level = np.zeros((m,), np.int32)
        self.point_angle = np.zeros((m,), np.float32)
        # Per-point statistics for LocalMapping-style maintenance.
        self.point_visible = np.zeros((m,), np.int32)  # frustum appearances
        self.point_found = np.zeros((m,), np.int32)  # tracked-inlier hits
        self.point_first_kf = np.full((m,), -1, np.int32)  # creating kf_id
        self.point_recent = np.zeros((m,), bool)  # in the recent-cull list
        self.keyframes: List[Keyframe] = []
        self.trajectory: List[FramePose] = []
        self._init_frame = None  # (kp_norm, desc, valid, frame_id, time)
        self._init_attempts = 0
        self._pose = np.zeros(6)
        self._motion = np.zeros(6)  # se3-ish delta applied per frame
        # Keypoint rows tracked as inliers in the latest frame (overlay).
        self.last_track_kp_rows = np.zeros(0, np.int32)
        self._frames_since_keyframe = 0
        self._rng = jax.random.PRNGKey(0)
        self._next_kf_id = 0
        self._last_loop_kf_id = -(10**9)  # kf_id of the last accepted loop
        # In-flight deferred local BA: (device result, window keyframes,
        # arena pids of its points). See _windowed_bundle_adjust(deferred=).
        self._pending_ba = None
        # Deferred arena descriptor writes: (slots, source keyframe, rows).
        # Created points' descriptors come from the keyframe's LAZY host
        # copy (see Keyframe) — writing them at creation time would block
        # on that 512 KB transfer mid-keyframe; instead they flush at the
        # next arena-descriptor READ (_flush_point_desc), by which time
        # the copy has landed.
        self._pending_point_desc: list = []
        self._last_loop_cand_kf_id = -1  # loop candidate's stable kf_id
        # Local-map mask: points observed by the recent keyframe window.
        # Per-frame tracking matches ONLY these (Tracking::TrackLocalMap
        # semantics) — matching the whole map would act as continuous
        # implicit relocalization, masking drift and starving loop closure
        # of its signal. Relocalization still searches the full map.
        self._local_points = np.zeros((m,), bool)
        # Device-resident keyframe descriptors for loop detection, keyed by
        # kf_id: uploaded once per keyframe so the per-insertion candidate
        # sweep stacks on-device instead of re-transferring every stored
        # keyframe (O(K) device copies instead of O(K) host round trips).
        self._kf_desc_dev: Dict[int, tuple] = {}
        # Device-resident map mirror for the per-frame hot path. Map
        # mutations happen only at keyframe cadence; between keyframes every
        # frame reuses the same device copy (invalidated via
        # _invalidate_device_map).
        self._dev_map = None
        self._dev_map_sel = None  # arena indices behind the compact mirror
        self._dev_map_count = 0
        self._dev_map_full = None  # full-arena mirror (relocalization only)
        # Maintenance observability (never silently degrade the map).
        self.stats: Dict[str, int] = {
            "points_created": 0,
            "points_culled": 0,
            "points_fused": 0,
            "points_recycled": 0,
            "points_skipped_capacity": 0,
            "points_dropped": 0,
            "keyframes_culled": 0,
            "loop_closures": 0,
            "ref_kf_recoveries": 0,
        }

    def _invalidate_device_map(self):
        self._dev_map = None
        self._dev_map_sel = None
        self._dev_map_full = None

    def _flush_point_desc(self):
        """Apply deferred created-point descriptor writes (ordered, so a
        recycled slot ends with its newest creation's descriptor). Must run
        before ANY read of ``point_desc``."""
        for slots, kf_src, rows in self._pending_point_desc:
            self.point_desc[slots] = kf_src.descriptors[rows]
        self._pending_point_desc.clear()

    def _device_map(self):
        """COMPACT local-map mirror resident on device, re-uploaded only
        after map mutations (keyframe cadence).

        The per-frame hot path only ever matches against the local window
        (point_valid & _local_points — typically well under half the
        arena), so the candidate set is gathered into a power-of-two bucket
        before upload: every [M, K] table op in fused_track_step (the
        per-frame elementwise cost) shrinks with the bucket instead of paying the
        full arena. Bucket floor 1024 keeps the shape count (and XLA
        compiles) to at most {1024, 2048, ..., arena} per ride. Returns
        (points [B, 3], desc [B, 256], mask [B], level [B]); the arena
        indices behind the rows live in _dev_map_sel / _dev_map_count for
        the host-side scatter-back in _track_attempt."""
        if self._dev_map is None:
            self._flush_point_desc()
            cap = self.config.max_map_points
            cand = np.nonzero(self.point_valid & self._local_points)[0]
            bucket = min(1024, cap)
            while bucket < len(cand):
                bucket *= 2
            bucket = min(bucket, cap)
            sel = np.zeros(bucket, np.int64)
            sel[: len(cand)] = cand
            mask = np.zeros(bucket, bool)
            mask[: len(cand)] = True
            self._dev_map_sel = sel
            self._dev_map_count = len(cand)
            self._dev_map = (
                jnp.asarray(self.points[sel]),
                jnp.asarray(self.point_desc[sel]),
                jnp.asarray(mask),
                jnp.asarray(self.point_level[sel]),
            )
        return self._dev_map

    def _device_map_full(self):
        """Full-arena device mirror — relocalization searches the WHOLE map
        (Tracking.cc Relocalization), so it cannot use the compact local
        mirror. Uploaded lazily (relocalization is rare) and invalidated on
        the same choke point as the compact mirror."""
        if self._dev_map_full is None:
            self._flush_point_desc()
            self._dev_map_full = (
                jnp.asarray(self.points),
                jnp.asarray(self.point_desc),
                jnp.asarray(self.point_valid),
            )
        return self._dev_map_full

    def warm_track_buckets(self):
        """Pre-compile fused_track_step for every local-map bucket this
        tracker can grow into ({1024, 2048, ..., arena}, see _device_map),
        with the exact static arguments and dtypes the per-frame path uses.
        Benchmarks and latency-sensitive callers run this once up front so
        a mid-ride bucket jump never lands an XLA compile inside the
        steady-state frame loop."""
        k = self.config.total_budget
        rng = np.random.default_rng(0)
        kp = jnp.asarray(rng.uniform(-0.5, 0.5, (k, 2)))
        kd = jnp.asarray(rng.integers(0, 2, (k, 256)).astype(np.uint8))
        kv = jnp.asarray(np.ones(k, bool))
        kl = jnp.asarray(np.zeros(k, np.int32))
        bucket = min(1024, self.config.max_map_points)
        while True:
            m_pts = jnp.asarray(rng.normal(size=(bucket, 3)))
            m_desc = jnp.asarray(
                rng.integers(0, 2, (bucket, 256)).astype(np.uint8)
            )
            m_cand = jnp.asarray(np.ones(bucket, bool))
            m_level = jnp.asarray(np.zeros(bucket, np.int32))
            jax.block_until_ready(
                fused_track_step(
                    m_pts, m_desc, m_cand, m_level,
                    jnp.asarray(np.zeros(6)),
                    kp, kd, kv, kl,
                    search_radius=self._search_rad,
                    max_distance=matching.HAMMING_HIGH,
                    scale=self.config.scale,
                    level_window=self.config.level_window,
                    refine_radius=self._refine_rad,
                    huber_delta=self._huber,
                    inlier_threshold=self._inlier_thresh,
                )
            )
            if self.config.track_chunk_frames > 0:
                c = self.config.track_chunk_frames
                jax.block_until_ready(
                    fused_track_chunk(
                        m_pts, m_desc, m_cand, m_level,
                        jnp.asarray(np.zeros(6)), jnp.asarray(np.zeros(6)),
                        (kp,) * c, (kd,) * c, (kv,) * c, (kl,) * c,
                        search_radius=self._search_rad,
                        max_distance=matching.HAMMING_HIGH,
                        scale=self.config.scale,
                        level_window=self.config.level_window,
                        refine_radius=self._refine_rad,
                        huber_delta=self._huber,
                        inlier_threshold=self._inlier_thresh,
                        min_track_inliers=self.config.min_track_inliers,
                    )
                )
            if bucket >= self.config.max_map_points:
                break
            bucket *= 2

    # ---------------------------------------------------------------- utils
    def _extract(self, gray):
        gray = np.asarray(gray)
        if gray.dtype == np.uint8:
            gray = gray.astype(np.float32) / 255.0
        kps = extract_orb_features(
            jnp.asarray(gray, jnp.float32),
            num_levels=self.config.num_levels,
            scale=self.config.scale,
            total_budget=self.config.total_budget,
            threshold=self.config.fast_threshold,
        )
        return (
            self.camera.normalize(np.asarray(kps.xy)),
            np.asarray(kps.descriptors),
            np.asarray(kps.valid),
            np.asarray(kps.level),
            np.asarray(kps.angle),
        )

    def _next_key(self):
        self._rng, sub = jax.random.split(self._rng)
        return sub

    def _point_observations(self) -> np.ndarray:
        """Number of keyframes observing each map point ([max_map_points])."""
        obs = np.zeros(self.config.max_map_points, np.int64)
        for kf in self.keyframes:
            refs = kf.map_point[kf.map_point >= 0]
            np.add.at(obs, refs, 1)
        return obs

    def _cull_points(self, pids: np.ndarray):
        """Remove map points: free slots + drop keyframe references."""
        if pids.size == 0:
            return
        self.point_valid[pids] = False
        self.point_recent[pids] = False
        self.point_visible[pids] = 0
        self.point_found[pids] = 0
        self.point_first_kf[pids] = -1
        dead = np.zeros(self.config.max_map_points, bool)
        dead[pids] = True
        for kf in self.keyframes:
            refs = kf.map_point >= 0
            kill = np.zeros_like(refs)
            kill[refs] = dead[kf.map_point[refs]]
            kf.map_point[kill] = -1
        self.stats["points_culled"] += int(pids.size)

    def _free_slots(self, count):
        """Indices of ``count`` free map slots, recycling the worst points
        under arena pressure (the round-1 version silently truncated here).
        """
        free = np.nonzero(~self.point_valid)[0]
        if free.size >= count:
            return free[:count]
        # Recycle: evict lowest-found-ratio points that are NOT referenced by
        # the recent keyframe window (evicting live local points would break
        # tracking; old low-quality points are the right victims).
        needed = count - free.size
        in_window = np.zeros(self.config.max_map_points, bool)
        for kf in self.keyframes[-self.config.local_window:]:
            refs = kf.map_point[kf.map_point >= 0]
            in_window[refs] = True
        candidates = np.nonzero(self.point_valid & ~in_window)[0]
        if candidates.size:
            ratio = self.point_found[candidates] / np.maximum(
                self.point_visible[candidates], 1
            )
            victims = candidates[np.argsort(ratio, kind="stable")[:needed]]
            self._cull_points(victims)
            self.stats["points_recycled"] += int(victims.size)
            self.stats["points_culled"] -= int(victims.size)  # counted above
            free = np.nonzero(~self.point_valid)[0]
        if free.size < count:
            # Creation demand exceeded free + recyclable capacity: the
            # allocator backs off (creation is opportunistic; evicting
            # live-window points to honor it would break tracking). This is
            # reported policy, not silent loss — ``points_dropped`` stays
            # reserved for genuine accounting failures and must remain 0.
            self.stats["points_skipped_capacity"] += int(count - free.size)
        return free[:count]

    def _kf_index_by_id(self) -> Dict[int, int]:
        return {kf.kf_id: i for i, kf in enumerate(self.keyframes)}

    def _cache_kf_descriptors(self, kf: Keyframe):
        dev = kf.device_descriptors()
        self._kf_desc_dev[kf.kf_id] = (
            # Prefetched keyframes: descriptors are ALREADY device-resident —
            # reuse that array instead of re-uploading the 512 KB we are
            # concurrently pulling down for the host copy.
            dev if dev is not None else jnp.asarray(kf.descriptors),
            jnp.asarray(kf.kp_valid),
        )

    def kf_descriptors_device(self, kf: Keyframe):
        """Device copies of a keyframe's descriptors (cached per kf_id)."""
        if kf.kf_id not in self._kf_desc_dev:
            self._cache_kf_descriptors(kf)
        return self._kf_desc_dev[kf.kf_id]

    def _refresh_local_points(self):
        """Local map = points observed by the recent keyframe window
        (covisibility-lite: the reference's UpdateLocalMap gathers keyframes
        sharing points with the current frame; with a bounded window the
        recent keyframes are exactly those)."""
        local = np.zeros(self.config.max_map_points, bool)
        for kf in self.keyframes[-self.config.local_window:]:
            refs = kf.map_point[kf.map_point >= 0]
            local[refs] = True
        self._local_points = local & self.point_valid
        # Every map mutation path funnels through here (keyframe cadence),
        # so this is the single choke point for the device mirror.
        self._invalidate_device_map()

    # ------------------------------------------------------------ lifecycle
    def process_frame(self, gray, frame_id: int, time_usec: int) -> str:
        feats = self._feature_fn(gray)
        kp_norm, desc, valid = feats[:3]
        kp_level, kp_angle = (feats[3], feats[4]) if len(feats) > 3 else (None, None)
        return self.process_features(
            kp_norm, desc, valid, frame_id, time_usec,
            kp_level=kp_level, kp_angle=kp_angle,
        )

    def process_features(
        self, kp_norm, desc, valid, frame_id: int, time_usec: int,
        kp_level=None, kp_angle=None,
    ) -> str:
        """Feed one frame's PRE-EXTRACTED features (batched-prefetch path).

        ``kp_level``/``kp_angle`` (pyramid level + orientation per keypoint)
        drive octave-aware matching and rotation-consistency filtering; when
        omitted (single-level test callers) both default to zeros, which
        reduces every octave rule to a no-op.
        """
        k = kp_norm.shape[0]
        if kp_level is None:
            kp_level = np.zeros(k, np.int32)
        if kp_angle is None:
            kp_angle = np.zeros(k, np.float32)
        frame = _FrameFeatures(kp_norm, desc, valid, kp_level, kp_angle)
        if self.state == NOT_INITIALIZED:
            self._try_initialize(frame, frame_id, time_usec)
        elif self.state == OK:
            self._track(frame, frame_id, time_usec)
        return self.state

    def _append_frame(self, frame_id, time_usec, pose6, is_lost=False):
        kf = self.keyframes[-1] if self.keyframes else None
        rel = self._pose_delta(kf.pose6, pose6) if kf is not None else None
        self.trajectory.append(
            FramePose(
                frame_id,
                time_usec,
                np.asarray(pose6).copy(),
                is_lost=is_lost,
                ref_kf_id=kf.kf_id if kf is not None else -1,
                rel6=rel,
            )
        )

    def final_trajectory(self) -> List[FramePose]:
        """Absolute per-frame poses reconstructed from the CURRENT keyframe
        poses (BA/loop corrections included) — System::GetTrajectory
        semantics (System.cc:371-413)."""
        self._apply_pending_ba()  # idempotent; landed long ago
        by_id = {kf.kf_id: kf for kf in self.keyframes}
        out = []
        for fp in self.trajectory:
            kf = by_id.get(fp.ref_kf_id)
            if kf is None or fp.rel6 is None:
                pose = fp.pose6
            else:
                pose = self._compose(fp.rel6, kf.pose6)
            out.append(
                FramePose(fp.frame_id, fp.time_usec, np.asarray(pose),
                          is_lost=fp.is_lost, ref_kf_id=fp.ref_kf_id,
                          rel6=fp.rel6)
            )
        return out

    # ------------------------------------------------------- initialization
    def _try_initialize(self, frame: _FrameFeatures, frame_id, time_usec):
        kp_norm, desc, valid = frame.kp_norm, frame.desc, frame.valid
        if self._init_frame is None:
            self._init_frame = (frame, frame_id, time_usec)
            return
        prev, fid0, t0 = self._init_frame
        kp0, d0, v0 = prev.kp_norm, prev.desc, prev.valid
        # The reference initializes on octave-0 keypoints only
        # (SearchForInitialization is called with minLevel=maxLevel=0):
        # coarse-level corners carry several level-0 pixels of positional
        # noise, which an essential-matrix fit amplifies into a bad map that
        # poisons the whole segment. But the reference also DOUBLES its
        # feature budget during init (Tracking.cc: mpIniORBextractor =
        # ORBextractor(2*nFeatures, ...)) — our prefetched features keep one
        # budget, so when the level-0 subset can't reach min_init_matches we
        # fall back to all levels rather than starve initialization.
        def match_levels(max_level):
            lvl_ok0 = prev.level <= max_level
            lvl_ok1 = frame.level <= max_level
            m = _match_descriptors(
                jnp.asarray(d0), jnp.asarray(desc),
                valid_a=jnp.asarray(v0 & lvl_ok0),
                valid_b=jnp.asarray(valid & lvl_ok1),
                max_distance=matching.HAMMING_LOW, ratio=0.9,
            )
            if self.config.rotation_consistency:
                m = matching.rotation_consistency(
                    jnp.asarray(prev.angle), jnp.asarray(frame.angle), m
                )
            return np.asarray(m.index), np.asarray(m.valid)

        def solve_two_view(idx, ok):
            p1 = np.where(ok[:, None], kp0, 0.0)
            p2 = np.where(ok[:, None], kp_norm[np.clip(idx, 0, None)], 0.0)
            res = _two_view(
                jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ok),
                self._next_key(),
            )
            # Start every result transfer now: the inliers pull below rides
            # the same round trip, and on success the points3d/translation/
            # rotation pulls find their bytes already landed (three saved
            # round trips).
            for h in (res.points3d, res.translation, res.rotation):
                if hasattr(h, "copy_to_host_async"):
                    h.copy_to_host_async()
            return res, np.asarray(res.inliers)  # array pull, not 0-d

        idx, ok = match_levels(self.config.init_max_level)
        res, inl = (None, np.zeros(0, bool))
        if ok.sum() >= self.config.min_init_matches:
            res, inl = solve_two_view(idx, ok)
        # Fall back to all pyramid levels when the level-0 map would start
        # too thin to survive tracking (init_rich_points): quantity beats
        # the level-0 noise hygiene once features are scarce.
        if (
            int(inl.sum()) < self.config.init_rich_points
            and self.config.init_max_level < self.config.num_levels - 1
        ):
            idx2, ok2 = match_levels(self.config.num_levels - 1)
            if ok2.sum() >= self.config.min_init_matches:
                res2, inl2 = solve_two_view(idx2, ok2)
                if int(inl2.sum()) > int(inl.sum()):
                    idx, ok, res, inl = idx2, ok2, res2, inl2
        if ok.sum() < self.config.min_init_matches:
            self._init_attempts += 1
            if self._init_attempts > 5:
                # Reference resets the initial frame when matching keeps
                # failing (Tracking::MonocularInitialization).
                self._init_frame = (frame, frame_id, time_usec)
                self._init_attempts = 0
            return
        if int(inl.sum()) < self.config.min_init_inliers:
            self._init_attempts += 1
            return
        pts = np.asarray(res.points3d)
        # Monocular scale: median depth of inliers -> 1 (like ORB-SLAM2's
        # initializer normalization).
        depths = pts[inl, 2]
        scale = 1.0 / max(np.median(depths), 1e-6)
        pts = pts * scale
        t21 = np.asarray(res.translation) * scale
        r21 = np.asarray(res.rotation)

        # World frame = first camera frame. Store map points. Descriptors
        # may arrive as device arrays (prefetch path): pull host copies
        # here, where both frames become keyframes anyway.
        d0 = np.asarray(d0)
        desc = np.asarray(desc)
        n_new = int(inl.sum())
        slots = self._free_slots(n_new)
        src_rows = np.nonzero(inl)[0]
        src_rows = src_rows[: len(slots)]
        dst_rows = idx[src_rows]
        self.points[slots] = pts[src_rows]
        self.point_desc[slots] = desc[np.clip(dst_rows, 0, None)]
        self.point_valid[slots] = True
        self.stats["points_created"] += len(slots)
        self.point_level[slots] = frame.level[np.clip(dst_rows, 0, None)]
        self.point_angle[slots] = frame.angle[np.clip(dst_rows, 0, None)]
        self.point_visible[slots] = 2
        self.point_found[slots] = 2
        # Created "at" the second init keyframe (the reference's
        # CreateInitialMapMonocular stamps mnFirstKFid with pKFcur->mnId=1),
        # so they only reach culling age after two more keyframes.
        self.point_first_kf[slots] = 1
        self.point_recent[slots] = True

        pose0 = np.zeros(6)
        pose1 = np.concatenate(
            [np_matrix_to_rotvec(r21), t21]
        )

        kf0_map = np.full(kp0.shape[0], -1, np.int32)
        kf0_map[src_rows] = slots
        kf1_map = np.full(kp_norm.shape[0], -1, np.int32)
        kf1_map[idx[src_rows]] = slots

        self.keyframes = [
            Keyframe(pose0, kp0, d0, v0, kf0_map, n_new, kf_id=0,
                     kp_level=np.asarray(prev.level, np.int32),
                     kp_angle=np.asarray(prev.angle, np.float32)),
            Keyframe(pose1, kp_norm, desc, valid, kf1_map, n_new, kf_id=1,
                     kp_level=np.asarray(frame.level, np.int32),
                     kp_angle=np.asarray(frame.angle, np.float32)),
        ]
        self._next_kf_id = 2
        for new_kf in self.keyframes:
            self._cache_kf_descriptors(new_kf)
        # The two init frames anchor to their own keyframes.
        self.trajectory.append(
            FramePose(fid0, t0, pose0, ref_kf_id=0, rel6=np.zeros(6))
        )
        self.trajectory.append(
            FramePose(frame_id, time_usec, pose1, ref_kf_id=1, rel6=np.zeros(6))
        )
        self._pose = pose1
        self._motion = self._pose_delta(pose0, pose1)
        self._frames_since_keyframe = 0
        self._refresh_local_points()
        self.state = OK

    @staticmethod
    def _pose_delta(prev6, curr6):
        """delta such that curr = delta o prev (world->camera composition).
        Pure host math — runs several times per frame (see np_rotvec_*)."""
        r_prev = np_rotvec_to_matrix(prev6[:3])
        r_curr = np_rotvec_to_matrix(curr6[:3])
        r_d = r_curr @ r_prev.T
        t_d = curr6[3:] - r_d @ prev6[3:]
        return np.concatenate([np_matrix_to_rotvec(r_d), t_d])

    @staticmethod
    def _compose(delta6, pose6):
        r_d = np_rotvec_to_matrix(delta6[:3])
        r_p = np_rotvec_to_matrix(pose6[:3])
        r = r_d @ r_p
        t = r_d @ pose6[3:] + delta6[3:]
        return np.concatenate([np_matrix_to_rotvec(r), t])

    # --------------------------------------------------------------- track
    def _track_attempt(self, predicted, frame: _FrameFeatures):
        """Projected matching + robust pose refinement around a pose guess
        (SearchByProjection + PoseOptimization analogue) — ONE fused device
        call against the device-resident map (see fused_track_step). Returns
        (pose6, num_inliers, match_idx, inliers, in_view) as host values,
        all indexed by ARENA slot (the device program runs on the compact
        local mirror; results scatter back through _dev_map_sel)."""
        points_dev, desc_dev, cand_dev, level_dev = self._device_map()
        packed = np.asarray(
            fused_track_step(
                points_dev,
                desc_dev,
                cand_dev,
                level_dev,
                jnp.asarray(predicted),
                jnp.asarray(frame.kp_norm),
                jnp.asarray(frame.desc),
                jnp.asarray(frame.valid),
                jnp.asarray(frame.level),
                search_radius=self._search_rad,
                max_distance=matching.HAMMING_HIGH,
                scale=self.config.scale,
                level_window=self.config.level_window,
                refine_radius=self._refine_rad,
                huber_delta=self._huber,
                inlier_threshold=self._inlier_thresh,
            )
        )
        b = int(cand_dev.shape[0])
        n = self._dev_map_count
        rows = self._dev_map_sel[:n]
        m = self.config.max_map_points
        match_idx = np.full(m, -1, np.int32)
        match_idx[rows] = packed[7 : 7 + n].astype(np.int32)
        inliers = np.zeros(m, bool)
        inliers[rows] = packed[7 + b : 7 + b + n] > 0.5
        in_view = np.zeros(m, bool)
        in_view[rows] = packed[7 + 2 * b : 7 + 2 * b + n] > 0.5
        return (
            packed[:6].astype(np.float64),
            int(packed[6]),
            match_idx,
            inliers,
            in_view,
        )

    def _track_reference_keyframe(self, frame: _FrameFeatures):
        """TrackReferenceKeyFrame (Tracking.cc:317-323, 748): descriptor-only
        matching against the newest keyframe's map-point observations, pose
        refined from the LAST pose (no motion extrapolation). Returns a
        candidate pose6 or None."""
        kf = self.keyframes[-1]
        has_point = (kf.map_point >= 0) & kf.kp_valid
        has_point &= self.point_valid[np.clip(kf.map_point, 0, None)]
        if has_point.sum() < 8:
            return None
        kf_desc_dev, _ = self.kf_descriptors_device(kf)
        kc = frame.kp_norm.shape[0]
        packed = np.asarray(
            fused_ref_kf_track(
                jnp.asarray(self.points[np.clip(kf.map_point, 0, None)]),
                jnp.asarray(has_point),
                kf_desc_dev,
                jnp.asarray(kf.kp_angle),
                jnp.asarray(kf.map_point),
                jnp.asarray(self._pose),
                jnp.asarray(frame.kp_norm),
                jnp.asarray(frame.desc),
                jnp.asarray(frame.valid),
                jnp.asarray(frame.level),
                jnp.asarray(frame.angle),
                scale=self.config.scale,
                use_rotation_check=self.config.rotation_consistency,
                huber_delta=self._huber,
                inlier_threshold=self._inlier_thresh,
            )
        )
        num_inliers = int(packed[6])
        # Reference accepts TrackReferenceKeyFrame at >=10 inliers
        # (Tracking.cc TrackReferenceKeyFrame: nmatchesMap >= 10); the pose
        # still has to survive guided local-map re-tracking afterwards.
        if num_inliers < max(10, self.config.min_track_inliers // 2):
            return None
        return packed[:6].astype(np.float64)

    def process_chunk(self, frames) -> List[tuple]:
        """Track up to ``config.track_chunk_frames`` consecutive frames with
        ONE blocking device round trip (fused_track_chunk).

        ``frames``: objects carrying ``.features`` (kp_norm, desc, valid,
        level, angle — host arrays, desc may be device-resident), optional
        ``.dev_features`` (device-resident (kp_norm, desc, valid, level)
        from the batched prefetcher — preferred, zero re-upload), and
        ``.frame_id`` / ``.time_usec``. Only valid in the OK state.

        Returns [(state, tracked_kp_rows)] for the frames actually CONSUMED;
        the caller re-feeds the rest. The chunk stops early at a tracking
        failure (the event frame re-runs through the full per-frame fallback
        path: ref-KF track, then relocalization). A mid-chunk KEYFRAME stops
        the chunk only when ``config.chunk_through_keyframes`` is False; the
        default keeps consuming — later frames tracked against the
        pre-keyframe map, the reference's Tracking-vs-LocalMapping lag —
        so a keyframe cycle costs one chunk round trip, not two.
        """
        assert self.state == OK, "process_chunk requires an initialized tracker"
        # The previous keyframe's deferred BA is NOT folded in here: it
        # applies at the next keyframe insertion (_apply_pending_ba there),
        # so this chunk tracks on pre-BA geometry — the reference's
        # Tracking-vs-LocalMapping lag — instead of stalling a full BA
        # round trip at every chunk boundary. Applying only at keyframe
        # cadence also keeps the chunked and per-frame paths bitwise
        # identical (both see map updates at the same frames).
        c = min(len(frames), self.config.track_chunk_frames)
        use = frames[:c]
        pad = self.config.track_chunk_frames - c

        def dev_inputs(f):
            dev = getattr(f, "dev_features", None)
            if dev is not None:
                return dev
            kp_norm, desc, valid, level, _ = f.features
            return (kp_norm, desc, valid, level)

        ins = [dev_inputs(f) for f in use]
        ins += [ins[-1]] * pad  # pad by repetition; outputs ignored
        kp_t, kd_t, kv_t, kl_t = zip(*ins)
        points_dev, desc_dev, cand_dev, level_dev = self._device_map()
        sel = self._dev_map_sel.copy()
        n = self._dev_map_count
        b = int(cand_dev.shape[0])
        packed_dev = fused_track_chunk(
            points_dev, desc_dev, cand_dev, level_dev,
            jnp.asarray(self._pose), jnp.asarray(self._motion),
            tuple(kp_t), tuple(kd_t), tuple(kv_t), tuple(kl_t),
            search_radius=self._search_rad,
            max_distance=matching.HAMMING_HIGH,
            scale=self.config.scale,
            level_window=self.config.level_window,
            refine_radius=self._refine_rad,
            huber_delta=self._huber,
            inlier_threshold=self._inlier_thresh,
            min_track_inliers=self.config.min_track_inliers,
        )
        # The LAST chunk frame usually becomes the next keyframe (the gap
        # rule fires at chunk end by construction): start its descriptor
        # host copy now so the keyframe path overlaps the pull with the
        # chunk's own result transfer.
        last_desc = ins[c - 1][1]
        if hasattr(last_desc, "copy_to_host_async"):
            last_desc.copy_to_host_async()
        packs = np.asarray(packed_dev)

        results: List[tuple] = []
        m = self.config.max_map_points
        rows_sel = sel[:n]
        # Chunk->host pose transplant state: device poses live in the
        # coordinate frame the chunk was DISPATCHED in. A mid-chunk keyframe
        # insertion may refine host poses (sync local BA), so subsequent
        # device poses are re-expressed relative to the anchor keyframe:
        # host_pose = (device_pose ∘ device_anchor⁻¹) ∘ refined_anchor —
        # exactly GetTrajectory's relative-pose transplant (System.cc:
        # 371-413). Until the first insertion the transplant is skipped so
        # the common case stays bitwise identical to the rewind path.
        anchor_kf = self.keyframes[-1]
        anchor_dev_pose = anchor_kf.pose6.copy()
        transplant = False
        for i, f in enumerate(use):
            row = packs[i]
            num_inliers = int(row[6])
            dev_pose6 = row[:6].astype(np.float64)
            pose6 = dev_pose6
            if transplant:
                # A through-frame that would TRIGGER the keyframe policy
                # must not be consumed from stale-map results: a keyframe
                # built from stale matches triangulates bad geometry and
                # cascades (stale inliers are depressed, so the ratio rule
                # would fire keyframe-after-keyframe). Stop here; the
                # caller re-feeds this frame, which then re-tracks against
                # the updated map and becomes a clean keyframe. Ordinary
                # through-frames (the common case) keep their results —
                # that is the reference's Tracking-vs-LocalMapping lag.
                ref_inl = self.keyframes[-1].num_inliers or num_inliers
                would_trigger = (
                    num_inliers
                    < self.config.keyframe_inlier_ratio * ref_inl
                    or self._frames_since_keyframe + 1
                    >= self.config.keyframe_max_gap
                )
                if would_trigger:
                    return results
                pose6 = self._compose(
                    self._pose_delta(anchor_dev_pose, dev_pose6),
                    anchor_kf.pose6,
                )
            match_idx = np.full(m, -1, np.int32)
            match_idx[rows_sel] = row[7 : 7 + n].astype(np.int32)
            inliers = np.zeros(m, bool)
            inliers[rows_sel] = row[7 + b : 7 + b + n] > 0.5
            in_view = np.zeros(m, bool)
            in_view[rows_sel] = row[7 + 2 * b : 7 + 2 * b + n] > 0.5
            if num_inliers < self.config.min_track_inliers:
                # Motion-model tracking failed on this frame: the chunk
                # carry froze here, so re-run it through the full
                # single-frame path (fresh motion attempt, then the ref-KF
                # / relocalization fallbacks). The re-attempt is NOT
                # redundant: the host-side prediction (f64 motion compose,
                # current map mirror) differs slightly from the device
                # carry's, and borderline frames routinely clear the
                # inlier bar on the retry — measured on a synthetic 720p
                # ride, reusing the chunk's failed attempt instead of
                # re-running it turned ~1 recoverable dip per 14 frames
                # into a LOST cascade.
                kp_norm, desc, valid, level, angle = f.features
                state = self.process_features(
                    kp_norm, desc, valid, f.frame_id, f.time_usec,
                    kp_level=level, kp_angle=angle,
                )
                results.append((state, self.last_track_kp_rows))
                return results
            next_id = self._next_kf_id
            self._commit_tracked_frame(
                _FrameFeatures(*f.features), f.frame_id, f.time_usec,
                pose6, num_inliers, match_idx, inliers, in_view,
            )
            results.append((OK, self.last_track_kp_rows))
            if self._next_kf_id != next_id:
                if not self.config.chunk_through_keyframes:
                    return results  # keyframe inserted -> map changed
                # Keep consuming: later chunk frames tracked against the
                # pre-keyframe map (the reference's LocalMapping lag). Their
                # stale-map stats are validity-filtered in the commit; their
                # poses transplant onto the (possibly BA-refined) new anchor.
                anchor_kf = self.keyframes[-1]
                anchor_dev_pose = dev_pose6
                transplant = True
        return results

    def _track(self, frame: _FrameFeatures, frame_id, time_usec):
        # Deferred BA applies at keyframe insertion, not here (see
        # process_chunk: the reference's Tracking-vs-LocalMapping lag).
        predicted = self._compose(self._motion, self._pose)
        new_pose, num_inliers, match_idx, inliers, in_front = (
            self._track_attempt(predicted, frame)
        )

        if (
            num_inliers < self.config.min_track_inliers
            and self.config.track_ref_kf_fallback
        ):
            # Motion-model tracking failed — retry against the reference
            # keyframe BEFORE relocalization (Tracking.cc:317-323): a wrong
            # motion prediction hides true matches behind the projection
            # window, while descriptor-only matching against the newest
            # keyframe cannot be fooled by it. An accepted ref-KF pose is
            # then polished by guided local-map re-tracking.
            ref_pose = self._track_reference_keyframe(frame)
            if ref_pose is not None:
                pose2, n2, match_idx2, inliers2, in_front2 = (
                    self._track_attempt(ref_pose, frame)
                )
                if n2 >= self.config.min_track_inliers:
                    new_pose, match_idx, inliers = pose2, match_idx2, inliers2
                    in_front = in_front2
                    num_inliers = n2
                    # The motion model is stale (it just failed); restart it
                    # from the recovered pose delta.
                    self._motion = self._pose_delta(self._pose, new_pose)
                    self.stats["ref_kf_recoveries"] += 1

        if num_inliers < self.config.min_track_inliers:
            # Attempt relocalization from scratch against the whole map
            # before falling to LOST (Tracking.cc: Relocalization() precedes
            # the LOST state). A relocalized pose only counts if GUIDED
            # re-tracking around it reaches full tracking quality — a
            # plausible-but-wrong pose must never replace the state (it
            # would poison the motion model and lose the segment within a
            # few frames).
            points_dev, map_desc_dev, map_valid_dev = self._device_map_full()
            reloc = relocalize(
                points_dev,
                map_desc_dev,
                map_valid_dev,
                jnp.asarray(frame.kp_norm),
                jnp.asarray(frame.desc),
                jnp.asarray(frame.valid),
                self._next_key(),
            )
            accepted = False
            # Array pull + host sum (never pull 0-d scalars, see
            # fused_track_step).
            reloc_inliers = int(np.asarray(reloc.inliers).sum())
            if reloc_inliers >= max(8, self.config.min_track_inliers // 2):
                # Locality is stale around a global relocalization: guided
                # re-tracking (and tracking until the next keyframe rebuilds
                # the window) runs against the whole map.
                saved_local = self._local_points
                self._local_points = self.point_valid.copy()
                self._invalidate_device_map()
                pose2, n2, match_idx2, inliers2, in_front2 = (
                    self._track_attempt(np.asarray(reloc.pose6), frame)
                )
                if n2 >= self.config.min_track_inliers:
                    new_pose, match_idx, inliers = pose2, match_idx2, inliers2
                    in_front = in_front2
                    num_inliers = n2
                    self._motion = np.zeros(6)  # motion model invalidated
                    accepted = True
                else:
                    self._local_points = saved_local
                    self._invalidate_device_map()
            if not accepted:
                self.state = LOST
                self._append_frame(
                    frame_id, time_usec, self._pose.copy(), is_lost=True
                )
                return

        self._commit_tracked_frame(
            frame, frame_id, time_usec,
            new_pose, num_inliers, match_idx, inliers, in_front,
        )

    def _commit_tracked_frame(
        self, frame: _FrameFeatures, frame_id, time_usec,
        new_pose, num_inliers, match_idx, inliers, in_front,
    ):
        """Accept one successfully tracked frame: per-point statistics,
        motion-model/pose update, trajectory append, and the keyframe
        policy + insertion (shared by the per-frame and chunked paths)."""
        # On the chunk-through-keyframes path a frame's match masks may
        # reference arena slots culled (or recycled) by a mid-chunk keyframe
        # insertion; filter them so stale slots never gain stats or keyframe
        # observations. No-op on the per-frame path (masks were computed
        # against the live map).
        inliers = inliers & self.point_valid
        in_front = in_front & self.point_valid
        # Per-point tracking statistics (MapPoint::IncreaseVisible/Found):
        # visible = the point was searched in this frame's frustum, found =
        # it survived pose optimization as an inlier.
        self.point_visible[in_front] += 1
        self.point_found[inliers] += 1

        # Keypoint rows tracked as map-point inliers this frame — consumed
        # by the offline visualization overlay (pipeline.py visualize).
        self.last_track_kp_rows = match_idx[np.nonzero(inliers)[0]]

        self._motion = self._pose_delta(self._pose, new_pose)
        self._pose = new_pose
        self._append_frame(frame_id, time_usec, new_pose)
        self._frames_since_keyframe += 1

        ref_inliers = self.keyframes[-1].num_inliers or num_inliers
        need_keyframe = (
            num_inliers < self.config.keyframe_inlier_ratio * ref_inliers
            or self._frames_since_keyframe >= self.config.keyframe_max_gap
        )
        if need_keyframe:
            # Fold in the PREVIOUS keyframe's deferred BA before any new
            # geometry references the map (triangulation uses prev keyframe
            # poses; fuse projects the points this refines).
            self._apply_pending_ba()
            kp_map = np.full(frame.kp_norm.shape[0], -1, np.int32)
            matched_points = np.nonzero(inliers)[0]
            kp_map[match_idx[matched_points]] = matched_points
            kf = Keyframe(
                # Descriptors may be device-resident on the prefetch path;
                # Keyframe starts the async host copy and materializes it
                # lazily (first host use is the triangulation-pull commit,
                # by which time the transfer has landed).
                new_pose.copy(), frame.kp_norm, frame.desc,
                frame.valid, kp_map, num_inliers, kf_id=self._next_kf_id,
                kp_level=np.asarray(frame.level, np.int32),
                kp_angle=np.asarray(frame.angle, np.float32),
            )
            self._next_kf_id += 1
            self.keyframes.append(kf)
            self._cache_kf_descriptors(kf)
            # Re-anchor the just-appended frame to the new keyframe.
            self.trajectory[-1].ref_kf_id = kf.kf_id
            self.trajectory[-1].rel6 = np.zeros(6)
            # Dispatch the whole keyframe fan — triangulation (one stacked
            # program for all neighbor pairs), the fuse sweep, and the
            # loop-detection vote sweep (descriptor-only, culling-safe by
            # kf_id) — before pulling ANY of them: independent device
            # programs whose compute and host copies all overlap, so the
            # fan costs one round trip (the reference hides this latency
            # in its LocalMapping + LoopClosing threads).
            create_dev = self._dispatch_create_points_all(kf)
            fuse_dev = self._dispatch_fuse(kf)
            vote_handle = None
            if self.config.enable_loop_closing and self._loop_preconditions(kf):
                from pilotguru.vo import loopclosing

                vote_handle = loopclosing.start_vote_sweep(self, kf)
            for handle in [
                create_dev[1], fuse_dev[1] if fuse_dev else None,
            ]:
                if hasattr(handle, "copy_to_host_async"):
                    handle.copy_to_host_async()
            # Host-only culling of unstable recent points runs while the
            # fan is in flight (also the reference's order: MapPointCulling
            # precedes CreateNewMapPoints in LocalMapping::Run).
            self._map_point_culling(kf)
            self._create_new_points(kf, dispatched=create_dev)
            self._fuse_duplicates(kf, dispatched=fuse_dev)
            if self.config.ba_every_keyframe and len(self.keyframes) >= 3:
                self._local_bundle_adjust()
            self._keyframe_culling()
            if self.config.enable_loop_closing:
                self._try_close_loop(kf, vote_handle)
            self._refresh_local_points()
            self._frames_since_keyframe = 0

    # ----------------------------------------------------------- map growth
    def _create_pair_active(self, kf: Keyframe, prev: Keyframe) -> bool:
        """Host-side gate for one (prev, kf) triangulation pair.

        Monocular baseline check (LocalMapping.cc:246-259): skip pairs
        whose camera-center separation is under 1% of the neighbor's
        median scene depth — triangulations from a near-zero baseline are
        pure noise amplification. Pairs where either keyframe lacks
        unmatched features are skipped too."""
        pids = prev.map_point[prev.map_point >= 0]
        pids = pids[self.point_valid[pids]]
        if pids.size >= 10:
            r_prev = np_rotvec_to_matrix(prev.pose6[:3])
            depths = (self.points[pids] @ r_prev.T + prev.pose6[3:])[:, 2]
            median_depth = float(np.median(depths))
            c_prev = -(r_prev.T @ prev.pose6[3:])
            r_kf = np_rotvec_to_matrix(kf.pose6[:3])
            c_kf = -(r_kf.T @ kf.pose6[3:])
            baseline = float(np.linalg.norm(c_kf - c_prev))
            if median_depth > 0 and baseline / median_depth < 0.01:
                return False
        un_prev = prev.kp_valid & (prev.map_point < 0)
        un_curr = kf.kp_valid & (kf.map_point < 0)
        return bool(un_prev.sum() >= 8 and un_curr.sum() >= 8)

    def _dispatch_create_points_all(self, kf: Keyframe):
        """Dispatch ALL of a keyframe's triangulation pairs (LocalMapping::
        CreateNewMapPoints analogue, closest neighbor first) as ONE stacked
        device program: padding the pair axis to ``create_neighbor_kfs``
        keeps a single compiled shape, and one packed [P, 5K] pull replaces
        P round trips (the reference hides this latency in the LocalMapping
        thread). Returns (active_neighbors, handle-or-None)."""
        n = self.config.create_neighbor_kfs
        neighbors = self.keyframes[max(0, len(self.keyframes) - 1 - n) : -1]
        active = [
            prev for prev in reversed(neighbors)
            if self._create_pair_active(kf, prev)
        ]
        if not active:
            return [], None
        # Stack per-pair inputs, padded to the fixed pair count with copies
        # of the first pair under an all-False unmatched mask (dead lanes).
        pad = [active[0]] * (n - len(active))
        rows = active + pad
        live = np.arange(n) < len(active)
        prev_desc = jnp.stack(
            [self.kf_descriptors_device(p)[0] for p in rows]
        )
        un_prev = np.stack(
            [p.kp_valid & (p.map_point < 0) for p in rows]
        ) & live[:, None]
        un_curr = kf.kp_valid & (kf.map_point < 0)
        curr_desc_dev, _ = self.kf_descriptors_device(kf)
        handle = fused_create_points_multi(
            prev_desc,
            jnp.asarray(un_prev),
            jnp.asarray(np.stack([p.kp_norm for p in rows])),
            jnp.asarray(np.stack([p.kp_level for p in rows])),
            jnp.asarray(np.stack([p.kp_angle for p in rows])),
            curr_desc_dev,
            jnp.asarray(un_curr),
            jnp.asarray(kf.kp_norm),
            jnp.asarray(kf.kp_level),
            jnp.asarray(kf.kp_angle),
            jnp.asarray(
                np.stack([self._pose_delta(p.pose6, kf.pose6) for p in rows])
            ),
            jnp.asarray(np.stack([p.pose6 for p in rows])),
            min_parallax_cos=self.config.min_parallax_cos,
            scale=self.config.scale,
            use_rotation_check=self.config.rotation_consistency,
            reproj_gate=self._reproj_gate,
            epipolar_gate=self._epi_gate,
        )
        return active, handle

    def _create_new_points(self, kf: Keyframe, dispatched=_NOT_DISPATCHED):
        """Triangulate unmatched features against the recent neighbor
        keyframes (LocalMapping::CreateNewMapPoints analogue). Pairs commit
        closest-neighbor first; a current-keyframe feature that gained a map
        point from an earlier (smaller-baseline, better-matched) pair is
        skipped in later ones — the same first-wins dedup the reference gets
        from marking the matched index per triangulation round."""
        active, handle = (
            dispatched if dispatched is not _NOT_DISPATCHED
            else self._dispatch_create_points_all(kf)
        )
        if handle is None:
            return
        k = kf.kp_norm.shape[0]
        packed_all = np.asarray(handle)  # [P, 5K]; one pull for all pairs
        for prev, packed in zip(active, packed_all):
            idx = packed[:k].astype(np.int32)
            good = packed[k : 2 * k] > 0.5
            pts_world_all = packed[2 * k :].reshape(k, 3).astype(np.float64)
            rows = np.nonzero(good)[0]
            if rows.size == 0:
                continue
            # Dedup against earlier pairs' commits (and against prev rows
            # that gained points since this pair was dispatched).
            fresh = (kf.map_point[idx[rows]] < 0) & (prev.map_point[rows] < 0)
            rows = rows[fresh]
            if rows.size == 0:
                continue
            pts_world = pts_world_all[rows]

            slots = self._free_slots(rows.size)
            take = len(slots)
            self.points[slots] = pts_world[:take]
            # Descriptor rows come from the keyframe's lazy host copy;
            # write them at the next arena read instead of blocking on the
            # in-flight transfer here (_flush_point_desc).
            self._pending_point_desc.append(
                (slots, kf, idx[rows[:take]].copy())
            )
            self.point_valid[slots] = True
            self.stats["points_created"] += take
            self.point_level[slots] = kf.kp_level[idx[rows[:take]]]
            self.point_angle[slots] = kf.kp_angle[idx[rows[:take]]]
            self.point_visible[slots] = 1
            self.point_found[slots] = 1
            self.point_first_kf[slots] = kf.kf_id
            self.point_recent[slots] = True
            prev.map_point[rows[:take]] = slots
            kf.map_point[idx[rows[:take]]] = slots

    # ------------------------------------------------------ map maintenance
    def _map_point_culling(self, kf: Keyframe):
        """LocalMapping::MapPointCulling (LocalMapping.cc:170-206): recent
        points must keep a found-ratio >= 0.25 and gather >cull_min_obs
        keyframe observations within 2 keyframes of creation; survivors
        graduate out of the recent list after 3 keyframes."""
        recent = np.nonzero(self.point_recent & self.point_valid)[0]
        if recent.size == 0:
            return
        # Age in keyframes since creation: current kf_id - first kf_id
        # matches the reference's nCurrentKFid - mnFirstKFid (kf ids stay
        # monotone even across keyframe culling).
        age = kf.kf_id - self.point_first_kf[recent]
        ratio = self.point_found[recent] / np.maximum(
            self.point_visible[recent], 1
        )
        obs = self._point_observations()[recent]
        bad = (ratio < self.config.cull_found_ratio) | (
            (age >= 2) & (obs <= self.config.cull_min_observations)
        )
        self._cull_points(recent[bad])
        graduated = recent[~bad][age[~bad] >= 3]
        self.point_recent[graduated] = False

    def _dispatch_fuse(self, kf: Keyframe, whole_map: bool = False):
        """Dispatch the fuse projection sweep; returns (sel, handle) where
        ``sel`` maps the result's row space back to arena slots (None for
        the whole-arena row space), or None when there are no candidates.

        The local sweep (the per-keyframe hot path) runs against the
        COMPACT device mirror: its candidate set is local-window points by
        construction, so the only fresh upload is a [bucket]-bool mask —
        previously every keyframe re-uploaded the full [M, 256] descriptor
        arena (~1 MB). The whole-map sweep (post-loop
        SearchAndFuse, rare) keeps the full-arena upload."""
        observed = np.zeros(self.config.max_map_points, bool)
        refs = kf.map_point[kf.map_point >= 0]
        observed[refs] = True

        cand = self.point_valid & ~observed
        kf_desc_dev, _ = self.kf_descriptors_device(kf)
        common = dict(
            search_radius=self._fuse_rad,
            max_distance=matching.HAMMING_LOW,
            scale=self.config.scale,
            level_window=self.config.level_window,
        )
        if not whole_map:
            cand &= self._local_points
            if not cand.any():
                return None
            points_dev, desc_dev, _, level_dev = self._device_map()
            sel, n = self._dev_map_sel, self._dev_map_count
            b = int(points_dev.shape[0])
            cand_b = np.zeros(b, bool)
            cand_b[:n] = cand[sel[:n]]
            handle = fused_project_match(
                points_dev, desc_dev, jnp.asarray(cand_b), level_dev,
                jnp.asarray(kf.pose6), kf_desc_dev,
                jnp.asarray(kf.kp_norm), jnp.asarray(kf.kp_valid),
                jnp.asarray(kf.kp_level), **common,
            )
            return sel.copy(), handle
        if not cand.any():
            return None
        self._flush_point_desc()
        handle = fused_project_match(
            jnp.asarray(self.points),
            jnp.asarray(self.point_desc),
            jnp.asarray(cand),
            jnp.asarray(self.point_level),
            jnp.asarray(kf.pose6),
            kf_desc_dev,
            jnp.asarray(kf.kp_norm),
            jnp.asarray(kf.kp_valid),
            jnp.asarray(kf.kp_level),
            **common,
        )
        return None, handle

    def _fuse_duplicates(
        self, kf: Keyframe, whole_map: bool = False,
        dispatched=_NOT_DISPATCHED,
    ):
        """LocalMapping::SearchInNeighbors (LocalMapping.cc:454-525): project
        map points NOT yet observed in the new keyframe into it; a match
        onto a keypoint that already references a different point merges the
        two (the better-observed point wins); a match onto a free keypoint
        adds an observation.

        Candidates come from the LOCAL window only (the reference fuses
        against covisible neighbor keyframes) — fusing against the whole map
        would silently stitch drifted revisits and mask loop errors.
        ``whole_map=True`` is the post-loop-closure global fuse
        (LoopClosing::SearchAndFuse), where stitching IS the point.

        ``dispatched``: pre-dispatched _dispatch_fuse result; passing it
        overlaps this sweep's device round trip with point creation (the
        candidate set is identical either way — points created at this
        keyframe are excluded as not-yet-valid at dispatch time and as
        observed-in-kf at commit time; commits filter stale pids below)."""
        result = (
            dispatched if dispatched is not _NOT_DISPATCHED
            else self._dispatch_fuse(kf, whole_map)
        )
        if result is None:
            return
        sel, packed_dev = result
        packed = np.asarray(packed_dev)
        m = packed.shape[0] // 2  # arena size, or the mirror bucket
        match_idx = packed[:m].astype(np.int32)
        match_ok = packed[m:] > 0.5
        pids = np.nonzero(match_ok)[0]
        if sel is not None:
            # Mirror row space -> arena slots.
            match_arena = np.full(
                self.config.max_map_points, -1, np.int32
            )
            match_arena[sel[pids]] = match_idx[pids]
            match_idx = match_arena
            pids = sel[pids]
        # On the overlapped path the arena may have mutated between dispatch
        # and commit: _map_point_culling can invalidate a candidate, and
        # _free_slots recycling can hand its slot to a point created at THIS
        # keyframe. Drop both (matches the reference's cull-then-fuse order).
        if pids.size:
            keep = self.point_valid[pids] & (
                self.point_first_kf[pids] != kf.kf_id
            )
            pids = pids[keep]
        if pids.size == 0:
            return
        obs_counts = self._point_observations()
        fused = 0
        for pid in pids:
            kp = int(match_idx[pid])
            existing = int(kf.map_point[kp])
            if existing < 0:
                kf.map_point[kp] = pid  # new observation of an old point
                continue
            if existing == pid or not self.point_valid[existing]:
                continue
            # Duplicate pair: keep the better-observed point, redirect every
            # keyframe reference of the loser, free the loser's slot.
            winner, loser = (
                (pid, existing)
                if obs_counts[pid] >= obs_counts[existing]
                else (existing, pid)
            )
            for other in self.keyframes:
                loser_rows = other.map_point == loser
                if not loser_rows.any():
                    continue
                # MapPoint::Replace drops the duplicate observation when the
                # keyframe already sees the winner — redirecting would leave
                # one keyframe observing the winner from two keypoints,
                # double-counting it in _point_observations and feeding BA
                # two conflicting observations.
                if (other.map_point == winner).any():
                    other.map_point[loser_rows] = -1
                else:
                    other.map_point[loser_rows] = winner
            self.point_found[winner] += self.point_found[loser]
            self.point_visible[winner] += self.point_visible[loser]
            self.point_valid[loser] = False
            self.point_recent[loser] = False
            self.point_first_kf[loser] = -1
            fused += 1
        self.stats["points_fused"] += fused

    def _keyframe_culling(self):
        """LocalMapping::KeyFrameCulling (LocalMapping.cc:631-695): drop a
        keyframe when >=90% of its tracked points are observed by at least 3
        other keyframes. The first two keyframes (the monocular gauge) and
        the freshest local pair are exempt. Trajectory frames anchored to a
        culled keyframe re-anchor to its predecessor."""
        if len(self.keyframes) < 4:
            return
        obs_counts = self._point_observations()
        for i in range(2, len(self.keyframes) - 2):
            kf = self.keyframes[i]
            pids = kf.map_point[kf.map_point >= 0]
            pids = pids[self.point_valid[pids]]
            if pids.size == 0:
                continue
            # "Observations > thObs" in the reference counts keyframes other
            # than this one, i.e. total observations >= thObs + 1.
            redundant = obs_counts[pids] >= self.config.keyframe_cull_min_obs + 1
            if redundant.sum() <= self.config.keyframe_cull_redundancy * pids.size:
                continue
            prev = self.keyframes[i - 1]
            delta_to_prev = self._pose_delta(prev.pose6, kf.pose6)
            for fp in self.trajectory:
                if fp.ref_kf_id == kf.kf_id and fp.rel6 is not None:
                    fp.rel6 = self._compose(fp.rel6, delta_to_prev)
                    fp.ref_kf_id = prev.kf_id
            self._kf_desc_dev.pop(kf.kf_id, None)
            del self.keyframes[i]
            self.stats["keyframes_culled"] += 1
            return  # at most one cull per keyframe insertion

    # ------------------------------------------------------------- local BA
    def _global_bundle_adjust(self):
        """Whole-map BA after a loop closure (LoopClosing::
        RunGlobalBundleAdjustment, Optimizer::GlobalBundleAdjustemnt): with
        duplicated landmarks fused across the seam, joint reprojection
        optimization of ALL keyframes + points polishes the closed loop to
        the observation noise floor — the Sim3 edge only needs to be good
        enough for fusion to land. Dense LM: at tracker scale (tens of
        keyframes x a few thousand points) the flattened problem fits one
        dense solve; no sparse Schur machinery needed."""
        self._windowed_bundle_adjust(self.keyframes)

    def _local_bundle_adjust(self):
        self._windowed_bundle_adjust(
            self.keyframes[-self.config.local_window :],
            pad_poses_to=self.config.local_window,
            deferred=self.config.ba_async,
        )

    def _windowed_bundle_adjust(self, window, pad_poses_to=None,
                                deferred=False):
        inv_scale = 1.0 / self.config.scale
        ki_parts, pid_parts, uv_parts, invs_parts = [], [], [], []
        for ki, kf in enumerate(window):
            rows = np.nonzero(kf.map_point >= 0)[0]
            kf_pids = kf.map_point[rows]
            ok = self.point_valid[kf_pids]
            rows, kf_pids = rows[ok], kf_pids[ok]
            ki_parts.append(np.full(rows.size, ki, np.int32))
            pid_parts.append(kf_pids)
            uv_parts.append(kf.kp_norm[rows])
            # Per-level information weight (Optimizer.cc:126-127): an
            # observation from pyramid level L carries sigma ~ scale**L.
            invs_parts.append(inv_scale ** kf.kp_level[rows].astype(np.float64))
        pid_cat = np.concatenate(pid_parts) if pid_parts else np.zeros(0, int)
        # Local point ids in first-appearance order (keeps device inputs
        # bitwise identical to the old dict.setdefault assembly).
        uniq, first_idx, inverse = np.unique(
            pid_cat, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        obs_pose = np.concatenate(ki_parts)
        obs_point = rank[inverse]
        obs_uv = np.concatenate(uv_parts) if uv_parts else np.zeros((0, 2))
        obs_invs = np.concatenate(invs_parts)
        if uniq.size < 10 or obs_uv.shape[0] < 30:
            return
        pids = uniq[order]

        # Pad to fixed buckets so the jitted BA compiles a handful of shapes
        # over the whole ride instead of once per keyframe: poses padded to
        # the window size (local) or an 8-bucket (global),
        # points/observations to power-of-two-ish buckets.
        def bucket(n, step):
            return -(-n // step) * step

        num_k = pad_poses_to or bucket(len(window), 8)
        poses = np.stack([kf.pose6 for kf in window])
        if poses.shape[0] < num_k:
            poses = np.concatenate(
                [poses, np.repeat(poses[-1:], num_k - poses.shape[0], axis=0)]
            )
        num_m = bucket(len(pids), 256)
        pts = np.zeros((num_m, 3))
        pts[: len(pids)] = self.points[pids]
        pts[len(pids):, 2] = 1.0  # benign padding in front of the camera
        point_valid = np.zeros(num_m, bool)
        point_valid[: len(pids)] = True
        num_obs = obs_uv.shape[0]
        num_o = bucket(num_obs, 1024)
        o_pose = np.zeros(num_o, np.int32)
        o_point = np.zeros(num_o, np.int32)
        o_uv = np.zeros((num_o, 2))
        o_valid = np.zeros(num_o, bool)
        o_pose[:num_obs] = obs_pose
        o_point[:num_obs] = obs_point
        o_uv[:num_obs] = obs_uv
        o_valid[:num_obs] = True
        o_invs = np.ones(num_o)
        o_invs[:num_obs] = obs_invs

        problem = BAProblem(
            jnp.asarray(poses),
            jnp.asarray(pts),
            jnp.asarray(o_pose),
            jnp.asarray(o_point),
            jnp.asarray(o_uv),
            jnp.asarray(o_valid),
            jnp.asarray(point_valid),
            jnp.asarray(o_invs),
        )
        result = _bundle_adjust(
            problem,
            huber_delta=self._huber,
            inlier_threshold=self._inlier_thresh,
        )
        # Start both host copies before blocking on either: the transfers
        # overlap, so the two result pulls cost one round trip, not two.
        for out in (result.poses6, result.points):
            if hasattr(out, "copy_to_host_async"):
                out.copy_to_host_async()
        if deferred:
            # LocalMapping-style asynchrony (the reference optimizes in its
            # own thread while Tracking finishes the frame, LocalMapping.cc
            # Run): park the in-flight result. It applies at the next track
            # dispatch / closure attempt / finalize — by which time the
            # async copies have landed behind the keyframe's remaining host
            # work (loop-vote pull, bookkeeping), so the apply costs no
            # blocking round trip.
            self._pending_ba = (result, list(window), pids)
            return
        new_poses = np.asarray(result.poses6)
        for ki, kf in enumerate(window):
            kf.pose6 = new_poses[ki]
        self.points[pids] = np.asarray(result.points)[: len(pids)]
        # Keep the tracker's current pose consistent with the refined last KF.
        # Keep the live pose consistent with the newest keyframe if it was
        # part of this window (it may sit mid-list in a seam window).
        for ki, kf in enumerate(window):
            if kf is self.keyframes[-1]:
                self._pose = new_poses[ki].copy()
                break

    def _apply_pending_ba(self):
        """Fold a deferred local-BA result into the map. Keyframe poses
        update by object identity (safe across keyframe culling — a culled
        keyframe object is simply no longer referenced); refined points
        culled or fused away in the interim are dropped (slots cannot be
        REUSED in between: recycling only happens inside _create_new_points,
        which always runs after this applies).

        Called ONLY where new geometry derives from the map — keyframe
        insertion, loop closure, finalize, trajectory export — NOT at every
        track step: right after a keyframe the BA is still computing +
        transferring, and blocking there put the whole BA round trip on the tracking
        critical path. Frames between two keyframes track on geometry
        stale by at most one local-BA window — exactly the reference's
        Tracking-vs-LocalMapping lag (LocalMapping.cc Run: tracking never
        waits for the optimizer). The apply points depend only on keyframe
        cadence — never on transfer timing — so trajectories are
        bit-reproducible across runs, backends, and the chunked vs
        per-frame paths. By keyframe time the transfer has had a full
        track round trip to land, so the apply is host-only in practice."""
        if self._pending_ba is None:
            return
        result, window, pids = self._pending_ba
        self._pending_ba = None
        new_poses = np.asarray(result.poses6)
        for ki, kf in enumerate(window):
            kf.pose6 = new_poses[ki]
        live = self.point_valid[pids]
        self.points[pids[live]] = np.asarray(result.points)[: len(pids)][live]
        # The tracker's live pose is NOT rewritten: it has moved on since
        # dispatch. Per-frame outputs stay consistent through the
        # keyframe-relative trajectory (final_trajectory composes rel6 onto
        # the refined keyframe poses, System.cc:371-413 semantics).
        self._invalidate_device_map()

    # ---------------------------------------------------------- loop closing
    def _loop_preconditions(self, kf: Keyframe) -> bool:
        """Cheap host-side gates before any loop-closing device work."""
        if (
            len(self.keyframes)
            < self.config.loop_exclude_recent + self.config.loop_cooldown_keyframes
        ):
            return False
        # Cooldown in monotone kf ids (list length shrinks under culling).
        return (
            kf.kf_id - self._last_loop_kf_id
            >= self.config.loop_cooldown_keyframes
        )

    def _try_close_loop(self, kf: Keyframe, vote_handle=None):
        """Detect + close loops (LoopClosing.cc semantics, fixed shapes):
        exhaustive matmul descriptor voting against all old keyframes replaces
        the DBoW2 index, RANSAC-Umeyama on matched 3D-3D map points replaces
        Sim3Solver, and a dense Sim(3) pose graph replaces
        OptimizeEssentialGraph. See vo/loopclosing.py. ``vote_handle``: a
        pre-dispatched start_vote_sweep result (overlapped with local BA)."""
        from pilotguru.vo import loopclosing

        if not self._loop_preconditions(kf):
            return
        cand_idx = loopclosing.detect_and_close(self, kf, vote_handle)
        if cand_idx is not None:
            # A deferred local BA dispatched this keyframe was computed from
            # pre-closure geometry; the closure's own seam/global BA
            # supersedes it. Applying it later would fight the correction.
            self._pending_ba = None
            self._last_loop_kf_id = kf.kf_id
            self._last_loop_cand_kf_id = self.keyframes[cand_idx].kf_id
            self.stats["loop_closures"] += 1
            # Post-correction fusion stitches the revisited region's
            # duplicated points (LoopClosing's SearchAndFuse role), then BA
            # polishes the map against the fused seam.
            self._fuse_duplicates(kf, whole_map=True)
            self._post_loop_ba(cand_idx)
            self._refresh_local_points()

    def _post_loop_ba(self, cand_idx: int):
        if self.config.loop_ba == "none":
            return
        if self.config.loop_ba == "global" or len(self.keyframes) <= 12:
            self._global_bundle_adjust()
            return
        # Seam window: the loop stitch lives between the candidate's
        # neighborhood and the current tail; optimizing just those
        # keyframes (with their fused points) captures most of the global
        # BA's benefit at local-BA cost.
        lo = max(cand_idx - 2, 0)
        hi = min(cand_idx + 3, len(self.keyframes))
        window = self.keyframes[lo:hi] + self.keyframes[-6:]
        seen = set()
        uniq = []
        for k in window:
            if k.kf_id not in seen:
                seen.add(k.kf_id)
                uniq.append(k)
        self._windowed_bundle_adjust(uniq)

    def finalize(self):
        """End-of-segment global-consistency pass: one cooldown-exempt loop
        detection + closure on the final keyframe. The reference runs its
        (async) global BA when a loop closes and a full-trajectory
        reconstruction at Shutdown; for the odometry outputs the equivalent
        win is closing the terminal loop exactly at the segment end, where
        the revisit overlap is maximal."""
        from pilotguru.vo import loopclosing

        self._apply_pending_ba()
        if not self.config.enable_loop_closing or len(self.keyframes) < 4:
            return
        kf = self.keyframes[-1]
        cand_idx = loopclosing.detect_and_close(self, kf)
        if cand_idx is not None:
            self.stats["loop_closures"] += 1
            self._fuse_duplicates(kf, whole_map=True)
            self._post_loop_ba(cand_idx)
            self._refresh_local_points()
        elif self.stats["loop_closures"] > 0:
            # A loop closed mid-ride: the keyframes appended AFTER it never
            # saw the seam BA. One more fuse + seam polish folds the tail
            # into the stitched region (the role of the reference's
            # closure-time global BA, which runs async and so also covers
            # later keyframes by correction propagation).
            by_id = self._kf_index_by_id()
            polish_idx = by_id.get(self._last_loop_cand_kf_id)
            if polish_idx is not None:
                self._fuse_duplicates(kf, whole_map=True)
                self._post_loop_ba(polish_idx)
                self._refresh_local_points()
