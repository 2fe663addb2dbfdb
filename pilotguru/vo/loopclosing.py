"""Loop detection + closure (replaces ORB-SLAM2's LoopClosing thread).

Reference flow (/root/reference/thirdparty/orb-slam2/src/LoopClosing.cc):
DetectLoop queries the DBoW2 inverted index for keyframes scoring above the
covisibility-neighbor baseline, ComputeSim3 fits a scaled relative transform
with Sim3Solver RANSAC, and the essential graph + (async) global BA spread
the correction.

Fixed-shape design: candidate retrieval is exhaustive descriptor voting —
one [K, K] Hamming matmul per stored keyframe, vmapped over the whole
keyframe stack (the same replace-the-index call as vo/matching.py makes for
DBoW2 relocalization). Verification is RANSAC-Umeyama over matched 3D-3D
map points (vo/sim3.py), and the correction is one dense Sim(3) pose-graph
solve over the keyframe chain + loop edge (vo/posegraph.py), after which
map points are re-expressed through their reference keyframe's correction
(CorrectLoop's landmark adjustment).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.solvers.levenberg_marquardt import levenberg_marquardt
from pilotguru.vo import matching, posegraph, sim3
from pilotguru.vo.pose import geo_jit, huber_weights, project, rotvec_to_matrix
from pilotguru.vo.tracking import (
    Keyframe,
    _match_descriptors,
    np_rotvec_to_matrix,
)


@partial(jax.jit, static_argnames=())
def _vote_counts(cur_desc, cur_valid, kf_desc_stack, kf_valid_stack):
    """Good-match votes of the current keyframe against a [N, K, 256] stack
    of stored keyframe descriptors. One vmapped matmul sweep."""

    def one(desc, valid):
        m = matching.match_descriptors(
            cur_desc, desc, valid_a=cur_valid, valid_b=valid,
            max_distance=matching.HAMMING_LOW, ratio=0.75,
        )
        return jnp.sum(m.valid)

    return jax.vmap(one)(kf_desc_stack, kf_valid_stack)


def _bucket(n: int, step: int = 8) -> int:
    return max(-(-n // step) * step, step)


def start_vote_sweep(tracker, kf: Keyframe):
    """Dispatch the candidate vote sweep WITHOUT blocking and start its
    host copy. Returns (votes_dev, old_kf_ids) for detect_candidate, or
    None when there are no old keyframes. The tracker calls this before
    local BA so the sweep's compute + transfer hide behind the BA round
    trip; keyframes culled in between are dropped by kf_id when the result
    is consumed (votes depend only on descriptors, so the deferred read is
    semantically identical)."""
    config = tracker.config
    # [:-k] with k == 0 would slice to nothing; spell the bound explicitly so
    # loop_exclude_recent == 0 means "consider every non-current keyframe".
    old = tracker.keyframes[: len(tracker.keyframes) - config.loop_exclude_recent]
    if not old:
        return None
    # Stack the stored keyframes' device-resident descriptor copies
    # (uploaded once per keyframe, tracking.py kf_descriptors_device) —
    # the sweep is pure device-memory traffic + one vmapped matmul pass, no per-call
    # host uploads. Padding rows reuse entry 0 with an all-False mask.
    n = _bucket(len(old))
    descs, valids = zip(*(tracker.kf_descriptors_device(okf) for okf in old))
    pad = n - len(old)
    desc = jnp.stack(list(descs) + [descs[0]] * pad)
    valid = jnp.stack(
        list(valids) + [jnp.zeros_like(valids[0])] * pad
    )
    votes_dev = _vote_counts(
        jnp.asarray(kf.descriptors), jnp.asarray(kf.kp_valid), desc, valid
    )
    if hasattr(votes_dev, "copy_to_host_async"):
        votes_dev.copy_to_host_async()
    return votes_dev, [okf.kf_id for okf in old]


def detect_candidate(tracker, kf: Keyframe, vote_handle=None):
    """Best loop candidate index (into tracker.keyframes) or None.

    Old keyframes = everything except the trailing ``loop_exclude_recent``
    window (those share covisibility with the current keyframe — matching
    them is just tracking, not a loop). ``vote_handle``: a pre-dispatched
    start_vote_sweep result to consume instead of sweeping now.
    """
    config = tracker.config
    if vote_handle is None:
        vote_handle = start_vote_sweep(tracker, kf)
    if vote_handle is None:
        return None
    votes_dev, old_kf_ids = vote_handle
    by_id = {okf.kf_id: okf for okf in tracker.keyframes}
    votes_all = np.asarray(votes_dev)[: len(old_kf_ids)]
    # Keyframes culled since the sweep was dispatched drop out by kf_id.
    old = []
    votes = []
    for vote, kf_id in zip(votes_all, old_kf_ids):
        okf = by_id.get(kf_id)
        if okf is not None:
            old.append(okf)
            votes.append(vote)
    if not old:
        return None
    votes = np.asarray(votes)

    # Covisibility exclusion (LoopClosing::DetectLoop skips keyframes
    # connected to the current one): a keyframe that shares map points with
    # the current keyframe is the local neighborhood seen slightly earlier,
    # not a revisit — a Sim3 "loop" against it would inject a noise edge.
    cur_pids = set(int(p) for p in kf.map_point[kf.map_point >= 0])
    for i, okf in enumerate(old):
        shared = sum(
            1 for p in okf.map_point[okf.map_point >= 0] if int(p) in cur_pids
        )
        if shared >= 5:
            votes[i] = -1

    best = int(np.argmax(votes))
    if votes[best] < config.loop_min_match_count:
        return None
    # Index into the CURRENT keyframe list — by identity, not list.index
    # (Keyframe is a dataclass whose __eq__ compares ndarray fields).
    for idx, existing in enumerate(tracker.keyframes):
        if existing is old[best]:
            return idx
    return None


@partial(geo_jit, static_argnames=("lm_iters",))
def refine_sim3(
    m0,  # [7] initial cur-cam -> cand-cam Sim(3)
    cand_pose6,  # [6] world -> cand camera
    cur_pose6,  # [6] world -> cur camera
    pts_cand_world,  # [P, 3] candidate's map points (accurate at lap start)
    obs_cur,  # [P, 2] their keypoint observations in the CURRENT keyframe
    pts_cur_world,  # [P, 3] current map points (accurate at lap end)
    obs_cand,  # [P, 2] their keypoint observations in the CANDIDATE keyframe
    pair_valid,  # [P] bool
    lm_iters: int = 20,
    huber_delta: float = 0.006,
):
    """Reprojection-based Sim(3) polish (Optimizer::OptimizeSim3 semantics,
    /root/reference/thirdparty/orb-slam2/src/Optimizer.cc): the 3D-3D
    Umeyama fit is limited by triangulated-point noise, so refine the loop
    transform against the IMAGE observations in both directions — project
    the candidate's points into the current keyframe through M^-1 and the
    current points into the candidate through M."""

    def to_cam(pose6, pts):
        r = rotvec_to_matrix(pose6[:3])
        return pts @ r.T + pose6[3:]

    cand_cam = to_cam(cand_pose6, pts_cand_world)  # accurate, cand frame
    cur_cam = to_cam(cur_pose6, pts_cur_world)  # accurate, cur frame
    w = pair_valid.astype(m0.dtype)

    def residuals(m):
        in_cur = jax.vmap(lambda x: sim3.act(sim3.inverse(m), x))(cand_cam)
        r1 = project(in_cur) - obs_cur
        in_cand = jax.vmap(lambda x: sim3.act(m, x))(cur_cam)
        r2 = project(in_cand) - obs_cand
        w1 = w * huber_weights(jnp.linalg.norm(r1, axis=-1), huber_delta)
        w2 = w * huber_weights(jnp.linalg.norm(r2, axis=-1), huber_delta)
        bad = (in_cur[:, 2] <= 1e-6) | (in_cand[:, 2] <= 1e-6)
        r1 = jnp.where(bad[:, None], 1.0, r1)
        r2 = jnp.where(bad[:, None], 1.0, r2)
        # Scale prior: when the relative translation is small, reprojection
        # is nearly invariant to a pure camera-frame scaling (points at
        # depth z map to s*z with identical projections), so log_s is a
        # near-null direction for this objective. The 3D-3D Umeyama
        # initialization DOES observe scale (from the point clouds) — pin
        # log_s to it and let reprojection refine rotation + translation.
        scale_prior = 1.0 * (m[6] - m0[6])
        return jnp.concatenate([(r1 * w1[:, None]).ravel(),
                                (r2 * w2[:, None]).ravel(),
                                scale_prior[None]])

    result = levenberg_marquardt(residuals, m0, num_iters=lm_iters)
    return result.x


def relative_sim3(tracker, kf: Keyframe, cand: Keyframe):
    """Fit the loop transform M = S_cand o S_cur^-1 from matched 3D-3D map
    points (Sim3Solver semantics): a physical landmark drifted into two map
    points — one seen from the current keyframe, one from the candidate —
    and the scaled alignment between their camera-frame positions IS the
    accumulated loop error. Returns (sim7, num_inliers) or None."""
    m = _match_descriptors(
        jnp.asarray(kf.descriptors), jnp.asarray(cand.descriptors),
        valid_a=jnp.asarray(kf.kp_valid & (kf.map_point >= 0)),
        valid_b=jnp.asarray(cand.kp_valid & (cand.map_point >= 0)),
        max_distance=matching.HAMMING_LOW, ratio=0.8,
    )
    idx = np.asarray(m.index)
    ok = np.asarray(m.valid)
    rows = np.nonzero(ok)[0]
    pid_cur = kf.map_point[rows]
    pid_cand = cand.map_point[idx[rows]]
    keep = (
        (pid_cur >= 0) & (pid_cand >= 0)
        & tracker.point_valid[np.clip(pid_cur, 0, None)]
        & tracker.point_valid[np.clip(pid_cand, 0, None)]
        # Exclude "self-pairs" (the keypoints matched onto the SAME map
        # point from both keyframes): they are consistent with the current
        # drifted poses by construction, so they pull the Sim3 fit toward
        # identity drift and dilute the loop correction. The loop error
        # lives in the DUPLICATED landmarks only.
        & (pid_cur != pid_cand)
    )
    rows, pid_cur, pid_cand = rows[keep], pid_cur[keep], pid_cand[keep]
    if rows.size < tracker.config.loop_min_inliers:
        return None

    def to_cam(pose6, pts):
        r = np_rotvec_to_matrix(pose6[:3])
        return pts @ r.T + pose6[3:]

    a = to_cam(kf.pose6, tracker.points[pid_cur])  # current camera frame
    b = to_cam(cand.pose6, tracker.points[pid_cand])  # candidate camera frame

    # Fixed-shape RANSAC: pad correspondences to a bucket.
    n = _bucket(rows.size, 64)
    pa = np.zeros((n, 3))
    pb = np.zeros((n, 3))
    va = np.zeros(n, bool)
    pa[: rows.size] = a
    pb[: rows.size] = b
    va[: rows.size] = True
    fit = sim3.ransac_umeyama(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(va), tracker._next_key()
    )
    # Array pull + host sum: one transfer (see fused_track_step).
    fit_inliers = np.asarray(fit.inliers)
    num_fit_inliers = int(fit_inliers.sum())
    if num_fit_inliers < tracker.config.loop_min_inliers:
        return None

    # Reprojection polish on the RANSAC inliers: image observations are far
    # tighter than triangulated 3D positions, and the pose graph is only as
    # good as this edge.
    inl = fit_inliers[: rows.size]
    r_in = rows[inl]
    obs_cur = kf.kp_norm[r_in]
    obs_cand = cand.kp_norm[idx[r_in]]
    w_cand = tracker.points[pid_cand[inl]]
    w_cur = tracker.points[pid_cur[inl]]
    p = _bucket(r_in.size, 64)
    pad = p - r_in.size

    def padded(arr, width):
        out = np.zeros((p, width))
        out[: r_in.size] = arr
        return jnp.asarray(out)

    refined = refine_sim3(
        jnp.asarray(np.asarray(fit.sim7)),
        jnp.asarray(cand.pose6),
        jnp.asarray(kf.pose6),
        padded(w_cand, 3),
        padded(obs_cur, 2),
        padded(w_cur, 3),
        padded(obs_cand, 2),
        jnp.asarray(np.arange(p) < r_in.size),
    )
    return np.asarray(refined), num_fit_inliers


def close_loop(tracker, cur_idx: int, cand_idx: int, loop_meas7: np.ndarray):
    """Pose-graph correction: chain edges from current keyframe poses plus
    the measured loop edge, one dense Sim(3) LM solve, then keyframe poses
    and map points updated in place (CorrectLoop +
    OptimizeEssentialGraph semantics)."""
    kfs = tracker.keyframes
    k = len(kfs)
    nodes = np.stack(
        [np.concatenate([kf.pose6, [0.0]]) for kf in kfs]
    )  # [K, 7] unit-scale lifts
    edge_i, edge_j, meas = posegraph.chain_edges(jnp.asarray(nodes))
    edge_i = np.concatenate([edge_i, [cand_idx]]).astype(np.int32)
    edge_j = np.concatenate([edge_j, [cur_idx]]).astype(np.int32)
    meas = np.concatenate([meas, loop_meas7[None]])

    # Fixed-shape solve: pad edges (invalid -> zero weight) so XLA reuses
    # the compiled program across closures with similar graph sizes.
    e = _bucket(edge_i.size, 32)
    pad = e - edge_i.size
    edge_i = np.concatenate([edge_i, np.zeros(pad, np.int32)])
    edge_j = np.concatenate([edge_j, np.zeros(pad, np.int32)])
    meas = np.concatenate([meas, np.tile(sim3.identity()[None], (pad, 1))])
    valid = np.zeros(e, bool)
    valid[: e - pad] = True

    result = posegraph.optimize_pose_graph(
        jnp.asarray(nodes), jnp.asarray(edge_i), jnp.asarray(edge_j),
        jnp.asarray(meas), jnp.asarray(valid), num_iters=30,
    )
    corrected = np.asarray(result.nodes7)  # [K, 7]

    # Map points: re-express each through its reference keyframe's
    # correction X' = S_new^-1(S_old(X)) (LoopClosing.cc: corrected
    # landmark = Swc_corrected * Scw_old * X). Reference keyframe = the
    # keyframe that created the point; fall back to the last keyframe for
    # points whose creator was culled.
    by_id = {kf.kf_id: i for i, kf in enumerate(kfs)}
    pids = np.nonzero(tracker.point_valid)[0]
    ref_idx = np.asarray(
        [by_id.get(int(tracker.point_first_kf[p]), k - 1) for p in pids],
        np.int32,
    )
    old_nodes = jnp.asarray(nodes)
    new_nodes = jnp.asarray(corrected)
    pts = jnp.asarray(tracker.points[pids])

    def correct_point(pt, ridx):
        cam = sim3.act(old_nodes[ridx], pt)
        return sim3.act(sim3.inverse(new_nodes[ridx]), cam)

    tracker.points[pids] = np.asarray(jax.vmap(correct_point)(pts, ref_idx))

    # Keyframe poses: Sim(3) -> SE(3) with the scale folded into t.
    for i, kf in enumerate(kfs):
        kf.pose6 = np.asarray(sim3.to_pose6(jnp.asarray(corrected[i])))

    # The tracker's live pose/motion follow the corrected last keyframe.
    tracker._pose = kfs[-1].pose6.copy()


def detect_and_close(tracker, kf: Keyframe, vote_handle=None):
    """Full LoopClosing::Run equivalent for one new keyframe. Returns the
    candidate keyframe index when a loop was accepted and the map was
    corrected, else None. ``vote_handle``: optional pre-dispatched
    start_vote_sweep result (overlaps the sweep with local BA)."""
    cand_idx = detect_candidate(tracker, kf, vote_handle)
    if cand_idx is None:
        return None
    # A closure is actually being attempted (rare): fold in any in-flight
    # deferred local BA first so the Sim3 fit and map correction run on
    # refined geometry, exactly as the synchronous path would.
    tracker._apply_pending_ba()
    cand = tracker.keyframes[cand_idx]
    fit = relative_sim3(tracker, kf, cand)
    if fit is None:
        return None
    loop_meas7, _ = fit
    cur_idx = len(tracker.keyframes) - 1
    close_loop(tracker, cur_idx, cand_idx, loop_meas7)
    return cand_idx
