"""Two-view geometry: batched-RANSAC essential + homography models with
H/F selection, pose recovery, triangulation.

Replaces the reference's Initializer (thirdparty/orb-slam2/src/Initializer.cc
H/F model selection + reconstruction). Fixed-shape design: RANSAC is a fixed
K-hypothesis vmap — K model fits (tiny SVDs) and one [K, N] scoring matmul —
instead of the reference's two data-dependent RANSAC threads. Calibrated
cameras are assumed (the ride camera is calibrated, src/calibrate.cc), so
the essential matrix is fit directly on normalized coordinates via the
8-point algorithm with the (1, 1, 0) singular-value projection, and the
homography is a Euclidean homography decomposed via Faugeras SVD
(Initializer.cc ReconstructH). Model selection follows the reference's
RH = SH / (SH + SF) ratio (Initializer.cc:104-124): planar-dominant or
low-parallax starts break an essential-only initialization, so when the
homography explains the matches better the pose comes from its
decomposition instead. Both models are fit, scored, and reconstructed in
one fixed-shape device program; the winner is chosen with jnp.where (no
data-dependent control flow under jit).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pilotguru.vo.pose import inv3x3


class TwoViewResult(NamedTuple):
    rotation: jnp.ndarray  # [3, 3] camera1 -> camera2 (R21)
    translation: jnp.ndarray  # [3] unit-norm t21
    points3d: jnp.ndarray  # [N, 3] in camera-1 frame
    inliers: jnp.ndarray  # [N] bool
    score: jnp.ndarray  # [] inlier count of the winning hypothesis


def normalized_coords(xy, fx, fy, cx, cy):
    """Pixel -> normalized camera coordinates."""
    x = (xy[..., 0] - cx) / fx
    y = (xy[..., 1] - cy) / fy
    return jnp.stack([x, y], axis=-1)


def _essential_from_eight(p1, p2):
    """8-point essential matrix from [8, 2] normalized correspondences."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(x1)
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=1
    )  # [8, 9]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    e = vt[-1].reshape(3, 3)
    # Project onto the essential manifold: singular values (1, 1, 0).
    u, _, vte = jnp.linalg.svd(e)
    return u @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], e.dtype)) @ vte


def _sampson_error(e, p1, p2):
    """First-order geometric (Sampson) error of x2' E x1 = 0, [N]."""
    ones = jnp.ones(p1.shape[:-1] + (1,), p1.dtype)
    x1 = jnp.concatenate([p1, ones], axis=-1)  # [N, 3]
    x2 = jnp.concatenate([p2, ones], axis=-1)
    ex1 = x1 @ e.T  # = (E x1)^T rows
    etx2 = x2 @ e  # = (E^T x2)^T rows
    num = jnp.sum(x2 * ex1, axis=-1) ** 2
    den = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
    return num / (den + 1e-18)


def _homography_from_four(p1, p2):
    """DLT homography from [4, 2] normalized correspondences ([8, 9] SVD)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    rows_a = jnp.stack(
        [x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=1
    )
    rows_b = jnp.stack(
        [z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=1
    )
    a = jnp.concatenate([rows_a, rows_b], axis=0)  # [8, 9]
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    return vt[-1].reshape(3, 3)


def _homography_sym_error(h, p1, p2):
    """Symmetric transfer error of x2 ~ H x1 on the normalized plane, [N]
    (the reference's CheckHomography scores both directions,
    Initializer.cc)."""

    def transfer(mat, a, b):
        ones = jnp.ones(a.shape[:-1] + (1,), a.dtype)
        x = jnp.concatenate([a, ones], axis=-1)
        y = x @ mat.T
        w = y[:, 2]
        w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        proj = y[:, :2] / w[:, None]
        err = jnp.sum((proj - b) ** 2, axis=-1)
        return jnp.nan_to_num(err, nan=1e9, posinf=1e9)

    # Near-singular hypotheses (degenerate 4-samples) invert to huge
    # entries; the transfer error then blows up and scores them out.
    det = jnp.linalg.det(h)
    safe = jnp.where(jnp.abs(det) < 1e-12, h + 1e-6 * jnp.eye(3, dtype=h.dtype), h)
    hinv = jnp.linalg.inv(safe)
    return transfer(h, p1, p2) + transfer(hinv, p2, p1)


def decompose_homography(h):
    """Faugeras SVD decomposition of a Euclidean homography into its 8
    motion hypotheses (Initializer.cc ReconstructH).

    Returns (rs [8, 3, 3], ts [8, 3] unit-norm). H = d R + t n^T up to
    scale; with SVD H = U diag(d1, d2, d3) V^T the physical solutions come
    in 4 variants for d' = +d2 (rotation about the plane normal's y-axis in
    the SVD frame) and 4 for d' = -d2 (reflection case).
    """
    u, d, vt = jnp.linalg.svd(h)
    s = jnp.linalg.det(u) * jnp.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    eps = jnp.asarray(1e-12, h.dtype)

    denom13 = jnp.maximum(d1 * d1 - d3 * d3, eps)
    x1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / denom13, 0.0))
    x3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / denom13, 0.0))
    x1s = jnp.stack([x1, x1, -x1, -x1])
    x3s = jnp.stack([x3, -x3, x3, -x3])

    def rot_y(c, sn):
        z = jnp.zeros_like(c)
        o = jnp.ones_like(c)
        return jnp.stack(
            [
                jnp.stack([c, z, -sn], axis=-1),
                jnp.stack([z, o, z], axis=-1),
                jnp.stack([sn, z, c], axis=-1),
            ],
            axis=-2,
        )

    def rot_y_neg(c, sn):
        # d' = -d2 case: R' = [[c, 0, s], [0, -1, 0], [s, 0, -c]].
        z = jnp.zeros_like(c)
        o = jnp.ones_like(c)
        return jnp.stack(
            [
                jnp.stack([c, z, sn], axis=-1),
                jnp.stack([z, -o, z], axis=-1),
                jnp.stack([sn, z, -c], axis=-1),
            ],
            axis=-2,
        )

    # d' = +d2: sin(theta) = (d1 - d3) x1 x3 / d2, cos = (d2^2 + d1 d3)
    # / ((d1 + d3) d2) — the reference's aux_stheta/ctheta.
    den_pos = jnp.maximum((d1 + d3) * d2, eps)
    c_pos = (d2 * d2 + d1 * d3) / den_pos
    s_pos = (d1 - d3) * x1s * x3s / jnp.maximum(d2, eps)
    rp_pos = rot_y(jnp.broadcast_to(c_pos, (4,)), s_pos)  # [4, 3, 3]
    tp_pos = (d1 - d3) * jnp.stack(
        [x1s, jnp.zeros_like(x1s), -x3s], axis=-1
    )  # [4, 3]

    # d' = -d2: sin(phi) = (d1 + d3) x1 x3 / d2, cos = (d1 d3 - d2^2)
    # / ((d1 - d3) d2).
    den_neg = jnp.where(jnp.abs((d1 - d3) * d2) < eps, eps, (d1 - d3) * d2)
    c_neg = (d1 * d3 - d2 * d2) / den_neg
    s_neg = (d1 + d3) * x1s * x3s / jnp.maximum(d2, eps)
    rp_neg = rot_y_neg(jnp.broadcast_to(c_neg, (4,)), s_neg)
    tp_neg = (d1 + d3) * jnp.stack(
        [x1s, jnp.zeros_like(x1s), x3s], axis=-1
    )

    rp = jnp.concatenate([rp_pos, rp_neg], axis=0)  # [8, 3, 3]
    tp = jnp.concatenate([tp_pos, tp_neg], axis=0)  # [8, 3]
    rs = s * jnp.einsum("ij,njk,kl->nil", u, rp, vt)
    ts = jnp.einsum("ij,nj->ni", u, tp)
    norms = jnp.linalg.norm(ts, axis=-1, keepdims=True)
    ts = ts / jnp.maximum(norms, eps)
    return rs, ts


def recover_pose_homography(h, p1, p2, mask):
    """Pick the physical (R, t) among the 8 Faugeras hypotheses by
    cheirality vote (the reference requires the best hypothesis to see the
    most points in front of both cameras, Initializer.cc ReconstructH)."""
    rs, ts = decompose_homography(h)

    def score(r21, t21):
        return _cheirality_count(r21, t21, p1, p2, mask)

    counts, points, goods = jax.vmap(score)(rs, ts)
    best = jnp.argmax(counts)
    return rs[best], ts[best], points[best], goods[best], counts[best]


def triangulate(r21, t21, p1, p2):
    """DLT triangulation in camera-1 frame (inhomogeneous form).

    P1 = [I | 0], P2 = [R | t]. The classic homogeneous DLT finds the null
    vector of the 4x4 row stack with a per-point SVD — a vmapped tiny SVD
    lowers to an iterative scalar loop. Finite scene points always have
    x4 != 0, so fixing x4 = 1 turns the same rows into an overdetermined
    4x3 least-squares problem solved in closed form via 3x3 normal
    equations: two batched matmuls + an adjugate inverse, far cheaper and
    exact on noise-free inputs. Points at infinity (x4 -> 0) come back with
    huge coordinates and are rejected by the callers' finite/depth gates,
    same as the SVD path's x/:x4 division. Returns [N, 3].
    """
    dt = r21.dtype
    n = p1.shape[0]
    zeros = jnp.zeros(n, dt)
    ones = jnp.ones(n, dt)
    # Rows of A [N, 4, 4]: u x (P x) = 0 linearized, P1 = [I|0], P2 = [R|t].
    row1 = jnp.stack([-ones, zeros, p1[:, 0], zeros], axis=-1)
    row2 = jnp.stack([zeros, -ones, p1[:, 1], zeros], axis=-1)
    pr2 = jnp.concatenate([r21, t21[:, None]], axis=1)  # [3, 4]
    row3 = p2[:, 0, None] * pr2[2] - pr2[0]
    row4 = p2[:, 1, None] * pr2[2] - pr2[1]
    a = jnp.stack([row1, row2, row3, row4], axis=-2)  # [N, 4, 4]
    b_mat = a[..., :3]  # [N, 4, 3]
    rhs = -a[..., 3]  # [N, 4]
    g = jnp.einsum("nki,nkj->nij", b_mat, b_mat)  # [N, 3, 3]
    h = jnp.einsum("nki,nk->ni", b_mat, rhs)  # [N, 3]
    return jnp.einsum("nij,nj->ni", inv3x3(g), h)


def _cheirality_count(r21, t21, p1, p2, mask):
    pts = triangulate(r21, t21, p1, p2)
    z1 = pts[:, 2]
    z2 = (pts @ r21.T + t21)[:, 2]
    finite = jnp.all(jnp.isfinite(pts), axis=1)
    good = (z1 > 0) & (z2 > 0) & (jnp.abs(z1) < 1e4) & finite & mask
    return jnp.sum(good), pts, good


def recover_pose(e, p1, p2, mask):
    """Decompose E into the 4 candidate poses, pick by cheirality vote."""
    u, _, vt = jnp.linalg.svd(e)
    # Enforce proper rotations.
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], e.dtype)
    r_a = u @ w @ vt
    r_b = u @ w.T @ vt
    t = u[:, 2]
    candidates = [(r_a, t), (r_a, -t), (r_b, t), (r_b, -t)]
    counts, points, goods = [], [], []
    for r21, t21 in candidates:
        c, pts, good = _cheirality_count(r21, t21, p1, p2, mask)
        counts.append(c)
        points.append(pts)
        goods.append(good)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    rs = jnp.stack([c[0] for c in candidates])
    ts = jnp.stack([c[1] for c in candidates])
    return (
        rs[best],
        ts[best],
        jnp.stack(points)[best],
        jnp.stack(goods)[best],
        counts[best],
    )


def two_view_reconstruction(
    p1,
    p2,
    mask,
    rng_key,
    num_hypotheses: int = 128,
    inlier_threshold: float = 2e-5,
    planar_ratio: float = 0.40,
) -> TwoViewResult:
    """Batched-RANSAC two-view initialization with H/F model selection.

    p1, p2: [N, 2] normalized correspondences (row i of p1 matches row i of
    p2); mask: [N] valid-match flags. ``inlier_threshold`` is a squared
    Sampson error in normalized coordinates (~ (2px / focal)^2).

    Both an essential matrix (8-point) and a homography (4-point DLT) are
    fit from the SAME vmapped hypothesis batch and scored with the
    reference's truncated-chi2 sums SH / SF; when
    RH = SH / (SH + SF) > ``planar_ratio`` the scene is planar-dominant or
    low-parallax and the pose comes from the Faugeras decomposition of H
    (Initializer.cc:104-124 + ReconstructH), otherwise from the essential
    decomposition. Selection is a jnp.where over two fixed-shape
    reconstructions — no data-dependent control flow.
    """
    n = p1.shape[0]
    weights = mask.astype(jnp.float32) + 1e-6

    def sample(key):
        return jax.random.choice(
            key, n, shape=(8,), replace=False, p=weights / jnp.sum(weights)
        )

    keys = jax.random.split(rng_key, num_hypotheses)
    samples = jax.vmap(sample)(keys)  # [K, 8]

    def fit_and_score(idx):
        e = _essential_from_eight(p1[idx], p2[idx])
        err = _sampson_error(e, p1, p2)
        inl = (err < inlier_threshold) & mask
        return e, jnp.sum(inl)

    es, scores = jax.vmap(fit_and_score)(samples)
    best = jnp.argmax(scores)
    e = es[best]
    err = _sampson_error(e, p1, p2)
    inliers = (err < inlier_threshold) & mask

    # Refit on all inliers (least squares over the full inlier set) for a
    # polished model, then recover the pose.
    x1 = jnp.concatenate([p1, jnp.ones((n, 1), p1.dtype)], axis=1)
    x2 = jnp.concatenate([p2, jnp.ones((n, 1), p2.dtype)], axis=1)
    a = jnp.einsum("ni,nj->nij", x2, x1).reshape(n, 9)
    a = a * inliers[:, None]
    _, _, vt = jnp.linalg.svd(a, full_matrices=False)
    e_ref = vt[-1].reshape(3, 3)
    u, _, vte = jnp.linalg.svd(e_ref)
    e_ref = u @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], e.dtype)) @ vte
    err_ref = _sampson_error(e_ref, p1, p2)
    inliers_ref = (err_ref < inlier_threshold) & mask
    use_refit = jnp.sum(inliers_ref) >= jnp.sum(inliers)
    e_final = jnp.where(use_refit, e_ref, e)
    inliers = jnp.where(use_refit, inliers_ref, inliers)
    err_e = jnp.where(use_refit, err_ref, err)

    # ---- homography model on the same hypothesis batch (first 4 of each
    # 8-sample; a homography needs only 4 correspondences).
    def fit_and_score_h(idx):
        h = _homography_from_four(p1[idx[:4]], p2[idx[:4]])
        err_h = _homography_sym_error(h, p1, p2)
        inl = (err_h < 2.0 * inlier_threshold) & mask
        return h, jnp.sum(inl)

    hs, scores_h = jax.vmap(fit_and_score_h)(samples)
    best_h = jnp.argmax(scores_h)
    h_best = hs[best_h]
    err_h = _homography_sym_error(h_best, p1, p2)
    # The symmetric transfer error sums TWO squared distances, so its
    # chi2 gate is double the one-sided Sampson gate (the reference's
    # 5.991 vs 3.84 chi2 thresholds encode the same 2-dof vs 1-dof split).
    h_gate = 2.0 * inlier_threshold
    inliers_h = (err_h < h_gate) & mask

    # Truncated-chi2 scores over ALL matches (Initializer.cc CheckHomography
    # / CheckFundamental: score += th - e2 for e2 < th in each direction).
    sh = jnp.sum(jnp.maximum(h_gate - err_h, 0.0) * mask)
    sf = jnp.sum(jnp.maximum(inlier_threshold - err_e, 0.0) * mask) * 2.0
    rh = sh / jnp.maximum(sh + sf, 1e-18)

    r_e, t_e, pts_e, good_e, _ = recover_pose(e_final, p1, p2, inliers)
    r_h, t_h, pts_h, good_h, _ = recover_pose_homography(
        h_best, p1, p2, inliers_h
    )

    use_h = rh > planar_ratio
    r21 = jnp.where(use_h, r_h, r_e)
    t21 = jnp.where(use_h, t_h, t_e)
    pts = jnp.where(use_h, pts_h, pts_e)
    good = jnp.where(use_h, good_h & inliers_h, good_e & inliers)
    return TwoViewResult(r21, t21, pts, good, jnp.sum(good))
