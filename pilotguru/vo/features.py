"""ORB-style feature extraction as fixed-shape array programs.

Replaces the reference's vendored ORBextractor
(/root/reference/thirdparty/orb-slam2/src/ORBextractor.cc: image pyramid +
FAST + octree keypoint distribution + rBRIEF). Accelerator-first design
decisions:

- Everything is fixed-shape: each pyramid level yields exactly
  ``per_level_budget`` keypoints (invalid slots masked), so the whole
  extractor jits once and batches over frames.
- The octree redistribution (ORBextractor.cc ComputeKeyPointsOctTree)
  becomes grid-cell top-k: 3x3 non-max suppression, then the best keypoint
  per cell, then the global top-N among cell winners — same goal (spatial
  spread under a budget) without data-dependent tree recursion.
- FAST-9/16 corner test with a sum-of-absolute-differences response
  (original FAST paper scoring; OpenCV's arc-max score differs only in
  within-cell ranking).
- rBRIEF uses a deterministic generated 256-pair Gaussian pattern (BRIEF
  paper construction, fixed seed) instead of OpenCV's learned table; all
  matching happens inside this framework so descriptor bit-compatibility
  with OpenCV is not required (DBoW2 is replaced by brute-force
  matrix-product matching, see vo/matching.py).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# 16-pixel Bresenham circle of radius 3 (FAST-9/16), starting at 12 o'clock,
# clockwise.
FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)  # (row, col) offsets

PATCH_RADIUS = 15  # intensity-centroid orientation patch (ORB standard)
BRIEF_RADIUS = 13  # max |coordinate| of pattern points
DESCRIPTOR_BITS = 256


def make_brief_pattern(seed: int = 7) -> np.ndarray:
    """Deterministic BRIEF-II pattern: pairs ~ N(0, (patch/5)^2), clipped.

    Returns int32 [256, 4] = (y1, x1, y2, x2) in patch coordinates.
    """
    rng = np.random.default_rng(seed)
    sigma = (2 * BRIEF_RADIUS + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(DESCRIPTOR_BITS, 4))
    return np.clip(np.round(pts), -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.int32)


BRIEF_PATTERN = make_brief_pattern()


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one image (or a batch with leading dims)."""

    xy: jnp.ndarray  # [K, 2] float32 — (x, y) in full-resolution coordinates
    response: jnp.ndarray  # [K]
    angle: jnp.ndarray  # [K] radians
    level: jnp.ndarray  # [K] int32 pyramid level
    valid: jnp.ndarray  # [K] bool
    descriptors: jnp.ndarray  # [K, 256] uint8 bits (0/1)


def fast_scores(image, threshold: float):
    """FAST-9/16 corner response map.

    image: [H, W] float. Returns [H, W] response (0 where not a corner).
    Border of 3 pixels is zero.

    The 16 circle taps are static slices combined elementwise (bits packed
    into one int32 word per side, SAD terms summed in a fixed order), so
    XLA fuses the whole test into one pass over the image.
    """
    h, w = image.shape
    padded = jnp.pad(image, 3, mode="edge")
    brighter = darker = jnp.zeros((h, w), jnp.int32)
    sad_bright = sad_dark = jnp.zeros((h, w), image.dtype)
    for i, (dy, dx) in enumerate(FAST_CIRCLE):
        diff = padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - image
        is_bright, is_dark = diff > threshold, diff < -threshold
        brighter = brighter | (is_bright.astype(jnp.int32) << i)
        darker = darker | (is_dark.astype(jnp.int32) << i)
        sad_bright = sad_bright + jnp.where(is_bright, diff - threshold, 0.0)
        sad_dark = sad_dark + jnp.where(is_dark, -diff - threshold, 0.0)

    # >= 9 contiguous set bits on the 16-cycle, all start positions at once.
    # Binary doubling on the packed word: R_2k(i) = R_k(i) & R_k(i+k), so a
    # run of 9 costs 4 rotate-ANDs.
    def rot(x, k):  # bit i of the result is bit i+k (mod 16) of x
        return ((x >> k) | (x << (16 - k))) & 0xFFFF

    def run9(bits):
        r2 = bits & rot(bits, 1)
        r4 = r2 & rot(r2, 2)
        r8 = r4 & rot(r4, 4)
        return (r8 & rot(bits, 8)) != 0

    corner = run9(brighter) | run9(darker)
    response = jnp.where(corner, jnp.maximum(sad_bright, sad_dark), 0.0)
    # Zero the 3-pixel border (circle taps use edge padding there).
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    inside = (rows >= 3) & (rows < h - 3) & (cols >= 3) & (cols < w - 3)
    return jnp.where(inside, response, 0.0)


def fast_and_nms(image, threshold: float):
    """(raw FAST response, 3x3-NMS'd response) pair.

    The extractor needs both maps: raw feeds subpixel refinement, NMS'd
    feeds grid selection. XLA fuses the 16-tap test and the NMS window
    into elementwise and reduce-window passes over the level image, and
    into the pyramid resize before them (PERF.md: on the H100 this beats
    two hand-written Pallas kernels end to end).
    """
    raw = fast_scores(image, threshold)
    return raw, nms3x3(raw)


def nms3x3(scores):
    """Keep only strict local maxima in 3x3 neighborhoods."""
    neighborhood = jax.lax.reduce_window(
        scores,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(3, 3),
        window_strides=(1, 1),
        padding="SAME",
    )
    return jnp.where(scores >= neighborhood, scores, 0.0)


def select_grid_topk(scores, num_keypoints: int, cell: int = 16):
    """Spatially-spread top-N selection: best-per-cell, then global top-N.

    Returns (yx [N, 2] int32, response [N], valid [N]).
    """
    h, w = scores.shape
    gh, gw = h // cell, w // cell
    cropped = scores[: gh * cell, : gw * cell]
    cells = cropped.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3)
    flat = cells.reshape(gh * gw, cell * cell)
    best = jnp.argmax(flat, axis=1)  # [cells]
    best_score = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    # Reconstruct absolute coordinates.
    cell_row = jnp.arange(gh * gw) // gw
    cell_col = jnp.arange(gh * gw) % gw
    y = cell_row * cell + best // cell
    x = cell_col * cell + best % cell

    k = min(num_keypoints, gh * gw)
    top_scores, top_idx = jax.lax.top_k(best_score, k)
    yx = jnp.stack([y[top_idx], x[top_idx]], axis=1).astype(jnp.int32)
    valid = top_scores > 0
    if k < num_keypoints:
        pad = num_keypoints - k
        yx = jnp.concatenate([yx, jnp.zeros((pad, 2), jnp.int32)])
        top_scores = jnp.concatenate([top_scores, jnp.zeros((pad,), scores.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return yx, top_scores, valid


def subpixel_offsets(raw_scores, yx):
    """Quadratic (parabola) sub-pixel refinement at integer keypoints.

    Fits a 1D parabola per axis through the raw (pre-NMS) FAST responses of
    the 3-neighborhood; offsets clip to [-0.5, 0.5]. Integer FAST corners
    carry ~0.5 px quantization noise, which dominates downstream pose noise
    at automotive focal lengths.
    Returns float offsets [K, 2] in (row, col) order.
    """
    h, w = raw_scores.shape
    y = jnp.clip(yx[:, 0], 1, h - 2)
    x = jnp.clip(yx[:, 1], 1, w - 2)

    def axis_offset(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        off = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (sm - sp) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    oy = axis_offset(
        raw_scores[y - 1, x], raw_scores[y, x], raw_scores[y + 1, x]
    )
    ox = axis_offset(
        raw_scores[y, x - 1], raw_scores[y, x], raw_scores[y, x + 1]
    )
    return jnp.stack([oy, ox], axis=1)


def orientations(image, yx):
    """Intensity-centroid angles at keypoints (ORB, IC_Angle).

    image: [H, W]; yx: [K, 2] int32. Returns [K] radians.
    """
    r = PATCH_RADIUS
    padded = jnp.pad(image, r, mode="edge")
    size = 2 * r + 1
    offs = jnp.arange(size, dtype=jnp.float32) - r
    dy = offs[:, None]
    dx = offs[None, :]
    circular = (dy * dy + dx * dx) <= r * r

    def one(point):
        patch = jax.lax.dynamic_slice(padded, (point[0], point[1]), (size, size))
        patch = jnp.where(circular, patch, 0.0)
        m10 = jnp.sum(patch * dx)
        m01 = jnp.sum(patch * dy)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(yx)


def brief_descriptors(image, yx, angles, pattern=None):
    """Steered BRIEF bits at keypoints.

    image: [H, W] (pre-smoothed); yx [K, 2] int32; angles [K] radians.
    Returns uint8 bits [K, 256].
    """
    if pattern is None:
        pattern = BRIEF_PATTERN
    pat = jnp.asarray(pattern, jnp.float32)  # [256, 4] (y1, x1, y2, x2)
    pad = BRIEF_RADIUS + 6  # rotation can push points slightly out
    padded = jnp.pad(image, pad, mode="edge")

    def one(point, angle):
        c, s = jnp.cos(angle), jnp.sin(angle)
        # Rotate pattern points: (x', y') = (x c - y s, x s + y c).
        y1, x1, y2, x2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

        def rot(x, y):
            return x * c - y * s, x * s + y * c

        rx1, ry1 = rot(x1, y1)
        rx2, ry2 = rot(x2, y2)
        py = point[0] + pad
        px = point[1] + pad
        iy1 = jnp.round(ry1).astype(jnp.int32) + py
        ix1 = jnp.round(rx1).astype(jnp.int32) + px
        iy2 = jnp.round(ry2).astype(jnp.int32) + py
        ix2 = jnp.round(rx2).astype(jnp.int32) + px
        v1 = padded[iy1, ix1]
        v2 = padded[iy2, ix2]
        return (v1 < v2).astype(jnp.uint8)

    return jax.vmap(one)(yx, angles)


PATCH_GATHER_RADIUS = 19  # covers orientation (r=15) + rotated BRIEF taps
_PATCH_SIZE = 2 * PATCH_GATHER_RADIUS + 1
BRIEF_ANGLE_BINS = 32  # steering quantization (ORB paper uses 2*pi/30)


def extract_patches(image, yx, radius: int = PATCH_GATHER_RADIUS):
    """Gather one square patch per keypoint: [K, 2r+1, 2r+1].

    The single block-structured fetch that feeds both the orientation
    moments and the BRIEF matmul — the only data-dependent addressing left
    in the descriptor path (replacing the 512 per-tap scattered gathers of
    brief_descriptors per keypoint). XLA fuses the gather into its
    consumers (quantize + moment/BRIEF contractions).
    """
    size = 2 * radius + 1
    padded = jnp.pad(image, radius, mode="edge")

    def one(point):
        return jax.lax.dynamic_slice(padded, (point[0], point[1]), (size, size))

    return jax.vmap(one)(yx)


def _orientation_moment_weights():
    offs = np.arange(_PATCH_SIZE, dtype=np.float32) - PATCH_GATHER_RADIUS
    dy = offs[:, None]
    dx = offs[None, :]
    circ = ((dy * dy + dx * dx) <= PATCH_RADIUS * PATCH_RADIUS).astype(
        np.float32
    )
    return dx * circ, dy * circ


_ORIENT_WX, _ORIENT_WY = _orientation_moment_weights()


def orientations_from_patches(patches):
    """Intensity-centroid angles as two static masked-moment contractions
    (elementwise einsum; no per-keypoint addressing). patches [K, S, S]."""
    m10 = jnp.einsum("kij,ij->k", patches, jnp.asarray(_ORIENT_WX))
    m01 = jnp.einsum("kij,ij->k", patches, jnp.asarray(_ORIENT_WY))
    return jnp.arctan2(m01, m10)


def _build_brief_bin_matrix() -> np.ndarray:
    """Per-angle-bin BRIEF tap-selection matrix, int8 [S*S, BINS*256].

    Column (b, j) holds +1 at the bin-b-rotated tap-1 pixel of pair j and
    -1 at tap-2, so patch_flat @ D = (v1 - v2) for every (bin, pair) at
    once — steered BRIEF becomes one integer matmul instead of 512 scattered
    reads per keypoint. Taps that round to the same pixel cancel to a 0
    column entry (value 0 -> bit 0, matching the v1 < v2 tie rule).
    """
    pat = np.asarray(BRIEF_PATTERN, np.float32)
    d = np.zeros((_PATCH_SIZE * _PATCH_SIZE, BRIEF_ANGLE_BINS, pat.shape[0]),
                 np.int8)
    y1, x1, y2, x2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    for b in range(BRIEF_ANGLE_BINS):
        ang = 2 * np.pi * b / BRIEF_ANGLE_BINS
        c, s = np.cos(ang), np.sin(ang)
        for taps, sign in (((y1, x1), 1), ((y2, x2), -1)):
            ty, tx = taps
            iy = np.round(tx * s + ty * c).astype(int) + PATCH_GATHER_RADIUS
            ix = np.round(tx * c - ty * s).astype(int) + PATCH_GATHER_RADIUS
            for j in range(pat.shape[0]):
                d[iy[j] * _PATCH_SIZE + ix[j], b, j] += sign
    return d.reshape(_PATCH_SIZE * _PATCH_SIZE, -1)


_BRIEF_BIN_MATRIX = _build_brief_bin_matrix()


def brief_from_patches(patches, angles):
    """Steered BRIEF bits from gathered patches via one int8 matmul.

    The patch is quantized to the 0..255 grid (see
    ``brief_from_grey_levels``). patches [K, S, S] float in [0, 1];
    angles [K].
    """
    levels = jnp.clip(jnp.round(patches * 255.0), 0.0, 255.0)
    return brief_from_grey_levels(levels, angles)


def brief_from_grey_levels(levels, angles):
    """Steered BRIEF bits from patches on the 0..255 grey-level grid.

    The patch is recentred by -128 so the two-term tap difference is exact
    in the int32 accumulator; the angle is quantized to BRIEF_ANGLE_BINS
    steering bins (the original ORB design — the reference's exact-angle
    OpenCV variant differs only in sub-bin tap rounding) and the keypoint's
    bin is collapsed with a one-hot einsum rather than a gather.
    levels [K, S, S] integer-valued; angles [K].
    """
    k = levels.shape[0]
    flat = (levels - 128).astype(jnp.int8).reshape(k, _PATCH_SIZE * _PATCH_SIZE)
    vals = jax.lax.dot_general(
        flat,
        jnp.asarray(_BRIEF_BIN_MATRIX),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(k, BRIEF_ANGLE_BINS, DESCRIPTOR_BITS)
    bins = jnp.mod(
        jnp.round(angles / (2 * jnp.pi / BRIEF_ANGLE_BINS)).astype(jnp.int32),
        BRIEF_ANGLE_BINS,
    )
    onehot = jax.nn.one_hot(bins, BRIEF_ANGLE_BINS, dtype=jnp.int32)
    picked = jnp.einsum("kbj,kb->kj", vals, onehot)
    return (picked < 0).astype(jnp.uint8)


# The pyramid and the descriptor blur run on the 0..255 grey-level grid in
# fixed-point integer arithmetic, like the reference's uint8 pyramid
# (ORBextractor::ComputePyramid: cv::resize and cv::GaussianBlur on CV_8U).
# Every value that feeds keypoint selection and the BRIEF bits is then an
# exact integer (FAST sums and orientation moments of such values stay
# below 2**24, so float32 holds them exactly in any summation order), and
# the extractor gives the same keypoints and descriptors on every backend.
# Weight bits per separable pass (OpenCV's INTER_RESIZE_COEF_BITS); two
# passes stay exact in int32: 255 * 2**22 < 2**31.
_FIXED_POINT_BITS = 11
_BLUR_SIGMA = 2.0


def _fixed_point_taps(weights: np.ndarray):
    """[out, in] float weights, rows summing to 1 -> (index, weight) taps,
    int32 [out, T] each, the weights of a row summing to 2**_FIXED_POINT_BITS
    (the rounding residue goes to the row's largest weight)."""
    one = 1 << _FIXED_POINT_BITS
    taps = max(int((weights > 0).sum(axis=1).max()), 1)
    index = np.zeros((weights.shape[0], taps), np.int32)
    fixed = np.zeros((weights.shape[0], taps), np.int32)
    for i, row in enumerate(weights):
        nz = np.nonzero(row > 0)[0]
        q = np.round(row[nz] * one).astype(np.int64)
        q[np.argmax(row[nz])] += one - q.sum()
        index[i, : len(nz)] = nz
        fixed[i, : len(nz)] = q
    return index, fixed


@lru_cache(maxsize=None)
def _resize_taps(in_size: int, out_size: int):
    """Taps of ``jax.image.resize(method="linear")`` along one axis: the
    triangle kernel, widened by the downscale factor (antialiasing)."""
    inv_scale = in_size / out_size
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[:, None] - np.arange(in_size)[None, :])
    weights = np.maximum(0.0, 1.0 - dist / max(inv_scale, 1.0))
    return _fixed_point_taps(weights / weights.sum(axis=1, keepdims=True))


@lru_cache(maxsize=None)
def _blur_taps():
    """The descriptor blur's Gaussian (sigma 2, radius 8) in fixed point;
    taps that round to 0 are dropped. Returns [(offset, weight)]."""
    radius = int(round(4.0 * _BLUR_SIGMA))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * _BLUR_SIGMA**2))
    index, fixed = _fixed_point_taps((k / k.sum())[None, :])
    return tuple(
        (int(i) - radius, int(wt))
        for i, wt in zip(index[0], fixed[0]) if wt
    )


def _round_shift(x, bits: int):
    return (x + (1 << (bits - 1))) >> bits


def resize_grey_levels(levels, height: int, width: int):
    """Antialiased linear resize of an int32 0..255 image, exact in int32."""

    def axis_pass(x, axis: int, out_size: int):
        index, fixed = _resize_taps(x.shape[axis], out_size)
        out = None
        for t in range(index.shape[1]):
            w = jnp.asarray(fixed[:, t])
            term = jnp.take(x, jnp.asarray(index[:, t]), axis=axis) * (
                w[:, None] if axis == 0 else w[None, :]
            )
            out = term if out is None else out + term
        return out

    rows = axis_pass(levels, 0, height)
    return _round_shift(axis_pass(rows, 1, width), 2 * _FIXED_POINT_BITS)


def blur_grey_levels(levels):
    """Separable reflect-padded Gaussian blur of an int32 0..255 image,
    exact in int32: the descriptor pre-smoothing (ORBextractor blurs with
    sigma 2 and BORDER_REFLECT_101 as well)."""
    taps = _blur_taps()
    radius = max(abs(off) for off, _ in taps)

    def axis_pass(x, axis: int):
        n = x.shape[axis]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (radius, radius)
        padded = jnp.pad(x, pad, mode="reflect")
        out = None
        for off, wt in taps:
            term = wt * jax.lax.slice_in_dim(
                padded, radius + off, radius + off + n, axis=axis
            )
            out = term if out is None else out + term
        return out

    return _round_shift(axis_pass(axis_pass(levels, 0), 1),
                        2 * _FIXED_POINT_BITS)


def pyramid_level_budgets(total: int, num_levels: int, scale: float) -> List[int]:
    """Per-level keypoint budgets with the ORB 1/scale geometric split
    (ORBextractor constructor semantics)."""
    factor = 1.0 / scale
    first = total * (1 - factor) / (1 - factor**num_levels)
    budgets = [int(round(first * factor**i)) for i in range(num_levels)]
    budgets[-1] = max(total - sum(budgets[:-1]), 0)
    return budgets


@partial(
    jax.jit,
    static_argnames=(
        "num_levels", "scale", "threshold", "total_budget", "cell",
    ),
)
def extract_orb_features(
    image,
    num_levels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0 / 255.0,
    total_budget: int = 2000,
    cell: int = 16,
) -> Keypoints:
    """Full extractor over an image pyramid -> fixed-size Keypoints.

    image: [H, W] float grayscale in [0, 1], read on the 0..255 grid.
    Coordinates are reported in level-0 pixels (scaled back up like
    ORBextractor); responses in image units.
    """
    budgets = pyramid_level_budgets(total_budget, num_levels, scale)
    h, w = image.shape
    # FAST runs on grey levels: the threshold in the same unit.
    threshold_levels = round(threshold * 255.0, 6)

    all_xy, all_resp, all_angle, all_level, all_valid, all_desc = (
        [], [], [], [], [], [],
    )
    base = jnp.clip(jnp.round(image * 255.0), 0, 255).astype(jnp.int32)
    for level in range(num_levels):
        lh = max(int(round(h / scale**level)), 32)
        lw = max(int(round(w / scale**level)), 32)
        levels = base if level == 0 else resize_grey_levels(base, lh, lw)
        raw, scores = fast_and_nms(levels.astype(jnp.float32), threshold_levels)
        yx, resp, valid = select_grid_topk(scores, budgets[level], cell)
        offsets = subpixel_offsets(raw, yx)
        # One patch gather per keypoint feeds both orientation moments and
        # the BRIEF matmul. Orientation is computed on the blurred image
        # (the reference's IC_Angle uses the raw level, but the radius-15
        # disc moments are low-pass already; one gather instead of two is
        # worth the sub-degree difference).
        smoothed = blur_grey_levels(levels).astype(jnp.float32)
        patches = extract_patches(smoothed, yx)
        angle = orientations_from_patches(patches)
        desc = brief_from_grey_levels(patches, angle)
        level_scale = scale**level
        refined = yx.astype(jnp.float32) + offsets
        all_xy.append(
            jnp.stack([refined[:, 1], refined[:, 0]], axis=1) * level_scale
        )
        all_resp.append(resp / 255.0)
        all_angle.append(angle)
        all_level.append(jnp.full((yx.shape[0],), level, jnp.int32))
        all_valid.append(valid)
        all_desc.append(desc)

    return Keypoints(
        xy=jnp.concatenate(all_xy),
        response=jnp.concatenate(all_resp),
        angle=jnp.concatenate(all_angle),
        level=jnp.concatenate(all_level),
        valid=jnp.concatenate(all_valid),
        descriptors=jnp.concatenate(all_desc),
    )


@partial(
    jax.jit,
    static_argnames=(
        "num_levels", "scale", "threshold", "total_budget", "cell",
    ),
)
def extract_orb_features_batch(
    images,
    num_levels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0 / 255.0,
    total_budget: int = 2000,
    cell: int = 16,
) -> Keypoints:
    """Batched extractor: [B, H, W] -> Keypoints with leading batch dim.

    Tracking is sequential, but extraction is stateless per frame, so the
    video pipeline prefetches features for whole frame batches in ONE device
    program: fewer dispatches and better device utilization than per-frame
    calls. Restarted segments reuse already-extracted features for free.

    Frames run under ``lax.map`` (sequential inside the one program), not
    ``vmap``: with a leading batch dimension XLA may stop fusing the 16
    FAST circle taps into one image pass and lower the per-keypoint patch
    slices to a 2-level gather. Sequential per-frame execution keeps every
    stage at its single-frame cost while paying one dispatch for the whole
    batch. (map vs vmap on the GPU: not measured.)
    """
    return jax.lax.map(
        lambda g: extract_orb_features(
            g,
            num_levels=num_levels,
            scale=scale,
            threshold=threshold,
            total_budget=total_budget,
            cell=cell,
        ),
        images,
    )
