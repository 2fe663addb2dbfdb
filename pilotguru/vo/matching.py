"""Brute-force binary descriptor matching as one matrix product.

Replaces both ORBmatcher's windowed Hamming searches and the DBoW2
bag-of-words index (/root/reference/thirdparty/orb-slam2/src/ORBmatcher.cc,
thirdparty/DBoW2): at a 2000-feature budget, an exhaustive 2000 x 2000
Hamming table is a single 256-deep matrix product, so approximate
vocabulary indexing buys nothing.

Hamming distance via the +-1 trick: with bits mapped to {-1, +1},
dot(a, b) = 256 - 2 * hamming(a, b), so hamming = (256 - dot) / 2 with the
dot computed from bfloat16 +-1 operands with float32 accumulation, which
is exact: every partial sum is an integer of magnitude <= 256.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pilotguru.vo.features import DESCRIPTOR_BITS

# ORBmatcher thresholds (ORBmatcher.cc TH_LOW / TH_HIGH).
HAMMING_LOW = 50
HAMMING_HIGH = 100


class Matches(NamedTuple):
    index: jnp.ndarray  # [Na] int32 — best match in B per A row (or -1)
    distance: jnp.ndarray  # [Na] int32
    valid: jnp.ndarray  # [Na] bool


def hamming_table(desc_a, desc_b, valid_a=None, valid_b=None):
    """Pairwise Hamming distances [Na, Nb] (invalid rows/cols -> 257).

    Returned as int16: distances fit in [0, 257], and the table is the
    dominant device-memory buffer of every matching pass (Na*Nb entries vs Na*256-bit
    inputs), so halving its width halves the bandwidth of each consumer
    (argmin / masked-min / mutual-check sweeps)."""
    # bf16 +-1 operands with f32 accumulation keep every dot EXACT
    # (integers up to DESCRIPTOR_BITS=256 are representable in bf16 and
    # f32). bf16 vs int8 operands on the GPU: not measured.
    a = (desc_a.astype(jnp.bfloat16) * 2 - 1)
    b = (desc_b.astype(jnp.bfloat16) * 2 - 1)
    dot = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    dist = ((DESCRIPTOR_BITS - dot) * 0.5).astype(jnp.int16)
    big = jnp.int16(DESCRIPTOR_BITS + 1)
    if valid_a is not None:
        dist = jnp.where(valid_a[:, None], dist, big)
    if valid_b is not None:
        dist = jnp.where(valid_b[None, :], dist, big)
    return dist


def match_descriptors(
    desc_a,
    desc_b,
    valid_a=None,
    valid_b=None,
    max_distance: int = HAMMING_LOW,
    ratio: float = 0.9,
    mutual: bool = True,
) -> Matches:
    """Best-match search with Lowe ratio + optional mutual-best check.

    Mirrors ORBmatcher's nearest/second-nearest ratio test
    (ORBmatcher.cc SearchByBoW / SearchForInitialization semantics).
    """
    dist = hamming_table(desc_a, desc_b, valid_a, valid_b)  # [Na, Nb]
    best_idx = jnp.argmin(dist, axis=1)
    best = jnp.take_along_axis(dist, best_idx[:, None], axis=1)[:, 0]
    # Second best: mask out the best column per row. A broadcast compare
    # fuses into the min reduction; a scatter would materialize a second
    # full-size table.
    cols = jnp.arange(dist.shape[1], dtype=jnp.int32)
    masked = jnp.where(
        cols[None, :] == best_idx[:, None], jnp.int16(DESCRIPTOR_BITS + 1), dist
    )
    second = jnp.min(masked, axis=1)

    ok = (best <= max_distance) & (
        best.astype(jnp.float32) < ratio * second.astype(jnp.float32)
    )
    if mutual:
        best_rev = jnp.argmin(dist, axis=0)  # [Nb]
        ok = ok & (best_rev[best_idx] == jnp.arange(dist.shape[0]))
    if valid_a is not None:
        ok = ok & valid_a
    return Matches(
        index=jnp.where(ok, best_idx, -1).astype(jnp.int32),
        distance=best.astype(jnp.int32),
        valid=ok,
    )


def match_projected(
    desc_a,
    xy_a,
    desc_b,
    xy_b,
    search_radius: float,
    valid_a=None,
    valid_b=None,
    max_distance: int = HAMMING_HIGH,
    ratio: float = 0.9,
    level_a=None,
    level_b=None,
    scale: float = 1.2,
    level_window: int = 2,
) -> Matches:
    """Window-constrained matching: candidates must lie within
    ``search_radius`` pixels (ORBmatcher::SearchByProjection semantics, as a
    masked dense table instead of per-cell candidate lists).

    Octave-aware when ``level_a``/``level_b`` are given (ORBmatcher.cc:70-96
    semantics): the search radius for row a scales with its pyramid level
    (coarse features carry proportionally larger positional uncertainty),
    and candidates must sit within ``level_window`` octaves of the row's
    level (the reference searches [nPredictedLevel-1, nPredictedLevel+1]).
    """
    dist = hamming_table(desc_a, desc_b, valid_a, valid_b)
    # d^2 via the ||a||^2 + ||b||^2 - 2ab expansion: one extra matmul
    # instead of materializing a rank-3 [Na, Nb, 2] difference tensor.
    a2 = jnp.sum(xy_a * xy_a, axis=-1)
    b2 = jnp.sum(xy_b * xy_b, axis=-1)
    d2 = a2[:, None] + b2[None, :] - 2.0 * (xy_a @ xy_b.T)
    if level_a is not None:
        radius = search_radius * scale ** level_a.astype(xy_a.dtype)
        in_window = d2 <= (radius**2)[:, None]
        if level_b is not None:
            level_gap = jnp.abs(level_a[:, None] - level_b[None, :])
            in_window = in_window & (level_gap <= level_window)
    else:
        in_window = d2 <= search_radius**2
    dist = jnp.where(in_window, dist, jnp.int16(DESCRIPTOR_BITS + 1))
    best_idx = jnp.argmin(dist, axis=1)
    best = jnp.take_along_axis(dist, best_idx[:, None], axis=1)[:, 0]
    cols = jnp.arange(dist.shape[1], dtype=jnp.int32)
    masked = jnp.where(
        cols[None, :] == best_idx[:, None], jnp.int16(DESCRIPTOR_BITS + 1), dist
    )
    second = jnp.min(masked, axis=1)
    ok = (best <= max_distance) & (
        best.astype(jnp.float32) < ratio * second.astype(jnp.float32)
    )
    if valid_a is not None:
        ok = ok & valid_a
    return Matches(
        index=jnp.where(ok, best_idx, -1).astype(jnp.int32),
        distance=best.astype(jnp.int32),
        valid=ok,
    )


ROTATION_HISTO_BINS = 30  # ORBmatcher.cc HISTO_LENGTH
ROTATION_KEEP_BINS = 3  # ComputeThreeMaxima keeps the 3 dominant bins


def rotation_consistency(
    angle_a,
    angle_b,
    matches: Matches,
    bins: int = ROTATION_HISTO_BINS,
    keep: int = ROTATION_KEEP_BINS,
) -> Matches:
    """Reject matches whose keypoint-orientation difference disagrees with
    the dominant rotation (ORBmatcher.cc CheckOrientation, :171-174 and
    ComputeThreeMaxima): all true matches between two views share one global
    in-plane rotation, so their angle differences pile into a few histogram
    bins while mismatches scatter uniformly. Keep only matches in the
    ``keep`` most-populated bins (a bin must also hold >=10% of the best bin,
    the reference's max2/max3 rule).

    angle_a: [Na] radians (e.g. map-point creation angles or previous-frame
    keypoint angles); angle_b: [Nb] current-frame keypoint angles.
    """
    idx = jnp.clip(matches.index, 0, None)
    diff = angle_b[idx] - angle_a
    two_pi = 2.0 * jnp.pi
    frac = (diff / two_pi) % 1.0  # [0, 1)
    bin_idx = jnp.clip((frac * bins).astype(jnp.int32), 0, bins - 1)
    hist = jnp.zeros((bins,), jnp.int32).at[bin_idx].add(
        matches.valid.astype(jnp.int32)
    )
    top_counts, top_bins = jax.lax.top_k(hist, keep)
    # Secondary bins only count while they hold >= 0.1x the dominant bin.
    keep_mask = top_counts.astype(jnp.float32) >= 0.1 * top_counts[0].astype(
        jnp.float32
    )
    in_top = jnp.any(
        (bin_idx[:, None] == top_bins[None, :]) & keep_mask[None, :], axis=1
    )
    ok = matches.valid & in_top
    return Matches(
        index=jnp.where(ok, matches.index, -1),
        distance=matches.distance,
        valid=ok,
    )
