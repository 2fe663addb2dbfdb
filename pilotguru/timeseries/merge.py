"""Merged time series and interpolation intervals as vectorized numpy index math.

The reference builds these structures with sequential pointer-walking loops
(/root/reference/src/interpolation/align_time_series.cc:29-113 for
MergeTimeSeries, :155-196 for MakeInterpolationIntervals). Here they are
closed-form ``np.unique`` + ``np.searchsorted`` programs producing flat
arrays — the index layout the device programs consume directly.

Semantics preserved exactly (validated against a literal oracle in tests):

MergeTimeSeries: merged events are the distinct union timestamps ``u`` with
``max_k(first_k) <= u <= min_k(last_k)``; the per-component index at event
``u`` is the latest element of that component with timestamp <= u; the
effective event timestamp is ``u`` itself.

MakeInterpolationIntervals: the timeline is cut by both the reference grid
and the interpolation grid; each nonempty piece ``(a, b]`` lying strictly
inside both grids' coverage becomes an interval with
``reference_end_index   = first reference index with timestamp >= b`` and
``interpolation_end_index = first interpolation index with timestamp >= b``.
Pieces are emitted in increasing order of end time, so any reference
sub-range [s, e) corresponds to a *contiguous slice* of the flat piece
arrays — which is what makes sliding-window calibration a batched gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


def _check_strictly_increasing(times: np.ndarray, name: str) -> None:
    if times.size > 1 and not np.all(np.diff(times) > 0):
        raise ValueError(f"{name} timestamps must be strictly increasing")


def merge_time_series(component_times: Sequence[np.ndarray]):
    """Zip-merge K strictly-increasing timestamp vectors.

    Returns:
      event_times_usec: int64 [E] — effective timestamp of each merged event.
      component_indices: int64 [E, K] — per-component most-recent index at
        each event.

    Matches MergeTimeSeries (align_time_series.cc:29-113). Returns empty
    arrays when the series do not overlap (end < start), like the reference.
    """
    comps = [np.asarray(c, dtype=np.int64) for c in component_times]
    if not comps or any(c.size == 0 for c in comps):
        raise ValueError("all components must be non-empty")
    for i, c in enumerate(comps):
        _check_strictly_increasing(c, f"component {i}")

    start_time = max(int(c[0]) for c in comps)
    end_time = min(int(c[-1]) for c in comps)
    if end_time < start_time:
        k = len(comps)
        return np.zeros((0,), np.int64), np.zeros((0, k), np.int64)

    union = np.unique(np.concatenate(comps))
    event_times = union[(union >= start_time) & (union <= end_time)]

    indices = np.stack(
        [np.searchsorted(c, event_times, side="right") - 1 for c in comps],
        axis=1,
    )
    return event_times, indices


@dataclass(frozen=True)
class InterpolationPieces:
    """Flat representation of MakeInterpolationIntervals output.

    One entry per timeline piece, ordered by end time:
      reference_end_index[P]     int64 — index into the reference grid
      interpolation_end_index[P] int64 — index into the interpolation grid
      start_usec[P], end_usec[P] int64
    """

    reference_end_index: np.ndarray
    interpolation_end_index: np.ndarray
    start_usec: np.ndarray
    end_usec: np.ndarray

    @property
    def num_pieces(self) -> int:
        return int(self.reference_end_index.shape[0])

    def duration_sec(self) -> np.ndarray:
        return (self.end_usec - self.start_usec).astype(np.float64) * 1e-6

    def grouped_by_reference(self, num_reference: int):
        """Nested per-reference-index lists, for parity with the reference API."""
        groups = [[] for _ in range(num_reference)]
        for r, i, s, e in zip(
            self.reference_end_index,
            self.interpolation_end_index,
            self.start_usec,
            self.end_usec,
        ):
            groups[int(r)].append((int(r), int(i), int(s), int(e)))
        return groups


def make_interpolation_pieces(
    reference_times: np.ndarray, interpolation_times: np.ndarray
) -> InterpolationPieces:
    """Cut the timeline by both grids into flat piece arrays.

    Matches MakeInterpolationIntervals (align_time_series.cc:155-196); the
    nested per-reference-index grouping is recoverable via
    ``InterpolationPieces.grouped_by_reference``.
    """
    ref = np.asarray(reference_times, dtype=np.int64)
    itp = np.asarray(interpolation_times, dtype=np.int64)
    _check_strictly_increasing(ref, "reference")
    _check_strictly_increasing(itp, "interpolation")

    lo = max(int(ref[0]), int(itp[0]))
    hi = min(int(ref[-1]), int(itp[-1]))
    if hi <= lo:
        z = np.zeros((0,), np.int64)
        return InterpolationPieces(z, z, z, z)

    cuts = np.unique(np.concatenate([ref, itp]))
    cuts = cuts[(cuts >= lo) & (cuts <= hi)]
    starts = cuts[:-1]
    ends = cuts[1:]

    ref_end = np.searchsorted(ref, ends, side="left")
    itp_end = np.searchsorted(itp, ends, side="left")

    # Pieces must lie strictly inside both grids' coverage: the reference
    # requires reference_idx > 0 and interpolation_idx > 0 (the piece has a
    # *previous* point on both grids), which the [lo, hi] clip ensures, and
    # non-emptiness, which consecutive distinct cuts ensure. One residual
    # reference-side guard: pieces ending exactly at reference_ts only get
    # emitted while interpolation points remain (interpolation_idx < size),
    # which the hi clip ensures as well.
    return InterpolationPieces(ref_end, itp_end, starts, ends)


def window_piece_slices(
    pieces: InterpolationPieces,
    reference_times: np.ndarray,
    window_starts: np.ndarray,
    window_ends: np.ndarray,
):
    """Locate each sliding window's contiguous slice of the flat piece arrays.

    A window over reference indices [s, e) admits exactly the pieces with
    ``reference_ts[s] < end_usec <= reference_ts[e-1]`` (window-local
    reference_end_index = global - s; the interpolation grid is shared).
    This reproduces constructing a per-window calibrator on the GPS slice as
    the reference does (fit_motion.cc:184-190).

    Returns (lo[W], hi[W]) int64 piece-index bounds per window.
    """
    ref = np.asarray(reference_times, dtype=np.int64)
    ws = np.asarray(window_starts, dtype=np.int64)
    we = np.asarray(window_ends, dtype=np.int64)
    lo = np.searchsorted(pieces.end_usec, ref[ws], side="right")
    hi = np.searchsorted(pieces.end_usec, ref[we - 1], side="right")
    return lo.astype(np.int64), hi.astype(np.int64)
