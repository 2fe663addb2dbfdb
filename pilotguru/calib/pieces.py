"""Host-side construction of the batched sliding-window calibration problem.

The reference solves each sliding window sequentially, re-merging time series
and re-cutting interpolation intervals per window (fit_motion.cc:179-246,
velocity.cc:29-39). Here the ride is preprocessed ONCE into flat numpy
arrays — the "piece" decomposition of the timeline cut by both the GPS grid
and the merged IMU grid — and every window becomes a contiguous slice of
those arrays. The device program then sees dense, padded, masked tensors of
shape [num_windows, max_pieces].

Terminology (matches the reference):
  event  = one merged IMU event (rotations x accelerations zip-merge)
  piece  = one interpolation interval: a timeline span between consecutive
           cuts, carrying the IMU sample indices of its *end* event and the
           GPS index of the reference interval it falls into
           (velocity.cc:79-98 consumes exactly this structure).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pilotguru.timeseries.merge import (
    make_interpolation_pieces,
    merge_time_series,
)


@dataclass(frozen=True)
class RidePieces:
    """Global piece decomposition of one ride (host numpy arrays)."""

    # Merged IMU events.
    event_times_usec: np.ndarray  # [E] int64
    # Per-piece data (ordered by end time).
    piece_end_usec: np.ndarray  # [P] int64
    piece_rot_rates: np.ndarray  # [P, 3] gyro rates at the piece's end event
    piece_accelerations: np.ndarray  # [P, 3]
    piece_dt_sec: np.ndarray  # [P] float64
    piece_gps_end_index: np.ndarray  # [P] int64, global GPS index
    piece_event_index: np.ndarray  # [P] int64, merged-event index
    # True where the NEXT piece belongs to a different event (or none).
    piece_next_event_differs: np.ndarray  # [P] bool

    @property
    def num_pieces(self) -> int:
        return int(self.piece_end_usec.shape[0])

    @property
    def num_events(self) -> int:
        return int(self.event_times_usec.shape[0])


@dataclass(frozen=True)
class WindowedProblem:
    """Dense padded per-window tensors ready for the device solver."""

    pieces: RidePieces
    window_gps_start: np.ndarray  # [W] int64 — global GPS index of window start
    window_gps_len: np.ndarray  # [W] int64 — number of GPS points in window
    piece_lo: np.ndarray  # [W] int64 — first global piece index
    piece_hi: np.ndarray  # [W] int64 — one-past-last global piece index
    # Padded tensors, Pmax = max window piece count.
    rot_rates: np.ndarray  # [W, Pmax, 3]
    accelerations: np.ndarray  # [W, Pmax, 3]
    dt_sec: np.ndarray  # [W, Pmax] (0 on padding)
    segment_ids: np.ndarray  # [W, Pmax] int32 window-local GPS end index (0 pad)
    valid: np.ndarray  # [W, Pmax] bool
    event_last: np.ndarray  # [W, Pmax] bool — last piece of its event in window
    global_piece_index: np.ndarray  # [W, Pmax] int64 (clipped on padding)
    gps_speeds: np.ndarray  # [W, B] float64, zero-padded window GPS speeds
    num_segments: int  # B = locations_batch_size

    @property
    def num_windows(self) -> int:
        return int(self.window_gps_start.shape[0])

    @property
    def max_pieces(self) -> int:
        return int(self.dt_sec.shape[1])


def build_ride_pieces(
    rot_times_usec: np.ndarray,
    rot_rates: np.ndarray,
    acc_times_usec: np.ndarray,
    accelerations: np.ndarray,
    gps_times_usec: np.ndarray,
) -> RidePieces:
    """Merge the IMU streams and cut the timeline against the full GPS grid.

    Reproduces AccelerometerCalibrator's constructor-time preprocessing
    (velocity.cc:14-39) once for the whole ride instead of per window.
    """
    event_times, event_indices = merge_time_series([rot_times_usec, acc_times_usec])
    if event_times.size == 0:
        raise ValueError("IMU streams do not overlap")

    pieces = make_interpolation_pieces(gps_times_usec, event_times)
    e_idx = pieces.interpolation_end_index
    rot_idx = event_indices[e_idx, 0]
    acc_idx = event_indices[e_idx, 1]

    next_differs = np.ones(e_idx.shape[0], dtype=bool)
    if e_idx.shape[0] > 1:
        next_differs[:-1] = e_idx[1:] != e_idx[:-1]

    return RidePieces(
        event_times_usec=event_times,
        piece_end_usec=pieces.end_usec,
        piece_rot_rates=np.asarray(rot_rates, np.float64)[rot_idx],
        piece_accelerations=np.asarray(accelerations, np.float64)[acc_idx],
        piece_dt_sec=pieces.duration_sec(),
        piece_gps_end_index=pieces.reference_end_index,
        piece_event_index=e_idx,
        piece_next_event_differs=next_differs,
    )


def build_windowed_problem(
    ride: RidePieces,
    gps_times_usec: np.ndarray,
    gps_speeds: np.ndarray,
    locations_batch_size: int = 40,
    locations_shift_step: int = 5,
    pad_pieces_to_multiple: int = 8,
) -> WindowedProblem:
    """Slice + pad the global pieces into dense per-window tensors.

    Window placement matches the reference sliding loop (fit_motion.cc:179-186):
    starts at 0, step ``locations_shift_step``, window end clipped to the GPS
    count. A window over GPS indices [s, e) owns exactly the global pieces
    with gps_ts[s] < end_usec <= gps_ts[e-1] (they form a contiguous slice),
    with window-local reference index = global - s.
    """
    gps_times = np.asarray(gps_times_usec, np.int64)
    gps_speeds = np.asarray(gps_speeds, np.float64)
    num_gps = gps_times.shape[0]

    starts = np.arange(0, num_gps, locations_shift_step, dtype=np.int64)
    ends = np.minimum(starts + locations_batch_size, num_gps)
    lo = np.searchsorted(ride.piece_end_usec, gps_times[starts], side="right")
    hi = np.searchsorted(ride.piece_end_usec, gps_times[ends - 1], side="right")
    lo = lo.astype(np.int64)
    hi = np.maximum(hi, lo).astype(np.int64)

    w = starts.shape[0]
    pmax = int(np.max(hi - lo)) if w else 0
    if pad_pieces_to_multiple > 1 and pmax > 0:
        pmax = -(-pmax // pad_pieces_to_multiple) * pad_pieces_to_multiple
    pmax = max(pmax, 1)

    offsets = np.arange(pmax, dtype=np.int64)[None, :]  # [1, Pmax]
    gidx = lo[:, None] + offsets  # [W, Pmax]
    valid = gidx < hi[:, None]
    gidx_c = np.minimum(gidx, max(ride.num_pieces - 1, 0))

    rot = np.where(valid[..., None], ride.piece_rot_rates[gidx_c], 0.0)
    acc = np.where(valid[..., None], ride.piece_accelerations[gidx_c], 0.0)
    dt = np.where(valid, ride.piece_dt_sec[gidx_c], 0.0)
    seg = np.where(
        valid, ride.piece_gps_end_index[gidx_c] - starts[:, None], 0
    ).astype(np.int32)

    # Last piece of its IMU event *within the window*: either the window's
    # final piece, or the global next piece belongs to a different event.
    event_last = valid & (
        ride.piece_next_event_differs[gidx_c] | (gidx == hi[:, None] - 1)
    )

    b = int(locations_batch_size)
    speeds = np.zeros((w, b), np.float64)
    for k in range(w):  # W is small (~G/step); python loop is negligible.
        s, e = int(starts[k]), int(ends[k])
        speeds[k, : e - s] = gps_speeds[s:e]

    return WindowedProblem(
        pieces=ride,
        window_gps_start=starts,
        window_gps_len=ends - starts,
        piece_lo=lo,
        piece_hi=hi,
        rot_rates=rot,
        accelerations=acc,
        dt_sec=dt,
        segment_ids=seg,
        valid=valid,
        event_last=event_last,
        global_piece_index=gidx_c,
        gps_speeds=speeds,
        num_segments=b,
    )
