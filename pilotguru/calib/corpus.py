"""Batched multi-ride corpus calibration (BASELINE.json stretch config).

The reference has no corpus-scale path at all: preprocess_all.py walks one
ride directory and spawns one fit_motion process per ride, each re-running
the sequential per-window L-BFGS loop (/root/reference/python/
preprocess_all.py, src/fit_motion.cc:179-246). At corpus scale that is
thousands of independent process launches and zero compilation reuse.

Fixed shapes: every ride runs through the SAME compiled ``_solve_and_reduce``
executable. All shape-bearing inputs are padded up to bucket boundaries
(piece count, window count, GPS count, event count, per-window piece
budget), so XLA compiles once per *bucket signature* instead of once per
ride; the real GPS count rides along as a traced scalar so padding is
exactly neutral. With a multi-device ``jax.sharding.Mesh`` the window axis —
the framework's main data-parallel axis — shards across devices and the
cross-window event reductions become XLA collectives.

Padding neutrality, by construction:
  - padded pieces: every window's ``valid`` mask ends at its real ``hi``;
  - padded windows: ``lo == hi == 0`` makes the mask all-False and the
    per-event output weights zero, so they contribute nothing;
  - padded GPS rows: the traced real count gates the target mask;
  - padded events: their counts stay zero and are sliced away on host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.calib.fit_motion import (
    FitMotionConfig,
    FitMotionResult,
    _solve_and_reduce,
    assemble_result,
    build_window_index,
)
from pilotguru.calib.pieces import build_ride_pieces
from pilotguru.calib.rotation_axis import (
    angular_velocities_around_axis,
    principal_rotation_axes,
)


class RideArrays(NamedTuple):
    """One ride's raw sensor streams (same inputs as fit_motion_arrays)."""

    rot_times_usec: np.ndarray  # [R] int64
    rot_rates: np.ndarray  # [R, 3]
    acc_times_usec: np.ndarray  # [A] int64
    accelerations: np.ndarray  # [A, 3]
    gps_times_usec: np.ndarray  # [G] int64
    gps_speeds: np.ndarray  # [G]


@dataclass(frozen=True)
class CorpusBuckets:
    """Shape-bucket granularities. Rides landing in the same bucket tuple
    reuse one compiled executable; coarser buckets mean fewer compiles but
    more padded FLOPs."""

    pieces: int = 4096
    windows: int = 64
    gps: int = 256
    events: int = 4096
    window_pieces: int = 64  # per-window piece budget (pmax) granularity
    rotations: int = 4096  # raw gyro rows (steering projection)
    rotation_chunks: int = 64  # PCA quaternion chunks
    chunk_steps: int = 32  # gyro steps per PCA chunk


def _round_up(n: int, multiple: int) -> int:
    return max(-(-n // multiple) * multiple, multiple)


def _pad_axis0(arr: np.ndarray, target: int) -> np.ndarray:
    pad = target - arr.shape[0]
    if pad <= 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths)


def fit_motion_corpus(
    rides: Sequence[RideArrays],
    config: FitMotionConfig = FitMotionConfig(),
    buckets: CorpusBuckets = CorpusBuckets(),
    mesh: Optional[jax.sharding.Mesh] = None,
    timer=None,
) -> list[FitMotionResult]:
    """Calibrate every ride in a corpus, reusing compiled executables.

    Equivalent per-ride to ``fit_motion_arrays`` (bitwise up to padded-zero
    arithmetic); the win is amortization — one compile per bucket signature
    and, with ``mesh``, window-sharded solves over all devices.
    """
    from pilotguru.utils.profiling import StageTimer

    timer = timer or StageTimer("fit_motion_corpus")
    dtype = config.dtype
    results: list[FitMotionResult] = []

    shard_windows = replicate = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]

        def shard_windows(arr):
            return jax.device_put(arr, NamedSharding(mesh, P(axis)))

        def replicate(arr):
            return jax.device_put(arr, NamedSharding(mesh, P()))

    for ride_arrays in rides:
        with timer.stage("rotation_axis_pca"):
            axes, _ = principal_rotation_axes(
                ride_arrays.rot_times_usec,
                ride_arrays.rot_rates,
                config.principal_rotation_axis_integration_interval_usec,
                dtype=dtype,
                chunk_bucket=buckets.rotation_chunks,
                step_bucket=buckets.chunk_steps,
            )
            vertical = axes[0]
            num_rot = np.asarray(ride_arrays.rot_rates).shape[0]
            rot_padded = _pad_axis0(
                np.asarray(ride_arrays.rot_rates),
                _round_up(num_rot, buckets.rotations),
            )
            steering = angular_velocities_around_axis(
                jnp.asarray(rot_padded, dtype), vertical
            )[:num_rot]

        with timer.stage("host_preprocess"):
            ride = build_ride_pieces(
                ride_arrays.rot_times_usec,
                ride_arrays.rot_rates,
                ride_arrays.acc_times_usec,
                ride_arrays.accelerations,
                ride_arrays.gps_times_usec,
            )
            num_gps = np.asarray(ride_arrays.gps_times_usec).shape[0]
            lo, hi, starts, pmax = build_window_index(
                ride,
                ride_arrays.gps_times_usec,
                config.locations_batch_size,
                config.locations_shift_step,
            )
            num_windows = starts.shape[0]

            p_pad = _round_up(ride.piece_end_usec.shape[0], buckets.pieces)
            w_pad = _round_up(num_windows, buckets.windows)
            if mesh is not None:
                w_pad = _round_up(w_pad, mesh.size)
            g_pad = _round_up(num_gps, buckets.gps)
            e_pad = _round_up(ride.num_events, buckets.events)
            pmax = _round_up(pmax, buckets.window_pieces)

            piece_ops = [
                _pad_axis0(np.asarray(ride.piece_rot_rates), p_pad),
                _pad_axis0(np.asarray(ride.piece_accelerations), p_pad),
                _pad_axis0(np.asarray(ride.piece_dt_sec), p_pad),
                _pad_axis0(np.asarray(ride.piece_gps_end_index), p_pad),
                _pad_axis0(np.asarray(ride.piece_event_index), p_pad),
                _pad_axis0(np.asarray(ride.piece_next_event_differs), p_pad),
                _pad_axis0(np.asarray(ride_arrays.gps_speeds), g_pad),
            ]
            # Fake windows: lo == hi == 0 (all-False piece mask) and
            # start == num_gps (all-False GPS target mask) — a fully zero
            # residual system that LM leaves at the origin.
            starts_padded = np.full(w_pad, num_gps, np.int32)
            starts_padded[:num_windows] = starts
            window_ops = [
                _pad_axis0(lo.astype(np.int32), w_pad),
                _pad_axis0(hi.astype(np.int32), w_pad),
                starts_padded,
            ]

        with timer.stage("solve_and_reduce"):
            piece_dev = [
                jnp.asarray(a, dtype) if a.dtype.kind == "f" else jnp.asarray(a)
                for a in piece_ops
            ]
            window_dev = [jnp.asarray(a) for a in window_ops]
            num_gps_dev = jnp.int32(num_gps)
            if mesh is not None:
                piece_dev = [replicate(a) for a in piece_dev]
                window_dev = [shard_windows(a) for a in window_dev]
                num_gps_dev = replicate(num_gps_dev)

            sol, ev_sum, ev_count, forward_total = _solve_and_reduce(
                *piece_dev,
                *window_dev,
                num_gps_dev,
                max_pieces=pmax,
                batch_size=config.locations_batch_size,
                num_events=e_pad,
                num_iters=config.optimization_iters,
                min_velocity=float(
                    config.forward_axis_inference_min_velocity_m_s
                ),
                min_rotation_rad=float(
                    config.forward_axis_inference_min_rotation_rad
                ),
            )
            ev_sum = np.asarray(ev_sum)[: ride.num_events]
            ev_count = np.asarray(ev_count)[: ride.num_events]

        with timer.stage("smooth_and_assemble"):
            results.append(
                assemble_result(
                    ride,
                    ride_arrays.rot_times_usec,
                    vertical,
                    steering,
                    np.asarray(sol.x, np.float64)[:num_windows],
                    np.asarray(sol.loss, np.float64)[:num_windows],
                    ev_sum,
                    ev_count,
                    np.asarray(forward_total, np.float64),
                    config,
                    event_bucket=buckets.events,
                )
            )

    return results
