"""End-to-end fit_motion: IMU + GPS -> velocities, steering, forward axis.

Batched device pipeline with the same inputs/outputs as the reference binary
(/root/reference/src/fit_motion.cc):

  1. Principal-rotation-axis PCA -> vehicle vertical axis (rotation.cc:16-57).
  2. Steering signal: gyro rates projected on the vertical axis
     (fit_motion.cc:139-154).
  3. Sliding-window IMU calibration: the reference runs an independent
     <=500-iteration L-BFGS per window, sequentially (fit_motion.cc:179-246).
     Here every window solves simultaneously as one batched Gauss-Newton
     device program; per-window trajectory replays, cross-window averaging,
     and the forward-axis accumulation are fused segment-sums.
  4. Gaussian post-smoothing of averaged speeds (fit_motion.cc:270-273).
  5. Forward axis: device-frame velocity sum over confident windows,
     vertical component removed, normalized (fit_motion.cc:222-245, 281-283).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.calib.accelerometer import solve_windows, window_residuals
from pilotguru.calib.pieces import WindowedProblem, build_ride_pieces
from pilotguru.calib.rotation_axis import (
    angular_velocities_around_axis,
    principal_rotation_axes,
)
from pilotguru.geometry.quaternion import quat_conjugate, quat_rotate
from pilotguru.geometry.strapdown import integrate_motion
from pilotguru.timeseries.smoothing import smooth_time_series


@dataclass(frozen=True)
class FitMotionConfig:
    """Mirrors the reference flags (fit_motion.cc:79-104)."""

    locations_batch_size: int = 40
    locations_shift_step: int = 5
    optimization_iters: int = 40  # Gauss-Newton; reference L-BFGS used 500.
    post_smoothing_sigma_sec: float = 0.003
    principal_rotation_axis_integration_interval_usec: int = 500_000
    forward_axis_inference_min_velocity_m_s: float = 5.0
    forward_axis_inference_min_rotation_rad: float = 0.2
    dtype: object = jnp.float64


@dataclass
class FitMotionResult:
    vertical_axis: np.ndarray  # [3]
    steering_times_usec: np.ndarray  # [R] (= rotation timestamps)
    steering_angular_velocities: np.ndarray  # [R]
    velocity_times_usec: np.ndarray  # [E'] covered merged-IMU-event times
    velocities_m_s: np.ndarray  # [E'] smoothed averaged speeds
    forward_axis: np.ndarray  # [3] unit, in device frame
    window_params: np.ndarray  # [W, 9] fitted calibration parameters
    window_final_loss: np.ndarray  # [W] final sum-of-squares residuals



@partial(
    jax.jit,
    static_argnames=(
        "max_pieces",
        "batch_size",
        "num_events",
        "num_iters",
        "min_velocity",
        "min_rotation_rad",
    ),
)
def _solve_and_reduce(
    piece_rot,  # [P, 3] flat piece arrays (uploaded once, ~MBs)
    piece_acc,  # [P, 3]
    piece_dt,  # [P]
    piece_gps_end,  # [P] int32
    piece_event,  # [P] int32
    piece_next_differs,  # [P] bool
    gps_speeds,  # [G]
    window_lo,  # [W] int32 — first global piece index per window
    window_hi,  # [W] int32
    window_start,  # [W] int32 — window's first GPS index
    num_gps,  # [] int32 — REAL gps count; arrays may be padded past it
    max_pieces: int,
    batch_size: int,
    num_events: int,
    num_iters: int,
    min_velocity: float,
    min_rotation_rad: float,
):
    """One device program: window gather/padding + batched GN solve + replay
    + cross-window reductions.

    The padded [W, Pmax] tensors are built ON DEVICE from the flat piece
    arrays (the windows are contiguous slices), so the host uploads ~15x
    less data than shipping pre-padded windows and does no big gathers.
    """
    dtype = piece_rot.dtype
    num_pieces = piece_rot.shape[0]

    offs = jnp.arange(max_pieces, dtype=jnp.int32)
    gidx = window_lo[:, None] + offs[None, :]  # [W, Pmax]
    valid = gidx < window_hi[:, None]
    gidx_c = jnp.minimum(gidx, num_pieces - 1)

    rot_rates = piece_rot[gidx_c] * valid[..., None]
    accelerations = piece_acc[gidx_c] * valid[..., None]
    dt_sec = piece_dt[gidx_c] * valid
    segment_ids = jnp.where(
        valid, piece_gps_end[gidx_c] - window_start[:, None], 0
    ).astype(jnp.int32)
    event_ids = piece_event[gidx_c].astype(jnp.int32)
    # Last piece of its IMU event within the window.
    event_last = valid & (
        piece_next_differs[gidx_c] | (gidx == window_hi[:, None] - 1)
    )
    out_weights = event_last.astype(dtype)

    bofs = jnp.arange(batch_size, dtype=jnp.int32)
    widx = window_start[:, None] + bofs[None, :]
    wvalid = widx < jnp.minimum(window_start[:, None] + batch_size, num_gps)
    gps_speeds_w = jnp.where(
        wvalid, gps_speeds[jnp.minimum(widx, num_gps - 1)], 0.0
    )

    sol = solve_windows(
        rot_rates,
        accelerations,
        dt_sec,
        segment_ids,
        gps_speeds_w,
        batch_size,
        num_iters=num_iters,
        dtype=dtype,
    )

    def replay(p, rot, acc, dt):
        integ = integrate_motion(rot, acc, dt, p[0:3], p[3:6], p[6:9])
        return integ.orientations, integ.velocities

    orient, vel = jax.vmap(replay)(sol.x, rot_rates, accelerations, dt_sec)
    speeds = jnp.linalg.norm(vel, axis=-1)  # [W, P]

    # Cross-window per-event speed averaging (fit_motion.cc:216-221, 259-269):
    # each window contributes each covered event's final-piece speed.
    flat_ids = event_ids.reshape(-1)
    flat_w = out_weights.reshape(-1)
    ev_sum = jax.ops.segment_sum(speeds.reshape(-1) * flat_w, flat_ids, num_events)
    ev_count = jax.ops.segment_sum(flat_w, flat_ids, num_events)

    # Forward-axis accumulation (fit_motion.cc:222-245): windows gated by
    # overall rotation (min |q.w| over the window's event orientations),
    # events gated by speed; velocities rotated into the device frame.
    abs_w = jnp.where(out_weights > 0, jnp.abs(orient[..., 0]), jnp.inf)
    min_cos = jnp.clip(jnp.min(abs_w, axis=1), -1.0, 1.0)  # [W]
    window_gate = jnp.arccos(min_cos) >= min_rotation_rad
    ev_gate = out_weights * (speeds >= min_velocity) * window_gate[:, None]
    v_local = quat_rotate(quat_conjugate(orient), vel)  # [W, P, 3]
    forward_total = jnp.sum(v_local * ev_gate[..., None], axis=(0, 1))  # [3]

    return sol, ev_sum, ev_count, forward_total


def build_window_index(ride, gps_times_usec, batch_size: int, shift_step: int):
    """Sliding GPS windows -> contiguous piece slices (fit_motion.cc:179-186).

    Returns (lo, hi, starts, pmax): per-window first/one-past-last global
    piece index, first GPS index, and the padded per-window piece budget
    (rounded up to a multiple of 8 for clean device tiling).
    """
    gps_times = np.asarray(gps_times_usec, np.int64)
    num_gps = gps_times.shape[0]
    starts = np.arange(0, num_gps, shift_step, dtype=np.int64)
    ends = np.minimum(starts + batch_size, num_gps)
    lo = np.searchsorted(ride.piece_end_usec, gps_times[starts], side="right")
    hi = np.searchsorted(ride.piece_end_usec, gps_times[ends - 1], side="right")
    hi = np.maximum(hi, lo)
    pmax = int(np.max(hi - lo)) if starts.size else 1
    pmax = max(-(-pmax // 8) * 8, 8)
    return lo, hi, starts, pmax


def fit_motion_arrays(
    rot_times_usec,
    rot_rates,
    acc_times_usec,
    accelerations,
    gps_times_usec,
    gps_speeds,
    config: FitMotionConfig = FitMotionConfig(),
    timer=None,
) -> FitMotionResult:
    """Run the full pipeline on in-memory arrays.

    Pass a utils.profiling.StageTimer to get per-stage wall times.
    """
    from pilotguru.utils.profiling import StageTimer

    timer = timer or StageTimer("fit_motion")
    dtype = config.dtype
    with timer.stage("rotation_axis_pca"):
        axes, _ = principal_rotation_axes(
            rot_times_usec,
            rot_rates,
            config.principal_rotation_axis_integration_interval_usec,
            dtype=dtype,
        )
        vertical = axes[0]
        steering = angular_velocities_around_axis(
            jnp.asarray(rot_rates, dtype), vertical
        )

    with timer.stage("host_preprocess"):
        ride = build_ride_pieces(
            rot_times_usec, rot_rates, acc_times_usec, accelerations, gps_times_usec
        )
        num_gps = np.asarray(gps_times_usec).shape[0]
        lo, hi, starts, pmax = build_window_index(
            ride,
            gps_times_usec,
            config.locations_batch_size,
            config.locations_shift_step,
        )

    with timer.stage("solve_and_reduce"):
        sol, ev_sum, ev_count, forward_total = _solve_and_reduce(
            jnp.asarray(ride.piece_rot_rates, dtype),
            jnp.asarray(ride.piece_accelerations, dtype),
            jnp.asarray(ride.piece_dt_sec, dtype),
            jnp.asarray(ride.piece_gps_end_index, jnp.int32),
            jnp.asarray(ride.piece_event_index, jnp.int32),
            jnp.asarray(ride.piece_next_event_differs),
            jnp.asarray(gps_speeds, dtype),
            jnp.asarray(lo, jnp.int32),
            jnp.asarray(hi, jnp.int32),
            jnp.asarray(starts, jnp.int32),
            jnp.int32(num_gps),
            max_pieces=pmax,
            batch_size=config.locations_batch_size,
            num_events=ride.num_events,
            num_iters=config.optimization_iters,
            min_velocity=float(config.forward_axis_inference_min_velocity_m_s),
            min_rotation_rad=float(config.forward_axis_inference_min_rotation_rad),
        )
        ev_sum = np.asarray(ev_sum)
        ev_count = np.asarray(ev_count)

    with timer.stage("smooth_and_assemble"):
        result = assemble_result(
            ride,
            rot_times_usec,
            vertical,
            steering,
            np.asarray(sol.x, np.float64),
            np.asarray(sol.loss, np.float64),
            ev_sum,
            ev_count,
            np.asarray(forward_total, np.float64),
            config,
        )
    return result


def assemble_result(
    ride,
    rot_times_usec,
    vertical,
    steering,
    window_params,  # [W, 9] float64
    window_loss,  # [W] float64
    ev_sum,  # [E] per-event speed sums (host numpy)
    ev_count,  # [E]
    forward_total,  # [3]
    config: FitMotionConfig,
    event_bucket: int = None,
) -> FitMotionResult:
    """Host post-processing shared by single-ride and corpus paths: covered-
    event averaging, Gaussian post-smoothing (fit_motion.cc:259-273), and
    forward-axis orthogonalization + normalization (fit_motion.cc:281-283).

    ``event_bucket`` shape-buckets the smoothing program (corpus path)."""
    covered = ev_count > 0
    avg_speeds = ev_sum[covered] / ev_count[covered]
    out_times = ride.event_times_usec[covered]

    if out_times.size:
        t_sec = (out_times - out_times[0]).astype(np.float64) * 1e-6
        smoothed = np.asarray(
            smooth_time_series(
                avg_speeds, t_sec, t_sec, config.post_smoothing_sigma_sec,
                dtype=config.dtype,
                sample_bucket=event_bucket,
                target_bucket=event_bucket,
            )
        )
    else:
        smoothed = avg_speeds

    forward = np.asarray(forward_total, np.float64)
    vert = np.asarray(vertical, np.float64)
    forward = forward - vert * float(vert @ forward)
    forward = forward / (np.linalg.norm(forward) + 1e-5)

    return FitMotionResult(
        vertical_axis=vert,
        steering_times_usec=np.asarray(rot_times_usec, np.int64),
        steering_angular_velocities=np.asarray(steering, np.float64),
        velocity_times_usec=out_times,
        velocities_m_s=smoothed,
        forward_axis=forward,
        window_params=window_params,
        window_final_loss=window_loss,
    )


def window_loss_fn(problem: WindowedProblem, window: int, dtype=jnp.float64):
    """Reference-normalized loss for one window, for oracle parity tests."""

    def loss(params):
        r = window_residuals(
            jnp.asarray(params, dtype),
            jnp.asarray(problem.rot_rates[window], dtype),
            jnp.asarray(problem.accelerations[window], dtype),
            jnp.asarray(problem.dt_sec[window], dtype),
            jnp.asarray(problem.segment_ids[window]),
            jnp.asarray(problem.gps_speeds[window], dtype),
            problem.num_segments,
        )
        total_time = jnp.sum(jnp.asarray(problem.dt_sec[window], dtype))
        return jnp.sum(r * r) / total_time

    return loss
