"""GPS-to-frame velocity interpolation as a vectorized penalized objective.

Reference: GPSInterpolationObjective (/root/reference/src/interpolate_velocity.cc:53-214).
Parameters are per-frame-timestamp scalar velocities; the objective is

  sum_g  w_v * (L1|L2 of per-GPS-interval distance mismatch)
  + sum_i w_a * (L1|L2 of finite-difference acceleration)
  + sum_i w_s * (L1|L2 of consecutive acceleration differences)

optimized with clipped gradient descent (gradient_descent.cc semantics,
autodiff gradients). Every term is a fused vectorized expression over the
flat piece arrays, no per-interval loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

import jax

from pilotguru.solvers.gradient_descent import gradient_descent
from pilotguru.timeseries.merge import make_interpolation_pieces


@jax.custom_jvp
def _reference_abs(x):
    """|x| with the reference's subgradient convention d|0| = -1.

    The reference's hand-written gradients use ``x > 0 ? 1 : -1``
    (interpolate_velocity.cc:119,144,175); plain autodiff of abs gives 0 at
    kinks, which changes descent trajectories on data where accelerations
    start exactly equal (the InitToAverages starting point guarantees that).
    """
    return jnp.abs(x)


@_reference_abs.defjvp
def _reference_abs_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    sign = jnp.where(x > 0, 1.0, -1.0).astype(x.dtype)
    return jnp.abs(x), sign * dx


@dataclass(frozen=True)
class InterpolationSettings:
    l1_weight: float = 0.0
    l2_weight: float = 0.0
    distance_weight: float = 1.0
    accelerations_weight: float = 1.0
    accelerations_smoothness_weight: float = 1.0
    learning_rate: float = 1e-1
    learning_rate_decay: float = 1.0
    iters: int = 1000


def interpolate_gps_velocities(
    gps_times_usec,
    gps_speeds,
    frame_times_usec,
    settings: InterpolationSettings = InterpolationSettings(),
    dtype=jnp.float64,
):
    """Returns per-frame interpolated velocities [F] (float64 numpy)."""
    if settings.l1_weight + settings.l2_weight <= 0:
        raise ValueError("l1_weight + l2_weight must be positive")

    gps_times = np.asarray(gps_times_usec, np.int64)
    gps_speeds_np = np.asarray(gps_speeds, np.float64)
    frame_times = np.asarray(frame_times_usec, np.int64)

    pieces = make_interpolation_pieces(gps_times, frame_times)
    piece_dt = jnp.asarray(pieces.duration_sec(), dtype)
    piece_gps = jnp.asarray(pieces.reference_end_index)
    piece_frame = jnp.asarray(pieces.interpolation_end_index)
    num_gps = gps_times.shape[0]
    num_frames = frame_times.shape[0]

    gps_speed_dev = jnp.asarray(gps_speeds_np, dtype)
    frame_dt = jnp.asarray(np.diff(frame_times).astype(np.float64) * 1e-6, dtype)

    l1 = jnp.asarray(settings.l1_weight, dtype)
    l2 = jnp.asarray(settings.l2_weight, dtype)
    w_v = jnp.asarray(settings.distance_weight, dtype)
    w_a = jnp.asarray(settings.accelerations_weight, dtype)
    w_s = jnp.asarray(settings.accelerations_smoothness_weight, dtype)

    def penalty(x, weight):
        return weight * jnp.sum(l1 * _reference_abs(x) + l2 * x * x)

    def loss(v):
        integrated = jax.ops.segment_sum(v[piece_frame] * piece_dt, piece_gps, num_gps)
        durations = jax.ops.segment_sum(piece_dt, piece_gps, num_gps)
        dist_diff = integrated - gps_speed_dev * durations
        accel = (v[1:] - v[:-1]) / frame_dt
        accel_diff = accel[1:] - accel[:-1]
        return penalty(dist_diff, w_v) + penalty(accel, w_a) + penalty(accel_diff, w_s)

    # Init to per-interval GPS averages (interpolate_velocity.cc:79-89):
    # frames covered by a GPS interval start at that interval's speed.
    init = np.zeros(num_frames)
    init[pieces.interpolation_end_index] = gps_speeds_np[pieces.reference_end_index]

    result = gradient_descent(
        loss,
        jnp.asarray(init, dtype),
        num_iters=int(settings.iters),
        learning_rate=settings.learning_rate,
        learning_rate_decay=settings.learning_rate_decay,
        min_gradient_clip=-10.0,
        max_gradient_clip=10.0,
    )
    return np.asarray(result, np.float64)
