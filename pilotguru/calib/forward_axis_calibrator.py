"""Fixed-forward-axis IMU calibration: (9 + N)-parameter joint solve.

Reference: FixedForwardAxisCalibrator
(/root/reference/src/calibration/velocity.cc:258-494). Parameters are the
two acceleration biases, a device-frame forward-axis vector, and one scalar
velocity per merged IMU event; the loss has three terms:

  1. travel-distance: per GPS interval,
       (|| sum_p dt_p * s_{e(p)} * R_pre_p @ axis || - d_gps)^2
  2. acceleration-match: per piece,
       || (s_{e(p)+1} R_post_p - s_{e(p)} R_pre_p) @ axis
          - dt_p (b_g + R_pre_p @ (b_l + a_p)) ||^2
  3. axis-magnitude penalty: 5e-3 * (||axis|| - 1)^2

The reference evaluates this with hand-derived gradients inside L-BFGS; here
the whole objective is a fused jnp program (orientation chain via
associative scan, per-interval reductions via segment sums) with autodiff,
solved by damped Gauss-Newton on the stacked residual vector for rides
where the dense normal system fits, and by gradient descent otherwise.
After the solve, velocities are normalized by the axis magnitude
(NormalizeVelocities, velocity.cc:472-483).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.calib.pieces import RidePieces, build_ride_pieces
from pilotguru.geometry.quaternion import (
    quat_cumulative_product,
    quat_to_rotation_matrix,
    rotation_rate_to_quat,
)
from pilotguru.solvers.levenberg_marquardt import levenberg_marquardt

AXIS_MAGNITUDE_WEIGHT = 5e-3


@dataclass
class FixedForwardAxisResult:
    acceleration_global_bias: np.ndarray  # [3]
    acceleration_local_bias: np.ndarray  # [3]
    forward_axis: np.ndarray  # [3] unit
    velocities: np.ndarray  # [E] scalar velocities per merged IMU event
    event_times_usec: np.ndarray  # [E]
    final_loss: float


def _piece_arrays(ride: RidePieces, gps_speeds, dtype):
    dq = rotation_rate_to_quat(
        jnp.asarray(ride.piece_rot_rates, dtype),
        jnp.asarray(ride.piece_dt_sec, dtype),
    )
    q_post = quat_cumulative_product(dq)  # orientation after each piece
    identity = jnp.asarray([1.0, 0.0, 0.0, 0.0], dtype)
    q_pre = jnp.concatenate([identity[None, :], q_post[:-1]], axis=0)
    return {
        "r_pre": quat_to_rotation_matrix(q_pre),  # [P, 3, 3]
        "r_post": quat_to_rotation_matrix(q_post),
        "dt": jnp.asarray(ride.piece_dt_sec, dtype),
        "acc": jnp.asarray(ride.piece_accelerations, dtype),
        "ref": jnp.asarray(ride.piece_gps_end_index),
        "event": jnp.asarray(ride.piece_event_index),
        "gps_speed": jnp.asarray(gps_speeds, dtype),
    }


def residuals(params, arrays, num_events: int, num_gps: int):
    """Stacked residual vector [G + 3P + 1]."""
    g_bias = params[0:3]
    l_bias = params[3:6]
    axis = params[6:9]
    velocities = params[9:]

    r_pre, r_post = arrays["r_pre"], arrays["r_post"]
    dt, acc = arrays["dt"], arrays["acc"]
    event = arrays["event"]

    s_now = velocities[event]  # [P]
    s_next = velocities[jnp.clip(event + 1, 0, num_events - 1)]

    axis_pre = jnp.einsum("pij,j->pi", r_pre, axis)  # [P, 3]
    axis_post = jnp.einsum("pij,j->pi", r_post, axis)

    # 1. Travel distance per GPS interval.
    weighted = dt[:, None] * s_now[:, None] * axis_pre
    travel = jax.ops.segment_sum(weighted, arrays["ref"], num_gps)  # [G, 3]
    ref_dist = jax.ops.segment_sum(
        dt * arrays["gps_speed"][arrays["ref"]], arrays["ref"], num_gps
    )
    travel_norm = jnp.sqrt(jnp.sum(travel * travel, axis=-1) + 1e-30)
    r_travel = travel_norm - ref_dist  # [G]

    # 2. Acceleration match per piece.
    delta_v_axis = s_next[:, None] * axis_post - s_now[:, None] * axis_pre
    imu_delta_v = dt[:, None] * (
        g_bias[None, :] + jnp.einsum("pij,pj->pi", r_pre, acc + l_bias[None, :])
    )
    r_accel = (delta_v_axis - imu_delta_v).ravel()  # [3P]

    # 3. Axis magnitude penalty.
    r_axis = jnp.sqrt(jnp.asarray(AXIS_MAGNITUDE_WEIGHT, params.dtype)) * (
        jnp.linalg.norm(axis) - 1.0
    )
    return jnp.concatenate([r_travel, r_accel, r_axis[None]])


def loss(params, arrays, num_events: int, num_gps: int):
    """Scalar objective matching the reference's three-term sum
    (velocity.cc:291-470)."""
    r = residuals(params, arrays, num_events, num_gps)
    return jnp.sum(r * r)


def initial_state(ride: RidePieces, gps_speeds, num_gps: int, dtype):
    """Physically-motivated start: gravity estimate for the global bias,
    unit x forward axis, per-interval GPS speeds for the velocities
    (the per-event analog of InitToAverages, interpolate_velocity.cc:79-89).
    """
    arrays = _piece_arrays(ride, gps_speeds, dtype)
    total = jnp.sum(arrays["dt"]) + 1e-30
    mean_rotated_acc = (
        jnp.sum(
            arrays["dt"][:, None]
            * jnp.einsum("pij,pj->pi", arrays["r_pre"], arrays["acc"]),
            axis=0,
        )
        / total
    )
    velocities = np.zeros(ride.num_events)
    np.maximum.at(
        velocities,
        ride.piece_event_index,
        np.asarray(gps_speeds)[ride.piece_gps_end_index],
    )
    params = np.concatenate(
        [
            -np.asarray(mean_rotated_acc, np.float64),
            np.zeros(3),
            [1.0, 0.0, 0.0],
            velocities,
        ]
    )
    return jnp.asarray(params, dtype), arrays


def normalize_velocities(params):
    """Scale the axis to unit norm, folding the magnitude into the
    velocities (NormalizeVelocities, velocity.cc:472-483)."""
    params = np.asarray(params, np.float64).copy()
    scale = np.linalg.norm(params[6:9])
    if scale <= 1e-5:
        raise ValueError("degenerate forward axis magnitude")
    params[6:9] /= scale
    params[9:] *= scale
    return params


def calibrate_fixed_forward_axis(
    rot_times_usec,
    rot_rates,
    acc_times_usec,
    accelerations,
    gps_times_usec,
    gps_speeds,
    num_iters: int = 60,
    dtype=jnp.float64,
) -> FixedForwardAxisResult:
    """Whole-ride joint solve. The dense LM normal system is
    (9 + E)^2 — fine for rides up to a few thousand merged events; longer
    rides should run the windowed AccelerometerCalibrator pipeline instead
    (which is also what the reference's fit_motion does)."""
    ride = build_ride_pieces(
        rot_times_usec, rot_rates, acc_times_usec, accelerations, gps_times_usec
    )
    num_gps = int(np.asarray(gps_times_usec).shape[0])
    x0, arrays = initial_state(ride, gps_speeds, num_gps, dtype)

    result = levenberg_marquardt(
        lambda p: residuals(p, arrays, ride.num_events, num_gps),
        x0,
        num_iters=num_iters,
    )
    params = normalize_velocities(result.x)
    return FixedForwardAxisResult(
        acceleration_global_bias=params[0:3],
        acceleration_local_bias=params[3:6],
        forward_axis=params[6:9],
        velocities=params[9:],
        event_times_usec=ride.event_times_usec,
        final_loss=float(result.loss),
    )
