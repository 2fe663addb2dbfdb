"""Strapdown IMU integration as parallel scans.

The reference integrates one Euler step at a time (IntegrateMotion,
/root/reference/src/geometry/geometry.cc:24-53):

  a_cal    = a_raw + local_bias                (device frame)
  a_global = R(q_prev) a_cal + global_bias     (fixed frame)
  v        = v_prev + a_global * dt
  q        = q_prev * dq

The orientation chain is an associative product, and given all pre-step
orientations the velocity chain is a plain cumulative sum — so the whole
sequential loop becomes two log-depth scans, which is the accelerator shape
of this computation (no per-step host control flow, everything fuses).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pilotguru.geometry.quaternion import (
    quat_cumulative_product,
    quat_multiply,
    quat_rotate,
    rotation_rate_to_quat,
)


class StrapdownResult(NamedTuple):
    orientations: jnp.ndarray  # [T, 4] post-step orientation q_t
    velocities: jnp.ndarray  # [T, 3] post-step velocity v_t


def integrate_motion(
    rotation_rates,
    accelerations,
    durations_sec,
    acceleration_global_bias,
    acceleration_local_bias,
    initial_velocity,
    initial_orientation=None,
):
    """Integrate a sequence of IMU steps with calibration parameters.

    Args:
      rotation_rates: [T, 3] gyro rates (rad/s) applied over each step.
      accelerations: [T, 3] raw accelerometer samples for each step.
      durations_sec: [T] step durations.
      acceleration_global_bias: [3] fixed-frame bias (~gravity).
      acceleration_local_bias: [3] device-frame bias.
      initial_velocity: [3].
      initial_orientation: [4] quaternion, identity if None.

    Returns StrapdownResult with post-step orientations/velocities, matching
    the sequential loop in AccelerometerCalibrator::IntegrateTrajectory
    (/root/reference/src/calibration/velocity.cc:199-256) up to floating-point
    reassociation of the scans.
    """
    dtype = jnp.result_type(rotation_rates)
    durations_sec = jnp.asarray(durations_sec, dtype=dtype)

    dqs = rotation_rate_to_quat(rotation_rates, durations_sec)  # [T, 4]
    q_post = quat_cumulative_product(dqs)  # [T, 4]
    if initial_orientation is not None:
        q0 = jnp.asarray(initial_orientation, dtype=dtype)
        q_post = quat_multiply(q0[None, :], q_post)
        q_first = q0
    else:
        q_first = jnp.asarray([1.0, 0.0, 0.0, 0.0], dtype=dtype)
    # Pre-step orientation for step t is q_{t-1} (identity/q0 for t=0).
    q_pre = jnp.concatenate([q_first[None, :], q_post[:-1]], axis=0)

    a_cal = accelerations + acceleration_local_bias[None, :]
    a_global = quat_rotate(q_pre, a_cal) + acceleration_global_bias[None, :]
    dv = a_global * durations_sec[:, None]
    velocities = initial_velocity[None, :] + jnp.cumsum(dv, axis=0)
    return StrapdownResult(q_post, velocities)
