"""Naive dead-reckoning diagnostic: raw IMU integration with endpoint debias.

Reference: /root/reference/src/integrate_motion.cc:57-110. Integrates the
merged rotation+acceleration streams with no calibration (zero biases, zero
initial velocity), then removes the constant acceleration bias implied by
assuming the ride starts and ends at rest.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pilotguru.geometry.strapdown import integrate_motion
from pilotguru.timeseries.merge import merge_time_series


def integrate_motion_debiased(
    rot_times_usec,
    rot_rates,
    acc_times_usec,
    accelerations,
    dtype=jnp.float64,
):
    """Returns (event_times_usec[1:], speeds_m_s[1:]) like integrate_motion.

    Events 1..E-1 of the merged series each get the norm of the debiased
    integrated velocity (integrate_motion.cc:104-121).
    """
    event_times, event_idx = merge_time_series([rot_times_usec, acc_times_usec])
    if event_times.size < 2:
        raise ValueError("need at least 2 merged IMU events")
    rates = np.asarray(rot_rates, np.float64)[event_idx[1:, 0]]
    accs = np.asarray(accelerations, np.float64)[event_idx[1:, 1]]
    dts = np.diff(event_times).astype(np.float64) * 1e-6

    integ = integrate_motion(
        jnp.asarray(rates, dtype),
        jnp.asarray(accs, dtype),
        jnp.asarray(dts, dtype),
        jnp.zeros(3, dtype),
        jnp.zeros(3, dtype),
        jnp.zeros(3, dtype),
    )
    velocities = integ.velocities  # [E-1, 3], v at events 1..E-1

    # Assume v(start) = v(end) = 0: remove the implied constant-acceleration
    # drift proportionally to elapsed time (integrate_motion.cc:91-110).
    total_sec = (event_times[-1] - event_times[0]) * 1e-6
    bias = velocities[-1] / jnp.asarray(total_sec, dtype)
    elapsed = jnp.asarray(
        (event_times[1:] - event_times[0]) * 1e-6, dtype
    )
    debiased = velocities - bias[None, :] * elapsed[:, None]
    speeds = jnp.linalg.norm(debiased, axis=-1)
    return event_times[1:], np.asarray(speeds, np.float64)
