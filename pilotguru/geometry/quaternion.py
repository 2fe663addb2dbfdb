"""Quaternion algebra as jnp array ops, (w, x, y, z) layout.

Replaces the Eigen::Quaterniond usage of the reference
(/root/reference/src/geometry/geometry.cc). All functions broadcast over
leading batch dimensions and are differentiable, so they compose with
vmap/scan/jacfwd in the calibration solvers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2 for (..., 4) arrays in (w,x,y,z) layout."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4).

    Matches Eigen's ``_transformVector`` (used at geometry.cc:40):
    v' = v + 2 w (u x v) + 2 (u x (u x v)) with u the quaternion vector part.
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_rotation_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotation_rate_to_quat(rates, duration_sec):
    """Gyro rate (..., 3) over duration (...,) -> delta quaternion (..., 4).

    Exact port of the exponential map in RotationMotionToQuaternion
    (/root/reference/src/geometry/geometry.cc:6-22), including the 1e-30
    singularity guard; the result is NOT normalized, matching the reference.
    """
    rates = jnp.asarray(rates)
    duration_sec = jnp.asarray(duration_sec, dtype=rates.dtype)
    omega = jnp.linalg.norm(rates, axis=-1)
    half_theta = omega * duration_sec * 0.5
    sin_norm = jnp.sin(half_theta) / (omega + 1e-30)
    return jnp.concatenate(
        [jnp.cos(half_theta)[..., None], rates * sin_norm[..., None]], axis=-1
    )


def quat_cumulative_product(dqs):
    """Running left-to-right quaternion products via associative scan.

    out[t] = dqs[0] * dqs[1] * ... * dqs[t], the log-depth
    replacement for the sequential orientation chain
    ``q_k = q_{k-1} * dq_k`` (reference: velocity.cc:101, rotation.cc:36).
    """
    return jax.lax.associative_scan(quat_multiply, dqs, axis=0)


def quat_normalize(q, eps=0.0):
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / (n + eps)
