"""Principal rotation axis (vehicle vertical) and axis-projected steering.

Reference: /root/reference/src/calibration/rotation.cc. The gyro stream is
integrated into >= 0.5 s quaternion chunks; PCA over the chunk (x, y, z)
components yields the dominant rotation axis, assumed vertical because
steering rotations dominate (fit_motion.cc:6-14). Projecting raw angular
velocities onto that axis gives the steering angular-velocity signal.

Fixed shapes: chunk boundaries are a greedy host-side computation; the chunk
quaternion products run as one padded associative scan [C, Lmax, 4]; the
3x3 PCA is a closed-form eigendecomposition.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pilotguru.geometry.quaternion import quat_multiply, rotation_rate_to_quat


def chunk_boundaries(times_usec: np.ndarray, interval_usec: int) -> np.ndarray:
    """Greedy chunking: accumulate step durations, emit when >= interval.

    Matches the accumulate-and-reset loop at rotation.cc:22-45: steps are
    (t[i-1], t[i]] for i >= 1; a chunk closes at the first step where the
    accumulated duration reaches ``interval_usec``.

    Returns chunk end indices (inclusive, into ``times_usec``); steps after
    the last emitted chunk are dropped, like the reference.
    """
    times = np.asarray(times_usec, np.int64)
    ends = []
    start = 0  # chunk accumulates steps (start, start+1], ..., (i-1, i]
    n = times.shape[0]
    while True:
        # First i > start with times[i] - times[start] >= interval.
        i = int(np.searchsorted(times, times[start] + interval_usec, side="left"))
        if i >= n:
            break
        ends.append(i)
        start = i
    return np.asarray(ends, np.int64)


def _round_up(n: int, multiple: int) -> int:
    return max(-(-n // multiple) * multiple, multiple)


def integrate_rotation_chunks(
    times_usec: np.ndarray,
    rot_rates: np.ndarray,
    interval_usec: int,
    dtype=jnp.float64,
    chunk_bucket: int | None = None,
    step_bucket: int | None = None,
    return_mask: bool = False,
):
    """Per-chunk integrated quaternions, [C, 4] (or (quats, mask)).

    Each chunk's quaternion is the ordered product of per-step delta
    quaternions (rotation.cc:32-36), computed as a padded associative scan.

    ``chunk_bucket`` / ``step_bucket`` round the device shapes up so rides
    of similar length reuse one compiled scan (the corpus path): padded
    steps AND padded chunks integrate to exact identity quaternions, and
    ``return_mask=True`` yields the real-chunk mask for weighted downstream
    statistics.
    """
    times = np.asarray(times_usec, np.int64)
    rates = np.asarray(rot_rates, np.float64)
    ends = chunk_boundaries(times, int(interval_usec))
    if ends.size < 3:
        raise ValueError(
            "need at least 3 rotation chunks for PCA "
            f"(got {ends.size}); ride too short for axis inference"
        )
    starts = np.concatenate([[0], ends[:-1]])
    num_chunks = int(ends.size)
    lmax = int(np.max(ends - starts))
    if step_bucket:
        lmax = _round_up(lmax, step_bucket)
    if chunk_bucket:
        c_pad = _round_up(num_chunks, chunk_bucket)
        # Fake chunks: start == end == 0 -> no valid steps -> identity.
        starts = np.concatenate([starts, np.zeros(c_pad - num_chunks, np.int64)])
        ends = np.concatenate([ends, np.zeros(c_pad - num_chunks, np.int64)])

    # Gather per-chunk padded steps: step j of chunk c is (idx-1, idx] with
    # idx = starts[c] + 1 + j, valid while idx <= ends[c].
    offs = np.arange(lmax, dtype=np.int64)[None, :]
    idx = starts[:, None] + 1 + offs  # [C, L]
    valid = idx <= ends[:, None]
    idx_c = np.minimum(idx, times.shape[0] - 1)
    step_rates = np.where(valid[..., None], rates[idx_c], 0.0)
    step_dt = np.where(valid, (times[idx_c] - times[idx_c - 1]) * 1e-6, 0.0)

    quats = _chunk_quats(
        jnp.asarray(step_rates, dtype), jnp.asarray(step_dt, dtype)
    )  # [C, 4]
    if not return_mask:
        return quats
    mask = np.zeros(quats.shape[0], bool)
    mask[:num_chunks] = True
    return quats, jnp.asarray(mask)


@jax.jit
def _chunk_quats(step_rates, step_dt):
    """Ordered per-chunk quaternion products as one device program.

    Padded steps give the identity quaternion, so only the final scan
    element per chunk matters.
    """
    dqs = rotation_rate_to_quat(step_rates, step_dt)  # [C, L, 4]
    chain = jax.vmap(
        lambda q: jax.lax.associative_scan(quat_multiply, q, axis=0)
    )(dqs)
    return chain[:, -1, :]


def principal_rotation_axes(
    times_usec: np.ndarray,
    rot_rates: np.ndarray,
    interval_usec: int = 500_000,
    dtype=jnp.float64,
    chunk_bucket: int | None = None,
    step_bucket: int | None = None,
):
    """PCA eigenvectors (rows, descending eigenvalue) of chunk quat (x,y,z).

    Matches GetPrincipalRotationAxes (rotation.cc:16-57). Eigenvector sign
    is inherently arbitrary (cv::PCA makes no promise either); we fix the
    convention that each axis's largest-|magnitude| component is positive,
    so outputs are deterministic. Row 0 is the inferred vertical axis.

    With ``chunk_bucket``/``step_bucket`` the mean/covariance become
    mask-weighted so bucket padding is exactly neutral (fake chunks carry
    weight 0), and the expensive quaternion scan compiles once per bucket
    signature instead of once per ride length.
    """
    quats, mask = integrate_rotation_chunks(
        times_usec,
        rot_rates,
        interval_usec,
        dtype,
        chunk_bucket=chunk_bucket,
        step_bucket=step_bucket,
        return_mask=True,
    )
    return _masked_pca(quats, mask)


@jax.jit
def _masked_pca(quats, mask):
    xyz = quats[:, 1:4]
    w = mask.astype(xyz.dtype)[:, None]
    mean = jnp.sum(xyz * w, axis=0, keepdims=True) / jnp.sum(w)
    centered = (xyz - mean) * w
    cov = centered.T @ centered
    eigvals, eigvecs = jnp.linalg.eigh(cov)  # ascending
    axes = eigvecs[:, ::-1].T  # rows, descending eigenvalue
    # Deterministic sign: largest-|component| positive per axis.
    dominant = jnp.take_along_axis(
        axes, jnp.argmax(jnp.abs(axes), axis=1)[:, None], axis=1
    )
    axes = axes * jnp.sign(dominant)
    return axes, eigvals[::-1]


@jax.jit
def angular_velocities_around_axis(rot_rates, axis):
    """Project raw gyro rates onto a (near-unit) axis.

    Matches GetAngularVelocitiesAroundAxisDirect (rotation.cc:103-119):
    result_i = <rate_i, axis> / ||axis||.
    """
    axis = jnp.asarray(axis)
    norm = jnp.linalg.norm(axis)
    return jnp.asarray(rot_rates) @ (axis / norm)


def rotations_complementary_to_axis(rot_rates, axis):
    """Remove the axis-aligned component of each angular velocity.

    Matches GetRotationsComplementaryToAxisDirect (rotation.cc:121-146).
    """
    axis = jnp.asarray(axis)
    rates = jnp.asarray(rot_rates)
    norm = jnp.linalg.norm(axis)
    along = (rates @ axis)[:, None] * axis[None, :] / (norm * norm)
    return rates - along
