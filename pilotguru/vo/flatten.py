"""Horizontal-plane flattening of visual-odometry trajectories.

Reference: /root/reference/src/slam/horizontal_flatten.cc and the PCA +
validity test in src/slam/track_image_sequence.cc:16-29, 72-94. All passes
are closed-form vectorized array programs.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from pilotguru.geometry.quaternion import quat_rotate


def trajectory_pca(translations) -> Tuple[np.ndarray, np.ndarray]:
    """PCA of trajectory translations (TrajectoryToPCA).

    Returns (eigenvectors [3,3] rows in descending-eigenvalue order,
    eigenvalues [3]). Sign convention: largest-|component| positive per row
    (cv::PCA leaves signs arbitrary).
    """
    t = np.asarray(translations, np.float64)
    centered = t - t.mean(axis=0, keepdims=True)
    cov = centered.T @ centered / t.shape[0]
    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(eigvals)[::-1]
    axes = eigvecs[:, order].T
    dominant = np.take_along_axis(
        axes, np.argmax(np.abs(axes), axis=1)[:, None], axis=1
    )
    axes = axes * np.sign(dominant)
    return axes, eigvals[order]


def plane_is_valid(eigenvalues, relative_tolerance: float = 1e-2) -> bool:
    """The reference's flatness test (track_image_sequence.cc:85-92):
    reject when the 3rd eigenvalue exceeds 1e-2 x the 2nd."""
    return bool(eigenvalues[2] <= eigenvalues[1] * relative_tolerance)


def project_directions(rotations, plane) -> np.ndarray:
    """Project camera optical-axis directions onto the 2x3 plane.

    Matches ProjectDirections (horizontal_flatten.cc:7-29): the camera
    direction is the pose rotation applied to the +z axis; projection uses
    the plane's eigenvector rows directly (unit directions, no mean shift).
    Returns [N, 2].
    """
    rotations = jnp.asarray(rotations)
    z = jnp.asarray([0.0, 0.0, 1.0], rotations.dtype)
    dirs = quat_rotate(rotations, jnp.broadcast_to(z, rotations[..., :3].shape))
    return np.asarray(dirs @ jnp.asarray(plane, rotations.dtype).T)


def project_translations(translations, plane) -> np.ndarray:
    """Flatten translations into the plane, expressed back in 3D.

    Matches ProjectTranslations (horizontal_flatten.cc:31-42):
    t' = (P t)^T P with P the 2x3 plane matrix.
    """
    t = np.asarray(translations, np.float64)
    p = np.asarray(plane, np.float64)
    return (t @ p.T) @ p


def turn_angles_from_directions(directions) -> np.ndarray:
    """Signed angles between consecutive 2D directions.

    Matches Projected2DDirectionsToTurnAngles (horizontal_flatten.cc:44-64):
    acos of the normalized dot product, sign from the 2D cross product
    (strictly positive cross -> +, else -, including zero).
    Element 0 is 0.
    """
    d = np.asarray(directions, np.float64)
    prev, curr = d[:-1], d[1:]
    dot = np.sum(prev * curr, axis=1)
    norms = np.linalg.norm(prev, axis=1) * np.linalg.norm(curr, axis=1)
    cos = np.clip(dot / norms, -1.0, 1.0)
    cross = prev[:, 0] * curr[:, 1] - prev[:, 1] * curr[:, 0]
    angles = np.arccos(cos) * np.where(cross > 0, 1.0, -1.0)
    return np.concatenate([[0.0], angles])


def flatten_trajectory(trajectory, relative_tolerance: float = 1e-2):
    """PCA plane + validity + directions + turn angles for one trajectory.

    Returns (plane [2,3], directions [N,2], turn_angles [N]) or None when
    the flatness test fails, mirroring TrackImageSequence's post-processing
    (track_image_sequence.cc:72-99).
    """
    axes, eigvals = trajectory_pca(trajectory.translations)
    if not plane_is_valid(eigvals, relative_tolerance):
        return None
    plane = axes[:2]
    directions = project_directions(trajectory.rotations, plane)
    angles = turn_angles_from_directions(directions)
    return plane, directions, angles
