"""Point-cloud augmentation utilities.

Covers the reference's augmentation surface: uniform random rotations (vgtk
`pc/augmentation.py` rand-rotation path and the commented random-rotation
augmentation in GT_dataloader.py:160-170) and the y-axis rotation used by the
mixed loader (GT_dataloader_mixed.py:186-199), numpy only.  A copy of
`etch_tpu/geometry/augment.py`; `tests/test_torch_gt_tools.py` holds it
bit-equal to the original.
"""

from __future__ import annotations

import numpy as np


def rand_rotation_matrix(rng: np.random.Generator | None = None) -> np.ndarray:
    """Uniform random rotation (Arvo's method; same distribution as the
    reference's rand_rotation_matrix, external/vgtk/vgtk/functional/
    rotation.py:66-114)."""
    rng = rng or np.random.default_rng()
    theta, phi, z = rng.random(3)
    theta *= 2.0 * np.pi
    phi *= 2.0 * np.pi
    z *= 2.0
    r = np.sqrt(z)
    V = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    Rz = np.array([[ct, st, 0.0], [-st, ct, 0.0], [0.0, 0.0, 1.0]])
    return (np.outer(V, V) - np.eye(3)) @ Rz


def y_rotation_matrix(angle: float) -> np.ndarray:
    ca, sa = np.cos(angle), np.sin(angle)
    return np.array([[ca, 0.0, sa], [0.0, 1.0, 0.0], [-sa, 0.0, ca]])


def rotate_cloud(
    points: np.ndarray,
    R: np.ndarray,
    center: np.ndarray | None = None,
) -> np.ndarray:
    """Rotate (N, 3) points about `center` (default origin)."""
    if center is None:
        return points @ R.T
    return (points - center) @ R.T + center


def jitter_cloud(
    points: np.ndarray, sigma: float = 0.001, rng=None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return points + sigma * rng.standard_normal(points.shape)
