"""Area-weighted surface sampling (numpy only).

A copy of `etch_tpu/data/sampling.py` (the replacement for
trimesh.sample.sample_surface, reference inference_demo.py:36-39): the same
`numpy.random.default_rng(seed)` draws in the same order, so a seed gives
the points the JAX package samples.  `tests/test_torch_entry.py` holds it
bit-equal to the original.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from etch_tpu_torch.data.mesh import TriMesh


def sample_surface(
    mesh: TriMesh, count: int, seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-by-area surface samples.

    Returns (points (count, 3), face_index (count,)).
    """
    rng = np.random.default_rng(seed)
    areas = mesh.face_areas
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    probs = areas / total
    fidx = rng.choice(len(probs), size=count, p=probs)
    # uniform barycentric coordinates via the square-root trick
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    tri = mesh.vertices[mesh.faces[fidx]]  # (count, 3, 3)
    pts = a[:, None] * tri[:, 0] + b[:, None] * tri[:, 1] + c[:, None] * tri[:, 2]
    return pts, fidx


def sample_barycentric(
    mesh: TriMesh, count: int, seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like sample_surface but also returns barycentric coords (count, 3)
    (reference scripts/generate_infopoints.py:89-99)."""
    rng = np.random.default_rng(seed)
    areas = mesh.face_areas
    probs = areas / areas.sum()
    fidx = rng.choice(len(probs), size=count, p=probs)
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    bary = np.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2], axis=1)
    tri = mesh.vertices[mesh.faces[fidx]]
    pts = np.einsum("nk,nkc->nc", bary, tri)
    return pts, fidx, bary
