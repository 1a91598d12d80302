"""Closest point on mesh and ray casting, numpy-vectorized with KD-tree
candidate pruning.

A copy of `etch_tpu/data/proximity.py` (the replacement for
trimesh.proximity.closest_point, reference GT_dataloader.py:110, and the
embree ray casting of the offline GT generator,
scripts/generate_infopoints.py:117-174).  The port's own C++ BVH
(`etch_tpu_torch.native`) is used when it builds, by the JAX package's rule;
the numpy KD-tree path is the fallback.  Each query object says which one it
runs (`backend`: "native" or "kdtree"), and `last_backend` holds the one
that answered the latest query.
"""

from __future__ import annotations

from typing import Tuple
import warnings

import numpy as np
from scipy.spatial import cKDTree

from etch_tpu_torch.data.mesh import TriMesh

_warned_raycast_fallback = False
# the backend that answered the latest closest-point or ray query
last_backend = None


def _warn_raycast_fallback() -> None:
    """One-time loud warning when ray casting degrades to the approximate
    numpy path (candidate set = k nearest face centroids — exact only when
    the mesh is locally dense).  GT generated through the fallback could
    silently differ from the native exact-BVH output otherwise; mirrors
    the JAX package's warning."""
    global _warned_raycast_fallback
    if _warned_raycast_fallback:
        return
    _warned_raycast_fallback = True
    warnings.warn(
        "etch_tpu_torch: native C++ BVH unavailable; MeshRayCaster is using "
        "the APPROXIMATE numpy fallback (KD-tree candidate pruning). Ray-cast "
        "GT generated this way may differ from the exact BVH path. Build "
        "etch_tpu_torch/native (see its __init__.py, g++) for exact results.",
        RuntimeWarning,
        stacklevel=3,
    )


def _closest_point_on_triangles(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """p: (Q, 3); tri: (Q, T, 3, 3) candidate triangles per query.
    Returns closest points (Q, T, 3).  Ericson's real-time collision
    detection algorithm, vectorized."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    p = p[:, None, :]
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = np.einsum("...i,...i->...", ab, ap)
    d2 = np.einsum("...i,...i->...", ac, ap)
    bp = p - b
    d3 = np.einsum("...i,...i->...", ab, bp)
    d4 = np.einsum("...i,...i->...", ac, bp)
    cp = p - c
    d5 = np.einsum("...i,...i->...", ab, cp)
    d6 = np.einsum("...i,...i->...", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_uv = vb + vc + va
    # region tests (each produces candidate point + condition)
    out = np.empty(np.broadcast_shapes(a.shape, p.shape), np.float64)

    # default: interior
    denom = np.where(np.abs(denom_uv) < 1e-30, 1.0, denom_uv)
    v = vb / denom
    w = vc / denom
    out[:] = a + v[..., None] * ab + w[..., None] * ac

    # edge AC
    w_ac = d2 / np.where(np.abs(d2 - d6) < 1e-30, 1.0, d2 - d6)
    cond_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = np.where(cond_ac[..., None], a + w_ac[..., None] * ac, out)

    # edge BC
    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = (d4 - d3) / np.where(np.abs(denom_bc) < 1e-30, 1.0, denom_bc)
    cond_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    out = np.where(cond_bc[..., None], b + w_bc[..., None] * (c - b), out)

    # edge AB
    v_ab = d1 / np.where(np.abs(d1 - d3) < 1e-30, 1.0, d1 - d3)
    cond_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = np.where(cond_ab[..., None], a + v_ab[..., None] * ab, out)

    # vertex regions (checked last: they dominate)
    cond_a = (d1 <= 0) & (d2 <= 0)
    out = np.where(cond_a[..., None], np.broadcast_to(a, out.shape), out)
    cond_b = (d3 >= 0) & (d4 <= d3)
    out = np.where(cond_b[..., None], np.broadcast_to(b, out.shape), out)
    cond_c = (d6 >= 0) & (d5 <= d6)
    out = np.where(cond_c[..., None], np.broadcast_to(c, out.shape), out)
    return out


def _try_native_bvh(mesh: TriMesh):
    try:
        from etch_tpu_torch import native

        if native.available():
            return native.NativeBVH(mesh.vertices, mesh.faces)
    except Exception:
        pass
    return None


class MeshProximity:
    """Closest-point queries against one mesh.

    Uses the native C++ BVH (etch_tpu_torch.native) when buildable — exact
    over all faces — with a KD-tree-pruned numpy fallback."""

    def __init__(self, mesh: TriMesh, n_candidates: int = 16, use_native: bool = True):
        self.mesh = mesh
        self._bvh = _try_native_bvh(mesh) if use_native else None
        self.tri = mesh.vertices[mesh.faces]           # (F, 3, 3)
        self.centroids = self.tri.mean(axis=1)
        self.tree = None if self._bvh is not None else cKDTree(self.centroids)
        self.n_candidates = min(n_candidates, len(mesh.faces))
        self.backend = "kdtree" if self._bvh is None else "native"

    def closest_point(self, points: np.ndarray):
        """(Q, 3) -> (closest (Q, 3), distance (Q,), face_index (Q,))."""
        global last_backend
        last_backend = self.backend
        q = np.asarray(points, np.float64)
        if self._bvh is not None:
            return self._bvh.closest_point(q)
        _, cand = self.tree.query(q, k=self.n_candidates)
        if cand.ndim == 1:
            cand = cand[:, None]
        tris = self.tri[cand]                           # (Q, T, 3, 3)
        cp = _closest_point_on_triangles(q, tris)       # (Q, T, 3)
        d2 = np.sum((cp - q[:, None]) ** 2, axis=-1)
        best = np.argmin(d2, axis=1)
        rows = np.arange(len(q))
        return (
            cp[rows, best],
            np.sqrt(d2[rows, best]),
            cand[rows, best],
        )


def ray_triangle_intersect(
    origins: np.ndarray,
    directions: np.ndarray,
    tri: np.ndarray,
    eps: float = 1e-12,
):
    """Möller–Trumbore, vectorized: origins (Q,3) x dirs (Q,3) x tri (Q,T,3,3)
    -> (t (Q,T), hit (Q,T)).  t is the ray parameter (inf when no hit,
    t > eps enforced: forward hits only)."""
    a = tri[..., 0, :]
    e1 = tri[..., 1, :] - a
    e2 = tri[..., 2, :] - a
    d = directions[:, None, :]
    o = origins[:, None, :]
    pvec = np.cross(d, e2)
    det = np.einsum("...i,...i->...", e1, pvec)
    ok = np.abs(det) > eps
    inv = 1.0 / np.where(ok, det, 1.0)
    tvec = o - a
    u = np.einsum("...i,...i->...", tvec, pvec) * inv
    qvec = np.cross(tvec, e1)
    v = np.einsum("...i,...i->...", d, qvec) * inv
    t = np.einsum("...i,...i->...", e2, qvec) * inv
    hit = ok & (u >= -1e-9) & (v >= -1e-9) & (u + v <= 1 + 1e-9) & (t > 1e-9)
    return np.where(hit, t, np.inf), hit


class MeshRayCaster:
    """Brute-force-over-candidates ray caster: KD-tree gathers faces near the
    ray segment (good enough for the short rays of the GT generator, which are
    capped at 0.16 m — generate_infopoints.py:127-174)."""

    def __init__(self, mesh: TriMesh, max_dist: float = 0.5, use_native: bool = True):
        self.mesh = mesh
        self._bvh = _try_native_bvh(mesh) if use_native else None
        if use_native and self._bvh is None:
            # requested the exact path but the native library is missing:
            # warn loudly (opting out via use_native=False stays silent)
            _warn_raycast_fallback()
        self.tri = mesh.vertices[mesh.faces]
        self.centroids = self.tri.mean(axis=1)
        self.tree = None if self._bvh is not None else cKDTree(self.centroids)
        self.backend = "kdtree" if self._bvh is None else "native"
        self.max_dist = max_dist
        # conservative search radius: face circumradius upper bound
        edge = np.linalg.norm(
            self.tri - np.roll(self.tri, 1, axis=1), axis=2
        ).max()
        self.face_radius = edge

    def cast(self, origins: np.ndarray, directions: np.ndarray, k: int = 256):
        """First-hit query.  Returns (t (Q,), face (Q,), hit (Q,)).

        Candidates = k nearest faces to the midpoint of the capped segment;
        exact for hits within max_dist when the mesh is locally dense.
        """
        global last_backend
        last_backend = self.backend
        q = np.asarray(origins, np.float64)
        d = np.asarray(directions, np.float64)
        d = d / np.clip(np.linalg.norm(d, axis=1, keepdims=True), 1e-20, None)
        if self._bvh is not None:
            return self._bvh.raycast(q, d, self.max_dist)
        mid = q + d * (self.max_dist / 2.0)
        k = min(k, len(self.centroids))
        _, cand = self.tree.query(mid, k=k)
        if cand.ndim == 1:
            cand = cand[:, None]
        # also include faces near the origin (hits close to the start)
        _, cand2 = self.tree.query(q, k=k)
        if cand2.ndim == 1:
            cand2 = cand2[:, None]
        cand = np.concatenate([cand, cand2], axis=1)
        tris = self.tri[cand]
        t, hit = ray_triangle_intersect(q, d, tris)
        t = np.where(t <= self.max_dist, t, np.inf)
        best = np.argmin(t, axis=1)
        rows = np.arange(len(q))
        t_best = t[rows, best]
        return (
            t_best,
            cand[rows, best],
            np.isfinite(t_best),
        )
