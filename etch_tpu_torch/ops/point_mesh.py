"""Point-to-mesh distance (differentiable).

Port of `etch_tpu/ops/point_mesh.py` (reference
`src/utils/customized_losses.py::my_point_mesh_face_distance`, the optional
point-mesh term of the fitting objective, fit_SMPL.py:103-109): the exact
point-to-triangle distance (Ericson's regions) over k candidate faces per
point, the k faces whose centroids are nearest (`ops/knn.py`: the kNN
kernel on the card, on detached inputs; the indices carry no gradient), so
the cost is O(P k) instead of O(P F).  The distance to the candidates is
plain torch, with autograd to the points and the vertices.
"""

from __future__ import annotations

import torch

from etch_tpu_torch.ops.knn import knn


def _safe_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x / torch.where(y.abs() < 1e-30, torch.ones_like(y), y)


def _point_triangle_dist2(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """p (..., 3), tri (..., 3, 3) -> squared distance (...,)."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = va + vb + vc
    denom = torch.where(denom.abs() < 1e-30, torch.ones_like(denom), denom)
    cp_int = a + (vb / denom)[..., None] * ab + (vc / denom)[..., None] * ac
    cp_ab = a + _safe_div(d1, d1 - d3)[..., None] * ab
    cp_ac = a + _safe_div(d2, d2 - d6)[..., None] * ac
    wbc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    cp_bc = b + wbc[..., None] * (c - b)

    out = cp_int
    out = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], cp_ac, out)
    out = torch.where(((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0))[..., None], cp_bc, out)
    out = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], cp_ab, out)
    out = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    out = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    return ((out - p) ** 2).sum(-1)


def point_mesh_distance(points: torch.Tensor, vertices: torch.Tensor, faces,
                        k: int = 8) -> torch.Tensor:
    """Exact distance from each point (B, P, 3) to the nearest of its k
    candidate faces of the meshes (vertices (B, V, 3), shared faces (F, 3)
    int).  Returns (B, P)."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=vertices.device)
    tri = vertices[:, faces]                                    # (B, F, 3, 3)
    centroids = tri.mean(dim=2)                                 # (B, F, 3)
    idx, _ = knn(points.detach().contiguous(), centroids.detach().contiguous(), k)
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    cand = tri[rows, idx.long()]                                # (B, P, k, 3, 3)
    d2 = _point_triangle_dist2(points[:, :, None, :], cand)
    return torch.sqrt(d2.min(dim=-1).values)
