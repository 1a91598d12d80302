"""Point-cloud index operations of the plain reference.

Frozen copies of the plain versions in the port's `ops/` (`fps_torch`,
`knn_torch`, `ball_query_torch`, the gathers and the inverse-distance
interpolation), with the same distance arithmetic, (dx*dx + dy*dy) + dz*dz
by direct difference, and the same tie rules, so the same points give the
same indices.
"""

from __future__ import annotations

import numpy as np
import torch


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, ...), idx (B, M) -> (B, M, ...)."""
    batch = torch.arange(feats.shape[0], device=feats.device)[:, None]
    return feats[batch, idx.long()]


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C...), idx (B, M, K) -> (B, M, K, C...)."""
    batch = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[batch, idx.long()]


def pairwise_sqdist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) x (B, N, 3) -> (B, M, N) squared distances."""
    d = [q[..., None, i] - s[:, None, :, i] for i in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def fps(xyz: torch.Tensor, m: int, lazy: bool = False) -> torch.Tensor:
    """Farthest point sampling from point 0, the smaller index winning ties;
    `lazy` (or m == N) is the arange.  (B, N, 3) -> (B, m) int64."""
    B, N, _ = xyz.shape
    if lazy or m == N:
        return torch.arange(m, device=xyz.device).expand(B, m)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mind = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    idx = torch.zeros((B, m), dtype=torch.int64, device=xyz.device)
    last = idx[:, :1]
    for i in range(1, m):
        dx, dy, dz = x - x.gather(1, last), y - y.gather(1, last), z - z.gather(1, last)
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(mind, dim=1, keepdim=True)
        idx[:, i:i + 1] = last
    return idx


def knn(query: torch.Tensor, support: torch.Tensor, k: int):
    """k nearest supports, ascending, smaller index first on ties: (idx
    (B, M, k) int64, euclidean distances (B, M, k))."""
    k = min(k, support.shape[1])
    idxs, d2s = [], []
    for b in range(query.shape[0]):
        d2 = pairwise_sqdist(query[b:b + 1], support[b:b + 1])
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        idxs.append(idx[..., :k])
        d2s.append(vals[..., :k])
    return torch.cat(idxs), torch.sqrt(torch.clamp(torch.cat(d2s), min=0.0))


def radius_sq(radius: float) -> float:
    r = np.float32(radius)
    return float(r * r)


def ball_query(query: torch.Tensor, support: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first `nsample` supports in index order strictly inside the
    radius, repeated cyclically when fewer; an empty ball gives index 0.
    (B, M, 3), (B, N, 3) -> (B, M, nsample) int64."""
    N = support.shape[1]
    r2 = radius_sq(radius)
    outs = []
    for b in range(query.shape[0]):
        mask = pairwise_sqdist(query[b:b + 1], support[b:b + 1]) < r2
        order = torch.arange(N, device=query.device) + N * (~mask).long()
        first = torch.sort(order, dim=-1).values[..., :nsample] % N
        cnt = mask.sum(-1, keepdim=True).clamp(max=nsample)
        j = torch.arange(nsample, device=query.device)
        src = torch.where(j < cnt, j, j % cnt.clamp(min=1))
        if first.shape[-1] < nsample:
            first = torch.nn.functional.pad(first, (0, nsample - first.shape[-1]))
        out = torch.gather(first, -1, src.expand_as(first))
        outs.append(torch.where(cnt > 0, out, torch.zeros_like(out)))
    return torch.cat(outs)


def knn_interpolate(src_xyz, dst_xyz, src_feat, k: int = 3, use_sqrt: bool = True,
                    idx_dist=None):
    """Inverse-distance weighted k-NN interpolation (B, S, C) -> (B, N, C):
    w ~ 1/(d + 1e-8) with `use_sqrt`, else 1/(d^2 + 1e-8)."""
    idx, dist = knn(dst_xyz, src_xyz, k) if idx_dist is None else idx_dist
    w = 1.0 / (dist + 1e-8) if use_sqrt else 1.0 / (dist * dist + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    out = None
    for j in range(idx.shape[-1]):
        g = gather_points(src_feat, idx[..., j]) * w[..., j:j + 1]
        out = g if out is None else out + g
    return out
