"""Radius (ball) query with the reference's repeat-fill semantics.

Port of `etch_tpu/ops/ball_query.py`: for each query take the first
`nsample` support indices, in index order, with squared distance strictly
below radius^2; if fewer are found, repeat them cyclically; an empty ball
yields index 0.  CUDA tensors launch `csrc/knn.cu:ball_query_kernel`
(replacing `etch_tpu/ops/pallas_knn.py:ball_query_pallas`), CPU tensors run
`ball_query_torch`.  Distances are direct-difference, as on the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from etch_tpu_torch import _build
from etch_tpu_torch.ops.knn import pairwise_sqdist


def radius_sq(radius: float) -> float:
    """radius^2 rounded as the JAX package rounds it: f32(radius) squared in
    f32.  The kernel and the plain version both compare against this."""
    r = np.float32(radius)
    return float(r * r)


def ball_query_torch(query: torch.Tensor, support: torch.Tensor, radius: float,
                     nsample: int) -> torch.Tensor:
    """Plain version: (B, M, 3), (B, N, 3) -> (B, M, nsample) int32."""
    N = support.shape[1]
    r2 = radius_sq(radius)
    outs = []
    for b in range(query.shape[0]):
        mask = pairwise_sqdist(query[b:b + 1], support[b:b + 1]) < r2  # (1, M, N)
        # the hits' indices in ascending order first: sort keys index + N*miss
        order = torch.arange(N, device=query.device) + N * (~mask).long()
        first = torch.sort(order, dim=-1).values[..., :nsample] % N
        cnt = mask.sum(-1, keepdim=True).clamp(max=nsample)
        j = torch.arange(nsample, device=query.device)
        src = torch.where(j < cnt, j, j % cnt.clamp(min=1))
        if first.shape[-1] < nsample:  # N < nsample: pad, slots never read
            first = torch.nn.functional.pad(first, (0, nsample - first.shape[-1]))
        out = torch.gather(first, -1, src.expand_as(first))
        outs.append(torch.where(cnt > 0, out, torch.zeros_like(out)))
    return torch.cat(outs).to(torch.int32)


def ball_query_cuda(query: torch.Tensor, support: torch.Tensor, radius: float,
                    nsample: int) -> torch.Tensor:
    device = _build.check_cuda("ball_query", (query, torch.float32),
                               (support, torch.float32))
    B, M, _ = query.shape
    N = support.shape[1]
    if support.shape[0] != B or nsample < 1:
        raise ValueError(f"ball_query: bad shapes {tuple(query.shape)}, "
                         f"{tuple(support.shape)}, nsample={nsample}")
    out = torch.empty((B, M, nsample), dtype=torch.int32, device=device)
    _build.launch("ball_query", "etch_ball_query", device, _build.ptr(query),
                  _build.ptr(support), _build.ptr(out), B, M, N,
                  radius_sq(radius), nsample)
    return out


def ball_query(query: torch.Tensor, support: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """query: (B, M, 3), support: (B, N, 3) -> idx (B, M, nsample) int32."""
    if query.is_cuda:
        return ball_query_cuda(query, support, radius, nsample)
    if query.device.type == "cpu":
        return ball_query_torch(query, support, radius, nsample)
    raise ValueError(f"ball_query: unsupported device {query.device}")
