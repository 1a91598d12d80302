"""Brute-force k-nearest-neighbours on dense batched clouds.

Port of `etch_tpu/ops/knn.py`.  `knn` dispatches on the device of its
inputs: CUDA tensors launch the hand-written kernel (`csrc/knn.cu`,
replacing `etch_tpu/ops/pallas_knn.py:knn_pallas`), CPU tensors run
`knn_torch`.  Both rank by direct-difference squared distance with the
smaller index first on ties, as the TPU kernel does.
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build

_KNN_MAX_K = 32  # largest register top-k bucket in csrc/knn.cu


def pairwise_sqdist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) x (B, N, 3) -> (B, M, N) squared distances by direct
    difference, (dx*dx + dy*dy) + dz*dz, the kernels' rounding order."""
    d = [q[..., None, i] - s[:, None, :, i] for i in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def knn_torch(query: torch.Tensor, support: torch.Tensor, k: int):
    """Plain version: (B, M, 3), (B, N, 3) -> idx (B, M, k) int32 and the
    squared distances (B, M, k), ascending, smaller index first on ties."""
    idxs, d2s = [], []
    for b in range(query.shape[0]):  # one cloud at a time bounds the (M, N) block
        d2 = pairwise_sqdist(query[b:b + 1], support[b:b + 1])
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        idxs.append(idx[..., :k])
        d2s.append(vals[..., :k])
    return torch.cat(idxs).to(torch.int32), torch.cat(d2s)


def knn_cuda(query: torch.Tensor, support: torch.Tensor, k: int):
    """Kernel launch: returns idx (B, M, k) int32 and squared distances."""
    device = _build.check_cuda("knn", (query, torch.float32),
                               (support, torch.float32))
    B, M, _ = query.shape
    N = support.shape[1]
    if support.shape[0] != B or not 1 <= k <= min(N, _KNN_MAX_K):
        raise ValueError(f"knn: bad shapes {tuple(query.shape)}, "
                         f"{tuple(support.shape)}, k={k}")
    idx = torch.empty((B, M, k), dtype=torch.int32, device=device)
    d2 = torch.empty((B, M, k), dtype=torch.float32, device=device)
    _build.launch("knn", "etch_knn", device, _build.ptr(query),
                  _build.ptr(support), _build.ptr(idx), _build.ptr(d2),
                  B, M, N, k)
    return idx, d2


def knn(query: torch.Tensor, support: torch.Tensor, k: int):
    """k nearest supports for each query point.

    query: (B, M, 3); support: (B, N, 3).  Returns (idx, dist): (B, M, k)
    int32 indices and euclidean distances (sqrt of the exact squared
    distance, as `etch_tpu/ops/knn.py` returns), ascending.
    """
    k = min(k, support.shape[1])
    if query.is_cuda:
        idx, d2 = knn_cuda(query, support, k)
    elif query.device.type == "cpu":
        idx, d2 = knn_torch(query, support, k)
    else:
        raise ValueError(f"knn: unsupported device {query.device}")
    return idx, torch.sqrt(torch.clamp(d2, min=0.0))
