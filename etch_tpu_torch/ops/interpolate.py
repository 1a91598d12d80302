"""k-NN inverse-distance-weighted feature interpolation (upsampling).

Port of `etch_tpu/ops/interpolate.py`, with its two weighting conventions:
  - use_sqrt=True:  w ~ 1/(sqrt(d2) + 1e-8)   (reference pointops.interpolation)
  - use_sqrt=False: w ~ 1/(d2 + 1e-8)         (reference PointFeatPropagation)
"""

from __future__ import annotations

import torch

from etch_tpu_torch.ops.grouping import gather_points
from etch_tpu_torch.ops.knn import knn


def knn_interpolate(src_xyz: torch.Tensor, dst_xyz: torch.Tensor,
                    src_feat: torch.Tensor, k: int = 3, use_sqrt: bool = True,
                    idx_dist=None) -> torch.Tensor:
    """src_xyz (B, S, 3), dst_xyz (B, N, 3), src_feat (B, S, C) -> (B, N, C).

    idx_dist: optional precomputed knn(dst_xyz, src_xyz, k) result, shared by
    callers that interpolate several feature sets over one geometry.
    """
    idx, dist = knn(dst_xyz, src_xyz, k) if idx_dist is None else idx_dist
    w = 1.0 / (dist + 1e-8) if use_sqrt else 1.0 / (dist * dist + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    out = None
    for j in range(idx.shape[-1]):  # same summation order as the JAX package
        g = gather_points(src_feat, idx[..., j]) * w[..., j:j + 1]
        out = g if out is None else out + g
    return out
