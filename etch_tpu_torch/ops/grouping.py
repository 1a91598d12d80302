"""Batched gather / grouping ops (port of `etch_tpu/ops/grouping.py`).

Plain tensor indexing.  `materialize_rows`, the TPU layout pin of the JAX
package, has no counterpart here: its contract (neighbour rows read from a
contiguous (B, P, A*C) tensor) is kept by the inter-conv kernel, whose
wrapper refuses a non-contiguous feature tensor (`nn/interconv.py`).
"""

from __future__ import annotations

import torch


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats: (B, N, ...), idx: (B, M) -> (B, M, ...)."""
    B = feats.shape[0]
    batch = torch.arange(B, device=feats.device)[:, None]
    return feats[batch, idx.long()]


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats: (B, N, C...), idx: (B, M, K) -> (B, M, K, C...)."""
    B = feats.shape[0]
    batch = torch.arange(B, device=feats.device)[:, None, None]
    return feats[batch, idx.long()]
