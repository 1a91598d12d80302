"""Confidence-weighted sparse marker extraction from labelled inner points.

Port of `etch_tpu/fit/markers.py`: per batch item and marker label, take the
top-3 points by confidence among the points predicted with that label,
weight them by (confidence / group max)^20 and average.  A label with no
points is invalid.
"""

from __future__ import annotations

import torch

ALPHA = 20.0  # reference fit_SMPL.py:53


def extract_markers(inner_points: torch.Tensor, part_labels: torch.Tensor,
                    confidences: torch.Tensor, num_markers: int = 86, top_k: int = 3):
    """inner_points (B, K, 3), part_labels (B, K) int, confidences (B, K, 1)
    or (B, K) -> (markers (B, L, 3), valid (B, L) bool)."""
    if confidences.ndim == 3:
        confidences = confidences[..., 0]
    B, K, _ = inner_points.shape
    L = num_markers
    labels = torch.arange(L, device=part_labels.device, dtype=part_labels.dtype)
    onehot = part_labels[:, None, :] == labels[None, :, None]
    neg = torch.finfo(confidences.dtype).min
    s = torch.where(onehot, confidences[:, None, :], torch.full_like(confidences[:, None, :], neg))
    # top-k by iterative argmax; ties resolve to the lowest index, as in JAX
    lanes = torch.arange(K, device=s.device)
    vals, idxs = [], []
    for _ in range(top_k):
        i = torch.argmax(s, dim=-1)                               # (B, L)
        vals.append(torch.gather(s, -1, i[..., None])[..., 0])
        idxs.append(i)
        s = torch.where(lanes == i[..., None], torch.full_like(s, neg), s)
    top_vals = torch.stack(vals, -1)                              # (B, L, t)
    top_idx = torch.stack(idxs, -1)                               # (B, L, t)
    hit = top_vals > neg / 2
    pts = torch.gather(inner_points, 1,
                       top_idx.reshape(B, L * top_k, 1).expand(-1, -1, 3)
                       ).reshape(B, L, top_k, 3)
    # confidence^alpha, normalised by the group's max |conf| first (the
    # weighted mean is scale-invariant; raw conf^20 can underflow)
    cmax = torch.where(hit, top_vals.abs(), torch.zeros_like(top_vals)).amax(-1, keepdim=True)
    safe = torch.where(cmax > 0, cmax, torch.ones_like(cmax))
    w = torch.where(hit, (top_vals / safe) ** ALPHA, torch.zeros_like(top_vals))
    wsum = w.sum(-1, keepdim=True)
    centers = (pts * w[..., None]).sum(2) / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    valid = hit.any(-1)
    centers = torch.where(valid[..., None], centers, torch.zeros_like(centers))
    return centers, valid
