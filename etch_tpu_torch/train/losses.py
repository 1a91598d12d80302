"""Training losses (reference src/train.py:81-101).

Port of `etch_tpu/train/losses.py`:
  direction:  1 - cosine(gt_vectors, pred_directions), mean, the cosine's
              denominator clamped at 1e-8 (torch cosine_similarity's eps)
  magnitude:  MSE(|gt_vectors| * scale_magnitude, pred_magnitudes)
  confidence: MSE(pred_confidences, gt_confidences)
  part_label: cross-entropy(pred_logits, gt_labels), integer labels
All multiplied by their configured weights and summed into `all_loss`.
"""

from __future__ import annotations

from typing import Dict

import torch

from etch_tpu_torch.utils.config import EtchConfig


def compute_losses(
    cfg: EtchConfig,
    results: Dict[str, torch.Tensor],
    vectors: torch.Tensor,       # (B, N, 3) gt tightness vectors
    confidences: torch.Tensor,   # (B, N, 1)
    labels: torch.Tensor,        # (B, N) int
) -> Dict[str, torch.Tensor]:
    losses = {}
    if "direction" in results:
        pred = results["direction"]
        dot = (vectors * pred).sum(-1)
        denom = torch.linalg.norm(vectors, dim=-1) * torch.linalg.norm(pred, dim=-1)
        cos = dot / torch.clamp(denom, min=1e-8)
        losses["direction_loss"] = (1.0 - cos).mean() * cfg.direction_w
    if "magnitude" in results:
        norms = torch.linalg.norm(vectors, dim=-1, keepdim=True)
        losses["magnitude_loss"] = (
            ((norms * cfg.scale_magnitude - results["magnitude"]) ** 2).mean()
            * cfg.magnitude_w
        )
    if "confidences" in results:
        losses["confidence_loss"] = (
            ((results["confidences"] - confidences) ** 2).mean() * cfg.confidence_w
        )
    if "part_labels" in results:
        logits = results["part_labels"]
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
        losses["part_label_loss"] = ce * cfg.part_label_w
    losses["all_loss"] = sum(v for k, v in losses.items() if k != "all_loss")
    return losses
