"""One training step in plain PyTorch: the reference.

A frozen copy of the port's `train/losses.py` and `train/state.py` step
(reference `src/train.py:60-140`): the training forward of `net.py`, the
four losses and their sum, the backward, Adam with optax's defaults
(0.9 / 0.999 / 1e-8) written out, the NaN guard (gradients through
`nan_to_num`; on a non-finite loss no parameter or moment moves), and the
BatchNorm running statistics moved once a step (0.9 old + 0.1 batch).
The state is a dict of tensors; imports nothing of the port.
"""

from __future__ import annotations

import torch

from perfbench.reference.net import Ctx, Numerics, forward

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
BN_MOMENTUM = 0.9


def compute_losses(cfg: dict, r: dict, vectors, confidences, labels) -> dict:
    pred = r["direction"]
    cos = (vectors * pred).sum(-1) / torch.clamp(
        torch.linalg.norm(vectors, dim=-1) * torch.linalg.norm(pred, dim=-1), min=1e-8)
    norms = torch.linalg.norm(vectors, dim=-1, keepdim=True)
    logits = r["part_labels"]
    losses = {
        "direction_loss": (1.0 - cos).mean() * cfg["direction_w"],
        "magnitude_loss": ((norms * cfg["scale_magnitude"] - r["magnitude"]) ** 2).mean()
        * cfg["magnitude_w"],
        "confidence_loss": ((r["confidences"] - confidences) ** 2).mean() * cfg["confidence_w"],
        "part_label_loss": torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()) * cfg["part_label_w"],
    }
    losses["all_loss"] = sum(losses.values())
    return losses


class TrainState:
    """Parameters (requiring gradients), buffers, Adam's moments and its
    count of applied updates."""

    def __init__(self, state_dict: dict, param_names):
        names = set(param_names)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in state_dict.items() if k in names}
        self.buffers = {k: v.detach().clone() for k, v in state_dict.items() if k not in names}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.last_grads = {}


def train_step(state: TrainState, cfg: dict, batch: dict, numerics: Numerics = None,
               lr: float = None):
    """One step on `batch` (hitpts, vectors, confidences, labels tensors);
    returns the losses (detached).  The gradients the step applied stay in
    `state.last_grads`."""
    numerics = numerics or Numerics()
    lr = cfg["lr"] if lr is None else lr
    with numerics.scope():
        ctx = Ctx({**state.params, **state.buffers}, cfg, train=True, numerics=numerics)
        r = forward(ctx, batch["hitpts"])
        losses = compute_losses(cfg, r, batch["vectors"], batch["confidences"], batch["labels"])
        names = list(state.params)
        grads = torch.autograd.grad(losses["all_loss"], [state.params[k] for k in names],
                                    allow_unused=True)
    with torch.no_grad():
        for name, value in ctx.stats.items():
            state.buffers[name].copy_(BN_MOMENTUM * state.buffers[name]
                                      + (1 - BN_MOMENTUM) * value)
        grads = {k: torch.nan_to_num(torch.zeros_like(state.params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        state.last_grads = grads
        if torch.isfinite(losses["all_loss"]).item():
            state.count += 1
            t = state.count
            for k, g in grads.items():
                m = state.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v = state.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                m_hat = m / (1 - BETA1 ** t)
                v_hat = v / (1 - BETA2 ** t)
                state.params[k].sub_(lr * m_hat / (v_hat.sqrt() + EPS))
    return {k: v.detach() for k, v in losses.items()}
