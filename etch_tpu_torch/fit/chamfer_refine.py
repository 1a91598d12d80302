"""Chamfer post-refinement of a fitted SMPL against the scan point cloud.

Port of `etch_tpu/fit/chamfer_refine.py` (reference
`scripts/experiment_scripts/chamfer_refine.py:247-298`): from fitted
parameters, minimise the one-way (SMPL -> scan) Chamfer distance, or both
ways, plus a GMM pose prior (1e-8) and an L2 on the betas (0.2), with Adam
at lr 2e-2 decayed linearly to 0 over the iterations.

The nearest neighbours come from `ops/knn.py` (the kNN kernel on the card,
k=1) on detached inputs; the distance to the chosen neighbour is then
recomputed in plain torch, so the gradient reaches the SMPL vertices
through it, as it does through the exact recomputation of the JAX
package's `_knn_xla` on the CPU (`etch_tpu/ops/knn.py:84-88`).  On a TPU the
JAX package stops that gradient instead (`:53-55`), so there its Chamfer
term moves nothing (ROADMAP, queue C).
"""

from __future__ import annotations

from typing import Optional

import torch

from etch_tpu_torch.body.smpl import SMPLModel, smpl_forward
from etch_tpu_torch.fit.prior import GMMPrior
from etch_tpu_torch.ops.knn import knn


def nearest_distance(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Each query point's (B, M, 3) euclidean distance to its nearest
    support point (B, N, 3), (B, M): the index from the kNN on detached
    inputs, the distance differentiable in both clouds."""
    idx, _ = knn(query.detach().contiguous(), support.detach().contiguous(), 1)
    rows = torch.arange(query.shape[0], device=query.device)[:, None]
    nearest = support[rows, idx[..., 0].long()]                 # (B, M, 3)
    return torch.sqrt(torch.clamp(((query - nearest) ** 2).sum(-1), min=0.0))


def chamfer_refine(model: SMPLModel, scan_points: torch.Tensor, init_pose: torch.Tensor,
                   init_betas: torch.Tensor, init_orient: torch.Tensor,
                   init_transl: torch.Tensor, prior: Optional[GMMPrior] = None,
                   iterations: int = 500, lr: float = 2e-2, beta_reg: float = 0.2,
                   prior_w: float = 1e-8, bidirectional: bool = False):
    """scan_points (P, 3); init_* (1, 69), (1, 10), (1, 3), (1, 3).  Returns
    {"pose", "betas", "orient", "transl"} refined (detached) and
    "final_loss", the loss before the last update."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in (
        ("pose", init_pose), ("betas", init_betas), ("orient", init_orient),
        ("transl", init_transl))}
    scan = scan_points[None]
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = None
    for i in range(iterations):
        verts, _ = smpl_forward(model, params["betas"], params["pose"], params["orient"],
                                params["transl"])
        loss = nearest_distance(verts, scan).mean()              # SMPL -> scan
        if bidirectional:
            loss = loss + nearest_distance(scan, verts).mean()
        loss = loss + beta_reg * (params["betas"] ** 2).mean()
        if prior is not None:
            loss = loss + prior_w * prior(params["pose"]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.param_groups[0]["lr"] = lr * (iterations - i) / iterations   # linear decay
        opt.step()
    out = {k: v.detach() for k, v in params.items()}
    out["final_loss"] = loss.detach()
    return out
