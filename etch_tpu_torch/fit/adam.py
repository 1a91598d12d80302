"""Adam-based SMPL fit (the alternative optimizer).

Port of `etch_tpu/fit/adam.py` (reference `src/models/fit_SMPL_Adam.py:
65-230`): the LM path's marker objective, the mean over the batch of the
summed squared masked marker residuals, minimised by Adam (lr 1e-2,
optax's defaults) in two stages from zero parameters: 400 steps with the
first 2 betas free, then 800 with all of them, each stage with a fresh
Adam state; optionally an L2 on the betas (mean shape).
"""

from __future__ import annotations

import torch

from etch_tpu_torch.body.smpl import MarkerSubModel, marker_forward
from etch_tpu_torch.fit.smpl_fit import NUM_POSE


def fit_smpl_adam(sub: MarkerSubModel, markers: torch.Tensor, valid: torch.Tensor,
                  steps_stage0: int = 400, steps_stage1: int = 800, lr: float = 1e-2,
                  num_betas: int = 10, use_mean_shape: bool = False,
                  mean_shape_w: float = 1e-2):
    """markers (B, M, 3), valid (B, M) -> dict(pose (B, 69), betas (B, 10),
    global_orient (B, 3), transl (B, 3), final_loss: the loss before the
    last update)."""
    B = markers.shape[0]
    vmask = valid.to(markers.dtype)[..., None]
    params = {k: markers.new_zeros((B, n)).requires_grad_(True)
              for k, n in (("pose", NUM_POSE), ("betas", num_betas), ("orient", 3),
                           ("transl", 3))}

    def loss_fn(n_free_betas):
        betas = torch.cat([params["betas"][:, :n_free_betas],
                           markers.new_zeros((B, num_betas - n_free_betas))], 1)
        fwd = marker_forward(sub, betas, params["pose"], params["orient"], params["transl"])
        loss = (((markers - fwd) * vmask) ** 2).sum((1, 2)).mean()
        if use_mean_shape:
            loss = loss + mean_shape_w * (betas ** 2).sum(1).mean()
        return loss

    loss = None
    for steps, n_free in ((steps_stage0, 2), (steps_stage1, num_betas)):
        opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            loss = loss_fn(n_free)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return {"pose": params["pose"].detach(), "betas": params["betas"].detach(),
            "global_orient": params["orient"].detach(), "transl": params["transl"].detach(),
            "final_loss": loss.detach()}
