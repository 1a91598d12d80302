"""Two-stage SMPL fit to predicted markers.

Port of `etch_tpu/fit/smpl_fit.py:fit_smpl_params` (reference
`src/models/fit_SMPL.py:68-269`):
  stage 0: pose (69) + first 2 betas + global orient (3) + transl (3),
           30 LM iterations, step 0.5, damping 0.01
  stage 1: pose + all 10 betas + orient + transl, warm-started,
           50 LM iterations, step 0.2, damping 1e-3
Residual: (markers - forward_markers) * valid, flattened (M*3), evaluated on
the marker-restricted SMPL submodel.  `fit_smpl` is the whole path from
inner points: markers, the fit, then the full SMPL forward.
"""

from __future__ import annotations

import torch

from etch_tpu_torch.body.smpl import (MarkerSubModel, SMPLModel, marker_forward,
                                     marker_submodel, smpl_forward)
from etch_tpu_torch.fit.lm import levenberg_marquardt
from etch_tpu_torch.fit.markers import extract_markers
from etch_tpu_torch.utils import trace

NUM_POSE = 69  # 23 joints * 3


def _unpack(x, n_betas):
    pose = x[..., :NUM_POSE]
    betas = x[..., NUM_POSE:NUM_POSE + n_betas]
    orient = x[..., NUM_POSE + n_betas:NUM_POSE + n_betas + 3]
    transl = x[..., NUM_POSE + n_betas + 3:]
    return pose, betas, orient, transl


def marker_residual(sub: MarkerSubModel, n_free_betas: int, num_betas: int = 10):
    """The LM residual of a stage with the first `n_free_betas` betas free:
    (x (P,), target (M, 3), mask (M, 1)) -> (M*3,)."""
    def fn(x, target, mask):
        pose, b_free, orient, transl = _unpack(x, n_free_betas)
        betas = torch.cat([b_free, b_free.new_zeros(num_betas - n_free_betas)])
        fwd = marker_forward(sub, betas[None], pose[None], orient[None], transl[None])[0]
        return ((target - fwd) * mask).reshape(-1)
    return fn


def fit_smpl_params(sub: MarkerSubModel, markers: torch.Tensor, valid: torch.Tensor,
                    steps_stage0: int = 30, steps_stage1: int = 50,
                    lr_stage0: float = 0.5, lr_stage1: float = 0.2,
                    damping_stage0: float = 0.01, damping_stage1: float = 1e-3,
                    num_betas: int = 10):
    """markers (B, M, 3), valid (B, M) bool -> dict(pose (B, 69), betas
    (B, 10), global_orient (B, 3), transl (B, 3)).  On a CUDA device each
    stage's Jacobian pass is captured once per submodel and batch shape."""
    B = markers.shape[0]
    vmask = valid.to(markers.dtype)[..., None]                    # (B, M, 1)

    def stage(n_free, x, steps, lr, damping):
        # id(sub): the cached graph keeps its residual, and so sub, alive
        return levenberg_marquardt(marker_residual(sub, n_free, num_betas), x,
                                   (markers, vmask), steps, lr, damping,
                                   graph_key=(id(sub), n_free, num_betas))

    x0 = markers.new_zeros((B, NUM_POSE + 2 + 6))
    with trace.span("fit.lm0"):
        x_s0 = stage(2, x0, steps_stage0, lr_stage0, damping_stage0)
    pose, b2, orient, transl = _unpack(x_s0, 2)
    x1 = torch.cat([pose, b2, markers.new_zeros((B, num_betas - 2)), orient, transl], -1)
    with trace.span("fit.lm1"):
        x_s1 = stage(num_betas, x1, steps_stage1, lr_stage1, damping_stage1)
    pose, betas, orient, transl = _unpack(x_s1, num_betas)
    return {"pose": pose, "betas": betas, "global_orient": orient, "transl": transl}


def fit_smpl(model: SMPLModel, marker_vids, inner_points: torch.Tensor,
             part_labels: torch.Tensor, confidences: torch.Tensor,
             steps_stage0: int = 30, steps_stage1: int = 50,
             lr_stage0: float = 0.5, lr_stage1: float = 0.2):
    """Inner points (B, K, 3), part labels (B, K) and confidences (B, K, 1)
    -> markers -> fitted SMPL.  Returns (vertices (B, V, 3), params dict,
    markers (B, M, 3), valid (B, M), joints (B, J, 3)), the information
    surface of reference fit_SMPL.py:68-269."""
    markers, valid = extract_markers(inner_points, part_labels, confidences,
                                     num_markers=len(marker_vids))
    params = fit_smpl_params(marker_submodel(model, marker_vids), markers, valid,
                             steps_stage0=steps_stage0, steps_stage1=steps_stage1,
                             lr_stage0=lr_stage0, lr_stage1=lr_stage1,
                             num_betas=int(model.num_betas))
    verts, joints = smpl_forward(model, params["betas"], params["pose"],
                                 params["global_orient"], params["transl"])
    return verts, params, markers, valid, joints
