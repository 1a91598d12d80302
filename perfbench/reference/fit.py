"""Markers, the two-stage LM fit and SMPL in plain PyTorch: the reference.

Frozen copies of the port's `fit/markers.py`, `fit/lm.py`,
`fit/smpl_fit.py` and `body/smpl.py` (reference `src/models/fit_SMPL.py`),
f32, reading the body model as a dict of tensors (v_template, shapedirs,
posedirs, J_regressor, lbs_weights, parents, landmark_ids) that the
benchmark makes itself.  Imports nothing of the port.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from perfbench.reference.geometry import rodrigues

ALPHA = 20.0
NUM_POSE = 69


def extract_markers(inner_points, part_labels, confidences, num_markers: int, top_k: int = 3):
    """Per marker label the top-3 points by confidence among those labelled
    with it, weighted by (confidence / group max)^20 and averaged.
    -> (markers (B, L, 3), valid (B, L) bool)."""
    if confidences.ndim == 3:
        confidences = confidences[..., 0]
    B, K, _ = inner_points.shape
    L = num_markers
    labels = torch.arange(L, device=part_labels.device, dtype=part_labels.dtype)
    onehot = part_labels[:, None, :] == labels[None, :, None]
    neg = torch.finfo(confidences.dtype).min
    s = torch.where(onehot, confidences[:, None, :], torch.full_like(confidences[:, None, :], neg))
    lanes = torch.arange(K, device=s.device)
    vals, idxs = [], []
    for _ in range(top_k):
        i = torch.argmax(s, dim=-1)
        vals.append(torch.gather(s, -1, i[..., None])[..., 0])
        idxs.append(i)
        s = torch.where(lanes == i[..., None], torch.full_like(s, neg), s)
    top_vals, top_idx = torch.stack(vals, -1), torch.stack(idxs, -1)
    hit = top_vals > neg / 2
    pts = torch.gather(inner_points, 1, top_idx.reshape(B, L * top_k, 1).expand(-1, -1, 3)
                       ).reshape(B, L, top_k, 3)
    cmax = torch.where(hit, top_vals.abs(), torch.zeros_like(top_vals)).amax(-1, keepdim=True)
    safe = torch.where(cmax > 0, cmax, torch.ones_like(cmax))
    w = torch.where(hit, (top_vals / safe) ** ALPHA, torch.zeros_like(top_vals))
    wsum = w.sum(-1, keepdim=True)
    centers = (pts * w[..., None]).sum(2) / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    valid = hit.any(-1)
    return torch.where(valid[..., None], centers, torch.zeros_like(centers)), valid


def _rigid_transforms(R, J, parents):
    J_rel = torch.cat([J[:, :1], J[:, 1:] - J[:, list(parents[1:])]], dim=1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    T_local = torch.cat([torch.cat([R, J_rel[..., None]], dim=-1), bottom], dim=-2)
    world = [T_local[:, 0]]
    for k in range(1, T_local.shape[1]):
        world.append(world[parents[k]] @ T_local[:, k])
    W = torch.stack(world, dim=1)
    WJ = torch.einsum("bkij,bkj->bki", W[..., :3, :3], J)
    shift = torch.cat([torch.zeros_like(W[..., :3, :3]), -WJ[..., None]], dim=-1)
    shift = torch.cat([shift, torch.zeros_like(W[..., :1, :])], dim=-2)
    return W + shift


def _pose_blend(pose):
    B = pose.shape[0]
    R = rodrigues(pose.reshape(B, 24, 3))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return R, (R[:, 1:] - eye).reshape(B, 23 * 9)


def smpl_forward(body: dict, betas, body_pose, global_orient, transl):
    """Full SMPL forward -> (vertices (B, V, 3), joints (B, 45, 3))."""
    B = betas.shape[0]
    V = body["v_template"].shape[0]
    v_shaped = body["v_template"][None] + torch.einsum("vcs,bs->bvc", body["shapedirs"], betas)
    J = torch.einsum("jv,bvc->bjc", body["J_regressor"], v_shaped)
    R, pose_feat = _pose_blend(torch.cat([global_orient, body_pose], dim=1))
    v_posed = v_shaped + (pose_feat @ body["posedirs"]).reshape(B, V, 3)
    A = _rigid_transforms(R, J, body["parents"])
    T = torch.einsum("vk,bkij->bvij", body["lbs_weights"], A)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvij,bvj->bvi", T, v_h)[..., :3] + transl[:, None]
    joints24 = torch.einsum("jv,bvc->bjc", body["J_regressor"], verts - transl[:, None])
    landmarks = verts[:, body["landmark_ids"].long()]
    return verts, torch.cat([joints24 + transl[:, None], landmarks], dim=1)


def marker_submodel(body: dict, vids) -> dict:
    """SMPL restricted to the marker vertices."""
    vids = torch.as_tensor(vids, dtype=torch.long, device=body["v_template"].device)
    V = body["v_template"].shape[0]
    return {
        "m_template": body["v_template"][vids],
        "m_shapedirs": body["shapedirs"][vids],
        "m_posedirs": body["posedirs"].reshape(207, V, 3)[:, vids, :].reshape(207, -1),
        "m_weights": body["lbs_weights"][vids],
        "J_template": torch.einsum("jv,vc->jc", body["J_regressor"], body["v_template"]),
        "J_shapedirs": torch.einsum("jv,vcs->jcs", body["J_regressor"], body["shapedirs"]),
        "parents": body["parents"],
    }


def marker_forward(sub: dict, betas, body_pose, global_orient, transl):
    B = betas.shape[0]
    M = sub["m_template"].shape[0]
    m_shaped = sub["m_template"][None] + torch.einsum("mcs,bs->bmc", sub["m_shapedirs"], betas)
    J = sub["J_template"][None] + torch.einsum("jcs,bs->bjc", sub["J_shapedirs"], betas)
    R, pose_feat = _pose_blend(torch.cat([global_orient, body_pose], dim=1))
    m_posed = m_shaped + (pose_feat @ sub["m_posedirs"]).reshape(B, M, 3)
    A = _rigid_transforms(R, J, sub["parents"])
    T = torch.einsum("mk,bkij->bmij", sub["m_weights"], A)
    m_h = torch.cat([m_posed, torch.ones_like(m_posed[..., :1])], dim=-1)
    return torch.einsum("bmij,bmj->bmi", T, m_h)[..., :3] + transl[:, None]


def levenberg_marquardt(residual_fn, x0, args, num_steps: int, step_size: float,
                        damping: float):
    """Constant-damping LM, batched: (J^T J + damping I) delta = -J^T r by
    Cholesky, x <- x + step * delta, Jacobians by forward mode."""
    eye = torch.eye(x0.shape[-1], dtype=x0.dtype, device=x0.device)

    def with_aux(x, *a):
        r = residual_fn(x, *a)
        return r, r

    jac = vmap(jacfwd(with_aux, has_aux=True))
    x = x0
    for _ in range(num_steps):
        J, r = jac(x, *args)
        Jt = J.transpose(-1, -2)
        L = torch.linalg.cholesky(Jt @ J + damping * eye)
        x = x + step_size * torch.cholesky_solve(-(Jt @ r[..., None]), L)[..., 0]
    return x


def _unpack(x, n_betas):
    return (x[..., :NUM_POSE], x[..., NUM_POSE:NUM_POSE + n_betas],
            x[..., NUM_POSE + n_betas:NUM_POSE + n_betas + 3], x[..., NUM_POSE + n_betas + 3:])


def fit_smpl_params(sub: dict, markers, valid, cfg: dict, num_betas: int = 10):
    """Stage 0: pose, 2 betas, orient, transl (damping 0.01); stage 1: all
    10 betas, warm-started (damping 1e-3).  -> pose, betas, global_orient,
    transl."""
    B = markers.shape[0]
    vmask = valid.to(markers.dtype)[..., None]

    def residual(n_free):
        def fn(x, target, mask):
            pose, b_free, orient, transl = _unpack(x, n_free)
            betas = torch.cat([b_free, b_free.new_zeros(num_betas - n_free)])
            fwd = marker_forward(sub, betas[None], pose[None], orient[None], transl[None])[0]
            return ((target - fwd) * mask).reshape(-1)
        return fn

    x0 = markers.new_zeros((B, NUM_POSE + 2 + 6))
    x_s0 = levenberg_marquardt(residual(2), x0, (markers, vmask), cfg["fit_steps_stage0"],
                               cfg["fit_lr_stage0"], 0.01)
    pose, b2, orient, transl = _unpack(x_s0, 2)
    x1 = torch.cat([pose, b2, markers.new_zeros((B, num_betas - 2)), orient, transl], -1)
    x_s1 = levenberg_marquardt(residual(num_betas), x1, (markers, vmask),
                               cfg["fit_steps_stage1"], cfg["fit_lr_stage1"], 1e-3)
    pose, betas, orient, transl = _unpack(x_s1, num_betas)
    return {"pose": pose, "betas": betas, "global_orient": orient, "transl": transl}


@torch.no_grad()
def fit(body: dict, marker_vids, cfg: dict, inner_points, part_labels, confidences):
    """Markers -> LM fit -> SMPL: (verts, params, markers, valid, joints)."""
    markers, valid = extract_markers(inner_points, part_labels, confidences, len(marker_vids))
    params = fit_smpl_params(marker_submodel(body, marker_vids), markers, valid, cfg,
                             num_betas=body["shapedirs"].shape[-1])
    verts, joints = smpl_forward(body, params["betas"], params["pose"],
                                 params["global_orient"], params["transl"])
    return verts, params, markers, valid, joints
