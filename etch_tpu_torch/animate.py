"""Scan animation: robust skin-weight transfer, then LBS unpose and repose.

Port of `etch_tpu/animate.py` (reference `src/animate.py`, which depends on
vendored smplx, igl and RobustSkinWeightsTransferCode):

  - clean_mesh: drop degenerate, zero-area and duplicate faces and unused
    vertices (:66-96);
  - weights_transfer: closest-surface match from SMPL to the scan within
    5% of the bounding-box diagonal and 30 degrees of normal, then harmonic
    inpainting of the unmatched vertices (:99-122), rows of all zeros
    falling back to the root (:166-170);
  - repose: T_raw = W @ A_raw per vertex, rest = T_raw^-1 x, new = T_new
    rest, with an identity guard for singular T_raw (:176-204);
  - filter_mesh: drop faces whose edge or area ratios blow up (:16-63).

The weight transfer and the inpainting are host sparse algebra (numpy and
scipy, the JAX package's code; the closest points from the port's
`data/proximity.py::MeshProximity`); the blend transforms and the reposing
are torch on the body model's device (`body/smpl.py::_rigid_transforms`,
`geometry/so3.py::rodrigues`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from etch_tpu_torch.body.smpl import SMPLModel, _rigid_transforms, smpl_forward
from etch_tpu_torch.data.mesh import TriMesh
from etch_tpu_torch.data.proximity import MeshProximity
from etch_tpu_torch.geometry.so3 import rodrigues


def clean_mesh(mesh: TriMesh, area_eps: float = 1e-12) -> TriMesh:
    V, F = mesh.vertices, mesh.faces
    degen = (F[:, 0] == F[:, 1]) | (F[:, 1] == F[:, 2]) | (F[:, 0] == F[:, 2])
    F1 = F[~degen]
    v0, v1, v2 = V[F1[:, 0]], V[F1[:, 1]], V[F1[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    F2 = F1[area >= area_eps]
    _, uniq = np.unique(np.sort(F2, axis=1), axis=0, return_index=True)
    F3 = F2[sorted(uniq)]
    used = np.unique(F3)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return TriMesh(V[used], remap[F3])


def _cotan_laplacian(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    vi, vj, vk = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    e_i, e_j, e_k = vk - vj, vi - vk, vj - vi

    def cot(a, b):
        cr = np.linalg.norm(np.cross(a, b), axis=1)
        return np.einsum("ij,ij->i", a, b) / np.clip(cr, 1e-14, None)

    ci, cj, ck = cot(-e_j, e_k), cot(-e_k, e_i), cot(-e_i, e_j)
    n = len(V)
    I = np.concatenate([F[:, 1], F[:, 2], F[:, 2], F[:, 0], F[:, 0], F[:, 1]])
    J = np.concatenate([F[:, 2], F[:, 1], F[:, 0], F[:, 2], F[:, 1], F[:, 0]])
    W = 0.5 * np.concatenate([ci, ci, cj, cj, ck, ck])
    Wm = sp.coo_matrix((W, (I, J)), shape=(n, n)).tocsr()
    return sp.diags(np.asarray(Wm.sum(1)).ravel()) - Wm


def find_matches_closest_surface(
    src_mesh: TriMesh, src_normals: np.ndarray, dst_mesh: TriMesh, dst_normals: np.ndarray,
    weights: np.ndarray, dist2_threshold: float, angle_threshold_deg: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each dst vertex: the source weights interpolated barycentrically
    at the closest source-surface point, and whether it matched (within the
    distance and normal-angle thresholds; RobustSkinWeightsTransfer)."""
    cp, dist, fidx = MeshProximity(src_mesh).closest_point(dst_mesh.vertices)

    tri = src_mesh.vertices[src_mesh.faces[fidx]]              # (Q, 3, 3)
    v0 = tri[:, 1] - tri[:, 0]
    v1 = tri[:, 2] - tri[:, 0]
    v2 = cp - tri[:, 0]
    d00 = np.einsum("ij,ij->i", v0, v0)
    d01 = np.einsum("ij,ij->i", v0, v1)
    d11 = np.einsum("ij,ij->i", v1, v1)
    d20 = np.einsum("ij,ij->i", v2, v0)
    d21 = np.einsum("ij,ij->i", v2, v1)
    denom = np.clip(d00 * d11 - d01 * d01, 1e-20, None)
    b = (d11 * d20 - d01 * d21) / denom
    c = (d00 * d21 - d01 * d20) / denom
    bary = np.clip(np.stack([1.0 - b - c, b, c], 1), 0, 1)
    bary /= bary.sum(1, keepdims=True)

    w_interp = np.einsum("qk,qkj->qj", bary, weights[src_mesh.faces[fidx]])
    n_interp = np.einsum("qk,qkj->qj", bary, src_normals[src_mesh.faces[fidx]])
    n_interp /= np.clip(np.linalg.norm(n_interp, axis=1, keepdims=True), 1e-12, None)

    cos = np.einsum("ij,ij->i", n_interp, dst_normals)
    angle_ok = cos >= np.cos(np.deg2rad(angle_threshold_deg))
    return (dist * dist <= dist2_threshold) & angle_ok, w_interp


def inpaint_weights(mesh: TriMesh, weights: np.ndarray, matched: np.ndarray) -> np.ndarray:
    """Harmonic inpainting: the unmatched vertices' weights solve L w = 0
    with the matched vertices as the Dirichlet boundary."""
    if matched.all():
        return weights
    L = _cotan_laplacian(mesh.vertices, mesh.faces).tocsr()
    free = ~matched
    Lff = L[free][:, free].tocsc()
    rhs = -L[free][:, matched] @ weights[matched]
    solve = spla.factorized(Lff + 1e-9 * sp.eye(Lff.shape[0], format="csc"))
    out = weights.copy()
    for k in range(weights.shape[1]):
        out[free, k] = solve(rhs[:, k])
    return np.clip(out, 0.0, None)


def weights_transfer(smpl_mesh: TriMesh, scan_mesh: TriMesh, lbs_weights: np.ndarray) -> np.ndarray:
    """SMPL -> scan skin-weight transfer (reference animate.py:99-122),
    normalised, with the all-zero fallback (:166-170)."""
    vmin, vmax = scan_mesh.bounds()
    dist_thr = 0.05 * float(np.linalg.norm(vmax - vmin))
    matched, w = find_matches_closest_surface(
        smpl_mesh, smpl_mesh.vertex_normals, scan_mesh, scan_mesh.vertex_normals,
        lbs_weights, dist_thr * dist_thr, 30.0)
    w = inpaint_weights(scan_mesh, w, matched)
    sums = w.sum(1, keepdims=True)
    zero = sums[:, 0] < 1e-12
    w[zero, 0] = 1.0
    sums[zero] = 1.0
    return w / sums


def blend_transforms(model: SMPLModel, betas, body_pose, global_orient) -> torch.Tensor:
    """Per-joint LBS transforms A (B, 24, 4, 4) of the given parameters."""
    B = betas.shape[0]
    v_shaped = model.v_template[None] + torch.einsum("vcs,bs->bvc", model.shapedirs, betas)
    J = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)
    R = rodrigues(torch.cat([global_orient, body_pose], dim=1).reshape(B, 24, 3))
    return _rigid_transforms(R, J, model.parents)


def repose_vertices(verts: torch.Tensor, weights: torch.Tensor, A_raw: torch.Tensor,
                    A_new: torch.Tensor) -> torch.Tensor:
    """Posed scan vertices (V, 3) (translation removed), skin weights
    (V, 24), the raw pose's transforms and the target pose's (24, 4, 4):
    unpose to rest, then repose (reference animate.py:176-204), a singular
    T_raw replaced by the identity."""
    T_raw = torch.einsum("vk,kij->vij", weights, A_raw)
    eye = torch.eye(4, dtype=verts.dtype, device=verts.device).expand(T_raw.shape)
    T_raw = torch.where((torch.linalg.det(T_raw).abs() < 1e-10)[:, None, None], eye, T_raw)
    vh = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=1)
    rest = torch.linalg.solve(T_raw, vh[..., None])[..., 0]     # T_raw^-1 x
    T_new = torch.einsum("vk,kij->vij", weights, A_new)
    return torch.einsum("vij,vj->vi", T_new, rest)[:, :3]


def filter_mesh(new_mesh: TriMesh, raw_mesh: TriMesh) -> TriMesh:
    """Drop faces stretched beyond the reference's edge and area ratio
    bounds (animate.py:16-63)."""

    def edge_area(m):
        v, f = m.vertices, m.faces
        e0 = np.linalg.norm(v[f[:, 1]] - v[f[:, 0]], axis=1)
        e1 = np.linalg.norm(v[f[:, 2]] - v[f[:, 1]], axis=1)
        e2 = np.linalg.norm(v[f[:, 0]] - v[f[:, 2]], axis=1)
        s = (e0 + e1 + e2) / 2
        area = np.sqrt(np.clip(s * (s - e0) * (s - e1) * (s - e2), 0, None))
        return np.stack([e0, e1, e2], 1), area

    re_, ra = edge_area(raw_mesh)
    ne, na = edge_area(new_mesh)
    edge_ratio = ne / (re_ + 1e-8)
    area_ratio = na / (ra + 1e-8)
    ok = (np.all((edge_ratio > 0.3) & (edge_ratio < 2.0), axis=1)
          & (area_ratio > 0.1) & (area_ratio < 4.0))
    F = new_mesh.faces[ok]
    used = np.unique(F)
    remap = -np.ones(len(new_mesh.vertices), np.int64)
    remap[used] = np.arange(len(used))
    return TriMesh(new_mesh.vertices[used], remap[F])


def animate_scan(model: SMPLModel, scan_mesh: TriMesh, raw_params: dict,
                 new_body_pose: torch.Tensor) -> TriMesh:
    """The whole animation (reference animate():125-209): raw_params holds
    betas (1, 10), body_pose (1, 69), global_orient (1, 3) and transl
    (1, 3); new_body_pose is (1, 69).  The tensors go to the body model's
    device."""
    dev = model.v_template.device
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    betas, pose, orient = (as_t(raw_params[k]) for k in ("betas", "body_pose", "global_orient"))
    new_pose = as_t(new_body_pose)
    scan = clean_mesh(scan_mesh)
    transl = as_t(raw_params["transl"]).reshape(1, 3).cpu().numpy()

    verts_raw, _ = smpl_forward(model, betas, pose, orient, torch.zeros_like(orient))
    smpl_mesh_raw = TriMesh(verts_raw[0].cpu().numpy().astype(np.float64), model.faces)
    W = weights_transfer(smpl_mesh_raw, scan, model.lbs_weights.cpu().numpy())

    A_raw = blend_transforms(model, betas, pose, orient)[0]
    A_new = blend_transforms(model, betas, new_pose, orient)[0]
    new_verts = repose_vertices(as_t(scan.vertices - transl), as_t(W), A_raw, A_new)
    out = TriMesh(new_verts.cpu().numpy() + transl, scan.faces)
    return filter_mesh(out, scan)
