"""SMPL body model in PyTorch: blend shapes + pose correctives + LBS.

Port of `etch_tpu/body/smpl.py` (`SMPLModel`, `smpl_forward`,
`MarkerSubModel` / `marker_submodel`, `marker_forward`,
`synthetic_body_model`, `load_smpl`).  Every function is functional (no
in-place writes into tensors that carry data), so `marker_forward` runs
under `torch.func.vmap` / `jacfwd` in the LM fit.

Loader notes: SMPL .pkl releases variously contain numpy arrays, chumpy
wrappers and scipy sparse matrices; `load_smpl` unpickles them without
chumpy installed by stubbing chumpy classes and extracting their underlying
ndarrays, as the JAX package's loader does.
"""

from __future__ import annotations

import dataclasses
import functools
import pickle

import numpy as np
import torch

from etch_tpu_torch.geometry.so3 import rodrigues

NUM_BODY_JOINTS = 23  # SMPL (excl. root)

# smplx's standard SMPL surface-landmark vertex ids (public metadata of the
# SMPL topology; order defines joints[24:45]), as in the JAX package.
SMPL_LANDMARK_VERTEX_IDS = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
    "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
    "lpinky": 2673,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133,
}


@dataclasses.dataclass
class SMPLModel:
    """Tensor bundle for one SMPL body model (one gender)."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, n_betas)
    posedirs: torch.Tensor     # (207, V*3) pose-corrective basis (row-major)
    J_regressor: torch.Tensor  # (24, V)
    lbs_weights: torch.Tensor  # (V, 24)
    parents: tuple             # (24,) ints, parents[0] == -1
    faces: np.ndarray          # (F, 3) int32
    landmark_ids: np.ndarray   # (21,) int32

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    def to(self, device) -> "SMPLModel":
        move = lambda t: t.to(device)
        return dataclasses.replace(
            self, v_template=move(self.v_template), shapedirs=move(self.shapedirs),
            posedirs=move(self.posedirs), J_regressor=move(self.J_regressor),
            lbs_weights=move(self.lbs_weights))


def _to_np(x):
    """ndarray from numpy / chumpy-stub / scipy sparse."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    if hasattr(x, "r"):        # live chumpy object
        return np.asarray(x.r)
    if isinstance(x, _ChStub):
        return x.array()
    return np.asarray(x)


class _ChStub:
    """Stand-in for chumpy objects during unpickling."""

    def __init__(self, *a, **k):
        self.__dict__["_state"] = {}

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    def array(self):
        st = self.__dict__.get("_state", {})
        if isinstance(st, dict):
            for key in ("x", "a", "v"):
                if key in st:
                    return _to_np(st[key])
        raise ValueError("cannot extract array from chumpy stub")


class _SMPLUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChStub
        return super().find_class(module, name)


def load_smpl(path: str, dtype=np.float32, device="cpu") -> SMPLModel:
    """Load an SMPL pkl (any of the common release formats) onto `device`."""
    with open(path, "rb") as f:
        data = _SMPLUnpickler(f, encoding="latin1").load()

    v_template = _to_np(data["v_template"]).astype(dtype)
    shapedirs = _to_np(data["shapedirs"]).astype(dtype)
    if shapedirs.shape[-1] > 10:
        shapedirs = shapedirs[..., :10]
    posedirs = _to_np(data["posedirs"]).astype(dtype)
    # store as (207, V*3) so the pose blend is one matmul
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T.copy()
    J_regressor = _to_np(data["J_regressor"]).astype(dtype)
    weights = _to_np(data["weights"]).astype(dtype)
    kintree = _to_np(data["kintree_table"]).astype(np.int64)
    parents = kintree[0].astype(np.int32)
    parents[0] = -1
    faces = _to_np(data["f"]).astype(np.int32)
    landmark_ids = np.array(list(SMPL_LANDMARK_VERTEX_IDS.values()), np.int32)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return SMPLModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        J_regressor=t(J_regressor),
        lbs_weights=t(weights),
        parents=tuple(int(p) for p in parents),
        faces=faces,
        landmark_ids=landmark_ids,
    )


@functools.lru_cache(maxsize=None)
def _parent_index(parents: tuple, device: torch.device) -> torch.Tensor:
    """parents[1:] as an int64 tensor on `device`, made once: indexing with
    the host list would copy it to the card on every call."""
    return torch.as_tensor(parents[1:], dtype=torch.int64, device=device)


def _rigid_transforms(R: torch.Tensor, J: torch.Tensor, parents) -> torch.Tensor:
    """Forward kinematics with rest-pose removal.  R (B, 24, 3, 3), J
    (B, 24, 3) -> A (B, 24, 4, 4) with v' = sum_k w_k A_k v_rest.

    No host-to-device copy, so the LM fit can capture it in a CUDA graph."""
    parents = tuple(parents)
    J_rel = torch.cat([J[:, :1], J[:, 1:] - J[:, _parent_index(parents, J.device)]], dim=1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0                                        # the row [0, 0, 0, 1]
    T_local = torch.cat([torch.cat([R, J_rel[..., None]], dim=-1), bottom], dim=-2)
    world = [T_local[:, 0]]
    for k in range(1, T_local.shape[1]):
        world.append(world[parents[k]] @ T_local[:, k])
    W = torch.stack(world, dim=1)                               # (B, 24, 4, 4)
    WJ = torch.einsum("bkij,bkj->bki", W[..., :3, :3], J)
    # A = W with its translation column reduced by W_rot @ J_rest
    shift = torch.cat([torch.zeros_like(W[..., :3, :3]), -WJ[..., None]], dim=-1)
    shift = torch.cat([shift, torch.zeros_like(W[..., :1, :])], dim=-2)
    return W + shift


def _pose_blend(pose: torch.Tensor):
    """pose (B, 72) axis-angle -> (R (B, 24, 3, 3), pose_feat (B, 207))."""
    B = pose.shape[0]
    R = rodrigues(pose.reshape(B, 24, 3))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return R, (R[:, 1:] - eye).reshape(B, 23 * 9)


def smpl_forward(model: SMPLModel, betas, body_pose, global_orient, transl):
    """Full SMPL forward -> (vertices (B, V, 3), joints (B, 45, 3))."""
    B = betas.shape[0]
    V = model.num_verts
    v_shaped = model.v_template[None] + torch.einsum("vcs,bs->bvc", model.shapedirs, betas)
    J = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)
    R, pose_feat = _pose_blend(torch.cat([global_orient, body_pose], dim=1))
    v_posed = v_shaped + (pose_feat @ model.posedirs).reshape(B, V, 3)
    A = _rigid_transforms(R, J, model.parents)
    T = torch.einsum("vk,bkij->bvij", model.lbs_weights, A)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvij,bvj->bvi", T, v_h)[..., :3] + transl[:, None]
    joints24 = torch.einsum("jv,bvc->bjc", model.J_regressor, verts - transl[:, None])
    joints24 = joints24 + transl[:, None]
    landmarks = verts[:, torch.as_tensor(model.landmark_ids, device=verts.device).long()]
    return verts, torch.cat([joints24, landmarks], dim=1)


@dataclasses.dataclass(frozen=True)
class MarkerSubModel:
    """SMPL restricted to the marker vertices: the fit needs only those, so
    its per-iteration LBS is (M, .) instead of (6890, .)."""

    m_template: torch.Tensor    # (M, 3)
    m_shapedirs: torch.Tensor   # (M, 3, n_betas)
    m_posedirs: torch.Tensor    # (207, M*3)
    m_weights: torch.Tensor     # (M, 24)
    J_template: torch.Tensor    # (24, 3)
    J_shapedirs: torch.Tensor   # (24, 3, n_betas)
    parents: tuple


def marker_submodel(model: SMPLModel, marker_vids) -> MarkerSubModel:
    vids = torch.as_tensor(np.asarray(marker_vids, np.int64), device=model.v_template.device)
    M = len(vids)
    pose_rows = model.posedirs.reshape(207, model.num_verts, 3)[:, vids, :]
    return MarkerSubModel(
        m_template=model.v_template[vids],
        m_shapedirs=model.shapedirs[vids],
        m_posedirs=pose_rows.reshape(207, M * 3),
        m_weights=model.lbs_weights[vids],
        J_template=torch.einsum("jv,vc->jc", model.J_regressor, model.v_template),
        J_shapedirs=torch.einsum("jv,vcs->jcs", model.J_regressor, model.shapedirs),
        parents=tuple(model.parents),
    )


def marker_forward(sub: MarkerSubModel, betas, body_pose, global_orient, transl):
    """Marker positions only: (B, M, 3)."""
    B = betas.shape[0]
    M = sub.m_template.shape[0]
    m_shaped = sub.m_template[None] + torch.einsum("mcs,bs->bmc", sub.m_shapedirs, betas)
    J = sub.J_template[None] + torch.einsum("jcs,bs->bjc", sub.J_shapedirs, betas)
    R, pose_feat = _pose_blend(torch.cat([global_orient, body_pose], dim=1))
    m_posed = m_shaped + (pose_feat @ sub.m_posedirs).reshape(B, M, 3)
    A = _rigid_transforms(R, J, sub.parents)
    T = torch.einsum("mk,bkij->bmij", sub.m_weights, A)
    m_h = torch.cat([m_posed, torch.ones_like(m_posed[..., :1])], dim=-1)
    return torch.einsum("bmij,bmj->bmi", T, m_h)[..., :3] + transl[:, None]


def synthetic_body_model(n_verts: int = 300, n_joints: int = 24, n_betas: int = 10,
                         seed: int = 0, device="cpu") -> SMPLModel:
    """Small deterministic body-like model for tests and benchmarks (no SMPL
    pkl needed): the JAX package's numpy generator, so the arrays are
    bit-equal to `etch_tpu.body.smpl.synthetic_body_model`'s."""
    rng = np.random.RandomState(seed)
    z = np.linspace(-0.9, 0.9, n_verts)
    theta = rng.uniform(0, 2 * np.pi, n_verts)
    r = 0.12 + 0.02 * np.cos(3 * z)
    v_template = np.stack([r * np.cos(theta), r * np.sin(theta), z], 1)

    joint_z = np.linspace(-0.85, 0.85, n_joints)
    parents = np.arange(-1, n_joints - 1, dtype=np.int32)

    d = np.abs(z[:, None] - joint_z[None, :])
    w = np.exp(-(d / 0.15) ** 2) + 1e-6
    weights = w / w.sum(1, keepdims=True)
    jr = np.exp(-(d.T / 0.05) ** 2) + 1e-9
    jr = jr / jr.sum(1, keepdims=True)

    shapedirs = rng.randn(n_verts, 3, n_betas).astype(np.float64) * 0.01
    posedirs = (rng.randn((n_joints - 1) * 9, n_verts * 3) * 1e-4)

    faces = np.stack(
        [np.arange(n_verts - 2), np.arange(1, n_verts - 1), np.arange(2, n_verts)], 1
    ).astype(np.int32)
    lm = np.linspace(0, n_verts - 1, 21).astype(np.int32)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SMPLModel(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        J_regressor=f32(jr),
        lbs_weights=f32(weights),
        parents=tuple(int(p) for p in parents),
        faces=faces,
        landmark_ids=lm,
    )
