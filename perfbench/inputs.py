"""What the benchmark hands to both sides: scans, training batches, the
body model, the marker set and the weights, all made from `--seed`.

Frozen copies, so that a change of the program cannot change its inputs:
  - `read_obj` and `sample_surface`: the port's `data/mesh.py::load_obj`
    (vertices and triangle faces) and `data/sampling.py::sample_surface`
    (area-weighted, square-root barycentric trick);
  - `capsule_batch`: the port's `train/synthetic.py::make_batch` (bumpy
    capsule clouds with analytic tightness vectors, labels and confidences);
  - `synthetic_body`: the port's `body/smpl.py::synthetic_body_model` at
    6,890 vertices (the repository has no SMPL pkl);
  - `make_weights`: the flax initialisers of the port's
    `models/etch_net.py::init_params` (truncated LeCun normal, Xavier
    uniform, BatchNorm 1 / 0, inter/intra conv biases 1e-3), drawn on the
    device from one `torch.Generator` in one call.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parent / "data"
SCAN = DATA / "scan_00122_Inner_Take2_00011.obj"
MARKERSET = DATA / "superset_smpl.json"


def seed_streams(seed: int, n: int):
    """n independent numpy seed sequences from one seed of any size."""
    return np.random.SeedSequence(int(seed)).spawn(n)


def torch_seed(ss: np.random.SeedSequence) -> int:
    lo, hi = ss.generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


# ---- scans ---------------------------------------------------------------


def read_obj(path) -> tuple:
    """Vertices (V, 3) float64 and triangle faces (F, 3) int64 of an OBJ
    (positions and faces only, polygons fanned, 1-based or negative)."""
    verts, faces = [], []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    return v, np.where(f > 0, f - 1, len(v) + f)


def surface(verts, faces) -> tuple:
    """A mesh's triangles (F, 3, 3) and their area shares (F,)."""
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    return tri, areas / areas.sum()


def sample_surface(tri, probs, count: int, rng: np.random.Generator) -> np.ndarray:
    """count points uniform by area on the triangles (count, 3)."""
    fidx = rng.choice(len(probs), size=count, p=probs)
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    t = tri[fidx]
    return ((1.0 - r1)[:, None] * t[:, 0] + (r1 * (1.0 - r2))[:, None] * t[:, 1]
            + (r1 * r2)[:, None] * t[:, 2])


def scan_clouds(mesh, batch: int, points: int, axis: int, rng: np.random.Generator) -> np.ndarray:
    """(batch, points, 3) f32 clouds: each a fresh area-weighted sample of
    the scan, turned about the vertical `axis` by a random angle, then
    bbox-centred as the serving entry prepares a scan."""
    tri, probs = surface(*mesh)
    out = np.empty((batch, points, 3), np.float32)
    a, b = [i for i in range(3) if i != axis]
    for i in range(batch):
        p = sample_surface(tri, probs, points, rng)
        th = rng.uniform(0.0, 2.0 * np.pi)
        c, s = np.cos(th), np.sin(th)
        q = p.copy()
        q[:, a], q[:, b] = c * p[:, a] - s * p[:, b], s * p[:, a] + c * p[:, b]
        out[i] = q - (q.min(0) + q.max(0)) / 2.0
    return out


# ---- training batches -----------------------------------------------------


def capsule_batch(rng: np.random.RandomState, batch: int, n_point: int) -> dict:
    """Scan points on a bumpy capsule and the smooth capsule underneath as
    the body: radial tightness vectors, 86 axial part labels, confidence
    exp(-10 |v|)."""
    z = rng.uniform(-0.9, 0.9, (batch, n_point))
    th = rng.uniform(0, 2 * np.pi, (batch, n_point))
    bump = 0.02 + 0.015 * np.sin(4 * z) * np.cos(2 * th)
    r_scan = 0.15 + bump
    cos_t, sin_t = np.cos(th), np.sin(th)
    pts = np.stack([r_scan * cos_t, r_scan * sin_t, z], axis=-1)
    vectors = np.stack([bump * cos_t, bump * sin_t, np.zeros_like(z)], axis=-1)
    labels = np.clip(((z + 0.9) / 1.8 * 86).astype(np.int32), 0, 85)
    conf = np.exp(-10.0 * bump)[..., None]
    return {"hitpts": pts.astype(np.float32), "vectors": vectors.astype(np.float32),
            "confidences": conf.astype(np.float32), "labels": labels}


def numpy_rng(ss: np.random.SeedSequence) -> np.random.RandomState:
    return np.random.RandomState(np.random.MT19937(ss))


# ---- body model and markers ---------------------------------------------


def synthetic_body(n_verts: int = 6890, n_joints: int = 24, n_betas: int = 10,
                   seed: int = 0) -> dict:
    """A deterministic body-like model with SMPL's layout (numpy arrays):
    v_template, shapedirs, posedirs, J_regressor, lbs_weights, parents,
    faces, landmark_ids."""
    rng = np.random.RandomState(seed)
    z = np.linspace(-0.9, 0.9, n_verts)
    theta = rng.uniform(0, 2 * np.pi, n_verts)
    r = 0.12 + 0.02 * np.cos(3 * z)
    v_template = np.stack([r * np.cos(theta), r * np.sin(theta), z], 1)
    joint_z = np.linspace(-0.85, 0.85, n_joints)
    d = np.abs(z[:, None] - joint_z[None, :])
    w = np.exp(-(d / 0.15) ** 2) + 1e-6
    jr = np.exp(-(d.T / 0.05) ** 2) + 1e-9
    shapedirs = rng.randn(n_verts, 3, n_betas).astype(np.float64) * 0.01
    posedirs = rng.randn((n_joints - 1) * 9, n_verts * 3) * 1e-4
    faces = np.stack([np.arange(n_verts - 2), np.arange(1, n_verts - 1),
                      np.arange(2, n_verts)], 1).astype(np.int32)
    f32 = lambda a: np.asarray(a, np.float32)
    return {"v_template": f32(v_template), "shapedirs": f32(shapedirs), "posedirs": f32(posedirs),
            "J_regressor": f32(jr / jr.sum(1, keepdims=True)),
            "lbs_weights": f32(w / w.sum(1, keepdims=True)),
            "parents": tuple(int(p) for p in np.arange(-1, n_joints - 1)), "faces": faces,
            "landmark_ids": np.linspace(0, n_verts - 1, 21).astype(np.int32)}


def body_tensors(body: dict, device) -> dict:
    """The body model's arrays as tensors on `device` (parents stays a tuple)."""
    return {k: (v if k in ("parents", "faces") else torch.as_tensor(v, device=device))
            for k, v in body.items()}


def marker_vids(n_verts: int) -> np.ndarray:
    vids = np.asarray(list(json.loads(MARKERSET.read_text()).values()), np.int32)
    return (vids % n_verts).astype(np.int32)


# ---- weights ---------------------------------------------------------------

_ZERO = re.compile(r"(running_mean|_mean|bias|_b|bc\d+|bm\d+|br)$")
_ONE = re.compile(r"(running_var|_var|_scale)$")
_CONV_BIAS = re.compile(r"\.(inter|intra)\.bias$")
_XAVIER = re.compile(r"(\.W|confi1_w)$")
_LECUN_IN_OUT = re.compile(r"(w0_kernel|w1_kernel|confi0_kernel|direction_head\.w\w+)$")


def _init_rule(name: str, shape) -> tuple:
    """(kind, scale) of a weight: ("const", value), ("trunc", std) or
    ("uniform", limit)."""
    if _CONV_BIAS.search(name):
        return "const", 1e-3
    if len(shape) == 1:
        if _ONE.search(name) or name.endswith(".weight"):
            return "const", 1.0
        if _ZERO.search(name):
            return "const", 0.0
    if len(shape) == 2:
        if _XAVIER.search(name):
            return "uniform", math.sqrt(6.0 / (shape[0] + shape[1]))
        if _LECUN_IN_OUT.search(name):
            return "trunc", math.sqrt(1.0 / shape[0]) / 0.87962566103423978
        if name.endswith(".weight"):   # torch Linear (out, in)
            return "trunc", math.sqrt(1.0 / shape[1]) / 0.87962566103423978
    raise ValueError(f"no initialiser for weight {name} {tuple(shape)}")


def make_weights(shapes: dict, seed: int, device) -> dict:
    """A state_dict for `shapes` (name -> shape, the program's names) from
    `seed`: every random weight from one uniform draw on `device`."""
    rules = {k: _init_rule(k, s) for k, s in shapes.items()}
    total = sum(math.prod(shapes[k]) for k, (kind, _) in rules.items() if kind != "const")
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))      # Phi(-2)
    out, at = {}, 0
    for k, (kind, scale) in rules.items():
        shape = tuple(shapes[k])
        if kind == "const":
            out[k] = torch.full(shape, scale, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        x = u[at:at + n]
        at += n
        if kind == "uniform":
            x = (2.0 * x - 1.0) * scale
        else:   # normal truncated at two standard deviations, by its inverse CDF
            x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * x) - 1.0) * scale
        out[k] = x.to(torch.float32).reshape(shape)
    return out
