"""What the port's CPU tests share: inputs, tolerances and the pairing of a
JAX network with the port's on the same weights.  Not a test module (pytest
collects `test_*.py` only); every `tests/test_torch_*.py` that needs one of
these imports it from here and never from another test module.

The pairing (`paired_nets`): the JAX package's `EtchNet(cfg).init` under
jit, its BatchNorm statistics and scales perturbed (`_perturb`, so the eval
affines are not identities), the first block's occupancy skip conv zeroed
(`zero_first_skip`: its instance norm of a per-channel constant is f32
rounding noise times 1/sqrt(eps) = 316, different in each framework), then
converted by `convert.flax_to_state_dict` into the port's `EtchNet`.  An
f32 JAX forward runs under `jax.jit` (`jax_apply`), as the JAX package
serves it: op by op it compiles each of its ~850 primitives on its own, 45
s against 8 s as one program (test_torch_widths.py's network, alone on an
8-core host), and the port's errors read the same to rounding.  The bf16
network stays op by op (test_torch_bf16.py)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from etch_tpu.data.mesh import TriMesh
from etch_tpu.models.etch_net import EtchNet as JaxEtchNet
from etch_tpu.pipeline import InferencePipeline as JaxPipeline
from etch_tpu.pipeline import build_pipeline as jax_build_pipeline
from etch_tpu.utils.config import EPNConfig as JaxEPNConfig
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.convert import flax_to_state_dict
from etch_tpu_torch.models.etch_net import EtchNet
from etch_tpu_torch.nn import attention
from etch_tpu_torch.nn.bf16 import rnd
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.train.synthetic import make_batch
from etch_tpu_torch.utils.config import EPNConfig, EtchConfig

# An xdist worker shares the host's cores with the others, and torch's
# default of one intra-op thread per core oversubscribes them: with six
# workers on 8 cores tier-1 took 1,014 s (test_torch_epn4.py's published
# widths forward 258 s, 10 s alone), with one thread a worker 214-314 s (17
# s), with two no less (313 s).  So a worker takes its share of the cores;
# a run without xdist keeps torch's default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.join(os.path.dirname(__file__), "..")
# the bundled 4D-Dress sample
DATA = os.path.join(REPO, "datafolder")
SAMPLE = "00122_Inner_Take2_00011"
SCAN_DIR = os.path.join(DATA, "4D-DRESS", "data_processed", "model")
SMPL_DIR = os.path.join(DATA, "4D-DRESS", "data_processed", "smplh")
INFO_DIR = os.path.join(DATA, "gt_4D-Dress_data", "npz")
MARKERSET = os.path.join(DATA, "useful_data_4d-dress", "superset_smpl.json")
TRAIN_IDS = os.path.join(DATA, "useful_data_4d-dress", "train_ids.pkl")

N = 128
CFG_KW = dict(num_point=N, batch_size=2, unet_blocks=(1, 2, 1, 1, 3), dir_num_layers=2)


# --- inputs -------------------------------------------------------------------------

def capsule(rng, B, n):
    """B clouds of n points on a capsule-like body surface (radius 0.15 +
    0.03 cos 3z, |z| < 0.9), float32; `rng` a seed or a RandomState, which
    the draws advance."""
    rng = _rng(rng)
    z = rng.uniform(-0.9, 0.9, (B, n))
    th = rng.uniform(0, 2 * np.pi, (B, n))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)


def _rng(rng):
    return rng if isinstance(rng, np.random.RandomState) else np.random.RandomState(rng)


def scaled_batch(rng, B, n, scale=0.5):
    """`train/synthetic.py::make_batch` clouds with their points and vectors
    scaled by `scale`; `rng` a seed or a RandomState."""
    b = make_batch(_rng(rng), B, n)
    b["hitpts"] = (b["hitpts"] * scale).astype(np.float32)
    b["vectors"] = (b["vectors"] * scale).astype(np.float32)
    return b


def markerset():
    """86 markers spread over the 6,890 vertices of the synthetic body."""
    return {f"M{i}": int(v) for i, v in enumerate(np.linspace(0, 6889, 86).astype(int))}


def _core_params(E, V, seed):
    """Random direction-core weights: two layers of q, k, v (E x E), the
    compression to V and the two-layer MLP and readout, f32 tensors."""
    g = np.random.RandomState(seed)
    p = {}
    for l in (0, 1):
        for nm in ("wq", "wk", "wv"):
            p[f"{nm}{l}"] = g.randn(E, E) / np.sqrt(E)
    p["wc0"], p["bc0"] = g.randn(E, E) / np.sqrt(E), 0.1 * g.randn(E)
    p["wc1"], p["bc1"] = g.randn(E, V) / np.sqrt(E), 0.1 * g.randn(V)
    p["wm0"], p["bm0"] = g.randn(V, V) / np.sqrt(V), 0.1 * g.randn(V)
    p["wm1"], p["bm1"] = g.randn(V, V) / np.sqrt(V), 0.1 * g.randn(V)
    p["wr"], p["br"] = g.randn(V, 1) / np.sqrt(V), 0.1 * g.randn(1)
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}


GAP = 2e-6


def _d2(q, s):
    return ((q[:, :, None, :].astype(np.float64) - s[:, None, :, :]) ** 2).sum(-1)


def _radius_without_boundary_pairs(q, s, candidates):
    """The first candidate radius with no (query, support) pair within GAP
    of it in squared distance (float64), where the JAX package's expanded
    distances could round the other way."""
    d = _d2(q, s)
    for r in candidates:
        r2 = float(np.float32(r) * np.float32(r))
        if np.abs(d - r2).min() > GAP:
            return r
    raise AssertionError("every candidate radius has a pair on its boundary")


# --- tolerances ---------------------------------------------------------------------

def _close(out, ref, atol=None):
    """max |out - ref| <= atol, by default 1e-4 * (1 + max |ref|): f32 sums
    taken in another order, carried through the network."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    atol = 1e-4 * (1 + np.abs(ref).max()) if atol is None else atol
    assert err <= atol, f"max abs err {err} > {atol}"


def _close_kernel(out, ref):
    """A bf16 plain version against a Pallas kernel (interpret mode): the
    same rounding points, another summation order."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    med = np.median(err / (np.abs(ref) + 1e-2))
    assert med <= 5e-3, f"median rel err {med}"
    assert err.max() <= 5e-2 * (1 + np.abs(ref).max()), f"max abs err {err.max()}"


def _bf16_gate(out, ref):
    """The card's bf16 gate: the same rounding points, another summation
    order, so max |diff| <= 1e-2 max|ref| and median |diff| / (|ref| +
    1e-2) <= 1e-3."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert err.max() <= 1e-2 * ref.abs().max(), err.max()
    assert (err / (ref.abs() + 1e-2)).median() <= 1e-3


def _close_forward(out, ref, q99=2e-4):
    """The port's EtchNet outputs against JAX's: magnitudes, logits and
    confidences by `_close`; the directions `q99` for 99% of the points and
    1e-2 for all, since at random weights the anchor weights are nearly
    uniform, the chordal mean nearly cancels and the SO(3) projection
    amplifies rounding."""
    for key in ("magnitude", "part_labels", "confidences"):
        _close(out[key].numpy(), ref[key])
    err = np.abs(out["direction"].numpy() - np.asarray(ref["direction"]))
    assert np.quantile(err, 0.99) <= q99 and err.max() <= 1e-2, err.max()


def _padded_attention_matches(Bc, L, E, H, seed):
    """The anchor attention's padded layout in float64: each head padded by
    zero columns to 8 or to a multiple of 16, the keys to 64 rows, those at
    L..63 masked to -inf and their k and v rows zero."""
    hs = E // H
    hp = 8 if hs <= 8 else -(-hs // 16) * 16
    g = np.random.RandomState(seed)
    q, k, v = (rnd(torch.tensor(g.randn(Bc, L, E) * (hs ** -0.5 if i == 0 else 1.0),
                                dtype=torch.float32)) for i in range(3))

    def pad(t):
        out = np.zeros((Bc, 64, H, hp))
        out[:, :L, :, :hs] = t.double().numpy().reshape(Bc, L, H, hs)
        return out

    qp, kp, vp = pad(q), pad(k), pad(v)
    s = np.einsum("bqhd,bkhd->bhqk", qp, kp)
    heads = q.double().numpy().reshape(Bc, L, H, hs), k.double().numpy().reshape(Bc, L, H, hs)
    np.testing.assert_array_equal(s[:, :, :L, :L], np.einsum("bqhd,bkhd->bhqk", *heads))
    s[..., L:] = -np.inf
    e = np.exp(s - s.max(-1, keepdims=True))
    a = e / e.sum(-1, keepdims=True)
    assert (a[..., L:] == 0).all()
    ab = rnd(torch.from_numpy(a.astype(np.float32))).double().numpy()
    o = np.einsum("bhqk,bkhd->bqhd", ab, vp)
    assert (o[..., hs:] == 0).all()
    out = torch.from_numpy(o[:, :L, :, :hs].reshape(Bc, L, E)).float()
    _bf16_gate(out, attention.attention_torch(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                              v.to(torch.bfloat16), H))


# --- the JAX network and the port's on the same weights ------------------------------

def _perturb(tree, rng):
    """Random BN statistics / scales so every eval affine is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k.endswith("mean"):
            out[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("var"):
            out[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        elif k.endswith("scale"):
            out[k] = (v * rng.uniform(0.8, 1.2, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def zero_first_skip(params):
    """Zero the first block's occupancy skip conv in a numpy flax tree, in
    place, and return the tree."""
    skip = params["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"], skip["bias"] = np.zeros_like(skip["kernel"]), np.zeros_like(skip["bias"])
    return params


def paired_nets(key, seed, epn=None, **kw):
    """(JAX EtchNet, its variables, the port's EtchNet in eval mode on them)
    at `EtchConfig.tiny(**kw)` (`epn`: a dict of EPNConfig fields):
    initialised from PRNGKey(key), BatchNorm perturbed from
    RandomState(seed), the first skip conv zeroed."""
    cfg_j = JaxConfig.tiny(**kw, **({} if epn is None else dict(epn=JaxEPNConfig(**epn))))
    cfg = EtchConfig.tiny(**kw, **({} if epn is None else dict(epn=EPNConfig(**epn))))
    jm = JaxEtchNet(cfg=cfg_j)
    v = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(key), jnp.zeros((1, cfg.num_point, 3)))
    rng = np.random.RandomState(seed)
    variables = {"params": _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng),
                 "batch_stats": _perturb(jax.tree_util.tree_map(np.asarray, v["batch_stats"]),
                                         rng)}
    zero_first_skip(variables["params"])
    tm = EtchNet(cfg).eval()
    tm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"], cfg))
    return jm, variables, tm


def paired_pipelines(markers, **kw):
    """(the JAX package's pipeline at `EtchConfig.tiny(**kw)` on its random
    weights, the first skip conv zeroed; the port's pipeline on the CPU on
    those weights converted), both on the synthetic body."""
    ref = jax_build_pipeline(JaxConfig.tiny(**kw), markers, allow_synthetic_body=True)
    params = zero_first_skip(jax.tree_util.tree_map(np.array, ref.params))
    stats = jax.tree_util.tree_map(np.array, ref.batch_stats)
    ref = JaxPipeline(ref.cfg, params, stats, ref.body_model, ref.marker_vids)
    cfg = EtchConfig.tiny(**kw)
    port = build_pipeline(cfg, markers, state_dict=flax_to_state_dict(params, stats, cfg),
                          allow_synthetic_body=True, device="cpu")
    return ref, port


def jax_apply(jm, variables, *args, **kw):
    """`jm.apply(variables, *args, **kw)` compiled as one program, its
    outputs as numpy."""
    out = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(variables, *map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


def forward_and_encoder(jm, variables, tm, pts):
    """One forward pass on each side: (the port's outputs, its encoder's
    (xyz, feats), JAX's outputs, its encoder's SphericalCloud)."""
    ref, state = jax_apply(jm, variables, pts, train=False,
                           capture_intermediates=lambda m, name: m.name == "encoder",
                           mutable=["intermediates"])
    (cloud, _), = state["intermediates"]["encoder"]["__call__"]
    seen = []
    hook = tm.encoder.register_forward_hook(lambda m, args, out: seen.append(out))
    try:
        out = tm(torch.from_numpy(pts))
    finally:
        hook.remove()
    (enc,) = seen
    return out, enc, ref, cloud


def _orbax_tool():
    """`tools/orbax_to_torch.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the JAX package's GT rejection-branch meshes ------------------------------------

def box_mesh(xmin, xmax, ymin, ymax, zmin, zmax):
    """Axis-aligned closed box with outward-facing triangles."""
    v = np.array([
        [xmin, ymin, zmin], [xmax, ymin, zmin],
        [xmax, ymax, zmin], [xmin, ymax, zmin],
        [xmin, ymin, zmax], [xmax, ymin, zmax],
        [xmax, ymax, zmax], [xmin, ymax, zmax],
    ], np.float64)
    f = np.array([
        [0, 2, 1], [0, 3, 2],          # bottom (-z)
        [4, 5, 6], [4, 6, 7],          # top (+z)
        [0, 1, 5], [0, 5, 4],          # -y
        [2, 3, 7], [2, 7, 6],          # +y
        [0, 4, 7], [0, 7, 3],          # -x
        [1, 2, 6], [1, 6, 5],          # +x
    ], np.int32)
    return TriMesh(v, f)


def merge(*meshes):
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += len(m.vertices)
    return TriMesh(np.concatenate(verts), np.concatenate(faces))


def top_face_samples(n=5, z=0.0, half=0.3):
    """Points on the z=`z` plane with +z normals, away from box edges."""
    g = np.linspace(-half, half, n)
    xx, yy = np.meshgrid(g, g)
    pts = np.stack([xx.ravel(), yy.ravel(), np.full(xx.size, z)], axis=1)
    normals = np.tile([0.0, 0.0, 1.0], (len(pts), 1))
    return pts, normals


# body slab: top face at z=0, comfortably thicker than the 0.03 self-test
BODY = box_mesh(-0.5, 0.5, -0.5, 0.5, -0.2, 0.0)


def scan_with_top(ztop):
    return box_mesh(-1.0, 1.0, -1.0, 1.0, -1.0, ztop)
