"""PyTorch port vs JAX package on the bf16 serving path (`use_bfloat16`).

Kernel modules: each plain version (what the port runs on the CPU, and what
its CUDA kernel is held to on the card) against the JAX package's Pallas
kernel in interpret mode, the way tests/test_attention.py and
tests/test_pallas_interconv.py call them.  Both sides round to bf16 at the
same points and differ only in summation order (and the Pallas inter-conv
forms its weights through the |x|^2 - 2 x.k + |k|^2 expansion), which can
move a value across a bf16 rounding boundary now and then.  Tolerance:
median |out - ref| / (|ref| + 1e-2) <= 5e-3 and max |out - ref| <=
5e-2 * (1 + max |ref|).

The network: the port's bf16 EtchNet against JAX `EtchNet(use_bfloat16=True)`
at the tiny config of tests/test_torch_model.py (`torch_parity.CFG_KW`),
weights converted by `flax_to_state_dict`.  On the CPU the JAX package runs its XLA reference
functions, which round in other places than its kernels (f32 weights in the
direction core and the vector attention, bf16 elementwise sums), while the
port follows the kernels.  Measured on the JAX package alone, bf16 against
f32 moves magnitudes and logits by a median relative 5e-3 and the
directions by 4.7e-2 (max 1.55, the chordal mean is ill-conditioned at
random weights).  So: magnitude, logits and confidences within a median
relative 1e-2 and 2e-2 * (1 + max |ref|) for all; part labels equal for 98%
of the points; the direction core's anchor weights (see the test's
docstring for their bound); the end-to-end directions finite and of unit
norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.geometry import get_anchors, get_kernel_points
from etch_tpu.nn.pallas_attention import packed_attention
from etch_tpu.nn.pallas_dircore import direction_core_pallas
from etch_tpu.nn.pallas_dircore import direction_core_ref as jax_direction_core_ref
from etch_tpu.nn.pallas_grouped_head import grouped_head_pallas
from etch_tpu.nn.pallas_interconv import interconv_t_pallas
from etch_tpu.nn.pallas_vector_attention import vector_attention_pallas
from etch_tpu.ops import group_points as jax_group
from etch_tpu_torch.nn import dircore, grouped_head, interconv, vector_attention
from etch_tpu_torch.ops.ball_query import ball_query_torch
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig

from torch_parity import (CFG_KW, N, _close_kernel, _core_params, capsule, markerset,
                          paired_nets)

BF16 = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def test_dircore_matches_pallas():
    p = {k: v.numpy() for k, v in _core_params(64, 128, 3).items()}
    tokens = np.random.RandomState(0).randn(4, 60, 64).astype(np.float32)
    ref = direction_core_pallas(jnp.asarray(tokens),
                                {k: jnp.asarray(v) for k, v in p.items()}, 8, tile=4,
                                interpret=True)
    tp = {k: _t(v) for k, v in p.items()}
    out = dircore.direction_core_torch(_t(tokens, BF16), tp, 8)
    _close_kernel(out.numpy(), ref)
    # the dispatcher takes the plain version for CPU tensors, in chunks
    # (a matmul's summation order may depend on its row count)
    np.testing.assert_allclose(
        dircore.direction_core(_t(tokens, BF16), tp, 8, chunk=3).numpy(), out.numpy(),
        rtol=1e-5, atol=1e-6)


def _va_inputs(B, N_, ns, c, s=8, seed=0):
    rng = np.random.RandomState(seed)
    cs = c // s
    xq = rng.randn(B * N_, c).astype(np.float32)
    xk = rng.randn(B, N_, c).astype(np.float32)
    xv = rng.randn(B, N_, c).astype(np.float32)
    idx = rng.randint(0, N_, (B, N_, ns)).astype(np.int32)
    pe = rng.randn(B * N_, ns, c).astype(np.float32)
    a0 = np.stack([rng.rand(c) + 0.5, rng.randn(c)]).astype(np.float32)
    w0 = (rng.randn(c, cs) / np.sqrt(c)).astype(np.float32)
    a1 = np.stack([rng.rand(cs) + 0.5, rng.randn(cs)]).astype(np.float32)
    w1 = (rng.randn(cs, cs) / np.sqrt(cs)).astype(np.float32)
    b1 = rng.randn(cs).astype(np.float32)
    return xq, xk, xv, idx, pe, a0, w0, a1, w1, b1


def _va_pallas(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """The JAX kernel on the same rows, gathered neighbour-major."""
    B, N_, ns = idx.shape
    gk = np.stack([xk[b][idx[b]] for b in range(B)]).reshape(B * N_, ns, -1)
    gv = np.stack([xv[b][idx[b]] for b in range(B)]).reshape(B * N_, ns, -1)
    tr = lambda a: jnp.asarray(a.transpose(1, 0, 2))
    return vector_attention_pallas(jnp.asarray(xq), tr(gk), tr(gv), tr(pe),
                                   jnp.asarray(a0), jnp.asarray(w0), jnp.asarray(a1),
                                   jnp.asarray(w1), jnp.asarray(b1[None]), interpret=True)


def _va_port(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    return vector_attention.vector_attention(
        _t(xq, BF16), _t(xk, BF16), _t(xv, BF16), torch.from_numpy(idx), _t(pe, BF16),
        _t(a0), _t(w0), _t(a1), _t(w1), _t(b1))


@pytest.mark.parametrize("ns,c", [(8, 64), (16, 128)])
def test_vector_attention_matches_pallas(ns, c):
    args = _va_inputs(2, 8, ns, c)
    _close_kernel(_va_port(*args).numpy(), _va_pallas(*args))


def test_vector_attention_b1_stability():
    """b1 + 300 on every logit: the softmax subtracts its max, so the port
    (which adds b1) stays finite and equal to the kernel (which drops it)."""
    args = list(_va_inputs(2, 8, 8, 64))
    args[9] = args[9] + 300.0
    out = _va_port(*args).numpy()
    assert np.isfinite(out).all()
    _close_kernel(out, _va_pallas(*args))


def test_grouped_head_matches_pallas():
    rng = np.random.RandomState(1)
    R, c0, k = 70, 128, 86
    h = rng.randn(R, c0).astype(np.float32)
    w0 = (rng.randn(c0, c0 * k) / np.sqrt(c0)).astype(np.float32)
    b0 = (rng.randn(c0 * k) * 0.1).astype(np.float32)
    wg = (rng.randn(k, c0) / np.sqrt(c0)).astype(np.float32)
    bg = (rng.randn(k) * 0.1).astype(np.float32)
    ref = grouped_head_pallas(*(jnp.asarray(a) for a in (h, w0, b0, wg, bg)),
                              interpret=True)
    out = grouped_head.grouped_head(_t(h, BF16), _t(w0), _t(b0), _t(wg), _t(bg))
    _close_kernel(out.numpy(), ref)


def _conv_inputs(C, seed=5, B=2, P=200, c=24, nn=12):
    """A conv0-like plan at small size: 24 centers, 12 neighbours from the
    port's ball query, 60 anchors x 24 kernel points, radius 0.2."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.5, 0.5, (B, P, 3)).astype(np.float32)
    centers = xyz[:, :c].copy()
    radius, sigma = 0.2, 0.5 * 0.2 ** 2
    nbr = ball_query_torch(torch.from_numpy(centers), torch.from_numpy(xyz), radius,
                           nn).numpy()
    rk = np.einsum("aij,kj->aki", get_anchors(), get_kernel_points(radius, 1))
    feats = rng.randn(B, P, 60 * C).astype(np.float32) if C else None
    gx = jax_group(jnp.asarray(xyz), jnp.asarray(nbr)) - jnp.asarray(centers)[:, :, None, :]
    return xyz, centers, nbr, feats, rk.reshape(-1, 3).astype(np.float32), sigma, gx


def test_interconv_ones_proj_matches_pallas():
    xyz, centers, nbr, _, rk, sigma, gx = _conv_inputs(0)
    w = np.random.RandomState(2).randn(24, 32).astype(np.float32) * 0.25
    ref = interconv_t_pallas(gx, None, jnp.asarray(rk), sigma, 60, proj_w=jnp.asarray(w),
                             interpret=True)                        # (B, c, A*Co) bf16
    t = torch.from_numpy
    out = interconv.interconv_ones_proj(t(xyz), t(centers), t(nbr), t(rk), sigma, 60,
                                        t(w))
    assert out.dtype == BF16 and out.shape == (2, 24, 60, 32)
    _close_kernel(out.float().reshape(2, 24, -1).numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("C", [8, 32])
def test_interconv_t_bf16_matches_pallas(C):
    xyz, centers, nbr, feats, rk, sigma, gx = _conv_inputs(C)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    gf2 = jax_group(fb, jnp.asarray(nbr))
    ref = interconv_t_pallas(gx, gf2, jnp.asarray(rk), sigma, 60, interpret=True)
    t = torch.from_numpy
    out = interconv.interconv_t(t(xyz), t(centers), t(nbr), _t(feats, BF16), t(rk), sigma,
                                60)
    assert out.dtype == BF16
    _close_kernel(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.fixture(scope="module")
def bf16_models():
    return paired_nets(0, 7, **CFG_KW, use_bfloat16=True)


def test_bf16_flax_tree_converts(bf16_models):
    """The bf16 model's flax parameters stay f32 and map one to one."""
    _, variables, tm = bf16_models
    leaves = jax.tree_util.tree_leaves(variables)
    assert all(np.asarray(x).dtype == np.float32 for x in leaves)
    assert all(p.dtype == torch.float32 for p in tm.state_dict().values())


@torch.no_grad()
def test_bf16_etchnet_forward(bf16_models):
    jm, variables, tm = bf16_models
    pts = capsule(4, 2, N)
    # op by op, the rounding points the docstring names: under jit XLA fuses
    # the bf16 elementwise sums, and the magnitudes' median read 0.70 of its
    # bound in place of 0.57
    ref = jm.apply(variables, jnp.asarray(pts), train=False)
    out = tm(torch.from_numpy(pts))
    for key in ("magnitude", "part_labels", "confidences"):
        o, r = out[key].numpy(), np.asarray(ref[key], np.float32)
        assert o.shape == r.shape and o.dtype == np.float32
        err = np.abs(o - r)
        assert np.median(err / (np.abs(r) + 1e-2)) <= 1e-2, key
        assert err.max() <= 2e-2 * (1 + np.abs(r).max()), key
    agree = (out["part_labels"].numpy().argmax(-1)
             == np.asarray(ref["part_labels"]).argmax(-1)).mean()
    assert agree >= 0.98, agree
    d = out["direction"].numpy()
    assert d.shape == (2, N, 3) and np.isfinite(d).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)


@torch.no_grad()
def test_bf16_direction_core_anchor_weights(bf16_models):
    """The direction head's anchor weights on random features, port (the
    TPU kernel's rounding points) against the JAX CPU path
    (`direction_core_ref` with packed attention), which keeps the weights in
    f32 and rounds the attention output elsewhere: the two differ by a
    median relative 8e-3 here, above the 5e-3 of the kernel tests, which
    compare like rounding with like.  So this holds the JAX package's own
    bound for its fused core against that reference
    (tests/test_attention.py:215-216): median relative < 5e-2, plus the
    kernel tests' 5e-2 * (1 + max) for every value."""
    jm, variables, tm = bf16_models
    feat = np.random.RandomState(1).randn(2 * N, 60, 8).astype(np.float32)
    p = variables["params"]["direction_head"]
    ref = jax_direction_core_ref(jnp.asarray(feat).astype(jnp.bfloat16),
                                 {k: jnp.asarray(v) for k, v in p.items()},
                                 tm.cfg.dir_num_heads, attn=packed_attention)
    head = tm.direction_head
    out = dircore.direction_core(torch.from_numpy(feat).to(BF16),
                                 dict(head.named_parameters()), head.num_heads, head.chunk)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.numpy() - ref)
    assert np.median(err / (np.abs(ref) + 1e-2)) < 5e-2
    assert err.max() <= 5e-2 * (1 + np.abs(ref).max())


def test_bf16_run_batch_on_cpu():
    B, Np = 2, 256
    pipe = build_pipeline(EtchConfig.tiny(num_point=Np, batch_size=B, use_bfloat16=True),
                          markerset(), allow_synthetic_body=True, device="cpu")
    out = pipe.run_batch(capsule(0, B, Np))
    shapes = {"vectors": (B, Np, 3), "inner_points": (B, Np, 3), "part_labels": (B, Np),
              "confidences": (B, Np, 1), "markers": (B, 86, 3), "markers_valid": (B, 86),
              "verts": (B, 6890, 3), "joints": (B, 45, 3)}
    for key, shape in shapes.items():
        assert tuple(out[key].shape) == shape, key
    for key in ("vectors", "inner_points", "confidences", "markers", "verts", "joints"):
        assert out[key].dtype == torch.float32 and torch.isfinite(out[key]).all(), key
