"""PyTorch port vs JAX package: the anchor attention, the chunked direction
head and the 1-channel inter-conv body.

  - `attention_torch` (the plain version of `csrc/attention.cu`) against
    `attention_pallas` in interpret mode, on the inputs of
    tests/test_attention.py.  Both round the attention weights to bf16 at the
    same point and differ only in f32 rounding (summation order; softmax
    divides where the kernel multiplies by the reciprocal), which can move a
    weight across a bf16 rounding boundary now and then (one step of a
    weight ~1/60 is 6e-5, times |v| <= 4): max |out - ref| <= 1e-3 *
    (1 + max |ref|), median |out - ref| / (|ref| + 1e-2) <= 1e-5.
  - The chunked bf16 direction head (`fused_core=False`) against the JAX
    package's `DirectionHead` on the CPU, which runs `direction_core_ref`
    with packed attention over chunks: same rounding points, so the anchor
    weights agree to a median relative 1e-4 and 5e-3 * (1 + max |ref|) for
    all.  The fused core's rounding (bf16 weights, `direction_core_torch`),
    which the port used on this route before, misses both bounds (a median
    relative 5e-3 to 7e-3): the test tells the two apart.
  - `interconv_t_c1` on f32 rows against `interconv_t_xla` (exact weights on
    both sides, f32 sums in another order: 1e-5 * max |t|), and on bf16 rows
    against `interconv_t_pallas` in interpret mode (`_kernel_c1`: exact
    weights, f32 sums, bf16 t; the TPU kernel forms the weights through the
    |x|^2 - 2 x.k + |k|^2 expansion, so a t can round to the neighbouring
    bf16 value: one bf16 step, 8e-3 * max |t|, for all, and a median relative
    1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.geometry import get_anchors, get_kernel_points
from etch_tpu.models.etch_net import DirectionHead as JaxDirectionHead
from etch_tpu.nn.pallas_attention import attention_pallas, packed_attention
from etch_tpu.nn.pallas_dircore import direction_core_ref
from etch_tpu.nn.pallas_interconv import interconv_t_pallas, interconv_t_xla
from etch_tpu.ops import group_points as jax_group
from etch_tpu_torch.models.etch_net import DirectionHead
from etch_tpu_torch.nn import attention, dircore, interconv
from etch_tpu_torch.ops.ball_query import ball_query_torch

BF16 = torch.bfloat16


def _bf(a):
    return torch.tensor(np.asarray(a, np.float32)).to(BF16)


def _errors(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref)
    return err.max(), np.median(err / (np.abs(ref) + 1e-2)), np.abs(ref).max()


def _close_attention(out, ref):
    worst, med, scale = _errors(out, ref)
    assert worst <= 1e-3 * (1 + scale), f"max abs err {worst}"
    assert med <= 1e-5, f"median rel err {med}"


def test_attention_matches_pallas():
    B, L, E, H = 16, 60, 64, 8
    rng = np.random.RandomState(2)
    q = rng.randn(B, L, E).astype(np.float32) / np.sqrt(8)
    k = rng.randn(B, L, E).astype(np.float32)
    v = rng.randn(B, L, E).astype(np.float32)
    ref = attention_pallas(*(jnp.asarray(a) for a in (q, k, v)), H, tile=8, interpret=True)
    out = attention.attention_torch(_bf(q), _bf(k), _bf(v), H)
    assert out.dtype == torch.float32
    _close_attention(out.numpy(), ref)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(attention.attention(_bf(q), _bf(k), _bf(v), H), out)


def test_attention_extreme_head_gap():
    """Head 0's logits ~1e3 above the others': the per-(query, head) max
    keeps every head finite and equal to the TPU kernel's."""
    B, L, E, H = 8, 60, 64, 8
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(B, L, E).astype(np.float32) for _ in range(3))
    q[:, :, :8] *= 40.0
    k[:, :, :8] *= 40.0
    ref = attention_pallas(*(jnp.asarray(a) for a in (q, k, v)), H, tile=8, interpret=True)
    out = attention.attention_torch(_bf(q), _bf(k), _bf(v), H).numpy()
    assert np.isfinite(out).all()
    _close_attention(out, ref)


@pytest.mark.parametrize("layers", [1, 2])
@torch.no_grad()
def test_chunked_direction_head_matches_jax(layers):
    E, V, H, chunk = 8, 16, 2, 64
    feat = np.random.RandomState(1).randn(2, 50, 60, E).astype(np.float32)   # 100 points
    jh = JaxDirectionHead(embed_dim=E, value_dim=V, num_heads=H, num_layers=layers,
                          chunk=chunk, dtype=jnp.bfloat16)
    params = jh.init(jax.random.PRNGKey(layers), jnp.asarray(feat))["params"]
    rng = np.random.RandomState(9)     # non-zero biases, so every bias is exercised
    params = {k: (np.asarray(v) + (0.1 * rng.randn(*v.shape) if k.startswith("b") else 0))
              .astype(np.float32) for k, v in params.items()}
    tokens = feat.reshape(100, 60, E)
    ref = direction_core_ref(jnp.asarray(tokens).astype(jnp.bfloat16),
                             {k: jnp.asarray(v) for k, v in params.items()}, H,
                             attn=packed_attention)
    head = DirectionHead(E, V, H, layers, chunk, dtype=BF16, fused_core=False)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    worst, med, scale = _errors(head.anchor_weights(torch.from_numpy(tokens)).numpy(), ref)
    assert med <= 1e-4 and worst <= 5e-3 * (1 + scale), (med, worst)
    # the fused core's rounding on the same tokens misses these bounds
    fused = dircore.direction_core_torch(torch.from_numpy(tokens).to(BF16),
                                         dict(head.named_parameters()), H)
    f_worst, f_med, _ = _errors(fused.numpy(), ref)
    assert f_med > 1e-4 and f_worst > 5e-3 * (1 + scale), (f_med, f_worst)
    # end to end: unit directions; the chordal mean is ill-conditioned at
    # random weights (tests/test_torch_model.py), so 99% within 2e-3
    d = head(torch.from_numpy(feat)).numpy()
    err = np.abs(d - np.asarray(jh.apply({"params": params}, jnp.asarray(feat))))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert np.quantile(err, 0.99) <= 2e-3 and err.max() <= 1e-2, err.max()


def _c1_inputs(seed=5):
    """A conv1-like plan at small size: 2 clouds of 200 points, 24 centers,
    12 neighbours, 60 anchors x 24 kernel points, 1-channel rows."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.5, 0.5, (2, 200, 3)).astype(np.float32)
    centers = xyz[:, :24].copy()
    radius, sigma = 0.2, 0.5 * 0.2 ** 2
    nbr = ball_query_torch(torch.from_numpy(centers), torch.from_numpy(xyz), radius,
                           12).numpy()
    rk = np.einsum("aij,kj->aki", get_anchors(), get_kernel_points(radius, 1))
    feats = rng.randn(2, 200, 60).astype(np.float32)
    gx = jax_group(jnp.asarray(xyz), jnp.asarray(nbr)) - jnp.asarray(centers)[:, :, None, :]
    return xyz, centers, nbr, feats, rk.reshape(-1, 3).astype(np.float32), sigma, gx


def test_interconv_c1_matches_xla():
    xyz, centers, nbr, feats, rk, sigma, gx = _c1_inputs()
    ref = np.asarray(interconv_t_xla(gx, jax_group(jnp.asarray(feats), jnp.asarray(nbr)),
                                     jnp.asarray(rk), sigma, 60))       # (B, c, A, K, 1)
    t = torch.from_numpy
    for fn in (interconv.interconv_t_c1_torch, interconv.interconv_t):
        out = fn(t(xyz), t(centers), t(nbr), t(feats), t(rk), sigma, 60).numpy()
        assert out.shape == ref.shape == (2, 24, 60, 24, 1)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_interconv_c1_bf16_matches_pallas():
    xyz, centers, nbr, feats, rk, sigma, gx = _c1_inputs()
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    ref = interconv_t_pallas(gx, jax_group(fb, jnp.asarray(nbr)), jnp.asarray(rk), sigma, 60,
                             interpret=True)
    t = torch.from_numpy
    out = interconv.interconv_t(t(xyz), t(centers), t(nbr), _bf(feats), t(rk), sigma, 60)
    assert out.dtype == BF16
    worst, med, scale = _errors(out.float().numpy(), np.asarray(ref, np.float32))
    assert worst <= 8e-3 * scale and med <= 1e-4, (worst, med)
