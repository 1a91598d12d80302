"""What the port's Python side hands its redesigned kernels, on the CPU.

The tensor-core contraction (`csrc/interconv.cu`, bf16 rows) pads the kernel
points to 32 rows and the neighbours to a multiple of 16; the direction core
(`csrc/dircore.cu`) copies a packed, row-padded weight image into shared
memory and runs head sizes below 8 as masked 8-column tiles.  These tests
hold each of those choices to the plain versions' arithmetic, and hold the
pipeline's entry point to the card by default.  No card is needed.
"""

import inspect

import numpy as np
import pytest
import torch

from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn import dircore, interconv
from etch_tpu_torch.nn.bf16 import rnd
from etch_tpu_torch.ops.ball_query import ball_query_torch
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig


def test_build_pipeline_defaults_to_the_card():
    assert inspect.signature(build_pipeline).parameters["device"].default == "cuda"


def test_build_pipeline_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_pipeline(EtchConfig.tiny(num_point=64, batch_size=1), {"M0": 0},
                       allow_synthetic_body=True)


@pytest.mark.parametrize("E,V", [(64, 128), (8, 16)])
def test_dircore_packed_weights_unpack_to_the_params(E, V):
    """The packed image is the kernel's layout (75,776 bf16 values: seven
    64 x 72 matrices, then 64 x 136 and two 128 x 136) and holds every
    matrix, bf16-rounded, at its offset, with zeros in the padding."""
    g = np.random.RandomState(0)
    shapes = {**{n: (E, E) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")},
              "wc1": (E, V), "wm0": (V, V), "wm1": (V, V), "bc0": (E,), "bc1": (V,),
              "bm0": (V,), "bm1": (V,), "wr": (V, 1), "br": (1,)}
    params = {n: torch.tensor(g.randn(*s), dtype=torch.float32) for n, s in shapes.items()}
    w, f = dircore.pack_weights(params, "cpu")
    assert w.dtype == torch.bfloat16 and w.numel() == 7 * 64 * 72 + 64 * 136 + 2 * 128 * 136
    assert f.dtype == torch.float32 and f.numel() == 576
    layout = [(n, 64, 64) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")] + \
        [("wc1", 64, 128), ("wm0", 128, 128), ("wm1", 128, 128)]
    i = 0
    for n, rows, cols in layout:
        m = w[i:i + rows * (cols + 8)].reshape(rows, cols + 8).float()
        i += m.numel()
        r, c = shapes[n]
        torch.testing.assert_close(m[:r, :c], rnd(params[n]), rtol=0, atol=0)
        assert m[r:].abs().sum() == 0 and m[:, c:].abs().sum() == 0
    i = 0
    for n, width in (("bc0", 64), ("bc1", 128), ("bm0", 128), ("bm1", 128), ("wr", 128)):
        v = params[n].reshape(-1)
        torch.testing.assert_close(f[i:i + v.numel()], v, rtol=0, atol=0)
        assert f[i + v.numel():i + width].abs().sum() == 0
        i += width


@pytest.mark.parametrize("hs", [1, 2, 4])
def test_dircore_masked_head_tiles_are_exact(hs):
    """Head sizes below 8: q masked to one head's columns of an 8-column
    tile, times the whole tile of k, gives that head's logits exactly (the
    other columns add exact zeros), as the kernel's m16n8k8 products do."""
    g = np.random.RandomState(hs)
    q = rnd(torch.tensor(g.randn(16, 8), dtype=torch.float32))
    k = rnd(torch.tensor(g.randn(64, 8), dtype=torch.float32))
    for h in range(8 // hs):
        mask = torch.zeros(8)
        mask[h * hs:(h + 1) * hs] = 1
        cols = slice(h * hs, (h + 1) * hs)
        ref = q[:, cols].double() @ k[:, cols].double().T
        torch.testing.assert_close((q * mask).double() @ k.double().T, ref, rtol=0, atol=0)


def test_interconv_mma_geometry():
    """Shared memory of the tensor-core body at the main path's shapes (64
    neighbours, K=24): 42,240 bytes at C=32 (5 blocks an SM), 75,008 at C=64
    (3 blocks); unsupported widths raise."""
    assert interconv.mma_smem_bytes(64, 24, 32) == 42240
    assert interconv.mma_smem_bytes(64, 24, 64) == 75008
    for C in (8, 16, 32, 64):
        interconv.check_mma_geometry(64, 24, C)
    for nn, K, C in ((64, 24, 4), (64, 24, 12), (64, 24, 72), (64, 33, 32), (400, 24, 64)):
        with pytest.raises(ValueError):
            interconv.check_mma_geometry(nn, K, C)


@pytest.mark.parametrize("nn,C", [(11, 8), (64, 32)])
def test_interconv_mma_padding_is_exact(nn, C):
    """The tensor-core body's per-anchor GEMM on padded operands: K padded
    to 32 rows (any finite values, their rows are dropped), neighbours
    padded to a multiple of 16 with w = 0 and feature rows that hold any
    finite values (zeros at first, a staged output later).  It equals the
    plain contraction up to f32 summation order."""
    rng = np.random.RandomState(nn)
    B, P, c, A = 2, 200, 5, 60
    xyz = torch.tensor(rng.uniform(-0.5, 0.5, (B, P, 3)), dtype=torch.float32)
    ctr = xyz[:, :c].contiguous()
    nbr = ball_query_torch(ctr, xyz, 0.4, nn)
    kp = get_kernel_points(0.4, 1)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy())
    sigma = 0.5 * 0.4 ** 2
    feats = torch.tensor(rng.randn(B, P, A * C), dtype=torch.float32).to(torch.bfloat16)
    K = rk.shape[0] // A
    np_ = -(-nn // 16) * 16
    w = rnd(interconv._weights(xyz, ctr, nbr, rk, sigma)).reshape(B, c, nn, A, K)
    wt = torch.full((B, c, A, 32, np_), 3.0)                  # stale rows >= K
    wt[..., :K, :] = 0.0
    wt[..., :K, :nn] = w.permute(0, 1, 3, 4, 2)               # [k][n] per anchor
    ft = torch.full((B, c, A, np_, C), -2.0)                 # stale padded rows
    gf = torch.stack([feats[b][nbr[b].long()] for b in range(B)]).float()   # (B,c,nn,A*C)
    ft[..., :nn, :] = gf.reshape(B, c, nn, A, C).permute(0, 1, 3, 2, 4)
    t = (wt @ ft)[..., :K, :]
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, sigma, A).float()
    tb = t.to(torch.bfloat16).float()
    assert (tb - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert (tb == ref).float().mean() >= 0.99


@pytest.mark.parametrize("sigma", [0.0032, 0.0064, 0.0128, 0.045])
def test_markstein_quotient_is_the_ieee_quotient(sigma):
    """The tensor-core body forms d2 / sigma as q1 = d2 * RN(1 / sigma),
    q = fma(fma(-q1, sigma, d2), RN(1 / sigma), q1) (Markstein's correction).
    Emulated here with float64 products, which are exact for two float32
    factors, it gives the IEEE float32 quotient on every sample."""
    rng = np.random.default_rng(0)
    s = np.float32(sigma)
    rs = np.float32(1) / s
    d2 = (rng.random(200_000) * 0.1).astype(np.float32)
    q1 = d2 * rs
    r = (d2.astype(np.float64) - q1.astype(np.float64) * np.float64(s)).astype(np.float32)
    q = (q1.astype(np.float64) + r.astype(np.float64) * np.float64(rs)).astype(np.float32)
    assert np.array_equal(q, d2 / s)
