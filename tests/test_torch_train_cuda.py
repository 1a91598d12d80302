"""The training path's kernels on the card (skipped without one).

Run on a machine with an H100 and nvcc:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py`
(tests/conftest.py imports jax).  Every test takes the `cuda` fixture.

  - each inter-conv autograd Function at small shapes: the kernel forward
    against the plain version (f32: 1e-5 of the largest value; bf16:
    1e-2 of it and a median relative error of 1e-3), and its gradients
    against the plain twin's autograd on the same cotangent (equal up to
    the order of the index backward's atomic sums);
  - a tiny train step on the card against the CPU, the same weights and
    batch: the loss to 1e-5 relative, the gradient leaves (those not zero
    by construction) with a median relative error of 1e-3, and exactly the
    f32 kernels launched.
"""

import statistics

import numpy as np
import pytest
import torch

from etch_tpu_torch import _build
from etch_tpu_torch.nn import interconv
from etch_tpu_torch.train.state import ZERO_GRADIENT, create_train_state, make_train_step
from etch_tpu_torch.train.synthetic import make_batch
from etch_tpu_torch.utils.config import EtchConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, C, dtype, seed=0, P=300, c=40, nn=24, A=60, K=24):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(2, P, 3, generator=g) * 0.3
    nbr = torch.randint(0, P, (2, c, nn), generator=g, dtype=torch.int32)
    rk = torch.randn(A * K, 3, generator=g) * 0.05
    feats = torch.randn(2, P, A * C, generator=g).to(dtype)
    w = torch.randn(K, 16, generator=g) * 0.2
    to = lambda t: t.to(dev).contiguous()
    return to(xyz), to(xyz[:, :c]), to(nbr), to(feats), to(rk), 0.02, A, to(w)


@pytest.mark.parametrize("kind", ["f32", "bf16", "c1_f32", "c1_bf16", "ones", "ones_proj"])
def test_function_forward_and_gradients(cuda, kind):
    C = 1 if kind.startswith(("c1", "ones")) else 32
    dt = torch.bfloat16 if kind.endswith("bf16") else torch.float32
    xyz, ctr, nbr, feats, rk, sg, A, w = _inputs(cuda, C, dt)
    plain_t = interconv.interconv_t_torch if C > 1 else interconv.interconv_t_c1_torch
    if kind == "ones":
        ins = (xyz, ctr)
        fn = lambda x, c: interconv.interconv_ones(x, c, nbr, rk, sg, A)
        plain = lambda x, c: interconv.interconv_ones_torch(x, c, nbr, rk, sg, A)
    elif kind == "ones_proj":
        ins = (xyz, ctr, w)
        fn = lambda x, c, ww: interconv.interconv_ones_proj(x, c, nbr, rk, sg, A, ww)
        plain = lambda x, c, ww: interconv.interconv_ones_proj_torch(x, c, nbr, rk, sg, A, ww)
    else:
        ins = (xyz, ctr, feats)
        fn = lambda x, c, f: interconv.interconv_t(x, c, nbr, f, rk, sg, A)
        plain = lambda x, c, f: plain_t(x, c, nbr, f, rk, sg, A)
    ins = [t.clone().requires_grad_(True) for t in ins]
    before = sum(_build.launches.values())
    out, ref = fn(*ins), plain(*ins)
    assert sum(_build.launches.values()) == before + 1
    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    if out.dtype == torch.bfloat16:
        assert err.max().item() <= 1e-2 * scale
        assert (err / (ref.float().abs() + 1e-2)).median().item() <= 1e-3
    else:
        assert err.max().item() <= 1e-5 * scale
    cot = torch.randn(out.shape, device=cuda).to(out.dtype)
    got = torch.autograd.grad(out, ins, cot)
    want = torch.autograd.grad(ref, ins, cot)
    for a, b in zip(got, want):
        tol = (1e-2 if a.dtype == torch.bfloat16 else 1e-5) * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol


def test_tiny_train_step_card_vs_cpu(cuda):
    cfg = EtchConfig.tiny(num_point=256, batch_size=2, unet_strides=(1, 2, 2, 2, 2))
    batch = make_batch(np.random.RandomState(3), 2, 256)
    batch["hitpts"] = (batch["hitpts"] * 0.5).astype(np.float32)

    def step(device):
        model, state, opt = create_train_state(cfg, seed=0, device=device)
        _, losses = make_train_step(model, opt, cfg)(state, batch)
        return float(losses["all_loss"]), {k: p.grad.cpu() for k, p in model.named_parameters()}

    cpu_loss, cpu = step("cpu")
    _build.reset_launch_counts()
    loss, card = step(cuda)
    ran = {k for k, v in _build.launches.items() if v}
    assert ran == {"fps", "knn", "ball_query", "interconv_ones", "interconv_t"}
    assert abs(loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    rel = [(card[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
           for k, g in cpu.items() if not ZERO_GRADIENT.search(k)]
    assert statistics.median(rel) <= 1e-3, statistics.median(rel)
