"""The EPN conv block's norm, activation and skip sum (`nn/epn.py::norm_act`)
on the CPU: bit for bit the plain ops the block ran before the fused kernel.

On the CPU, and wherever autograd records the call, `norm_act(x, slope,
residual)` is `leaky_relu(instance_norm_pa(x), slope)` (+ residual) and
counts no `epn.norm_fused`; `SeparableSO3ConvBlock` gives the same bits as
its three norms, activations and sum written out.  The kernel itself is
held to the same plain twin on the card (`tests/test_torch_kernels_cuda.py`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from etch_tpu_torch.models.etch_net import init_params
from etch_tpu_torch.nn import epn
from etch_tpu_torch.ops import gather_points
from etch_tpu_torch.utils import trace
from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
from torch_parity import capsule


@pytest.fixture(autouse=True)
def tracer_on():
    trace.drain()
    trace.enable()
    yield
    trace.disable()
    trace.drain()


def _inputs(B, P, C, seed, grad=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, P, 60, C, generator=g) * 3 + 0.5
    x[..., 0] = 0.37   # a constant channel, as the first block's skip branch
    r = torch.randn(B, P, 60, C, generator=g)
    return x.requires_grad_(grad), r.requires_grad_(grad)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("residual", [False, True], ids=["act", "act_residual"])
@pytest.mark.parametrize("B,P,C", [(2, 9, 8), (1, 5, 12), (3, 4, 5), (2, 3, 1)])
def test_norm_act_on_the_cpu_is_the_plain_ops(B, P, C, residual, grad):
    x, r = _inputs(B, P, C, seed=B * P * C, grad=grad)
    with torch.set_grad_enabled(grad):
        got = epn.norm_act(x, 0.01, r if residual else None)
        want = F.leaky_relu(epn.instance_norm_pa(x), 0.01)
        if residual:
            want = r + want
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, want)
    if C > 1:
        assert torch.equal(got[..., 0], r[..., 0] if residual else torch.zeros_like(r[..., 0]))
    if grad:
        assert got.grad_fn is not None
    assert "epn.norm_fused" not in trace.drain()[1]


def test_norm_act_cuda_refuses_a_cpu_tensor():
    x, _ = _inputs(1, 2, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        epn.norm_act_cuda(x, 0.01)
    assert "epn.norm_fused" not in trace.drain()[1]


@pytest.mark.parametrize("B,rows,C", [(32, 150000, 32), (32, 75000, 64), (32, 37500, 128),
                                      (32, 18780, 256), (8, 150000, 32), (1, 150000, 32),
                                      (2, 18780, 12), (3, 2400, 5), (2, 60, 1027), (1, 60, 1)])
def test_norm_splits(B, rows, C):
    """A launch's row splits: at least one, at most one a row lane (none
    empty), and about _NORM_BLOCKS blocks a pass unless a thread would take
    fewer than _NORM_ROWS rows; at the four-block cell's B=32 shapes, 33
    (the fastest of those timed on the H100)."""
    vec = 4 if C % 4 == 0 else 1
    splits = epn.norm_splits(B, rows, C, vec)
    groups = C // vec
    tile = min(groups, epn._NORM_THREADS)
    lanes, tiles = epn._NORM_THREADS // tile, -(-groups // tile)
    assert 1 <= splits <= -(-rows // lanes)
    assert (splits * B * tiles >= epn._NORM_BLOCKS
            or splits == max(1, -(-rows // (lanes * epn._NORM_ROWS))))
    if B == 32:
        assert splits == 33


def _block_by_hand(block, xyz, feats):
    """SeparableSO3ConvBlock.forward with its norms, activations and sum
    written out as the plain ops."""
    act = lambda h: F.leaky_relu(h, block.negative_slope)
    new_xyz, x, sample_idx = block.inter(xyz, feats)
    h = act(epn.instance_norm_pa(x))
    h = act(epn.instance_norm_pa(block.intra(h)))
    skip = feats if block.stride == 1 else gather_points(feats, sample_idx)
    return new_xyz, h + act(epn.instance_norm_pa(block.skip_conv(skip)))


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_conv_blocks_unchanged_bit_for_bit(bf16, grad):
    """Every block of a small EPN, fed the previous block's output: the same
    bits as the plain ops written out, the first block's skip branch (a
    normalised constant) exactly 0, and no fused norm counted."""
    cfg = EtchConfig.tiny(num_point=128, batch_size=2, epn_mlps=((8, 12), (16, 16)))
    enc = epn.EPNBackbone(backbone_plan(cfg), torch.bfloat16 if bf16 else None)
    with torch.no_grad():
        init_params(enc, torch.Generator().manual_seed(5))
    xyz = torch.from_numpy(capsule(np.random.RandomState(2), 2, 128))
    feats = torch.ones((2, 128, 60, 1))
    with torch.set_grad_enabled(grad):
        for name in enc.names:
            block = getattr(enc, name)
            new_xyz, got = block(xyz, feats)
            want_xyz, want = _block_by_hand(block, xyz, feats)
            assert torch.equal(new_xyz, want_xyz) and torch.equal(got, want), name
            assert (got.grad_fn is not None) == grad
            if name == enc.names[0]:
                skip = gather_points(feats, block.inter(xyz, feats)[2])
                s = epn.instance_norm_pa(block.skip_conv(skip))
                assert s.abs().max().item() == 0.0
            xyz, feats = new_xyz, got
    assert "epn.norm_fused" not in trace.drain()[1]
