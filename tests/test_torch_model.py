"""PyTorch port vs JAX package, module by module, with the same weights.

The flax variables of `EtchNet(cfg).init` (BatchNorm statistics and scales
perturbed, so the eval affines are not identities) are converted with
`convert.flax_to_state_dict` (`torch_parity.paired_nets`); the JAX modules
run `model.apply(..., train=False)` under jit on the CPU (their f32 XLA
paths), the port runs its plain versions.  Tolerance: max |port - jax| <=
1e-4 * (1 + max |jax|), f32 rounding of sums taken in another order (the
intra conv's gather form vs the JAX block-sparse fold, per-head vs packed
attention) carried through the network.

Two places are ill-conditioned in both frameworks and are handled
explicitly:
  - the first block's skip branch instance-normalises a per-channel
    constant (a Dense of the all-ones occupancy input), so its output is
    f32 rounding noise times 1/sqrt(eps) = 316, different in each framework.
    The test zeroes that skip conv's weights, which makes the branch exactly
    zero in both.
  - at random weights the direction head's anchor weights are nearly
    uniform, so the chordal mean w @ anchors nearly cancels (the group's
    matrices sum to zero) and the SO(3) projection amplifies rounding: the
    end-to-end direction is held at 2e-4 for 99% of the points and 1e-2 for
    all of them (the head alone, on random features, is held at 1e-4)."""

import numpy as np
import pytest
import torch

from etch_tpu_torch.nn.point_transformer import unet_geometry
from torch_parity import (CFG_KW, N, _close, _close_forward, capsule, forward_and_encoder,
                          jax_apply, paired_nets)


@pytest.fixture(scope="module")
def models():
    return paired_nets(0, 7, **CFG_KW)


@torch.no_grad()
def test_epn_backbone(models):
    jm, variables, tm = models
    pts = capsule(0, 2, N)
    cloud, _ = jax_apply(jm, variables, pts, method=lambda m, x: m.encoder(x))
    xyz, feats = tm.encoder(torch.from_numpy(pts))
    np.testing.assert_array_equal(xyz.numpy(), cloud.xyz)
    _close(feats.numpy(), cloud.feats)


@torch.no_grad()
def test_direction_head(models):
    jm, variables, tm = models
    feat = np.random.RandomState(1).randn(2, N, 60, 8).astype(np.float32)
    ref = jax_apply(jm, variables, feat, method=lambda m, f: m.direction_head(f, train=False))
    _close(tm.direction_head(torch.from_numpy(feat)).numpy(), ref)


@torch.no_grad()
@pytest.mark.parametrize("head", ["magnitude", "confidence"])
def test_unet_heads(models, head):
    jm, variables, tm = models
    pts = capsule(2, 2, N)
    feat = np.random.RandomState(3).randn(2, N, 8).astype(np.float32)
    ref = jax_apply(jm, variables, pts, feat,
                    method=lambda m, p, f: getattr(m, f"{head}_head")(p, f, train=False))
    cfg = tm.cfg
    geom = unet_geometry(torch.from_numpy(pts), cfg.unet_strides, cfg.unet_nsamples)
    out = getattr(tm, f"{head}_encoder")(torch.from_numpy(pts), torch.from_numpy(feat), geom)
    if head == "magnitude":
        _close(out.numpy(), ref)
    else:
        _close(out[0].numpy(), ref[0])
        _close(out[1].numpy(), ref[1])


@torch.no_grad()
def test_etchnet_forward(models):
    jm, variables, tm = models
    pts = capsule(4, 2, N)
    ref = jax_apply(jm, variables, pts, train=False)
    out = tm(torch.from_numpy(pts))
    assert set(out) == {"direction", "magnitude", "part_labels", "confidences"}
    _close_forward(out, ref)


def _deeper_epn_forward(kw, width, key, seed, B, direction_q99=2e-4):
    """The port's encoder and whole forward against the JAX package's, the
    same converted weights and points, at a depth and widths of `kw` (the
    encoders' outputs taken from the forward pass on each side); the
    direction head alone on random features of the last block's width."""
    jm, variables, tm = paired_nets(key, seed, **kw)
    assert len(tm.encoder.names) == 2 * kw["epn_layer_num"]
    pts = capsule(5, B, N)
    out, (xyz, feats), ref, cloud = forward_and_encoder(jm, variables, tm, pts)
    assert feats.shape[-1] == width
    np.testing.assert_array_equal(xyz.numpy(), cloud.xyz)
    _close(feats.numpy(), cloud.feats)
    feat = np.random.RandomState(seed).randn(B, N, 60, width).astype(np.float32)
    head = jax_apply(jm, variables, feat, method=lambda m, f: m.direction_head(f, train=False))
    _close(tm.direction_head(torch.from_numpy(feat)).numpy(), head)
    _close_forward(out, ref, direction_q99)


# (kw, last block's width, init key, BatchNorm seed, B, the direction's q99)
DEEPER = {
    # epn_layer_num=3 (the reference CLI's --EPN_layer_num) with three EPN
    # blocks of tiny widths: the third block, the wider direction tokens and
    # the U-Nets' wider point features
    "three blocks": (dict(CFG_KW, epn_layer_num=3, epn_mlps=((8, 8), (8, 8), (16, 16))),
                     16, 1, 9, 2, 2e-4),
    # epn_layer_num=4 with four EPN blocks of tiny widths (8, 8, 16, 16): the
    # fourth block's sampling, ball radius and kernel sigma, and the network
    # after it
    "four blocks": (dict(CFG_KW, epn_layer_num=4, epn_mlps=((8, 8), (8, 8), (16, 16), (16, 16))),
                    16, 2, 10, 2, 2e-4),
    # epn_layer_num=4 at EPN's published widths 32, 64, 128, 256, one scan:
    # the 128- and 256-channel blocks and the direction head on E=256 tokens
    # (the tiny head's two heads of 128).  The head alone is held at 1e-4 as
    # everywhere; end to end the direction takes 1e-3 for 99% of the points,
    # since eight convs of up to 256 channels carry more rounding into the
    # SO(3) projection of a nearly cancelling chordal mean (2.8e-4 read here,
    # against 2e-4 at tiny widths)
    "four blocks, published widths": (dict(CFG_KW, batch_size=1, epn_layer_num=4,
                                           epn_mlps=None), 256, 3, 11, 1, 1e-3),
}


@torch.no_grad()
@pytest.mark.parametrize("depth", list(DEEPER))
def test_deeper_epn_forward(depth):
    """EPN's three and four blocks (--EPN_layer_num 3 and 4), at tiny and at
    published widths: the same model in both packages."""
    _deeper_epn_forward(*DEEPER[depth])
