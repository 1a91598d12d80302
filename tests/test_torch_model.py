"""PyTorch port vs JAX package, module by module, with the same weights.

The flax variables of `EtchNet(cfg).init` (BatchNorm statistics and scales
perturbed, so the eval affines are not identities) are converted with
`convert.flax_to_state_dict`; the JAX modules run `model.apply(...,
train=False)` on the CPU (their f32 XLA paths), the port runs its plain
versions.  Tolerance: max |port - jax| <= 1e-4 * (1 + max |jax|), f32
rounding of sums taken in another order (the intra conv's gather form vs
the JAX block-sparse fold, per-head vs packed attention) carried through
the network.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.models.etch_net import EtchNet as JaxEtchNet
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.convert import flax_to_state_dict
from etch_tpu_torch.models.etch_net import EtchNet
from etch_tpu_torch.nn.point_transformer import unet_geometry
from etch_tpu_torch.utils.config import EtchConfig

N = 128
CFG_KW = dict(num_point=N, batch_size=2, unet_blocks=(1, 2, 1, 1, 3), dir_num_layers=2)


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


def _points(seed, B):
    rng = np.random.RandomState(seed)
    z = rng.uniform(-0.9, 0.9, (B, N))
    th = rng.uniform(0, 2 * np.pi, (B, N))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = JaxEtchNet(cfg=JaxConfig.tiny(**CFG_KW))
    v = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, N, 3)))
    rng = np.random.RandomState(7)
    variables = {"params": _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng),
                 "batch_stats": _perturb(jax.tree_util.tree_map(np.asarray, v["batch_stats"]), rng)}
    skip = variables["params"]["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"], skip["bias"] = np.zeros_like(skip["kernel"]), np.zeros_like(skip["bias"])
    cfg = EtchConfig.tiny(**CFG_KW)
    tm = EtchNet(cfg).eval()
    tm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"], cfg))
    return jm, variables, tm


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-4 * (1 + np.abs(ref).max()), f"max abs err {err}"


@torch.no_grad()
def test_epn_backbone(models):
    jm, variables, tm = models
    pts = _points(0, 2)
    cloud, _ = jm.apply(variables, jnp.asarray(pts), method=lambda m, x: m.encoder(x))
    xyz, feats = tm.encoder(torch.from_numpy(pts))
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(cloud.xyz))
    _close(feats.numpy(), cloud.feats)


@torch.no_grad()
def test_direction_head(models):
    jm, variables, tm = models
    feat = np.random.RandomState(1).randn(2, N, 60, 8).astype(np.float32)
    ref = jm.apply(variables, jnp.asarray(feat),
                   method=lambda m, f: m.direction_head(f, train=False))
    _close(tm.direction_head(torch.from_numpy(feat)).numpy(), ref)


@torch.no_grad()
@pytest.mark.parametrize("head", ["magnitude", "confidence"])
def test_unet_heads(models, head):
    jm, variables, tm = models
    pts = _points(2, 2)
    feat = np.random.RandomState(3).randn(2, N, 8).astype(np.float32)
    ref = jm.apply(variables, jnp.asarray(pts), jnp.asarray(feat),
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
    pts = _points(4, 2)
    ref = jm.apply(variables, jnp.asarray(pts), train=False)
    out = tm(torch.from_numpy(pts))
    assert set(out) == {"direction", "magnitude", "part_labels", "confidences"}
    for key in ("magnitude", "part_labels", "confidences"):
        _close(out[key].numpy(), ref[key])
    err = np.abs(out["direction"].numpy() - np.asarray(ref["direction"]))
    assert np.quantile(err, 0.99) <= 2e-4 and err.max() <= 1e-2, err.max()


DEEP_KW = dict(CFG_KW, epn_layer_num=3, epn_mlps=((8, 8), (8, 8), (16, 16)))
# four blocks (--EPN_layer_num 4): at tiny widths, and at EPN's published
# 32, 64, 128, 256 (the fourth block's radius and sigma, the E=256 tokens)
FOUR_KW = dict(CFG_KW, epn_layer_num=4, epn_mlps=((8, 8), (8, 8), (16, 16), (16, 16)))
FOUR_PUBLISHED_KW = dict(CFG_KW, batch_size=1, epn_layer_num=4, epn_mlps=None)


def _deeper_epn_forward(kw, width, key, seed, B, direction_q99=2e-4):
    """The port's encoder and whole forward against the JAX package's, the
    same converted weights and points, at a depth and widths of `kw`; the
    direction head alone on random features of the last block's width."""
    jm = JaxEtchNet(cfg=JaxConfig.tiny(**kw))
    v = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(key), jnp.zeros((1, N, 3)))
    rng = np.random.RandomState(seed)
    variables = {"params": _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng),
                 "batch_stats": _perturb(jax.tree_util.tree_map(np.asarray, v["batch_stats"]), rng)}
    skip = variables["params"]["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"], skip["bias"] = np.zeros_like(skip["kernel"]), np.zeros_like(skip["bias"])
    cfg = EtchConfig.tiny(**kw)
    tm = EtchNet(cfg).eval()
    tm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"], cfg))
    assert len(tm.encoder.names) == 2 * kw["epn_layer_num"]
    pts = _points(5, B)
    cloud, _ = jm.apply(variables, jnp.asarray(pts), method=lambda m, x: m.encoder(x))
    xyz, feats = tm.encoder(torch.from_numpy(pts))
    assert feats.shape[-1] == width
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(cloud.xyz))
    _close(feats.numpy(), cloud.feats)
    feat = np.random.RandomState(seed).randn(B, N, 60, width).astype(np.float32)
    head = jm.apply(variables, jnp.asarray(feat),
                    method=lambda m, f: m.direction_head(f, train=False))
    _close(tm.direction_head(torch.from_numpy(feat)).numpy(), head)
    ref = jm.apply(variables, jnp.asarray(pts), train=False)
    out = tm(torch.from_numpy(pts))
    for key in ("magnitude", "part_labels", "confidences"):
        _close(out[key].numpy(), ref[key])
    err = np.abs(out["direction"].numpy() - np.asarray(ref["direction"]))
    assert np.quantile(err, 0.99) <= direction_q99 and err.max() <= 1e-2, err.max()


@torch.no_grad()
def test_deeper_epn_forward():
    """epn_layer_num=3 (the reference CLI's --EPN_layer_num) with three EPN
    blocks of tiny widths: the third block, the wider direction tokens and
    the U-Nets' wider point features are the same model in both packages."""
    _deeper_epn_forward(DEEP_KW, 16, key=1, seed=9, B=2)


@torch.no_grad()
def test_four_block_epn_forward():
    """epn_layer_num=4 with four EPN blocks of tiny widths (8, 8, 16, 16):
    the fourth block's sampling, ball radius and kernel sigma, and the
    network after it, are the same model in both packages."""
    _deeper_epn_forward(FOUR_KW, 16, key=2, seed=10, B=2)


@torch.no_grad()
def test_four_block_epn_forward_published_widths():
    """epn_layer_num=4 at EPN's published widths 32, 64, 128, 256: the 128-
    and 256-channel blocks and the direction head on E=256 tokens (the tiny
    head's two heads of 128) against the JAX package, one scan.  The
    head alone is held at 1e-4 as everywhere; end to end the direction takes
    1e-3 for 99% of the points, since eight convs of up to 256 channels carry
    more rounding into the SO(3) projection of a nearly cancelling chordal
    mean (2.8e-4 read here, against 2e-4 at tiny widths)."""
    _deeper_epn_forward(FOUR_PUBLISHED_KW, 256, key=3, seed=11, B=1, direction_q99=1e-3)
