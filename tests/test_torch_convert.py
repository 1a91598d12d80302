"""Weight bridge: every leaf of the flax variables of `EtchNet(cfg).init`
lands in exactly one key of the port's state_dict, with the right layout.

The config is `tiny()` with `unet_blocks` (1, 2, 1, 1, 3), so the
`nn.scan`-stacked `enc{l}_blocks` are unstacked at lengths 1 and 2, and
`dir_num_layers=2`, so the direction head's residual layer 0 exists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from etch_tpu.models.etch_net import EtchNet as JaxEtchNet
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.convert import flax_to_state_dict
from etch_tpu_torch.models.etch_net import EtchNet
from etch_tpu_torch.utils.config import EtchConfig

CFG_KW = dict(num_point=64, batch_size=1, unet_blocks=(1, 2, 1, 1, 3), dir_num_layers=2)


@pytest.fixture(scope="module")
def flax_vars():
    model = JaxEtchNet(cfg=JaxConfig.tiny(**CFG_KW))
    v = jax.jit(lambda r, x: model.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)))
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": v["batch_stats"]})


def test_every_leaf_consumed_once(flax_vars):
    cfg = EtchConfig.tiny(**CFG_KW)
    sd = flax_to_state_dict(flax_vars["params"], flax_vars["batch_stats"], cfg)
    model = EtchNet(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # a scan-stacked leaf of length n expands to n keys, the rest map 1:1
    leaves = jax.tree_util.tree_leaves_with_path(flax_vars)
    stacked = [leaf.shape[0] for path, leaf in leaves
               if any("_blocks" in str(getattr(k, "key", "")) for k in path)]
    assert sorted(set(stacked)) == [1, 2]
    assert len(sd) == len(leaves) + sum(n - 1 for n in stacked)


def test_layouts(flax_vars):
    cfg = EtchConfig.tiny(**CFG_KW)
    p, bs = flax_vars["params"], flax_vars["batch_stats"]
    sd = flax_to_state_dict(p, bs, cfg)
    unet = p["confidence_encoder"]["unet"]
    # Dense kernel (in, out) -> Linear weight (out, in)
    np.testing.assert_array_equal(sd["confidence_encoder.unet.enc1_down.Dense_0.weight"].numpy(),
                                  unet["enc1_down"]["Dense_0"]["kernel"].T)
    # scan-stacked block i -> enc{l}_blocks.{i}
    blk = unet["enc5_blocks"]["block"]
    for i in range(2):
        np.testing.assert_array_equal(
            sd[f"confidence_encoder.unet.enc5_blocks.{i}.linear1.weight"].numpy(),
            blk["linear1"]["kernel"][i].T)
        np.testing.assert_array_equal(
            sd[f"confidence_encoder.unet.enc5_blocks.{i}.bn1.running_var"].numpy(),
            bs["confidence_encoder"]["unet"]["enc5_blocks"]["block"]["bn1"]["var"][i])
    # EPN W and explicit weights keep their layout
    np.testing.assert_array_equal(sd["encoder.block0_conv1.inter.W"].numpy(),
                                  p["encoder"]["block0_conv1"]["inter"]["W"])
    np.testing.assert_array_equal(sd["direction_head.wq0"].numpy(),
                                  p["direction_head"]["wq0"])
    np.testing.assert_array_equal(sd["confidence_encoder.confi1_w"].numpy(),
                                  p["confidence_encoder"]["confi1_w"])


def test_unused_or_missing_leaves_raise(flax_vars):
    cfg = EtchConfig.tiny(**CFG_KW)
    p = dict(flax_vars["params"])
    p["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no such parameter"):
        flax_to_state_dict(p, flax_vars["batch_stats"], cfg)
    p = dict(flax_vars["params"])
    del p["direction_head"]
    with pytest.raises(KeyError, match="left unset"):
        flax_to_state_dict(p, flax_vars["batch_stats"], cfg)
