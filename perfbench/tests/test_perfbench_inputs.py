"""The input generators and the frozen FLOP model."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import core, flops, inputs  # noqa: E402

SEEDS = (7, 2 ** 31 + 5)


def clouds(seed):
    ss = inputs.seed_streams(seed, 3)
    mesh = inputs.read_obj(inputs.SCAN)
    return inputs.scan_clouds(mesh, 2, 300, 1, np.random.default_rng(ss[1]))


def capsules(seed):
    ss = inputs.seed_streams(seed, 2)
    return [inputs.capsule_batch(inputs.numpy_rng(s), 2, 300) for s in ss[1].spawn(2)]


@pytest.mark.parametrize("seed", SEEDS)
def test_scans_repeat_by_seed(seed):
    a, b = clouds(seed), clouds(seed)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, clouds(seed + 1))
    assert a.shape == (2, 300, 3) and a.dtype == np.float32
    assert not np.array_equal(a[0], a[1])
    centre = (a.min(1) + a.max(1)) / 2
    np.testing.assert_allclose(centre, 0.0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_batches_repeat_by_seed(seed):
    a, b, c = capsules(seed), capsules(seed), capsules(seed + 1)
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k])
    assert not np.array_equal(a[0]["hitpts"], a[1]["hitpts"])
    assert not np.array_equal(a[0]["hitpts"], c[0]["hitpts"])


def test_capsule_batch_is_the_ports():
    from etch_tpu_torch.train.synthetic import make_batch
    got = inputs.capsule_batch(np.random.RandomState(3), 2, 64)
    want = make_batch(np.random.RandomState(3), 2, 64)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_body_and_scan_are_the_ports():
    from etch_tpu_torch.body.smpl import synthetic_body_model
    from etch_tpu_torch.data.mesh import load_obj
    body, want = inputs.synthetic_body(), synthetic_body_model(n_verts=6890)
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(body[k], getattr(want, k).numpy())
    assert body["parents"] == want.parents
    v, f = inputs.read_obj(inputs.SCAN)
    mesh = load_obj(str(inputs.SCAN))
    np.testing.assert_array_equal(v, mesh.vertices)
    np.testing.assert_array_equal(f, mesh.faces)


def test_weights_repeat_by_seed():
    shapes = {"a.W": (24, 8), "a.bias": (8,), "b.inter.bias": (8,), "c.weight": (16, 12),
              "c.running_var": (16,), "direction_head.wq0": (8, 8)}
    a, b = inputs.make_weights(shapes, 5, "cpu"), inputs.make_weights(shapes, 5, "cpu")
    c = inputs.make_weights(shapes, 6, "cpu")
    for k in shapes:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["c.weight"], c["c.weight"])
    assert float(a["b.inter.bias"][0]) == pytest.approx(1e-3)
    assert float(a["a.bias"].abs().max()) == 0.0 and float(a["c.running_var"].min()) == 1.0
    std = 1.0 / 12 ** 0.5 / 0.87962566103423978   # truncated at two of its deviations
    assert float(a["c.weight"].abs().max()) <= 2 * std + 1e-6


def test_flop_model_matches_tools_flops_report():
    from etch_tpu_torch.utils.config import EtchConfig
    cfg = dataclasses.asdict(EtchConfig())
    assert flops.forward_flops(cfg) / 1e9 == pytest.approx(187.28, abs=0.005)
    assert flops.fit_flops(cfg) / 1e9 == pytest.approx(1.57, abs=0.005)
    for name in ("etch-bf16", "etch-f32"):
        conf = core.load_cell({"etch-bf16": "etch-bf16.serve-b32",
                               "etch-f32": "etch-f32.train-b8"}[name]).config
        assert flops.forward_flops(conf) == pytest.approx(flops.forward_flops(cfg))


def test_plan_is_the_ports():
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    from perfbench.reference.plan import backbone_plan as frozen
    for cfg in (EtchConfig(), EtchConfig(epn_layer_num=4), EtchConfig.tiny()):
        assert frozen(dataclasses.asdict(cfg)) == backbone_plan(cfg)
