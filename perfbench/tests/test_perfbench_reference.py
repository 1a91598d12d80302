"""The frozen plain reference against the port's CPU path (its plain
versions) at `EtchConfig.tiny()` widths: the forward, the fit and one
training step; and its control numerics."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import core, inputs  # noqa: E402
from perfbench.reference import fit as ref_fit  # noqa: E402
from perfbench.reference import net as ref_net  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402


def tiny():
    from etch_tpu_torch.utils.config import EtchConfig
    cfg = dataclasses.asdict(EtchConfig.tiny(num_point=256))
    return cfg, core.etch_config(cfg)


def weights_for(ecfg, seed=3):
    from etch_tpu_torch.models.etch_net import EtchNet
    model = EtchNet(ecfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = inputs.make_weights(shapes, seed, "cpu")
    model.load_state_dict(w)
    return model, w


def scans(n, seed=0):
    mesh = inputs.read_obj(inputs.SCAN)
    return torch.as_tensor(inputs.scan_clouds(mesh, n, 256, 1, np.random.default_rng(seed)))


def test_forward_equals_the_port():
    cfg, ecfg = tiny()
    model, w = weights_for(ecfg)
    pts = scans(2)
    with torch.no_grad():
        got = model.eval()(pts)
    ref = ref_net.forward(ref_net.Ctx(w, cfg), pts)
    for k in ("direction", "magnitude", "part_labels", "confidences"):
        torch.testing.assert_close(ref[k], got[k], rtol=1e-5, atol=1e-6)


def test_fit_equals_the_port():
    from etch_tpu_torch.body.smpl import SMPLModel
    from etch_tpu_torch.fit.smpl_fit import fit_smpl

    cfg, ecfg = tiny()
    model, w = weights_for(ecfg)
    pts = scans(2, seed=1)
    out = ref_net.predict(w, cfg, pts)
    body = inputs.synthetic_body()
    bt = inputs.body_tensors(body, "cpu")
    prog_body = SMPLModel(**{k: bt[k] for k in ("v_template", "shapedirs", "posedirs",
                                                "J_regressor", "lbs_weights")},
                          parents=body["parents"], faces=body["faces"],
                          landmark_ids=body["landmark_ids"])
    vids = inputs.marker_vids(6890)
    args = (out["inner_points"], out["part_labels"], out["confidences"])
    v_p, p_p, m_p, _, j_p = fit_smpl(prog_body, vids, *args, steps_stage0=5, steps_stage1=5)
    cfg_short = {**cfg, "fit_steps_stage0": 5, "fit_steps_stage1": 5}
    v_r, p_r, m_r, _, j_r = ref_fit.fit(bt, vids, cfg_short, *args)
    torch.testing.assert_close(m_r, m_p, rtol=0, atol=0)
    torch.testing.assert_close(v_r, v_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(j_r, j_p, rtol=1e-5, atol=1e-6)


def test_train_step_equals_the_port():
    from etch_tpu_torch.train.state import create_train_state, make_train_step

    cfg, ecfg = tiny()
    _, w = weights_for(ecfg, seed=4)
    model, state, opt = create_train_state(ecfg, device="cpu", state_dict=w)
    step = make_train_step(model, opt, ecfg)
    batch = inputs.capsule_batch(np.random.RandomState(0), 2, 256)
    state, losses = step(state, batch)
    names = dict(model.named_parameters())
    st = ref_train.TrainState(w, list(names))
    ref = ref_train.train_step(st, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ref:
        torch.testing.assert_close(ref[k], losses[k], rtol=1e-6, atol=0)
    med = torch.stack([g.norm() for g in st.last_grads.values()]).median()
    for k, p in names.items():
        g_prog = opt.state[p]["exp_avg"] / 0.1
        assert float((g_prog - st.last_grads[k]).norm()) <= 1e-4 * max(
            float(st.last_grads[k].norm()), float(med)), k
    for k, b in model.state_dict().items():
        if k not in names:
            torch.testing.assert_close(st.buffers[k], b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["fp8", "tf32", None])
def test_numerics(kind):
    num = ref_net.Numerics(kind)
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    err = float((num.q(x) - x).abs().max() / x.abs().max())
    if kind == "fp8":
        assert 1e-3 < err < 0.07      # 3 mantissa bits, per-tensor scale
    else:
        assert err == 0.0
    with num.scope():
        assert torch.backends.cuda.matmul.allow_tf32 == (kind == "tf32")
    assert not torch.backends.cuda.matmul.allow_tf32
