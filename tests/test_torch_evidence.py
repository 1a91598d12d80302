"""Model-quality evidence of the PyTorch port, on the CPU.

  - The port's scheduled Adam (`create_train_state(lr=
    cosine_decay_schedule(...))`) against the JAX package's
    `optax.adam(optax.cosine_decay_schedule(...))` through its own guard
    (`etch_tpu.train.state._guarded_update`), fed the same gradients for 12
    steps, one of them with a NaN loss and one with a NaN gradient entry:
    at every step the learning rate applied, the parameters and Adam's
    moments within 1e-6 and its count equal; the skipped step leaves the
    schedule where it was.
  - A short CPU run of tools/torch_overfit_harness.py's `train` (12 steps
    at `EtchConfig.tiny` widths, B=2, N=128) whose loss falls by a fifth, as
    tests/test_overfit.py::test_overfit_smoke asks of the JAX harness at
    full width (16 s a step on this host's CPU at full width).
  - The two artifacts of the port's card runs
    (tools/torch_overfit_evidence.py, tools/torch_realdata_closed_loop.py)
    held to the JAX gates of tests/test_overfit.py word for word, each from
    an H100 and with its tool's recipe.  A missing artifact fails.
  - The held-out generalization artifact of the card
    (tools/torch_generalization_evidence.py) held to the gates of
    tests/test_generalization.py word for word, on the tool's recipe; the
    port's synthetic body family bit-equal to the JAX harness's.
  - The closed loop's V2V to the oracle fit belongs to its markers, not to
    the port's fit: the 86 markers the card's trained evaluation fitted,
    fitted again on the CPU by the JAX package's LM and by the port's, land
    as far from their own framework's oracle fit as the card's fit did.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from etch_tpu.train.state import TrainState as JaxTrainState
from etch_tpu.train.state import _guarded_update as jax_guarded_update
from etch_tpu_torch.train.state import _guarded_update, cosine_decay_schedule, create_train_state
from etch_tpu_torch.utils.config import EtchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LR, DECAY, ALPHA, STEPS = 1e-3, 10, 0.05, 12
NAN_LOSS_STEP, NAN_GRAD_STEP = 5, 2


def test_scheduled_adam_matches_optax():
    cfg = EtchConfig.tiny(num_point=64, batch_size=1)
    model, state, opt = create_train_state(cfg, device="cpu",
                                           lr=cosine_decay_schedule(LR, DECAY, alpha=ALPHA))
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    schedule = optax.cosine_decay_schedule(LR, DECAY, alpha=ALPHA)
    tx = optax.adam(schedule)
    ref = JaxTrainState(params=params, batch_stats={}, opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    guard = jax.jit(lambda loss, grads, s: jax_guarded_update(tx, loss, grads, s, {}))
    rng = np.random.RandomState(0)
    lrs = []
    for i in range(STEPS):
        grads = {n: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
                 for n, v in params.items()}
        if i == NAN_GRAD_STEP:
            next(iter(grads.values())).flat[0] = np.nan
        loss = np.float32(np.nan if i == NAN_LOSS_STEP else 1.0)
        count = int(ref.opt_state[1].count)      # the schedule's count before the update
        ref = guard(loss, grads, ref)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        _guarded_update(state, torch.tensor(loss))
        lr = float(opt.param_groups[0]["lr"])
        lrs.append(lr)
        assert abs(lr - float(schedule(count))) <= 1e-6 * LR, (i, lr, float(schedule(count)))
        adam = ref.opt_state[0]
        assert int(adam.count) == int(ref.opt_state[1].count) == (i if i >= NAN_LOSS_STEP else i + 1)
        for n, p in model.named_parameters():
            st = opt.state[p]
            assert float(st["step"]) == int(adam.count), n
            for got, want, key in ((p.detach(), ref.params[n], "param"),
                                   (st["exp_avg"], adam.mu[n], "exp_avg"),
                                   (st["exp_avg_sq"], adam.nu[n], "exp_avg_sq")):
                err = np.abs(got.numpy() - np.asarray(want)).max()
                assert err <= 1e-6, (i, n, key, err)
    # the skipped step left the schedule where it was: the next update ran
    # at the skipped one's rate, and the last at the decayed floor
    assert lrs[NAN_LOSS_STEP + 1] == lrs[NAN_LOSS_STEP] < lrs[NAN_LOSS_STEP - 1]
    assert abs(lrs[-1] - ALPHA * LR) <= 1e-6 * LR


def test_overfit_harness_smoke():
    from etch_tpu_torch.train.synthetic import make_batch
    from tools import torch_overfit_harness as harness

    cfg = EtchConfig.tiny(num_point=128, batch_size=2, lr=harness.LR,
                          unet_strides=(1, 2, 2, 2, 2))
    batch = make_batch(np.random.RandomState(harness.SEED), 2, 128)
    result = harness.train(cfg, batch, 12, "cpu", seed=harness.SEED)
    losses = result["losses"]
    assert len(losses) == 12 and all(np.isfinite(l) for l in losses), losses
    assert losses[-1] < 0.8 * losses[0], f"no training progress in 12 steps: {losses}"
    assert np.isfinite(result["cosine"]) and result["train_seconds"] > 0


def _artifact(name, tool):
    path = os.path.join(REPO, "docs", "evidence", name)
    assert os.path.isfile(path), (
        f"docs/evidence/{name} is missing: run `python {tool}` on an H100 and commit it")
    with open(path) as f:
        r = json.load(f)
    assert "H100" in r["device"] and r["backend"] == "cuda", r["device"]
    assert r["train_seconds"] > 0
    return r


def test_overfit_h100_artifact():
    """tests/test_overfit.py::test_overfit_full_gate_artifact's gates, on
    the harness's recipe."""
    from tools import torch_overfit_harness as harness

    r = _artifact("overfit_h100.json", "tools/torch_overfit_evidence.py")
    assert r["steps"] >= 100
    assert ((r["steps"], r["n_point"], r["batch"], r["lr"], r["seed"])
            == (harness.STEPS, harness.N_POINT, harness.BATCH, harness.LR, harness.SEED)), r
    assert r["final"] < 0.05 * r["initial"], (
        f"overfit gate failed: {r['initial']:.4f} -> {r['final']:.4f} "
        f"({r['final'] / r['initial']:.1%} of initial)"
    )
    assert r["cosine"] > 0.95, f"direction cosine {r['cosine']:.4f} <= 0.95"


def test_realdata_closed_loop_h100_artifact():
    """tests/test_overfit.py::test_realdata_closed_loop_artifact's gates, on
    the tool's settings."""
    from tools import torch_realdata_closed_loop as loop

    r = _artifact("realdata_closed_loop_h100.json", "tools/torch_realdata_closed_loop.py")
    assert r["steps"] >= 100
    assert ((r["steps"], r["num_point"], r["batch"], r["lr"])
            == (loop.STEPS, loop.NUM_POINT, loop.BATCH, loop.LR)), r
    assert r["after"]["direction_cosine"] > 0.8, r["after"]
    assert r["after"]["direction_cosine"] > 2.0 * r["before"]["direction_cosine"]
    assert r["after"]["label_acc"] > 0.8, r["after"]
    assert r["after"]["marker_err_cm"] < 0.5 * r["before"]["marker_err_cm"], (
        r["before"], r["after"])
    assert r["v2v_oracle_cm_trained"] < 0.5 * r["v2v_oracle_cm_random"], (
        r["v2v_oracle_cm_random"], r["v2v_oracle_cm_trained"])
    assert r["marker_v2v_cm_trained"] < r["marker_v2v_cm_random"], (
        r["marker_v2v_cm_random"], r["marker_v2v_cm_trained"])


def test_realdata_closed_loop_fit_witness():
    """JAX's two-stage LM fed the port's trained markers lands within a
    quarter of the card's V2V to the oracle (both fits of the synthetic
    body, each against its own framework's fit to the GT markers), and so
    does the port's CPU fit; on the same markers the two frameworks' fits
    lie within a tenth of it of each other."""
    from etch_tpu.body.smpl import marker_submodel as jax_submodel
    from etch_tpu.body.smpl import smpl_forward as jax_forward
    from etch_tpu.fit.smpl_fit import fit_smpl_params as jax_fit
    from etch_tpu.pipeline import load_body_model as jax_body_model
    from etch_tpu_torch.body.smpl import marker_submodel, smpl_forward
    from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
    from etch_tpu_torch.pipeline import load_body_model
    from tools import torch_realdata_closed_loop as loop

    r = _artifact("realdata_closed_loop_h100.json", "tools/torch_realdata_closed_loop.py")
    with open(loop.MARKERSET) as f:
        markerset = json.load(f)
    vids = np.asarray(list(markerset.values()), np.int32)
    markers = np.asarray(r["trained_markers"], np.float32)
    valid = np.asarray(r["trained_markers_valid"], bool)
    assert markers.shape == (len(vids), 3) and valid.shape == (len(vids),)
    gt, everywhere = loop.gt_markers(markerset), np.ones(len(vids), bool)
    jbody = jax_body_model("neutral", root=REPO, allow_synthetic=True)
    body = load_body_model("neutral", root=REPO, allow_synthetic=True)

    def fit_jax(mk, ok):
        p = jax_fit(jax_submodel(jbody, vids), jnp.asarray(mk[None]), jnp.asarray(ok[None]))
        v, _ = jax_forward(jbody, p["betas"], p["pose"], p["global_orient"], p["transl"])
        return np.asarray(v[0])

    @torch.no_grad()
    def fit_port(mk, ok):
        p = fit_smpl_params(marker_submodel(body, vids), torch.from_numpy(mk[None]),
                            torch.from_numpy(ok[None]))
        v, _ = smpl_forward(body, p["betas"], p["pose"], p["global_orient"], p["transl"])
        return v[0].numpy()

    def cm(a, b):
        return float(np.mean(np.linalg.norm(a - b, axis=1))) * 100.0

    jax_trained, port_trained = fit_jax(markers, valid), fit_port(markers, valid)
    jax_cm = cm(jax_trained, fit_jax(gt, everywhere))
    port_cm = cm(port_trained, fit_port(gt, everywhere))
    apart_cm, card_cm = cm(jax_trained, port_trained), r["v2v_oracle_cm_trained"]
    print(f"V2V to the oracle, cm: card {card_cm}, JAX's fit on the CPU {jax_cm:.3f}, "
          f"the port's on the CPU {port_cm:.3f}; the two fits {apart_cm:.3f} apart")
    assert abs(jax_cm - card_cm) <= 0.25 * card_cm, (jax_cm, card_cm)
    assert abs(port_cm - card_cm) <= 0.25 * card_cm, (port_cm, card_cm)
    assert apart_cm <= 0.1 * card_cm, (apart_cm, card_cm)


def test_generalization_family_is_the_jax_copy():
    from tools import generalization_harness as jax_harness
    from tools import torch_generalization_harness as harness

    assert harness.marker_vertex_ids() == jax_harness.marker_vertex_ids()
    for seed in (0, 7, 105):
        for ours, ref in zip(harness.make_pair(seed), jax_harness.make_pair(seed)):
            np.testing.assert_array_equal(ours.vertices, ref.vertices)
            np.testing.assert_array_equal(ours.faces, ref.faces)


def test_generalization_h100_artifact():
    """tests/test_generalization.py::test_generalization_artifact's gates,
    on the tool's recipe."""
    from tools import torch_generalization_evidence as gen

    r = _artifact("generalization_h100.json", "tools/torch_generalization_evidence.py")
    c = r["config"]
    assert ((c["train_bodies"], c["eval_bodies"], c["samplings"], c["steps"], c["num_point"],
             c["batch"], c["lr"])
            == (len(gen.TRAIN_SEEDS), len(gen.EVAL_SEEDS), gen.SAMPLINGS, gen.STEPS,
                gen.NUM_POINT, gen.BATCH, gen.LR)), c
    assert c["eval_bodies"] >= 8
    assert c["train_bodies"] >= 8
    held = r["trained"]["heldout"]
    rnd = r["random"]["heldout"]
    assert held["direction_cosine"] > 0.9, held
    assert held["label_acc"] > 0.6, held
    assert held["marker_err_cm"] < 0.2 * rnd["marker_err_cm"], (held, rnd)
    assert held["v2v_oracle_cm"] < 0.35 * rnd["v2v_oracle_cm"], (held, rnd)
    assert all(r["gates"].values()), r["gates"]
    curve = r["learning_curve"]
    assert len(curve) >= 2
    ks = [c["k_train"] for c in curve]
    assert ks == sorted(ks) == list(gen.CURVE) + [len(gen.TRAIN_SEEDS)]
    accs = [c["heldout"]["label_acc"] for c in curve]
    assert accs[-1] >= max(accs[:-1]) - 0.1, accs
