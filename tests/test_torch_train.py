"""PyTorch port vs JAX package: the training path on the CPU.

One JAX compile (module fixture): the value and gradient of the JAX train
loss (`model.apply(..., train=True, mutable=["batch_stats"])` then
`compute_losses`) at `EtchConfig.tiny`, N=128, B=2, with the JAX package's
random weights converted by `convert.flax_to_state_dict` (its gradients,
new batch statistics and Adam moments are mapped through the same bridge).
As in tests/test_torch_model.py, the first block's occupancy skip conv is
zeroed in both: its instance norm of a constant is f32 rounding noise
x 316 in JAX.

The inputs are `train/synthetic.py::make_batch` clouds scaled by 0.5 and
the U-Net strides are 2: at the unscaled N=128 some points' EPN tokens are
anchor-invariant, their chordal mean is the zero matrix, and JAX's gradient
is NaN there (the VJP of `jnp.linalg.norm` at an underflowed norm, inside
`quaternion_to_matrix`), while the port's is finite
(`test_gradients_finite_at_anchor_invariant_tokens`); at strides 4 the
coarsest level holds one point a cloud and its BatchNorms normalise two
values.

Tolerances:
  - losses of the step: 1e-5 relative; `compute_losses` alone: 1e-6.
  - gradients: every leaf within 1e-4 * max|g_jax| plus the rounding
    spread of both frameworks, each measured as the largest change of that
    leaf when the two clouds of the batch swap places (the same function,
    its sums in another order).  flax's fast variance E[x^2] - E[x]^2 in
    f32 at the magnitude U-Net's first BatchNorm moves some leaves by up to
    3% under that swap, in either framework (in float64 statistics, by
    3e-5); where both frameworks agree with themselves the 1e-4 bound
    rules.  Every gradient that JAX has nonzero is nonzero in the port.
    Leaves whose exact gradient is zero (a bias that a normalisation or a
    softmax removes: `train/state.py::ZERO_GRADIENT`) hold only rounding noise; the
    port's must stay below 1e-4 of the largest gradient.
  - one Adam step fed JAX's gradients: parameters and moments within 1e-6.
  - BatchNorm running statistics after the step: within 1e-5 of the leaf's
    scale (its largest |value|; a running mean's scale also counts the
    standard deviation its variance gives).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etch_tpu.train.losses import compute_losses as jax_compute_losses
from etch_tpu.train.state import create_train_state as jax_create_train_state
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.convert import flax_to_state_dict
from etch_tpu_torch.nn import interconv
from etch_tpu_torch.train.losses import compute_losses
from etch_tpu_torch.train.state import (ZERO_GRADIENT, _guarded_update, create_train_state,
                                        dynamic_targets, make_train_step,
                                        make_train_step_dynamic)
from etch_tpu_torch.train.synthetic import make_batch
from etch_tpu_torch.utils.config import EtchConfig

REPO = os.path.join(os.path.dirname(__file__), "..")
N, B = 128, 2
CFG_KW = dict(num_point=N, batch_size=B, unet_blocks=(1, 2, 1, 1, 2), dir_num_layers=2,
              unet_strides=(1, 2, 2, 2, 2))
def _batch(seed=0, scale=0.5):
    b = make_batch(np.random.RandomState(seed), B, N)
    b["hitpts"] = (b["hitpts"] * scale).astype(np.float32)
    b["vectors"] = (b["vectors"] * scale).astype(np.float32)
    return b


def _swap(batch):
    return {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def ref():
    cfg = JaxConfig.tiny(**CFG_KW)
    model, state, tx = jax_create_train_state(cfg, jax.random.PRNGKey(0), jnp.zeros((1, N, 3)))
    params, stats = _np(state.params), _np(state.batch_stats)
    skip = params["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"][:] = 0.0
    skip["bias"][:] = 0.0

    def loss_fn(p, bs, batch):
        out, mut = model.apply({"params": p, "batch_stats": bs}, batch["hitpts"], train=True,
                               mutable=["batch_stats"])
        losses = jax_compute_losses(cfg, out, batch["vectors"], batch["confidences"],
                                    batch["labels"])
        return losses["all_loss"], (losses, mut["batch_stats"], out)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    runs = []
    for batch in (_batch(), _swap(_batch())):
        (_, (losses, new_stats, out)), grads = step(params, stats, batch)
        runs.append(dict(losses={k: float(v) for k, v in losses.items()}, grads=_np(grads),
                         stats=_np(new_stats), out=_np(out)))
    opt_state = tx.init(params)
    updates, new_opt = tx.update(runs[0]["grads"], opt_state, params)
    tcfg = EtchConfig.tiny(**CFG_KW)
    bridge = lambda tree: flax_to_state_dict(tree, stats, tcfg)
    mu, nu = new_opt[0].mu, new_opt[0].nu
    return dict(cfg=tcfg, sd=flax_to_state_dict(params, stats, tcfg), runs=runs,
                grads=[bridge(r["grads"]) for r in runs],
                new_stats=flax_to_state_dict(params, runs[0]["stats"], tcfg),
                adam=dict(params=bridge(_np(optax.apply_updates(params, updates))),
                          exp_avg=bridge(_np(mu)), exp_avg_sq=bridge(_np(nu))))


def _port_step(ref, batch):
    """The port's loss and gradients on `batch`, from the converted weights."""
    model, state, _ = create_train_state(ref["cfg"], device="cpu", state_dict=ref["sd"])
    out = model(torch.from_numpy(batch["hitpts"]), train=True)
    losses = compute_losses(ref["cfg"], out, *(torch.from_numpy(batch[k]) for k in
                                               ("vectors", "confidences", "labels")))
    losses["all_loss"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return model, out, {k: float(v) for k, v in losses.items()}, grads


def _nudge(batch):
    """The batch's points moved by one rounding: each coordinate times
    1 + 2^-23 * (-1, 0 or 1), seeded."""
    sign = np.random.RandomState(5).randint(-1, 2, batch["hitpts"].shape)
    return dict(batch, hitpts=(batch["hitpts"] * (1 + 2.0 ** -23 * sign)).astype(np.float32))


@pytest.fixture(scope="module")
def port(ref):
    runs = [_port_step(ref, b) for b in (_batch(), _swap(_batch()), _nudge(_batch()))]
    return dict(model=runs[0][0], out=runs[0][1], losses=runs[0][2],
                grads=[r[3] for r in runs])


def test_synthetic_batch_is_the_harness_copy():
    """`train/synthetic.py::make_batch` is bit-equal to
    `tools/overfit_harness.py::make_batch`."""
    sys.path.insert(0, REPO)
    from tools import overfit_harness

    for seed, batch, n in ((0, 2, 64), (5, 3, 100)):
        ours = make_batch(np.random.RandomState(seed), batch, n)
        ref = overfit_harness.make_batch(np.random.RandomState(seed), batch, n)
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def test_compute_losses_match_jax():
    rng = np.random.RandomState(0)
    out = {"direction": rng.randn(B, N, 3), "magnitude": rng.randn(B, N, 1),
           "confidences": rng.rand(B, N, 1), "part_labels": rng.randn(B, N, 86)}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    vectors = rng.randn(B, N, 3).astype(np.float32)
    vectors[0, 0] = 0.0   # the cosine's clamped denominator
    conf = rng.rand(B, N, 1).astype(np.float32)
    labels = rng.randint(0, 86, (B, N)).astype(np.int32)
    cfg = dict(direction_w=2.0, magnitude_w=0.5, confidence_w=1.5, part_label_w=0.7)
    ref = jax_compute_losses(JaxConfig(**cfg), out, vectors, conf, jnp.asarray(labels))
    got = compute_losses(EtchConfig(**cfg), {k: torch.from_numpy(v) for k, v in out.items()},
                         torch.from_numpy(vectors), torch.from_numpy(conf),
                         torch.from_numpy(labels))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)


def test_train_losses_match_jax(ref, port):
    want = ref["runs"][0]["losses"]
    assert set(port["losses"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(port["losses"][k], v, rtol=1e-5, err_msg=k)


def test_train_gradients_match_jax(ref, port):
    g_jax, g_jax_sw = ref["grads"]
    g_port, g_port_sw, g_port_nudged = port["grads"]
    assert set(g_port) == {k for k, _ in port["model"].named_parameters()}
    top = max(v.abs().max().item() for v in g_jax.values())
    bad = []
    for name, g in g_port.items():
        gj = g_jax[name]
        scale = gj.abs().max().item()
        if ZERO_GRADIENT.search(name):
            if g.abs().max().item() > 1e-4 * top:
                bad.append((name, "structural zero", g.abs().max().item()))
            continue
        spread = ((gj - g_jax_sw[name]).abs().max().item()
                  + (g - g_port_sw[name]).abs().max().item()
                  + (g - g_port_nudged[name]).abs().max().item())
        err = (g - gj).abs().max().item()
        if not err <= 1e-4 * scale + spread:
            bad.append((name, err, scale, spread))
        if scale > 0 and g.abs().max().item() == 0:
            bad.append((name, "zero where JAX's is not"))
    assert not bad, bad


def test_batch_stats_after_step_match_jax(ref, port):
    sd = port["model"].state_dict()
    want = ref["new_stats"]
    keys = [k for k in sd if k.endswith(("running_mean", "running_var", "_mean", "_var"))
            and not k.endswith(("scale", "bias"))]
    assert len(keys) == len([k for k, v in want.items() if "mean" in k or "var" in k])
    for k in keys:
        var_key = k.replace("running_mean", "running_var").replace("_mean", "_var")
        scale = want[k].abs().max().item()
        if var_key != k:
            scale += want[var_key].max().item() ** 0.5
        err = (sd[k] - want[k]).abs().max().item()
        assert err <= 1e-5 * scale, (k, err, scale)
    # the running statistics moved once, however often a block was recomputed
    moved = [k for k in keys if not torch.equal(sd[k], ref["sd"][k])]
    assert len(moved) == len(keys)


def test_adam_step_fed_jax_gradients(ref):
    model, state, opt = create_train_state(ref["cfg"], device="cpu", state_dict=ref["sd"])
    for name, p in model.named_parameters():
        p.grad = ref["grads"][0][name].clone()
    _guarded_update(state, torch.tensor(1.0))
    assert int(state.step) == 1
    for name, p in model.named_parameters():
        st = opt.state[p]
        for got, key in ((p, "params"), (st["exp_avg"], "exp_avg"),
                         (st["exp_avg_sq"], "exp_avg_sq")):
            err = (got.detach() - ref["adam"][key][name]).abs().max().item()
            assert err <= 1e-6, (name, key, err)
        assert float(st["step"]) == 1.0


def _adam_tensors(state):
    out = []
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        out += [p.detach().clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                st["step"].clone()]
    return out


def test_nan_guard_skips_the_whole_update(ref):
    """A non-finite loss leaves the parameters and all Adam state
    bit-unchanged (the reference `continue`s past optimizer.step(),
    src/train.py:111-123) while the BN running statistics advance and the
    step counts; a clean batch through the same step then moves them."""
    cfg = ref["cfg"]
    model, state, opt = create_train_state(cfg, device="cpu", state_dict=ref["sd"])
    step = make_train_step(model, opt, cfg)
    state, _ = step(state, _batch())            # Adam's state is live, not zeros
    before = _adam_tensors(state)
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    nan_batch = dict(_batch(1), vectors=np.full((B, N, 3), np.nan, np.float32))
    state, losses = step(state, nan_batch)
    assert not torch.isfinite(losses["all_loss"])
    for a, b in zip(before, _adam_tensors(state)):
        assert torch.equal(a, b)
    assert int(state.step) == 2
    assert any(not torch.equal(v, model.state_dict()[k]) for k, v in stats.items())
    state, losses = step(state, _batch(1))
    assert torch.isfinite(losses["all_loss"])
    after = _adam_tensors(state)
    for i in range(4):   # parameters, both moments and Adam's step moved
        assert any(not torch.equal(a, b) for a, b in zip(before[i::4], after[i::4]))
    assert float(opt.state[next(model.parameters())]["step"]) == 2.0


def test_dynamic_targets_match_jax(ref, port):
    """make_train_step_dynamic's labels and confidences: the nearest marker
    to the predicted inner point, exp(-10 d); JAX's from its own outputs by
    its expressions (`etch_tpu/train/state.py:118-126`)."""
    rng = np.random.RandomState(4)
    markers = (rng.randn(B, 86, 3) * 0.1).astype(np.float32)
    out = ref["runs"][0]["out"]
    hit = _batch()["hitpts"]
    inner = hit - out["direction"] * out["magnitude"] / ref["cfg"].scale_magnitude
    d = np.asarray(jnp.linalg.norm(jnp.asarray(inner)[:, :, None, :] - markers[:, None], axis=-1))
    want_labels = np.asarray(jnp.argmin(d, axis=-1))
    want_conf = np.asarray(jnp.exp(-10.0 * jnp.min(d, axis=-1))[..., None])
    conf, labels = dynamic_targets(ref["cfg"], torch.from_numpy(hit),
                                   {k: v.detach() for k, v in port["out"].items()},
                                   torch.from_numpy(markers))
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    # the inner points carry the direction head's conditioning: held as
    # tests/test_torch_model.py holds the vectors, 1e-4 * (1 + max)
    assert np.abs(conf.numpy() - want_conf).max() <= 1e-4 * (1 + np.abs(want_conf).max())
    # the dynamic step runs and regenerates its targets from its own forward
    model, state, opt = create_train_state(ref["cfg"], device="cpu", state_dict=ref["sd"])
    state, losses = make_train_step_dynamic(model, opt, ref["cfg"])(
        state, dict(_batch(), markers_positions=markers))
    assert torch.isfinite(losses["all_loss"]) and int(state.step) == 1


def test_gradients_finite_at_anchor_invariant_tokens(ref):
    """At the unscaled clouds some points' EPN tokens are anchor-invariant:
    their chordal mean is the zero matrix.  The port's gradient there stays
    finite (JAX's is NaN)."""
    model, _, _ = create_train_state(ref["cfg"], device="cpu", state_dict=ref["sd"])
    batch = _batch(scale=1.0)
    seen = {}
    model.direction_head.register_forward_pre_hook(lambda m, a: seen.update(x=a[0]))
    out = model(torch.from_numpy(batch["hitpts"]), train=True)
    tok = seen["x"]
    assert ((tok - tok.mean(2, keepdim=True)).abs().amax((2, 3)) < 1e-4).any()
    compute_losses(ref["cfg"], out, *(torch.from_numpy(batch[k]) for k in
                                      ("vectors", "confidences", "labels")))["all_loss"].backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def _interconv_inputs(dtype, C, seed=0, P=40, c=6, nn=5, A=60):
    """Random geometry, K = 2 kernel points a rotation, sigma 0.1 (about
    half the weights inside the ReLU's support); the gradient checks take
    A = 3 rotations (the plain twins take any A), the twin checks the EPN's
    60."""
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.rand(2, P, 3, generator=g) * 0.3).to(dtype)
    centers = xyz[:, :c].clone()
    nbr = torch.randint(0, P, (2, c, nn), generator=g, dtype=torch.int32)
    rk = (torch.randn(A * 2, 3, generator=g) * 0.05).to(dtype)
    feats = torch.randn(2, P, A * C, generator=g).to(dtype)
    return xyz, centers, nbr, feats, rk, 0.1, A


def _gradcheck(fn, inputs):
    """gradcheck, and proof that it checked something: nonzero gradients."""
    assert torch.autograd.gradcheck(fn, inputs)
    out = fn(*inputs)
    grads = torch.autograd.grad(out, inputs, torch.ones_like(out))
    assert all(g.abs().max() > 0 for g in grads)


@pytest.mark.parametrize("C", [3, 1], ids=["contraction", "one_channel"])
def test_interconv_t_gradcheck(C):
    xyz, centers, nbr, feats, rk, sigma, A = _interconv_inputs(torch.float64, C, P=12, c=4, A=3)
    for t in (xyz, centers, feats):
        t.requires_grad_(True)
    _gradcheck(lambda x, ct, f: interconv.InterconvT.apply(x, ct, f, nbr, rk, sigma, A),
               (xyz, centers, feats))


def test_interconv_ones_gradcheck():
    xyz, centers, nbr, _, rk, sigma, A = _interconv_inputs(torch.float64, 1, P=12, c=4, A=3)
    xyz.requires_grad_(True)
    centers.requires_grad_(True)
    _gradcheck(lambda x, ct: interconv.InterconvOnes.apply(x, ct, nbr, rk, sigma, A),
               (xyz, centers))


def test_interconv_ones_proj_gradcheck():
    xyz, centers, nbr, _, rk, sigma, A = _interconv_inputs(torch.float64, 1, P=12, c=4, A=3)
    w = torch.randn(2, 4, dtype=torch.float64, requires_grad=True)
    xyz.requires_grad_(True)
    centers.requires_grad_(True)
    _gradcheck(lambda x, ct, ww: interconv.InterconvOnesProj.apply(x, ct, ww, nbr, rk, sigma, A),
               (xyz, centers, w))


@pytest.mark.parametrize("kind", ["f32", "bf16", "c1_f32", "c1_bf16", "ones", "ones_proj"])
def test_interconv_function_grads_equal_plain_twin(kind):
    """Each Function's gradients are its plain twin's autograd, bit for bit
    on the CPU, in the serving dtypes."""
    C = 1 if kind.startswith(("c1", "ones")) else 8
    xyz, centers, nbr, feats, rk, sigma, A = _interconv_inputs(torch.float32, C, seed=3)
    if kind.endswith("bf16"):
        feats = feats.to(torch.bfloat16)
    w = torch.randn(2, 4)

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in (xyz, centers, feats, w)]
        out = fn(*ins)
        cot = torch.linspace(-1, 1, out.numel()).reshape(out.shape).to(out.dtype)
        grads = torch.autograd.grad(out, ins, cot, allow_unused=True)
        return out, grads

    if kind in ("f32", "bf16", "c1_f32", "c1_bf16"):
        plain = interconv.interconv_t_torch if C > 1 else interconv.interconv_t_c1_torch
        got = run(lambda x, ct, f, ww: interconv.interconv_t(x, ct, nbr, f, rk, sigma, A))
        want = run(lambda x, ct, f, ww: plain(x, ct, nbr, f, rk, sigma, A))
    elif kind == "ones":
        got = run(lambda x, ct, f, ww: interconv.interconv_ones(x, ct, nbr, rk, sigma, A))
        want = run(lambda x, ct, f, ww: interconv.interconv_ones_torch(x, ct, nbr, rk, sigma, A))
    else:
        got = run(lambda x, ct, f, ww: interconv.interconv_ones_proj(x, ct, nbr, rk, sigma, A, ww))
        want = run(lambda x, ct, f, ww: interconv.interconv_ones_proj_torch(
            x, ct, nbr, rk, sigma, A, ww))
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert any(g is not None and g.abs().max() > 0 for g in got[1])


def test_bf16_train_step_runs(ref):
    """The bf16 policy's training forward (the occupancy conv with its
    projection and the bf16 contraction under their Functions, the train
    chains in bf16) gives finite losses and gradients, and a nonzero
    gradient to the first conv's projection through `InterconvOnesProj`."""
    cfg = ref["cfg"].replace(use_bfloat16=True)
    model, state, opt = create_train_state(cfg, device="cpu", state_dict=ref["sd"])
    state, losses = make_train_step(model, opt, cfg)(state, _batch())
    assert all(torch.isfinite(v) for v in losses.values())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert model.encoder.block0_conv0.inter.W.grad.abs().max() > 0
