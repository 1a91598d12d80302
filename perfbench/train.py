"""The training loop: the step that `make_train_step` returns, back to back.

Set-up makes the weights and a pool of distinct synthetic batches from the
seed, builds the model and Adam, and drives the first three steps through
the window's own call on three different batches; from them it keeps each
step's loss, the first gradient's leaf norms (Adam's first moment after
step 1) and the leaf norms of the parameters' and BatchNorm statistics'
change after step 3.  The window then steps the same object on, cycling the
pool, until `seconds` have passed; the rate is every sample of every step
over the whole window.  After it the plain reference follows the three
checked steps from the same weights and batches (`compare.train_numbers`).
"""

from __future__ import annotations

import time

import torch

from perfbench import compare, core, inputs, trace
from perfbench.reference import net as ref_net
from perfbench.reference import train as ref_train

CHECKED_STEPS = 3
BETA1 = 0.9
PROFILED_STEPS = 2


def norms(tensors: dict) -> dict:
    """Leaf -> its float64 2-norm, read in one copy."""
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].double()) for k in names]).cpu()
    return dict(zip(names, vals.tolist()))


def build(cell, seed: int, device):
    """(model, state, optimizer, step, the weights on the host, pool)."""
    from etch_tpu_torch.models.etch_net import EtchNet
    from etch_tpu_torch.train.state import create_train_state, make_train_step

    ss = inputs.seed_streams(seed, 2)
    tr = cell.traffic
    ecfg = core.etch_config(cell.config)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in EtchNet(ecfg).state_dict().items()}
    weights = inputs.make_weights(shapes, inputs.torch_seed(ss[0]), device)
    model, state, opt = create_train_state(ecfg, device=device, state_dict=weights)
    step = make_train_step(model, opt, ecfg)
    pool = [inputs.capsule_batch(inputs.numpy_rng(s), tr["batch"], tr["points"])
            for s in ss[1].spawn(tr["pool"])]
    host_weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    return model, state, opt, step, host_weights, pool


def checked_steps(model, state, opt, step, weights, pool, device) -> dict:
    """The first CHECKED_STEPS steps on pool[0..2] through the window's
    call; the program's side of `compare.train_numbers`."""
    names = dict(model.named_parameters())
    buffers = {k: v for k, v in model.state_dict(keep_vars=True).items() if k not in names}
    losses, grad = [], None
    for s in range(CHECKED_STEPS):
        state, out = step(state, pool[s])
        losses.append(out["all_loss"])
        if s == 0:
            grad = norms({k: opt.state[p]["exp_avg"] / (1 - BETA1) for k, p in names.items()})
    w0 = {k: v.to(device) for k, v in weights.items()}
    change = norms({k: p.detach() - w0[k] for k, p in names.items()})
    moved = norms({k: b.detach() - w0[k] for k, b in buffers.items()})
    return {"losses": [float(x) for x in losses], "grad": grad, "change": change,
            "buffers": moved}


def reference_steps(cell, weights, param_names, pool, device, numerics=None,
                    half_batch: bool = False) -> dict:
    """The reference's side: CHECKED_STEPS steps from the same weights on
    the same batches.  `numerics` lowers its precision (the control);
    `half_batch` leaves out half of each batch (a planted fault)."""
    st = ref_train.TrainState({k: v.to(device) for k, v in weights.items()}, param_names)
    w0 = {k: v.to(device) for k, v in weights.items()}
    losses, grad = [], None
    for s in range(CHECKED_STEPS):
        b = {k: torch.as_tensor(v, device=device) for k, v in pool[s].items()}
        if half_batch:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        out = ref_train.train_step(st, cell.config, b, numerics)
        losses.append(float(out["all_loss"]))
        if s == 0:
            grad = norms(st.last_grads)
    return {"losses": losses, "grad": grad,
            "change": norms({k: v - w0[k] for k, v in st.params.items()}),
            "buffers": norms({k: v - w0[k] for k, v in st.buffers.items()})}


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float):
    from etch_tpu_torch import _build

    tr = cell.traffic
    B = tr["batch"]
    t_start = time.perf_counter()
    model, state, opt, step, weights, pool = build(cell, seed, device)
    t_built = time.perf_counter()
    param_names = [k for k, _ in model.named_parameters()]
    prog = checked_steps(model, state, opt, step, weights, pool, device)
    core.sync(device)
    setup_s = time.perf_counter() - t0
    core.log_setup(t0, t_start, t_built, time.perf_counter())

    spans = trace.Spans()
    clock = trace.train_clock(model, opt, spans) if traced else None
    losses, host_ms = [], []
    core.reset_peak(device)
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        if clock:
            clock.begin()
            spans.start("train.step")
        state, out = step(state, pool[(CHECKED_STEPS + i) % len(pool)])
        if clock:
            clock.mark("end", closes="train.guard")
            spans.stop("train.step")
            clock.end()
        losses.append(out["all_loss"])
        host_ms.append((time.perf_counter() - t) * 1e3)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    core.sync(device)
    window_s = time.perf_counter() - start
    core.log_calls("step (host, enqueued)", host_ms)
    peak = core.peak_bytes(device)
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    result = {"metrics": {"train_samples_per_s": B * len(losses) / window_s,
                          "setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30},
              "attempted": B * len(losses), "failed": B * bad, "peak": peak}

    if traced:
        layer_ms = {"forward": clock.elapsed_ms("fwd0", "fwd1"),
                    "backward": clock.elapsed_ms("fwd1", "opt0"),
                    "optim": clock.elapsed_ms("opt0", "end")}

        def one(j):
            nonlocal state
            clock.begin()
            spans.start("train.step")
            state, _ = step(state, pool[j % len(pool)])
            clock.mark("end", closes="train.guard")
            spans.stop("train.step")
            clock.end()

        prof = trace.profile_calls(
            one, PROFILED_STEPS,
            ("train.step", "train.forward", "train.backward", "train.optim", "train.guard"),
            _build)
        clock.remove()
        result["record"] = dict(kind="train", items_per_call=B, calls=len(losses),
                                window_s=window_s, layer_ms=layer_ms, profile=prof,
                                item_flops=None)

    del model, state, opt, step, losses
    core.free(device)
    ref = reference_steps(cell, weights, param_names, pool, device)
    result["numbers"] = compare.train_numbers(prog, ref)
    return result


def control_numbers(cell, weights, param_names, pool, device, ref) -> dict:
    """The control (the reference in TF32) and the planted half-batch fault,
    each in the program's place, against the reference's steps `ref`."""
    low = reference_steps(cell, weights, param_names, pool, device, ref_net.Numerics("tf32"))
    half = reference_steps(cell, weights, param_names, pool, device, half_batch=True)
    return {"control": compare.train_numbers(low, ref),
            "half_batch": compare.train_numbers(half, ref)}
