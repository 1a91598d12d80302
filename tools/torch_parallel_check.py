"""Data-parallel train steps of the PyTorch port against one rank.

`run(world, ...)` trains the port's `EtchNet` for a few steps on global
batches: with `world == 1` in this process, otherwise in `world` spawned
ranks (`parallel/mesh.py`: `make_mesh`, `replicate`, `shard_batch`), each
taking its slice of every global batch, as `cli/train_mixed.py` does.
Each rank starts from other weights (seed + rank), so the result also
shows that `replicate` broadcast rank 0's.  The same ranks then run one
step again from fresh weights with each planted fault asked for:

  - "sum": the gradients summed over the ranks, not averaged;
  - "local_bn": BatchNorm statistics of the rank's own shard;
  - "local_guard": the NaN guard (and the losses) on the rank's own loss.

Each rank returns its losses of every step, its gradients and buffers (the
BatchNorm running statistics) and the count of its all-reduces after the
first step, its parameters after the last, and, after `timed_steps` more
steps on the last batch (the first run only), their milliseconds (median)
and the rank's peak device memory.  `compare` reduces a run to
the numbers the checks read.  tests/test_torch_parallel.py runs it on the
CPU with gloo; chip_smoke.py phase 9 with two ranks on one card.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

def _summed(mesh, params):
    """The planted fault "sum": the ranks' gradients summed, not averaged."""
    from etch_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.average_gradients(mesh, params)
    for p in params:
        p.grad.mul_(mesh.world_size)


def rank_main(rank, world, init_method, device, backend, cfg_json, state_dict, batches,
              optimizer, lr, faults, timed_steps, out, threads):
    """One rank's runs, one for each entry of `faults` (None: sound), each
    from fresh weights; writes their results, in order, to `out`.<rank>."""
    if threads:   # a spawned rank
        torch.set_num_threads(threads)
    from etch_tpu_torch.parallel import mesh as mesh_mod
    from etch_tpu_torch.train import state as state_mod
    from etch_tpu_torch.utils.config import EtchConfig

    cfg = EtchConfig.from_json(cfg_json)
    mesh = mesh_mod.make_mesh(device, backend=backend, init_method=init_method, rank=rank,
                              world_size=world)
    sound = (state_mod.average_gradients, state_mod.global_means, mesh_mod._all_reduce_)
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return sound[2](*args)

    mesh_mod._all_reduce_ = counted
    try:
        results = []
        for i, fault in enumerate(faults):
            results.append(_train(rank, mesh, cfg, state_dict, batches, optimizer, lr, fault,
                                  timed_steps if i == 0 else 0, calls))
            state_mod.average_gradients, state_mod.global_means = sound[:2]
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        torch.save(results, f"{out}.{rank}")
    finally:
        mesh_mod._all_reduce_ = sound[2]
        mesh.close()


def _train(rank, mesh, cfg, state_dict, batches, optimizer, lr, fault, timed_steps, calls):
    from etch_tpu_torch.nn.point_transformer import bind_mesh
    from etch_tpu_torch.parallel.mesh import replicate, shard_batch
    from etch_tpu_torch.train import state as state_mod

    model, state, opt = state_mod.create_train_state(
        cfg, seed=cfg.seed + rank, device=mesh.device,
        state_dict=state_dict if rank == 0 else None)
    if optimizer == "sgd":
        state.optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    state = replicate(mesh, state)
    if fault == "sum":
        state_mod.average_gradients = _summed
    elif fault == "local_bn":
        bind_mesh(model, None)
    elif fault == "local_guard":
        state_mod.global_means = lambda mesh, values: values
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    step = state_mod.make_train_step(model, state.optimizer, cfg)
    result = {"losses": [], "staged": mesh.staged, "device": str(mesh.device)}
    for i, b in enumerate(batches if fault is None else batches[:1]):
        calls[0] = 0
        state, out_losses = step(state, shard_batch(mesh, b))
        result["losses"].append({k: float(v) for k, v in out_losses.items()})
        if i == 0:
            result["collectives"] = calls[0]
            result["grads"] = {n: p.grad.detach().cpu().clone()
                               for n, p in model.named_parameters()}
            result["buffers"] = {n: t.detach().cpu().clone() for n, t in model.named_buffers()}
    result["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    if timed_steps:
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        times = []
        for _ in range(timed_steps):
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            state, out_losses = step(state, shard_batch(mesh, batches[-1]))
            float(out_losses["all_loss"])
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        result["step_ms"] = statistics.median(times)
        if mesh.device.type == "cuda":
            result["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
    return result


def run(world, cfg, batches, optimizer="adam", lr=1e-3, faults=(None,), state_dict=None,
        device="cpu", backend=None, timed_steps=0, threads=1, timeout=600):
    """`world` ranks training `cfg`, from `state_dict` on rank 0 or the
    port's initialisation, a step on each of the global `batches` (numpy
    dicts), once for each entry of `faults` (None: sound; a planted fault
    takes the first batch only), in the same processes.  Returns, for each
    entry, the ranks' results (a list, rank order).  Several ranks are spawned processes joined through a file in
    a temporary directory; one rank runs in this process, without a fault."""
    if world == 1 and any(faults):
        raise ValueError("a planted fault needs spawned ranks")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        args = (world, f"file://{os.path.join(tmp, 'init')}", device, backend, cfg.to_json(),
                state_dict, batches, optimizer, lr, faults, timed_steps, out,
                threads if world > 1 else None)
        if world == 1:
            rank_main(0, *args)
        else:
            _spawn(world, rank_main, args, timeout)
        per_rank = [torch.load(f"{out}.{r}") for r in range(world)]
        return [[results[i] for results in per_rank] for i in range(len(faults))]


def cli_rank(rank, world, port, module, argv, out):
    """One rank of `python -m <module> <argv>` as torchrun starts it (the
    environment's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT); writes the final parameters and step to `out`.<rank>."""
    import importlib

    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    _, state = importlib.import_module(module).main(argv)
    torch.save({"params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
                "step": int(state.step)}, f"{out}.{rank}")


def run_cli(world, module, argv, timeout=600):
    """`module`'s CLI in `world` spawned ranks joined as under torchrun, on
    a free local port; returns each rank's final parameters and step."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        _spawn(world, cli_rank, (world, port, module, argv, out), timeout)
        return [torch.load(f"{out}.{r}") for r in range(world)]


def _spawn(world, target, args, timeout):
    """Run target(rank, *args) in `world` spawned processes; a rank that
    fails leaves the others waiting in a collective, so stop them all at
    the first failure, or at the deadline."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    while (any(p.is_alive() for p in procs) and time.time() < deadline
           and not any(p.exitcode for p in procs)):
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks failed or timed out after {timeout} s "
                           f"(rank, exit code): {failed}")


def _rel(a, b):
    """max |a - b| over max |b|, 0 where both are 0."""
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    return err / scale if scale > 0 else err


def compare(ranks, single, zero_gradient=None):
    """The numbers a check reads, of `ranks` against the one-rank `single`
    result: the largest relative loss difference over the steps, the
    largest leaf error of the first step's gradients relative to the leaf's
    largest value (leaves whose name `zero_gradient` matches, exact zeros
    with only rounding noise, left out) and their global norm-relative
    difference (tests/test_parallel_equiv.py's measure), the largest leaf
    error of its buffers and of the last parameters, and the largest
    difference between the ranks' last parameters."""
    r0 = ranks[0]
    loss = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
               for a, b in zip(r0["losses"], single["losses"]) for k in b)
    keep = [n for n in single["grads"] if zero_gradient is None or not zero_gradient.search(n)]
    g, g1 = r0["grads"], single["grads"]
    return {
        "loss": loss,
        "grads": max(_rel(g[n], g1[n]) for n in keep),
        "grads_global": float(np.sqrt(sum(float(((g[n] - g1[n]) ** 2).sum()) for n in g1)
                                      / max(sum(float((v ** 2).sum()) for v in g1.values()),
                                            1e-30))),
        "buffers": max(_rel(r0["buffers"][n], single["buffers"][n]) for n in single["buffers"]),
        "params": max(_rel(r0["params"][n], single["params"][n]) for n in single["params"]),
        "ranks_apart": max((r["params"][n] - r0["params"][n]).abs().max().item()
                           for r in ranks[1:] for n in r0["params"]) if len(ranks) > 1 else 0.0,
    }


def trajectory_deviation(p0, single, ranks):
    """The ranks' parameters' distance from the one-rank run's, over the
    one-rank run's distance from the initial parameters `p0` (global
    norms: tests/test_parallel_equiv.py's trajectory statement)."""
    num = sum(float(((ranks[0]["params"][n] - v) ** 2).sum()) for n, v in single["params"].items())
    den = sum(float(((v - p0[n]) ** 2).sum()) for n, v in single["params"].items())
    return float(np.sqrt(num / max(den, 1e-30)))
