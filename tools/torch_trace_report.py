#!/usr/bin/env python3
"""Where a serving batch's and a train step's time goes, by the program's own
spans (`etch_tpu_torch/utils/trace.py`), on one CUDA card.  From the root of
a checkout:

    python3 tools/torch_trace_report.py --cell etch-bf16.serve-b32 --seeds 11,12,13 \
        [--seconds 15] [--out trace_serve.json]

For each seed it builds the benchmark's cell as `perfbench/serve.py` or
`perfbench/train.py` does and warms it up, then runs four windows of
`--seconds` with tracing off, on, on, off (the cost of tracing: the rate
on against off), reads the program's spans and counters of the traced
windows, and profiles one batch (two steps) with torch.profiler, tracing on
and the benchmark's own hook ranges opened as a `perfbench/run.py --trace 1`
run opens them.  `reduce_events` reduces the profile twice: labelled by the
innermost benchmark range, as `perfbench/trace.py::Profile` labels it, and
by the innermost program span; idle gaps by the innermost range of either
set.  The numbers the program's spans give (`METRICS`: among them the
device ms a batch of each `net.*` span of the forward, and the points the
wide direction core served, the contractions' 64-channel slices and the
bf16 tensor-core products a batch) sit beside the benchmark's own reading
of the same batch, and beside the offset of each span's in-memory start
from its profiler range's (the two clocks).
Prints the card's name and power limit, then one JSON line a seed, and
writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from etch_tpu_torch.utils import trace  # noqa: E402

SERVE_RANGES = ("serve.fit", "serve.forward")
TRAIN_RANGES = ("train.step", "train.forward", "train.backward", "train.optim", "train.guard")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")
FIT_IDLE = ("fit.lm.jacobian", "fit.lm.solve", "fit.markers", "fit.smpl", "pipeline.predict")
NET_SPANS = tuple(n for n in trace.SPAN_NAMES if n.startswith("net."))


def _ns(e, which):
    fn = getattr(e, f"{which}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{which}_us")() * 1000)


def _corr(e):
    fn = getattr(e, "correlation_id", None)
    return fn() if fn is not None else None


def _labeller(spans):
    """t -> the name of the shortest span holding t ("outside" if none)."""
    spans = sorted(spans, key=lambda s: s[1] - s[0])

    def label(t):
        for s, e, n in spans:
            if s <= t <= e:
                return n
        return "outside"
    return label


def _innermost_op(ops):
    """t -> the name of the shortest ATen op holding t ("none" if none)."""
    import numpy as np

    start = np.array([o[0] for o in ops], np.int64)
    end = np.array([o[1] for o in ops], np.int64)

    def op_at(t):
        hold = np.flatnonzero((start <= t) & (t <= end))
        return ops[hold[np.argmin(end[hold] - start[hold])]][2] if hold.size else "none"
    return op_at


def _add(d, k, v):
    d[k] = d.get(k, 0) + v


def reduce_events(events, bench_names, program_names=trace.SPAN_NAMES):
    """The profiled stretch's events reduced by both span sets.  Device-side
    copies of either set's ranges are not device work.  Returns a dict:
    `launches` and `syncs` (host runtime calls) by innermost program span,
    `bench_launches` by innermost benchmark range, `sync_ops` by program
    span, innermost ATen op and runtime call, `kernel_s` (device
    seconds of kernels) by the program span that launched them, `gaps` (idle
    seconds before work) by the innermost range of either set that launched
    the work after the gap, `gap_pairs` by (benchmark range, program span),
    `busy_s`, and `ranges`: each program span's profiler range (name, start)."""
    named = set(bench_names) | set(program_names)
    bench, prog, launch_at, device, syncs, ops = [], [], {}, [], [], []
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            if name not in named:
                device.append((_ns(e, "start"), _ns(e, "end"), _corr(e),
                               not name.startswith(("Memcpy", "Memset"))))
        elif name in bench_names:
            bench.append((_ns(e, "start"), _ns(e, "end"), name))
        elif name in program_names:
            prog.append((_ns(e, "start"), _ns(e, "end"), name))
        elif name.startswith(LAUNCH):
            launch_at[_corr(e)] = _ns(e, "start")
        elif name in SYNCS:
            syncs.append((_ns(e, "start"), name))
        elif name.startswith("aten::"):
            ops.append((_ns(e, "start"), _ns(e, "end"), name))
    by_bench, by_prog, by_any = _labeller(bench), _labeller(prog), _labeller(bench + prog)
    out = {"launches": {}, "bench_launches": {}, "syncs": {}, "sync_ops": {}, "kernel_s": {},
           "gaps": {}, "gap_pairs": {}, "ranges": sorted((s, n) for s, _, n in prog)}
    for t in launch_at.values():
        _add(out["launches"], by_prog(t), 1)
        _add(out["bench_launches"], by_bench(t), 1)
    op_at = _innermost_op(ops)
    for t, api in syncs:
        _add(out["syncs"], by_prog(t), 1)
        _add(out["sync_ops"], f"{by_prog(t)} | {op_at(t)} | {api}", 1)
    device.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e, corr, is_kernel in device:
        t = launch_at.get(corr)
        if is_kernel:
            _add(out["kernel_s"], by_prog(t) if t is not None else "outside", (e - s) * 1e-9)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gap = (s - cur_e) * 1e-9
                if t is None:
                    lab, pair = "outside", ("outside", "outside")
                else:
                    lab, pair = by_any(t), (by_bench(t), by_prog(t))
                _add(out["gaps"], lab, gap)
                _add(out["gap_pairs"], pair, gap)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    out["busy_s"] = busy * 1e-9
    return out


# ---- what the program's spans give: one function a metric ---------------


def lm_ms(spans):
    """Host ms a batch inside `fit.lm0` and `fit.lm1`, over the batches
    (`pipeline.run_batch` requests) of the drained spans."""
    batches = sum(1 for s in spans if s[0] == "pipeline.run_batch")
    ms = sum(s[4] - s[3] for s in spans if s[0] in ("fit.lm0", "fit.lm1")) * 1e-6
    return ms / batches if batches else None


def span_ms(spans, calls):
    """Host ms a call inside each span name."""
    out = {}
    for s in spans:
        _add(out, s[0], (s[4] - s[3]) * 1e-6 / calls)
    return out


def lm_launches_per_iter(red, iterations):
    """Host launches under the `fit.lm*` spans of the profiled batch over its
    LM iterations (`fit.lm_iterations`).  A CUDA graph's replay is one
    launch (`cudaGraphLaunch`), whatever the kernels it holds."""
    n = sum(v for k, v in red["launches"].items() if k.startswith("fit.lm"))
    return n / iterations if iterations else None


def fit_syncs(red, calls):
    """Host synchronisations a batch under the `fit.*` spans."""
    return sum(v for k, v in red["syncs"].items() if k.startswith("fit.")) / calls


def per_call(counts, name, calls):
    """A counter's total over the calls it was read for."""
    return counts.get(name, 0) / calls


def interconv_backward_ms(red, calls):
    """Device ms a step of the kernels launched inside `interconv.backward`."""
    s = red["kernel_s"].get("interconv.backward", 0.0)
    return s * 1e3 / calls if s else None


def net_ms(red, calls):
    """Device ms a batch of the kernels launched inside each `net.*` span of
    the network forward (None for a span that launched none)."""
    return {n: red["kernel_s"][n] * 1e3 / calls if red["kernel_s"].get(n) else None
            for n in NET_SPANS}


METRICS = {"serve.lm_ms": ("fit.lm0", "fit.lm1"),
           "serve.lm_launches_per_iter": ("fit.lm0", "fit.lm1", "fit.lm.jacobian",
                                          "fit.lm.solve", "fit.lm_iterations"),
           "serve.fit_syncs": ("fit.markers", "fit.lm0", "fit.lm1", "fit.lm.jacobian",
                               "fit.lm.solve", "fit.smpl"),
           "fit.lm.graph_replays": ("fit.lm.graph_replays",),
           "fit.lm.graph_captures": ("fit.lm.graph_captures",),
           "serve.net_ms": NET_SPANS,
           "dircore.wide_points": ("dircore.wide_points",),
           "interconv.slices": ("interconv.slices",),
           "bf16.tc_products": ("bf16.tc_products",),
           "train.interconv_backward_ms": ("interconv.backward",),
           "train.skipped_updates": ("step.skipped_updates",)}


def clock_offsets_us(spans, ranges):
    """Each drained span's start less its profiler range's start, in µs,
    matched by name in the order they opened."""
    by = {}
    for s, n in ranges:
        by.setdefault(n, []).append(s)
    out = []
    for n, starts in by.items():
        mine = sorted(s[3] for s in spans if s[0] == n)
        if len(mine) == len(starts):
            out += [(a - b) * 1e-3 for a, b in zip(mine, starts)]
    return out


# ---- the card -----------------------------------------------------------


def _windows(call, seconds, sync):
    """Rates of four windows: tracing off, on, on, off; and the spans and
    counters of the traced ones, with their call count."""
    rates, spans, counts, n_on = [], [], {}, 0
    for on in (False, True, True, False):
        (trace.enable if on else trace.disable)()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            call(n)
            n += 1
        sync()
        rates.append(n / (time.perf_counter() - t0))
        trace.disable()
        s, c = trace.drain()
        if on:
            spans += s
            n_on += n
            for k, v in c.items():
                _add(counts, k, v)
    return rates, spans, counts, n_on


def _profile(run, calls, sync):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    sync()
    trace.drain()
    trace.enable()
    with profile(activities=acts) as prof:
        for i in range(calls):
            run(i)
        sync()
    trace.disable()
    return list(prof.profiler.kineto_results.events()), trace.drain()


def measure(cell_name, seed, seconds, device="cuda"):
    import torch

    from perfbench import core
    from perfbench import trace as bench

    cell = core.load_cell(cell_name)
    dev = torch.device(device)
    sync = lambda: core.sync(dev)  # noqa: E731
    spans_b = bench.Spans()
    serving = cell.traffic["kind"] == "serve"
    if serving:
        from perfbench import serve
        pipe, _, pool, *_ = serve.build(cell, seed, dev)
        serve.to_host(pipe.run_batch(pool[0]))

        def call(i):
            return serve.to_host(pipe.run_batch(pool[i % len(pool)]))
        clock, calls, names = bench.serve_clock(pipe.model, spans_b), 1, SERVE_RANGES

        def one(i):
            clock.begin()
            spans_b.start("serve.fit")
            call(i)
            spans_b.stop("serve.fit")
            clock.end()
    else:
        from perfbench import train
        model, state, opt, step, _, pool = train.build(cell, seed, dev)
        for i in range(train.CHECKED_STEPS):
            state, _ = step(state, pool[i])
        box = {"state": state}

        def call(i):
            box["state"], _ = step(box["state"], pool[i % len(pool)])
        clock, calls, names = bench.train_clock(model, opt, spans_b), 2, TRAIN_RANGES

        def one(i):
            clock.begin()
            spans_b.start("train.step")
            call(i)
            clock.mark("end", closes="train.guard")
            spans_b.stop("train.step")
            clock.end()
    sync()
    rates, spans, counts, n_on = _windows(call, seconds, sync)
    events, (p_spans, p_counts) = _profile(one, calls, sync)
    clock.remove()
    red = reduce_events(events, names)
    untouched = [e for e in events if e.name() not in trace.SPAN_NAMES]
    before = bench.Profile(untouched, names, 1.0, calls, {})
    offsets = sorted(abs(x) for x in clock_offsets_us(p_spans, red["ranges"]))
    out = {"cell": cell_name, "seed": seed, "rates_off_on_on_off": rates,
           "tracing_cost": 1 - (rates[1] + rates[2]) / (rates[0] + rates[3]),
           "counts_per_call": {k: v / n_on for k, v in counts.items()},
           "span_ms_per_call": span_ms(spans, n_on),
           "profiled": {"calls": calls, "counts": p_counts, "busy_s": red["busy_s"],
                        "launches": red["launches"], "syncs": red["syncs"],
                        "sync_ops": red["sync_ops"],
                        "kernel_s": red["kernel_s"], "gaps": red["gaps"],
                        "gap_pairs": {f"{a} | {b}": v for (a, b), v in red["gap_pairs"].items()}},
           "benchmark_reading": {"launches": before.launches, "gaps": before.gaps,
                                 "busy_s": before.busy_s},
           "clock_offset_us": {"n": len(offsets),
                               "median": statistics.median(offsets) if offsets else None,
                               "worst": offsets[-1] if offsets else None}}
    if serving:
        iters = per_call(p_counts, "fit.lm_iterations", calls)
        out["metrics"] = {"serve.lm_ms": lm_ms(spans),
                          "serve.lm_launches_per_iter": lm_launches_per_iter(
                              red, p_counts.get("fit.lm_iterations", 0)),
                          "serve.fit_syncs": fit_syncs(red, calls),
                          "fit.lm.graph_replays": per_call(p_counts, "fit.lm.graph_replays",
                                                           calls),
                          "fit.lm.graph_captures": per_call(p_counts, "fit.lm.graph_captures",
                                                            calls),
                          "fit.lm_iterations": iters,
                          "serve.net_ms": net_ms(red, calls),
                          "dircore.wide_points": per_call(p_counts, "dircore.wide_points",
                                                          calls),
                          "interconv.slices": per_call(p_counts, "interconv.slices", calls),
                          "bf16.tc_products": per_call(p_counts, "bf16.tc_products", calls)}
        fit_idle = sum(v for (b, _), v in red["gap_pairs"].items() if b == "serve.fit")
        named = sum(v for (b, p), v in red["gap_pairs"].items()
                    if b == "serve.fit" and p in FIT_IDLE)
        out["serve_fit_idle_named_share"] = named / fit_idle if fit_idle else None
    else:
        out["metrics"] = {"train.interconv_backward_ms": interconv_backward_ms(red, calls),
                          "train.skipped_updates": counts.get("step.skipped_updates", 0)}
    return out


def main(argv=None):
    import gc

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", default="11,12,13")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = measure(args.cell, seed, args.seconds)
        print(json.dumps(res), flush=True)
        results.append(res)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
