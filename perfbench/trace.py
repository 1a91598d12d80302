"""What a `--trace 1` run reads: layer times from CUDA events on the
program's module and optimizer hooks, and a short profiled stretch.

Spans are the benchmark's own `record_function` ranges around each layer
call, opened and closed by the same hooks: `serve.forward` (the network)
inside `serve.fit` (the rest of `run_batch`: markers, LM fit, SMPL);
`train.forward`, `train.backward` (loss and backward, up to the optimizer),
`train.optim` (Adam) and `train.guard` (the NaN guard after it), inside
`train.step`.  The profile stays in memory: the kernels' device intervals,
the host's launches, each labelled by the innermost span that launched it,
and the program's launch counts by shape (`_build.shape_launches`).
"""

from __future__ import annotations

import re
import time

import torch
from torch.autograd.profiler import record_function


class Spans:
    """Named `record_function` ranges opened and closed by hooks; at most
    one open range a name."""

    def __init__(self):
        self.open = {}

    def start(self, name: str) -> None:
        self.stop(name)
        rf = record_function(name)
        rf.__enter__()
        self.open[name] = rf

    def stop(self, name: str) -> None:
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


class LayerClock:
    """CUDA events on hooks: for each call between `begin` and `end`, the
    device milliseconds between named marks; a mark may also close one
    span and open the next."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.calls = []
        self.current = None
        self.handles = []

    def mark(self, name: str, opens: str = None, closes: str = None) -> None:
        if self.current is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.current[name] = ev
        if closes:
            self.spans.stop(closes)
        if opens:
            self.spans.start(opens)

    def begin(self) -> None:
        self.current = {}

    def end(self) -> None:
        self.calls.append(self.current)
        self.current = None

    def elapsed_ms(self, a: str, b: str):
        """Per call, the device milliseconds from mark a to mark b."""
        return [m[a].elapsed_time(m[b]) for m in self.calls if a in m and b in m]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def serve_clock(model: torch.nn.Module, spans: Spans) -> LayerClock:
    clock = LayerClock(spans)
    clock.handles = [
        model.register_forward_pre_hook(lambda *_: clock.mark("fwd0", opens="serve.forward")),
        model.register_forward_hook(lambda *_: clock.mark("fwd1", closes="serve.forward"))]
    return clock


def train_clock(model: torch.nn.Module, optimizer, spans: Spans) -> LayerClock:
    clock = LayerClock(spans)
    clock.handles = [
        model.register_forward_pre_hook(lambda *_: clock.mark("fwd0", opens="train.forward")),
        model.register_forward_hook(lambda *_: clock.mark("fwd1", closes="train.forward",
                                                          opens="train.backward")),
        optimizer.register_step_pre_hook(lambda *_: clock.mark("opt0", closes="train.backward",
                                                               opens="train.optim")),
        optimizer.register_step_post_hook(lambda *_: clock.mark("opt1", closes="train.optim",
                                                                opens="train.guard"))]
    return clock


# ---- the profiled stretch ---------------------------------------------


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{which}_us")() * 1000)


_LAUNCH = re.compile(r"(cudaLaunch|cuLaunch|cudaGraphLaunch)")


def _corr(e):
    fn = getattr(e, "correlation_id", None)
    return fn() if fn is not None else None


class Profile:
    """The reduction of one profiled stretch of `calls` calls.  Events are
    told apart by device and name alone (which torch versions agree on):
    on the card, the GPU side of a span carries the span's name, copies and
    sets are "Memcpy ..." and "Memset ...", the rest are kernels; on the
    host, spans by name and launches by the runtime call's name."""

    def __init__(self, events, span_names, window_s: float, calls: int, shapes: dict):
        self.window_s, self.calls = window_s, calls
        self.shape_launches = shapes
        spans, launch_at, device = [], {}, []
        for e in events:
            name = e.name()
            if "CUDA" in str(e.device_type()):
                if name not in span_names:
                    device.append((_ns(e, "start"), _ns(e, "end"), name, _corr(e),
                                   not name.startswith(("Memcpy", "Memset"))))
            elif name in span_names:
                spans.append((_ns(e, "start"), _ns(e, "end"), name))
            elif _LAUNCH.search(name):
                launch_at[_corr(e)] = _ns(e, "start")
        spans.sort(key=lambda s: s[1] - s[0])     # innermost first

        def label(t):
            for s, e, n in spans:
                if s <= t <= e:
                    return n
            return "outside"

        self.launches = {}
        for t in launch_at.values():
            lab = label(t)
            self.launches[lab] = self.launches.get(lab, 0) + 1
        device.sort()
        self.kernels = []         # (name, seconds, label) of each device kernel
        self.gaps = {}            # label -> idle seconds before its work
        busy, cur_s, cur_e = 0, None, None
        for s, e, name, corr, is_kernel in device:
            lab = label(launch_at[corr]) if corr in launch_at else "outside"
            if is_kernel:
                self.kernels.append((name, (e - s) * 1e-9, lab))
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    self.gaps[lab] = self.gaps.get(lab, 0.0) + (s - cur_e) * 1e-9
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy * 1e-9

    def device_ops(self, top: int = 10, width: int = 160):
        """The kernels that took most device time, by name (cut to `width`
        characters), with their seconds."""
        by = {}
        for name, sec, _ in self.kernels:
            by[name] = by.get(name, 0.0) + sec
        return [(n[:width], s) for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        return sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]


def profile_calls(run, calls: int, span_names, build) -> Profile:
    """Run `run(i)` for i < calls under torch.profiler (host and device),
    with the program's launch counts reset, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            run(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    shapes = {k: dict(v) for k, v in build.shape_launches.items() if v}
    return Profile(prof.profiler.kineto_results.events(), span_names, window, calls, shapes)
