"""Spans and counters inside the program, off unless a caller turns them on.

`span(name)` marks a stretch of host time.  When tracing is on it opens
`torch.profiler.record_function(name)`, so the stretch lands in a
profiler's trace beside the device work launched inside it, and keeps a
record `(name, request id, parent index, start_ns, end_ns)` in memory.  The
record's times are `time.time_ns()`: the clock of the profiler's CPU events
(Unix epoch nanoseconds), read as the profiler range opens and closes.
`request(name)` opens a root span with a new id, which every span opened
inside it shares: one `run_batch`, one train step.  `count(name, n)` adds
to a host counter; `count_device(name, t)` adds a 0-dim tensor to a counter
held on t's device, which only `drain()` reads.  `drain()` returns what
was recorded and clears it; call it between requests, not inside one.

Off (the default), `span` and `request` return one shared no-op context
and the counters return at once: no profiler range, no clock read, no
allocation, no launch.

The open spans form one stack for the process, so a span opened on the
autograd engine's thread (a Function's backward on the card) nests under
the span that the thread calling `backward()` waits in.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

# Every span the program opens, and every counter it keeps.
SPAN_NAMES = (
    "pipeline.run_batch", "pipeline.predict", "fit.markers", "fit.lm0", "fit.lm1",
    "fit.lm.jacobian", "fit.lm.solve", "fit.smpl",
    "step", "step.loss", "step.backward", "step.allreduce", "step.adam", "step.guard",
    "interconv.backward",
    "net.encoder", "net.propagate", "net.confidence", "net.direction", "net.magnitude",
    "epn.block0", "epn.block1", "epn.block2", "epn.block3")
COUNTER_NAMES = ("fit.lm_iterations", "fit.lm.graph_captures", "fit.lm.graph_replays",
                 "step.skipped_updates", "dircore.wide_points", "interconv.slices",
                 "bf16.tc_products", "epn.norm_fused", "interconv.backward_wide")

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_on = False
_spans = []            # [name, request id, parent index, start_ns, end_ns]
_stack = []            # indices into _spans of the open spans, innermost last
_counts = {}
_device_counts = {}
_request_ids = itertools.count(1)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "rid", "rec", "index", "rf")

    def __init__(self, name: str, rid=None):
        self.name, self.rid = name, rid

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        start = time.time_ns()
        self.rf.__enter__()
        with _lock:
            parent = _stack[-1] if _stack else None
            rid = self.rid
            if rid is None and parent is not None:
                rid = _spans[parent][1]
            self.index = len(_spans)
            self.rec = [self.name, rid, parent, start, None]
            _spans.append(self.rec)
            _stack.append(self.index)
        return self

    def __exit__(self, *exc):
        self.rec[4] = time.time_ns()
        with _lock:
            if self.index < len(_spans) and _spans[self.index] is self.rec:
                _stack.remove(self.index)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking `name` (one of SPAN_NAMES)."""
    if not _on:
        return _NULL
    return _Span(name)


def request(name: str):
    """The root span of one request, with a new request id."""
    if not _on:
        return _NULL
    return _Span(name, next(_request_ids))


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name`."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-dim tensor t (bool or integer) to the int64 counter `name` on
    t's device: one launch, no host read."""
    if not _on:
        return
    acc = _device_counts.get(name)
    if acc is None:
        acc = _device_counts[name] = torch.zeros((), dtype=torch.int64, device=t.device)
    acc.add_(t)


def drain():
    """(spans, counters): the spans as tuples `(name, request id, parent
    index, start_ns, end_ns)` in the order they opened (a parent index
    points into the same list; a span still open has end None), and each
    counter's total (the device counters read here, once); both cleared."""
    with _lock:
        spans = [tuple(r) for r in _spans]
        _spans.clear()
        _stack.clear()
    counts = dict(_counts)
    counts.update({k: int(v) for k, v in _device_counts.items()})
    _counts.clear()
    _device_counts.clear()
    return spans, counts
