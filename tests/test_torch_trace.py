"""The port's spans and counters (`etch_tpu_torch/utils/trace.py`) on the CPU:
off, they record nothing and never open a profiler range; on, they change
no number the program computes and give the span tree of a serving batch
and of a train step; and the reduction of `tools/torch_trace_report.py`
on made-up profiler events."""

import threading

import numpy as np
import pytest
import torch

from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.train.state import create_train_state, make_train_step
from etch_tpu_torch.train.synthetic import make_batch
from etch_tpu_torch.utils import trace
from etch_tpu_torch.utils.config import EtchConfig
from tools import torch_trace_report as report

N, B = 256, 2
STEPS0, STEPS1 = 3, 4
SERVE_KW = dict(num_point=N, batch_size=B, fit_steps_stage0=STEPS0, fit_steps_stage1=STEPS1)
TRAIN_N = 128
TRAIN_KW = dict(num_point=TRAIN_N, batch_size=B, unet_blocks=(1, 2, 1, 1, 2), dir_num_layers=2,
                unet_strides=(1, 2, 2, 2, 2))


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _markerset():
    return {f"M{i}": int(v) for i, v in enumerate(np.linspace(0, 6889, 86).astype(int))}


def _points(seed=0):
    rng = np.random.RandomState(seed)
    z = rng.uniform(-0.9, 0.9, (B, N))
    th = rng.uniform(0, 2 * np.pi, (B, N))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pipe():
    return build_pipeline(EtchConfig.tiny(**SERVE_KW), _markerset(), allow_synthetic_body=True,
                          rng_seed=3, device="cpu")


def _batch(seed=0):
    b = make_batch(np.random.RandomState(seed), B, TRAIN_N)
    return {k: (v * 0.5).astype(np.float32) if k in ("hitpts", "vectors") else v
            for k, v in b.items()}


def _train(steps):
    """A fresh tiny train state (seeded weights) and the given batches'
    steps: (model, losses of each step)."""
    cfg = EtchConfig.tiny(**TRAIN_KW)
    model, state, opt = create_train_state(cfg, seed=1, device="cpu")
    step = make_train_step(model, opt, cfg)
    losses = []
    for batch in steps:
        state, out = step(state, batch)
        losses.append(out)
    return model, losses


def _tree(spans):
    """name -> names of its children, in order, over the drained spans."""
    kids = {}
    for name, _, parent, _, _ in spans:
        if parent is not None:
            kids.setdefault(spans[parent][0], []).append(name)
    return kids


def _raise(*a, **k):
    raise AssertionError("record_function entered with tracing off")


def test_off_records_nothing_and_opens_no_profiler_range(pipe, monkeypatch):
    # torch.profiler's name, the one the tracer opens (torch.optim's own
    # ranges go through torch.autograd.profiler's)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    pipe.run_batch(_points())
    _train([_batch()])
    assert trace.drain() == ([], {})
    assert trace.span("fit.smpl") is trace.span("step") is trace.request("step")


def test_run_batch_bit_identical_on_and_off(pipe):
    off = pipe.run_batch(_points(1))
    trace.enable()
    on = pipe.run_batch(_points(1))
    trace.disable()
    assert trace.drain()[0]
    for k in off:
        if k == "fit_params":
            for p in off[k]:
                assert torch.equal(off[k][p], on[k][p]), p
        else:
            assert torch.equal(off[k], on[k]), k


def test_train_step_bit_identical_on_and_off():
    # one thread: the CPU backward's threaded sums differ run to run in the
    # last bit, tracing or not
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batches = [_batch(0), _batch(1)]
        m_off, l_off = _train(batches)
        trace.enable()
        m_on, l_on = _train(batches)
        trace.disable()
    finally:
        torch.set_num_threads(threads)
    assert trace.drain()[0]
    for a, b in zip(l_off, l_on):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (k, a), b in zip(m_off.state_dict().items(), m_on.state_dict().values()):
        assert torch.equal(a, b), k


def test_run_batch_span_tree(pipe):
    trace.enable()
    pipe.run_batch(_points(2))
    trace.disable()
    spans, counts = trace.drain()
    assert spans[0][0] == "pipeline.run_batch" and spans[0][2] is None
    assert {s[1] for s in spans} == {spans[0][1]} and spans[0][1] is not None
    kids = _tree(spans)
    assert kids["pipeline.run_batch"] == ["pipeline.predict", "fit.markers", "fit.lm0",
                                          "fit.lm1", "fit.smpl"]
    assert kids["pipeline.predict"] == ["net.encoder", "net.propagate", "net.confidence",
                                        "net.direction", "net.magnitude"]
    assert kids["fit.lm0"] == ["fit.lm.jacobian", "fit.lm.solve"] * STEPS0
    assert kids["fit.lm1"] == ["fit.lm.jacobian", "fit.lm.solve"] * STEPS1
    assert counts == {"fit.lm_iterations": STEPS0 + STEPS1}
    assert {s[0] for s in spans} <= set(trace.SPAN_NAMES)
    for name, _, parent, start, end in spans:
        assert start <= end
        if parent is not None:
            assert spans[parent][3] <= start and end <= spans[parent][4]


def test_each_run_batch_is_a_request(pipe):
    trace.enable()
    pipe.run_batch(_points(3))
    pipe.run_batch(_points(4))
    trace.disable()
    spans, counts = trace.drain()
    roots = [s for s in spans if s[2] is None]
    assert [s[0] for s in roots] == ["pipeline.run_batch"] * 2
    assert roots[0][1] != roots[1][1]
    assert counts["fit.lm_iterations"] == 2 * (STEPS0 + STEPS1)
    assert report.lm_ms(spans) == pytest.approx(sum(
        s[4] - s[3] for s in spans if s[0] in ("fit.lm0", "fit.lm1")) * 1e-6 / 2)


def test_train_step_span_tree():
    trace.enable()
    _train([_batch()])
    trace.disable()
    spans, counts = trace.drain()
    assert spans[0][0] == "step" and spans[0][2] is None
    assert {s[1] for s in spans} == {spans[0][1]}
    kids = _tree(spans)
    assert kids["step"] == ["net.encoder", "net.propagate", "net.confidence", "net.direction",
                            "net.magnitude", "step.loss", "step.backward", "step.guard",
                            "step.adam", "step.guard"]
    assert set(kids["step.backward"]) == {"interconv.backward"}
    assert counts == {"step.skipped_updates": 0}
    assert {s[0] for s in spans} <= set(trace.SPAN_NAMES)


def test_skipped_updates_counts_the_guard():
    """The guard's device counter: 1 after a NaN-loss step, 0 after a finite
    one (the set-up of test_torch_train's NaN guard test)."""
    cfg = EtchConfig.tiny(**TRAIN_KW)
    model, state, opt = create_train_state(cfg, seed=1, device="cpu")
    step = make_train_step(model, opt, cfg)
    state, _ = step(state, _batch())
    nan_batch = dict(_batch(1), vectors=np.full((B, TRAIN_N, 3), np.nan, np.float32))
    trace.enable()
    state, losses = step(state, nan_batch)
    assert not torch.isfinite(losses["all_loss"])
    assert trace.drain()[1] == {"step.skipped_updates": 1}
    state, losses = step(state, _batch(1))
    assert torch.isfinite(losses["all_loss"])
    assert trace.drain()[1] == {"step.skipped_updates": 0}


def test_spans_nest_across_threads_and_drain_clears():
    trace.enable()
    with trace.request("step"):
        with trace.span("step.backward"):
            t = threading.Thread(target=lambda: trace.span("interconv.backward").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join()
        trace.count("fit.lm_iterations", 2)
    with trace.request("step"):
        pass
    spans, counts = trace.drain()
    assert [(s[0], s[2]) for s in spans] == [("step", None), ("step.backward", 0),
                                              ("interconv.backward", 1), ("step", None)]
    assert spans[0][1] == spans[1][1] == spans[2][1] != spans[3][1]
    assert counts == {"fit.lm_iterations": 2}
    assert trace.drain() == ([], {})


def test_spans_and_counts_from_many_threads_are_all_kept():
    """More threads than cores, switching often: every span and count kept,
    every span closed, and the stack empty after."""
    import os
    import sys

    n_threads, per = 2 * (os.cpu_count() or 2), 200

    def work():
        for _ in range(per):
            with trace.span("step.loss"):
                with trace.span("step.backward"):
                    trace.count("fit.lm_iterations")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        trace.disable()
    assert trace._stack == []
    spans, counts = trace.drain()
    assert len(spans) == 2 * n_threads * per and all(s[4] is not None for s in spans)
    assert counts == {"fit.lm_iterations": n_threads * per}


def test_records_are_on_the_profiler_clock():
    """Each record's start and its `record_function` range's start in the
    profiler's CPU events: the same clock, a few microseconds apart."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable()
        for _ in range(5):
            with trace.request("step"):
                with trace.span("step.loss"):
                    torch.ones(64).sum()
        trace.disable()
    spans, _ = trace.drain()
    ranges = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.name() in trace.SPAN_NAMES)
    off = report.clock_offsets_us(spans, ranges)
    assert len(off) == len(spans) == 10
    assert all(abs(x) < 5000 for x in off)


# ---- the report's reduction, on made-up events ---------------------------


class Ev:
    def __init__(self, name, dev, start, end, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, start, end, corr

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


BENCH = [
    Ev("serve.fit", "CPU", 0, 1000),
    Ev("serve.forward", "CPU", 0, 300),
    Ev("cudaLaunchKernel", "CPU", 10, 12, 1),
    Ev("cudaLaunchKernel", "CPU", 400, 402, 2),
    Ev("cudaLaunchKernel", "CPU", 500, 502, 3),
    Ev("cudaLaunchKernel", "CPU", 700, 702, 4),
    Ev("aten::linalg_cholesky_ex", "CPU", 540, 595),
    Ev("aten::item", "CPU", 555, 592),
    Ev("cudaStreamSynchronize", "CPU", 560, 590),
    Ev("cudaMemcpyAsync", "CPU", 950, 955),
    Ev("cudaStreamSynchronize", "CPU", 960, 990),
    Ev("serve.forward", "CUDA", 20, 300),
    Ev("void knn_kernel<8>(float const*)", "CUDA", 20, 120, 1),
    Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 110, 150, 0),
    Ev("void at::native::elementwise_kernel<128>(x)", "CUDA", 450, 470, 2),
    Ev("void at::native::elementwise_kernel<128>(x)", "CUDA", 600, 650, 3),
    Ev("void gemv(x)", "CUDA", 800, 830, 4),
]
PROGRAM = [
    Ev("pipeline.run_batch", "CPU", 1, 940),
    Ev("pipeline.predict", "CPU", 2, 290),
    Ev("fit.lm0", "CPU", 390, 800),
    Ev("fit.lm.jacobian", "CPU", 395, 450),
    Ev("fit.lm.solve", "CPU", 490, 600),
    Ev("fit.lm.jacobian", "CPU", 690, 720),
    Ev("fit.lm0", "CUDA", 450, 830),        # the span's device side: not work
    Ev("fit.lm.solve", "CUDA", 600, 650),
]


def test_reduction_by_program_span():
    red = report.reduce_events(BENCH + PROGRAM, report.SERVE_RANGES)
    assert red["launches"] == {"pipeline.predict": 1, "fit.lm.jacobian": 2, "fit.lm.solve": 1}
    assert red["bench_launches"] == {"serve.forward": 1, "serve.fit": 3}
    assert red["syncs"] == {"fit.lm.solve": 1, "outside": 1}
    assert red["sync_ops"] == {"fit.lm.solve | aten::item | cudaStreamSynchronize": 1,
                               "outside | none | cudaStreamSynchronize": 1}
    assert red["kernel_s"] == pytest.approx({"pipeline.predict": 100e-9,
                                             "fit.lm.jacobian": 50e-9, "fit.lm.solve": 50e-9})
    assert red["gaps"] == pytest.approx({"fit.lm.jacobian": (450 - 150 + 800 - 650) * 1e-9,
                                         "fit.lm.solve": (600 - 470) * 1e-9})
    assert red["gap_pairs"] == pytest.approx({("serve.fit", "fit.lm.jacobian"): 450e-9,
                                              ("serve.fit", "fit.lm.solve"): 130e-9})
    assert red["busy_s"] == pytest.approx((150 - 20 + 20 + 50 + 30) * 1e-9)
    assert [n for _, n in red["ranges"]][:2] == ["pipeline.run_batch", "pipeline.predict"]


def test_metrics_on_the_reduction():
    red = report.reduce_events(BENCH + PROGRAM, report.SERVE_RANGES)
    assert report.lm_launches_per_iter(red, 2) == 1.5
    counts = {"fit.lm.graph_replays": 160, "fit.lm.graph_captures": 2}
    assert report.per_call(counts, "fit.lm.graph_replays", 2) == 80
    assert report.per_call(counts, "fit.lm.graph_captures", 2) == 1
    assert report.per_call(counts, "fit.lm_iterations", 2) == 0
    assert report.fit_syncs(red, 1) == 1
    assert report.interconv_backward_ms(red, 1) is None
    red["kernel_s"]["interconv.backward"] = 0.25
    assert report.interconv_backward_ms(red, 2) == 125.0
    assert report.net_ms(red, 1) == dict.fromkeys(report.NET_SPANS)
    red["kernel_s"].update({"net.encoder": 0.03, "net.direction": 0.08})
    assert report.net_ms(red, 2) == {"net.encoder": 15.0, "net.propagate": None,
                                     "net.confidence": None, "net.direction": 40.0,
                                     "net.magnitude": None}
    counts = {"dircore.wide_points": 320000, "interconv.slices": 20, "bf16.tc_products": 28}
    assert report.per_call(counts, "dircore.wide_points", 2) == 160000
    assert report.per_call(counts, "interconv.slices", 2) == 10
    assert report.per_call(counts, "bf16.tc_products", 2) == 14
    assert report.per_call({}, "bf16.tc_products", 2) == 0
    spans = [("pipeline.run_batch", 1, None, 0, 10 ** 7), ("fit.lm0", 1, 0, 0, 2 * 10 ** 6),
             ("fit.lm1", 1, 0, 2 * 10 ** 6, 5 * 10 ** 6)]
    assert report.lm_ms(spans) == 5.0
    assert report.span_ms(spans, 2) == {"pipeline.run_batch": 5.0, "fit.lm0": 1.0, "fit.lm1": 1.5}


def test_benchmark_labels_unmoved_by_program_spans():
    """With the program's spans added, the benchmark's labels, busy time and
    gap total read as `perfbench/trace.py::Profile` reads the events
    without them."""
    from perfbench import trace as bench

    red = report.reduce_events(BENCH + PROGRAM, report.SERVE_RANGES)
    prof = bench.Profile(BENCH, report.SERVE_RANGES, 1.0, 1, {})
    assert red["bench_launches"] == prof.launches
    assert red["busy_s"] == pytest.approx(prof.busy_s)
    by_bench = {}
    for (b, _), v in red["gap_pairs"].items():
        by_bench[b] = by_bench.get(b, 0) + v
    assert by_bench == pytest.approx(prof.gaps)


@pytest.mark.parametrize("metric", sorted(report.METRICS))
def test_every_name_a_metric_reads_is_the_programs(metric):
    for name in report.METRICS[metric]:
        assert name in trace.SPAN_NAMES + trace.COUNTER_NAMES, name


def test_net_spans_label_the_forward_kernels():
    """Kernels launched inside a `net.*` span count to it, not to the
    `pipeline.predict` around it, and `net_ms` reads them a batch."""
    net = [Ev("net.encoder", "CPU", 5, 100), Ev("net.direction", "CPU", 150, 280)]
    red = report.reduce_events(BENCH + PROGRAM + net, report.SERVE_RANGES)
    assert red["launches"]["net.encoder"] == 1 and "pipeline.predict" not in red["launches"]
    assert red["kernel_s"]["net.encoder"] == pytest.approx(100e-9)
    assert report.net_ms(red, 1)["net.encoder"] == pytest.approx(100e-6)
    assert report.net_ms(red, 1)["net.direction"] is None
