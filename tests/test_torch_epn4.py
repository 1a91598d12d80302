"""EtchNet at EPN's four published blocks (`--EPN_layer_num 4`, mlps 32, 64,
128, 256) against the benchmark's plain reference (`perfbench/reference/`),
the configuration file the benchmark serves it by, the two per-layer readers
of its cell, and the forward's spans (the network's and, inside the
encoder, each EPN block's) and the wrappers' counters (`utils/trace.py`).

On the CPU the port runs its plain versions, which the reference is a
frozen copy of: in f32 the two agree to f32 summation order (rtol 1e-5,
atol 1e-6, the tolerance of `perfbench/tests/test_perfbench_reference.py`).
The bf16 program rounds at the JAX package's points and the reference's
`Numerics("bf16")` at every product operand, so they differ by bf16
rounding, not bit for bit: an output is held to `BF16_RATIO` times the bf16
reference's own distance from the f32 reference (`perfbench/compare.py`'s
`conf_ratio`, whose limit in the bf16 cells is 4).

The card test (`cuda` marker) serves the benchmark cell's own batch, B=32
and N=5000, through `run_batch`; it imports no jax (run it with
`--noconftest` where jax is absent).
"""

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from etch_tpu_torch import _build  # noqa: E402
from etch_tpu_torch.models.etch_net import EtchNet  # noqa: E402
from etch_tpu_torch.nn import dircore, interconv  # noqa: E402
from etch_tpu_torch.utils import trace  # noqa: E402
from etch_tpu_torch.utils.config import backbone_plan  # noqa: E402
from perfbench import compare, core, flops, inputs, serve  # noqa: E402
from perfbench import trace as bench_trace  # noqa: E402
from perfbench.reference import net as ref_net  # noqa: E402
from perfbench.reference import plan as ref_plan  # noqa: E402

CELL = "etch-epn4-bf16.serve-b32"
CONFIG = ROOT / "perfbench" / "configs" / "etch-epn4-bf16.json"
OUTPUTS = ("direction", "magnitude", "part_labels", "confidences")
NET_SPANS = ("net.encoder", "net.propagate", "net.confidence", "net.direction", "net.magnitude")
EPN_SPANS = ("epn.block0", "epn.block1", "epn.block2", "epn.block3")
# f32 against the reference: the same plain operations, sums in the same or
# another f32 order
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 against the reference: within this many times the bf16 reference's
# own distance from f32 (the port rounds at other points: 0.9-1.6 of it at
# the published widths, N=256)
BF16_RATIO = 3.0
# the small widths: four blocks of 8, 8, 16, 16 channels, the U-Nets and
# heads at EtchConfig.tiny()'s, two direction layers, a short fit
SMALL = dict(num_point=256, epn_mlps=[[8, 8], [8, 8], [16, 16], [16, 16]],
             unet_planes_magnitude=[8, 16, 16, 16, 16], unet_planes_confidence=[8, 16, 16, 16, 16],
             unet_blocks=[1, 1, 1, 1, 1], unet_nsamples=[4, 4, 4, 4, 4], dir_value_dim=16,
             dir_num_heads=2, dir_chunk=512, epn={"input_num": 128}, fit_steps_stage0=5,
             fit_steps_stage1=5)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def published(N: int, bf16: bool) -> dict:
    """The benchmark's configuration at N points, in f32 or bf16."""
    cfg = json.loads(CONFIG.read_text())
    return {**cfg, "num_point": N, "use_bfloat16": bf16, "precision": "bf16" if bf16 else "f32"}


def model_for(cfg: dict, seed: int = 3):
    """EtchNet for a configuration dict with seeded random weights (the
    benchmark's initialisers): (model in eval mode, the weights)."""
    model = EtchNet(core.etch_config(cfg))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = inputs.make_weights(shapes, seed, "cpu")
    model.load_state_dict(w)
    return model.eval(), w


def scans(n: int, N: int, seed: int = 0) -> torch.Tensor:
    mesh = inputs.read_obj(inputs.SCAN)
    return torch.as_tensor(inputs.scan_clouds(mesh, n, N, 1, np.random.default_rng(seed)))


@pytest.fixture(scope="module")
def published_outputs():
    """The port in f32 and in bf16 and the reference in f32, bf16 and fp8 on
    one scan of 256 points at the published widths, one set of weights."""
    f32_model, w = model_for(published(256, False))
    bf16_model, _ = model_for(published(256, True))
    bf16_model.load_state_dict(w)
    pts = scans(1, 256)
    cfg = published(256, False)
    with torch.no_grad():
        out = {"f32": f32_model(pts), "bf16": bf16_model(pts)}
    for kind in (None, "bf16", "fp8"):
        out[f"ref_{kind}"] = ref_net.forward(ref_net.Ctx(w, cfg, numerics=ref_net.Numerics(kind)),
                                             pts)
    return out


def within_f32(got, ref) -> bool:
    return all(torch.allclose(got[k], ref[k], **F32_TOL) for k in OUTPUTS)


def within_bf16(got, ref, ref_bf16) -> bool:
    return all(compare.rel(got[k], ref[k]) <= BF16_RATIO * compare.rel(ref_bf16[k], ref[k])
               for k in OUTPUTS)


# ---- (a) the port against the reference, f32 ------------------------------


def test_small_widths_run_batch_equals_the_reference():
    """Four blocks at small widths, B=2, N=256, through `run_batch` as the
    benchmark serves them: the network's outputs and the fit (stage by
    stage on the program's own inner points) against the reference."""
    cell = core.load_cell(CELL)
    cell.config = {**cell.config, **SMALL, "use_bfloat16": False, "precision": "f32"}
    cell.traffic = {**cell.traffic, "batch": 2, "points": 256, "pool": 1}
    dev = torch.device("cpu")
    pipe, weights, pool, body, vids, _ = serve.build(cell, 2 ** 31 + 11, dev)
    assert len(pipe.model.encoder.names) == 8
    out = serve.to_host(pipe.run_batch(pool[0]))
    numbers = serve.reference_check(cell, weights, body, vids, pool[0], out, dev)
    assert numbers["vectors_rel"] <= F32_TOL["rtol"] and numbers["conf_rel"] <= F32_TOL["rtol"]
    assert numbers["labels_off"] == 0.0
    # the fit is f32 on both sides and sees the same inputs: bit for bit
    assert numbers["verts_mm"] == 0.0


def test_small_widths_forward_equals_the_reference():
    cfg = {**published(256, False), **SMALL}
    model, w = model_for(cfg, seed=5)
    pts = scans(2, 256, seed=1)
    with torch.no_grad():
        got = model(pts)
    ref = ref_net.forward(ref_net.Ctx(w, cfg), pts)
    for k in OUTPUTS:
        torch.testing.assert_close(ref[k], got[k], **F32_TOL)


def test_published_widths_forward_equals_the_reference(published_outputs):
    o = published_outputs
    for k in OUTPUTS:
        torch.testing.assert_close(o["ref_None"][k], o["f32"][k], **F32_TOL)


# ---- (b) the bf16 plain route against the reference's bf16 ----------------


def test_published_widths_bf16_within_bf16_rounding(published_outputs):
    o = published_outputs
    assert within_bf16(o["bf16"], o["ref_None"], o["ref_bf16"])


def test_f32_program_passes_the_bf16_tolerance(published_outputs):
    o = published_outputs
    assert within_bf16(o["f32"], o["ref_None"], o["ref_bf16"])


def test_bf16_program_fails_the_f32_tolerance(published_outputs):
    o = published_outputs
    assert not within_f32(o["bf16"], o["ref_None"])


def test_fp8_reference_fails_the_bf16_tolerance(published_outputs):
    """One precision below bf16 (float8 e4m3 operands) is refused: the bf16
    tolerance is tighter than the next precision down."""
    o = published_outputs
    assert not within_bf16(o["ref_fp8"], o["ref_None"], o["ref_bf16"])


# ---- (c) the configuration file -------------------------------------------


def test_config_file_is_four_published_blocks():
    cfg = json.loads(CONFIG.read_text())
    ecfg = core.etch_config(cfg)
    assert ecfg.epn_layer_num == 4 and ecfg.use_bfloat16 and cfg["reduced"] == []
    base = json.loads((ROOT / "perfbench" / "configs" / "etch-bf16.json").read_text())
    changed = {k for k in cfg if cfg[k] != base.get(k)}
    assert changed == {"name", "source", "assumed", "epn_layer_num"}
    port, ref = backbone_plan(ecfg), ref_plan.backbone_plan(cfg)
    assert [len(b) for b in port] == [len(b) for b in ref] == [2, 2, 2, 2]
    for pb, rb in zip(port, ref):
        for pc, rc in zip(pb, rb):
            for key, value in rc.items():
                assert pc[key] == pytest.approx(value), key
    convs = [c for b in ref for c in b]
    assert [c["dim_out"] for c in convs] == [32, 32, 64, 64, 128, 128, 256, 256]
    assert convs[-1]["dim_out"] == 256 and convs[-1]["n_out"] == 313
    assert flops.forward_flops(cfg) / 1e9 == pytest.approx(782.78, abs=0.005)


# ---- (d) the cell's two readers on made-up records ------------------------


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


WIDE_KEY = ("etch_dircore_wide", 160000, 60, 256, 128, 8, 32, 1 / math.sqrt(32))
SPANS = ("serve.fit", "serve.forward")


def record(events, shapes, kind="serve", calls=1):
    prof = bench_trace.Profile(events, SPANS, window_s=1.0, calls=calls, shapes=shapes)
    return SimpleNamespace(kind=kind, profile=prof, kernels=core.kernel_bounds())


def dircore_events(wide_ns):
    return [Ev("serve.fit", "CPU", 0, 10 ** 9), Ev("serve.forward", "CPU", 0, 10 ** 8),
            Ev("cudaLaunchKernel", "CPU", 10, 12, 1), Ev("cudaLaunchKernel", "CPU", 20, 22, 2),
            Ev("void (anonymous namespace)::dircore_wide_kernel<16, 32>(x)", "CUDA", 100,
               100 + wide_ns, 1),
            Ev("void knn_kernel<8>(float const*)", "CUDA", 200 + wide_ns, 300 + wide_ns, 2)]


def readers():
    return core.metric_readers(["serve.dircore_ms", "kernels_roofline.dircore"])


def test_dircore_readers_read_the_wide_core():
    from perfbench.kernels import dircore as bound
    wide_ns = 80 * 10 ** 6                      # 80 ms a batch over two batches
    rec = record(dircore_events(wide_ns), {"dircore": {WIDE_KEY: 2}}, calls=2)
    got = {n: r.read(rec) for n, r in readers().items()}
    assert got["serve.dircore_ms"] == pytest.approx(40.0)
    assert got["kernels_roofline.dircore"] == pytest.approx(
        100 * 2 * bound.bound(WIDE_KEY) / (wide_ns * 1e-9))
    assert 0 < got["kernels_roofline.dircore"] < 100


@pytest.mark.parametrize("case", ["no device time", "not launched", "training"])
def test_dircore_readers_read_nothing(case):
    events = dircore_events(10 ** 6)
    shapes = {"dircore": {WIDE_KEY: 1}}
    kind = "serve"
    if case == "no device time":
        events = [e for e in events if "dircore" not in e.name()]
    elif case == "not launched":      # the chunked core of the f32 path
        events = [e for e in events if "dircore" not in e.name()]
        shapes = {}
    else:
        kind = "train"
    rec = record(events, shapes, kind)
    assert {n: r.read(rec) for n, r in readers().items()} == {
        "serve.dircore_ms": None, "kernels_roofline.dircore": None}


# ---- (e) spans and counters -----------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    model, _ = model_for({**published(256, False), **SMALL})
    return model, scans(1, 256, seed=2)


def _raise(*a, **k):
    raise AssertionError("record_function entered with tracing off")


def test_forward_spans_recorded_in_order(small_model):
    model, pts = small_model
    trace.enable()
    with torch.no_grad(), trace.request("pipeline.run_batch"):
        model(pts)
    trace.disable()
    spans, counts = trace.drain()
    assert [s[0] for s in spans] == ["pipeline.run_batch", NET_SPANS[0], *EPN_SPANS,
                                     *NET_SPANS[1:]]
    assert all(s[2] == (1 if s[0] in EPN_SPANS else 0) and s[1] == spans[0][1]
               for s in spans[1:])
    assert all(s[3] <= s[4] for s in spans)
    assert counts == {}     # the plain versions on the CPU: no wrapper counted
    assert set(NET_SPANS + EPN_SPANS) <= set(trace.SPAN_NAMES)


def test_forward_off_records_nothing_and_opens_no_range(small_model, monkeypatch):
    model, pts = small_model
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with torch.no_grad():
        model(pts)
    assert trace.drain() == ([], {})


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' launches, recorded and not run: the counters' logic on
    CPU tensors."""
    seen = []
    monkeypatch.setattr(_build, "check_cuda", lambda name, *pairs: pairs[0][0].device)
    monkeypatch.setattr(_build, "launch", lambda kernel, entry, device, *args:
                        seen.append(_build.shape_key(entry, args)))
    return seen


def _dircore_params(E, V=128, layers=2):
    g = torch.Generator().manual_seed(0)
    p = {}
    for l in range(layers):
        out = V if l == layers - 1 else E
        for nm in ("wq", "wk", "wv"):
            p[f"{nm}{l}"] = torch.randn(E, E, generator=g)
        p[f"wc{l}"] = torch.randn(E, out, generator=g)
        p[f"bc{l}"] = torch.zeros(out)
    p.update(wm0=torch.randn(V, V, generator=g), bm0=torch.zeros(V),
             wm1=torch.randn(V, V, generator=g), bm1=torch.zeros(V),
             wr=torch.randn(V, 1, generator=g), br=torch.zeros(1))
    return p


@pytest.mark.parametrize("E,wide", [(256, True), (64, False)])
def test_wide_points_counter(launches, E, wide):
    tokens = torch.zeros(7, 60, E, dtype=torch.bfloat16)
    params = _dircore_params(E)
    trace.enable()
    dircore.direction_core_cuda(tokens, params, 8)
    trace.disable()
    assert [k[0] for k in launches] == ["etch_dircore_wide" if wide else "etch_dircore"]
    assert trace.drain()[1] == ({"dircore.wide_points": 7} if wide else {})
    dircore.direction_core_cuda(tokens, params, 8)        # off: counted nowhere
    assert trace.drain() == ([], {})


def _contraction(C, B=1, P=40, c=16, nn=8, K=24, A=60):
    g = torch.Generator().manual_seed(1)
    xyz = torch.rand(B, P, 3, generator=g)
    return (xyz, xyz[:, :c].contiguous(), torch.randint(0, P, (B, c, nn), dtype=torch.int32,
                                                        generator=g),
            torch.zeros(B, P, A * C, dtype=torch.bfloat16), torch.rand(A * K, 3, generator=g),
            0.05, A)


@pytest.mark.parametrize("C,slices", [(64, 0), (128, 2), (256, 4), (200, 4)])
def test_slices_counter(launches, C, slices):
    args = _contraction(C)
    trace.enable()
    interconv.interconv_t_cuda(*args)
    trace.disable()
    assert [k[0] for k in launches] == ["etch_interconv_t_bf16"]
    assert trace.drain()[1] == ({"interconv.slices": slices} if slices else {})
    interconv.interconv_t_cuda(*args)
    assert trace.drain() == ([], {})


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_batch_serves_on_the_card(cuda):
    """The cell's first batch (B=32, N=5000, four blocks, bf16) through
    `run_batch` with tracing on: finite vertices, the wide direction core on
    all 160,000 points, the contraction at 128 and 256 channels in 64-channel
    slices, and the five forward spans."""
    cell = core.load_cell(CELL)
    pipe, _, pool, *_ = serve.build(cell, 2 ** 31 + 17, cuda)
    B, N = cell.traffic["batch"], cell.traffic["points"]
    _build.reset_launch_counts()
    trace.enable()
    out = pipe.run_batch(pool[0])
    trace.disable()
    spans, counts = trace.drain()
    assert out["verts"].shape[0] == B and bool(torch.isfinite(out["verts"]).all())
    assert any(k[0] == "etch_dircore_wide" for k in _build.shape_launches["dircore"])
    assert counts["dircore.wide_points"] == B * N
    widths = {k[7] for k in _build.shape_launches["interconv_t_bf16"]}
    assert {128, 256} <= widths
    # ceil(C / 64) slices a launch, a launch a chunk of 512 centres
    slices = sum(-(-c["n_out"] // 512) * -(-c["dim_in"] // 64)
                 for b in ref_plan.backbone_plan(cell.config) for c in b if c["dim_in"] > 64)
    assert counts["interconv.slices"] == slices == 10
    assert [s[0] for s in spans if s[0].startswith("net.")] == list(NET_SPANS)
