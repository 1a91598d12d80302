"""Training EtchNet at EPN's four published blocks (`--EPN_layer_num 4`) in
f32, TF32 off: the benchmark cell `etch-epn4-f32.train-b8`'s step, through
`train/state.py`'s `create_train_state` and `make_train_step` as
`perfbench/train.py` drives it, against the plain reference
(`perfbench/reference/train.py`), and the configuration file the cell
trains by.

On the CPU the port runs its plain versions, of which the reference is a
frozen copy, on one torch thread (several threads sum in another order run
to run).  The losses and the first gradient agree to f32 summation order
(`F32_RTOL`, the f32 tolerance of `test_torch_epn4.py`).  The parameters'
and the BatchNorm statistics' change after three Adam steps do not: Adam's
first update is lr * g / (|g| + eps), lr times the sign of g wherever |g|
is above 1e-8, so an element whose gradient is rounding noise moves by a
whole lr either way; those two are held to the cell's own limits
(`perfbench/limits/etch-epn4-f32.train-b8.json`).

The card test (`cuda` marker) runs the cell's three checked steps at B=8,
N=5000 against the reference under the cell's limits and records the
step's peak memory; it imports no jax (run it with `--noconftest` where jax
is absent).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from types import SimpleNamespace  # noqa: E402

from etch_tpu_torch.utils import trace  # noqa: E402
from perfbench import compare, core, train  # noqa: E402
from perfbench import trace as bench_trace  # noqa: E402
from perfbench.reference import plan as ref_plan  # noqa: E402

CELL = "etch-epn4-f32.train-b8"
CONFIG = ROOT / "perfbench" / "configs" / "etch-epn4-f32.json"
F32_RTOL = 1e-5
# test_torch_epn4.py's small widths: four blocks of 8, 8, 16, 16 channels,
# the U-Nets and heads at EtchConfig.tiny()'s, two direction layers
SMALL = dict(num_point=256, epn_mlps=[[8, 8], [8, 8], [16, 16], [16, 16]],
             unet_planes_magnitude=[8, 16, 16, 16, 16], unet_planes_confidence=[8, 16, 16, 16, 16],
             unet_blocks=[1, 1, 1, 1, 1], unet_nsamples=[4, 4, 4, 4, 4], dir_value_dim=16,
             dir_num_heads=2, dir_chunk=512, epn={"input_num": 128})
# EPN at its published widths, the U-Nets small
TINY_UNETS = dict(num_point=256, unet_planes_magnitude=[8, 16, 16, 16, 16],
                  unet_planes_confidence=[8, 16, 16, 16, 16], unet_blocks=[1, 1, 1, 1, 1],
                  unet_nsamples=[4, 4, 4, 4, 4], dir_chunk=512)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()
    torch.set_num_threads(threads)


def cell_at(config: dict, batch: int, points: int):
    cell = core.load_cell(CELL)
    cell.config = {**cell.config, **config}
    cell.traffic = {**cell.traffic, "batch": batch, "points": points, "pool": 3}
    return cell


def program_and_reference(cell, seed, device):
    """The cell's three checked steps on the program and on the reference
    from the same weights and batches: (program's readings, reference's)."""
    model, state, opt, step, weights, pool = train.build(cell, seed, device)
    names = [k for k, _ in model.named_parameters()]
    prog = train.checked_steps(model, state, opt, step, weights, pool, device)
    del model, state, opt, step
    core.free(device)
    return prog, train.reference_steps(cell, weights, names, pool, device)


def wide_backwards(cfg: dict) -> int:
    """Inter-conv backwards a step on rows wider than 64 channels: one a
    512-centre chunk of each conv whose input is wider."""
    return sum(-(-c["n_out"] // 512) for b in ref_plan.backbone_plan(cfg) for c in b
               if c["dim_in"] > 64)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 7])
def test_small_widths_train_steps_equal_the_reference(seed):
    cell = cell_at(SMALL, 2, 256)
    prog, ref = program_and_reference(cell, seed, torch.device("cpu"))
    numbers = compare.train_numbers(prog, ref)
    assert numbers["loss1_rel"] <= F32_RTOL and numbers["loss_rel"] <= F32_RTOL, numbers
    assert numbers["grad_gap"] <= F32_RTOL, numbers
    limits = compare.load_limits(CELL)
    assert numbers["change_gap"] <= limits["change_gap"], numbers
    assert numbers["bn_gap"] <= limits["bn_gap"], numbers


def test_published_widths_train_step_runs_the_wide_backward():
    """EPN at 32, 64, 128 and 256 channels (N=256, B=1): the training
    forward and backward give every parameter a finite gradient, with the
    plain twin's backward on the 128- and 256-channel rows counted once a
    conv; then the cell's checked steps give the reference's losses and
    first gradient."""
    from etch_tpu_torch.train.losses import compute_losses
    from etch_tpu_torch.train.state import batch_to

    cell = cell_at(TINY_UNETS, 1, 256)
    dev = torch.device("cpu")
    model, _, _, _, _, pool = train.build(cell, 2 ** 31 + 77, dev)
    b = batch_to(pool[0], dev)
    trace.enable()
    out = model(b["hitpts"], train=True)
    loss = compute_losses(model.cfg, out, b["vectors"], b["confidences"], b["labels"])
    grads = torch.autograd.grad(loss["all_loss"], list(model.parameters()), allow_unused=True)
    trace.disable()
    assert trace.drain()[1]["interconv.backward_wide"] == wide_backwards(cell.config) == 3
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    prog, ref = program_and_reference(cell, 2 ** 31 + 77, dev)
    numbers = compare.train_numbers(prog, ref)
    assert numbers["loss1_rel"] <= F32_RTOL and numbers["grad_gap"] <= F32_RTOL, numbers


def test_config_file_is_four_published_blocks_in_f32():
    cfg = json.loads(CONFIG.read_text())
    ecfg = core.etch_config(cfg)
    assert ecfg.epn_layer_num == 4 and ecfg.use_bfloat16 is False
    assert cfg["reduced"] == [] and cfg["precision"] == "f32"
    serve = json.loads((ROOT / "perfbench" / "configs" / "etch-epn4-bf16.json").read_text())
    changed = {k for k in cfg if cfg[k] != serve.get(k)}
    assert changed == {"name", "source", "precision", "assumed", "use_bfloat16"}
    # the serving configuration's four-block option, plus the training loop's lines
    assert "src/train.py:23,60-140" in cfg["source"] and "(--EPN_layer_num 4)" in cfg["source"]
    assert cfg["source"] != serve["source"]
    assert wide_backwards(cfg) == 4
    two = json.loads((ROOT / "perfbench" / "configs" / "etch-f32.json").read_text())
    assert wide_backwards(two) == 0


# ---- the cell's reader of the gathers' backward, on made-up records -------


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


STEP_SPANS = ("train.step", "train.forward", "train.backward", "train.optim", "train.guard")
INDEX_BACKWARD = ("void at::native::(anonymous namespace)::indexing_backward_kernel<float, 4>"
                  "(long const*, long const*, float const*, float*, long)")


def step_record(kernel_ns, kind="train", calls=2):
    events = [Ev("train.step", "CPU", 0, 10 ** 9), Ev("train.backward", "CPU", 0, 10 ** 9),
              Ev("cudaLaunchKernel", "CPU", 10, 12, 1), Ev("cudaLaunchKernel", "CPU", 20, 22, 2),
              Ev("cudaLaunchKernel", "CPU", 30, 32, 3),
              Ev("void at::native::elementwise_kernel<128, 2>(x)", "CUDA", 100, 5100, 1)]
    events += [Ev(INDEX_BACKWARD, "CUDA", 6000 + 10 ** 7 * i, 6000 + 10 ** 7 * i + ns, 2 + i)
               for i, ns in enumerate(kernel_ns)]
    prof = bench_trace.Profile(events, STEP_SPANS, window_s=1.0, calls=calls, shapes={})
    return SimpleNamespace(kind=kind, profile=prof, kernels=core.kernel_bounds())


def gather_backward():
    return core.metric_readers(["train.gather_backward_ms"])["train.gather_backward_ms"]


def test_gather_backward_reader_reads_ms_a_step():
    rec = step_record([3 * 10 ** 6, 5 * 10 ** 6])       # 8 ms over two steps
    assert gather_backward().read(rec) == pytest.approx(4.0)


@pytest.mark.parametrize("case", ["no such kernel", "serving"])
def test_gather_backward_reader_reads_nothing(case):
    rec = step_record([] if case == "no such kernel" else [10 ** 6],
                      "train" if case == "no such kernel" else "serve")
    assert gather_backward().read(rec) is None


# ---- on the card ----------------------------------------------------------


@pytest.mark.cuda
def test_cell_steps_on_the_card():
    """The cell's three checked steps at its own size (B=8, N=5000) against
    the reference under the cell's limits; the program's peak memory a step
    printed and below the card's 80 GB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc for sm_90a)")
    core.cache_env()
    dev = torch.device("cuda", 0)
    cell = core.load_cell(CELL)
    model, state, opt, step, weights, pool = train.build(cell, 2 ** 31 + 4021, dev)
    names = [k for k, _ in model.named_parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    trace.enable()
    prog = train.checked_steps(model, state, opt, step, weights, pool, dev)
    trace.disable()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{CELL}: max_memory_allocated over three steps {peak / 2 ** 30:.3f} GiB")
    assert trace.drain()[1]["interconv.backward_wide"] == 3 * wide_backwards(cell.config)
    del model, state, opt, step
    core.free(dev)
    ref = train.reference_steps(cell, weights, names, pool, dev)
    ok, checks = compare.judge(compare.train_numbers(prog, ref), compare.load_limits(CELL))
    assert ok, checks
    assert peak < 80e9
