"""On the card: each cell's traced run at its own size, the controls at the
cells' own sizes (the reference one precision below the configuration in
the program's place must come out not correct), and the planted faults.

    python -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_cuda.py

Every test skips where torch sees no card."""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import compare, core, serve, train  # noqa: E402
from perfbench import run as runmod  # noqa: E402

pytestmark = pytest.mark.cuda
SERVE, TRAIN = "etch-bf16.serve-b32", "etch-f32.train-b8"
SEED = 2 ** 31 + 911


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    core.cache_env()
    return torch.device("cuda")


def drive(cell, trace, seconds=3.0):
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=seconds, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runmod.run(args, "cuda", cell)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_traced_run(card, workload):
    cell = core.load_cell(workload)
    res = drive(cell, 1)
    assert res["correct"], res["checks"]
    assert {m["name"] for m in cell.per_layer} == set(res["metrics"])
    for name, m in res["metrics"].items():
        if name.startswith(("kernels_roofline", "mfu")):
            assert 0 < m["value"] <= 100, (name, m)
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"] and dev["platform"] == "gpu"
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]


def test_serve_control_fails(card):
    cell = core.load_cell(SERVE)
    pipe, weights, pool, body, vids, _ = serve.build(cell, SEED, card)
    out = serve.to_host(pipe.run_batch(pool[0]))
    del pipe
    core.free(card)
    numbers = serve.reference_check(cell, weights, body, vids, pool[0], out, card,
                                    control="low")
    ok, checks = compare.judge(numbers, compare.load_limits(SERVE))
    assert not ok, checks


def test_train_control_and_half_batch_fail(card):
    cell = core.load_cell(TRAIN)
    model, state, opt, step, weights, pool = train.build(cell, SEED, card)
    names = [k for k, _ in model.named_parameters()]
    del model, state, opt, step
    core.free(card)
    ref = train.reference_steps(cell, weights, names, pool, card)
    limits = compare.load_limits(TRAIN)
    for kind, numbers in train.control_numbers(cell, weights, names, pool, card, ref).items():
        ok, checks = compare.judge(numbers, limits)
        assert not ok, (kind, checks)
