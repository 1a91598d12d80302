"""A whole run of each cell, on the CPU at tiny widths, with the timed path
sound and broken underneath: the sound run is `correct`, and each fault the
cell can have comes out not correct, under the cell's own limits.  Also
the serving control (the reference with fp8 operands in the program's
place).  The training control (TF32) acts on the card only: see
test_perfbench_cuda.py."""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import compare, core, inputs, serve  # noqa: E402
from perfbench import run as runmod  # noqa: E402

TINY = dict(num_point=256, epn_mlps=[[8, 8], [8, 8]], unet_planes_magnitude=[8, 16, 16, 16, 16],
            unet_planes_confidence=[8, 16, 16, 16, 16], unet_blocks=[1, 1, 1, 1, 1],
            unet_nsamples=[4, 4, 4, 4, 4], dir_value_dim=16, dir_num_heads=2, dir_num_layers=1,
            dir_chunk=512, epn={"input_num": 128}, fit_steps_stage0=10, fit_steps_stage1=10)
SERVE, TRAIN = "etch-bf16.serve-b32", "etch-f32.train-b8"


def tiny_cell(workload, precision="f32"):
    cell = core.load_cell(workload)
    cell.config = {**cell.config, **TINY, "use_bfloat16": precision == "bf16",
                   "precision": precision}
    cell.traffic = {**cell.traffic, "batch": 4, "points": 256}
    return cell


def drive(cell, seed=2 ** 31 + 3):
    """One run on the CPU; returns its result line."""
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=0.1, trace=0)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runmod.run(args, "cpu", cell, compare.load_limits(cell.name))
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_serve_sound():
    res = drive(tiny_cell(SERVE))
    assert res["correct"], res["checks"]
    assert res["attempted"] == 4 * (res["attempted"] // 4) and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _altered_answer(orig):
    def run_batch(self, points):
        out = orig(self, points)
        out["verts"] = out["verts"].clone()
        out["verts"][0] += 0.01          # one scan's body 1 cm off
        return out
    return run_batch


def _half_batch(orig):
    def run_batch(self, points):
        out = orig(self, points[: len(points) // 2])
        twice = lambda t: torch.cat([t, t]) if torch.is_tensor(t) else t
        res = {k: twice(v) for k, v in out.items() if k != "fit_params"}
        res["fit_params"] = {k: twice(v) for k, v in out["fit_params"].items()}
        return res
    return run_batch


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch], ids=["answer", "half_batch"])
def test_serve_faults(monkeypatch, fault):
    from etch_tpu_torch.pipeline import InferencePipeline
    monkeypatch.setattr(InferencePipeline, "run_batch", fault(InferencePipeline.run_batch))
    assert not drive(tiny_cell(SERVE))["correct"]


def test_serve_control_fails():
    cell = tiny_cell(SERVE)
    pipe, weights, pool, body, vids, _ = serve.build(cell, 11, torch.device("cpu"))
    out = serve.to_host(pipe.run_batch(pool[0]))
    numbers = serve.reference_check(cell, weights, body, vids, pool[0], out, "cpu",
                                    control="low")
    ok, _ = compare.judge(numbers, compare.load_limits(SERVE))
    assert not ok, numbers


def test_train_sound():
    res = drive(tiny_cell(TRAIN))
    assert res["correct"], res["checks"]
    assert res["attempted"] % 4 == 0 and res["failed"] == 0


def test_train_state_unchanged(monkeypatch):
    from etch_tpu_torch.train import state as st
    monkeypatch.setattr(st, "_guarded_update", lambda state, loss: state)
    assert not drive(tiny_cell(TRAIN))["correct"]


def test_train_half_batch(monkeypatch):
    from etch_tpu_torch.train import state as st
    orig = st.batch_to

    def half(batch, device):
        return {k: v[: v.shape[0] // 2] for k, v in orig(batch, device).items()}

    monkeypatch.setattr(st, "batch_to", half)
    assert not drive(tiny_cell(TRAIN))["correct"]


def test_weights_reach_the_program_unchanged():
    cell = tiny_cell(SERVE)
    pipe, weights, *_ = serve.build(cell, 5, torch.device("cpu"))
    for k, v in pipe.model.state_dict().items():
        torch.testing.assert_close(v, weights[k], rtol=0, atol=0)
    assert inputs.make_weights({k: tuple(v.shape) for k, v in weights.items()},
                               inputs.torch_seed(inputs.seed_streams(5, 3)[0]),
                               "cpu").keys() == weights.keys()
