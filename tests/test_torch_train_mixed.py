"""`cli/train_mixed.py` of the PyTorch port on the CPU: at world size 1 in
both label modes, and in two gloo ranks joined as under torchrun, on the
bundled 4D-Dress item given twice (a `ConcatDataset` of two parts), at
full width and N=128."""

import json
import os

import numpy as np
import pytest

from tools import torch_parallel_check as check
from torch_parity import INFO_DIR, MARKERSET, SCAN_DIR, SMPL_DIR, TRAIN_IDS

SPEC = f"{SCAN_DIR}:{SMPL_DIR}:{INFO_DIR}:{TRAIN_IDS}"


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_train_mixed_cli(tmp_path, dynamic):
    """`cli.train_mixed` at world size 1 on the CPU, one epoch over the
    bundled 4D-Dress item given twice (a `ConcatDataset` of two parts,
    centered and rotated), with and without the dynamic labels: its folder,
    its log and one checkpoint, of two steps."""
    from etch_tpu_torch.cli import train_mixed

    args = ["--dataset_spec", SPEC, SPEC, "--num_point", "128", "--epochs", "1",
            "--batch_size", "1", "--num_workers", "0", "--device", "cpu",
            "--markerset_path", MARKERSET,
            "--output_folder", str(tmp_path / "exp")]
    if dynamic:
        args.append("--use_dynamic_label_confidence")
    out, state = train_mixed.main(args)
    assert sorted(os.listdir(out)) == ["checkpoints", "log_all", "training_args.json"]
    assert os.listdir(os.path.join(out, "checkpoints")) == ["0.pt"]
    with open(os.path.join(out, "training_args.json")) as fh:
        saved = json.load(fh)
    assert saved["use_dynamic_label_confidence"] is dynamic and len(saved["dataset_spec"]) == 2
    with open(os.path.join(out, "log_all", "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [0]
    assert all(np.isfinite(rows[0][k]) for k in ("all_loss", "confidence_loss",
                                                 "part_label_loss"))
    assert int(state.step) == 2


def test_train_mixed_cli_two_ranks(tmp_path):
    """`cli.train_mixed` in two gloo ranks joined as under torchrun (env://
    on a free local port), on the CPU: one global batch of the bundled item
    given twice, one cloud a rank; both ranks end on the same parameters
    after one step, and only rank 0 wrote the experiment folder."""
    out = tmp_path / "exp"
    ranks = check.run_cli(2, "etch_tpu_torch.cli.train_mixed", [
        "--dataset_spec", SPEC, SPEC, "--num_point", "128", "--epochs", "1",
        "--batch_size", "2", "--num_workers", "0", "--device", "cpu", "--no_augment",
        "--markerset_path", MARKERSET,
        "--output_folder", str(out)], timeout=600)
    assert [r["step"] for r in ranks] == [1, 1]
    for n, v in ranks[0]["params"].items():
        assert (ranks[1]["params"][n] == v).all(), n
    assert sorted(os.listdir(out)) == ["checkpoints", "log_all", "training_args.json"]
    assert os.listdir(out / "checkpoints") == ["0.pt"]
    with open(out / "log_all" / "metrics.jsonl") as fh:
        assert len(fh.readlines()) == 1
