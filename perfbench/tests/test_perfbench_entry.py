"""The command's refusals: no result without a card, and none in a checkout
that holds only BENCHMARK.json and the benchmark's own files."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "etch-bf16.serve-b32", "--seed", "2147483999", "--seconds", "1",
        "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = run(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
