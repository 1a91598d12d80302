"""Shared CLI plumbing of the port (the part of `etch_tpu/cli/common.py` its
entry points use so far)."""

from __future__ import annotations

from etch_tpu_torch.pipeline import load_markerset  # noqa: F401
