"""Levenberg-Marquardt with constant damping, batched over problems.

Port of `etch_tpu/fit/lm.py:levenberg_marquardt` (reference Theseus setup,
`src/models/fit_SMPL.py:179-249`): normal equations
(J^T J + damping I) delta = -J^T r solved by Cholesky, x <- x + step * delta,
a fixed number of iterations.  Jacobians come from `torch.func.jacfwd`
(forward mode: ~85 parameters against a 258-wide residual), vmapped over the
batch; the residual comes out of the same pass as an auxiliary output.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, vmap


def levenberg_marquardt(residual_fn: Callable, x0: torch.Tensor, args: tuple,
                        num_steps: int, step_size: float, damping: float) -> torch.Tensor:
    """Minimise |residual_fn(x, *a)|^2 for each problem of a batch.

    residual_fn: ((P,), *per-problem args) -> (R,); x0 (B, P); args: tuple of
    (B, ...) tensors, one slice per problem.  Returns the final x (B, P).
    """
    P = x0.shape[-1]
    eye = torch.eye(P, dtype=x0.dtype, device=x0.device)

    def with_aux(x, *a):
        r = residual_fn(x, *a)
        return r, r

    jac = vmap(jacfwd(with_aux, has_aux=True))
    x = x0
    for _ in range(num_steps):
        J, r = jac(x, *args)                                     # (B, R, P), (B, R)
        Jt = J.transpose(-1, -2)
        L = torch.linalg.cholesky(Jt @ J + damping * eye)
        delta = torch.cholesky_solve(-(Jt @ r[..., None]), L)[..., 0]
        x = x + step_size * delta
    return x
