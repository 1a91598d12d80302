"""Levenberg-Marquardt with constant damping, batched over problems.

Port of `etch_tpu/fit/lm.py` (reference Theseus setup,
`src/models/fit_SMPL.py:179-249`): normal equations
(J^T J + damping I) delta = -J^T r solved by Cholesky, x <- x + step * delta,
a fixed number of iterations.  Jacobians come from `torch.func.jacfwd`
(forward mode: ~85 parameters against a 258-wide residual), vmapped over the
batch; the residual comes out of the same pass as an auxiliary output.

On a CUDA device the Jacobian pass, some 380 small kernels, is captured
once as a CUDA graph (`_JacobianGraph`) and replayed on every iteration:
the same kernels on the same data, so the fit is bit-equal to the eager
one, without the host issuing each kernel.  The solve and the update stay
eager.
"""

from __future__ import annotations

import collections
from typing import Callable, Hashable, Optional

import torch
from torch.func import jacfwd, vmap

from etch_tpu_torch.utils import trace

# The captured Jacobian passes, least recently used first.  A graph holds
# device pointers into its residual's closed-over tensors, so an entry keeps
# that residual, and with it those tensors, alive; 8 entries cover both
# stages of a few submodels and batch sizes (`cli/evaluate`'s gender batches).
_GRAPHS: "collections.OrderedDict[tuple, _JacobianGraph]" = collections.OrderedDict()
_MAX_GRAPHS = 8
# device -> (side stream, memory pool), shared by every capture on it.  One
# stream: cuBLAS keeps a workspace for each stream it runs on, which the
# captured GEMMs read, so each new stream would hold another.  One pool:
# passes run one at a time on one stream and each iteration reads its J and
# r before the next replay of any of them.
_CAPTURE: dict = {}


def levenberg_marquardt(residual_fn: Callable, x0: torch.Tensor, args: tuple,
                        num_steps: int, step_size: float, damping: float,
                        graph_key: Optional[Hashable] = None) -> torch.Tensor:
    """Minimise |residual_fn(x, *a)|^2 for each problem of a batch.

    residual_fn: ((P,), *per-problem args) -> (R,); x0 (B, P); args: tuple of
    (B, ...) tensors, one slice per problem.  Returns the final x (B, P).
    On a CUDA device the Jacobian pass is a CUDA graph, captured once per
    residual and shape: `graph_key` names the state that residual_fn closes
    over, so that calls with a new closure over the same state replay the
    same graph (default: residual_fn itself).
    """
    return _lm(residual_fn, x0, args, num_steps, step_size, damping, graph_key=graph_key)[0]


def levenberg_marquardt_with_history(residual_fn: Callable, x0: torch.Tensor, args: tuple,
                                     num_steps: int, step_size: float, damping: float):
    """`levenberg_marquardt` (the same update, the same Cholesky solve),
    also returning each problem's residual 2-norm at the start of every
    iteration and the final one, (B, num_steps + 1): the observable that
    tests/test_lm_trace.py holds against the Theseus trace.  Always eager."""
    x, norms = _lm(residual_fn, x0, args, num_steps, step_size, damping, history=True)
    final = vmap(residual_fn)(x, *args)
    return x, torch.stack(norms + [torch.linalg.norm(final, dim=-1)], -1)


class _JacobianGraph:
    """The vmapped Jacobian pass captured as a CUDA graph: it reads the
    static buffers `x` and `args` and writes the static `J` (B, R, P) and
    `r` (B, R)."""

    def __init__(self, jac, residual_fn, x: torch.Tensor, args: tuple):
        self.residual_fn = residual_fn        # keeps the captured tensors alive
        self.x = x.clone()
        self.args = tuple(a.clone() for a in args)
        dev = x.device
        if dev not in _CAPTURE:
            _CAPTURE[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        side, pool = _CAPTURE[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            jac(self.x, *self.args)           # warm-up: lazy set-up stays out of the capture
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=side):
                self.J, self.r = jac(self.x, *self.args)
        torch.cuda.current_stream(dev).wait_stream(side)

    def load(self, args: tuple) -> None:
        for static, a in zip(self.args, args):
            static.copy_(a)

    def __call__(self, x: torch.Tensor):
        self.x.copy_(x)
        self.graph.replay()
        trace.count("fit.lm.graph_replays")
        return self.J, self.r


def _jacobian_graph(jac, residual_fn, x0, args, graph_key) -> _JacobianGraph:
    """The cached graph for this residual and these shapes, its args loaded
    (captured on a miss)."""
    key = (residual_fn if graph_key is None else graph_key, x0.device, x0.dtype,
           tuple(x0.shape), tuple((a.dtype, tuple(a.shape)) for a in args))
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        while len(_GRAPHS) >= _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        graph = _JacobianGraph(jac, residual_fn, x0, args)
        trace.count("fit.lm.graph_captures")
    else:
        graph.load(args)
    _GRAPHS[key] = graph
    return graph


def _lm(residual_fn, x0, args, num_steps, step_size, damping, history=False, graph_key=None):
    P = x0.shape[-1]
    eye = torch.eye(P, dtype=x0.dtype, device=x0.device)

    def with_aux(x, *a):
        r = residual_fn(x, *a)
        return r, r

    jac = vmap(jacfwd(with_aux, has_aux=True))
    if x0.is_cuda and not history and num_steps > 0:
        jac, args = _jacobian_graph(jac, residual_fn, x0, args, graph_key), ()   # holds args
    x, norms = x0, []
    for _ in range(num_steps):
        trace.count("fit.lm_iterations")
        with trace.span("fit.lm.jacobian"):
            J, r = jac(x, *args)                                 # (B, R, P), (B, R)
        if history:
            norms.append(torch.linalg.norm(r, dim=-1))
        with trace.span("fit.lm.solve"):
            Jt = J.transpose(-1, -2)
            L = torch.linalg.cholesky(Jt @ J + damping * eye)
            delta = torch.cholesky_solve(-(Jt @ r[..., None]), L)[..., 0]
            x = x + step_size * delta
    return x, norms
