"""Data parallelism over `torch.distributed`.

Port of `etch_tpu/parallel/mesh.py`.  The JAX package shards the batch
over a 1-D 'data' mesh and replicates the parameters; GSPMD then makes the
sharded step compute what the one-device step computes: the gradient of the
global batch's mean loss, and BatchNorm statistics over the global batch.
Here each rank is a process:

  - `make_mesh()` joins the process group that `torchrun` describes
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`); without those
    variables, or with one rank, it is world size 1 and joins no group.
    The backend is `nccl` on CUDA and `gloo` on the CPU.
  - `shard_batch(mesh, batch)` keeps this rank's contiguous slice of the
    global batch, which every rank loads in the same seeded order.
  - `replicate(mesh, state)` broadcasts the parameters, buffers and Adam's
    state from rank 0 and binds the mesh to the train state and to the
    model's batch-statistic BatchNorms (`nn/point_transformer.py`).

The train step (`train/state.py`) then averages the gradients over the
ranks in one flat all-reduce and takes its losses, and the NaN guard's
decision, from the global means; the BatchNorms all-reduce their sums
through `all_reduce_sum`, whose backward all-reduces the incoming
gradient.  Where gloo refuses CUDA tensors, the reductions are staged
through pinned host copies (`Mesh.staged`); the compute stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    rank: int = 0
    world_size: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    group: Optional[dist.ProcessGroup] = None   # None at world size 1
    staged: bool = False     # reductions through pinned host copies (gloo on CUDA)
    owns_group: bool = False

    def close(self) -> None:
        """Leave the process group if `make_mesh` joined it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def _resolve_device(device, local_rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r}: torch sees no CUDA device "
                               f"(pass device=\"cpu\" to run on the CPU)")
        if device.index is None:   # one card a local rank, ranks sharing cards round robin
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def _gloo_takes_cuda(group, device) -> bool:
    try:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    except RuntimeError:
        return False
    return True


def make_mesh(device="cuda", backend: Optional[str] = None, init_method: str = "env://",
              rank: Optional[int] = None, world_size: Optional[int] = None) -> Mesh:
    """The data-parallel mesh of this process on `device` (`cuda` takes the
    card of the local rank).  `rank` and `world_size` default to the
    environment's `RANK` and `WORLD_SIZE` (1 when unset).  A process group
    that is already initialised is used as it is."""
    if dist.is_initialized():
        rank, world_size, owns = dist.get_rank(), dist.get_world_size(), False
    else:
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
        owns = world_size > 1
    device = _resolve_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if world_size == 1:
        return Mesh(device=device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if owns:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    group = dist.group.WORLD
    staged = (device.type == "cuda" and dist.get_backend(group) == "gloo"
              and not _gloo_takes_cuda(group, device))
    return Mesh(rank=rank, world_size=world_size, device=device, group=group, staged=staged,
                owns_group=owns)


def _in_place(mesh: Mesh, t: torch.Tensor, collective) -> torch.Tensor:
    """collective(t) in place, through a pinned host copy where the mesh
    is staged."""
    if not mesh.staged:
        collective(t)
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    collective(host)
    return t.copy_(host)


def _all_reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place."""
    return _in_place(mesh, t, lambda x: dist.all_reduce(x, group=mesh.group))


def _broadcast_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Overwrite `t` with rank 0's copy."""
    return _in_place(mesh, t, lambda x: dist.broadcast(x, src=0, group=mesh.group))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks.  Every rank's loss reads y, so the
    gradient of the ranks' summed loss with respect to one rank's x is the
    sum of the ranks' gradients with respect to y: the backward all-reduces
    too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(mesh, x.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(ctx.mesh, g.contiguous().clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the mesh's ranks, differentiable."""
    return _AllReduceSum.apply(x, mesh)


def average_gradients(mesh: Mesh, params: List[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks: one
    flat buffer, one all-reduce.  A parameter with no gradient counts as a
    zero one (as `_guarded_update` treats it)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce_(mesh, flat).div_(mesh.world_size)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def global_means(mesh: Mesh, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar of `values` (a rank's mean over its shard) averaged over
    the ranks: the global batch's mean, the shards being equal."""
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    _all_reduce_(mesh, flat).div_(mesh.world_size)
    return {k: flat[i] for i, k in enumerate(keys)}


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous slice of every array of the global `batch`
    (numpy arrays or tensors, leading axis B); B must divide by the world
    size, as a NamedSharding over the batch axis requires."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % mesh.world_size:
            raise ValueError(f"shard_batch: {k} has a batch of {b}, which does not divide "
                             f"over {mesh.world_size} ranks")
        n = b // mesh.world_size
        out[k] = v[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def replicate(mesh: Mesh, state):
    """Broadcast the train state's parameters, buffers and Adam state from
    rank 0, and bind the mesh to the state and to the model's batch
    statistics.  Returns the state."""
    from etch_tpu_torch.nn.point_transformer import bind_mesh

    if mesh.world_size > 1:
        with torch.no_grad():
            for t in list(state.model.parameters()) + list(state.model.buffers()):
                _broadcast_(mesh, t)
            for st in state.optimizer.state.values():
                for t in st.values():
                    if torch.is_tensor(t):
                        _broadcast_(mesh, t)
            _broadcast_(mesh, state.step)
    bind_mesh(state.model, mesh)
    state.mesh = mesh
    return state
