"""Train state and train step.

Port of `etch_tpu/train/state.py` (reference loop body `src/train.py:60-140`):
Adam(cfg.lr) with optax's defaults (betas 0.9 / 0.999, eps 1e-8), the loss
sum, the NaN guard, and BatchNorm running statistics that advance in the
training forward.  The model holds the parameters and BN buffers, the
optimizer the Adam state; `TrainState.step` counts every step, skipped or
not.

The NaN guard (`_guarded_update`, the reference's `continue` past
`optimizer.step()` on a NaN loss, train.py:111-123): gradients pass through
`torch.nan_to_num`; on a non-finite loss the update is skipped entirely,
parameters, `exp_avg`, `exp_avg_sq` and Adam's own `step` bit-unchanged,
while the BN running statistics still advance (torch BN updates them in the
forward, before the check).  The skip is a device-side select, as the JAX
package's `jnp.where`: no step reads the loss on the host, and the step
returns its losses as device tensors.

A learning-rate schedule (`create_train_state(lr=cosine_decay_schedule(...))`,
the counterpart of the JAX `tx=optax.adam(schedule)`) is evaluated, as optax
evaluates it, at the count of updates made so far: Adam's own `step`, which
the guard restores on a skipped step, so the schedule skips with the update.
The learning rate is a tensor beside that count (on the card, `capturable`
Adam reads it there), set on the device before each update: no host read.

Data parallelism (`parallel/mesh.py`: `state = replicate(mesh, state)`,
each rank fed `shard_batch(mesh, batch)`): after the backward the
gradients are averaged over the ranks in one flat all-reduce, before the
guard's `nan_to_num` (a NaN on one rank zeroes that entry on every rank, as
in the JAX global gradient); the losses the step returns are the global
batch's means, and the guard decides on the global loss, so every rank
takes or skips the same update.

With `utils/trace.py` on, each step is a request whose spans mark the loss,
the backward, the all-reduce, Adam and the guard, and the guard adds each
skipped update to the device counter `step.skipped_updates`.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from etch_tpu_torch.models.etch_net import EtchNet, init_params
from etch_tpu_torch.parallel.mesh import Mesh, average_gradients, global_means
from etch_tpu_torch.train.losses import compute_losses
from etch_tpu_torch.utils import trace
from etch_tpu_torch.utils.config import EtchConfig

BATCH_KEYS = ("hitpts", "vectors", "confidences", "labels")
# Parameters whose exact gradient is zero at every input: a bias that an
# instance norm, a batch-statistic BatchNorm or a softmax removes, the
# first block's skip conv of the all-ones occupancy input (instance-
# normalised to 0), and the direction head's biases that shift all 60 anchor
# weights alike (the anchor rotations sum to zero).  Their gradients are
# rounding noise in either framework.
ZERO_GRADIENT = re.compile(
    r"(\.(inter|intra|skip_conv)\.bias|block0_conv0\.skip_conv\.weight|direction_head\.(bm1|br)"
    r"|transformer2\.(linear_[qkv]|linear_p[01])\.bias|transformer2\.w[01]_bias"
    r"|dec[1-4]_up\.linear[12]\.bias|dec5_up\.linear1\.bias|final0\.bias|cls0\.bias)$")


Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: EtchNet
    optimizer: torch.optim.Adam
    step: torch.Tensor   # () int64 on the model's device
    lr_schedule: Optional[Schedule] = None   # of Adam's update count; None: a fixed lr
    mesh: Optional[Mesh] = None   # data parallelism (`parallel/mesh.py::replicate`)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule as a function of a float32 count tensor:
    init_value * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count, T) / T)) +
    alpha), in f32 on the count's device."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")
    T = float(decay_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(count, max=T)
        cosine = 0.5 * (1 + torch.cos(math.pi * count / T))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: torch sees no CUDA device "
                           f"(pass device=\"cpu\" to train on the CPU)")
    return device


def make_optimizer(model: EtchNet, lr: Union[float, Schedule]) -> torch.optim.Adam:
    """Adam with optax's defaults and its state made up front (zero moments,
    step 0, as `optax.adam(lr).init`), so a step that is skipped has a state
    to keep.  On the card the step counter lives on the device
    (`capturable`), so the guard never reads it on the host.  With a
    schedule for `lr` the group's learning rate is a tensor beside the step
    counter, holding the schedule at count 0 (`_guarded_update` sets it
    before each update)."""
    params = list(model.parameters())
    capturable = params[0].is_cuda
    step_device = params[0].device if capturable else torch.device("cpu")
    if callable(lr):
        lr = lr(torch.zeros((), dtype=torch.float32, device=step_device))
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=capturable)
    for p in params:
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=step_device),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return opt


def create_train_state(
    cfg: EtchConfig,
    seed: int = 0,
    device="cuda",
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    lr: Union[float, Schedule, None] = None,
) -> Tuple[EtchNet, TrainState, torch.optim.Adam]:
    """Build model, state and optimizer on `device` (the card unless the
    caller asks for the CPU).  The weights are `state_dict` (e.g. from
    `convert.flax_to_state_dict`) or drawn from a `torch.Generator` seeded
    with `seed`.  `lr` overrides Adam's `cfg.lr` with another rate or a
    schedule of the update count (`cosine_decay_schedule`), as the JAX
    `tx=optax.adam(schedule)` does."""
    device = _device(device)
    model = EtchNet(cfg)
    if state_dict is None:
        init_params(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device)
    lr = cfg.lr if lr is None else lr
    opt = make_optimizer(model, lr)
    state = TrainState(model=model, optimizer=opt,
                       step=torch.zeros((), dtype=torch.int64, device=device),
                       lr_schedule=lr if callable(lr) else None)
    return model, state, opt


@torch.no_grad()
def _guarded_update(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Apply the Adam update, skipping it ENTIRELY on a non-finite loss (see
    the module docstring); NaN gradients on a finite-loss batch are zeroed."""
    opt = state.optimizer
    params = [p for group in opt.param_groups for p in group["params"]]
    with trace.span("step.guard"):
        for p in params:
            if p.grad is None:   # no path to the loss: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
            torch.nan_to_num(p.grad, out=p.grad)
        kept = []
        for p in params:   # each parameter and its optimizer state (Adam: moments and step)
            kept += [p] + [t for t in opt.state[p].values() if torch.is_tensor(t)]
        old = torch._foreach_mul(kept, 1.0)     # copies, bit for bit, in few launches
    with trace.span("step.adam"):
        if state.lr_schedule is not None:   # at the count of updates made so far
            for group in opt.param_groups:
                group["lr"].copy_(state.lr_schedule(opt.state[group["params"][0]]["step"]))
        opt.step()
    with trace.span("step.guard"):
        ok = torch.isfinite(loss)
        for t, o in zip(kept, old):
            torch.where(ok.to(t.device), t, o, out=t)
        if trace.enabled():
            trace.count_device("step.skipped_updates", ~ok)
        state.step += 1
    return state


def batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """The training arrays of a batch (numpy or tensors) on `device`."""
    return {k: torch.as_tensor(batch[k], device=device)
            for k in BATCH_KEYS + ("markers_positions",) if k in batch}


def _step(state: TrainState, batch, cfg: EtchConfig, targets):
    model, opt = state.model, state.optimizer
    with trace.request("step"):
        device = next(model.parameters()).device
        b = batch_to(batch, device)
        opt.zero_grad(set_to_none=True)
        outputs = model(b["hitpts"], train=True)
        with trace.span("step.loss"):
            confidences, labels = targets(outputs, b)
            losses = compute_losses(cfg, outputs, b["vectors"], confidences, labels)
        with trace.span("step.backward"):
            losses["all_loss"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if state.mesh is not None and state.mesh.world_size > 1:
            with trace.span("step.allreduce"):
                average_gradients(state.mesh, [p for g in opt.param_groups for p in g["params"]])
                losses = global_means(state.mesh, losses)
        _guarded_update(state, losses["all_loss"])
    return state, losses


def make_train_step(model: EtchNet, optimizer: torch.optim.Adam, cfg: EtchConfig):
    """The train step: `train_step(state, batch) -> (state, losses)`, the
    state updated in place, the losses device tensors."""

    def train_step(state: TrainState, batch):
        return _step(state, batch, cfg, lambda out, b: (b["confidences"], b["labels"]))

    return train_step


def dynamic_targets(cfg: EtchConfig, hitpts, outputs, markers):
    """Labels from the nearest marker to the *predicted* inner point, and
    confidence exp(-10 * that distance) (reference train_mixed.py:124-158);
    no gradient flows through them."""
    inner = (hitpts - outputs["direction"] * outputs["magnitude"]
             / cfg.scale_magnitude).detach()
    d = torch.linalg.norm(inner[:, :, None, :] - markers[:, None, :, :], dim=-1)
    return torch.exp(-10.0 * d.min(-1).values)[..., None], d.argmin(-1)


def make_train_step_dynamic(model: EtchNet, optimizer: torch.optim.Adam, cfg: EtchConfig):
    """Train step with dynamic label/confidence regeneration from the batch's
    `markers_positions` (B, M, 3): brute force over the markers on the
    device, as the JAX package does."""

    def train_step(state: TrainState, batch):
        return _step(state, batch, cfg, lambda out, b: dynamic_targets(
            cfg, b["hitpts"], out, b["markers_positions"]))

    return train_step


def make_eval_step(model: EtchNet):
    @torch.no_grad()
    def eval_step(state: TrainState, hitpts):
        device = next(state.model.parameters()).device
        return state.model(torch.as_tensor(hitpts, device=device), train=False)

    return eval_step
