"""Farthest point sampling on dense batched clouds.

Port of `etch_tpu/ops/fps.py`.  `fps` dispatches on the device of its input:
a CUDA tensor launches the hand-written kernel (`csrc/fps.cu`, replacing
`etch_tpu/ops/pallas_fps.py:fps_pallas`), a CPU tensor runs `fps_torch`, the
plain version with the same semantics (`_fps_xla`): start from point 0, then
greedily pick the argmax of the running min squared distance, the smaller
index winning ties.
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build

# csrc/fps.cu keeps up to this many points a cloud in registers; above it the
# cloud and its running minimum stream from a (B, N, 4) f32 scratch
_FPS_REG_POINTS = 8192


def _sqdist(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz, one rounding per op, as the kernels compute it."""
    return (dx * dx + dy * dy) + dz * dz


def fps_torch(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version.  xyz (B, N, 3) f32 -> (B, m) int32."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mind = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    idx = torch.zeros((B, m), dtype=torch.int64, device=xyz.device)
    last = idx[:, :1]
    for i in range(1, m):
        d = _sqdist(x - x.gather(1, last), y - y.gather(1, last),
                    z - z.gather(1, last))
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1, keepdim=True)
        idx[:, i:i + 1] = last
    return idx.to(torch.int32)


def fps_cuda(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Kernel launch.  xyz (B, N, 3) f32 CUDA -> (B, m) int32, any N."""
    device = _build.check_cuda("fps", (xyz, torch.float32))
    B, N, _ = xyz.shape
    out = torch.empty((B, m), dtype=torch.int32, device=device)
    scratch = (torch.empty((B, N, 4), dtype=torch.float32, device=device)
               if N > _FPS_REG_POINTS else None)
    _build.launch("fps", "etch_fps", device, _build.ptr(xyz), _build.ptr(out),
                  None if scratch is None else _build.ptr(scratch), B, N, m)
    return out


def fps(xyz: torch.Tensor, m: int, lazy: bool = False) -> torch.Tensor:
    """Select m centers per cloud.  xyz: (B, N, 3) -> idx (B, m) int32.

    `lazy` (or m == N) returns arange without sampling, as the reference's
    `lazy_sample` shortcut does.
    """
    B, N, _ = xyz.shape
    if lazy or N == m:
        return torch.arange(m, dtype=torch.int32, device=xyz.device).expand(B, m)
    if m > N:
        raise ValueError(f"fps: m={m} > N={N}")
    if xyz.is_cuda:
        return fps_cuda(xyz, m)
    if xyz.device.type == "cpu":
        return fps_torch(xyz, m)
    raise ValueError(f"fps: unsupported device {xyz.device}")
