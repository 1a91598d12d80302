"""Inter-SO(3)-conv contraction: plain versions and kernel launches.

Port of `etch_tpu/nn/pallas_interconv.py` (`interconv_t_pallas`, bodies
`_kernel` and `_kernel_ones`).  Unlike the JAX contract, which takes
pre-gathered relative coordinates and feature rows, both functions here take
the neighbour indices and gather themselves, so the CUDA kernel
(`csrc/interconv.cu`) can fuse both gathers:

    x_pn       = xyz[nbr[p, n]] - centers[p]
    w[p,n,a,k] = relu(1 - |x_pn - rk[a*K + k]|^2 / sigma)
    t[p,a,k,c] = sum_n w[p,n,a,k] * feats[nbr[p, n], a*C + c]   (interconv_t)
    t[p,a,k]   = sum_n w[p,n,a,k]                             (interconv_ones)

Shapes: xyz (B, P, 3), centers (B, c, 3), nbr (B, c, nn) int32, feats
(B, P, A*C) contiguous (the row layout `materialize_rows` pins on the TPU),
rk (A*K, 3) anchor-rotated kernel points.  CUDA tensors launch the kernel,
CPU tensors run the `*_torch` plain version.
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build
from etch_tpu_torch.ops.grouping import group_points

_TK, _TC = 3, 4        # per-thread (k, c) micro-tile of csrc/interconv.cu
_MAX_THREADS = 256     # threads per block the anchor group G is sized for
_SMEM_BYTES = 227 * 1024


def _weights(xyz, centers, nbr, rk, sigma):
    """(B, c, nn, A*K) kernel-point weights, one coordinate at a time so the
    (…, A*K, 3) difference tensor is never built."""
    gx = group_points(xyz, nbr) - centers[:, :, None, :]          # (B,c,nn,3)
    d = [gx[..., None, i] - rk[:, i] for i in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return torch.relu(1.0 - d2 / sigma)


def interconv_t_torch(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    """Plain contraction -> t (B, c, A, K, C) f32."""
    B, c, nn = nbr.shape
    K = rk.shape[0] // A
    C = feats.shape[-1] // A
    w = _weights(xyz, centers, nbr, rk, sigma).reshape(B, c, nn, A, K)
    gf = group_points(feats, nbr).reshape(B, c, nn, A, C)
    return torch.einsum("bcnak,bcnad->bcakd", w, gf)


def interconv_ones_torch(xyz, centers, nbr, rk, sigma: float, A: int):
    """Plain occupancy conv -> t (B, c, A, K) f32."""
    B, c, _ = nbr.shape
    return _weights(xyz, centers, nbr, rk, sigma).sum(2).reshape(B, c, A, -1)


def _anchor_group(A: int, per_anchor: int) -> int:
    """Largest divisor G of A with G * per_anchor <= _MAX_THREADS."""
    return max(g for g in range(1, A + 1)
               if A % g == 0 and g * per_anchor <= max(_MAX_THREADS, per_anchor))


def _check_geometry(name, xyz, centers, nbr, rk):
    device = _build.check_cuda(name, (xyz, torch.float32),
                               (centers, torch.float32), (nbr, torch.int32),
                               (rk, torch.float32))
    B, c, _ = nbr.shape
    if (xyz.shape[0] != B or xyz.shape[2] != 3 or centers.shape != (B, c, 3)
            or rk.ndim != 2 or rk.shape[1] != 3):
        raise ValueError(f"{name}: bad shapes xyz {tuple(xyz.shape)}, centers "
                         f"{tuple(centers.shape)}, nbr {tuple(nbr.shape)}, "
                         f"rk {tuple(rk.shape)}")
    return device


def interconv_t_cuda(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    device = _check_geometry("interconv_t", xyz, centers, nbr, rk)
    _build.check_cuda("interconv_t", (feats, torch.float32))
    B, c, nn = nbr.shape
    P = xyz.shape[1]
    K = rk.shape[0] // A
    C = feats.shape[-1] // A
    if feats.shape != (B, P, A * C) or rk.shape[0] != A * K:
        raise ValueError(f"interconv_t: feats {tuple(feats.shape)} is not "
                         f"(B, P, A*C) for A={A}")
    if K % _TK or C % _TC:
        raise ValueError(f"interconv_t: needs K % {_TK} == 0 and C % {_TC} "
                         f"== 0, got K={K}, C={C}")
    G = _anchor_group(A, (K // _TK) * (C // _TC))
    if G * (K // _TK) * (C // _TC) > 1024:
        raise ValueError(f"interconv_t: C={C} is too wide for one block")
    if 4 * nn * (4 + G * K + G * C) > _SMEM_BYTES:
        raise ValueError(f"interconv_t: nn={nn} neighbours do not fit shared "
                         f"memory")
    out = torch.empty((B, c, A, K, C), dtype=torch.float32, device=device)
    _build.launch("interconv_t", "etch_interconv_t", device, _build.ptr(xyz),
                  _build.ptr(centers), _build.ptr(nbr), _build.ptr(feats),
                  _build.ptr(rk), _build.ptr(out), B, P, c, nn, A, K, C, G,
                  float(sigma))
    return out


def interconv_ones_cuda(xyz, centers, nbr, rk, sigma: float, A: int):
    device = _check_geometry("interconv_ones", xyz, centers, nbr, rk)
    B, c, nn = nbr.shape
    AK = rk.shape[0]
    out = torch.empty((B, c, A, AK // A), dtype=torch.float32, device=device)
    _build.launch("interconv_ones", "etch_interconv_ones", device,
                  _build.ptr(xyz), _build.ptr(centers), _build.ptr(nbr),
                  _build.ptr(rk), _build.ptr(out), B, xyz.shape[1], c, nn, AK,
                  float(sigma))
    return out


def interconv_t(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    """t (B, c, A, K, C): kernel on CUDA, plain version on CPU."""
    if xyz.is_cuda:
        return interconv_t_cuda(xyz, centers, nbr, feats, rk, sigma, A)
    if xyz.device.type == "cpu":
        return interconv_t_torch(xyz, centers, nbr, feats, rk, sigma, A)
    raise ValueError(f"interconv_t: unsupported device {xyz.device}")


def interconv_ones(xyz, centers, nbr, rk, sigma: float, A: int):
    """Occupancy t (B, c, A, K): kernel on CUDA, plain version on CPU."""
    if xyz.is_cuda:
        return interconv_ones_cuda(xyz, centers, nbr, rk, sigma, A)
    if xyz.device.type == "cpu":
        return interconv_ones_torch(xyz, centers, nbr, rk, sigma, A)
    raise ValueError(f"interconv_ones: unsupported device {xyz.device}")
