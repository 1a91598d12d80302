"""Inter-SO(3)-conv contraction: plain versions and kernel launches.

Port of `etch_tpu/nn/pallas_interconv.py` (`interconv_t_pallas`, bodies
`_kernel`, `_kernel_ones`, `_kernel_ones_proj` and `_kernel_c1`).  Unlike
the JAX contract, which takes pre-gathered relative coordinates and feature
rows, the functions here take the neighbour indices and gather themselves,
so the CUDA kernels (`csrc/interconv.cu`) can fuse both gathers:

    x_pn       = xyz[nbr[p, n]] - centers[p]
    w[p,n,a,k] = relu(1 - |x_pn - rk[a*K + k]|^2 / sigma)
    t[p,a,k,c] = sum_n w[p,n,a,k] * feats[nbr[p, n], a*C + c]   (interconv_t)
    t[p,a,k]   = sum_n w[p,n,a,k] * feats[nbr[p, n], a]       (interconv_t_c1)
    t[p,a,k]   = sum_n w[p,n,a,k]                             (interconv_ones)
    o[p,a,o]   = sum_k bf16(t[p,a,k]) * bf16(W[k, o])         (interconv_ones_proj)

With bf16 feature rows (the serving path) `interconv_t` rounds w to bf16
before the multiply, sums in f32 and returns t as bf16, as the TPU kernel
does; `interconv_ones_proj` returns bf16 too.  `interconv_t` sends
1-channel rows (C == 1, rows that are not the occupancy input: an EPN
schedule with a 1-channel conv after the first) to `interconv_t_c1`, which
keeps `_kernel_c1`'s rounding: w exact in f32 (not rounded to bf16, unlike
C > 1 and unlike the JAX XLA path), f32 sums, t rounded to bf16 on bf16
rows only.  The weights w are exact everywhere (the TPU's approximate
`fast_w` variant is not ported).

Shapes: xyz (B, P, 3), centers (B, c, 3), nbr (B, c, nn) int32, feats
(B, P, A*C) contiguous (the row layout `materialize_rows` pins on the TPU),
rk (A*K, 3) anchor-rotated kernel points.  CUDA tensors launch the kernel,
CPU tensors run the `*_torch` plain version.

Autograd: `interconv_t`, `interconv_ones` and `interconv_ones_proj` go
through a `torch.autograd.Function` each (`InterconvT`, `InterconvOnes`,
`InterconvOnesProj`).  The forward is the kernel on the card (the plain
version on the CPU); the backward recomputes the plain twin under
`torch.enable_grad()` and takes its autograd, as the JAX package's custom
VJPs run the XLA reference, never Pallas
(`etch_tpu/nn/pallas_interconv.py:355-371`, `:408-412`).  Gradients flow to
xyz, centers, feats and the projection w; nbr and rk get none.  float64
operands (the gradient checks) skip the bf16 rounding of the occupancy
projection: the function there is the unrounded one.
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build
from etch_tpu_torch.nn.bf16 import BF16, rnd
from etch_tpu_torch.ops.grouping import group_points

_SMEM_BYTES = 227 * 1024
# both tensor-core bodies take up to 64 channels a block; a wider row runs as
# ceil(C / 64) channel slices of 64 on one launch's third grid axis, the last
# ending at the row's end (`csrc/interconv.cu:launch_slices`)
_SLICE = 64
# the bf16 body: 4 warps a block, kernel points in blocks of 32 (two m16
# tiles), neighbours gathered in chunks of 64, C a multiple of the n8 tile
_MMA_WARPS, _MMA_KP, _MMA_CHUNK, _MMA_C = 4, 32, 64, 8
# the f32 body (3xTF32): C a multiple of 4, neighbours gathered in chunks of 32
_TF32_C, _TF32_CHUNK = 4, 32
# the occupancy conv and the C == 1 body: neighbours staged 64 at a time
_W_CHUNK = 64


def _weights(xyz, centers, nbr, rk, sigma):
    """(B, c, nn, A*K) kernel-point weights, one coordinate at a time so the
    (…, A*K, 3) difference tensor is never built."""
    gx = group_points(xyz, nbr) - centers[:, :, None, :]          # (B,c,nn,3)
    d = [gx[..., None, i] - rk[:, i] for i in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return torch.relu(1.0 - d2 / sigma)


def interconv_t_torch(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    """Plain contraction -> t (B, c, A, K, C), in the type of feats."""
    B, c, nn = nbr.shape
    K = rk.shape[0] // A
    C = feats.shape[-1] // A
    w = _weights(xyz, centers, nbr, rk, sigma)
    if feats.dtype == BF16:
        w = rnd(w)
    w = w.reshape(B, c, nn, A, K)
    gf = group_points(feats, nbr).to(w.dtype).reshape(B, c, nn, A, C)
    return torch.einsum("bcnak,bcnad->bcakd", w, gf).to(feats.dtype)


def interconv_t_c1_torch(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    """Plain contraction on 1-channel rows feats (B, P, A) -> t (B, c, A, K, 1),
    in the type of feats, from exact f32 weights and f32 sums."""
    B, c, nn = nbr.shape
    w = _weights(xyz, centers, nbr, rk, sigma).reshape(B, c, nn, A, -1)
    gf = group_points(feats, nbr).to(w.dtype)                      # (B,c,nn,A)
    return torch.einsum("bcnak,bcna->bcak", w, gf)[..., None].to(feats.dtype)


def interconv_ones_torch(xyz, centers, nbr, rk, sigma: float, A: int):
    """Plain occupancy conv -> t (B, c, A, K) f32."""
    B, c, _ = nbr.shape
    return _weights(xyz, centers, nbr, rk, sigma).sum(2).reshape(B, c, A, -1)


def interconv_ones_proj_torch(xyz, centers, nbr, rk, sigma: float, A: int, w):
    """Plain occupancy conv + (K -> Co) projection, w (K, Co) -> (B, c, A, Co)
    bf16 (float64 for float64 operands: no rounding)."""
    t = interconv_ones_torch(xyz, centers, nbr, rk, sigma, A)
    if w.dtype == torch.float64:
        return t @ w
    return (rnd(t) @ rnd(w)).to(BF16)


def padded_channels(C: int, bf16: bool) -> int:
    """The channel count a body runs C at: C rounded up to the body's grain
    (8 for bf16, 4 for f32); the wrapper pads each anchor's row with zero
    channels up to it."""
    grain = _MMA_C if bf16 else _TF32_C
    return -(-C // grain) * grain


def mma_smem_bytes(nn: int, K: int, C: int) -> int:
    """Shared memory of one block of the bf16 body (`csrc/interconv.cu`):
    offsets (float4) and indices of nn padded to 16 neighbours, then per
    warp a ring of two feature tiles of max(min(nn_pad, 64), min(K, 32))
    rows of the widest slice's channels (C padded, up to 64) + 8 bf16
    values."""
    np_ = -(-nn // 16) * 16
    rows = max(min(np_, _MMA_CHUNK), min(K, _MMA_KP))
    return 20 * np_ + _MMA_WARPS * 2 * rows * (min(padded_channels(C, True), _SLICE) + 8) * 2


def check_mma_geometry(nn: int, K: int, C: int) -> None:
    """Raise on a contraction the bf16 body does not take: only more
    neighbours than their offsets and indices leave room for (20 bytes
    each beside the ring: about 7,900 at 64 channels)."""
    if mma_smem_bytes(nn, K, C) > _SMEM_BYTES:
        raise ValueError(f"interconv_t_bf16: nn={nn} neighbours do not fit shared memory")


def tf32_smem_bytes(nn: int, C: int) -> int:
    """Shared memory of one block of the f32 body (`csrc/interconv.cu`):
    offsets (float4) and indices of nn padded to 32-neighbour chunks, then
    per warp a ring of two 32-row f32 tiles whose rows are the widest
    slice's channels (C padded, up to 64) rounded up to 16, plus 8, values
    long."""
    np_ = -(-nn // _TF32_CHUNK) * _TF32_CHUNK
    Cs = min(padded_channels(C, False), _SLICE)
    return 20 * np_ + _MMA_WARPS * 2 * _TF32_CHUNK * (-(-Cs // 16) * 16 + 8) * 4


def check_tf32_geometry(nn: int, C: int) -> None:
    """Raise on a contraction the f32 body does not take: only more
    neighbours than their offsets and indices leave room for."""
    if tf32_smem_bytes(nn, C) > _SMEM_BYTES:
        raise ValueError(f"interconv_t: nn={nn} neighbours do not fit shared memory")


def w_smem_bytes(nn: int, A: int, K: int, feat: bool) -> int:
    """Shared memory of one block of the occupancy conv (feat False) or the
    C == 1 body (feat True): a chunk of at most 64 neighbours' offsets
    (float4) and, for C == 1, their (A) f32 feature rows, and the staged
    (A*K) f32 row.  Bounded in nn: no neighbour count is refused."""
    cn = min(nn, _W_CHUNK)
    return cn * 16 + -(-A * K // 4) * 4 * 4 + (cn * A * 4 if feat else 0)


def pad_channels(feats, A: int, C: int, Cp: int):
    """(B, P, A*C) rows -> (B, P, A*Cp), each anchor's C channels followed by
    Cp - C zeros (a copy of the rows)."""
    B, P, _ = feats.shape
    out = feats.new_zeros((B, P, A, Cp))
    out[..., :C] = feats.reshape(B, P, A, C)
    return out.reshape(B, P, A * Cp)


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
    """f32 feature rows launch `interconv_t`, bf16 rows `interconv_t_bf16`,
    both on the tensor cores (3xTF32 products for f32 accuracy, bf16
    products).  Any width, any K and any nn up to the shared-memory check:
    rows wider than 64 channels run as channel slices
    (`csrc/interconv.cu:launch_slices`), as the 128- and 256-channel EPN
    blocks of `epn_layer_num` 3 and 4 need; a C off the body's grain (f32:
    C % 4, bf16: C % 8 or C < 8) runs on rows padded with zero channels and
    t is sliced back, which costs a copy of the rows and of t, acceptable
    at the widths no timed request runs (the reference's are multiples of
    8)."""
    bf16 = feats.dtype == BF16
    name = "interconv_t_bf16" if bf16 else "interconv_t"
    device = _check_geometry(name, xyz, centers, nbr, rk)
    _build.check_cuda(name, (feats, BF16 if bf16 else torch.float32))
    B, c, nn = nbr.shape
    P = xyz.shape[1]
    K = rk.shape[0] // A
    C = feats.shape[-1] // A
    if feats.shape != (B, P, A * C) or rk.shape[0] != A * K:
        raise ValueError(f"interconv_t: feats {tuple(feats.shape)} is not "
                         f"(B, P, A*C) for A={A}")
    if feats.data_ptr() % 16:
        raise ValueError(f"{name}: feats must start on a 16-byte boundary")
    if bf16:
        check_mma_geometry(nn, K, C)
    else:
        check_tf32_geometry(nn, C)
    Cp = padded_channels(C, bf16)
    rows = feats if Cp == C else pad_channels(feats, A, C, Cp)
    out = torch.empty((B, c, A, K, Cp), dtype=feats.dtype, device=device)
    _build.launch(name, f"etch_{name}", device, _build.ptr(xyz),
                  _build.ptr(centers), _build.ptr(nbr), _build.ptr(rows),
                  _build.ptr(rk), _build.ptr(out), B, P, c, nn, A, K, Cp, float(sigma))
    return out if Cp == C else out[..., :C].contiguous()


def interconv_t_c1_cuda(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    """1-channel rows (B, P, A), f32 or bf16, launch `interconv_t_c1`; any
    nn (neighbours staged 64 at a time)."""
    bf16 = feats.dtype == BF16
    device = _check_geometry("interconv_t_c1", xyz, centers, nbr, rk)
    _build.check_cuda("interconv_t_c1", (feats, BF16 if bf16 else torch.float32))
    B, c, nn = nbr.shape
    P = xyz.shape[1]
    K = rk.shape[0] // A
    if feats.shape != (B, P, A) or rk.shape[0] != A * K:
        raise ValueError(f"interconv_t_c1: feats {tuple(feats.shape)} is not (B, P, A) "
                         f"for A={A}")
    out = torch.empty((B, c, A, K, 1), dtype=feats.dtype, device=device)
    _build.launch("interconv_t_c1", "etch_interconv_t_c1_bf16" if bf16 else
                  "etch_interconv_t_c1", device, _build.ptr(xyz), _build.ptr(centers),
                  _build.ptr(nbr), _build.ptr(feats), _build.ptr(rk), _build.ptr(out), B, P,
                  c, nn, A, K, float(sigma))
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


def interconv_ones_proj_cuda(xyz, centers, nbr, rk, sigma: float, A: int, w):
    device = _check_geometry("interconv_ones_proj", xyz, centers, nbr, rk)
    _build.check_cuda("interconv_ones_proj", (w, torch.float32))
    B, c, nn = nbr.shape
    AK = rk.shape[0]
    K, Co = w.shape
    if AK != A * K:
        raise ValueError(f"interconv_ones_proj: w {tuple(w.shape)} does not match "
                         f"A*K = {AK} kernel points for A={A}")
    wb = w.to(BF16)
    out = torch.empty((B, c, A, Co), dtype=BF16, device=device)
    _build.launch("interconv_ones_proj", "etch_interconv_ones_proj", device,
                  _build.ptr(xyz), _build.ptr(centers), _build.ptr(nbr),
                  _build.ptr(rk), _build.ptr(wb), _build.ptr(out), B, xyz.shape[1],
                  c, nn, A, K, Co, float(sigma))
    return out


def _forward_route(name, xyz, cuda, plain):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if xyz.is_cuda:
        return cuda
    if xyz.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: unsupported device {xyz.device}")


def _plain_grads(ctx, g, plain, diff):
    """Gradients of `plain(*diff)` against cotangent g for the inputs in
    `diff` that need one (None for the rest), from the plain twin's autograd
    on detached copies of the saved inputs."""
    need = ctx.needs_input_grad[:len(diff)]
    if not any(need):
        return (None,) * len(diff)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(diff, need)]
        got = iter(torch.autograd.grad(plain(*ins), [t for t, n in zip(ins, need) if n], g))
    return tuple(next(got) if n else None for n in need)


def _contraction(feats, A: int, cuda: bool):
    """The contraction's kernel (cuda) or plain version for these rows:
    1-channel rows take the C == 1 body."""
    if feats.shape[-1] == A:
        return interconv_t_c1_cuda if cuda else interconv_t_c1_torch
    return interconv_t_cuda if cuda else interconv_t_torch


class InterconvT(torch.autograd.Function):
    """The contraction with gradients to xyz, centers and feats."""

    @staticmethod
    def forward(ctx, xyz, centers, feats, nbr, rk, sigma: float, A: int):
        ctx.save_for_backward(xyz, centers, feats, nbr, rk)
        ctx.sigma, ctx.A = sigma, A
        fn = _forward_route("interconv_t", xyz, _contraction(feats, A, True),
                            _contraction(feats, A, False))
        return fn(xyz, centers, nbr, feats, rk, sigma, A)

    @staticmethod
    def backward(ctx, g):
        xyz, centers, feats, nbr, rk = ctx.saved_tensors
        plain = _contraction(feats, ctx.A, False)
        grads = _plain_grads(ctx, g, lambda x, ct, f: plain(x, ct, nbr, f, rk, ctx.sigma, ctx.A),
                             (xyz, centers, feats))
        return grads + (None,) * 4


class InterconvOnes(torch.autograd.Function):
    """The occupancy conv with gradients to xyz and centers."""

    @staticmethod
    def forward(ctx, xyz, centers, nbr, rk, sigma: float, A: int):
        ctx.save_for_backward(xyz, centers, nbr, rk)
        ctx.sigma, ctx.A = sigma, A
        fn = _forward_route("interconv_ones", xyz, interconv_ones_cuda, interconv_ones_torch)
        return fn(xyz, centers, nbr, rk, sigma, A)

    @staticmethod
    def backward(ctx, g):
        xyz, centers, nbr, rk = ctx.saved_tensors
        grads = _plain_grads(
            ctx, g, lambda x, ct: interconv_ones_torch(x, ct, nbr, rk, ctx.sigma, ctx.A),
            (xyz, centers))
        return grads + (None,) * 4


class InterconvOnesProj(torch.autograd.Function):
    """The occupancy conv with its projection, gradients to xyz, centers and
    the projection w."""

    @staticmethod
    def forward(ctx, xyz, centers, w, nbr, rk, sigma: float, A: int):
        ctx.save_for_backward(xyz, centers, w, nbr, rk)
        ctx.sigma, ctx.A = sigma, A
        fn = _forward_route("interconv_ones_proj", xyz, interconv_ones_proj_cuda,
                            interconv_ones_proj_torch)
        return fn(xyz, centers, nbr, rk, sigma, A, w)

    @staticmethod
    def backward(ctx, g):
        xyz, centers, w, nbr, rk = ctx.saved_tensors
        grads = _plain_grads(
            ctx, g,
            lambda x, ct, ww: interconv_ones_proj_torch(x, ct, nbr, rk, ctx.sigma, ctx.A, ww),
            (xyz, centers, w))
        return grads + (None,) * 4


def interconv_t(xyz, centers, nbr, feats, rk, sigma: float, A: int):
    """t (B, c, A, K, C): kernel on CUDA, plain version on CPU; C == 1 rows
    take the 1-channel body.  Differentiable (`InterconvT`)."""
    return InterconvT.apply(xyz, centers, feats, nbr, rk, sigma, A)


def interconv_ones(xyz, centers, nbr, rk, sigma: float, A: int):
    """Occupancy t (B, c, A, K): kernel on CUDA, plain version on CPU.
    Differentiable (`InterconvOnes`)."""
    return InterconvOnes.apply(xyz, centers, nbr, rk, sigma, A)


def interconv_ones_proj(xyz, centers, nbr, rk, sigma: float, A: int, w):
    """Occupancy conv projected by w (K, Co) -> (B, c, A, Co) bf16: kernel on
    CUDA, plain version on CPU.  Differentiable (`InterconvOnesProj`)."""
    return InterconvOnesProj.apply(xyz, centers, w, nbr, rk, sigma, A)
