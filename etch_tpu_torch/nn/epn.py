"""SE(3)-locally-equivariant point network (EPN) backbone, f32 serving path.

Port of `etch_tpu/nn/epn.py` (`InterSO3Conv`, `IntraSO3Conv`,
`InstanceNormPA`, `SeparableSO3ConvBlock`, `EPNBackbone`).  Features are
dense (B, P, A, C) with A = 60 anchors, channels last, as in the JAX package.

  - `InterSO3Conv` runs FPS (or the lazy arange), the ball query, then the
    kernel-point contraction chunk by chunk over the sampled centers (512 at
    a time, as the JAX package streams them) and the (K*C -> C_out)
    projection, which stays a plain matmul.  The contraction is the CUDA
    kernel of `nn/interconv.py` on the card, whose autograd Function takes
    the plain twin's gradient.  Under autograd each chunk is recomputed in
    the backward pass (`torch.utils.checkpoint`, the JAX package's
    `jax.checkpoint` around its chunk), so the (chunk, nn, A*K) weights are
    never kept.
  - `IntraSO3Conv` uses the reference form: gather the 12 neighbouring
    anchors along `get_intra_idx()` and apply one (12*C -> C_out) matmul.
    The JAX package folds the gather into a block-sparse (A*C -> A*C_out)
    matmul instead (a TPU trade); the sum runs in another order, so the two
    agree to f32 rounding, not bit for bit.

`compute_dtype=torch.bfloat16` is the bf16 serving path (JAX
`compute_dtype=bfloat16`): the features stream as bf16 rows into the
contraction (bf16 t), the (K*C -> C_out) projection and the intra conv take
bf16 operands with f32 sums and f32 outputs, and the occupancy conv runs
with its projection fused (`interconv_ones_proj`, bf16 output).  Instance
norm statistics stay in float64 and the skip conv in f32, as in the JAX
package (whose skip Dense has no dtype).

Each conv block ends in three norms, each followed by a leaky ReLU, and the
skip sum (`SeparableSO3ConvBlock.forward`).  `norm_act` runs each as one
call: on a CUDA tensor that autograd does not record, the hand-written
kernel `csrc/instance_norm.cu` (norm, activation and sum in one pass over
the statistics and one over the output, counted in `epn.norm_fused`);
elsewhere (the CPU, training) `norm_act_torch`, the same ops in plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from etch_tpu_torch import _build
from etch_tpu_torch.geometry.icosahedral import get_anchors, get_intra_idx
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn.bf16 import mm
from etch_tpu_torch.nn.interconv import interconv_ones, interconv_ones_proj, interconv_t
from etch_tpu_torch.ops import ball_query, fps, gather_points
from etch_tpu_torch.utils import trace

# csrc/instance_norm.cu: threads a block (its kThreads); the blocks a pass
# aims at (8 of 256 threads on each of the H100's 132 SMs) and the fewest
# rows a thread takes statistics of (both from timings on the H100 at the
# serving shapes, B = 1, 8 and 32)
_NORM_THREADS = 256
_NORM_BLOCKS = 1056
_NORM_ROWS = 48
NORM_EPS = 1e-5


def instance_norm_pa(x: torch.Tensor, eps: float = NORM_EPS) -> torch.Tensor:
    """InstanceNorm over the (point, anchor) axes per channel, no affine
    (torch InstanceNorm2d(C, affine=False) on (B, C, P, A)).

    The statistics are taken in float64.  The first block's skip branch
    normalises a per-channel constant (a Dense of the all-ones occupancy
    input); f32 statistics turn it into rounding noise times 1/sqrt(eps)
    = 316, different on every device and summation order, while float64
    statistics of a constant are exact and give the exact result, 0.
    """
    x64 = x.double()
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = x64.var(dim=(1, 2), keepdim=True, unbiased=False)
    return ((x64 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_act_torch(x: torch.Tensor, slope: float, residual=None) -> torch.Tensor:
    """Plain version: leaky_relu(instance_norm_pa(x), slope), plus
    `residual` (residual + that, the block's skip sum) where given."""
    y = torch.nn.functional.leaky_relu(instance_norm_pa(x), slope)
    return y if residual is None else residual + y


def norm_splits(B: int, rows: int, C: int, vec: int) -> int:
    """The row splits a batch element's statistics are taken in, by a launch
    of csrc/instance_norm.cu on (B, rows, C) in channel groups of `vec`:
    about _NORM_BLOCKS blocks a pass, with at least _NORM_ROWS rows a
    thread."""
    groups = C // vec
    tile = min(groups, _NORM_THREADS)
    lanes, tiles = _NORM_THREADS // tile, -(-groups // tile)
    return max(1, min(-(-_NORM_BLOCKS // (B * tiles)), -(-rows // (lanes * _NORM_ROWS))))


def norm_act_cuda(x: torch.Tensor, slope: float, residual=None) -> torch.Tensor:
    """Kernel launch: `norm_act_torch` on x (B, P, A, C) f32 CUDA, any C >= 1
    and P * A >= 1; residual, where given, f32 of x's shape on its device;
    all contiguous."""
    pairs = [(x, torch.float32)] + ([] if residual is None else [(residual, torch.float32)])
    device = _build.check_cuda("instance_norm", *pairs)
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"instance_norm: x must be a non-empty (B, P, A, C), got "
                         f"{tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"instance_norm: residual {tuple(residual.shape)} vs x "
                         f"{tuple(x.shape)}")
    B, P, A, C = x.shape
    rows = P * A
    out = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, residual) if t is not None)
    vec = 4 if C % 4 == 0 and aligned else 1
    splits = norm_splits(B, rows, C, vec)
    scratch = torch.empty(B * (3 * splits + 2) * C, dtype=torch.float64, device=device)
    trace.count("epn.norm_fused")
    sizes = (B, rows, C, vec, splits, float(slope), NORM_EPS)
    if residual is None:
        _build.launch("instance_norm", "etch_instance_norm", device, _build.ptr(x),
                      _build.ptr(out), _build.ptr(scratch), *sizes)
    else:
        _build.launch("instance_norm", "etch_instance_norm_residual", device, _build.ptr(x),
                      _build.ptr(residual), _build.ptr(out), _build.ptr(scratch), *sizes)
    return out


def norm_act(x: torch.Tensor, slope: float, residual=None) -> torch.Tensor:
    """leaky_relu(instance_norm_pa(x), slope) [+ residual]: the kernel on a
    CUDA tensor that autograd does not record, the plain version elsewhere."""
    recorded = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, residual))
    if x.is_cuda and not recorded:
        return norm_act_cuda(x, slope, residual)
    return norm_act_torch(x, slope, residual)


class InterSO3Conv(nn.Module):
    """Spatial equivariant conv (reference vgtk modules.py:92-128)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int,
                 radius: float, sigma: float, n_neighbor: int, lazy_sample: bool,
                 occupancy_input: bool = False, chunk: int = 512, compute_dtype=None,
                 **_):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dim_in, self.dim_out = dim_in, dim_out
        self.stride, self.radius, self.sigma = stride, radius, sigma
        self.n_neighbor, self.lazy_sample = n_neighbor, lazy_sample
        self.occupancy_input, self.chunk = occupancy_input, chunk
        kernels = get_kernel_points(radius, kernel_size)          # (K, 3)
        anchors = get_anchors(60)                                  # (A, 3, 3)
        self.A, self.K = anchors.shape[0], kernels.shape[0]
        rk = np.einsum("aij,kj->aki", anchors, kernels).reshape(-1, 3)
        self.register_buffer("rk", torch.from_numpy(np.ascontiguousarray(rk)),
                             persistent=False)
        self.W = nn.Parameter(torch.empty(self.K * dim_in, dim_out))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor):
        """xyz (B, P, 3), feats (B, P, A, C) -> (new_xyz, out (B, P2, A, Co),
        sample_idx (B, P2))."""
        B, P, A, C = feats.shape
        if C != self.dim_in or A != self.A:
            raise ValueError(f"InterSO3Conv: feats {tuple(feats.shape)} vs "
                             f"dim_in={self.dim_in}, A={self.A}")
        P2 = -(-P // self.stride)
        sample_idx = fps(xyz, P2, lazy=self.lazy_sample)
        new_xyz = gather_points(xyz, sample_idx)
        nbr = ball_query(new_xyz, xyz, self.radius, self.n_neighbor)
        if self.occupancy_input:
            # all-ones occupancy input (reference functional.py:70-89): the
            # contraction is a neighbour sum of the weights, no feature read
            if C != 1:
                raise ValueError(f"occupancy conv expects C=1, got C={C}")
            flat = None
        else:
            # rows streamed in the compute type, flattened before the gather
            flat = feats.to(self.compute_dtype or feats.dtype).reshape(B, P, A * C)
            flat = flat.contiguous()
        outs = []
        for s in range(0, P2, self.chunk):
            ctr = new_xyz[:, s:s + self.chunk].contiguous()
            idx = nbr[:, s:s + self.chunk].contiguous()
            if torch.is_grad_enabled():
                outs.append(checkpoint(self._chunk, xyz, ctr, idx, flat, use_reentrant=False,
                                       preserve_rng_state=False))
            else:
                outs.append(self._chunk(xyz, ctr, idx, flat))
        return new_xyz, torch.cat(outs, dim=1), sample_idx

    def _chunk(self, xyz, ctr, idx, flat):
        """One chunk of centers: contraction, then the (K*C -> Co)
        projection -> (B, c, A, Co) f32."""
        B, c = idx.shape[:2]
        A, C = self.A, self.dim_in
        W = self.W.reshape(self.K * C, self.dim_out)
        bf16 = self.compute_dtype is not None
        if flat is None and bf16:
            # occupancy conv with the (K -> Co) projection fused in
            o = interconv_ones_proj(xyz, ctr, idx, self.rk, self.sigma, A, W)
            return o.float() + self.bias
        if flat is None:
            t = interconv_ones(xyz, ctr, idx, self.rk, self.sigma, A)
        else:
            t = interconv_t(xyz, ctr, idx, flat, self.rk, self.sigma, A)
        # (K*C -> Co) projection, W row index k*C + c (K-major)
        return mm(t.reshape(B, c, A, self.K * C), W, bf16, self.bias)


class IntraSO3Conv(nn.Module):
    """Rotation-group conv over the 12-neighbour anchor adjacency
    (reference vgtk modules.py:131-153), gather + (12*C -> O) matmul."""

    def __init__(self, dim_in: int, dim_out: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        intra = np.asarray(get_intra_idx(), np.int64)              # (A, 12)
        self.register_buffer("intra_idx", torch.from_numpy(intra), persistent=False)
        self.W = nn.Parameter(torch.empty(intra.shape[1] * dim_in, dim_out))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        B, P, A, C = feats.shape
        bf16 = self.compute_dtype is not None
        if bf16:   # round before the 12x gather: the same values, 1/12 the work
            feats = feats.to(self.compute_dtype)
        g = feats[:, :, self.intra_idx, :]                         # (B,P,A,12,C)
        return mm(g.reshape(B, P, A, -1), self.W, bf16, self.bias)


class SeparableSO3ConvBlock(nn.Module):
    """inter-conv -> intra-conv with a normalised skip connection
    (reference src/models/so3conv.py:145-183)."""

    negative_slope = 0.01  # torch leaky_relu default

    def __init__(self, spec: dict, compute_dtype=None):
        super().__init__()
        self.stride = spec["stride"]
        self.inter = InterSO3Conv(**spec, compute_dtype=compute_dtype)
        self.intra = IntraSO3Conv(spec["dim_out"], spec["dim_out"], compute_dtype)
        self.skip_conv = nn.Linear(spec["dim_in"], spec["dim_out"])

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor):
        slope = self.negative_slope
        new_xyz, x, sample_idx = self.inter(xyz, feats)
        h = norm_act(x, slope)
        h = norm_act(self.intra(h), slope)
        skip = feats
        if self.stride > 1:
            skip = gather_points(skip, sample_idx)
        # h + leaky_relu(norm(skip_conv(skip))): the skip branch's norm takes h
        # as its residual
        return new_xyz, norm_act(self.skip_conv(skip), slope, residual=h)


class EPNBackbone(nn.Module):
    """Stack of separable SO(3) conv blocks driven by `backbone_plan`
    (reference so3net.py:10-33, 36-152).  With `utils/trace.py` on, each
    block's forward (its convs) runs inside the span `epn.block<i>`."""

    def __init__(self, plan, compute_dtype=None):
        super().__init__()
        self.names, self.blocks = [], []
        for bi, block in enumerate(plan):
            self.blocks.append([])
            for ci, spec in enumerate(block):
                name = f"block{bi}_conv{ci}"
                self.add_module(name, SeparableSO3ConvBlock(spec, compute_dtype))
                self.names.append(name)
                self.blocks[bi].append(name)

    def forward(self, xyz: torch.Tensor):
        """xyz (B, P, 3) -> (xyz', feats (B, P', 60, C_last))."""
        B, P, _ = xyz.shape
        feats = torch.ones((B, P, 60, 1), dtype=xyz.dtype, device=xyz.device)
        for bi, names in enumerate(self.blocks):
            with trace.span(f"epn.block{bi}"):
                for name in names:
                    xyz, feats = getattr(self, name)(xyz, feats)
        return xyz, feats
