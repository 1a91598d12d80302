"""SO(3) utilities in PyTorch: rotation conversions and the weighted
chordal mean.

Port of `etch_tpu/geometry/so3.py` (reference `src/models/so3conv.py:
186-225`, `src/utils/rotation_conversions.py`): the chordal projection the
direction head uses (`project_to_so3`, Davenport's q-method) and its SVD
form kept for tests (`project_to_so3_svd`), `so3_mean`, the axis-angle map
SMPL uses (`rodrigues`) and its inverse, and the quaternion and 6D
conversions.  `project_to_so3` and `rodrigues` are written with
elementwise ops and `torch.where` only, so they run under `torch.func.vmap`
/ `jacfwd` (the LM fit differentiates through `rodrigues`).
"""

from __future__ import annotations

import torch


def _bmm4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...jk->...ik", a, b)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def project_to_so3_svd(C: torch.Tensor) -> torch.Tensor:
    """SVD projection onto SO(3): U diag(1, 1, det(U V^T)) V^T (reference
    so3_mean core, src/models/so3conv.py:215-225), of C + 1e-8 I.  The
    reference form, for tests; `project_to_so3` computes the same rotation."""
    eps = 1e-8 * torch.eye(3, dtype=C.dtype, device=C.device)
    u, _, vt = torch.linalg.svd(C + eps, full_matrices=False)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (u * d[..., None, :]) @ vt


def project_to_so3(C: torch.Tensor, newton_iters: int = 30) -> torch.Tensor:
    """Chordal-L2 projection of (..., 3, 3) onto SO(3), Davenport q-method.

    The maximiser of tr(R^T C) is R(q*) with q* the principal eigenvector of
    the traceless symmetric 4x4 Davenport matrix K(C).  Its largest
    eigenvalue comes from `newton_iters` Newton steps on the characteristic
    quartic started from the upper bound sqrt(tr K^2); the eigenvector is a
    column of adj(K - lambda I) (Cayley-Hamilton).  Same algorithm and
    operation order as the JAX package.
    """
    m00, m01, m02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    m10, m11, m12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    m20, m21, m22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    row0 = torch.stack([m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    row1 = torch.stack([m21 - m12, m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    row2 = torch.stack([m02 - m20, m01 + m10, m11 - m00 - m22, m12 + m21], -1)
    row3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, m22 - m00 - m11], -1)
    K = torch.stack([row0, row1, row2, row3], -2)          # (..., 4, 4)

    K2 = _bmm4(K, K)
    K3 = _bmm4(K2, K)
    t2 = _trace(K2)
    t3 = _trace(K3)
    t4 = (K2 * K2.transpose(-1, -2)).sum((-1, -2))         # tr(K^4)

    # char poly of traceless K: l^4 + e2 l^2 - e3 l + e4
    e2 = -t2 / 2.0
    e3 = t3 / 3.0
    e4 = (t2 * t2 / 2.0 - t4) / 4.0

    lam = torch.sqrt(torch.clamp(t2, min=1e-20))           # >= lambda_max
    for _ in range(newton_iters):
        p = ((lam * lam + e2) * lam - e3) * lam + e4
        dp = (4.0 * lam * lam + 2.0 * e2) * lam - e3
        lam = lam - p / torch.where(dp.abs() < 1e-20, torch.full_like(dp, 1e-20), dp)

    eye = torch.eye(4, dtype=C.dtype, device=C.device)
    M = K - lam[..., None, None] * eye
    s1 = _trace(M)
    M2 = _bmm4(M, M)
    s2 = _trace(M2)
    M3 = _bmm4(M2, M)
    s3 = _trace(M3)
    d3 = -s1
    d2 = (s1 * s1 - s2) / 2.0
    d1 = -(s1 ** 3 - 3.0 * s1 * s2 + 2.0 * s3) / 6.0
    adj = -(
        M3
        + d3[..., None, None] * M2
        + d2[..., None, None] * M
        + d1[..., None, None] * eye
    )
    # adj is rank one (scalar * q q^T): take the column with the largest
    # diagonal magnitude
    col = torch.argmax(torch.diagonal(adj, dim1=-2, dim2=-1).abs(), dim=-1)
    idx = col[..., None, None].expand(adj.shape[:-1] + (1,))
    q = torch.gather(adj, -1, idx)[..., 0]
    return quaternion_to_matrix(q)


def so3_mean(Rs: torch.Tensor, weights: torch.Tensor = None) -> torch.Tensor:
    """Weighted chordal-L2 mean of rotations Rs (..., N, 3, 3), weights
    (..., N) or None -> (..., 3, 3)."""
    C = Rs.sum(-3) if weights is None else (weights[..., None, None] * Rs).sum(-3)
    return project_to_so3(C)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    Taylor-safe at theta ~ 0: SMPL poses start at zero and the LM fit
    differentiates through this, so the unselected branch of every
    `torch.where` stays finite (the double-where of the JAX version).
    """
    sq = (axis_angle * axis_angle).sum(-1, keepdim=True)
    small = sq < 1e-16
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    theta = torch.where(small, torch.zeros_like(sq), safe_theta)
    k = axis_angle / safe_theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zero, -kz, ky], -1),
            torch.stack([kz, zero, -kx], -1),
            torch.stack([-ky, kx, zero], -1),
        ],
        dim=-2,
    )
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(K.shape)
    KK = k[..., :, None] * k[..., None, :] - eye            # K @ K for unit k
    R = eye + s * K + (1.0 - c) * KK
    ax, ay, az = axis_angle[..., 0], axis_angle[..., 1], axis_angle[..., 2]
    Klin = torch.stack(
        [
            torch.stack([zero, -az, ay], -1),
            torch.stack([az, zero, -ax], -1),
            torch.stack([-ay, ax, zero], -1),
        ],
        dim=-2,
    )
    return torch.where(small[..., None], eye + Klin, R)


def rotation_matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    cos = torch.clamp((_trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin = torch.sin(theta)
    small = sin.abs() < 1e-7
    scale = torch.where(small, torch.full_like(theta, 0.5),
                        theta / torch.where(small, torch.ones_like(sin), 2.0 * sin))
    return w * scale[..., None]


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, w >= 0:
    Shepperd's method without branches (all four candidates, the best
    conditioned taken)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], -2)                   # (..., 4, 4)
    best = torch.argmax((cands * cands).sum(-1), dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)           # canonical hemisphere


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation (..., 6) -> (..., 3, 3), rows
    b1, b2, b3 by Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-8)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -2)
