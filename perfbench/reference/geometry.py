"""Geometry constants and SO(3) maps of the plain reference.

A frozen copy, for the benchmark's reference, of the port's
`geometry/icosahedral.py` (the 60 icosahedral anchors and their 12-neighbour
intra adjacency), `geometry/kernel_points.py` (the reference's kpsphere24
layout) and, from `geometry/so3.py`, the chordal projection onto SO(3)
(Davenport's q-method) and the axis-angle map SMPL uses.  Numpy and plain
torch only; nothing here imports the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PHI = (1.0 + np.sqrt(5.0)) / 2.0


def _icosahedron_vertices() -> np.ndarray:
    """12 unit vertices of a regular icosahedron (golden-rectangle layout)."""
    v = []
    for s1 in (-1.0, 1.0):
        for s2 in (-1.0, 1.0):
            v.append([0.0, s1, s2 * PHI])
            v.append([s1, s2 * PHI, 0.0])
            v.append([s2 * PHI, 0.0, s1])
    v = np.unique(np.round(np.array(v), 12), axis=0)
    assert v.shape == (12, 3)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _faces_from_hull(verts: np.ndarray) -> np.ndarray:
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    faces = []
    for simplex in hull.simplices:
        a, b, c = verts[simplex]
        n = np.cross(b - a, c - a)
        centroid = (a + b + c) / 3.0
        if np.dot(n, centroid) < 0:  # enforce outward winding
            simplex = simplex[[0, 2, 1]]
        faces.append(simplex)
    faces = np.array(sorted(map(tuple, faces)))
    assert faces.shape == (20, 3)
    return faces


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _snap(R: np.ndarray) -> np.ndarray:
    """Project to the nearest rotation matrix (keeps group closure exact to fp)."""
    u, _, vt = np.linalg.svd(R)
    d = np.sign(np.linalg.det(u @ vt))
    u[:, -1] *= d
    return u @ vt


@functools.lru_cache(maxsize=1)
def _build():
    verts = _icosahedron_vertices()
    faces = _faces_from_hull(verts)
    normals = []
    for f in faces:
        a, b, c = verts[f]
        n = np.cross(b - a, c - a)
        normals.append(n / np.linalg.norm(n))
    normals = np.array(normals)  # (20, 3) outward unit face normals

    # --- generate the rotation group I by closure ----------------------------
    g5 = _axis_angle(verts[0], 2 * np.pi / 5)     # 5-fold about a vertex axis
    g3 = _axis_angle(normals[0], 2 * np.pi / 3)   # 3-fold about a face axis
    elems = [np.eye(3)]

    def find(R, pool):
        for i, E in enumerate(pool):
            if np.abs(E - R).max() < 1e-8:
                return i
        return -1

    frontier = [np.eye(3)]
    while frontier:
        new_frontier = []
        for E in frontier:
            for g in (g5, g3):
                R = _snap(g @ E)
                if find(R, elems) < 0:
                    elems.append(R)
                    new_frontier.append(R)
        frontier = new_frontier
    assert len(elems) == 60, f"group closure produced {len(elems)} elements"
    elems = np.array(elems)

    # --- canonical ordering: face-major, gamma-minor -------------------------
    # Each g in I maps the reference face axis u0 = normals[0] to some face
    # normal; group elements into 20 cosets of 3 by that image.
    u0 = normals[0]
    images = elems @ u0                      # (60, 3)
    face_of = np.argmax(images @ normals.T, axis=1)
    assert np.allclose(
        np.max(images @ normals.T, axis=1), 1.0, atol=1e-6
    ), "group does not permute face normals"

    # in-face angle (gamma) of each element, for a stable within-coset order
    ref_tangent = verts[faces[0][0]] - u0 * np.dot(verts[faces[0][0]], u0)
    ref_tangent /= np.linalg.norm(ref_tangent)

    def gamma_angle(R, f):
        # angle of R(ref_tangent) measured in the target face plane
        n = normals[f]
        t = R @ ref_tangent
        t = t - n * np.dot(t, n)
        t /= np.linalg.norm(t)
        # basis of target face plane
        b1 = verts[faces[f][0]] - n * np.dot(verts[faces[f][0]], n)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(n, b1)
        return np.arctan2(np.dot(t, b2), np.dot(t, b1))

    order = []
    for f in range(20):
        idxs = np.where(face_of == f)[0]
        assert len(idxs) == 3
        gammas = [gamma_angle(elems[i], f) for i in idxs]
        order.extend(idxs[np.argsort(gammas)])
    anchors = elems[np.array(order)]          # (60, 3, 3), identity included
    face_of = face_of[np.array(order)]

    # --- face adjacency ------------------------------------------------------
    adj = [[] for _ in range(20)]
    for i in range(20):
        for j in range(20):
            if i != j and len(set(faces[i]) & set(faces[j])) == 2:
                adj[i].append(j)
    adj = np.array(adj)                       # (20, 3)

    # --- intra neighbors: 12 right-multipliers -------------------------------
    # H = elements keeping u0 on its own face (3, incl. identity) or moving it
    # to one of the 3 adjacent faces (9); matches the reference's 12-neighbor
    # layout (own face + 3 adjacent faces, rotation.py:118-140).
    own = [i for i in range(60) if face_of[i] == 0]
    neigh = [i for i in range(60) if face_of[i] in adj[0]]
    H_idx = np.array(own + sorted(neigh))
    assert len(H_idx) == 12
    H = anchors[H_idx]                        # (12, 3, 3)

    # intra_idx[a, j] = index of anchors[a] @ H[j]
    prod = np.einsum("aij,hjk->ahik", anchors, H)      # (60, 12, 3, 3)
    diff = prod[:, :, None] - anchors[None, None]      # (60,12,60,3,3)
    intra_idx = np.argmin(np.abs(diff).max(axis=(-1, -2)), axis=2)
    err = np.abs(diff).max(axis=(-1, -2)).min(axis=2).max()
    assert err < 1e-6, f"intra adjacency not closed: {err}"

    return (
        anchors.astype(np.float32),
        intra_idx.astype(np.int32),
        normals.astype(np.float32),
    )


def get_anchors(k: int = 60) -> np.ndarray:
    """(k, 3, 3) rotation anchors.  k=60 is the full group; k in {1, 20}
    subsample as in reference `so3conv/functional.py:390-398`."""
    anchors, _, _ = _build()
    if k == 60:
        return anchors
    if k == 1:
        return anchors[:1]        # identity
    if k == 20:
        return anchors[::3]       # one per face
    return anchors


def get_intra_idx() -> np.ndarray:
    """(60, 12) rotation-group convolution adjacency (right-mult indices)."""
    _, intra_idx, _ = _build()
    return intra_idx


KERNEL_CONDENSE_RATIO = 0.7  # reference modules.py:13

_SIZE_MAP = {1: 24, 2: 30, 3: 66}  # reference functional.py:148

# Exact kpsphere{24,30,66}.ply vertex coordinates (reference
# external/vgtk/vgtk/data/anchors/, ascii ply payload — fixed geometry
# constants, required for numerical parity of the conv weights).
_REFERENCE_LAYOUTS = {
    24: [
        (0.0, 0.0, 0.0),
        (0.6299, -0.2149, -0.7423),
        (-0.3022, 0.7119, -0.6461),
        (-0.2966, -0.9471, -0.1752),
        (0.2247, 0.226, 0.9405),
        (-0.9917, 0.0428, 0.1434),
        (0.5258, 0.7599, 0.402),
        (-0.2035, -0.0206, -0.9718),
        (0.3777, 0.4709, -0.8007),
        (0.0201, -0.8949, 0.4631),
        (0.1504, 0.9692, -0.1638),
        (-0.6206, 0.2209, 0.7483),
        (-0.7326, -0.4753, -0.4757),
        (-0.1841, 0.7913, 0.5883),
        (-0.7168, -0.5765, 0.3743),
        (0.58, -0.4954, 0.6381),
        (0.0465, -0.6561, -0.7571),
        (0.8635, 0.1413, 0.4999),
        (0.5038, -0.8428, -0.1487),
        (-0.6553, 0.7446, 0.0504),
        (0.9561, -0.2905, -0.0871),
        (-0.8158, 0.2253, -0.5471),
        (-0.2005, -0.3558, 0.9158),
        (0.8413, 0.4655, -0.2484),
    ],
    30: [
        (0.0, 0.0, 0.0),
        (0.3652, -0.3791, -0.8628),
        (-0.4803, 0.6644, 0.5948),
        (0.3332, -0.4217, 0.8705),
        (-0.6308, 0.8077, -0.0669),
        (0.1518, -0.9318, 0.3939),
        (-1.0532, 0.2475, 0.143),
        (0.3315, -0.9158, -0.2675),
        (1.0801, 0.0438, 0.1552),
        (-0.8004, 0.3207, -0.6279),
        (0.7509, -0.5757, 0.3404),
        (0.1998, 0.3141, -0.9507),
        (0.7376, 0.7613, 0.2401),
        (-0.5152, -0.0709, -0.0869),
        (-0.3344, -0.0976, -0.9577),
        (0.4523, 0.846, -0.4607),
        (0.0082, 1.0084, 0.0926),
        (0.8411, -0.4832, -0.3561),
        (-0.6912, 0.028, 0.759),
        (0.4739, 0.2228, -0.0761),
        (-0.2315, 0.747, -0.635),
        (-0.1966, -0.7407, -0.6733),
        (-0.886, -0.5346, 0.2965),
        (-0.3921, -0.9375, -0.0178),
        (0.6689, 0.1576, 0.7531),
        (0.8571, 0.206, -0.6344),
        (-0.3328, -0.5827, 0.7463),
        (-0.0618, 0.1242, 1.0014),
        (-0.8578, -0.4656, -0.4937),
        (0.1931, 0.6978, 0.7148),
    ],
    66: [
        (0.0, 0.0, 0.0),
        (0.0, 0.0, 0.5),
        (0.433, 0.0, 0.25),
        (0.433, 0.0, -0.25),
        (-0.0, -0.0, -0.5),
        (-0.0, 0.0, 0.5),
        (-0.0, 0.433, 0.25),
        (-0.0, 0.433, -0.25),
        (0.0, -0.0, -0.5),
        (-0.0, -0.0, 0.5),
        (-0.433, -0.0, 0.25),
        (-0.433, -0.0, -0.25),
        (0.0, 0.0, -0.5),
        (0.0, -0.0, 0.5),
        (0.0, -0.433, 0.25),
        (0.0, -0.433, -0.25),
        (-0.0, 0.0, -0.5),
        (0.0, 0.0, 1.0),
        (0.5, 0.0, 0.866),
        (0.866, 0.0, 0.5),
        (1.0, 0.0, -0.0),
        (0.866, 0.0, -0.5),
        (0.5, 0.0, -0.866),
        (-0.0, -0.0, -1.0),
        (0.0, 0.0, 1.0),
        (0.3117, 0.3909, 0.866),
        (0.54, 0.6771, 0.5),
        (0.6235, 0.7818, -0.0),
        (0.54, 0.6771, -0.5),
        (0.3117, 0.3909, -0.866),
        (-0.0, -0.0, -1.0),
        (-0.0, 0.0, 1.0),
        (-0.1113, 0.4875, 0.866),
        (-0.1927, 0.8443, 0.5),
        (-0.2225, 0.9749, -0.0),
        (-0.1927, 0.8443, -0.5),
        (-0.1113, 0.4875, -0.866),
        (0.0, -0.0, -1.0),
        (-0.0, 0.0, 1.0),
        (-0.4505, 0.2169, 0.866),
        (-0.7803, 0.3758, 0.5),
        (-0.901, 0.4339, -0.0),
        (-0.7803, 0.3758, -0.5),
        (-0.4505, 0.2169, -0.866),
        (0.0, -0.0, -1.0),
        (-0.0, -0.0, 1.0),
        (-0.4505, -0.2169, 0.866),
        (-0.7803, -0.3758, 0.5),
        (-0.901, -0.4339, -0.0),
        (-0.7803, -0.3758, -0.5),
        (-0.4505, -0.2169, -0.866),
        (0.0, 0.0, -1.0),
        (-0.0, -0.0, 1.0),
        (-0.1113, -0.4875, 0.866),
        (-0.1927, -0.8443, 0.5),
        (-0.2225, -0.9749, -0.0),
        (-0.1927, -0.8443, -0.5),
        (-0.1113, -0.4875, -0.866),
        (0.0, 0.0, -1.0),
        (0.0, -0.0, 1.0),
        (0.3117, -0.3909, 0.866),
        (0.54, -0.6771, 0.5),
        (0.6235, -0.7818, -0.0),
        (0.54, -0.6771, -0.5),
        (0.3117, -0.3909, -0.866),
        (-0.0, 0.0, -1.0),
    ],
}


def get_kernel_points(radius: float, kernel_size: int = 1) -> np.ndarray:
    """(ks, 3) kernel points with max-norm == KERNEL_CONDENSE_RATIO * radius.

    `kernel_size` maps {1: 24, 2: 30, 3: 66} points as the reference does
    (`functional.py:148`).
    """
    pts = np.asarray(_REFERENCE_LAYOUTS[_SIZE_MAP[kernel_size]], np.float32)
    scale = KERNEL_CONDENSE_RATIO * radius / np.abs(np.linalg.norm(pts, axis=1)).max()
    return (pts * scale).astype(np.float32)


def _bmm4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...jk->...ik", a, b)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


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
