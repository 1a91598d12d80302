"""Icosahedral SO(3) anchor group, built analytically (PyTorch port).

A numpy copy of `etch_tpu/geometry/icosahedral.py` (the port cannot import
the JAX package); `tests/test_torch_geometry.py` holds the arrays bit-equal.

The reference derives 60 rotation "anchors" from a bundled icosahedron ply via
trimesh + Euler-angle assembly (`external/vgtk/vgtk/functional/rotation.py:
118-344`, invoked at import in `so3conv/functional.py:384-408`), then fixes the
set into a group by right-multiplying with the anchor closest to identity, and
tabulates a 60x12 "intra" adjacency used by the rotation-group convolution.

Here we construct the chiral icosahedral rotation group I (order 60) directly
by generator closure, which gives us a closed group containing the identity by
construction, and define the intra adjacency as right-multiplication by the 12
group elements that keep a reference face axis on itself or move it to one of
its 3 adjacent faces.  Right-multiplication adjacency makes the rotation-group
convolution exactly equivariant under the left action of the group (see
tests/test_icosahedral.py), which is the property the EPN backbone relies on.

All outputs are deterministic numpy constants computed once at import.
"""

from __future__ import annotations

import functools

import numpy as np

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
