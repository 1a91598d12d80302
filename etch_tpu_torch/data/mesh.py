"""Minimal triangle-mesh container, OBJ and PLY IO (numpy only).

A copy of `etch_tpu/data/mesh.py`: `TriMesh` (vertices and faces in file
order, face and vertex normals, face areas, bounding box and the midpoint
subdivision that `load_item` applies to the SMPL mesh), `load_obj`,
`save_obj`, and the point-cloud PLY IO of the evaluation and ground-truth
tools (`load_ply`, `save_ply`, `save_points_with_vector`,
`save_points_with_color`).  `tests/test_torch_entry.py`,
`tests/test_torch_data.py` and `tests/test_torch_evaluate.py` hold it
bit-equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float
    faces: np.ndarray     # (F, 3) int

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.faces.copy())

    @property
    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.clip(norm, 1e-20, None)

    @property
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return 0.5 * np.linalg.norm(n, axis=1)

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals."""
        fn = self.face_normals * (2.0 * self.face_areas)[:, None]
        vn = np.zeros_like(self.vertices, dtype=np.float64)
        for k in range(3):
            np.add.at(vn, self.faces[:, k], fn)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        return (vn / np.clip(norm, 1e-20, None)).astype(self.vertices.dtype)

    def bounds(self):
        return self.vertices.min(0), self.vertices.max(0)

    def subdivide(self) -> "TriMesh":
        """Midpoint subdivision; original vertices keep their indices
        (the property the reference asserts for marker geodesics,
        GT_dataloader.py:49-55)."""
        v, f = self.vertices, self.faces
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges_sorted = np.sort(edges, axis=1)
        uniq, inverse = np.unique(edges_sorted, axis=0, return_inverse=True)
        mid = v[uniq].mean(axis=1)
        mid_idx = len(v) + inverse.reshape(3, -1).T  # (F, 3): m01, m12, m20
        new_v = np.concatenate([v, mid])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
        new_f = np.concatenate([
            np.stack([a, m01, m20], 1),
            np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1),
            np.stack([m01, m12, m20], 1),
        ])
        return TriMesh(new_v, new_f.astype(f.dtype))


def load_obj(path: str, dtype=np.float64) -> TriMesh:
    """Vertex/face OBJ loader (positions + triangle faces only, order kept)."""
    verts, faces = [], []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) for i in idx]
                # triangulate fans for polygons
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, dtype=dtype)
    f = np.asarray(faces, dtype=np.int64)
    f = np.where(f > 0, f - 1, len(v) + f)  # OBJ is 1-based; negatives relative
    return TriMesh(v, f)


def save_obj(path: str, mesh: TriMesh) -> None:
    with open(path, "w") as fh:
        for v in mesh.vertices:
            fh.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for f in mesh.faces + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def load_ply(path: str) -> np.ndarray:
    """Load vertex positions from an ascii or binary_little_endian PLY."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header")
    header = data[:header_end].decode("latin1")
    n = None
    props = []
    in_vertex = False
    fmt = "ascii"
    for line in header.splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n = int(t[2])
        elif t[0] == "property" and in_vertex:
            props.append((t[1], t[2]))
    assert n is not None, "no vertex element in ply"
    body = data[header_end + len(b"end_header") :].lstrip(b"\r\n")
    if fmt == "ascii":
        rows = body.decode("latin1").split("\n")[:n]
        pts = np.array([[float(x) for x in r.split()[:3]] for r in rows])
        return pts
    np_types = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
    dtype = np.dtype([(name, np_types.get(ty, "<f4")) for ty, name in props])
    arr = np.frombuffer(body, dtype=dtype, count=n)
    return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float64)


def save_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> None:
    """ASCII point-cloud PLY with optional uint8 colors and normals."""
    n = len(points)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {n}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            fh.write("property float nx\nproperty float ny\nproperty float nz\n")
        if colors is not None:
            fh.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        fh.write("end_header\n")
        for i in range(n):
            row = [f"{points[i, k]:.6f}" for k in range(3)]
            if normals is not None:
                row += [f"{normals[i, k]:.6f}" for k in range(3)]
            if colors is not None:
                row += [str(int(colors[i, k])) for k in range(3)]
            fh.write(" ".join(row) + "\n")


def save_points_with_vector(points: np.ndarray, vectors: np.ndarray, path: str):
    """Points with a per-point vector stored in the normal channel (the
    reference's debug export, utils/GT_utils.py)."""
    save_ply(path, points, normals=vectors)


def save_points_with_color(points: np.ndarray, colors: np.ndarray, path: str):
    """colors in [0,1] floats or uint8."""
    c = colors
    if c.dtype != np.uint8:
        c = np.clip(np.asarray(c) * 255.0, 0, 255).astype(np.uint8)
    save_ply(path, points, colors=c)
