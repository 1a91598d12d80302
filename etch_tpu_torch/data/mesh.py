"""Minimal triangle-mesh container and OBJ IO (numpy only).

A copy of the part of `etch_tpu/data/mesh.py` that the single-scan entry
point and the ground-truth dataset need (`TriMesh`, `load_obj`,
`save_obj`): vertices and faces in file order, face and vertex normals,
face areas, bounding box and the midpoint subdivision that `load_item`
applies to the SMPL mesh.  `tests/test_torch_entry.py` and
`tests/test_torch_data.py` hold it bit-equal to the original.
"""

from __future__ import annotations

import dataclasses

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
