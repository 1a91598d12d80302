"""Minimal triangle-mesh container and OBJ IO (numpy only).

A copy of the part of `etch_tpu/data/mesh.py` that the single-scan entry
point needs (`TriMesh`, `load_obj`, `save_obj`): vertices and faces in file
order, face areas, bounding box.  `tests/test_torch_entry.py` holds it
bit-equal to the original.
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
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return 0.5 * np.linalg.norm(n, axis=1)

    def bounds(self):
        return self.vertices.min(0), self.vertices.max(0)


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
