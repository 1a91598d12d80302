"""Heat-method geodesic distances on triangle meshes.

A copy of `etch_tpu/data/geodesics.py` (numpy and scipy only).  It replaces potpourri3d's MeshHeatMethodDistanceSolver used by the reference for
marker label / confidence GT (`src/data_utils/GT_dataloader.py:128-135`):
per sample, geodesic distance fields from the 86 marker vertices on a
subdivided SMPL mesh, combined into per-vertex (argmin label, min distance).

Implementation: Crane et al. "Geodesics in Heat" — (1) diffuse indicator
u = (M - t L)^{-1} delta, (2) normalize face gradients, (3) solve the Poisson
problem L phi = div X.  Both sparse systems are prefactored once per mesh
(scipy splu), so evaluating all 86 sources is 86 cheap back-substitutions.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from etch_tpu_torch.data.mesh import TriMesh


class HeatMethodSolver:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray, t_coef: float = 1.0):
        V = np.asarray(vertices, np.float64)
        F = np.asarray(faces, np.int64)
        n = len(V)
        self.n = n
        self.V, self.F = V, F

        vi, vj, vk = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        e_i = vk - vj  # edge opposite vertex i
        e_j = vi - vk
        e_k = vj - vi
        normal = np.cross(e_k, -e_j)
        dbl_area = np.linalg.norm(normal, axis=1)
        dbl_area = np.clip(dbl_area, 1e-14, None)
        self.face_normal = normal / dbl_area[:, None]
        self.face_area = 0.5 * dbl_area

        # cotangents at each corner
        def cot(a, b):
            cross = np.linalg.norm(np.cross(a, b), axis=1)
            return np.einsum("ij,ij->i", a, b) / np.clip(cross, 1e-14, None)

        cot_i = cot(-e_j, e_k)   # angle at vertex i between edges (i->k),(i->j)
        cot_j = cot(-e_k, e_i)
        cot_k = cot(-e_i, e_j)

        # cotan Laplacian (positive semi-definite form: L = D - W)
        I = np.concatenate([F[:, 1], F[:, 2], F[:, 2], F[:, 0], F[:, 0], F[:, 1]])
        J = np.concatenate([F[:, 2], F[:, 1], F[:, 0], F[:, 2], F[:, 1], F[:, 0]])
        Wv = 0.5 * np.concatenate([cot_i, cot_i, cot_j, cot_j, cot_k, cot_k])
        W = sp.coo_matrix((Wv, (I, J)), shape=(n, n)).tocsr()
        L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
        self.L = L.tocsc()

        # lumped mass matrix
        m = np.zeros(n)
        for c in range(3):
            np.add.at(m, F[:, c], self.face_area / 3.0)
        self.mass = m

        # timestep: mean edge length squared
        h2 = np.mean(
            np.concatenate([
                np.einsum("ij,ij->i", e_i, e_i),
                np.einsum("ij,ij->i", e_j, e_j),
                np.einsum("ij,ij->i", e_k, e_k),
            ])
        )
        t = t_coef * h2

        eps = 1e-10
        A_heat = (sp.diags(m) + t * L).tocsc()
        A_pois = (L + eps * sp.diags(np.ones(n))).tocsc()
        self._heat = spla.splu(A_heat)
        self._pois = spla.splu(A_pois)

        # per-face gradient operators (evaluated on the fly in _grad)
        self._e = (e_i, e_j, e_k)

    def _grad(self, u: np.ndarray) -> np.ndarray:
        """Per-face gradient of a vertex function: (F, 3)."""
        F = self.F
        N = self.face_normal
        A2 = 2.0 * self.face_area[:, None]
        e_i, e_j, e_k = self._e
        g = (
            u[F[:, 0], None] * np.cross(N, e_i)
            + u[F[:, 1], None] * np.cross(N, e_j)
            + u[F[:, 2], None] * np.cross(N, e_k)
        ) / A2
        return g

    def _div(self, X: np.ndarray) -> np.ndarray:
        """Integrated divergence of a face vector field: (V,)."""
        F = self.F
        N = self.face_normal
        e_i, e_j, e_k = self._e
        out = np.zeros(self.n)
        # div at vertex i gets contribution 0.5 * <N x e_i, X> per face
        np.add.at(out, F[:, 0], 0.5 * np.einsum("ij,ij->i", np.cross(N, e_i), X))
        np.add.at(out, F[:, 1], 0.5 * np.einsum("ij,ij->i", np.cross(N, e_j), X))
        np.add.at(out, F[:, 2], 0.5 * np.einsum("ij,ij->i", np.cross(N, e_k), X))
        return out

    def compute_distance(self, source: int) -> np.ndarray:
        delta = np.zeros(self.n)
        delta[source] = 1.0
        u = self._heat.solve(delta)
        g = self._grad(u)
        norm = np.linalg.norm(g, axis=1, keepdims=True)
        X = -g / np.clip(norm, 1e-14, None)
        phi = self._pois.solve(self._div(X))
        phi -= phi[source]
        return np.abs(phi)

    def compute_distances(self, sources: np.ndarray) -> np.ndarray:
        """(S,) sources -> (S, V) distance fields (factorizations reused)."""
        return np.stack([self.compute_distance(int(s)) for s in sources])


def marker_label_fields(mesh: TriMesh, marker_vertex_ids) -> tuple:
    """(min geodesic distance (V,), argmin label (V,)) over all markers
    (reference GT_dataloader.py:128-135)."""
    solver = HeatMethodSolver(mesh.vertices, mesh.faces)
    d = solver.compute_distances(np.asarray(marker_vertex_ids))
    return d.min(axis=0), d.argmin(axis=0)
