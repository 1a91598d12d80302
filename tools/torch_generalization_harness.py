"""Held-out generalization harness of the PyTorch port.

The port's counterpart of tools/generalization_harness.py (whose docstring
explains the family): a parametric family of synthetic bodies, each a
closed tube around a bent and twisted spine (the "pose") with a harmonic
radius profile (the "shape"), and its scan the same tube pushed out along
the normal by a strictly positive bump field (the "clothing").  Each body
goes through the port's ground-truth pipeline (the infopoint raycast of
`cli/generate_infopoints.py`, then `data/dataset.py::load_item`: surface
sampling, the 1 cm info-vector rule, heat-method geodesic labels and
confidences), the same code path the bundled 4D-Dress sample takes.  The
86 markers are fixed (z, theta) grid vertices shared by the family.

The mesh construction is a numpy copy of the JAX tool's (the port imports
nothing of the JAX package); tests/test_torch_evidence.py holds it
bit-equal to the original.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from etch_tpu_torch.data.mesh import TriMesh, save_obj  # noqa: E402

N_THETA = 48
N_Z = 96
N_MARKERS = 86


def _tube_mesh(radii: np.ndarray, spine: np.ndarray, twist: np.ndarray) -> TriMesh:
    """Closed tube: an (N_Z, N_THETA) radius grid around a bent spine
    (N_Z, 3), each ring turned by `twist` (N_Z,), with fans to two poles."""
    nz, nt = radii.shape
    th = np.linspace(0, 2 * np.pi, nt, endpoint=False)[None, :] + twist[:, None]
    # ring planes stay horizontal (xy): the deformations are mild
    x = spine[:, 0:1] + radii * np.cos(th)
    y = spine[:, 1:2] + radii * np.sin(th)
    zz = np.broadcast_to(spine[:, 2:3], radii.shape)
    verts = np.stack([x, y, zz], axis=-1).reshape(-1, 3)

    faces = []
    for i in range(nz - 1):
        for j in range(nt):
            a = i * nt + j
            b = i * nt + (j + 1) % nt
            c = (i + 1) * nt + j
            d = (i + 1) * nt + (j + 1) % nt
            faces.append([a, b, d])
            faces.append([a, d, c])
    bot = len(verts)
    verts = np.concatenate(
        [verts, spine[0:1] - [0, 0, 0.02], spine[-1:] + [0, 0, 0.02]], axis=0)
    top = bot + 1
    for j in range(nt):
        faces.append([bot, (j + 1) % nt, j])
        base = (nz - 1) * nt
        faces.append([top, base + j, base + (j + 1) % nt])
    return TriMesh(np.asarray(verts, np.float64), np.asarray(faces, np.int32))


def make_pair(seed: int):
    """(body TriMesh, scan TriMesh) of one family member."""
    rng = np.random.RandomState(seed)
    z = np.linspace(-0.9, 0.9, N_Z)

    # pose: bent and twisted spine
    bend = rng.uniform(-0.25, 0.25, 4)
    spine = np.stack([
        bend[0] * z ** 2 + bend[1] * z ** 3,
        bend[2] * z ** 2 + bend[3] * z ** 3,
        z,
    ], axis=1)
    twist = rng.uniform(-0.8, 0.8) * z

    # shape: radius-profile harmonics in z and theta
    th = np.linspace(0, 2 * np.pi, N_THETA, endpoint=False)
    amp = rng.uniform(-0.02, 0.02, 3)
    r = (0.14
         + amp[0] * np.cos(2.5 * z)[:, None]
         + amp[1] * np.sin(1.5 * z)[:, None]
         + amp[2] * np.cos(2 * th)[None, :] * (1 - z ** 2)[:, None])
    r = np.maximum(r, 0.06)

    # clothing: strictly positive smooth bump field
    ba = rng.uniform(0.008, 0.02, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    bump = (0.008
            + ba[0] * (1 + np.sin(3 * z[:, None] + ph[0])) / 2
            + ba[1] * (1 + np.cos(2 * th[None, :] + ph[1])) / 2
            + ba[2] * (1 + np.sin(4 * z[:, None] + 3 * th[None, :] + ph[2])) / 2)

    return _tube_mesh(r, spine, twist), _tube_mesh(r + bump, spine, twist)


def marker_vertex_ids() -> list:
    """86 fixed (z, theta) grid ids, shared across the family, off the two
    rings next to each pole."""
    ids = []
    zi = np.linspace(4, N_Z - 5, 22).astype(int)
    for i, zz in enumerate(zi):
        for tj in range(4):
            if len(ids) >= N_MARKERS:
                break
            ids.append(int(zz * N_THETA + (tj * N_THETA // 4 + (i * 7) % N_THETA) % N_THETA))
    return ids[:N_MARKERS]


def build_item_files(workdir: str, seed: int) -> str:
    """Write the scan, the body and the infopoints of one family member in
    the `DatasetPaths` layout; returns its id."""
    from etch_tpu_torch.cli.generate_infopoints import generate_for_pair

    id_ = f"synth_{seed:04d}"
    body, scan = make_pair(seed)
    scan_dir = os.path.join(workdir, "model", id_)
    smpl_dir = os.path.join(workdir, "smplh", id_)
    info_dir = os.path.join(workdir, "npz")
    for d in (scan_dir, smpl_dir, info_dir):
        os.makedirs(d, exist_ok=True)
    save_obj(os.path.join(scan_dir, f"{id_}.obj"), scan)
    save_obj(os.path.join(smpl_dir, f"mesh_smpl_{id_}.obj"), body)
    np.savez(os.path.join(smpl_dir, f"info_{id_}.npz"), gender=0)   # 0: neutral
    pts, vecs = generate_for_pair(body, scan, n_samples=30000, seed=seed)
    np.savez(os.path.join(info_dir, f"{id_}.npz"), info_points=pts, info_vectors=vecs)
    return id_


def build_items(workdir: str, seeds, num_point: int, samplings: int = 1, verbose: bool = True):
    """The ground-truth pipeline's items of each family seed, `samplings`
    of each (sampling seeds seed * 100 + s).  Returns (batch dict stacked
    over the items, the GT markers (items, 86, 3))."""
    from etch_tpu_torch.data.dataset import DatasetPaths, load_item

    paths = DatasetPaths(scan_dir=os.path.join(workdir, "model"),
                         smpl_dir=os.path.join(workdir, "smplh"),
                         infopoints_dir=os.path.join(workdir, "npz"))
    vids = marker_vertex_ids()
    items, gt_mk = [], []
    for seed in seeds:
        t0 = time.time()
        id_ = build_item_files(workdir, seed)
        body, _ = make_pair(seed)
        for s in range(samplings):
            items.append(load_item(paths, id_, num_point, vids, seed=seed * 100 + s))
            gt_mk.append(body.vertices[vids])
        if verbose:
            print(f"  seed {seed}: {samplings} item(s) in {time.time() - t0:.1f}s", flush=True)
    batch = {k: np.stack([it[k] for it in items])
             for k in ("hitpts", "vectors", "confidences", "labels")}
    return batch, np.stack(gt_mk)
