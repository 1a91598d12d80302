"""Ground-truth dataset: scans + infopoints -> fixed-shape training batches.

A copy of `etch_tpu/data/dataset.py` (numpy and scipy only): the same seeds,
the same draws in the same order, the same `drop_last=True` batching, so an
item and a batch are bit-equal to the JAX package's.  Rebuild of reference `src/data_utils/GT_dataloader.py:62-180` (single dataset)
and `GT_dataloader_mixed.py:110-300` (bbox-centered + y-rotation-augmented
variant used by All-in-One training).  Per item:

  1. sample num_point surface points from the scan (seeded)
  2. tightness vector = nearest info-vector if the nearest info point is
     closer than 1 cm, else point - closest-point-on-SMPL-mesh
     (GT_dataloader.py:104-122)
  3. labels/confidence: geodesic distance fields from the 86 markers on the
     subdivided SMPL mesh; label = argmin marker, confidence = exp(-10 d) at
     the SMPL vertex nearest to the inner point (GT_dataloader.py:124-145)

The geodesic solve is the CPU hot loop (SURVEY §3.1); items are produced by a
process pool and stacked into dense (B, N, ...) numpy batches for the card.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from etch_tpu_torch.data.geodesics import HeatMethodSolver
from etch_tpu_torch.data.mesh import TriMesh, load_obj
from etch_tpu_torch.data.proximity import MeshProximity
from etch_tpu_torch.data.sampling import sample_surface

SHARPNESS = 10.0  # confidence = exp(-10 * geodesic), GT_dataloader.py:57-60
GENDER_NAMES = {0: "female", 1: "male"}


def convert_geodesic_distances_to_confidence(d: np.ndarray) -> np.ndarray:
    return np.exp(-SHARPNESS * d)


@dataclasses.dataclass
class DatasetPaths:
    scan_dir: str
    smpl_dir: str
    infopoints_dir: str
    activated_ids_path: Optional[str] = None


def list_ids(paths: DatasetPaths) -> List[str]:
    """Sorted ids present in all three dirs ∩ activated list
    (GT_dataloader.py:72-73)."""
    activated = None
    if paths.activated_ids_path and os.path.isfile(paths.activated_ids_path):
        with open(paths.activated_ids_path, "rb") as f:
            activated = set(pickle.load(f))
    out = []
    for i in sorted(os.listdir(paths.scan_dir)):
        if not os.path.isdir(os.path.join(paths.scan_dir, i)):
            continue
        if not os.path.isdir(os.path.join(paths.smpl_dir, i)):
            continue
        if not os.path.isfile(os.path.join(paths.infopoints_dir, f"{i}.npz")):
            continue
        if activated is not None and i not in activated:
            continue
        out.append(i)
    return out


def _item_paths(paths: DatasetPaths, id_: str):
    return (
        os.path.join(paths.infopoints_dir, f"{id_}.npz"),
        os.path.join(paths.scan_dir, id_, f"{id_}.obj"),
        os.path.join(paths.smpl_dir, id_, f"mesh_smpl_{id_}.obj"),
        os.path.join(paths.smpl_dir, id_, f"info_{id_}.npz"),
    )


def load_item(
    paths: DatasetPaths,
    id_: str,
    num_point: int,
    marker_vertex_ids: Sequence[int],
    seed: int = 1,
    center: bool = False,
    rotate_y: Optional[float] = None,
    include_marker_positions: bool = False,
) -> Dict[str, np.ndarray]:
    """One training item (GT_dataloader.py:85-180).  `center` and `rotate_y`
    enable the mixed-variant preprocessing (GT_dataloader_mixed.py:176-199)."""
    info_path, scan_path, smpl_path, smpl_info_path = _item_paths(paths, id_)

    info = np.load(info_path)
    info_points = np.asarray(info["info_points"], np.float64)
    info_vectors = np.asarray(info["info_vectors"], np.float64)

    scan_mesh = load_obj(scan_path)
    smpl_mesh = load_obj(smpl_path)

    if center:
        vmin, vmax = scan_mesh.bounds()
        c = (vmin + vmax) / 2.0
        scan_mesh.vertices = scan_mesh.vertices - c
        smpl_mesh.vertices = smpl_mesh.vertices - c
        info_points = info_points - c

    sample_points, _ = sample_surface(scan_mesh, num_point, seed=seed + 15)

    # condition 1: nearest info point within 1 cm -> reuse its vector
    tree = cKDTree(info_points)
    dists, indices = tree.query(sample_points, k=1)

    # condition 2 fallback: vector to closest point on SMPL surface
    prox = MeshProximity(smpl_mesh)
    closest_points, _, _ = prox.closest_point(sample_points)

    threshold = 0.01
    vectors = np.where(
        (dists < threshold)[:, None],
        info_vectors[indices],
        sample_points - closest_points,
    )

    # labels & confidences from geodesic marker fields on the subdivided mesh
    new_mesh = smpl_mesh.subdivide()
    solver = HeatMethodSolver(new_mesh.vertices, new_mesh.faces)
    fields = solver.compute_distances(np.asarray(marker_vertex_ids))
    geo_min = fields.min(axis=0)
    geo_label = fields.argmin(axis=0)

    vtree = cKDTree(new_mesh.vertices)
    inner_points = sample_points - vectors
    _, vidx = vtree.query(inner_points, k=1)
    geodesic_distances = geo_min[vidx].reshape(-1, 1)
    labels = geo_label[vidx]
    confidences = convert_geodesic_distances_to_confidence(geodesic_distances)

    if rotate_y is not None:
        ca, sa = np.cos(rotate_y), np.sin(rotate_y)
        R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        sample_points = sample_points @ R.T
        vectors = vectors @ R.T

    smpl_info = np.load(smpl_info_path)
    gender = GENDER_NAMES.get(int(np.asarray(smpl_info["gender"]).item()), "neutral")

    item = {
        "id": id_,
        "hitpts": sample_points.astype(np.float32),
        "vectors": vectors.astype(np.float32),
        "confidences": confidences.astype(np.float32),
        "labels": labels.astype(np.int32),
        "gender": gender,
    }
    if include_marker_positions:
        # marker positions on the SMPL mesh (GT_dataloader_mixed marker
        # export; used by the dynamic relabel path, train_mixed.py:124-158)
        mk = smpl_mesh.vertices[np.asarray(marker_vertex_ids)]
        if rotate_y is not None:
            ca, sa = np.cos(rotate_y), np.sin(rotate_y)
            R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
            mk = mk @ R.T
        item["markers_positions"] = mk.astype(np.float32)
    return item


class GTDataset:
    """Map-style dataset over one (scan_dir, smpl_dir, infopoints_dir)."""

    def __init__(
        self,
        paths: DatasetPaths,
        num_point: int,
        marker_vertex_ids: Sequence[int],
        seed: int = 1,
        center: bool = False,
        augment_rotation: bool = False,
        include_marker_positions: bool = False,
    ):
        self.paths = paths
        self.num_point = num_point
        self.marker_vertex_ids = list(marker_vertex_ids)
        self.seed = seed
        self.center = center
        self.augment_rotation = augment_rotation
        self.include_marker_positions = include_marker_positions
        self.ids = list_ids(paths)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rot = None
        if self.augment_rotation:
            rot = float(
                np.random.default_rng(self.seed * 100003 + index).uniform(
                    0, 2 * np.pi
                )
            )
        return load_item(
            self.paths,
            self.ids[index],
            self.num_point,
            self.marker_vertex_ids,
            seed=self.seed,
            center=self.center,
            rotate_y=rot,
            include_marker_positions=self.include_marker_positions,
        )


class ConcatDataset:
    """Mixed-training concatenation (reference train_mixed.py:459-461)."""

    def __init__(self, datasets: Sequence[GTDataset]):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index: int):
        di = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[di][index - int(self.offsets[di])]


def _load_indexed(args):
    ds, idx = args
    return ds[idx]


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked fixed-shape numpy batches (the DataLoader equivalent,
    reference train.py:221-222; worker processes feed the accelerator)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order) - (len(order) % batch_size if drop_last else 0)

    def stack(items):
        out = {
            "id": [it["id"] for it in items],
            "gender": [it["gender"] for it in items],
            "hitpts": np.stack([it["hitpts"] for it in items]),
            "vectors": np.stack([it["vectors"] for it in items]),
            "confidences": np.stack([it["confidences"] for it in items]),
            "labels": np.stack([it["labels"] for it in items]),
        }
        if "markers_positions" in items[0]:
            out["markers_positions"] = np.stack(
                [it["markers_positions"] for it in items]
            )
        return out

    if num_workers <= 0:
        for s in range(0, n, batch_size):
            yield stack([dataset[int(i)] for i in order[s : s + batch_size]])
        return

    with ProcessPoolExecutor(max_workers=num_workers) as pool:
        for s in range(0, n, batch_size):
            items = list(
                pool.map(
                    _load_indexed,
                    [(dataset, int(i)) for i in order[s : s + batch_size]],
                )
            )
            yield stack(items)
