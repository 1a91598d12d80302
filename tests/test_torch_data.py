"""The port's copies of the GT data pipeline against the JAX package's
originals: bit-equal outputs on the same inputs.

  - `TriMesh.subdivide`, `face_normals`, `vertex_normals`;
  - `HeatMethodSolver` and `marker_label_fields` on a small sphere;
  - `MeshProximity` with the native BVH (each package builds its own copy
    of `meshquery.cpp`) and with the numpy KD-tree path, and
    `MeshRayCaster` with both;
  - `load_item` on the bundled 4D-Dress sample at N=512, each package's
    own call;
  - `batch_iterator`'s order and stacking, in-process and with workers;
  - `MetricLogger`'s JSONL, byte for byte.
"""

import json
import os

import numpy as np
import pytest

from etch_tpu.data import dataset as jax_dataset
from etch_tpu.data import geodesics as jax_geodesics
from etch_tpu.data import proximity as jax_proximity
from etch_tpu.data.mesh import TriMesh as JaxTriMesh
from etch_tpu.geometry.icosahedral import _faces_from_hull, _icosahedron_vertices
from etch_tpu.utils.logging import MetricLogger as JaxLogger
from etch_tpu_torch import native
from etch_tpu_torch.data import dataset, geodesics, proximity
from etch_tpu_torch.data.mesh import TriMesh
from etch_tpu_torch.utils.logging import MetricLogger

DATA = os.path.join(os.path.dirname(__file__), "..", "datafolder")
ITEM = "00122_Inner_Take2_00011"


def _sphere(subdiv):
    """Unit icosphere as (vertices, faces), built by the JAX package."""
    mesh = JaxTriMesh(_icosahedron_vertices().copy(), _faces_from_hull(_icosahedron_vertices()))
    for _ in range(subdiv):
        mesh = mesh.subdivide()
        mesh.vertices /= np.linalg.norm(mesh.vertices, axis=1, keepdims=True)
    return mesh.vertices, mesh.faces


def _eq(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_mesh_normals_and_subdivide_bit_equal():
    v, f = _sphere(1)
    v = v * np.array([1.0, 0.7, 1.3])        # not a sphere: normals not radial
    ours, ref = TriMesh(v.copy(), f.copy()), JaxTriMesh(v.copy(), f.copy())
    _eq(ours.face_normals, ref.face_normals)
    _eq(ours.vertex_normals, ref.vertex_normals)
    sub, rsub = ours.subdivide(), ref.subdivide()
    _eq(sub.vertices, rsub.vertices)
    _eq(sub.faces, rsub.faces)
    _eq(sub.subdivide().faces, rsub.subdivide().faces)


def test_heat_geodesics_bit_equal():
    v, f = _sphere(2)
    ours = geodesics.HeatMethodSolver(v, f)
    ref = jax_geodesics.HeatMethodSolver(v, f)
    _eq(ours.compute_distances(np.array([0, 7, 41])), ref.compute_distances(np.array([0, 7, 41])))
    _eq(geodesics.marker_label_fields(TriMesh(v, f), [3, 30, 100]),
        jax_geodesics.marker_label_fields(JaxTriMesh(v, f), [3, 30, 100]))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "kdtree"])
def test_proximity_bit_equal(use_native):
    v, f = _sphere(2)
    rng = np.random.RandomState(0)
    q = rng.randn(300, 3) * 1.3
    ours = proximity.MeshProximity(TriMesh(v, f), use_native=use_native)
    ref = jax_proximity.MeshProximity(JaxTriMesh(v, f), use_native=use_native)
    assert ours.backend == ("native" if use_native else "kdtree")
    assert (ours._bvh is None) == (ref._bvh is None)
    _eq(ours.closest_point(q), ref.closest_point(q))
    assert proximity.last_backend == ours.backend
    origins = rng.randn(50, 3) * 2.0
    dirs = -origins + 0.1 * rng.randn(50, 3)
    caster = proximity.MeshRayCaster(TriMesh(v, f), max_dist=5.0, use_native=use_native)
    rcaster = jax_proximity.MeshRayCaster(JaxTriMesh(v, f), max_dist=5.0, use_native=use_native)
    _eq(caster.cast(origins, dirs), rcaster.cast(origins, dirs))


def test_native_builds_outside_the_source_tree():
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and "build" in lib.parts
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__), "libmeshquery.so"))


@pytest.fixture(scope="module")
def paths():
    kw = dict(scan_dir=f"{DATA}/4D-DRESS/data_processed/model",
              smpl_dir=f"{DATA}/4D-DRESS/data_processed/smplh",
              infopoints_dir=f"{DATA}/gt_4D-Dress_data/npz",
              activated_ids_path=f"{DATA}/useful_data_4d-dress/train_ids.pkl")
    with open(f"{DATA}/useful_data_4d-dress/superset_smpl.json") as fh:
        markers = list(json.load(fh).values())
    return dataset.DatasetPaths(**kw), jax_dataset.DatasetPaths(**kw), markers


def test_load_item_bit_equal_on_bundled_sample(paths):
    ours_p, ref_p, markers = paths
    assert dataset.list_ids(ours_p) == jax_dataset.list_ids(ref_p) == [ITEM]
    kw = dict(num_point=512, marker_vertex_ids=markers, seed=1, include_marker_positions=True)
    ours = dataset.load_item(ours_p, ITEM, **kw)
    ref = jax_dataset.load_item(ref_p, ITEM, **kw)
    assert proximity.last_backend == "native"
    assert set(ours) == set(ref)
    for k in ref:
        _eq(ours[k], ref[k])
    # the mixed variant (bbox-centred, rotated about y) through GTDataset
    ds = dataset.GTDataset(ours_p, 128, markers, seed=2, center=True, augment_rotation=True)
    rds = jax_dataset.GTDataset(ref_p, 128, markers, seed=2, center=True, augment_rotation=True)
    a, b = ds[0], rds[0]
    for k in b:
        _eq(a[k], b[k])
    both = dataset.ConcatDataset([ds, ds])
    assert len(both) == 2 and both[1]["id"] == ITEM


class _Items:
    """A small map-style dataset of random items (module level: workers
    unpickle it)."""

    def __init__(self, n, markers=False):
        self.n, self.markers = n, markers

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        item = {"id": f"s{i}", "gender": "neutral",
                "hitpts": rng.randn(16, 3).astype(np.float32),
                "vectors": rng.randn(16, 3).astype(np.float32),
                "confidences": rng.rand(16, 1).astype(np.float32),
                "labels": rng.randint(0, 86, 16).astype(np.int32)}
        if self.markers:
            item["markers_positions"] = rng.randn(86, 3).astype(np.float32)
        return item


@pytest.mark.parametrize("kw", [dict(batch_size=3, seed=5), dict(batch_size=2, shuffle=False),
                                dict(batch_size=4, seed=1, drop_last=False),
                                dict(batch_size=3, seed=5, num_workers=2)],
                         ids=["shuffle", "ordered", "keep_last", "workers"])
def test_batch_iterator_order_and_stacking(kw):
    items = _Items(10, markers=kw.get("drop_last", True))
    ours = list(dataset.batch_iterator(items, **kw))
    ref = list(jax_dataset.batch_iterator(items, **kw))
    assert len(ours) == len(ref) == (10 // kw["batch_size"] if kw.get("drop_last", True)
                                     else -(-10 // kw["batch_size"]))
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in b:
            _eq(a[k], b[k])


def test_metric_logger_jsonl(tmp_path):
    ours, ref = MetricLogger(str(tmp_path / "ours")), JaxLogger(str(tmp_path / "ref"))
    rows = [(0, {"all_loss": np.float32(1.25), "epoch_time_s": 3.5}),
            (1, {"all_loss": 0.75, "direction_loss": np.float64(1e-7)})]
    for step, m in rows:
        ours.log(step, m)
        ref.log(step, m)
    with open(ours.path, "rb") as a, open(ref.path, "rb") as b:
        assert a.read() == b.read()
    assert dict(ours.history) == dict(ref.history)
    ours.plot()   # draws nothing where matplotlib is missing, never raises
