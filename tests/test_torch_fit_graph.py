"""The LM fit's Jacobian pass as the card's CUDA graph captures it, checked
on the CPU (tests/test_torch_fit_graph_cuda.py replays it on the card):

  - `_rigid_transforms`, `marker_forward`, `smpl_forward` and the vmapped
    Jacobian of the marker residual, now with the parent index and the
    bottom row made on the device, bit-equal to the frozen plain copies in
    `perfbench/reference/fit.py` on random poses over the benchmark's
    synthetic body;
  - the parent index is made once a device;
  - on the CPU the fit takes the eager path: no graph is captured or
    replayed, `fit.lm_iterations` reads 80, and a `graph_key` changes no
    number;
  - the graph cache (`_jacobian_graph`) with a stand-in for the capture:
    one capture a key and shape, the arguments loaded on a hit, the least
    recently used entry evicted past eight.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from etch_tpu_torch.body import smpl  # noqa: E402
from etch_tpu_torch.fit import lm  # noqa: E402
from etch_tpu_torch.fit.smpl_fit import NUM_POSE, fit_smpl_params, marker_residual  # noqa: E402
from etch_tpu_torch.utils import trace  # noqa: E402
from perfbench import inputs  # noqa: E402
from perfbench.reference import fit as ref_fit  # noqa: E402

B = 3


@pytest.fixture(scope="module")
def bodies():
    """(the port's SMPLModel, the reference's dict) of the benchmark's
    6,890-vertex synthetic body, and the 86 marker ids."""
    body = inputs.synthetic_body()
    bt = inputs.body_tensors(body, "cpu")
    model = smpl.SMPLModel(v_template=bt["v_template"], shapedirs=bt["shapedirs"],
                           posedirs=bt["posedirs"], J_regressor=bt["J_regressor"],
                           lbs_weights=bt["lbs_weights"], parents=body["parents"],
                           faces=body["faces"], landmark_ids=body["landmark_ids"])
    return model, bt, inputs.marker_vids(body["v_template"].shape[0])


def _params(seed, n=B):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 10, generator=g) * 0.5, torch.randn(n, 69, generator=g) * 0.3,
            torch.randn(n, 3, generator=g) * 0.5, torch.randn(n, 3, generator=g) * 0.1)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rigid_transforms_bit_equal_to_reference(bodies, seed):
    model, bt, _ = bodies
    betas, pose, orient, _ = _params(seed)
    R, _ = smpl._pose_blend(torch.cat([orient, pose], 1))
    J = torch.einsum("jv,bvc->bjc", bt["J_regressor"],
                     bt["v_template"][None] + torch.einsum("vcs,bs->bvc", bt["shapedirs"], betas))
    assert torch.equal(smpl._rigid_transforms(R, J, model.parents),
                       ref_fit._rigid_transforms(R, J, bt["parents"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_marker_and_smpl_forward_bit_equal_to_reference(bodies, seed):
    model, bt, vids = bodies
    betas, pose, orient, transl = _params(seed)
    got = smpl.marker_forward(smpl.marker_submodel(model, vids), betas, pose, orient, transl)
    want = ref_fit.marker_forward(ref_fit.marker_submodel(bt, vids), betas, pose, orient,
                                  transl)
    assert torch.equal(got, want)
    for a, b in zip(smpl.smpl_forward(model, betas, pose, orient, transl),
                    ref_fit.smpl_forward(bt, betas, pose, orient, transl)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_free", [2, 10])
def test_jacobian_pass_bit_equal_to_reference(bodies, n_free):
    """The pass the card captures: vmap(jacfwd) of the stage's residual."""
    model, bt, vids = bodies
    sub, ref_sub = smpl.marker_submodel(model, vids), ref_fit.marker_submodel(bt, vids)
    g = torch.Generator().manual_seed(n_free)
    x = torch.randn(B, NUM_POSE + n_free + 6, generator=g) * 0.2
    target = torch.randn(B, len(vids), 3, generator=g) * 0.3
    mask = (torch.rand(B, len(vids), 1, generator=g) > 0.2).float()

    def ref_residual(x, target, mask):
        pose, b_free, orient, transl = ref_fit._unpack(x, n_free)
        betas = torch.cat([b_free, b_free.new_zeros(10 - n_free)])
        fwd = ref_fit.marker_forward(ref_sub, betas[None], pose[None], orient[None],
                                     transl[None])[0]
        return ((target - fwd) * mask).reshape(-1)

    got = vmap(jacfwd(marker_residual(sub, n_free)))(x, target, mask)
    want = vmap(jacfwd(ref_residual))(x, target, mask)
    assert got.shape == (B, len(vids) * 3, x.shape[1])
    assert torch.equal(got, want)


def test_parent_index_made_once_a_device(bodies):
    model, _, _ = bodies
    a = smpl._parent_index(tuple(model.parents), torch.device("cpu"))
    assert a is smpl._parent_index(tuple(model.parents), torch.device("cpu"))
    assert a.dtype == torch.int64 and a.tolist() == list(model.parents[1:])


def test_cpu_fit_is_eager_and_counts_no_graph(bodies):
    model, _, vids = bodies
    sub = smpl.marker_submodel(model, vids)
    betas, pose, orient, transl = _params(5, 2)
    markers = smpl.marker_forward(sub, betas * 0.2, pose * 0.2, orient, transl)
    valid = torch.ones(markers.shape[:2], dtype=torch.bool)
    cached = len(lm._GRAPHS)
    trace.enable()
    fit_smpl_params(sub, markers, valid)
    trace.disable()
    _, counts = trace.drain()
    assert counts["fit.lm_iterations"] == 80
    assert counts.get("fit.lm.graph_captures", 0) == 0
    assert counts.get("fit.lm.graph_replays", 0) == 0
    assert len(lm._GRAPHS) == cached


def test_graph_key_changes_no_number_on_the_cpu(bodies):
    model, _, vids = bodies
    sub = smpl.marker_submodel(model, vids)
    g = torch.Generator().manual_seed(7)
    target = torch.randn(2, len(vids), 3, generator=g) * 0.3
    mask = torch.ones(2, len(vids), 1)
    x0 = torch.zeros(2, NUM_POSE + 2 + 6)
    run = lambda **k: lm.levenberg_marquardt(marker_residual(sub, 2), x0, (target, mask),  # noqa: E731
                                             5, 0.5, 0.01, **k)
    eager = lm.levenberg_marquardt_with_history(marker_residual(sub, 2), x0, (target, mask),
                                                5, 0.5, 0.01)[0]
    assert torch.equal(run(), eager)
    assert torch.equal(run(graph_key=(id(sub), 2, 10)), eager)


class _Capture:
    """Stands in for `_JacobianGraph`: records its captures and loads."""
    made = []

    def __init__(self, jac, residual_fn, x, args):
        self.residual_fn, self.loads = residual_fn, []
        _Capture.made.append(self)

    def load(self, args):
        self.loads.append(args)


def test_graph_cache_keys_loads_and_evicts(monkeypatch):
    monkeypatch.setattr(lm, "_JacobianGraph", _Capture)
    monkeypatch.setattr(lm, "_GRAPHS", type(lm._GRAPHS)())
    _Capture.made = []
    fn = lambda x, t: x  # noqa: E731
    x, t = torch.zeros(4, 5), torch.zeros(4, 2)
    first = lm._jacobian_graph(None, fn, x, (t,), ("sub", 2))
    again = lm._jacobian_graph(None, lambda x, t: x, x, (t + 1,), ("sub", 2))
    assert again is first and len(_Capture.made) == 1
    assert torch.equal(first.loads[0][0], t + 1) and first.residual_fn is fn
    # another stage, batch size, dtype or residual is another capture
    lm._jacobian_graph(None, fn, x, (t,), ("sub", 10))
    lm._jacobian_graph(None, fn, torch.zeros(1, 5), (torch.zeros(1, 2),), ("sub", 2))
    lm._jacobian_graph(None, fn, x.double(), (t.double(),), ("sub", 2))
    lm._jacobian_graph(None, fn, x, (t,), None)
    assert len(_Capture.made) == 5
    for i in range(lm._MAX_GRAPHS):
        lm._jacobian_graph(None, fn, x, (t,), ("other", i))
    assert len(lm._GRAPHS) == lm._MAX_GRAPHS
    # the oldest entries went first; the newest stay
    assert all(k[0][0] == "other" for k in lm._GRAPHS)
    lm._jacobian_graph(None, fn, x, (t,), ("sub", 2))
    assert len(_Capture.made) == 6 + lm._MAX_GRAPHS
