"""The LM fit's Jacobian pass replayed from a CUDA graph, on the card
(skipped without one).

Run on a machine with an H100:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fit_graph_cuda.py`
(tests/conftest.py imports jax).  Every test takes the `cuda` fixture.
Everything is compared with `torch.equal`: a graph replays the kernels the
eager pass launches, on the same data.

  - `levenberg_marquardt` at B=32 and B=1, each stage's residual, steps,
    step size and damping, against the eager `levenberg_marquardt_with_history`
    on the same inputs; then a second problem through the same graph (a
    stale static buffer would show); one capture, then none, and a replay
    an iteration;
  - `InferencePipeline.fit` on two batches of inner points against the
    same pipeline with its LM forced eager: verts, params, markers, valid
    and joints; 2 captures and 80 replays on the first batch, 0 and 80 on
    the second, and 80 iterations each.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from etch_tpu_torch.body import smpl  # noqa: E402
from etch_tpu_torch.fit import lm, smpl_fit  # noqa: E402
from etch_tpu_torch.fit.smpl_fit import NUM_POSE, marker_residual  # noqa: E402
from etch_tpu_torch.models.etch_net import EtchNet  # noqa: E402
from etch_tpu_torch.pipeline import InferencePipeline  # noqa: E402
from etch_tpu_torch.utils import trace  # noqa: E402
from etch_tpu_torch.utils.config import EtchConfig  # noqa: E402
from perfbench import inputs  # noqa: E402

pytestmark = pytest.mark.cuda

STAGES = {0: (2, 30, 0.5, 0.01), 1: (10, 50, 0.2, 1e-3)}   # free betas, steps, lr, damping


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _body():
    """The benchmark's 6,890-vertex synthetic body and its 86 marker ids."""
    body = inputs.synthetic_body()
    bt = inputs.body_tensors(body, "cpu")
    model = smpl.SMPLModel(v_template=bt["v_template"], shapedirs=bt["shapedirs"],
                           posedirs=bt["posedirs"], J_regressor=bt["J_regressor"],
                           lbs_weights=bt["lbs_weights"], parents=body["parents"],
                           faces=body["faces"], landmark_ids=body["landmark_ids"])
    return model, inputs.marker_vids(body["v_template"].shape[0])


def _markers(sub, B, seed, dev):
    """Markers of the body at random parameters, with noise, and a mask
    with about a tenth of them missing."""
    g = torch.Generator().manual_seed(seed)
    betas, pose = torch.randn(B, 10, generator=g) * 0.5, torch.randn(B, 69, generator=g) * 0.2
    orient, transl = torch.randn(B, 3, generator=g) * 0.3, torch.randn(B, 3, generator=g) * 0.1
    m = smpl.marker_forward(sub, betas.to(dev), pose.to(dev), orient.to(dev), transl.to(dev))
    m = m + (torch.randn(m.shape, generator=g) * 0.01).to(dev)
    valid = (torch.rand(m.shape[:2], generator=g) > 0.1).to(dev)
    return m, valid


def _counts():
    c = trace.drain()[1]
    return (c.get("fit.lm.graph_captures", 0), c.get("fit.lm.graph_replays", 0),
            c.get("fit.lm_iterations", 0))


@pytest.mark.parametrize("B", [32, 1])
@pytest.mark.parametrize("stage", [0, 1])
def test_graphed_lm_bit_equal_to_eager(cuda, B, stage):
    model, vids = _body()
    sub = smpl.marker_submodel(model.to(cuda), vids)
    n_free, steps, lr, damping = STAGES[stage]
    P = NUM_POSE + n_free + 6
    for k, seed in enumerate((B, B + 100)):
        markers, valid = _markers(sub, B, seed, cuda)
        args = (markers, valid.to(markers.dtype)[..., None])
        g = torch.Generator().manual_seed(seed)
        x0 = (torch.randn(B, P, generator=g) * 0.05 * stage).to(cuda)
        trace.enable()
        got = lm.levenberg_marquardt(marker_residual(sub, n_free), x0, args, steps, lr, damping,
                                     graph_key=(id(sub), n_free, 10))
        trace.disable()
        assert _counts() == (1 - k, steps, steps)
        want = lm.levenberg_marquardt_with_history(marker_residual(sub, n_free), x0, args,
                                                   steps, lr, damping)[0]
        assert torch.isfinite(want).all()
        assert torch.equal(got, want), (k, (got - want).abs().max())


def _inner(sub, B, seed, dev):
    """Inner points that give the markers of `_markers`: four points a
    marker, labelled with it, with random confidences."""
    markers, valid = _markers(sub, B, seed, dev)
    M = markers.shape[1]
    g = torch.Generator().manual_seed(seed + 1)
    pts = markers.repeat_interleave(4, 1) + (torch.randn(B, 4 * M, 3, generator=g) * 1e-3).to(dev)
    labels = torch.arange(M, device=dev).repeat_interleave(4)[None].expand(B, -1).clone()
    labels[~valid.repeat_interleave(4, 1)] = M          # a missing marker has no points
    conf = (torch.rand(B, 4 * M, 1, generator=g) * 0.5 + 0.5).to(dev)
    return pts, labels, conf


def _eager(*a, graph_key=None):
    return lm.levenberg_marquardt_with_history(*a)[0]


@pytest.mark.parametrize("B", [32, 1])
def test_pipeline_fit_graphed_equals_eager(cuda, B, monkeypatch):
    model, vids = _body()
    cfg = EtchConfig.tiny(fit_steps_stage0=30, fit_steps_stage1=50)
    pipe = InferencePipeline(cfg, EtchNet(cfg), model, vids, cuda)
    batches = [_inner(pipe.sub, B, seed, cuda) for seed in (B + 7, B + 8)]
    graphed = []
    for k, batch in enumerate(batches):
        trace.enable()
        graphed.append(pipe.fit(*batch))
        trace.disable()
        assert _counts() == (2 * (k == 0), 80, 80)
    monkeypatch.setattr(smpl_fit, "levenberg_marquardt", _eager)
    for got, batch in zip(graphed, batches):
        want = pipe.fit(*batch)
        assert torch.isfinite(want[0]).all()
        for name, a, b in zip(("verts", "params", "markers", "valid", "joints"), got, want):
            if name == "params":
                for p in a:
                    assert torch.equal(a[p], b[p]), p
            else:
                assert torch.equal(a, b), name
