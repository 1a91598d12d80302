"""`nn/bf16.py::mm` on the card: the bf16 tensor-core product with f32 output
(skipped without a card).

Run on a machine with an H100:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bf16_mm_cuda.py`
(tests/conftest.py imports jax).  Every test takes the `cuda` fixture.

  - at each of the EPN's product shapes at B=32, N=5000 (the rows of an
    intra conv or of a 512-centre projection chunk; K·C or 12·C from 384 to
    6144; Co from 32 to 256), the output is f32 and within the f32 summation
    bound, (terms) · 2^-24 · Σ|a||b|, of the float64 product of the
    bf16-rounded operands.  A sum rounded to bf16 anywhere (torch's
    bf16-output matmul, a split-K reduction in bf16) breaks that bound, and
    the bf16-output product is checked to break it at every shape;
  - the form `point_transformer.Dense` calls it in (f32 rows, the weight
    transposed), within the same bound;
  - `on=False`, and a product autograd records, keep the widened form bit
    for bit and count no tensor-core product;
  - one forward of the four-block bf16 encoder at N=5000, B=2 is as
    accurate against the f32 encoder as the same encoder with its products
    widened (`chip_smoke.AS_ACCURATE_STEP`), and every product it takes
    counts once in `bf16.tc_products`.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from etch_tpu_torch.models.etch_net import EtchNet, init_params  # noqa: E402
from etch_tpu_torch.nn import bf16, epn  # noqa: E402
from etch_tpu_torch.utils import trace  # noqa: E402
from etch_tpu_torch.utils.config import EtchConfig  # noqa: E402

pytestmark = pytest.mark.cuda

U = 2.0 ** -24           # f32 unit roundoff
ROWS = 1 << 16           # rows of a float64 reference block
# (rows, k, n) of the EPN's products at B=32, N=5000 and 60 anchors: an intra
# conv (12·C -> Co over every centre) or a projection (24·C -> Co over a
# chunk of 512 centres, or the last block's 313)
PATH = [
    (4_800_000, 384, 32),      # block 1 intra conv (both bf16 cells)
    (983_040, 768, 32),        # block 1, second conv's projection
    (2_400_000, 768, 64),      # block 2 intra conv
    (983_040, 1536, 64),       # block 2, second conv's projection
    (1_200_000, 1536, 128),    # block 3 intra conv (four blocks)
    (983_040, 3072, 128),      # block 3, second conv's projection
    (600_960, 3072, 256),      # block 4 intra conv
    (600_960, 6144, 256),      # block 4, second conv's projection
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def tracer_on():
    trace.drain()
    trace.enable()
    yield
    trace.disable()
    trace.drain()


def _randn(dev, *shape, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _bound_ratio(out, a, b, bias=None):
    """max over the output of |out - exact| / ((terms) · 2^-24 · Σ|a||b|),
    with `exact` the float64 product of the bf16-rounded operands (plus the
    bias): at most 1 for any f32 summation order."""
    b64 = b.to(torch.bfloat16).double()
    terms = a.shape[1] + (bias is not None)
    worst = 0.0
    for s in range(0, a.shape[0], ROWS):
        a64 = a[s:s + ROWS].to(torch.bfloat16).double()
        ref, mag = a64 @ b64, a64.abs() @ b64.abs()
        if bias is not None:
            ref, mag = ref + bias.double(), mag + bias.double().abs()
        err = (out[s:s + ROWS].double() - ref).abs()
        worst = max(worst, float((err / (terms * U * mag)).max()))
    return worst


@pytest.mark.parametrize("rows,k,n", PATH, ids=[f"{r}x{k}x{n}" for r, k, n in PATH])
def test_tc_product_within_the_f32_summation_bound(cuda, rows, k, n):
    # rows of positive mean (as after a leaky ReLU), and half the columns of
    # w non-negative: there the sum hardly cancels, so a bf16 rounding of it
    # (2^-9 of |sum|) exceeds the bound at every k of the path.  With
    # zero-mean operands the sum cancels to about sqrt(k) terms' size while
    # the bound grows as k^2: the bf16-output product read 0.864 of the
    # bound at 600960x6144x256 (on an H100), a bf16 sum the bound missed
    a = (_randn(cuda, rows, k, seed=1) + 0.5).to(torch.bfloat16)
    w = _randn(cuda, k, n, seed=2) / k ** 0.5
    w[:, :n // 2] = w[:, :n // 2].abs()
    bias = _randn(cuda, n, seed=3)
    out = bf16.mm(a, w, True, bias)
    assert out.dtype == torch.float32 and out.shape == (rows, n)
    assert trace.drain()[1] == {"bf16.tc_products": 1}
    ratio = _bound_ratio(out, a, w, bias)
    # a sum rounded to bf16 breaks the bound: the bound has the power to see it
    rounded = (a @ w.to(torch.bfloat16)).float() + bias
    control = _bound_ratio(rounded, a, w, bias)
    print(f"{rows}x{k}x{n}: error / bound {ratio:.3e}; bf16-output product {control:.3e}")
    assert ratio <= 1.0
    assert control > 1.0
    del out, rounded
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rows,k,n", [(160_000, 64, 128), (40_000, 512, 86)])
def test_dense_form_within_the_bound(cuda, rows, k, n):
    """f32 rows and a transposed f32 weight, as `Dense` passes them."""
    x = _randn(cuda, rows, k, seed=4)
    weight = _randn(cuda, n, k, seed=5) / k ** 0.5       # torch Linear's (out, in)
    out = bf16.mm(x, weight.T)
    assert out.dtype == torch.float32
    assert _bound_ratio(out, x, weight.T) <= 1.0
    assert trace.drain()[1] == {"bf16.tc_products": 1}


def test_f32_and_recorded_products_keep_the_widened_form(cuda):
    a = _randn(cuda, 3, 70, 96, seed=6)
    w = _randn(cuda, 96, 40, seed=7)
    bias = _randn(cuda, 40, seed=8)
    with torch.no_grad():
        assert torch.equal(bf16.mm(a, w, False, bias), a @ w + bias)
    wg = w.clone().requires_grad_(True)
    got = bf16.mm(a, wg, True, bias)
    assert got.requires_grad
    assert torch.equal(got, bf16.rnd(a) @ bf16.rnd(wg) + bias)
    got.sum().backward()
    assert wg.grad is not None and bool(torch.isfinite(wg.grad).all())
    assert trace.drain()[1] == {}


def _widened(a, b, on=True, bias=None):
    out = bf16.rnd(a, on) @ bf16.rnd(b, on)
    return out if bias is None else out + bias


def test_four_block_encoder_as_accurate_as_the_widened_form(cuda, monkeypatch):
    """Eight convs deep, summation order alone flips enough bf16 roundings
    that the two forms' encoder outputs differ by a median relative 5.9e-3
    (H100), past `tests/test_torch_bf16.py`'s kernel parity median of 5e-3.
    So the tensor-core form is held as the repository holds a full-width
    bf16 serving step (`chip_smoke.AS_ACCURATE_STEP`): its error against the
    f32 encoder at most 1.3 times the widened form's, in the median
    relative and the max."""
    import chip_smoke
    models = {}
    for bf in (True, False):
        models[bf] = EtchNet(EtchConfig(num_point=5000, epn_layer_num=4, use_bfloat16=bf))
    with torch.no_grad():
        init_params(models[True], torch.Generator().manual_seed(0))
    models[False].load_state_dict(models[True].state_dict())
    enc = {bf: m.encoder.to(cuda).eval() for bf, m in models.items()}
    g = torch.Generator(device=cuda).manual_seed(9)
    pts = torch.rand(2, 5000, 3, generator=g, device=cuda) - 0.5
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return bf16.mm(*args, **kw)
    with torch.no_grad():
        monkeypatch.setattr(epn, "mm", counted)
        xyz, got = enc[True](pts)
        counts = trace.drain()[1]
        monkeypatch.setattr(epn, "mm", _widened)
        xyz_ref, widened = enc[True](pts)
        exact = enc[False](pts)[1]
    assert counts["bf16.tc_products"] == len(calls) > 8
    assert torch.equal(xyz, xyz_ref)
    assert "bf16.tc_products" not in trace.drain()[1]
    got, widened, exact = got.float(), widened.float(), exact.float()
    apart = chip_smoke.median_rel((got - widened).abs(), widened)
    tc, wide, ok = chip_smoke.as_accurate(got, widened, exact, chip_smoke.AS_ACCURATE_STEP)
    print(f"encoder: forms apart (median rel) {apart:.3e}; against f32 (median rel, max abs):"
          f" tensor cores {tc}, widened {wide}")
    assert ok, (tc, wide)
