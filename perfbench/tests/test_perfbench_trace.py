"""The profile's reduction, on events made up in the shape torch.profiler
gives them: busy time, idle gaps by span, launches by span, kernel times,
and the per-layer readers on it."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import core, trace  # noqa: E402
from perfbench.kernels import knn  # noqa: E402


class Ev:
    def __init__(self, name, dev, start, end, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, start, end, corr

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


SPANS = ("serve.fit", "serve.forward")
EVENTS = [
    Ev("serve.fit", "CPU", 0, 1000),
    Ev("serve.forward", "CPU", 0, 300),
    Ev("cudaLaunchKernel", "CPU", 10, 12, 1),
    Ev("cudaLaunchKernel", "CPU", 400, 402, 2),
    Ev("cudaLaunchKernel", "CPU", 500, 502, 3),
    Ev("serve.forward", "CUDA", 20, 300),          # the span's device side: not work
    Ev("void knn_kernel<8>(float const*)", "CUDA", 20, 120, 1),
    Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 110, 150, 0),
    Ev("void at::native::elementwise_kernel<128>(x)", "CUDA", 450, 470, 2),
    Ev("void at::native::elementwise_kernel<128>(x)", "CUDA", 600, 650, 3),
]


def test_profile_reduction():
    p = trace.Profile(EVENTS, SPANS, window_s=1e-6, calls=1,
                      shapes={"knn": {("etch_knn", 2, 100, 100, 8): 1}})
    assert p.busy_s == pytest.approx((150 - 20 + 20 + 50) * 1e-9)
    assert p.launches == {"serve.forward": 1, "serve.fit": 2}
    assert p.gaps == pytest.approx({"serve.fit": (450 - 150 + 600 - 470) * 1e-9})
    assert [k[2] for k in p.kernels] == ["serve.forward", "serve.fit", "serve.fit"]
    assert p.device_ops()[0][0].startswith("void knn_kernel")


def test_readers_on_a_profile():
    p = trace.Profile(EVENTS, SPANS, window_s=1e-6, calls=1,
                      shapes={"knn": {("etch_knn", 2, 100, 100, 8): 1}})
    rec = SimpleNamespace(kind="serve", items_per_call=2, calls=3, window_s=1.0,
                          layer_ms={"forward": [1.0, 3.0], "fit": [5.0, 7.0]}, profile=p,
                          item_flops=1e9, peak_flops=1e12, kernels=core.kernel_bounds())
    names = ["serve.forward_ms", "serve.fit_ms", "serve.fit_kernels", "kernels_roofline.serve",
             "mfu.serve", "device.idle_pct.serve", "train.forward_ms", "mfu.train"]
    got = {n: r.read(rec) for n, r in core.metric_readers(names).items()}
    assert got["serve.forward_ms"] == 2.0 and got["serve.fit_ms"] == 6.0
    assert got["serve.fit_kernels"] == 2
    want = 100 * knn.bound(("etch_knn", 2, 100, 100, 8)) / 100e-9
    assert got["kernels_roofline.serve"] == pytest.approx(want)
    assert got["mfu.serve"] == pytest.approx(100 * 1e9 * 6 / 1e12)
    assert got["device.idle_pct.serve"] == pytest.approx(100 * (1 - 200e-9 / (1.0 / 3)))
    assert got["train.forward_ms"] is None and got["mfu.train"] is None


@pytest.mark.parametrize("kernel", sorted(core.kernel_bounds()))
def test_every_kernel_of_the_program_has_a_bound(kernel):
    from etch_tpu_torch import _build
    spec = core.kernel_bounds()[kernel]
    assert kernel in _build.launches and spec.DEVICE_NAMES
