"""`nn/bf16.py::mm` on the CPU: bit for bit the widened form.

On the CPU, and wherever autograd records the product, `mm(a, b, on, bias)`
is the f32 product of the operands rounded to bf16 (`rnd(a, on) @ rnd(b,
on)`, plus the bias), with the same gradients, and counts no tensor-core
product.  The card's form is held in `tests/test_torch_bf16_mm_cuda.py`.
"""

import pytest
import torch

from etch_tpu_torch.nn.bf16 import mm, rnd
from etch_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def tracer_on():
    trace.drain()
    trace.enable()
    yield
    trace.disable()
    trace.drain()


def _operands(a_dtype, b_dtype, bias, grad):
    g = torch.Generator().manual_seed(7)
    a = torch.randn(3, 5, 40, generator=g).to(a_dtype)
    b = torch.randn(40, 24, generator=g).to(b_dtype)
    c = torch.randn(24, generator=g) if bias else None
    for t in (a, b, c):
        if grad and t is not None:
            t.requires_grad_(True)
    return a, b, c


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16], ids=["b_f32", "b_bf16"])
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16], ids=["a_f32", "a_bf16"])
@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_mm_on_the_cpu_is_the_widened_product(on, a_dtype, b_dtype, bias, grad):
    a, b, c = _operands(a_dtype, b_dtype, bias, grad)
    with torch.set_grad_enabled(grad):
        got = mm(a, b, on, c)
        want = rnd(a, on) @ rnd(b, on)
        if c is not None:
            want = want + c
    assert got.dtype == torch.float32 and got.shape == (3, 5, 24)
    assert torch.equal(got, want)
    if grad:
        leaves = [t for t in (a, b, c) if t is not None]
        w = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
        g_got = torch.autograd.grad((got * w).sum(), leaves)
        g_want = torch.autograd.grad((want * w).sum(), leaves)
        for x, y in zip(g_got, g_want):
            assert torch.equal(x, y)
    assert trace.drain()[1] == {}
