"""The bf16 contraction (`csrc/interconv.cu`, bf16 `mma.sync`): as the f32
one, with bf16 rows and t and the products at the bf16 tensor-core peak."""

from perfbench.kernels.interconv_t import contraction

DEVICE_NAMES = r"\binterconv_mma(_ring)?_kernel\b"


def bound(key):
    _, B, P, c, nn, A, K, C, _sigma = key
    return contraction(B, P, c, nn, A, K, C, 2)
