"""The f32 contraction (`csrc/interconv.cu`, 3xTF32): xyz, centers,
indices, the rotated kernel points and the whole (B, P, A*C) rows read
once, t (B, c, A, K, C) written; the kernel-point weights on the FP32
cores (11 operations each), the products as three TF32 passes, the least
the tensor cores need for f32-accurate products."""

from perfbench.peaks import TF32_TENSOR, bound_s

DEVICE_NAMES = r"\binterconv_tf32_kernel\b"
WEIGHT_FLOP = 11


def contraction(B, P, c, nn, A, K, C, elem):
    bytes_ = (B * P * 3 + B * c * 3 + A * K * 3) * 4 + B * c * nn * 4 + \
        (B * P * A * C + B * c * A * K * C) * elem
    products = 2.0 * B * c * nn * A * K * C
    weights = float(WEIGHT_FLOP) * B * c * nn * A * K
    if elem == 2:
        return bound_s(bytes_, products, weights)
    return bound_s(bytes_, 3.0 * products, weights, TF32_TENSOR)


def bound(key):
    _, B, P, c, nn, A, K, C, _sigma = key
    return contraction(B, P, c, nn, A, K, C, 4)
