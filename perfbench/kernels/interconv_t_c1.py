"""The 1-channel contraction (`csrc/interconv.cu`, `interconv_w_kernel<T,
true>`): the occupancy conv's weights with each neighbour's feature, 9
FP32 operations a weight, 10 a neighbour; rows and t in the rows' type."""

from perfbench.kernels.interconv_ones import EXPANDED_WEIGHT_FLOP, NEIGHBOUR_FLOP
from perfbench.peaks import bound_s

DEVICE_NAMES = r"\binterconv_w_kernel<[^,]+, true>"


def bound(key):
    entry, B, P, c, nn, A, K, _sigma = key
    elem = 2 if entry.endswith("bf16") else 4
    bytes_ = (B * P * 3 + B * c * 3 + A * K * 3) * 4 + B * c * nn * 4 + \
        (B * P * A + B * c * A * K) * elem
    return bound_s(bytes_, 0.0, ((EXPANDED_WEIGHT_FLOP + 1) * A * K + NEIGHBOUR_FLOP) * B * c * nn)
