"""The bf16 occupancy conv with its (K -> Co) projection fused
(`csrc/interconv.cu`): the weights as the f32 occupancy conv's, the
(A, K) x (K, Co) products on the tensor cores; bf16 output."""

from perfbench.kernels.interconv_ones import EXPANDED_WEIGHT_FLOP, NEIGHBOUR_FLOP
from perfbench.peaks import bound_s

DEVICE_NAMES = r"\binterconv_ones_proj_kernel\b"


def bound(key):
    _, B, P, c, nn, A, K, Co, _sigma = key
    return bound_s(B * P * 12 + B * c * 12 + B * c * nn * 4 + A * K * 12 + K * Co * 2
                   + B * c * A * Co * 2, 2.0 * B * c * A * K * Co,
                   (EXPANDED_WEIGHT_FLOP * A * K + NEIGHBOUR_FLOP) * B * c * nn)
