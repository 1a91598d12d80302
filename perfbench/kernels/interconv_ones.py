"""The f32 occupancy conv (`csrc/interconv.cu`, `interconv_w_kernel<float,
false>`): the kernel-point weights summed over each center's neighbours,
counted in the expanded form (8 FP32 operations a weight, 10 a neighbour);
points, centers, indices and kernel points read, t (B, c, A*K) written."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"\binterconv_w_kernel<float, false>"
EXPANDED_WEIGHT_FLOP, NEIGHBOUR_FLOP = 8, 10


def bound(key):
    _, B, P, c, nn, AK, _sigma = key
    return bound_s(B * P * 12 + B * c * 12 + B * c * nn * 4 + AK * 12 + B * c * AK * 4, 0.0,
                   (EXPANDED_WEIGHT_FLOP * AK + NEIGHBOUR_FLOP) * B * c * nn)
