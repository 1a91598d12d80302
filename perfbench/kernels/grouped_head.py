"""The grouped confidence head (`csrc/grouped_head.cu`, `wgmma` + TMA):
h and the weights read in bf16, the (R, k) confidences written; h @ W0 on
the tensor cores, the per-group reduction on the FP32 cores."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"\bgrouped_head_kernel\b"


def bound(key):
    _, R, k, c0 = key
    return bound_s(R * c0 * 2 + c0 * k * c0 * 2 + R * k * 4, 2.0 * R * c0 * k * c0,
                   4.0 * R * k * c0)
