"""The anchor attention of the chunked direction core (`csrc/attention.cu`):
bf16 q, k, v read, the f32 output written; q.k and a.v on the bf16 tensor
cores."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"(?<!vector_)\battention_kernel\b"


def bound(key):
    _, Bc, L, E, _H = key
    return bound_s(3 * Bc * L * E * 2 + Bc * L * E * 4, 4.0 * Bc * L * L * E)
