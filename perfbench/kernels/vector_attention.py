"""The Point Transformer vector attention (`csrc/vector_attention.cu`):
q, k, v and the position encodings read in bf16 with the indices, the f32
output written; the two weight-MLP products on the tensor cores, the
affines, softmax and aggregation on the FP32 cores."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"\bvector_attention(_wide)?_kernel\b"


def bound(key):
    _, R, _N, ns, c, cs = key
    return bound_s(R * c * 2 * 3 + R * ns * (4 + c * 2) + R * c * 4,
                   2.0 * R * ns * (c * cs + cs * cs), R * ns * (8.0 * c + 6.0 * cs))
