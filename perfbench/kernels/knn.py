"""kNN (`csrc/knn.cu`): M queries against N supports, k kept.  Every
pair's squared distance and its comparison, about 8 FP32 operations; both
clouds read once, the indices and distances written."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"\bknn_kernel\b"


def bound(key):
    _, B, M, N, k = key
    return bound_s(B * (M + N) * 12 + B * M * k * 8, 0.0, 8.0 * B * M * N)
