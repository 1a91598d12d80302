"""Ball query (`csrc/knn.cu`): M queries among N supports, nsample kept.
The pairs an index-order search must visit depend on the points, so only
the bytes are counted: both clouds read once, the indices written.  The
share is therefore a floor of the roofline's."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"\bball_query_kernel\b"


def bound(key):
    _, B, M, N, _r2, nsample = key
    return bound_s(B * (M + N) * 12 + B * M * nsample * 4)
