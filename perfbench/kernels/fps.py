"""FPS (`csrc/fps.cu`): a (B, N) cloud, m centers.  Each step's distance of
every point to the last center and the running minimum, about 10 FP32
operations a point a step; the cloud read once, the indices written."""

from perfbench.peaks import bound_s

DEVICE_NAMES = r"\bfps_(reg|mem)_kernel\b"


def bound(key):
    _, B, N, m = key
    return bound_s(B * N * 12 + B * m * 4, 0.0, 10.0 * B * m * N)
