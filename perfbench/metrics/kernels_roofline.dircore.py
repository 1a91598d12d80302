"""The fused direction core against its roofline (serve): the least time the
card could take for every direction-core launch of the profiled stretch
(each launch's shape from the program's launch counts,
`shape_launches["dircore"]`, through `perfbench/kernels/dircore.py::bound`),
over those kernels' device time in the profiler's trace, in percent.
Nothing is read where the core was not launched or has no device time."""

import re


def read(rec):
    spec = rec.kernels.get("dircore")
    shapes = rec.profile.shape_launches.get("dircore")
    if rec.kind != "serve" or spec is None or not shapes:
        return None
    t = sum(s for name, s, _ in rec.profile.kernels if re.search(spec.DEVICE_NAMES, name))
    if t <= 0:
        return None
    return 100.0 * sum(n * spec.bound(key) for key, n in shapes.items()) / t
