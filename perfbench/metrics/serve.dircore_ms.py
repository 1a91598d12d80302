"""The fused direction core, serving: device milliseconds a batch of the
kernels named by `perfbench/kernels/dircore.py::DEVICE_NAMES`
(`csrc/dircore.cu`, `dircore_wide.cu`, `dircore_big.cu`) in the profiled
stretch.  Nothing is read where they have no device time (the chunked
core of the f32 path launches none of them)."""

import re


def read(rec):
    spec = rec.kernels.get("dircore")
    if rec.kind != "serve" or spec is None or rec.profile.calls <= 0:
        return None
    t = sum(s for name, s, _ in rec.profile.kernels if re.search(spec.DEVICE_NAMES, name))
    return 1e3 * t / rec.profile.calls if t > 0 else None
