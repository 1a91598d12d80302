"""The program's kernels against their roofline (serve): the least time the
card could take for every kernel launch of the profiled stretch (each
launch's shape from the program's launch counts, through the bound in
`perfbench/kernels/<kernel>.py`), over those kernels' device time in the
profiler's trace, in percent.  Nothing is read where a launched kernel has
no device time under its names, or no kernel has a bound."""

import re
import sys


def read(rec):
    if rec.kind != "serve":
        return None
    bound = seconds = 0.0
    for kernel, shapes in rec.profile.shape_launches.items():
        spec = rec.kernels.get(kernel)
        if spec is None:
            print(f"kernels_roofline: no bound for kernel {kernel}; left out", file=sys.stderr)
            continue
        t = sum(s for name, s, _ in rec.profile.kernels if re.search(spec.DEVICE_NAMES, name))
        if t <= 0:
            print(f"kernels_roofline: {kernel} launched, no device time under "
                  f"{spec.DEVICE_NAMES!r}", file=sys.stderr)
            return None
        bound += sum(n * spec.bound(key) for key, n in shapes.items())
        seconds += t
    return 100.0 * bound / seconds if seconds > 0 else None
