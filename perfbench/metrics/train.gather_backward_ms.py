"""Training step, the gathers' backward: device milliseconds a step, in the
profiled stretch, of advanced indexing's backward kernels (`index_put_`
with accumulation, which the backward of a gather by index runs), by kernel
name.  This is where the cotangents of the 3-NN propagation's gathers and
of the inter-conv plain twins' neighbour gathers are summed into their
sources.  Nothing is read where no such kernel has device time."""

import re

NAMES = r"indexing_backward_kernel"


def read(rec):
    if rec.kind != "train" or rec.profile.calls <= 0:
        return None
    t = sum(s for name, s, _ in rec.profile.kernels if re.search(NAMES, name))
    return 1e3 * t / rec.profile.calls if t > 0 else None
