"""The card's idle share (serve), in percent: 1 - the device's busy seconds a
call in the profiled stretch (kernels, copies and sets, from the
profiler's device intervals) over the seconds a call of the untraced part
of the window.  The profiler's host overhead stretches the profiled calls
themselves (about 2.6x a serving batch on an H100), so their own length
would overstate the idle share."""


def read(rec):
    if rec.kind != "serve" or rec.profile.calls <= 0 or rec.calls <= 0:
        return None
    busy = rec.profile.busy_s / rec.profile.calls
    return 100.0 * max(0.0, 1.0 - busy / (rec.window_s / rec.calls))
