"""Device launches a batch outside the network forward (markers, LM fit,
SMPL), counted from the host's launch calls in the profiled stretch."""


def read(rec):
    if rec.kind != "serve":
        return None
    n = rec.profile.launches.get("serve.fit", 0)
    return n / rec.profile.calls if n else None
