"""Network forward, serving: device milliseconds a batch, from CUDA events
on `EtchNet`'s forward pre- and post-hooks, over every batch of the window."""


def read(rec):
    if rec.kind != "serve" or not rec.layer_ms["forward"]:
        return None
    return sum(rec.layer_ms["forward"]) / len(rec.layer_ms["forward"])
