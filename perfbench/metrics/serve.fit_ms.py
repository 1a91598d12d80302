"""Markers, LM fit and SMPL: milliseconds a batch on the host's clock, each
`run_batch` up to its outputs on the host less its forward's device time,
over every batch of the window."""


def read(rec):
    if rec.kind != "serve" or not rec.layer_ms["fit"]:
        return None
    return sum(rec.layer_ms["fit"]) / len(rec.layer_ms["fit"])
