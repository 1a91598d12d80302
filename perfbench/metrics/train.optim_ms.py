"""Training step, optim: device milliseconds a step from CUDA events on the
model's and the optimizer's hooks (forward: the model's pre- to post-hook;
backward: from there to the optimizer's pre-hook, the loss included;
optim: from there to the step's end, Adam and the NaN guard), over every
step of the window."""


def read(rec):
    if rec.kind != "train" or not rec.layer_ms["optim"]:
        return None
    return sum(rec.layer_ms["optim"]) / len(rec.layer_ms["optim"])
