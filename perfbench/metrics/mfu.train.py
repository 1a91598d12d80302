"""The whole step's share of the card's peak (train): the frozen analytic
FLOPs of every item the traced window completed (serving: forward and fit
a scan; training: three forwards a sample) over the window's time and the
configuration's peak (989 TFLOP/s bf16, 67 TFLOP/s FP32), in percent."""


def read(rec):
    if rec.kind != "train":
        return None
    return 100.0 * rec.item_flops * rec.items_per_call * rec.calls / rec.window_s / rec.peak_flops
