"""Published peaks of one NVIDIA H100 SXM (dense, 700 W), and the roofline.

NVIDIA's data sheet: 3.35 TB/s of HBM3; 989 TFLOP/s in bf16 on the tensor
cores, 495 in TF32, 67 TFLOP/s in float32 outside the tensor cores.  A copy
of the arithmetic of `chip_smoke.py::bound`.
"""

from __future__ import annotations

BYTES_S = 3.35e12
BF16_TENSOR = 989e12
TF32_TENSOR = 495e12
FP32 = 67e12

# the whole step's peak for each configuration's precision: bf16 products on
# the tensor cores; f32 with TF32 off runs its library products in FP32
STEP_PEAK = {"bf16": BF16_TENSOR, "f32": FP32}


def bound_s(bytes_: float, tensor_flop: float = 0.0, fp32_flop: float = 0.0,
            tensor_peak: float = BF16_TENSOR) -> float:
    """Least seconds the card could take for a kernel's work: the bytes
    moved (each input read once, each output written once) over the memory
    rate, or the operations over their peaks (tensor-core products and FP32
    arithmetic run side by side, so the slower of the two), the larger."""
    return max(bytes_ / BYTES_S, tensor_flop / tensor_peak, fp32_flop / FP32)
