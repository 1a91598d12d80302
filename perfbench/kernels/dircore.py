"""The fused direction core (`csrc/dircore.cu`, `dircore_wide.cu`,
`dircore_big.cu`): per point two attention layers over its A anchor tokens,
the BatchMLP and Dense(1).  The bf16 tokens read and the (M, A) weights
written; every product on the bf16 tensor cores."""

from perfbench.peaks import bound_s

DEVICE_NAMES = (r"\b(dircore_kernel|dircore_wide_kernel)\b"
                r"|\(anonymous namespace\)::(gemm_kernel|pad_rows_kernel|reduce_kernel)\b")


def core(M, A, E, V):
    flop = 2.0 * M * A * (2 * 3 * E * E + E * E + E * V + 2 * V * V + V) + 8.0 * M * A * A * E
    return bound_s(M * A * E * 2 + M * A * 4, flop)


def bound(key):
    entry = key[0]
    if entry == "etch_dircore":          # E = 64, V = 128 compiled in
        return core(key[1], key[2], 64, 128)
    if entry == "etch_dircore_wide":
        _, M, A, Ep, Vp = key[:5]
        return core(M, A, Ep, Vp)
    _, M, A, E, _Ep, _Eh, _Ehp, Vp = key[:8]    # etch_dircore_big
    return core(M, A, E, Vp)
