"""The EPN conv schedule, frozen for the benchmark.

A copy of the arithmetic of the port's `utils/config.py::backbone_plan`
(reference `src/models/so3net.py:36-133`), on a configuration given as the
plain dict of a `perfbench/configs/<name>.json` file.  The reference
network and the FLOP model both read it, so neither follows a later change
of the program's schedule.
"""

from __future__ import annotations

EPN_DEFAULTS = {
    "kanchor": 60, "input_num": 1024, "initial_radius_ratio": 0.2, "sampling_ratio": 0.8,
    "sampling_density": 0.5, "sigma_ratio": 0.5, "kernel_size": 1,
}


def epn_options(cfg: dict) -> dict:
    return {**EPN_DEFAULTS, **cfg.get("epn", {})}


def backbone_plan(cfg: dict):
    """Per-conv static plan of the EPN backbone: a list of blocks, each a
    list of conv dicts (dim_in, dim_out, kernel_size, stride, radius, sigma,
    n_neighbor, lazy_sample, n_in, n_out, occupancy_input)."""
    epn = epn_options(cfg)
    n_layers = cfg["epn_layer_num"]
    if cfg.get("epn_mlps") is not None:
        mlps = [list(b) for b in cfg["epn_mlps"]][:n_layers]
    else:
        mlps = [[32, 32], [64, 64], [128, 128], [256, 256]][:n_layers]
    strides = [2, 2, 2, 2][:n_layers]
    input_num = epn["input_num"]
    sampling_ratio = epn["sampling_ratio"]
    if input_num > 1024:
        sampling_ratio /= input_num / 1024
        strides[0] = int(2 * (input_num / 1024))

    stride_multipliers = [1]
    for _ in range(len(mlps)):
        stride_multipliers.append(stride_multipliers[-1] * 2)
    num_centers = [int(input_num / m) for m in stride_multipliers]
    radius_ratio = [epn["initial_radius_ratio"] * m ** epn["sampling_density"]
                    for m in stride_multipliers]
    radii = [r * cfg["epn_input_radius"] for r in radius_ratio]
    weighted_sigma = [epn["sigma_ratio"] * radii[0] ** 2]
    for idx, s in enumerate(strides):
        weighted_sigma.append(weighted_sigma[idx] * s)

    blocks = []
    dim_in = 1
    n_in = cfg["num_point"]
    for i, block in enumerate(mlps):
        block_param = []
        for j, dim_out in enumerate(block):
            neighbor = int(sampling_ratio * num_centers[i]
                           * radius_ratio[i] ** (1 / epn["sampling_density"]))
            if i == 0 and j == 0:
                neighbor *= max(1, int(input_num / 1024))
            neighbor *= 2
            if j == 0:
                inter_stride = strides[i]
                nidx = i if i == 0 else i + 1
            else:
                inter_stride = 1
                nidx = i + 1
            n_out = -(-n_in // inter_stride)
            block_param.append(dict(
                dim_in=dim_in, dim_out=dim_out, kernel_size=epn["kernel_size"],
                stride=inter_stride, radius=radii[nidx], sigma=weighted_sigma[nidx],
                n_neighbor=neighbor, lazy_sample=(i != 0 or j != 0), n_in=n_in, n_out=n_out,
                occupancy_input=(i == 0 and j == 0)))
            dim_in = dim_out
            n_in = n_out
        blocks.append(block_param)
    return blocks
