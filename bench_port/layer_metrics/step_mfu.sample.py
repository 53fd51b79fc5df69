"""The sampling step's share of the card's peak, in percent: the plain
reference's FLOPs per denoiser call at the cell's batch (counted on the
meta device, convolutions and matrix products) times the calls in the
traced window, over the window's wall time and the peak of the precision
the configuration states (``peak`` in its file; the table in
``common/peaks.json``)."""

from bench_port.common.counts import peaks


def read(cell, out):
    w = out.get("window")
    if w is None or not w.device or "calls" not in w.counts:
        return None
    import torch

    pk = peaks(torch.cuda.get_device_name())[cell.config["peak"]]
    flops = out["static"]["flops_per_call"] * w.counts["calls"]
    return 100.0 * flops / w.wall_s / pk
