"""The training step's share of the card's bfloat16 peak, in percent: the
plain reference's FLOPs of one step's loss and backward at the cell's
batch (counted on the meta device; no recomputation) times the steps in
the traced window, over the window's wall time and the peak of the
configuration's compute dtype."""

from bench_port.common.counts import peaks


def read(cell, out):
    w = out.get("window")
    if w is None or not w.device or "train_steps" not in w.counts:
        return None
    import torch

    pk = peaks(torch.cuda.get_device_name())[cell.config["compute_dtype"]]
    flops = out["static"]["flops_per_step"] * w.counts["train_steps"]
    return 100.0 * flops / w.wall_s / pk
