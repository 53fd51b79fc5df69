"""The micro-batcher's fill, in percent: ``SamplerService.stats``' samples
over batches times the batch size, taken over the served window (the
counters' change from the window's start to its end)."""


def read(cell, out):
    s = out.get("service_stats")
    if not s or not s.get("batches"):
        return None
    return 100.0 * s["samples"] / (s["batches"] * cell.traffic["batch"])
