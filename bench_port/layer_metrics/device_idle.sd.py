"""Share of the traced window in which no operation ran on the card, in
percent, for the sampling cells of a text-conditioned model (traffic of
the ``sample_ctx`` driver): 1 - busy / wall over a steady window of graph
replays (the union of the device activities' intervals in the profiler's
trace), as ``device_idle.sample`` reads it for the ``sample`` driver."""


def read(cell, out):
    w = out.get("window")
    if w is None or not w.device or cell.traffic["driver"] != "sample_ctx":
        return None
    return 100.0 * w.idle_share
