"""Share of the traced window in which no operation ran on the card, in
percent: 1 - busy / wall over a steady serve window (the union of the
device activities' intervals in the profiler's trace)."""


def read(cell, out):
    w = out.get("window")
    if w is None or not w.device or cell.traffic["driver"] != "serve":
        return None
    return 100.0 * w.idle_share
