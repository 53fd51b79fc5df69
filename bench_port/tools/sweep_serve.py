"""The serving knee on the card: one window of a serving cell at each
offered rate, in one process, with the completed samples per second, the
95th percentile latency and the median latency of the requests due in the
window's first and last thirds (a backlog that grows over the window
shows as the last third's median well above the first's).

    python3 bench_port/tools/sweep_serve.py --workload NAME \\
        --rates 6,8,10,12 --seconds 20 --seed 5

One JSON line per rate.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)

    import torch

    from bench_port.common.harness import load_cell

    if not torch.cuda.is_available():
        print("sweep_serve: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    dev = torch.device("cuda", 0)
    for rate in (float(r) for r in a.rates.split(",")):
        cell.traffic["rate_per_s"] = rate
        opt = argparse.Namespace(seed=a.seed, seconds=a.seconds, trace=0,
                                 device=dev, t0=time.perf_counter())
        out = cell.driver().run(cell, opt)
        rows = sorted(out["latency_by_due"])
        third = len(rows) // 3
        med = lambda rs: statistics.median(l for _, l in rs)
        st = out["service_stats"]
        print(json.dumps({
            "rate_per_s": rate, "requests": out["attempted"],
            "failed": out["failed"],
            "samples_per_s": st["samples"] / a.seconds,
            "batch_fill": st["samples"] / max(1, st["batches"])
            / cell.traffic["batch"],
            "request_p95_s": out["e2e"]["request_p95_s"],
            "median_s_first_third": med(rows[:third]),
            "median_s_last_third": med(rows[-third:]),
            "readings": out["readings"]}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
