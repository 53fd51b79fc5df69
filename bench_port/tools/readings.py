"""The readings that a cell's correctness limits are set from, on the card:
for each seed, one run of the cell (a window of ``--seconds``) with the
program's compared numbers, and beside them the control's (the plain
reference at each ``--control`` precision, in the program's place, against
the reference) and the planted faults'. All seeds in
one process.

    python3 bench_port/tools/readings.py --workload NAME --seeds 1,2,3 \\
        --seconds 12 [--control fp8] [--fault half_batch,altered]

Faults by driver: train ``half_batch``, ``altered``; sample (SuperDiff)
``hard_mix``, ``stale_logq``; serve ``label_swap``.

One JSON line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", default="")
    p.add_argument("--fault", default="")
    a = p.parse_args(argv)

    import torch

    from bench_port.common.harness import clean, forbidden_modules, load_cell

    cell = load_cell(a.workload)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        opt = argparse.Namespace(
            seed=seed, seconds=a.seconds, trace=0, device=dev,
            t0=time.perf_counter(),
            controls=[c for c in a.control.split(",") if c],
            faults=[f for f in a.fault.split(",") if f])
        out = cell.driver().run(cell, opt)
        row = {"workload": a.workload, "seed": seed,
               "setup_s": out["setup_s"],
               "e2e": out["e2e"], "readings": out["readings"],
               "controls": out.get("controls", {}),
               "faults": out.get("faults", {}),
               "memory_peak_bytes": out["memory_peak_bytes"]}
        print(json.dumps(row, default=clean), flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
    found = forbidden_modules()
    if found:
        print(f"readings: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
