"""One run of one cell of the port's benchmark.

    python3 bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs the cell named in ``BENCHMARK.json`` on the card it is started on:
set-up (weights from the seed on the card, the cell's shapes warmed and
captured), a window of ``--seconds`` of the cell's work, then the check of
what the window produced against the plain reference in
``bench_port/reference/``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``; its per-layer metrics, read from a
device trace of short steady windows, with ``--trace 1``), ``device`` and,
with ``--trace 1``, ``breakdown``; its last key, ``checks``, holds each
compared number beside its limit, which are also the last lines on
standard error. Exits non-zero, printing no result, without a CUDA card,
or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def execute(cell, opt):
    """Run ``cell`` on ``device``: ``(result, check lines)``; the result
    is the JSON object of the run, without ``device``'s card fields."""
    from bench_port.reference.compare import judge
    from bench_port.common.harness import checks_line, clean

    out = cell.driver().run(cell, opt)
    ok, lines = judge(out["readings"], cell.limits)
    if opt.trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(cell, out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": clean(out["e2e"][m["name"]] if
                                              m["name"] != "setup_s"
                                              else out["setup_s"]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(ok), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    w = out.get("window")
    if opt.trace and w is not None:
        result["device"].update(busy_s=w.busy_s, window_s=w.wall_s)
        result["breakdown"] = {"device_ops": w.top_ops(),
                               "idle_gaps": w.idle_gaps()}
    result["checks"] = checks_line(lines)
    result.update(setup_s=out["setup_s"], window_s=out.get("window_s", 0.0),
                  reference_s=out.get("reference_s", 0.0))
    return result, lines


def main(argv=None) -> int:
    opt = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from bench_port.common.harness import forbidden_modules, load_cell

    cell = load_cell(opt.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    opt.device, opt.t0 = device, T0
    result, lines = execute(cell, opt)
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        "count": 1, "power_limit": power_limit(),
                        **result["device"]}
    result["checks"] = result.pop("checks")
    print(f"bench_port: setup {result.pop('setup_s'):.3f} s, window "
          f"{result.pop('window_s'):.3f} s, reference "
          f"{result.pop('reference_s'):.3f} s", file=sys.stderr)
    for c in lines:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
