"""The controls on the card, at each cell's own size, on three seeds: the
plain reference one precision below the configuration's (fp8 for a
bfloat16 configuration, TF32 for an IEEE float32 one) put in the program's
place fails one of the cell's limits, and the program in the same run
passes them all. Run on the card:

    python -m pytest -q -s -m cuda bench_port/tests/test_bench_control.py
"""

import json
import time
import types

import pytest

from toy_cells import ROOT

from bench_port.common.harness import load_cell
from bench_port.reference.compare import judge

# the shortest window that finishes what each cell compares
SECONDS = {"wide256-ddpm1000-b16": 10.0, "ref-superdiff-or-b16": 6.0,
           "wide256-train-b16": 2.0, "wide256-serve-ddim50": 10.0}
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the cells run at full size)")
    cell = load_cell(workload)
    mode = cell.config["control"]
    for seed in (2**33 + 101, 2**33 + 102, 2**33 + 103):
        opt = types.SimpleNamespace(
            seed=seed, seconds=SECONDS.get(workload, 10.0), trace=0,
            device=torch.device("cuda", 0), t0=time.perf_counter(),
            controls=[mode])
        out = cell.driver().run(cell, opt)
        ok, lines = judge(out["readings"], cell.limits)
        readings = out["controls"][mode]
        # the exact counts are the program's alone; the control is judged
        # on the numbers it has
        limits = {k: v for k, v in cell.limits.items() if k in readings}
        ctl_ok, ctl_lines = judge(readings, limits)
        print(json.dumps({"workload": workload, "seed": seed,
                          "program": out["readings"],
                          "control": {mode: readings}}))
        assert ok, lines
        assert not ctl_ok, ctl_lines
