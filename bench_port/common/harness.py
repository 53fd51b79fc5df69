"""The manifest, the files the harness finds by name, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name in
``BENCHMARK.json``:

- a configuration: the ``file`` its entry names (``configs/<name>.json``),
  whose ``arch`` names its plain reference, ``reference/<arch>.py``;
- a traffic mix: ``traffic/<name>.json``, whose ``driver`` names the code
  that runs it, ``drivers/<driver>.py``;
- a cell's correctness limits: ``limits/<cell name>.json``;
- a per-layer metric: ``layer_metrics/<metric name>.py``, whose
  ``read(cell, out)`` returns the metric or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]          # bench_port/
ROOT = HERE.parent                                   # the checkout

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "superdiff_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that a run of the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str = None):
    """A module loaded from its file, by path (names may hold dots)."""
    name = name or "bench_port_" + path.stem.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def reference(self):
        return importlib.import_module(
            f"bench_port.reference.{self.config['arch']}")

    def driver(self):
        return load_module(self.root / "bench_port" / "drivers"
                           / f"{self.traffic['driver']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "bench_port" / "layer_metrics"
                           / f"{metric}.py")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r} (have "
                         f"{sorted(cells)})")
    entry = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(root / "bench_port" / "traffic"
                    / f"{entry['traffic']}.json")
    limits = _json(root / "bench_port" / "limits" / f"{workload}.json")
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m["workloads"]]
    return Cell(workload, entry, config, traffic, limits, e2e, per_layer,
                root)


def clean(v):
    """A number for JSON: NaN and infinities as strings."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def checks_line(lines) -> Dict[str, dict]:
    return {c["name"]: {"value": clean(c["value"]), "limit": c["limit"]}
            for c in lines}
