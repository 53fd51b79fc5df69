"""Toy cells for the CPU tests: the benchmark copied into a temporary
checkout with small configurations, traffic and limits added as files and
``BENCHMARK.json`` entries, as a later change would add them."""

from __future__ import annotations

import json
import shutil
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY_COND = {
    "name": "toy_cond", "source": "a toy of the wide256 preset",
    "arch": "condunet", "preset": "small64", "resolution": 32,
    "in_channels": 1, "out_channels": 1, "base_channels": 32,
    "channel_mults": [1, 2], "num_res_blocks": [1, 1],
    "attn_resolutions": [8], "up_attn_resolutions": [8], "num_heads": 4,
    "pixel_shuffle": 2, "groups": 32, "time_emb_dim": 32, "num_classes": 2,
    "compute_dtype": "bfloat16", "sampling_norm_dtype": "bfloat16",
    "sampling_weights": {"dtype": "bfloat16", "keep_float32": [
        "norm", "time_mlp", "class_emb", "emb_proj", "out_conv"]},
    "num_timesteps": 20, "beta_start": 0.0001, "beta_end": 0.02,
    "peak": "bfloat16", "control": "fp8"}
TOY_REF = {
    "name": "toy_ref", "source": "a toy of the reference's RefUNet",
    "arch": "refunet", "preset": "ref", "resolution": 16, "in_channels": 1,
    "out_channels": 1, "base_channels": 8, "time_emb_dim": 32,
    "num_classes": 0, "compute_dtype": "float32",
    "sampling_norm_dtype": "float32",
    "sampling_weights": TOY_COND["sampling_weights"],
    "num_timesteps": 20, "beta_start": 0.0001, "beta_end": 0.02,
    "peak": "float32", "control": "tf32"}

TRAFFIC = {
    "toy-ddpm": {"driver": "sample", "sampler": "ddpm", "models": 1,
                 "batch": 4, "labels": "uniform", "trace_steps": 2,
                 "check": {"rows": 4, "first_steps": 5, "last_steps": 5,
                           "segments": ["first", "last"]}},
    "toy-superdiff": {"driver": "sample", "sampler": "superdiff",
                      "mode": "or", "models": 2, "batch": 4, "labels": None,
                      "trace_steps": 2,
                      "check": {"rows": 4, "first_steps": 5,
                                "last_steps": 5, "segments": ["first"],
                                "tie_nats": 0.1}},
    "toy-train": {"driver": "train", "batch": 4, "pool": 4,
                  "learning_rate": 0.0002, "grad_clip_norm": 1.0,
                  "ema_decay": 0.995, "cfg_drop_prob": 0.1,
                  "checked_steps": 3, "trace_steps": 1},
    "toy-serve": {"driver": "serve", "method": "ddim", "steps": 5,
                  "batch": 4, "max_wait_ms": 20, "rate_per_s": 4.0,
                  "arrival_seed": 0,
                  "sizes": [[1, 0.5], [2, 0.3], [4, 0.2]],
                  "labels": [0, 1, None], "trace_seconds": 0.5,
                  "check": {"requests": 4}},
}
# toy limits: a decade above the toy's own readings on the CPU (bf16
# policy against the float32 reference: 1e-4 - 2e-3; float32 against
# float32: 1e-7)
CELLS = {
    "toy-cond-ddpm": ("toy_cond", "toy-ddpm",
                      {"x_rel_err.first": 1e-2, "x_rel_err.last": 1e-2}),
    "toy-ref-superdiff": ("toy_ref", "toy-superdiff",
                          {"x_rel_err.first": 1e-5,
                           "x_rel_err_tied.first": None,
                           "dlogq_gap.first": 1e-4,
                           "near_tie_rows.first": None}),
    "toy-cond-train": ("toy_cond", "toy-train",
                       {"loss_rel_gap": None, "grad1_leaf_gap": 5e-2,
                        "dparam_leaf_gap": 0.1, "ema_leaf_gap": 0.1}),
    "toy-cond-serve": ("toy_cond", "toy-serve",
                       {"requests_missing": 0, "rows_unmatched": 0,
                        "labels_mismatched": 0, "x_rel_err": 2e-2}),
}


def make_checkout(tmp: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench_port/`` under ``tmp`` with
    the toy configurations, traffic and cells added; the program is the
    repository's own."""
    shutil.copytree(ROOT / "bench_port", tmp / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in (TOY_COND, TOY_REF):
        path = f"bench_port/configs/{cfg['name']}.json"
        (tmp / path).write_text(json.dumps(cfg))
        man["configs"].append({"name": cfg["name"], "source": cfg["source"],
                               "file": path, "reduced": [], "why": "toy"})
    for name, tr in TRAFFIC.items():
        (tmp / "bench_port/traffic" / f"{name}.json").write_text(
            json.dumps(tr))
    for cell, (cfg, tr, limits) in CELLS.items():
        (tmp / "bench_port/limits" / f"{cell}.json").write_text(
            json.dumps(limits))
        man["workloads"].append({"name": cell, "config": cfg,
                                 "traffic": tr, "chips": 1, "why": "toy"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


def run_cell(checkout: Path, cell: str, seed: int = 2**33 + 7,
             seconds: float = 1.5, trace: int = 0, **extra):
    """``(out, correct, lines)`` of one run of ``cell`` on the CPU (the
    harness's look for a card skipped)."""
    import torch

    from bench_port.common.harness import load_cell
    from bench_port.reference.compare import judge

    c = load_cell(cell, root=checkout)
    opt = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace,
                                device=torch.device("cpu"),
                                t0=time.perf_counter(), **extra)
    out = c.driver().run(c, opt)
    ok, lines = judge(out["readings"], c.limits)
    return out, ok, lines
