"""The ``sample_ctx`` driver (sampling under a text context, the SD cell's)
on the CPU at a toy width, sound and with the timed path broken
underneath: ``correct`` comes out true for the program and false for a
step that leaves its state unchanged, half the batch left out, an answer
altered where it is produced, and contexts that never reach the captured
step (``plan.start`` ignoring them). The toy is ``sd21base`` with every
level 32 wide, two heads, an 8 x 8 latent, a 5 x 16 context and DDIM-8."""

import json

import pytest
import torch

from test_bench_faults import _break
from toy_cells import ROOT, make_checkout, run_cell

torch.set_num_threads(1)

CELL = "toy-sd-ddim8"
# the toy's own readings on the CPU (three seeds): sound 3.5-3.8e-2 and
# 8.8-9.7e-4; fp8 in the program's place 0.30-0.48 and 6.2-6.5e-3; the
# altered answer (1e-2 added to one row a step) 1.7e-3 over the last steps
LIMITS = {"x_rel_err.first": 0.1, "x_rel_err.last": 1.3e-3}
# chain 0 (8 steps, ~0.5 s alone) has to end inside the window for the last
# steps to be compared: a window of several chains keeps it there on a
# loaded CPU
SECONDS = 4.0


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    tmp = make_checkout(tmp_path_factory.mktemp("bench_ctx"))
    cfg = json.loads((ROOT / "bench_port/configs/sd21base.json").read_text())
    cfg.update(name="toy_sd", sample_size=8, block_out_channels=[32] * 4,
               attention_head_dim=[2] * 4, cross_attention_dim=16,
               context_len=5)
    tr = json.loads((ROOT / "bench_port/traffic/ddim50-cfg-b8.json")
                    .read_text())
    tr.update(steps=8, batch=2, trace_steps=2,
              check=dict(tr["check"], rows=2, first_steps=2, last_steps=2))
    (tmp / "bench_port/configs/toy_sd.json").write_text(json.dumps(cfg))
    (tmp / "bench_port/traffic/toy-sd-ddim8.json").write_text(json.dumps(tr))
    (tmp / f"bench_port/limits/{CELL}.json").write_text(json.dumps(LIMITS))
    man = json.loads((tmp / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy_sd", "source": "a toy of sd21base",
                           "file": "bench_port/configs/toy_sd.json",
                           "reduced": [], "why": "toy"})
    man["workloads"].append({"name": CELL, "config": "toy_sd",
                             "traffic": "toy-sd-ddim8", "chips": 1,
                             "why": "toy"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


def test_sound_run_is_correct(checkout):
    out, ok, lines = run_cell(checkout, CELL, seconds=SECONDS)
    assert ok, lines
    assert out["attempted"] > 2 * 2 and out["failed"] == 0
    assert all(c["value"] > 0 for c in lines), lines


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_caught(checkout, monkeypatch, fault):
    _break(monkeypatch, fault, "sample")
    out, ok, lines = run_cell(checkout, CELL, seconds=SECONDS)
    assert not ok, lines


def test_contexts_left_out_of_the_step_are_caught(checkout, monkeypatch):
    """``start`` that resets the state but keeps the buffer's old contexts
    (the null context the plan was built with): chain 0 is sampled
    unconditionally and fails the first steps' limit."""
    from superdiff_torch.diffusion.samplers import SamplerPlan

    start = SamplerPlan.start
    monkeypatch.setattr(SamplerPlan, "start",
                        lambda self, x_init, y=None: start(self, x_init))
    out, ok, lines = run_cell(checkout, CELL, seconds=SECONDS)
    assert not ok, lines
    assert not next(c for c in lines if c["name"] == "x_rel_err.first")["ok"]
