"""The harness on the CPU: the manifest's rules, cells found by name with
no file edited, the JAX guard, the reference's independence from the
program, counts against hand counts, the open-loop schedule, and a run
without a card."""

import ast
import json
import re
import subprocess
import sys

import pytest

from toy_cells import CELLS, ROOT, TOY_COND, TOY_REF, make_checkout

from bench_port.common import counts
from bench_port.common.harness import forbidden_modules, load_cell
from bench_port.reference import condunet, refunet

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_names_units_and_files():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench_port"]
    assert 1 <= m["run_seconds"] <= 51
    metrics = m["end_to_end"] + m["per_layer"]
    for entry in m["configs"] + m["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in metrics:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench_port/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench_port/limits" / f"{w['name']}.json").exists()
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in m["workloads"])
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    assert len(json.dumps(m)) < 64 * 1024


def test_each_per_layer_metric_has_a_reader_and_its_cells_report_moves():
    m = _manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for pl in m["per_layer"]:
        assert (ROOT / "bench_port/layer_metrics" / f"{pl['name']}.py"
                ).exists()
        moves = e2e[pl["moves"]]
        for w in pl["workloads"]:
            assert w in cells
            assert w in moves.get("workloads", cells)
    for w in cells:                     # setup_s, one more, one per-layer
        cell = load_cell(w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_added_config_traffic_and_metric_are_found_by_name(tmp_path):
    checkout = make_checkout(tmp_path)
    (checkout / "bench_port/layer_metrics/toy.count.py").write_text(
        "def read(cell, out):\n    return 42.0\n")
    man = json.loads((checkout / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "toy.count", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "toy", "moves": "setup_s",
                             "workloads": ["toy-cond-ddpm"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(man))
    cell = load_cell("toy-cond-ddpm", root=checkout)
    assert cell.config == TOY_COND
    assert cell.traffic["sampler"] == "ddpm"
    assert cell.limits == CELLS["toy-cond-ddpm"][2]
    assert [m["name"] for m in cell.per_layer] == ["toy.count"]
    assert cell.reader("toy.count").read(cell, {}) == 42.0
    assert cell.driver().__name__.endswith("sample")
    for f in ("BENCHMARK.json",):                # the repository's own
        assert "toy" not in (ROOT / f).read_text()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "superdiff_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "flaxen.sub", object())
    assert "superdiff_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "optax.contrib", object())
    assert "optax" in forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench_port/reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("superdiff_torch", "superdiff_tpu", "jax",
                                   "flax", "optax"), (path, n)


def test_flop_counts_match_hand_counts():
    # RefUNet: ten 3x3 convs, 2*9*Cin*Cout per pixel, and five time-bias
    # denses; the time MLP
    cfg = TOY_REF
    B, R, E = 2, cfg["resolution"], cfg["time_emb_dim"]
    w = [1, 8, 16, 16, 8, 1]
    convs = sum(2 * 9 * a * b + 2 * 9 * b * b for a, b in zip(w, w[1:]))
    want = (B * R * R * convs + 2 * B * E * 4 * E * 2
            + sum(2 * B * E * b for b in w[1:]))
    assert counts.forward_flops(refunet, cfg, B) == want
    # training: the backward's two products per forward product, less the
    # input's gradient of the first layer of each kind the count skips
    fwd = counts.forward_flops(condunet, TOY_COND, 2)
    trn = counts.train_flops(condunet, TOY_COND, 2)
    assert 2.5 * fwd < trn <= 3 * fwd


def test_b4_chain_bytes_match_hand_counts():
    chains = counts.b4_chains(refunet, TOY_REF, 2)
    assert len(chains) == 10
    assert chains[0] == (2, 16, 16, 1, 1, False)
    pk = {"hbm_bytes_per_s": 1.0, "float32": 1e30}
    R = 16
    w = [1, 8, 16, 16, 8]
    widths = [c for a, b in zip(w, w[1:] + [1]) for c in (a, b)]
    want = sum(2 * 2 * R * R * c * 4 + 2 * c * 4 for c in widths)
    assert counts.b4_bound_s(chains, 4, pk) == want
    cond = counts.b4_chains(condunet, TOY_COND, 2)
    film = [c for c in cond if c[5]]
    assert len(cond) == 2 * (len(film)) + 1   # norm_0, norm_1 per block; head


def test_open_loop_schedule_is_fixed_by_the_seed():
    from bench_port.drivers.serve import schedule

    tr = {"rate_per_s": 10.0, "arrival_seed": 0,
          "sizes": [[1, 0.4], [2, 0.3], [4, 0.2], [8, 0.1]],
          "labels": [0, 1, None]}
    a, b = schedule(tr, 2**40 + 3, 30), schedule(tr, 2**40 + 3, 30)
    c = schedule(tr, 2**40 + 4, 30)
    assert a == b and a != c
    assert len(a[0]) == 300 and all(0 <= t < 30 for t in a[0])
    assert a[0] == sorted(a[0]) and a[0] == c[0]        # the same arrivals
    assert schedule(dict(tr, arrival_seed=1), 2**40 + 3, 30)[0] != a[0]
    assert a[1] != c[1]                                  # in another order
    assert sorted(a[1]) == sorted(c[1]) and sorted(a[2], key=str) == sorted(
        c[2], key=str)
    assert a[1].count(8) == 30 and a[1].count(1) == 120


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    res = subprocess.run([sys.executable, str(ROOT / "bench_port/run.py"),
                          "--workload", "wide256-ddpm1000-b16", "--seed",
                          str(2**33), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


@pytest.mark.cuda
def test_run_with_only_the_benchmark_files_fails(tmp_path):
    import shutil

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: without one every run exits "
                    "before it reaches the program")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "wide256-ddpm1000-b16", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
