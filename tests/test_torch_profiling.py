"""``superdiff_torch/utils/profiling.py`` on the CPU: the timer, the trace
file, the non-finite checks and the determinism switch (the counterparts
of ``superdiff_tpu/utils/profiling.py``'s ``timed``, ``trace``,
``enable_debug_checks`` and ``set_deterministic``)."""

import json
import os

import pytest
import torch

from superdiff_torch.utils import profiling


def test_timed_returns_seconds_per_call_and_the_last_result():
    calls = []

    def fn(a, scale=1.0):
        calls.append(a)
        return torch.full((2,), float(len(calls))) * scale

    sec, out = profiling.timed(fn, 3, warmup=2, iters=4, scale=2.0)
    assert sec > 0 and len(calls) == 6
    assert torch.equal(out, torch.full((2,), 12.0))


def test_trace_writes_a_chrome_trace_of_the_ops(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        (a @ a).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("nans,infs,bad,msg", [
    (True, False, float("nan"), "NaN"),
    (False, True, float("inf"), "Inf"),
])
def test_debug_checks_raise_at_the_first_non_finite_output(nans, infs, bad,
                                                           msg):
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(bad)
    handle = profiling.enable_debug_checks(nans=nans, infs=infs)
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match=f"{msg} in the output "
                                                     "of Linear"):
            lin(torch.ones(1, 2))
        torch.nn.Linear(2, 2)(torch.ones(1, 2))       # finite: no error
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(False)
    lin(torch.ones(1, 2))                              # hook removed


def test_set_deterministic_switches_the_flags(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        profiling.set_deterministic(True)
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        profiling.set_deterministic(False)
        assert not torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.deterministic
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]
