"""The spans of ``superdiff_torch/utils/profiling.py`` on the CPU: off, and
out of any other profiler's events, outside a ``profiling.trace``; inside
one, ranges of its Chrome trace around the ops they enclose, a train
step's phases (``training/steps.py``) in order; a trace that raises or
whose synchronisation fails still stops its profiler, and the training
loop keeps a step's own error. Also the service's clock and device counter
(``serve.py``) on the CPU."""

import json
import signal
import types

import pytest
import torch

from superdiff_torch import serve
from superdiff_torch.diffusion.schedules import make_schedule
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.training.state import create_train_state, make_optimizer
from superdiff_torch.training.steps import make_train_step
from superdiff_torch.utils import profiling

RES, B, T = 8, 4, 10
KW = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
          attn_resolutions=(), num_classes=2, time_emb_dim=16, groups=4)
FAST = serve.SampleSpec(method="ddim", steps=2)
PHASES = ("train.step", "train.forward", "train.backward", "train.optimizer",
          "train.ema")


@pytest.fixture(scope="module")
def model():
    return CondUNet(resolution=RES, device="cpu", **KW).init_parameters(0)


def _train(model, grad_accum=1):
    m = CondUNet(resolution=RES, device="cpu", **KW)
    m.load_state_dict(model.state_dict())
    state = create_train_state(m, torch.Generator().manual_seed(0),
                               tx=make_optimizer(grad_clip_norm=1.0))
    step_fn = make_train_step(make_schedule(T, device="cpu"),
                              conditional=True, cfg_drop_prob=0.1,
                              null_label=m.null_label, grad_accum=grad_accum)
    batch = {"image": torch.rand(B, RES, RES, 1) * 2 - 1,
             "label": torch.tensor([0, 1, 0, 1])}
    return state, step_fn, batch


def _ranges(path):
    """The complete events of a Chrome trace, in the order they start."""
    events = json.loads((path / "trace.json").read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and "dur" in e),
                  key=lambda e: e["ts"])


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_spans_are_off_and_unseen_outside_a_trace(model):
    """Outside ``profiling.trace`` a span is the one shared no-op, and a
    train step under another profiler adds no range to its events."""
    from torch.profiler import ProfilerActivity, profile

    assert profiling.span("a") is profiling.span("b")
    state, step_fn, batch = _train(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, batch)
    names = {e.name for e in prof.events()}
    assert "aten::convolution" in names
    assert not names & set(PHASES)


def test_the_chrome_trace_holds_nested_spans_around_their_ops(tmp_path):
    a = torch.randn(16, 16)
    with profiling.trace(str(tmp_path)):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                (a @ a).sum()
    rows = {e["name"]: e for e in _ranges(tmp_path)}
    assert _inside(rows["aten::mm"], rows["train.forward"])
    assert _inside(rows["train.forward"], rows["train.step"])
    assert profiling.span("a") is profiling.span("b")      # off again


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_traced_train_step_holds_its_phases_in_order(model, tmp_path,
                                                       grad_accum):
    state, step_fn, batch = _train(model, grad_accum)
    with profiling.trace(str(tmp_path)):
        step_fn(state, batch)
    rows = [e for e in _ranges(tmp_path) if e["name"].startswith("train.")]
    step, = [e for e in rows if e["name"] == "train.step"]
    kids = [e for e in rows if e is not step]
    assert [e["name"] for e in kids] == (
        ["train.forward", "train.backward"] * grad_accum
        + ["train.optimizer", "train.ema"])
    for a, b in zip(kids, kids[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    assert all(_inside(e, step) for e in kids)


def test_a_trace_that_raises_writes_its_file_and_turns_spans_off(tmp_path):
    from torch.autograd import profiler as autograd_profiler

    with pytest.raises(ValueError, match="inside"):
        with profiling.trace(str(tmp_path)):
            with profiling.span("train.step"):
                raise ValueError("inside")
    assert [e["name"] for e in _ranges(tmp_path)
            if e["name"] == "train.step"] == ["train.step"]
    assert profiling.span("a") is profiling.span("b")
    assert not autograd_profiler._is_profiler_enabled


def test_a_trace_whose_sync_fails_still_stops_its_profiler(tmp_path,
                                                           monkeypatch):
    from torch.autograd import profiler as autograd_profiler

    def fault():
        raise RuntimeError("device fault")

    monkeypatch.setattr(profiling, "_sync", fault)
    with pytest.raises(RuntimeError, match="device fault"):
        with profiling.trace(str(tmp_path)):
            pass
    assert not autograd_profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b")


def test_a_failing_profiled_step_keeps_its_error_and_the_teardown(
        tmp_path, monkeypatch):
    """A step that raises while ``logging.profile_steps`` traces it: the
    step's error leaves ``train``, not the trace's failing sync, and the
    signal handlers are restored."""
    from superdiff_torch import config as tcfg
    from superdiff_torch.training import loop

    made = loop.make_train_step

    def failing_second_step(*a, **kw):
        step_fn, calls = made(*a, **kw), []

        def fn(state, batch, draws=None):
            calls.append(1)
            if len(calls) == 2:              # the first traced step
                raise ValueError("step failed")
            return step_fn(state, batch, draws)
        return fn

    def fault():
        raise RuntimeError("device fault")

    monkeypatch.setattr(loop, "make_train_step", failing_second_step)
    monkeypatch.setattr(profiling, "_sync", fault)
    cfg = tcfg.Config()
    cfg.run_id = "fail"
    cfg.model.preset = "small64"
    cfg.model.base_channels = 8
    cfg.model.compute_dtype = cfg.model.norm_dtype = "float32"
    t = cfg.training
    t.resolution, t.batch_size, t.num_timesteps = 16, 4, 8
    t.num_epochs, t.steps_per_epoch, t.vis_every = 1, 3, 0
    cfg.logging.stdout = False
    cfg.logging.profile_steps = 1
    cfg.paths.local_base = cfg.paths.cluster_base = str(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(ValueError, match="step failed"):
        loop.train(cfg, use_synthetic=True, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    assert profiling.span("a") is profiling.span("b")


def test_the_service_times_its_batches_on_the_perf_counter(model,
                                                           monkeypatch):
    """The coalescing deadline reads ``time.perf_counter`` (a module
    without ``time.time`` serves), and on the CPU each batch adds the
    eager steps' host time to ``stats["device_ms_total"]``."""
    import time

    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        perf_counter=time.perf_counter))
    svc = serve.SamplerService(model.eval(), make_schedule(T, device="cpu"),
                               resolution=RES, conditional=True,
                               batch_size=B, max_wait_ms=20, autostart=False)
    try:
        totals = []
        for sizes in ((1, 2), (3,)):
            for n in sizes:
                svc.submit(n, label=n % 2, spec=FAST)
            tic = time.perf_counter()
            assert svc.step_once() == len(sizes)
            wall_ms = (time.perf_counter() - tic) * 1e3
            totals.append(svc.stats["device_ms_total"])
            grown = totals[-1] - (totals[-2] if len(totals) > 1 else 0.0)
            assert 0 < grown <= wall_ms
    finally:
        svc.close()
    assert svc.stats["batches"] == 2
