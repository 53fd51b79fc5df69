"""The rest of a run on the CPU (the look for a card skipped) at toy sizes,
sound and with the timed path broken underneath: ``correct`` comes out
true for the program and false for each fault a cell can have (a step that
leaves its state unchanged; half the batch left out; an answer altered
where it is produced; in serving, a request given another label in the
batcher or in the launch). A one-card cell has no exchange between chips
to leave out."""

import pytest
import torch

from toy_cells import make_checkout, run_cell


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("bench"))


def _break(monkeypatch, fault, kind):
    from superdiff_torch.diffusion.graphed import GraphedSampler

    if kind in ("sample", "serve"):
        step = GraphedSampler.step

        def broken(self):
            if fault == "unchanged":
                return
            x = self.plan.x
            keep = x[x.shape[0] // 2:].clone()
            step(self)
            if fault == "half_batch":
                x[x.shape[0] // 2:] = keep
            else:                                     # altered
                x[0].add_(1e-2)

        monkeypatch.setattr(GraphedSampler, "step", broken)
    else:
        import superdiff_torch.training.steps as steps
        from superdiff_torch.training.state import Optimizer

        if fault == "unchanged":
            monkeypatch.setattr(Optimizer, "update",
                                lambda self, p, g, s, **kw: torch.zeros(()))
            return
        if fault == "altered":
            import superdiff_torch.diffusion.process as process

            target = process.pred_target

            def first_row_negated(*a, **kw):
                out = target(*a, **kw)
                return torch.cat([-out[:1], out[1:]])

            monkeypatch.setattr(process, "pred_target", first_row_negated)
            return
        make = steps.make_train_step

        def make_broken(*a, **kw):
            fn = make(*a, **kw)

            def step(state, batch, draws=None):
                B = batch["image"].shape[0]
                return fn(state, {k: v[:B // 2] for k, v in batch.items()},
                          draws)
            return step

        monkeypatch.setattr(steps, "make_train_step", make_broken)


CASES = [("toy-cond-ddpm", "sample"), ("toy-ref-superdiff", "sample"),
         ("toy-cond-train", "train"), ("toy-cond-serve", "serve")]


@pytest.mark.parametrize("cell,kind", CASES, ids=[c for c, _ in CASES])
def test_sound_run_is_correct(checkout, cell, kind):
    out, ok, lines = run_cell(checkout, cell)
    assert ok, lines
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell,kind", CASES, ids=[c for c, _ in CASES])
def test_fault_is_caught(checkout, monkeypatch, cell, kind, fault):
    _break(monkeypatch, fault, kind)
    out, ok, lines = run_cell(checkout, cell)
    assert not ok, lines


@pytest.mark.parametrize("where", ["batcher", "launch"])
def test_serve_label_fault_is_caught(checkout, monkeypatch, where):
    import numpy as np

    from superdiff_torch.serve import SamplerService

    if where == "batcher":                  # the request stores another label
        submit = SamplerService.submit

        def relabelled(self, num, label=None, **kw):
            return submit(self, num, label=1 if label == 0 else 0, **kw)

        monkeypatch.setattr(SamplerService, "submit", relabelled)
    else:                                   # the launch rolls its labels
        launch = SamplerService._launch

        def rolled(self, spec, labels, seed, *a, **kw):
            return launch(self, spec, np.roll(labels, 1), seed, *a, **kw)

        monkeypatch.setattr(SamplerService, "_launch", rolled)
    out, ok, lines = run_cell(checkout, "toy-cond-serve")
    assert not ok, lines
    if where == "batcher":
        assert any(c["name"] == "labels_mismatched" and not c["ok"]
                   for c in lines), lines


@pytest.mark.parametrize("fault", ["hard_mix", "stale_logq"])
def test_superdiff_mixing_fault_fails_the_limits(checkout, fault):
    """A fault of the mixing weights, planted in the reference put in the
    program's place, fails the rows away from ties: every row starts
    tied."""
    from bench_port.common.harness import load_cell
    from bench_port.reference.compare import judge

    out, ok, lines = run_cell(checkout, "toy-ref-superdiff", faults=[fault])
    assert ok, lines
    limits = load_cell("toy-ref-superdiff", root=checkout).limits
    assert not judge(out["faults"][fault], limits)[0]
