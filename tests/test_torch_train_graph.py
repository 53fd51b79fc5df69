"""The split train step of ``superdiff_torch/training/steps.py`` on the CPU,
where it runs its body eagerly: the draws taken ahead into static buffers
and the per-step numbers read from a tensor give the eager step's bits.

The eager step, which passes the per-step numbers as Python floats, runs
with injected draws (drawn here, in the order the module documents, from
a generator of the state's seed) and with a mesh of one process
(``make_mesh`` without a process group), where it draws as it goes. The
card's capture and replays are checked in ``tests/test_torch_cuda.py``."""

import pytest
import torch

from superdiff_torch.diffusion import make_schedule
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.parallel.mesh import make_mesh
from superdiff_torch.training import steps
from superdiff_torch.training.state import (
    create_train_state, ema_scalars, ema_update, make_optimizer)
from superdiff_torch.training.steps import make_train_step

torch.set_num_threads(1)

TOY = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attn_resolutions=(8,), num_heads=2, num_classes=2,
           time_emb_dim=16, groups=4)
R, B = 16, 4
OPTS = {"constant": dict(learning_rate=1e-3),
        "warmup_clip": dict(learning_rate=1e-3, warmup_steps=2,
                            grad_clip_norm=1.0),
        "cosine_adamw_clip": dict(learning_rate=1e-3, schedule="cosine",
                                  total_steps=5, warmup_steps=1,
                                  weight_decay=0.1, grad_clip_norm=0.01)}


def _state(opt="constant"):
    model = CondUNet(resolution=R, device="cpu", **TOY).init_parameters(3)
    return create_train_state(model, torch.Generator().manual_seed(5),
                              tx=make_optimizer(**OPTS[opt]), ema_decay=0.9)


def _batches(n=3, uint8=False):
    g = torch.Generator().manual_seed(1)
    out = []
    for _ in range(n):
        img = (torch.randint(0, 256, (B, R, R, 1), generator=g,
                             dtype=torch.uint8) if uint8
               else torch.rand((B, R, R, 1), generator=g) * 2 - 1)
        out.append({"image": img,
                    "label": torch.randint(0, 2, (B,), generator=g)})
    return out


def _run(mesh, opt, batches, inject=False, **kw):
    """Steps on ``batches``; ``inject``: with draws taken here from a
    generator of the state's seed, per microbatch the label-drop mask
    (when it drops), then ``t``, then the noise."""
    state = _state(opt)
    step = make_train_step(make_schedule(50, device="cpu"), mesh=mesh,
                           conditional=True, null_label=2, **kw)
    g = torch.Generator().manual_seed(5)
    accum, p = kw.get("grad_accum", 1), kw.get("cfg_drop_prob", 0.0)
    mb = B // accum
    losses = []
    for b in batches:
        draws = None
        if inject:
            draws = []
            for _ in range(accum):
                d = {"drop": torch.rand((mb,), generator=g) < p} if p else {}
                d["t"] = torch.randint(0, 50, (mb,), generator=g)
                d["noise"] = torch.randn((mb, R, R, 1), generator=g)
                draws.append(d)
        state, m = step(state, b, draws)
        losses.append(m["loss"])
    if inject:
        state.generator.set_state(g.get_state())
    return state, losses


def _assert_same_state(a, b):
    for x, y in zip(a.params + a.ema_params + a.opt_state["mu"]
                    + a.opt_state["nu"],
                    b.params + b.ema_params + b.opt_state["mu"]
                    + b.opt_state["nu"]):
        assert torch.equal(x, y)
    assert (a.step, a.opt_state["count"]) == (b.step, b.opt_state["count"])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_split_step_equals_the_eager_step(opt, drop, grad_accum):
    """Three steps of the toy CondUNet against the eager step fed the draws
    in the documented order: loss, every parameter, the moments, the EMA,
    the count and the generator's state, bit for bit."""
    batches = _batches()
    kw = dict(cfg_drop_prob=drop, grad_accum=grad_accum)
    split, l_split = _run(None, opt, batches, **kw)
    eager, l_eager = _run(None, opt, batches, inject=True, **kw)
    assert [v.item() for v in l_split] == [v.item() for v in l_eager]
    _assert_same_state(split, eager)
    assert split.step == split.opt_state["count"] == 3


@pytest.mark.parametrize("augmentation", ["low", "medium"])
def test_split_step_draws_a_uint8_batch_augmentation_ahead(augmentation):
    """uint8 batches augmented inside the step: the augmentation's draws,
    taken ahead of the batch, give the bits of the eager step that draws
    as it goes (a mesh of one process)."""
    batches = _batches(uint8=True)
    kw = dict(cfg_drop_prob=0.3, augmentation=augmentation)
    split, l_split = _run(None, "warmup_clip", batches, **kw)
    eager, l_eager = _run(make_mesh(device="cpu"), "warmup_clip", batches,
                          **kw)
    assert [v.item() for v in l_split] == [v.item() for v in l_eager]
    _assert_same_state(split, eager)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_tensor_scalar_adam_and_ema_equal_the_float_path(opt):
    """``Optimizer.update`` and ``ema_update`` with their per-step numbers
    in a float32 tensor against the Python floats, over counts where the
    warmup, the cosine and the clip act, on leaves whose sizes leave
    vector tails: the same bits; only the float form advances the count."""
    g = torch.Generator().manual_seed(0)
    shapes = [(1,), (17,), (33, 5), (1000,), (4099,)]
    params = [torch.randn(s, generator=g) for s in shapes]
    tx = make_optimizer(**OPTS[opt])
    a = ([p.clone() for p in params], tx.init(params))
    b = ([p.clone() for p in params], tx.init(params))
    ema_a = [p.clone() for p in params]
    ema_b = [p.clone() for p in params]
    for count in range(5):
        grads = [torch.randn(s, generator=g) * 10 ** (count - 2)
                 for s in shapes]
        numbers = torch.tensor(tx.step_scalars(count), dtype=torch.float32)
        na = tx.update(a[0], [x.clone() for x in grads], a[1])
        nb = tx.update(b[0], [x.clone() for x in grads], b[1],
                       scalars=numbers)
        b[1]["count"] += 1
        assert torch.equal(na, nb) and a[1]["count"] == b[1]["count"]
        ema_update(ema_a, a[0], 0.995, count)
        ema_update(ema_b, b[0], 0.995, count, scalars=torch.tensor(
            ema_scalars(0.995, count), dtype=torch.float32))
        for x, y in zip(a[0] + a[1]["mu"] + a[1]["nu"] + ema_a,
                        b[0] + b[1]["mu"] + b[1]["nu"] + ema_b):
            assert torch.equal(x, y)


def test_metrics_of_consecutive_steps_do_not_alias():
    """A split step's metrics are its own tensors: the next steps leave
    them as they were."""
    state = _state()
    step = make_train_step(make_schedule(50, device="cpu"), conditional=True,
                           null_label=2)
    batches = _batches()
    state, first = step(state, batches[0])
    kept = {k: v.clone() for k, v in first.items()}
    for b in batches[1:]:
        state, m = step(state, b)
        for k in first:
            assert m[k].data_ptr() != first[k].data_ptr()
    assert all(torch.equal(first[k], kept[k]) for k in first)
    assert m["loss"].item() != kept["loss"].item()


def test_counters_count_eager_steps_for_a_mesh_and_injected_draws():
    """Without a card nothing is captured or replayed: every step counts
    as eager, those of a mesh and with injected draws among them; the
    split step keeps one set of static buffers for its key."""
    schedule = make_schedule(50, device="cpu")
    batches = _batches(n=2)
    steps.reset_counts()
    state = _state()
    step = make_train_step(schedule, mesh=make_mesh(device="cpu"),
                           conditional=True, null_label=2)
    for b in batches:
        state, _ = step(state, b)
    assert (steps.captures, steps.replays, steps.eager_steps) == (0, 0, 2)
    assert step.split.key is None
    step = make_train_step(schedule, conditional=True, null_label=2)
    draws = {"t": torch.tensor([1, 7, 20, 49]),
             "noise": torch.randn((B, R, R, 1))}
    state, _ = step(state, batches[0], draws)
    assert steps.eager_steps == 3 and step.split.key is None
    for b in batches:
        state, _ = step(state, b)
    key = step.split.key
    state, _ = step(state, batches[0])
    assert step.split.key == key and step.split.graph is None
    assert (steps.captures, steps.replays, steps.eager_steps) == (0, 0, 6)
    steps.reset_counts()
    assert (steps.captures, steps.replays, steps.eager_steps) == (0, 0, 0)
