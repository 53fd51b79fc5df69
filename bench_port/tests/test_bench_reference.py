"""The plain reference against the port on the CPU, in float32, at toy
sizes: the denoisers, one DDPM step, one SuperDiff OR step, one train step
(loss, the gradient as Adam took it, parameters and EMA after it)."""

import copy

import pytest
import torch

from toy_cells import TOY_COND, TOY_REF

from bench_port.common import program, weights
from bench_port.reference import compare, condunet, diffusion, refunet
from bench_port.reference import train as ref_train


def _f32(cfg):
    return dict(cfg, compute_dtype="float32")


def _program_model(cfg, ref, seed=3):
    P = weights.make(ref.param_specs(cfg), seed, torch.device("cpu"))
    return program.build_model(cfg, P, torch.device("cpu"),
                               sampling=False).eval(), P


@pytest.mark.parametrize("cfg,ref", [(_f32(TOY_COND), condunet),
                                     (TOY_REF, refunet)],
                         ids=["condunet", "refunet"])
def test_denoiser_matches_program(cfg, ref):
    model, P = _program_model(cfg, ref)
    g = torch.Generator().manual_seed(1)
    R = cfg["resolution"]
    x = torch.randn((3, R, R, 1), generator=g)
    t = torch.tensor([0, 7, 19])
    y = torch.tensor([0, 1, 2]) if cfg["num_classes"] else None
    with torch.no_grad():
        want = model(x, t, *([y] if y is not None else []))
        got = ref.forward(P, cfg, x, t, y)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_ddpm_and_superdiff_steps_match_program():
    from superdiff_torch.diffusion.samplers import ddpm_step
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan

    cfg = TOY_REF
    sched = program.schedule(cfg, torch.device("cpu"))
    s = diffusion.Schedule(cfg, torch.device("cpu"))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 16, 16, 1), generator=g)
    eps = torch.randn(x.shape, generator=g)
    z = torch.randn(x.shape, generator=g)
    for t in (19, 5, 0):
        want = ddpm_step(sched, x, torch.full((2,), t), eps, z)
        torch.testing.assert_close(diffusion.ddpm_update(s, x, t, eps, z),
                                   want, rtol=1e-6, atol=1e-6)
    eps2 = [torch.randn(x.shape, generator=g) for _ in range(2)]
    plan = SuperDiffPlan(sched, [lambda x_, t_, e=e: e for e in eps2],
                         x.shape, mode="or")
    plan.start(x)
    plan.z.copy_(z)
    logq0 = plan.logq.clone()
    torch.testing.assert_close(diffusion.logq_start(x)[None].expand(2, -1),
                               logq0, rtol=1e-6, atol=1e-3)
    plan.step()                                    # t = T - 1
    x1, lq1 = diffusion.superdiff_or_update(s, x, logq0, 19, eps2, z)
    torch.testing.assert_close(x1, plan.x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lq1 - logq0, plan.logq - logq0, rtol=1e-4,
                               atol=1e-2)


def test_train_step_matches_program():
    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)
    from superdiff_torch.training.steps import make_train_step

    cfg = _f32(TOY_COND)
    tr = {"learning_rate": 2e-4, "grad_clip_norm": 1.0, "ema_decay": 0.995,
          "cfg_drop_prob": 0.5}
    model, P = _program_model(cfg, condunet)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 32, 32, 1), generator=g)
    y = torch.tensor([0, 1, 0, 1])
    state = create_train_state(model, torch.Generator().manual_seed(9),
                               tx=make_optimizer(2e-4, grad_clip_norm=1.0))
    step = make_train_step(program.schedule(cfg, torch.device("cpu")),
                           conditional=True, cfg_drop_prob=0.5,
                           null_label=2)
    state, m = step(state, {"image": x, "label": y})
    fwd = lambda Q, x_, t_, y_: condunet.forward(Q, cfg, x_, t_, y_)
    out = ref_train.run_steps(fwd, copy.deepcopy(P),
                              diffusion.Schedule(cfg, torch.device("cpu")),
                              [(x, y)], torch.Generator().manual_seed(9), tr,
                              null_label=2)
    assert abs(float(m["loss"]) - out["losses"][0]) <= 1e-5 * abs(
        out["losses"][0])
    # Adam's first step is lr * g / (|g| + eps): an element whose gradient
    # is round-off (a conv bias under a one-channel GroupNorm group) moves
    # by round-off, so the state is compared where the gradient is not
    moved = compare.moved(out["grad1"])
    for n, mu, p, e in zip(names, state.opt_state["mu"], state.params,
                           state.ema_params):
        torch.testing.assert_close(mu / 0.1, out["grad1"][n], rtol=1e-3,
                                   atol=1e-7)
        m = moved.get(n, torch.zeros_like(p, dtype=torch.bool))
        torch.testing.assert_close(p.detach()[m], out["params"][n][m],
                                   rtol=0, atol=1e-3 * tr["learning_rate"])
        torch.testing.assert_close(e[m], out["ema"][n][m], rtol=0,
                                   atol=1e-3 * tr["learning_rate"])
