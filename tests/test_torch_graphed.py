"""The graphed sampler (``superdiff_torch.diffusion.graphed``), the sampling
CLI that runs it (PNG grids, ``--step`` / ``--best``) and ``cli.serve``'s
loading, on the CPU.

On the CPU a ``GraphedSampler`` runs its plan's step eagerly; it must give
the eager samplers' bits exactly (the same arithmetic and the same draws in
the same order). The capture itself is tested on the card
(``tests/test_torch_cuda.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from superdiff_torch import config as tcfg
from superdiff_torch.cli import sample as sample_cli
from superdiff_torch.cli import serve as serve_cli
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import samplers as ts
from superdiff_torch.diffusion import superdiff as tsd
from superdiff_torch.diffusion.graphed import GraphedSampler
from superdiff_torch.diffusion.schedules import make_schedule
from superdiff_torch.inference import load_run, make_eps_fn_p
from superdiff_torch.models.presets import model_from_config
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.training.loop import train

torch.set_num_threads(1)

T, RES = 8, 16
SHAPE = (3, RES, RES, 1)
KW = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
          attn_resolutions=(8,), num_heads=2, num_classes=2,
          time_emb_dim=16, groups=4)


@pytest.fixture(scope="module")
def nets():
    s = make_schedule(T, device="cpu")
    m1 = CondUNet(resolution=RES, device="cpu", **KW).init_parameters(1)
    m2 = CondUNet(resolution=RES, device="cpu", **KW).init_parameters(2)
    return s, m1.eval(), m2.eval()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cases(nets):
    """(name, plan, eager sampler call) with the same model fns and args."""
    s, m1, m2 = nets
    per = make_eps_fn_p(m1, "per_sample")
    f = lambda *a: per(m1, *a)
    y = torch.tensor([0, 1, 2])
    cfg = dict(y=y, guidance_scale=2.5, null_label=2)
    a1, a2 = make_eps_fn_p(m1, 0), make_eps_fn_p(m2, 1)
    fns = [lambda x, t: a1(m1, x, t), lambda x, t: a2(m2, x, t)]
    yield ("ddpm_cfg", ts.DDPMPlan(s, f, SHAPE, **cfg),
           lambda g, **k: ts.ddpm_sample(s, f, SHAPE, g, **cfg, **k))
    yield ("ddim_eta", ts.DDIMPlan(s, f, SHAPE, num_steps=3, eta=0.7, y=y),
           lambda g, **k: ts.ddim_sample(s, f, SHAPE, g, num_steps=3,
                                         eta=0.7, y=y, **k))
    yield ("ddim_trailing_unclipped",
           ts.DDIMPlan(s, f, SHAPE, num_steps=4, t_spacing="trailing",
                       clip_x0=False, **cfg),
           lambda g, **k: ts.ddim_sample(s, f, SHAPE, g, num_steps=4,
                                         t_spacing="trailing", clip_x0=False,
                                         **cfg, **k))
    yield ("dpmpp", ts.DPMppPlan(s, f, SHAPE, num_steps=5, y=y),
           lambda g, **k: ts.dpmpp_sample(s, f, SHAPE, g, num_steps=5, y=y,
                                          **k))
    for mode, extra in (("or", dict(temperature=0.7, bias=[0.5, 0.0])),
                        ("and", {}), ("fixed", dict(kappa=[0.3, 0.7]))):
        yield (f"superdiff_{mode}",
               tsd.SuperDiffPlan(s, fns, SHAPE, mode=mode, **extra),
               lambda g, mode=mode, extra=extra, **k: tsd.superdiff_sample(
                   s, fns, SHAPE, g, mode=mode, **extra, **k))


CASE_NAMES = ["ddpm_cfg", "ddim_eta", "ddim_trailing_unclipped", "dpmpp",
              "superdiff_or", "superdiff_and", "superdiff_fixed"]


def _case(nets, name):
    return next(c for c in _cases(nets) if c[0] == name)[1:]


def _equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.shape == v.shape and torch.equal(u, v)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_graphed_step_run_eagerly_equals_the_eager_sampler(nets, name):
    """Same generator seed: the same bits; a second run of the same object
    (state buffers reset by ``start``) gives them again."""
    plan, eager = _case(nets, name)
    sampler = GraphedSampler(plan)
    assert sampler.graph is None          # the CPU runs the step eagerly
    got = sampler(_gen(5))
    _equal(got, eager(_gen(5)))
    _equal(sampler(_gen(5)), got)
    other = sampler(_gen(6))
    assert not torch.equal(other[0] if isinstance(other, tuple) else other,
                           got[0] if isinstance(got, tuple) else got)


@pytest.mark.parametrize("name", ["ddpm_cfg", "ddim_eta", "superdiff_and"])
def test_graphed_sampler_takes_injected_draws(nets, name):
    plan, eager = _case(nets, name)
    rng = np.random.default_rng(0)
    draw = lambda: torch.from_numpy(
        rng.standard_normal(SHAPE).astype(np.float32))
    x_init, noise = draw(), [draw() for _ in range(plan.num_steps)]
    _equal(GraphedSampler(plan)(x_init=x_init, noise=noise),
           eager(None, x_init=x_init, noise=noise))


def test_eager_run_counts_no_capture_or_replay(nets):
    """The counts a graphed run's kernel launches are read from: a run
    whose step is eager (the CPU) captures no graph and replays none."""
    from superdiff_torch.diffusion import graphed

    plan, _ = _case(nets, "ddim_eta")
    graphed.reset_counts()
    GraphedSampler(plan)(_gen(1))
    assert graphed.captures == graphed.replays == 0


def test_plan_tables_and_position_counter(nets):
    s, m1, _ = nets
    f = lambda x, t: torch.zeros_like(x)
    for spacing, grid in (("leading", ts.ddim_timesteps(T, 3)),
                          ("trailing", ts.trailing_timesteps(T, 3))):
        plan = ts.DDIMPlan(s, f, SHAPE, num_steps=3, t_spacing=spacing)
        assert plan.t.tolist() == grid.tolist() and plan.num_steps == 3
        assert plan.ab_next[-1].item() == 1.0
    plan = ts.DPMppPlan(s, f, SHAPE, num_steps=5)
    assert plan.t.tolist() == ts.dpmpp_timesteps(
        T, 5, s.alpha_bars).tolist()
    assert not plan.draws_noise and plan.z is None
    plan = ts.DDPMPlan(s, f, SHAPE)
    plan.start(torch.zeros(SHAPE))
    for i in range(3):
        plan.draw(_gen(0))
        plan.step()
    assert plan.pos.tolist() == [3] and plan.t.tolist() == list(
        range(T - 1, -1, -1))
    with pytest.raises(ValueError, match="without labels"):
        plan.start(torch.zeros(SHAPE), y=torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="CUDA"):
        GraphedSampler(plan, capture=True)


def _tiny_run(path, seed, T=4, **model):
    cfg = tcfg.Config()
    cfg.training.resolution, cfg.training.num_timesteps = RES, T
    cfg.model.base_channels, cfg.model.num_res_blocks = 8, (1,)
    cfg.model.attn_resolutions = (8,)
    for k, v in model.items():
        setattr(cfg.model, k, v)
    os.makedirs(path, exist_ok=True)
    tcfg.save_config(cfg, os.path.join(path, "config.yaml"))
    shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
    fp.export_params(fp.random_params(shapes, seed),
                     os.path.join(path, fp.EXPORT_FILE))
    return cfg


def _png_pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        assert im.mode == "L"
        return np.array(im)


def test_cli_sample_writes_a_png_grid_per_batch(tmp_path):
    run = str(tmp_path / "run")
    _tiny_run(run, 1)
    out = str(tmp_path / "out")
    argv = ["--run-dir", run, "--device", "cpu", "--method", "ddim",
            "--num-steps", "2", "--batch-size", "5", "--num-batches", "2",
            "--label", "1", "--guidance", "2.0", "--out", out]
    assert sample_cli.main(argv) == 0
    assert sorted(os.listdir(out)) == ["batch0.png", "batch1.png",
                                       "samples.npy"]
    x = np.load(os.path.join(out, "samples.npy"))
    assert x.shape == (10, RES, RES, 1)
    grid = _png_pixels(os.path.join(out, "batch1.png"))
    assert grid.shape == (2 * RES + 2, 4 * RES + 3 * 2)   # 4 columns, 2 rows
    for i in range(5):
        img = x[5 + i, ..., 0]
        want = np.round((img - img.min()) / (img.max() - img.min()) * 255)
        r, c = divmod(i, 4)
        tile = grid[r * (RES + 2):r * (RES + 2) + RES,
                    c * (RES + 2):c * (RES + 2) + RES]
        np.testing.assert_array_equal(tile, want.astype(np.uint8))
    assert (grid[RES:RES + 2] == 255).all()               # gap rows
    # the eager argument gives the same samples (on the card it skips the
    # graph; here both run the step eagerly)
    eager = str(tmp_path / "eager")
    assert sample_cli.main(argv[:-1] + [eager], eager=True) == 0
    np.testing.assert_array_equal(
        np.load(os.path.join(eager, "samples.npy")), x)


def test_cli_sample_step_and_best_pick_the_checkpoint(tmp_path):
    cfg = tcfg.Config()
    cfg.run_id = "toy"
    cfg.model.preset, cfg.model.base_channels = "small64", 8
    cfg.model.compute_dtype = cfg.model.norm_dtype = "float32"
    t = cfg.training
    t.resolution, t.batch_size, t.num_timesteps = RES, 2, 4
    t.num_epochs, t.steps_per_epoch, t.vis_every, t.eval_batches = 3, 1, 0, 1
    t.learning_rate = 0.05
    cfg.logging.stdout = False
    cfg.paths.local_base = cfg.paths.cluster_base = str(tmp_path)
    train(cfg, use_synthetic=True, device="cpu")
    run = os.path.join(str(tmp_path), "outputs", "PNEUMONIA",
                       "experiment_exp0_run_toy")
    with open(os.path.join(run, "best_val.json")) as f:
        best = json.load(f)["step"]

    def sample(*flags):
        out = str(tmp_path / ("s" + "".join(flags)))
        assert sample_cli.main(["--run-dir", run, "--device", "cpu",
                                "--method", "ddim", "--num-steps", "2",
                                "--batch-size", "2", "--out", out,
                                *flags]) == 0
        assert os.path.exists(os.path.join(out, "batch0.png"))
        return np.load(os.path.join(out, "samples.npy"))

    def direct(**pick):
        _, model, schedule = load_run(run, device="cpu", **pick)
        from superdiff_torch.inference import apply_sampling_policy
        apply_sampling_policy(model)
        fn = make_eps_fn_p(model, None)
        return ts.ddim_sample(schedule, lambda x, t: fn(model, x, t),
                              (2, RES, RES, 1), _gen(0),
                              num_steps=2).numpy()

    latest, first = sample(), sample("--step", "1")
    np.testing.assert_array_equal(latest, direct())
    np.testing.assert_array_equal(first, direct(step=1))
    assert not np.array_equal(latest, first)
    np.testing.assert_array_equal(sample("--best"), direct(best=True))
    np.testing.assert_array_equal(sample("--step", str(best)),
                                  direct(step=best))
    with pytest.raises(FileNotFoundError, match="step 9"):
        sample("--step", "9")


def test_cli_serve_flags_are_the_reference_flags():
    from superdiff_tpu.cli import serve as jserve_cli

    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    ours, ref = flags(serve_cli.build_parser()), flags(
        jserve_cli.build_parser())
    assert ours.pop("device") == ("cuda", ())
    assert ref.pop("data_parallel") == (False, ())
    assert ours == ref


def test_cli_serve_loads_runs_and_picks_the_warm_spec(tmp_path):
    r1, r2, odd = (str(tmp_path / n) for n in ("r1", "r2", "odd"))
    _tiny_run(r1, 1)
    _tiny_run(r2, 2)
    _tiny_run(odd, 3, num_classes=3)
    parse = lambda *a: serve_cli.build_parser().parse_args(
        ["--run-dir", r1, "--device", "cpu", "--batch-size", "2", *a])
    svc, cfg, spec = serve_cli.load_service(parse("--run-dir2", r2))
    try:
        assert (spec.method, spec.steps) == ("ddim", 50)
        assert svc.batch_size == 2 and svc._model2 is not None
        req = svc.sample_request(1, label=0, spec=spec.__class__(
            "superdiff"), timeout=60)
        assert req.result.shape == (1, RES, RES, 1)
        assert req.logq.shape == (2, 1)
    finally:
        svc.close()
    svc, _, spec = serve_cli.load_service(parse("--method", "dpmpp"))
    svc.close()
    assert (spec.method, spec.steps) == ("dpmpp", 10)
    with pytest.raises(SystemExit, match="requires --run-dir2"):
        serve_cli.load_service(parse("--method", "superdiff"))
    with pytest.raises(SystemExit, match="conditioning differs"):
        serve_cli.load_service(parse("--run-dir2", odd))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve_cli.load_service(serve_cli.build_parser().parse_args(
                ["--run-dir", r1]))
