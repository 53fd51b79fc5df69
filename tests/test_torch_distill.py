"""Progressive distillation of the port against the JAX package (CPU,
float32, the toy CondUNet of ``__graft_entry__.py``).

The phase tables, the DDIM transition and the target solve are held to
``superdiff_tpu.diffusion.distill`` on the same inputs. The distillation step
is held to JAX's jitted step from the same teacher and student parameters and
batches, with the draws of JAX's key chain (null-label mask, transition
index, noise) replayed into the port's step. ``cli.distill`` writes stamped
students that both packages load and sample alike with trailing DDIM and
``clip_x0=False``.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.data.synthetic import synthetic_xray_batch
from superdiff_tpu.diffusion import distill as jd
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion import samplers as js
from superdiff_tpu.inference import load_run as j_load_run
from superdiff_tpu.inference import make_eps_fn_p as j_make_eps_fn_p
from superdiff_tpu.inference import resolve_sampler_spec as j_resolve
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.training.state import TrainState as JaxTrainState
from superdiff_tpu.training.state import make_optimizer as j_make_optimizer
from superdiff_torch import config as tcfg
from superdiff_torch.cli import distill as distill_cli
from superdiff_torch.cli import sample as sample_cli
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import distill as td
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.diffusion import samplers as ts
from superdiff_torch.inference import (apply_sampling_policy, load_run,
                                       make_eps_fn_p, resolve_sampler_spec)
from superdiff_torch.models.presets import model_from_config
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.training.state import create_train_state, make_optimizer

torch.set_num_threads(1)

TOY = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attn_resolutions=(8,), num_heads=2, time_emb_dim=16, groups=4)
T, B, R, N = 50, 4, 16, 2
NULL_P = 0.5
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=6,
           schedule="cosine")


def _compile(pool, lowered):
    """Compile a lowered JAX program on ``pool`` at XLA's lowest backend
    optimisation level: each reference program here runs a few times on
    toy shapes, so its compile is nearly all of its cost, and a compile
    in a thread overlaps the next trace (which holds the GIL)."""
    return pool.submit(lowered.compile, compiler_options={
        "xla_backend_optimization_level": 0})


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _comparable(path, a):
    """Drop the key third of a fused ``qkv`` bias (softmax is invariant to
    it: its gradient is rounding noise that Adam normalises into full-size
    steps, as in ``tests/test_torch_training.py``)."""
    if tuple(path[-2:]) == ("qkv", "bias"):
        c = a.shape[0] // 3
        return np.concatenate([a[:c], a[2 * c:]])
    return a


# ---------------------------------------------------- tables and algebra ---

@pytest.mark.parametrize("n,kind", [(1, "linear"), (4, "linear"),
                                    (8, "cosine"), (25, "linear")])
def test_phase_tables_match_jax(n, kind):
    """Student nodes, midpoints and the (alpha, sigma) of start, midpoint
    and endpoint (the last one clean) equal JAX's: both reckon in float64
    from the same float32 alpha_bars and round once."""
    expect = jd.phase_tables(j_make_schedule(T, kind=kind), n)
    got = td.phase_tables(make_schedule(T, kind=kind, device="cpu"), n)
    assert set(got) == set(expect)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(expect[k]), k)
    assert got["t_s"][0] == T - 1
    assert got["a_e"][-1] == 1.0 and got["s_e"][-1] == 0.0


@pytest.mark.parametrize("clip", [True, False])
def test_ddim_transition_and_targets_match_jax(clip):
    """``_ddim_to`` (the clipped transition re-derives eps with
    ``max(s, 1e-12)``) and ``distill_targets`` on the same inputs, with
    outputs reaching past [-1, 1]; rtol 1e-6 (float32, a few operations)."""
    rng = np.random.default_rng(3 + clip)
    shape = (6, 4, 4, 1)
    x, eps = (rng.normal(0, 2, shape).astype(np.float32) for _ in range(2))
    tab = jd.phase_tables(j_make_schedule(T), 3)
    i = np.array([0, 1, 2, 2, 1, 0])
    co = {k: np.asarray(tab[k])[i][:, None, None, None]
          for k in ("a_s", "s_s", "a_m", "s_m", "a_e", "s_e")}
    expect = np.array(jd._ddim_to(x, co["a_s"], co["s_s"], co["a_e"],
                                  co["s_e"], eps, clip_x0=clip))
    tco = {k: torch.from_numpy(v) for k, v in co.items()}
    got = td._ddim_to(torch.from_numpy(x), tco["a_s"], tco["s_s"],
                      tco["a_e"], tco["s_e"], torch.from_numpy(eps),
                      clip_x0=clip).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    e_t = np.asarray(jd.distill_targets(x, co["a_s"], co["s_s"], co["a_e"],
                                        co["s_e"], expect))
    g_t = td.distill_targets(torch.from_numpy(x), tco["a_s"], tco["s_s"],
                             tco["a_e"], tco["s_e"],
                             torch.from_numpy(expect)).numpy()
    np.testing.assert_allclose(g_t, e_t, rtol=1e-6, atol=1e-6)
    # the clean endpoint: the target is the teacher's result itself
    np.testing.assert_array_equal(g_t[i == 2], expect[i == 2])


# ------------------------------------------------------- distill step ------

# (conditional, student head, teacher rollout clipped, uint8 batch)
CASES = {"cond_v": (True, "v", True, False),
         "uncond_eps_unclipped_uint8": (False, "eps", False, True)}


def _flax_params(num_classes, seed):
    """Seeded parameters of the toy CondUNet (the head's parameterization
    does not change them), Flax layout; the shapes come from the port's
    model on the meta device, which costs no trace."""
    shapes = fp.flax_shapes(CondUNet(resolution=R, device="meta", **TOY,
                                     num_classes=num_classes))
    return {"params": fp.random_params(shapes, seed)}


def _batches(cond, uint8):
    out = []
    for s in range(3):
        imgs, labels = synthetic_xray_batch(B, R, seed=s)
        if uint8:
            imgs = np.round((imgs + 1) * 127.5).astype(np.uint8)
        out.append((imgs, labels.astype(np.int64)))
    return out


def _jax_draws(state_rng, step, shape, null_prob):
    """Replay the key chain of JAX's distillation step: returns the next
    state key and the draws."""
    rng, step_rng = jax.random.split(jnp.asarray(state_rng))
    r = jax.random.fold_in(step_rng, step)
    draws = {}
    if null_prob > 0:
        r, drop_rng = jax.random.split(r)
        draws["drop"] = torch.from_numpy(np.array(
            jax.random.bernoulli(drop_rng, null_prob, (shape[0],))))
    rng_i, rng_noise = jax.random.split(r)
    draws["i"] = torch.from_numpy(np.array(
        jax.random.randint(rng_i, (shape[0],), 0, N))).long()
    draws["noise"] = torch.from_numpy(np.array(
        jax.random.normal(rng_noise, shape, jnp.float32)))
    return rng, draws


def _jax_case(name, pool):
    """Set up one case's JAX distillation step from seeded teacher (eps
    head) and student parameters, lower it and start its compile."""
    cond, head, clip, uint8 = CASES[name]
    nc = 2 if cond else 0
    jt = JaxCondUNet(**TOY, num_classes=nc)
    js_ = JaxCondUNet(**TOY, num_classes=nc, parameterization=head)
    t_params, s_params = _flax_params(nc, 1), _flax_params(nc, 2)
    sched = j_make_schedule(T)
    tx = j_make_optimizer(**OPT)
    rng0 = np.array(jax.random.PRNGKey(11))
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=s_params,
        ema_params=jax.tree_util.tree_map(jnp.copy, s_params),
        opt_state=tx.init(s_params), rng=jnp.asarray(rng0),
        apply_fn=js_.apply, tx=tx, ema_decay=0.9)
    null_prob = NULL_P if cond else 0.0
    step_fn = jd.make_distill_step(
        sched, j_make_eps_fn_p(jt, "per_sample" if cond else None,
                               schedule=sched),
        N, conditional=cond, parameterization=head, null_prob=null_prob,
        null_label=jt.null_label if cond else 0, clip_x0=clip)
    host = _batches(cond, uint8)
    batches = [{"image": jnp.asarray(imgs), "label": jnp.asarray(labels)}
               if cond else {"image": jnp.asarray(imgs)}
               for imgs, labels in host]
    compiled = _compile(pool, step_fn.lower(state, t_params, batches[0]))
    return dict(case=CASES[name], t_params=t_params, s_params=s_params,
                rng0=rng0, batches=host, null_prob=null_prob), (
                    state, batches, compiled)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's jitted distillation step run for 3 steps in each case: metrics
    per step and the student's parameters and EMA after 3 steps. Both
    cases are traced before either is run, so the second trace overlaps
    the first compile."""
    with ThreadPoolExecutor(2) as pool:
        pending = {name: _jax_case(name, pool) for name in CASES}
        runs = {}
        for name, (run, (state, batches, compiled)) in pending.items():
            step_fn = compiled.result()
            metrics = []
            for batch in batches:
                state, m = step_fn(state, run["t_params"], batch)
                metrics.append({k: float(v) for k, v in m.items()})
            run["metrics"] = metrics
            run["final"] = jax.tree_util.tree_map(np.asarray, {
                "params": state.params, "ema_params": state.ema_params})
            runs[name] = run
    return runs


@pytest.fixture(scope="module", params=list(CASES))
def jax_distill(request, jax_runs):
    return jax_runs[request.param]


def _port_steps(jx, n):
    cond, head, clip, _ = jx["case"]
    nc = 2 if cond else 0
    teacher = CondUNet(resolution=R, device="cpu", **TOY, num_classes=nc)
    fp.load_state_dict(teacher, jx["t_params"])
    teacher.eval().requires_grad_(False)
    student = CondUNet(resolution=R, device="cpu", **TOY, num_classes=nc,
                       parameterization=head)
    fp.load_state_dict(student, jx["s_params"])
    st = create_train_state(student, torch.Generator().manual_seed(0),
                            tx=make_optimizer(**OPT), ema_decay=0.9)
    sched = make_schedule(T, device="cpu")
    step_fn = td.make_distill_step(
        sched, make_eps_fn_p(teacher, "per_sample" if cond else None,
                             schedule=sched),
        N, conditional=cond, parameterization=head,
        null_prob=jx["null_prob"], null_label=teacher.null_label if cond
        else 0, clip_x0=clip)
    rng, out = jx["rng0"], []
    for s in range(n):
        imgs, labels = jx["batches"][s]
        rng, draws = _jax_draws(rng, s, imgs.shape, jx["null_prob"])
        if s == 0 and cond:
            assert draws["drop"].any() and not draws["drop"].all()
        batch = {"image": torch.from_numpy(imgs)}
        if cond:
            batch["label"] = torch.from_numpy(labels)
        st, m = step_fn(st, teacher, batch, draws)
        out.append({k: float(v) for k, v in m.items()})
    assert not any(p.requires_grad for p in teacher.parameters())
    return st, out


def test_one_distill_step_matches_jax(jax_distill):
    """The loss (rtol 1e-5) and the gradient norm (rtol 1e-4) of one step:
    the same teacher rollout, targets, student forward and backward."""
    _, m = _port_steps(jax_distill, 1)
    np.testing.assert_allclose(m[0]["loss"], jax_distill["metrics"][0]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(m[0]["grad_norm"],
                               jax_distill["metrics"][0]["grad_norm"],
                               rtol=1e-4)


def test_three_distill_steps_match_jax(jax_distill):
    """Metrics of each of 3 steps (loss rtol 1e-4, grad_norm 1e-3), then the
    student's parameters and EMA (relative L2 per leaf <= 1e-4): the
    tolerances of the 3-step train-step parity test. Step 0 has rate 0
    (warm-up), so every leaf moves only through steps 1 and 2."""
    st, metrics = _port_steps(jax_distill, 3)
    assert st.step == 3 and st.opt_state["count"] == 3
    for m, jm in zip(metrics, jax_distill["metrics"]):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-3)
    got = {"params": fp.to_flax(st.model), "ema_params": fp.to_flax(
        st.ema_model)}
    start = fp._flatten(jax_distill["s_params"]["params"])
    for name in ("params", "ema_params"):
        g = fp._flatten(got[name])
        e = fp._flatten(jax_distill["final"][name]["params"])
        assert set(g) == set(e)
        for path in g:
            assert _rel_l2(_comparable(path, g[path]),
                           _comparable(path, e[path])) <= 1e-4, (name, path)
            assert not np.array_equal(g[path], start[path]), (name, path)


# ------------------------------------------------------------------ CLI ----

RES, T_CLI = 16, 8


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """A toy conditional eps teacher run (float32), distilled by
    ``cli.distill --synthetic --steps 2,1`` into ``s2/`` and ``s1/``."""
    base = tmp_path_factory.mktemp("distill")
    run = str(base / "run")
    cfg = tcfg.Config()
    cfg.training.resolution, cfg.training.num_timesteps = RES, T_CLI
    cfg.training.steps_per_epoch = 2
    cfg.model.base_channels, cfg.model.num_res_blocks = 8, (1,)
    cfg.model.attn_resolutions = (8,)
    cfg.model.compute_dtype = cfg.model.norm_dtype = "float32"
    os.makedirs(run)
    tcfg.save_config(cfg, os.path.join(run, "config.yaml"))
    shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
    fp.export_params(fp.random_params(shapes, 5),
                     os.path.join(run, fp.EXPORT_FILE))
    out = str(base / "students")
    assert distill_cli.main(["--run-dir", run, "--synthetic", "--steps",
                             "2,1", "--phase-epochs", "1", "--batch-size",
                             "2", "--lr", "1e-3", "--warmup-steps", "1",
                             "--device", "cpu", "--out", out]) == 0
    return run, out


def test_cli_distill_writes_stamped_students(distilled):
    run, out = distilled
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert [p["num_steps"] for p in summary["phases"]] == [2, 1]
    for p in summary["phases"]:
        assert p["steps"] == 2 and np.isfinite(p["first_loss"])
        assert np.isfinite(p["last_loss"])
    teacher_w = fp._flatten(fp.load_exported_params(
        os.path.join(run, fp.EXPORT_FILE)))
    for n in (2, 1):
        sdir = os.path.join(out, f"s{n}")
        assert sorted(os.listdir(sdir)) == ["config.yaml", fp.EXPORT_FILE]
        cfg = tcfg.load_config(os.path.join(sdir, "config.yaml"))
        s = cfg.sampling
        assert (s.method, s.num_steps, s.t_spacing, s.eta, s.clip_x0) == (
            "ddim", n, "trailing", 0.0, False)
        assert cfg.model.parameterization == "v"
        w = fp._flatten(fp.load_exported_params(
            os.path.join(sdir, fp.EXPORT_FILE))["params"])
        assert set(w) == set(teacher_w)
        assert any(not np.array_equal(w[k], teacher_w[k]) for k in w)


SAMPLE_SHAPE = (3, RES, RES, 1)


@pytest.fixture(scope="module")
def jax_student_samples(distilled):
    """Each student through JAX's ``load_run``, its stamp through JAX's
    ``resolve_sampler_spec``, and JAX's trailing DDIM without clipping from
    a seeded key: ``{n: (spec, samples, the initial noise)}``. Both
    samplers are traced before either is compiled, and compile together."""
    _, out = distilled
    pending = {}
    with ThreadPoolExecutor(2) as pool:
        for n in (2, 1):
            jcfg, jmodel, jsched, jparams = j_load_run(
                os.path.join(out, f"s{n}"))
            spec = tuple(j_resolve(jcfg))
            jfn = j_make_eps_fn_p(jmodel, None, schedule=jsched)
            key = jax.random.PRNGKey(n)
            # the weights ride as an argument (closed over, they would be
            # folded into the compile as constants)
            sample = jax.jit(lambda p, k, jsched=jsched, jfn=jfn, spec=spec:
                             js.ddim_sample(jsched,
                                            lambda x, t: jfn(p, x, t),
                                            SAMPLE_SHAPE, k,
                                            num_steps=spec[1],
                                            t_spacing=spec[2],
                                            clip_x0=spec[3]))
            pending[n] = (spec, key, jparams,
                          _compile(pool, sample.lower(jparams, key)))
        res = {}
        for n, (spec, key, jparams, compiled) in pending.items():
            x = np.asarray(compiled.result()(jparams, key))
            _, init_rng = jax.random.split(key)
            res[n] = (spec, x, np.array(jax.random.normal(init_rng,
                                                          SAMPLE_SHAPE)))
    return res


@pytest.mark.parametrize("n", [2, 1])
def test_student_samples_alike_in_both_packages(distilled,
                                                jax_student_samples, n):
    """Both ``load_run``s read the student; both resolve its stamp to
    trailing DDIM-n with ``clip_x0=False``; from the same initial noise the
    two samplers agree (float32 toy, n steps: max abs 1e-5 on outputs of
    order 1). The clipped sampler gives another result, so the stamp
    matters."""
    _, out = distilled
    cfg, model, sched = load_run(os.path.join(out, f"s{n}"), device="cpu")
    jspec, expect, x_init = jax_student_samples[n]
    spec = resolve_sampler_spec(cfg)
    assert spec == ("ddim", n, "trailing", False) == jspec
    fn = make_eps_fn_p(model, None, schedule=sched)

    def sample(clip):
        with torch.no_grad():
            return ts.ddim_sample(sched, lambda x, t: fn(model, x, t),
                                  SAMPLE_SHAPE, num_steps=n,
                                  t_spacing="trailing", clip_x0=clip,
                                  x_init=torch.from_numpy(x_init)).numpy()

    got = sample(False)
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)
    assert np.abs(got).max() > 1.0
    assert not np.allclose(got, sample(True))


def test_cli_sample_follows_the_student_stamp(distilled, tmp_path):
    """``cli.sample --run-dir s2`` with no ``--method`` runs the stamped
    trailing DDIM-2 with ``clip_x0=False``: the same samples as that
    sampler called directly on the same policy-cast model."""
    _, out = distilled
    sdir = os.path.join(out, "s2")
    dst = str(tmp_path / "samples")
    assert sample_cli.main(["--run-dir", sdir, "--device", "cpu",
                            "--batch-size", "2", "--out", dst]) == 0
    got = np.load(os.path.join(dst, "samples.npy"))
    _, model, sched = load_run(sdir, device="cpu")
    apply_sampling_policy(model)
    fn = make_eps_fn_p(model, None, schedule=sched)

    def direct(**kw):
        with torch.no_grad():
            return ts.ddim_sample(sched, lambda x, t: fn(model, x, t),
                                  (2, RES, RES, 1),
                                  torch.Generator().manual_seed(0), **kw
                                  ).float().numpy()

    np.testing.assert_array_equal(got, direct(num_steps=2,
                                              t_spacing="trailing",
                                              clip_x0=False))
    assert not np.array_equal(got, direct(num_steps=50))


@pytest.mark.parametrize("spec", ["8,2", "4,2,2", "0", ","])
def test_bad_step_lists_exit_before_any_compute(spec, monkeypatch):
    """A list that does not halve phase over phase (or is empty or not
    positive) exits before the run is even loaded."""
    import superdiff_torch.inference as inference

    def boom(*a, **k):
        raise AssertionError("load_run reached")

    monkeypatch.setattr(inference, "load_run", boom)
    with pytest.raises(SystemExit) as e:
        distill_cli.main(["--run-dir", "/nonexistent", "--synthetic",
                          "--steps", spec, "--device", "cpu"])
    assert "steps" in str(e.value)
