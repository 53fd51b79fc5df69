"""The CondUNet's pipeline stages, the two-stage pipeline
(``superdiff_torch/parallel/pp.py``) and stacked SuperDiff models
(``diffusion/superdiff.py::stack_eps_fns``, ``inference.py``) against the
JAX package, on the CPU with the same Flax weights.

float32 on both sides: a CondUNet call within rtol/atol 2e-5 of JAX's (the
pipeline's tolerance in ``tests/test_pp.py``); the port against itself
(stages against the full call, stacked against sequential calls) within
1e-5 (``vmap`` batches the convolutions' and products' weights, which
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion.superdiff import stack_eps_fns as j_stack
from superdiff_tpu.inference import make_stacked_eps_fn as j_make_stacked
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.parallel import pp as j_pp
from superdiff_torch import config as tcfg
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.diffusion.superdiff import (
    SuperDiffPlan, stack_eps_fns, superdiff_sample)
from superdiff_torch.inference import (
    make_eps_fn, make_stacked_eps_fn, same_architecture)
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.parallel import pp

torch.set_num_threads(1)

B, RES = 8, 32
PP = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=(1, 2),
          attn_resolutions=(8,), num_classes=2, time_emb_dim=16, groups=4,
          pixel_shuffle=2)
# head dim 32 at the 8x8 level: attention takes the flash path (B1's op)
SMALL = dict(base_channels=16, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), num_heads=1, num_classes=2,
             time_emb_dim=16, groups=4)


def _pair(cfg, res, seed=1, **extra):
    jm = JaxCondUNet(**cfg, **extra)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, res, res, 1)),
                            jnp.zeros((B,), jnp.int32),
                            jnp.zeros((B,), jnp.int32))
    params = {"params": fp.random_params(shapes, seed)}
    tm = CondUNet(resolution=res, device="cpu", **cfg, **extra).eval()
    fp.load_state_dict(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pp_pair():
    return _pair(PP, RES)


def _inputs(res, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, res, res, 1)).astype(np.float32)
    t = np.arange(B, dtype=np.int64) * 7
    y = np.array([1, 0] * (B // 2), dtype=np.int64)
    return x, t, y


def test_down_then_up_equals_the_full_call_and_jax_stages(pp_pair):
    jm, params, tm = pp_pair
    x, t, y = _inputs(RES)
    tx, tt, ty = (torch.from_numpy(a) for a in (x, t, y))
    with torch.no_grad():
        full = tm(tx, tt, ty)
        h, skips, emb = tm(tx, tt, ty, stage="down")
        out = tm(None, None, stage="up", pp_state=(h, skips, emb))
    torch.testing.assert_close(out, full, rtol=1e-6, atol=1e-6)
    jh, jskips, jemb = jax.jit(lambda p, *a: jm.apply(p, *a, stage="down"))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    assert len(skips) == len(jskips)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=2e-5,
                               atol=2e-5)
    for a, b in zip(skips, jskips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


def test_stage_arguments_are_checked(pp_pair):
    tm = pp_pair[2]
    x, t, y = (torch.from_numpy(a) for a in _inputs(RES))
    with pytest.raises(ValueError, match="stage must be all/down/up"):
        tm(x, t, y, stage="mid")
    with pytest.raises(ValueError, match='requires pp_state'):
        tm(None, None, stage="up")


def test_stage_subsets_are_jax_split_params(pp_pair):
    """``split_params`` of the port's state dict takes exactly the modules
    JAX's ``split_params`` puts in each stage, and partitions it."""
    jm, params, tm = pp_pair
    j0, j1 = j_pp.split_params(params)
    p0, p1 = pp.split_params(tm.state_dict())
    assert {k.split(".")[0] for k in p0} == set(j0["params"])
    assert {k.split(".")[0] for k in p1} == set(j1["params"])
    assert set(p0) | set(p1) == set(tm.state_dict())
    assert not set(p0) & set(p1)
    with pytest.raises(ValueError, match="lost modules: \\['extra'\\]"):
        pp.split_params({**tm.state_dict(), "extra.weight": torch.zeros(1)})


def test_pipeline_matches_jax_and_checks_its_arguments(pp_pair):
    jm, params, tm = pp_pair
    x, t, y = _inputs(RES, seed=3)
    jfn = j_pp.make_pp_denoiser(jm, params, devices=jax.devices()[:2],
                                num_microbatches=4)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    fn = pp.make_pp_denoiser(tm, devices=("cpu", "cpu"), num_microbatches=4)
    got = fn(*(torch.from_numpy(a) for a in (x, t, y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        full = tm(*(torch.from_numpy(a) for a in (x, t, y)))
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pp.make_pp_denoiser(tm, devices=("cpu", "cpu"),
                            num_microbatches=3)(
            *(torch.from_numpy(a) for a in (x, t, y)))
    with pytest.raises(ValueError, match="requires labels y"):
        fn(torch.from_numpy(x), torch.from_numpy(t))
    with pytest.raises(ValueError, match="exactly 2 devices"):
        pp.make_pp_denoiser(tm, devices=("cpu",))


def test_each_stage_holds_only_its_parameters(pp_pair):
    tm = pp_pair[2]
    p0, p1 = pp.split_params(tm.state_dict())
    s0 = pp._stage(tm, p0, pp._DOWN_PREFIXES, "cpu")
    s1 = pp._stage(tm, p1, pp._UP_PREFIXES, "cpu")
    assert set(s0.state_dict()) == set(p0)
    assert set(s1.state_dict()) == set(p1)


@pytest.fixture(scope="module")
def stacked_pair():
    jm, p1, tm1 = _pair(SMALL, 16, seed=1)
    _, p2, tm2 = _pair(SMALL, 16, seed=2)
    return jm, (p1, p2), (tm1, tm2)


def test_stacked_call_matches_jax_and_the_list_form(stacked_pair):
    jm, params, models = stacked_pair
    x, t, _ = _inputs(16, seed=4)
    jfn = j_stack(lambda p, xx, tt: jm.apply(
        p, xx, tt, jnp.full((xx.shape[0],), 1, jnp.int32)), list(params))
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(t)))
    fn = stack_eps_fns(lambda m, xx, tt: m(xx, tt, torch.full(
        (xx.shape[0],), 1)), models)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        got = fn(tx, tt)
        listed = torch.stack([m(tx, tt, torch.full((B,), 1))
                              for m in models])
    assert got.shape == (2, B, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, listed, rtol=1e-5, atol=1e-5)


def test_stacked_call_runs_the_kernels_through_their_ops(stacked_pair,
                                                         monkeypatch):
    """Under ``vmap`` the attention goes through ``superdiff::
    flash_attn_fwd`` once for both models (its rule folds the model axis
    into the batch) and each GroupNorm chain through ``superdiff::
    gn_film_silu`` once per model."""
    from superdiff_torch.ops import flash_attention as fa
    from superdiff_torch.ops import fused_norm as fn_

    calls = {"b1": [], "b4": 0}
    f_impl, n_impl = fa._flash_forward_impl, fn_._gn_film_silu_policy_impl

    def b1(q, k, v):
        calls["b1"].append(q.shape[0])
        return f_impl(q, k, v)

    def b4(*a):
        calls["b4"] += 1
        return n_impl(*a)

    monkeypatch.setattr(fa, "_flash_forward_impl", b1)
    monkeypatch.setattr(fn_, "_gn_film_silu_policy_impl", b4)
    models = stacked_pair[2]
    fn = make_stacked_eps_fn(list(models), label=0)
    x = torch.randn(3, 16, 16, 1)
    with torch.no_grad():
        fn(x, torch.tensor([1, 2, 3]))
    n_attn = sum(1 for n, _ in models[0].named_children() if "attn" in n)
    assert calls["b1"] == [2 * 3] * n_attn
    n_chains = 2 * sum(1 for n, _ in models[0].named_children()
                       if "block" in n) + 1
    assert calls["b4"] == 2 * n_chains


def test_make_stacked_eps_fn_converts_v_heads_like_jax():
    jm, p1, tm1 = _pair(SMALL, 16, seed=1, parameterization="v")
    _, p2, tm2 = _pair(SMALL, 16, seed=2, parameterization="v")
    js, ts = j_make_schedule(50), make_schedule(50, device="cpu")
    x, t, _ = _inputs(16, seed=5)
    want = np.asarray(jax.jit(j_make_stacked(jm, [p1, p2], label=None,
                                             schedule=js))(
        jnp.asarray(x), jnp.asarray(t)))
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        got = make_stacked_eps_fn([tm1, tm2], schedule=ts)(tx, tt)
        listed = torch.stack([make_eps_fn(m, schedule=ts)(tx, tt)
                              for m in (tm1, tm2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, listed, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="pass schedule="):
        make_stacked_eps_fn([tm1, tm2])


def test_same_architecture():
    a, b = tcfg.Config(), tcfg.Config()
    assert same_architecture(a, b)
    b.model.base_channels = 32
    assert not same_architecture(a, b)


def test_stacked_superdiff_equals_the_list_form(stacked_pair):
    models = stacked_pair[2]
    sch = make_schedule(6, device="cpu")
    shape = (3, 16, 16, 1)
    runs = []
    for fns, kw in ((make_stacked_eps_fn(list(models), label=1),
                     dict(num_models=2)),
                    ([make_eps_fn(m, 1) for m in models], {})):
        runs.append(superdiff_sample(sch, fns, shape,
                                     torch.Generator().manual_seed(0),
                                     mode="and", **kw))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=1e-5,
                               atol=1e-3)


def test_stacked_callable_needs_num_models():
    sch = make_schedule(4, device="cpu")
    with pytest.raises(ValueError, match="num_models is required with a "
                                         "stacked model_fns callable"):
        superdiff_sample(sch, lambda x, t: x[None], (1, 4, 4, 1))
    with pytest.raises(ValueError, match="superposition needs >= 2 models"):
        SuperDiffPlan(sch, lambda x, t: x[None], (1, 4, 4, 1), num_models=1)
    with pytest.raises(ValueError, match="AND mode supports exactly two"):
        SuperDiffPlan(sch, lambda x, t: x[None], (1, 4, 4, 1), mode="and",
                      num_models=3)
