"""Sampler parity: superdiff_torch against the JAX samplers at T=8.

``jax.random`` and torch cannot share a stream, so each test rebuilds the
JAX sampler's key chain (``rng, init = split(rng)`` for the initial draw,
then ``key, nkey = split(key)`` per step) and injects those draws into the
port (``x_init=``, ``noise=``). Tolerances are float32 over 8 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.diffusion import samplers as js
from superdiff_tpu.diffusion import schedules as jsch
from superdiff_tpu.inference import make_eps_fn_p as j_make_eps_fn_p
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_torch.compat.flax_params import load_state_dict, random_params
from superdiff_torch.diffusion import samplers as ts
from superdiff_torch.diffusion import schedules as tsch
from superdiff_torch.diffusion.process import (
    eps_from_pred, pred_target, predict_x0_from_eps, q_sample, x0_from_pred)
from superdiff_torch.inference import make_eps_fn_p
from superdiff_torch.models.unet import CondUNet

torch.set_num_threads(1)

T = 8
SHAPE = (2, 8, 8, 1)
NULL = 2


@pytest.fixture(scope="module")
def sched():
    return jsch.make_schedule(T), tsch.make_schedule(T, device="cpu")


def jax_draws(seed, shape, steps):
    """The JAX samplers' draws: initial x, then one per step."""
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    x_init = np.array(jax.random.normal(init_rng, shape))
    key, noise = rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noise.append(np.array(jax.random.normal(nkey, shape)))
    return torch.from_numpy(x_init), [torch.from_numpy(n) for n in noise]


def j_model(x, t, y=None):
    eps = 0.1 * x + 0.01 * t.astype(x.dtype)[:, None, None, None]
    if y is not None:
        eps = eps + 0.3 * (y == NULL).astype(x.dtype)[:, None, None, None]
    return eps


def t_model(x, t, y=None):
    eps = 0.1 * x + 0.01 * t.to(x.dtype)[:, None, None, None]
    if y is not None:
        eps = eps + 0.3 * (y == NULL).to(x.dtype)[:, None, None, None]
    return eps


def _close(got, expect):
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-5)


def test_schedule_and_process_match(sched):
    js_, ts_ = sched
    for name in ("betas", "alphas", "alpha_bars", "alpha_bars_prev",
                 "sqrt_alpha_bars", "sqrt_one_minus_alpha_bars",
                 "sqrt_recip_alphas", "posterior_variance"):
        np.testing.assert_array_equal(getattr(ts_, name).numpy(),
                                      np.asarray(getattr(js_, name)))
    cos_j = jsch.make_schedule(50, kind="cosine")
    cos_t = tsch.make_schedule(50, kind="cosine", device="cpu")
    np.testing.assert_array_equal(cos_t.alpha_bars.numpy(),
                                  np.asarray(cos_j.alpha_bars))
    from superdiff_tpu.diffusion import process as jp
    rng = np.random.default_rng(0)
    x, e = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([0, 7])
    tx, te, tt = torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(t)
    _close(q_sample(ts_, tx, tt, te), jp.q_sample(js_, x, t, e))
    _close(predict_x0_from_eps(ts_, tx, tt, te),
           jp.predict_x0_from_eps(js_, x, t, e))
    for kind in ("eps", "v", "x0"):
        _close(pred_target(ts_, tx, tt, te, kind),
               jp.pred_target(js_, x, t, e, kind))
        _close(eps_from_pred(ts_, tx, tt, te, kind),
               jp.eps_from_pred(js_, x, t, e, kind))
        _close(x0_from_pred(ts_, tx, tt, te, kind),
               jp.x0_from_pred(js_, x, t, e, kind))


@pytest.mark.parametrize("guidance", [1.0, 3.0], ids=["plain", "cfg3"])
def test_ddpm_matches_jax(sched, guidance):
    js_, ts_ = sched
    y = np.array([0, 1])
    expect = js.ddpm_sample(js_, j_model, SHAPE, jax.random.PRNGKey(4),
                            y=jnp.asarray(y), guidance_scale=guidance,
                            null_label=NULL, num_frames=3)
    x_init, noise = jax_draws(4, SHAPE, T)
    got = ts.ddpm_sample(ts_, t_model, SHAPE, y=torch.from_numpy(y),
                         guidance_scale=guidance, null_label=NULL,
                         num_frames=3, x_init=x_init, noise=noise)
    _close(got[0], expect[0])
    _close(got[1], expect[1])


@pytest.mark.parametrize("spacing,eta", [("leading", 0.0),
                                         ("trailing", 0.7)])
def test_ddim_matches_jax(sched, spacing, eta):
    js_, ts_ = sched
    expect = js.ddim_sample(js_, j_model, SHAPE, jax.random.PRNGKey(5),
                            num_steps=4, eta=eta, t_spacing=spacing)
    x_init, noise = jax_draws(5, SHAPE, 4)
    got = ts.ddim_sample(ts_, t_model, SHAPE, num_steps=4, eta=eta,
                         t_spacing=spacing, x_init=x_init, noise=noise)
    _close(got, expect)


def test_dpmpp_matches_jax(sched):
    js_, ts_ = sched
    expect = js.dpmpp_sample(js_, j_model, SHAPE, jax.random.PRNGKey(6),
                             num_steps=5)
    x_init, _ = jax_draws(6, SHAPE, 0)
    got = ts.dpmpp_sample(ts_, t_model, SHAPE, num_steps=5, x_init=x_init)
    _close(got, expect)


def test_grids_and_frame_recorder_match():
    for n in (1, 3, 8):
        np.testing.assert_array_equal(ts.ddim_timesteps(8, n),
                                      js.ddim_timesteps(8, n))
        np.testing.assert_array_equal(ts.trailing_timesteps(8, n),
                                      js.trailing_timesteps(8, n))
    ab = np.asarray(jsch.make_schedule(1000).alpha_bars)
    np.testing.assert_array_equal(ts.dpmpp_timesteps(1000, 10, ab),
                                  js.dpmpp_timesteps(1000, 10, ab))
    init, record = ts.make_frame_recorder(7, 3)
    buf = init((1,), torch.float32, "cpu")
    for pos in range(7):
        buf = record(buf, torch.full((1,), float(pos)), pos)
    assert buf.flatten().tolist() == [2.0, 4.0, 6.0]


def test_toy_unet_ddpm_cfg_slice_matches_jax(sched):
    """The slice as a whole at toy size: the __graft_entry__.py CondUNet
    with random weights, sampled by DDPM with CFG 3.0 (one 2B call per
    step) through make_eps_fn_p on both sides."""
    js_, ts_ = sched
    kw = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
              attn_resolutions=(8,), num_heads=2, num_classes=2,
              time_emb_dim=16, groups=4)
    shape = (2, 16, 16, 1)
    jm = JaxCondUNet(**kw)
    params = {"params": random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros(shape),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32)), 7)}
    y = np.array([0, 1])
    jfn = j_make_eps_fn_p(jm, "per_sample")
    expect = jax.jit(lambda r, p: js.ddpm_sample(
        js_, lambda *a: jfn(p, *a), shape, r, y=jnp.asarray(y),
        guidance_scale=3.0, null_label=jm.null_label))(
            jax.random.PRNGKey(8), params)
    tm = CondUNet(resolution=16, device="cpu", **kw)
    load_state_dict(tm, params)
    tfn = make_eps_fn_p(tm, "per_sample")
    x_init, noise = jax_draws(8, shape, T)
    got = ts.ddpm_sample(ts_, lambda *a: tfn(tm, *a), shape,
                         y=torch.from_numpy(y), guidance_scale=3.0,
                         null_label=tm.null_label, x_init=x_init,
                         noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_generator_sampling_is_reproducible(sched):
    _, ts_ = sched
    draw = lambda: ts.ddpm_sample(
        ts_, t_model, SHAPE, torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert torch.equal(a, b) and torch.isfinite(a).all()
