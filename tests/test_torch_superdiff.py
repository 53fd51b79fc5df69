"""SuperDiff parity: superdiff_torch against the JAX package, plus the
JAX tests' closed-form Gaussian checks re-run on the port.

For the analytic Gaussian diffusion (data ~ N(mu, I)) the optimal denoiser
is eps(x, t) = sigma_t (x - mu sqrt(ab_t)) and log q_0 = log N(x; mu, I).
Noise for the parity tests is JAX's own key chain, injected into the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.diffusion import schedules as jsch
from superdiff_tpu.diffusion import superdiff as jsd
from superdiff_tpu.inference import make_eps_fn_p as j_make_eps_fn_p
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_torch.compat.flax_params import load_state_dict, random_params
from superdiff_torch.diffusion import ddpm_sample
from superdiff_torch.diffusion import schedules as tsch
from superdiff_torch.diffusion import superdiff as tsd
from superdiff_torch.inference import make_eps_fn_p
from superdiff_torch.models.unet import CondUNet

torch.set_num_threads(1)

SHAPE = (4, 8, 8, 1)


def jax_draws(seed, shape, steps):
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    x_init = np.array(jax.random.normal(init_rng, shape))
    key, noise = rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noise.append(np.array(jax.random.normal(nkey, shape)))
    return torch.from_numpy(x_init), [torch.from_numpy(n) for n in noise]


def j_gauss(mu, s):
    def fn(x, t):
        ab = s.alpha_bars[t].reshape(-1, 1, 1, 1)
        sig = s.sqrt_one_minus_alpha_bars[t].reshape(-1, 1, 1, 1)
        return sig * (x - mu * jnp.sqrt(ab))
    return fn


def t_gauss(mu, s):
    def fn(x, t):
        ab = s.alpha_bars[t].reshape(-1, 1, 1, 1)
        sig = s.sqrt_one_minus_alpha_bars[t].reshape(-1, 1, 1, 1)
        return sig * (x - mu * torch.sqrt(ab))
    return fn


@pytest.mark.parametrize("mode,extra", [
    ("or", dict(temperature=0.7, bias=[0.5, 0.0])),
    ("and", {}),
    ("fixed", dict(kappa=[0.3, 0.7])),
])
def test_superdiff_matches_jax(mode, extra):
    """(x, logq) on the same injected noise, T=8. Tolerance: float32; logq
    is ~-100, accumulated over 8 steps of three 64-term dot products."""
    T = 8
    js_, ts_ = jsch.make_schedule(T), tsch.make_schedule(T, device="cpu")
    jx, jlq = jsd.superdiff_sample(
        js_, [j_gauss(0.5, js_), j_gauss(-0.4, js_)], SHAPE,
        jax.random.PRNGKey(11), mode=mode, **extra)
    x_init, noise = jax_draws(11, SHAPE, T)
    tx, tlq = tsd.superdiff_sample(
        ts_, [t_gauss(0.5, ts_), t_gauss(-0.4, ts_)], SHAPE, mode=mode,
        x_init=x_init, noise=noise, **extra)
    assert tlq.shape == (2, SHAPE[0])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tlq.numpy(), np.asarray(jlq), rtol=1e-5,
                               atol=1e-3)


def test_mixing_helpers_match_jax():
    rng = np.random.default_rng(0)
    T = 8
    js_, ts_ = jsch.make_schedule(T), tsch.make_schedule(T, device="cpu")
    x, dxb, dxc = (rng.standard_normal(SHAPE).astype(np.float32)
                   for _ in range(3))
    scores = rng.standard_normal((2,) + SHAPE).astype(np.float32)
    logq = rng.standard_normal((2, 4)).astype(np.float32) * 10
    bias = np.array([0.2, -0.1], np.float32)
    t = lambda a: torch.from_numpy(a)
    np.testing.assert_allclose(
        tsd.ito_logdensity_step(ts_, 5, t(x), t(scores), t(dxb)).numpy(),
        np.asarray(jsd.ito_logdensity_step(js_, 5, x, scores, dxb)),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        tsd._mix_kappa_or(t(logq), 0.5, t(bias)).numpy(),
        np.asarray(jsd._mix_kappa_or(logq, 0.5, bias)), rtol=1e-5, atol=1e-6)
    # scale dx_coef down so some kappas land outside [-2, 3] and clip
    got = tsd._mix_kappa_and(ts_, 5, t(x), t(scores), t(dxb), t(dxc * 0.01),
                             t(bias), t(logq)).numpy()
    expect = np.asarray(jsd._mix_kappa_and(js_, 5, x, scores, dxb,
                                           dxc * 0.01, bias, logq))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    assert got.min() >= -2.0 and got.max() <= 3.0


def test_ito_estimator_matches_analytic_gaussian():
    """Tracked log q at t=0 against the closed-form Gaussian log-density
    (T=400; discretisation error is a few percent of |logq| ~ 60)."""
    mu, T = 0.3, 400
    s = tsch.make_schedule(T, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, logq = tsd.superdiff_sample(s, [t_gauss(mu, s), t_gauss(mu, s)],
                                   SHAPE, g, mode="fixed", kappa=[0.5, 0.5])
    diff = (x - mu).reshape(SHAPE[0], -1).double()
    expect = -0.5 * (diff ** 2).sum(-1) - 0.5 * 64 * math.log(2 * math.pi)
    np.testing.assert_allclose(logq[0].numpy(), expect.numpy(), rtol=0.08,
                               atol=3.0)
    np.testing.assert_allclose(logq[0].numpy(), logq[1].numpy(), rtol=1e-5)


def test_and_equalizes_and_fixed_pure_is_ddpm():
    T = 400
    s = tsch.make_schedule(T, device="cpu")
    m1, m2 = t_gauss(0.4, s), t_gauss(-0.4, s)
    x, logq = tsd.superdiff_sample(s, [m1, m2], SHAPE,
                                   torch.Generator().manual_seed(1),
                                   mode="and")
    assert (logq[0] - logq[1]).abs().max() < 3.0
    assert (x.mean(dim=(1, 2, 3)).abs() < 0.35).all()

    x_init, noise = jax_draws(2, SHAPE, T)
    x_sup, _ = tsd.superdiff_sample(s, [m1, m2], SHAPE, mode="fixed",
                                    kappa=[1.0, 0.0], x_init=x_init,
                                    noise=noise)
    x_ddpm = ddpm_sample(s, m1, SHAPE, x_init=x_init, noise=noise)
    np.testing.assert_allclose(x_sup.numpy(), x_ddpm.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_mode_validation():
    s = tsch.make_schedule(4, device="cpu")
    m = t_gauss(0.0, s)
    with pytest.raises(ValueError):
        tsd.superdiff_sample(s, [m, m], SHAPE, mode="xor")
    with pytest.raises(ValueError):
        tsd.superdiff_sample(s, [m], SHAPE)
    with pytest.raises(ValueError):
        tsd.superdiff_sample(s, [m, m, m], SHAPE, mode="and")
    with pytest.raises(ValueError):
        tsd.superdiff_sample(s, [m, m], SHAPE, mode="fixed")


def test_toy_unet_superdiff_and_slice_matches_jax():
    """Two differently seeded toy CondUNets, label 0, AND mode, T=4 (each
    step = two denoiser calls + the closed-form kappa)."""
    T = 4
    js_, ts_ = jsch.make_schedule(T), tsch.make_schedule(T, device="cpu")
    kw = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
              attn_resolutions=(8,), num_heads=2, num_classes=2,
              time_emb_dim=16, groups=4)
    shape = (2, 16, 16, 1)
    jm = JaxCondUNet(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape),
                            jnp.zeros((2,), jnp.int32),
                            jnp.zeros((2,), jnp.int32))
    p1 = {"params": random_params(shapes, 21)}
    p2 = {"params": random_params(shapes, 22)}
    jfn = j_make_eps_fn_p(jm, 0)

    def j_run(r, a, b):
        return jsd.superdiff_sample(
            js_, [lambda x, t: jfn(a, x, t), lambda x, t: jfn(b, x, t)],
            shape, r, mode="and")

    jx, jlq = jax.jit(j_run)(jax.random.PRNGKey(12), p1, p2)
    t1 = CondUNet(resolution=16, device="cpu", **kw)
    t2 = CondUNet(resolution=16, device="cpu", **kw)
    load_state_dict(t1, p1)
    load_state_dict(t2, p2)
    tfn = make_eps_fn_p(t1, 0)
    x_init, noise = jax_draws(12, shape, T)
    tx, tlq = tsd.superdiff_sample(
        ts_, [lambda x, t: tfn(t1, x, t), lambda x, t: tfn(t2, x, t)], shape,
        mode="and", x_init=x_init, noise=noise)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tlq.numpy(), np.asarray(jlq), rtol=1e-4,
                               atol=1e-2)
