"""Training losses of the port against the JAX package (CPU, float32): the
same schedule, images, timesteps and noise go through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion import process as jp
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.diffusion import process as tp

torch.set_num_threads(1)

T = 50


def _data(seed=0, B=4, R=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, R, R, 1)).astype(np.float32)
    noise = rng.standard_normal((B, R, R, 1)).astype(np.float32)
    t = np.array([0, 7, 30, T - 1])[:B]
    return x, noise, t


def _model(xp):
    """A cheap stand-in denoiser with the same arithmetic in both packages:
    it sees x_t, t and (optionally) y."""
    def fn(x, t, y=None):
        shift = t.reshape(-1, 1, 1, 1) / float(T)
        out = 0.7 * x - 0.2 * shift + 0.05 * x * x
        if y is not None:
            out = out + 0.1 * y.reshape(-1, 1, 1, 1)
        return out
    return fn


@pytest.mark.parametrize("kind", ["eps", "v", "x0"])
@pytest.mark.parametrize("weighting", ["none", "min_snr"])
def test_loss_weights_match_jax(kind, weighting):
    """rtol 1e-6: the same float32 table lookups and divisions."""
    t = np.array([0, 1, 10, 25, T - 1])
    js, ts = j_make_schedule(T), make_schedule(T, device="cpu")
    expect = np.asarray(jp.loss_weights(js, jnp.asarray(t), weighting, 5.0,
                                        kind))
    got = tp.loss_weights(ts, torch.from_numpy(t), weighting, 5.0, kind)
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-6)


def test_loss_weights_reject_unknown_names():
    ts = make_schedule(T, device="cpu")
    t = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="weighting"):
        tp.loss_weights(ts, t, "snr")
    with pytest.raises(ValueError, match="parameterization"):
        tp.loss_weights(ts, t, "min_snr", parameterization="score")
    with pytest.raises(ValueError, match="loss_type"):
        tp.p_losses(ts, _model(torch), torch.zeros(2, 4, 4, 1), t,
                    noise=torch.zeros(2, 4, 4, 1), loss_type="l1")


@pytest.mark.parametrize("kind", ["eps", "v", "x0"])
@pytest.mark.parametrize("loss_type,weighting", [
    ("mse", "none"), ("huber", "none"), ("mse", "min_snr"),
    ("huber", "min_snr")])
def test_p_losses_match_jax(kind, loss_type, weighting):
    """JAX draws its noise from a key; the port gets the same array
    injected. rtol 1e-5: float32 means summed in a different order."""
    x, _, t = _data()
    js, ts = j_make_schedule(T), make_schedule(T, device="cpu")
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    y = np.array([0, 1, 2, 1])
    # scale the stand-in's output so huber sees both of its branches
    jfn = lambda *a: 3.0 * _model(jnp)(*a)
    tfn = lambda *a: 3.0 * _model(torch)(*a)
    expect = float(jp.p_losses(js, jfn, jnp.asarray(x), jnp.asarray(t), key,
                               y=jnp.asarray(y), loss_type=loss_type,
                               weighting=weighting, parameterization=kind))
    got = tp.p_losses(ts, tfn, torch.from_numpy(x), torch.from_numpy(t),
                      y=torch.from_numpy(y), loss_type=loss_type,
                      weighting=weighting, parameterization=kind,
                      noise=torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), expect, rtol=1e-5)


def test_training_step_matches_jax_with_replayed_draws():
    """``training_step`` splits its key into (t, noise); replaying that
    split and injecting both gives JAX's loss."""
    x, _, _ = _data(1)
    js, ts = j_make_schedule(T), make_schedule(T, device="cpu")
    key = jax.random.PRNGKey(11)
    rng_t, rng_noise = jax.random.split(key)
    t = np.array(jax.random.randint(rng_t, (x.shape[0],), 0, T))
    noise = np.array(jax.random.normal(rng_noise, x.shape, jnp.float32))
    expect = float(jp.training_step(js, _model(jnp), jnp.asarray(x), key,
                                    weighting="min_snr",
                                    parameterization="v"))
    got = tp.training_step(ts, _model(torch), torch.from_numpy(x),
                           weighting="min_snr", parameterization="v",
                           t=torch.from_numpy(t),
                           noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), expect, rtol=1e-5)


def test_training_step_draws_from_the_generator_in_order():
    """Without injection: t first, then the noise, both from the generator;
    the same seed gives the same loss and the draws are in range."""
    x = torch.from_numpy(_data(2)[0])
    ts = make_schedule(T, device="cpu")
    seen = {}

    def fn(xt, t):
        seen["t"] = t
        return xt

    a = tp.training_step(ts, fn, x, torch.Generator().manual_seed(5))
    b = tp.training_step(ts, fn, x, torch.Generator().manual_seed(5))
    assert a.item() == b.item() and np.isfinite(a.item())
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, T, (x.shape[0],), generator=g)
    assert torch.equal(seen["t"], t)
    assert seen["t"].min() >= 0 and seen["t"].max() < T
    noise = torch.randn(x.shape, generator=g)
    c = tp.p_losses(ts, fn, x, t, noise=noise)
    assert c.item() == a.item()
