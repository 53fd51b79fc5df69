"""Device-side batch preparation of the port against the JAX package (CPU):
the augmentation draws are replayed from JAX's key chain and injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.data import transforms as jt
from superdiff_tpu.data.synthetic import synthetic_xray_batch as j_synth
from superdiff_torch.data import transforms as tt
from superdiff_torch.data.synthetic import synthetic_xray_batch

torch.set_num_threads(1)


def _images(B=4, R=32, seed=0):
    imgs, _ = j_synth(B, R, seed=seed, normalization="minmax")
    return imgs.astype(np.float32)


def _jax_draws(key, B, shape, risk):
    """The draws ``superdiff_tpu.data.transforms.augment`` makes from
    ``key``, as numpy arrays under the port's names."""
    keys = jax.random.split(key, 6)
    max_deg = 5.0 if risk == "low" else 15.0
    bc = jax.random.uniform(keys[4], (B, 2, 1, 1, 1), minval=-0.2, maxval=0.2)
    d = {"flip": jax.random.bernoulli(keys[0], 0.5, (B, 1, 1, 1)).reshape(B),
         "angles": jax.random.uniform(keys[1], (B,), minval=-max_deg,
                                      maxval=max_deg) * (jnp.pi / 180.0),
         "rot": jax.random.bernoulli(keys[2], 0.5 if risk == "low" else 1.0,
                                     (B,)),
         "bc": jax.random.bernoulli(keys[3], 0.3 if risk == "low" else 0.4,
                                    (B, 1, 1, 1)).reshape(B),
         "bright": bc[:, 0].reshape(B), "contrast": bc[:, 1].reshape(B)}
    if risk == "low":
        k_noise, k_p, k_sig = jax.random.split(keys[5], 3)
        d["noise_mask"] = jax.random.bernoulli(k_p, 0.2,
                                               (B, 1, 1, 1)).reshape(B)
        d["sigma"] = jax.random.uniform(k_sig, (B, 1, 1, 1), minval=0.01,
                                        maxval=0.05).reshape(B)
        d["noise"] = jax.random.normal(k_noise, shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("mode", ["minmax", "zscore", "tanh", "none"])
def test_normalize_and_denormalize_match_jax(mode):
    x = _images()
    x[0] = 0.25                        # a constant image: minmax's clamp
    n_expect = np.asarray(jt.normalize(jnp.asarray(x), mode))
    n_got = tt.normalize(torch.from_numpy(x), mode)
    np.testing.assert_allclose(n_got.numpy(), n_expect, rtol=1e-6, atol=1e-6)
    d_expect = np.asarray(jt.denormalize(jnp.asarray(n_expect), mode))
    d_got = tt.denormalize(n_got, mode)
    np.testing.assert_allclose(d_got.numpy(), d_expect, rtol=1e-6, atol=1e-6)


def test_unknown_names_raise():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="normalization"):
        tt.normalize(x, "l2")
    with pytest.raises(ValueError, match="high-risk"):
        tt.augment(x, torch.Generator(), risk="high")
    with pytest.raises(ValueError, match="unknown augmentation"):
        tt.augment(x, torch.Generator(), risk="extreme")


@pytest.mark.parametrize("max_deg", [5.0, 15.0])
def test_rotate_shear3_matches_jax(max_deg):
    """Three 1-D bilinear shears, the reference's arithmetic. atol 1e-5:
    each output pixel is a 2-term float32 blend, three times over."""
    x = _images(B=3, R=32, seed=1)
    angles = np.deg2rad(np.array([max_deg, -max_deg / 3, 0.0])).astype(
        np.float32)
    expect = np.asarray(jt._rotate_shear3(jnp.asarray(x), jnp.asarray(angles),
                                          max_deg))
    got = tt._rotate_shear3(torch.from_numpy(x), torch.from_numpy(angles),
                            max_deg)
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), x[2], atol=1e-6)   # angle 0
    assert np.abs(got[0].numpy() - x[0]).max() > 0.05    # it did rotate


@pytest.mark.parametrize("risk", ["low", "medium"])
def test_augment_matches_jax_with_replayed_draws(risk):
    x = _images(B=8, R=32, seed=2)
    key = jax.random.PRNGKey(7 if risk == "low" else 8)
    expect = np.asarray(jt.augment(jnp.asarray(x), key, risk=risk))
    draws = _jax_draws(key, 8, x.shape, risk)
    # the cases each branch needs are present in this batch
    assert draws["flip"].any() and not draws["flip"].all()
    assert draws["bc"].any()
    got = tt.augment(torch.from_numpy(x), None, risk=risk, draws=draws)
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-5)
    assert np.abs(expect - x).max() > 0.05


def test_augment_none_is_identity_and_generator_is_reproducible():
    x = torch.from_numpy(_images(B=4, R=16, seed=3))
    assert tt.augment(x, torch.Generator(), risk="none") is x
    a = tt.augment(x, torch.Generator().manual_seed(1), risk="low")
    b = tt.augment(x, torch.Generator().manual_seed(1), risk="low")
    c = tt.augment(x, torch.Generator().manual_seed(2), risk="low")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0.0 and a.max() <= 1.0


def test_prepare_batch_matches_jax():
    u8 = (_images(B=4, R=32, seed=4) * 255).astype(np.uint8)
    key = jax.random.PRNGKey(21)
    expect = np.asarray(jt.prepare_batch(jnp.asarray(u8), key, "medium",
                                         "tanh"))
    got = tt.prepare_batch(torch.from_numpy(u8), None, "medium", "tanh",
                           draws=_jax_draws(key, 4, u8.shape, "medium"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5)
    # no generator and no draws: clean data (validation)
    clean = tt.prepare_batch(torch.from_numpy(u8), None, "medium", "zscore")
    np.testing.assert_allclose(
        clean.numpy(),
        np.asarray(jt.prepare_batch(jnp.asarray(u8), None, "medium",
                                    "zscore")), atol=1e-6)


def test_synthetic_batch_is_the_same_generator():
    for kw in (dict(seed=0), dict(seed=5, normalization="minmax",
                                  num_classes=3)):
        a_img, a_lab = synthetic_xray_batch(3, 16, **kw)
        b_img, b_lab = j_synth(3, 16, **kw)
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_lab, b_lab)
