"""Parity of the superdiff_torch models with the JAX package (CPU).

The same seeded numpy weights (every leaf random, so no zero-initialised
layer hides another) and the same inputs go through the Flax module and the
port. JAX's ``model.apply`` is jitted: for the toy net that costs ~1 s here
against ~8 s of eager per-primitive dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from superdiff_tpu.inference import cast_sampling_params as j_cast
from superdiff_tpu.models import layers as jl
from superdiff_tpu.models.presets import build_model as j_build_model
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.models.unet import depth_to_space as j_d2s
from superdiff_tpu.models.unet import space_to_depth as j_s2d
from superdiff_torch.compat.flax_params import (
    from_flax, load_state_dict, random_params, torch_key)
from superdiff_torch.inference import apply_sampling_policy
from superdiff_torch.models import layers as tl
from superdiff_torch.models.presets import build_model
from superdiff_torch.models.unet import CondUNet, depth_to_space, space_to_depth

torch.set_num_threads(1)

# the __graft_entry__.py toy CondUNet (16², attention mirrored into the up
# path because up_attn_resolutions is None)
TOY = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attn_resolutions=(8,), num_heads=2, num_classes=2,
           time_emb_dim=16, groups=4)
# wide256's structure at toy width: pixel shuffle with C=2 (channel order),
# per-level num_res_blocks, narrower up-path attention, and head dims 32/64
# so attention goes through the flash wrapper (its plain version on CPU)
WIDE_TOY = dict(base_channels=32, channel_mults=(1, 1, 2),
                num_res_blocks=(1, 2, 1), attn_resolutions=(8, 4),
                up_attn_resolutions=(4,), num_heads=1, num_classes=2,
                time_emb_dim=16, groups=4, pixel_shuffle=2, in_channels=2,
                out_channels=2)


def _inputs(B, R, C, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, R, C)).astype(np.float32)
    t = rng.integers(0, 1000, size=(B,))
    y = rng.integers(0, 3, size=(B,))
    return x, t, y


def _flax_params(model, B, R, C, seed=1):
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((B, R, R, C)),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))
    return {"params": random_params(shapes, seed)}


def _jax_eps(model, params, x, t, y):
    return np.asarray(jax.jit(model.apply)(
        params, jnp.asarray(x), jnp.asarray(t, jnp.int32),
        jnp.asarray(y, jnp.int32)), dtype=np.float32)


def _torch_eps(model, x, t, y):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(y)).float().numpy()


@pytest.mark.parametrize("kw,R", [(TOY, 16), (WIDE_TOY, 32)],
                         ids=["toy16", "wide256_shaped32"])
def test_condunet_matches_flax(kw, R):
    C = kw.get("in_channels", 1)
    x, t, y = _inputs(2, R, C)
    jm = JaxCondUNet(**kw)
    params = _flax_params(jm, 2, R, C)
    expect = _jax_eps(jm, params, x, t, y)
    tm = CondUNet(resolution=R, device="cpu", **kw)
    load_state_dict(tm, params)
    got = _torch_eps(tm, x, t, y)
    assert got.shape == expect.shape
    assert np.abs(expect).max() > 0.1       # the random weights reach the out
    # float32 on both sides; only summation order differs across ~30 layers
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_sampling_policy_bf16_matches_flax():
    """bf16 weights + bf16 norm passes on both sides. Tolerance: bf16 keeps
    8 mantissa bits (rel. 4e-3 per rounding); rounding points differ between
    XLA and torch (conv accumulation, bias add), so compare the relative L2
    error at 3e-2 and check the cast leaves are the same set."""
    x, t, y = _inputs(2, 32, 2)
    jm = JaxCondUNet(compute_dtype=jnp.bfloat16, **WIDE_TOY)
    params = _flax_params(jm, 2, 32, 2)
    jm_inf = jm.clone(norm_dtype=jnp.bfloat16)
    jp = j_cast(params)
    expect = _jax_eps(jm_inf, jp, x, t, y)
    tm = CondUNet(resolution=32, device="cpu", compute_dtype=torch.bfloat16,
                  **WIDE_TOY)
    load_state_dict(tm, params)
    apply_sampling_policy(tm)
    got = _torch_eps(tm, x, t, y)
    rel = np.linalg.norm(got - expect) / np.linalg.norm(expect)
    assert rel < 3e-2, rel

    j_bf16 = {torch_key(tuple(k.key for k in p)[1:], leaf.ndim)[0]
              for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]
              if leaf.dtype == jnp.bfloat16}
    t_bf16 = {n for n, p in tm.named_parameters() if p.dtype == torch.bfloat16}
    assert j_bf16 == t_bf16 and j_bf16


def test_wide256_parameters_match_flax_tree():
    """Full-width flagship: every key and shape of the port's state_dict
    equals the Flax tree's, converted (no forward is run)."""
    jm = j_build_model("wide256", num_classes=2)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 1)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))["params"]
    expect = {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key, perm = torch_key(tuple(k.key for k in p), len(leaf.shape))
        expect[key] = tuple(leaf.shape[i] for i in perm) if perm else tuple(
            leaf.shape)
    tm = build_model("wide256", num_classes=2, device="meta")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == expect
    assert sum(int(np.prod(s)) for s in got.values()) == 38_624_004
    # 8 attention layers: 2 + 2 in the down path, mid, 3 in the up path
    attn = [k for k in got if k.endswith("qkv.weight")]
    assert len(attn) == 8, attn


def test_space_to_depth_channel_order():
    """Channel index (ph*p + pw)*C + c as in JAX; pixel_unshuffle's order
    (c*p*p + ph*p + pw) agrees only for C = 1."""
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    got = space_to_depth(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_s2d(x, 2)))
    np.testing.assert_array_equal(depth_to_space(got, 2).numpy(), x)
    np.testing.assert_array_equal(
        depth_to_space(got, 2).numpy(),
        np.asarray(j_d2s(np.asarray(j_s2d(x, 2)), 2)))
    unshuf = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not torch.equal(unshuf, got)


@pytest.mark.parametrize("size", [8, 7])
def test_downsample_same_padding(size):
    """Flax SAME on a stride-2 3x3 conv pads (0, 1) on even sizes (1, 1)
    on odd ones; exact to float32 rounding."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    jd = jl.Downsample()
    params = random_params(jax.eval_shape(
        jd.init, jax.random.PRNGKey(0), jnp.zeros(x.shape)), 3)
    expect = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    td = tl.Downsample(4, device="cpu")
    td.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = td(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mean", [0.0, 3.0])
def test_groupnorm_matches_flax(mean):
    """Statistics E[x] and E[x^2] in float32, variance E[x^2] - E[x]^2
    clipped at 0, eps 1e-5, as Flax computes them. The last group is
    constant, where the clip keeps the output at the bias (no NaN).
    Tolerance 1e-5: both reduce in float32, in different orders."""
    rng = np.random.default_rng(3)
    x = (mean + rng.standard_normal((2, 4, 4, 16))).astype(np.float32)
    x[..., 12:] = 0.3
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=4, epsilon=1e-5)
    expect = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}},
                                 jnp.asarray(x)))
    tg = tl.GroupNorm(4, 16, device="cpu")
    tg.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = tg(torch.from_numpy(x), torch.float32).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[..., 12:], np.broadcast_to(
        bias[12:], got[..., 12:].shape), atol=1e-3)


def test_time_embedding_matches_flax():
    t = np.array([0, 1, 17, 999])
    expect = np.asarray(jl.sinusoidal_time_embedding(jnp.asarray(t), 32))
    got = tl.sinusoidal_time_embedding(torch.from_numpy(t), 32).numpy()
    # sin/cos of float32 arguments up to 999 rad, whose ulp is 6e-5
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-4)


def test_ref_preset_not_ported_and_model_needs_labels():
    """``"ref"`` builds the unconditional RefUNet from its own graph fields
    (the CondUNet-only ones are dropped); the CondUNet needs labels."""
    from superdiff_torch.models.unet_ref import RefUNet

    ref = build_model("ref", device="cpu", base_channels=8, dropout=0.1,
                      remat=True, num_classes=2)
    assert isinstance(ref, RefUNet) and not hasattr(ref, "num_classes")
    out = ref(torch.zeros(1, 8, 8, 1), torch.zeros(1, dtype=torch.long))
    assert out.shape == (1, 8, 8, 1)
    tm = CondUNet(resolution=16, device="cpu", **TOY)
    with pytest.raises(ValueError, match="requires labels"):
        tm(torch.zeros(1, 16, 16, 1), torch.zeros(1, dtype=torch.long))
