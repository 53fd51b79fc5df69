"""The CondUNet's GroupNorm -> (FiLM) -> SiLU chains through kernel B4's
policy mode (CPU side): the plain chain against the code the ResBlock and
the CondUNet ran before they called B4 (bit for bit) and against the JAX
ResBlock's chain, the dispatcher's routes, and B4's launch geometry
(``launch_geometry``) at every main-path and RefUNet shape. The kernel
itself is checked against the plain chain on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from superdiff_torch.models.unet import CondUNet
from superdiff_torch.ops import fused_norm as fn

torch.set_num_threads(1)

# every chain one wide256 call runs at 256²: (H*W, C) with G = 32
MAIN_PATH = [(128 * 128, 128), (128 * 128, 256), (64 * 64, 256),
             (64 * 64, 128), (32 * 32, 384), (32 * 32, 256), (32 * 32, 128),
             (16 * 16, 512), (16 * 16, 384), (16 * 16, 256), (16 * 16, 128),
             (8 * 8, 512), (8 * 8, 256)]
# the RefUNet's chains: 256², float32, (C, G)
REF = [(1, 1), (64, 4), (128, 4)]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _pre_pr_chain(x, gamma, beta, G, nd, scale=None, shift=None, eps=1e-5):
    """The chain as ``GroupNorm.forward`` + ``ResBlock.forward`` /
    ``CondUNet.forward`` computed it before the model called B4, verbatim."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, G, C // G)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    mu2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * gamma.float().view(1, 1, G, C // G)
    y = (xg - mu) * mul + beta.float().view(1, 1, G, C // G)
    h = y.reshape(x.shape).to(nd)
    if scale is not None:
        h = (h * (1.0 + scale.to(nd)[:, None, None, :])
             + shift.to(nd)[:, None, None, :])
    return F.silu(h)


def _inputs(B, H, W, C, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 + 2 * rng.standard_normal((B, H, W, C))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    scale, shift = (0.2 * rng.standard_normal((B, C)).astype(np.float32)
                    for _ in range(2))
    return x, gamma, beta, scale, shift


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("nd", ["bf16", "f32"])
@pytest.mark.parametrize("cd", ["bf16", "f32"])
def test_policy_plain_equals_the_pre_pr_chain_bit_for_bit(cd, nd, film):
    """``gn_film_silu_policy_plain`` is the code the ResBlock and the
    CondUNet ran, moved: the same bits for every (input, norm) dtype pair,
    with and without FiLM, including FiLM operands that are the ResBlock's
    ``cond.chunk(2)`` views."""
    x, gamma, beta, scale, shift = map(torch.from_numpy,
                                       _inputs(2, 6, 5, 32, seed=1))
    x = x.to(DTYPES[cd])
    cond = torch.cat([scale, shift], dim=-1)
    scale, shift = cond.chunk(2, dim=-1) if film else (None, None)
    want = _pre_pr_chain(x, gamma, beta, 8, DTYPES[nd], scale, shift)
    got = fn.gn_film_silu_policy_plain(x, gamma, beta, 8, DTYPES[nd], scale,
                                       shift)
    assert got.dtype == want.dtype == DTYPES[nd]
    assert torch.equal(got, want)
    # the dispatcher takes the plain chain for a CPU tensor: the same bits
    assert torch.equal(fn.gn_film_silu_policy(x, gamma, beta, 8, DTYPES[nd],
                                              scale, shift), want)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("nd", ["bf16", "f32"])
def test_policy_plain_matches_the_jax_resblock_chain(nd, film):
    """Against the JAX ResBlock's chain: ``flax.linen.GroupNorm(dtype=nd)``,
    FiLM in ``nd`` as ``h * (1 + scale) + shift``, ``nn.silu``, on the same
    numpy inputs. float32: only the statistics' summation order differs ->
    1e-5. bfloat16: XLA rounds the FiLM and SiLU steps at its own points (it
    may keep float32 inside a fusion), so values may sit a bf16 ulp or two
    apart (2^-8 relative each) -> rtol 2e-2, atol 2e-2."""
    x, gamma, beta, scale, shift = _inputs(2, 6, 5, 32, seed=2)
    jd = jnp.bfloat16 if nd == "bf16" else jnp.float32
    gn = fnn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jd)
    h = gn.apply({"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x))
    if film:
        h = (h * (1.0 + jnp.asarray(scale).astype(jd)[:, None, None, :])
             + jnp.asarray(shift).astype(jd)[:, None, None, :])
    expect = np.asarray(fnn.silu(h), np.float32)
    got = fn.gn_film_silu_policy_plain(
        *map(torch.from_numpy, (x, gamma, beta)), 8, DTYPES[nd],
        *((torch.from_numpy(scale), torch.from_numpy(shift)) if film
          else (None, None)))
    tol = 2e-2 if nd == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), expect, rtol=tol,
                               atol=tol)


def test_dispatcher_routes_cpu_to_plain_and_gradients_to_autograd():
    """A CPU tensor takes the plain chain and launches nothing; with a
    gradient wanted (even at the float32 norm dtype, where a CUDA tensor
    takes B4's backward kernel) the plain chain runs under autograd (its
    gradients are autograd's of the plain chain) and neither B4's forward
    nor its backward is counted; under no_grad no graph is built."""
    x, gamma, beta, scale, shift = map(torch.from_numpy,
                                       _inputs(2, 4, 4, 16, seed=3))
    fn.reset_launches()
    leaves = [a.clone().requires_grad_() for a in (x, gamma, beta, scale,
                                                    shift)]
    y = fn.gn_film_silu_policy(leaves[0], leaves[1], leaves[2], 4,
                               torch.float32, leaves[3], leaves[4])
    assert y.grad_fn is not None
    assert "PolicyChainFn" not in type(y.grad_fn).__name__
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(y, leaves, g)
    want = torch.autograd.grad(
        _pre_pr_chain(leaves[0], leaves[1], leaves[2], 4, torch.float32,
                      leaves[3], leaves[4]), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        y = fn.gn_film_silu_policy(leaves[0], leaves[1], leaves[2], 4,
                                   torch.float32, leaves[3], leaves[4])
    assert y.grad_fn is None
    assert fn.launches == 0 and fn.launches_by_shape == {}
    assert fn.bwd_launches == 0 and fn.bwd_launches_by_shape == {}
    with pytest.raises(ValueError, match="divisible"):
        fn.gn_film_silu_policy(x, gamma, beta, 5, torch.float32)
    with pytest.raises(ValueError, match="together"):
        fn.gn_film_silu_policy(x, gamma, beta, 4, torch.float32, scale)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("C,G", [(16, 16), (16, 4), (32, 2)])
def test_policy_backward_plain_matches_autograd_of_the_plain_chain(C, G,
                                                                   film):
    """``gn_film_silu_policy_backward_plain`` (the closed form B4's backward
    kernel computes) against autograd of ``gn_film_silu_policy_plain`` at a
    float32 norm dtype: group widths 1, 4 and 16, with and without FiLM
    (``cond.chunk(2)`` views), 5 x 7 positions (a length that is not a
    multiple of 8). float32 throughout; the two differ in the order of
    their sums and in the variance's derivative (the closed form's mean
    subtraction against autograd's E[x^2] - E[x]^2 terms) -> 1e-4 of each
    gradient's largest value."""
    x, gamma, beta, scale, shift = map(torch.from_numpy,
                                       _inputs(3, 5, 7, C, seed=C + G))
    cond = torch.cat([scale, shift], dim=-1)
    scale, shift = cond.chunk(2, dim=-1) if film else (None, None)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(G))
    leaves = [a if a is None else a.clone().requires_grad_()
              for a in (x, gamma, beta, scale, shift)]
    y = fn.gn_film_silu_policy_plain(leaves[0], leaves[1], leaves[2], G,
                                     torch.float32, leaves[3], leaves[4])
    want = torch.autograd.grad(y, [a for a in leaves if a is not None], g)
    got = fn.gn_film_silu_policy_backward_plain(x, g, gamma, beta, G, scale,
                                                shift)
    assert (got[3] is None) == (got[4] is None) == (not film)
    for a, b in zip([a for a in got if a is not None], want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * b.abs().max().item())


def test_condunet_runs_every_silu_chain_through_the_dispatcher(monkeypatch):
    """Every ResBlock's two chains and the CondUNet's ``out_norm`` go
    through ``gn_film_silu_policy`` (FiLM on ``norm_1`` only) in the
    model's ``norm_dtype``; the attention norm (no SiLU) does not."""
    calls = []
    real = fn.gn_film_silu_policy

    def spy(x, gamma, beta, G, nd, scale=None, shift=None, eps=1e-5):
        calls.append((x.shape[-1], G, nd, scale is not None))
        return real(x, gamma, beta, G, nd, scale, shift, eps)

    monkeypatch.setattr(fn, "gn_film_silu_policy", spy)
    m = CondUNet(resolution=16, base_channels=8, channel_mults=(1, 2),
                 num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
                 num_classes=2, time_emb_dim=16, groups=4, device="cpu",
                 compute_dtype=torch.bfloat16).init_parameters(0)
    m.set_norm_dtype(torch.bfloat16)
    with torch.no_grad():
        m(torch.zeros((1, 16, 16, 1)), torch.tensor([3]), torch.tensor([0]))
    n_res = sum(1 for k in dict(m.named_modules()) if k.endswith("norm_1"))
    assert len(calls) == 2 * n_res + 1
    assert sum(film for *_, film in calls) == n_res
    assert {nd for _, _, nd, _ in calls} == {torch.bfloat16}


def _check_geometry(geo, B, hw, C, G, elem):
    n = hw * C
    step = geo.threads * geo.vec
    assert step % C == 0 and (step // C) & (step // C - 1) == 0
    if geo.regime == "three_pass":
        assert (geo.tiles - 1) * geo.iters * step < n <= (
            geo.tiles * geo.iters * step)
        return
    assert geo.cluster in (4, 8, 16) and geo.threads <= 256
    assert geo.cluster * geo.iters * step >= n > (
        geo.cluster * (geo.iters - 1) * step)
    # as many steps resident as the block's shared memory holds
    fixed = fn._cluster_fixed_bytes(step, C, G)
    assert 0 <= geo.resident <= geo.iters
    assert geo.smem == fixed + geo.resident * step * elem <= fn._CLUSTER_SMEM
    assert geo.resident == geo.iters or (
        geo.smem + step * elem > fn._CLUSTER_SMEM)


@pytest.mark.parametrize("B", [16, 4])
@pytest.mark.parametrize("hw,C", MAIN_PATH)
def test_geometry_of_every_main_path_shape(hw, C, B):
    """Every CondUNet chain shape at batch 16 and 4, bf16 in and out (the
    sampling policy) and bf16 -> float32: up to 32 MB of x in the batch the
    cluster regime with 16-byte vectors, blocks covering each sample
    exactly once, 4 / 8 / 16 blocks per sample up to 512 KB / 2 MB / above,
    as many steps resident as a block's shared memory holds; at batch 16
    the 128² shapes (64 and 128 MB) take the three-pass regime."""
    for out in (torch.bfloat16, torch.float32):
        geo = fn.launch_geometry(B, hw, C, 32, torch.bfloat16, out, True)
        _check_geometry(geo, B, hw, C, 32, 2)
        sample = hw * C * 2
        if B * sample > 32 << 20:
            assert geo.regime == "three_pass" and hw == 128 * 128
            continue
        assert geo.regime == "cluster" and geo.vec == 8
        assert geo.cluster == (4 if sample <= 512 << 10 else
                               8 if sample <= 2 << 20 else 16)


@pytest.mark.parametrize("B", [16, 4])
@pytest.mark.parametrize("hw,C", MAIN_PATH)
def test_backward_geometry_of_every_main_path_shape(hw, C, B):
    """B4's backward at every CondUNet chain shape, bf16 x: 16 bytes of g
    per load (vec 4); up to 64 MiB of x and g in the batch the cluster
    regime (blocks covering each sample exactly once, nothing resident, 4 /
    8 / 16 blocks per sample up to 512 KB / 2 MB / above of x and g), else
    the three-pass one; at batch 16 the 128² shapes and 64²×256 take three
    passes."""
    geo = fn.backward_geometry(B, hw, C, 32, torch.bfloat16, True)
    n, step = hw * C, geo.threads * geo.vec
    assert step % C == 0 and (step // C) & (step // C - 1) == 0
    assert geo.vec == 4 and geo.resident == 0
    blocks = geo.tiles if geo.regime == "three_pass" else geo.cluster
    assert (blocks - 1) * geo.iters * step < n <= blocks * geo.iters * step
    sample = hw * C * 6
    if B * sample > 64 << 20:
        assert geo.regime == "three_pass"
        assert B == 4 or hw == 128 * 128 or (hw, C) == (64 * 64, 256)
        return
    assert geo.regime == "cluster"
    assert geo.smem == fn._cluster_fixed_bytes(geo.threads * geo.vec, C, 32)
    assert geo.cluster == (4 if sample <= 512 << 10 else
                           8 if sample <= 2 << 20 else 16)


@pytest.mark.parametrize("C,G", REF)
def test_geometry_of_the_refunet_shapes(C, G):
    """The RefUNet's float32 chains at batch 16, 256²: C1 in the cluster
    regime, C64 and C128 (16 and 32 MB per sample) in the three-pass one,
    which keeps its earlier geometry (1024 blocks)."""
    geo = fn.launch_geometry(16, 65536, C, G, torch.float32, torch.float32,
                             True)
    _check_geometry(geo, 16, 65536, C, G, 4)
    assert geo.regime == ("cluster" if C == 1 else "three_pass")
    if geo.regime == "three_pass":
        assert 16 * geo.tiles == 1024
        assert (geo.vec, geo.threads, geo.iters, geo.tiles) == fn._geometry(
            16, 65536, C, 4, True)


@pytest.mark.parametrize("B,hw,C,G,dtype,aligned", [
    (2, 63, 64, 4, torch.float32, True), (1, 63, 1, 1, torch.float32, True),
    (3, 25, 3, 1, torch.bfloat16, True), (2, 64, 32, 8, torch.float32, False),
    (4, 4096, 48, 16, torch.bfloat16, True)])
def test_cluster_blocks_cover_each_element_once_with_fixed_channels(
        B, hw, C, G, dtype, aligned):
    """The cluster kernel's indexing (csrc/group_norm_silu.cu::gn_cluster),
    replayed in numpy over the geometry: block ``rank``'s thread ``t``
    covers element ``rank * iters * S + it * S + t * vec + j`` for every
    step ``it`` and lane ``j`` while the vector starts inside the sample;
    every element is covered once, always by a slot of its own channel.
    Ragged lengths take scalar loads."""
    geo = fn.launch_geometry(B, hw, C, G, dtype, dtype, aligned, "cluster")
    n, step = hw * C, geo.threads * geo.vec
    assert geo.vec == (16 // (2 if dtype == torch.bfloat16 else 4)
                       if n % (16 // (2 if dtype == torch.bfloat16 else 4))
                       == 0 and aligned else 1)
    cover = np.zeros(n, np.int64)
    t = np.arange(geo.threads)
    for rank in range(geo.cluster):
        for it in range(geo.iters):
            start = rank * geo.iters * step + it * step + t * geo.vec
            live = start < n
            for j in range(geo.vec):
                e = start[live] + j
                assert (e < n).all()
                assert ((t[live] * geo.vec + j) % C == e % C).all()
                np.add.at(cover, e, 1)
    assert (cover == 1).all()


def test_geometry_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="bfloat16/float32"):
        fn.launch_geometry(16, 64, 256, 32, torch.float16, torch.float16,
                           True)
    with pytest.raises(ValueError, match="bfloat16/float32"):
        fn.launch_geometry(16, 64, 256, 32, torch.bfloat16, torch.float64,
                           True)
    with pytest.raises(ValueError, match="divisible"):
        fn.launch_geometry(16, 64, 256, 24, torch.bfloat16, torch.bfloat16,
                           True)
    with pytest.raises(ValueError, match="regime"):
        fn.launch_geometry(16, 64, 256, 32, torch.bfloat16, torch.bfloat16,
                           True, "two_pass")
    with pytest.raises(ValueError, match="cluster kernel"):
        fn.launch_geometry(1, 4, 4096, 32, torch.float32, torch.float32,
                           True, "cluster")
    # the default picks the three-pass regime where the cluster one cannot
    assert fn.launch_geometry(1, 4, 4096, 32, torch.float32, torch.float32,
                              True).regime == "three_pass"
