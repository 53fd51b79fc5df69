"""Fused GroupNorm(+FiLM)+SiLU of the port (kernel B4's plain version, its
autograd Function, the modules and the packed chain) against the JAX
package on the CPU: ``_xla_gn_silu``, the Pallas kernel in interpret mode,
``jax.grad``, ``GroupNormSiLU`` / ``NormAct`` and ``groupnorm_film_silu``.
The CUDA kernel itself is checked on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``; its launch geometry (Python) is checked here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.models import layers as jl
from superdiff_tpu.ops.fused_norm import _xla_gn_silu
from superdiff_tpu.ops.fused_norm import fused_groupnorm_silu as j_fused
from superdiff_tpu.ops.packed_norm import groupnorm_film_silu as j_packed
from superdiff_torch.compat.flax_params import from_flax
from superdiff_torch.models import layers as tl
from superdiff_torch.ops import fused_norm as fn
from superdiff_torch.ops.packed_norm import groupnorm_film_silu

torch.set_num_threads(1)

# jitted, one compile per shape (eager JAX compiles every primitive apart)
_xla = jax.jit(_xla_gn_silu, static_argnums=(5, 6))


def _inputs(B, H, W, C, film, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 + 2 * rng.standard_normal((B, H, W, C))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    if not film:
        return x, gamma, beta, None, None
    scale, shift = (0.2 * rng.standard_normal((B, C)).astype(np.float32)
                    for _ in range(2))
    return x, gamma, beta, scale, shift


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("G,C,film", [(8, 32, True), (8, 32, False),
                                      (16, 48, True), (1, 1, False),
                                      (4, 128, False)])
def test_plain_matches_xla_and_pallas_interpret(G, C, film):
    """The plain op (what a CPU tensor runs) against ``_xla_gn_silu`` and
    the TPU kernel in interpret mode, incl. group width 3 (C=48, G=16) and
    1 (C=G=1, the RefUNet's first and last norm). float32 on all sides;
    the sums run in other orders -> rtol 1e-4, atol 1e-5."""
    arrays = _inputs(2, 8, 8, C, film, seed=C + G)
    got = fn.fused_groupnorm_silu(*_t(arrays[:3]), G, *_t(arrays[3:]))
    x, gamma, beta, scale, shift = _j(arrays)
    for expect in (_xla(x, gamma, beta, scale, shift, G, 1e-5),
                   j_fused(x, gamma, beta, G, scale, shift, force="pallas",
                           interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-4, atol=1e-5)


def test_bf16_matches_xla():
    """bfloat16 x: float32 statistics and math, one rounding of the output
    on both sides; results may sit one bf16 ulp apart -> 5e-2."""
    arrays = _inputs(2, 8, 8, 32, True, seed=5)
    tx = torch.from_numpy(arrays[0]).to(torch.bfloat16)
    got = fn.fused_groupnorm_silu(tx, *_t(arrays[1:3]), 8, *_t(arrays[3:]))
    assert got.dtype == torch.bfloat16
    x, gamma, beta, scale, shift = _j(arrays)
    expect = _xla(x.astype(jnp.bfloat16), gamma, beta, scale, shift, 8,
                  1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_gradients_of_all_inputs_match_jax_grad():
    """Gradients of x, gamma, beta, scale and shift through
    ``GroupNormSiLUFn`` (plain forward on the CPU, autograd of the plain
    version backward) against ``jax.grad`` of ``_xla_gn_silu``."""
    arrays = _inputs(2, 4, 4, 48, True, seed=7)
    w = np.random.default_rng(8).standard_normal(arrays[0].shape).astype(
        np.float32)
    leaves = [a.requires_grad_() for a in _t(arrays)]
    y = fn.GroupNormSiLUFn.apply(leaves[0], leaves[1], leaves[2], leaves[3],
                                 leaves[4], 16, 1e-5)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    loss = lambda *a: jnp.sum(_xla_gn_silu(*a, 16, 1e-5) * w)
    expect = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*_j(arrays))
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-3,
                                   atol=1e-4)


def test_validation_and_wrapper_rules_on_cpu():
    x, gamma, beta, scale, shift = _t(_inputs(2, 4, 4, 32, True))
    with pytest.raises(ValueError, match="divisible"):
        fn.fused_groupnorm_silu(x, gamma, beta, 7)
    with pytest.raises(ValueError, match="together"):
        fn.fused_groupnorm_silu(x, gamma, beta, 8, scale, None)
    with pytest.raises(ValueError, match="gamma"):
        fn.fused_groupnorm_silu(x, gamma[:4], beta, 8)
    with pytest.raises(ValueError, match="scale and shift must be"):
        fn.fused_groupnorm_silu(x, gamma, beta, 8, scale[:1], shift[:1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn.fused_groupnorm_silu(x.to("meta"), gamma.to("meta"),
                                beta.to("meta"), 8)
    # a CPU tensor takes the plain version and launches nothing
    fn.reset_launches()
    torch.testing.assert_close(
        fn.fused_groupnorm_silu(x, gamma, beta, 8, scale, shift),
        fn.gn_silu_plain(x, gamma, beta, 8, scale, shift), rtol=0, atol=0)
    assert fn.launches == 0 and fn.launches_by_shape == {}


@pytest.mark.parametrize("B,hw,C,elem,aligned", [
    (16, 65536, 1, 4, True), (16, 65536, 64, 4, True),
    (16, 65536, 128, 2, True), (4, 4096, 48, 4, True),
    (4, 1024, 384, 2, True), (2, 63, 64, 4, True), (1, 63, 1, 4, True),
    (3, 25, 3, 2, True), (2, 64, 32, 4, False), (1, 4, 4096, 4, True)])
def test_kernel_geometry(B, hw, C, elem, aligned):
    """The launch geometry the wrapper hands the kernel: 16-byte vectors
    only when the flat length and the address allow them; each block step
    is C * 2^p elements (fixed channels per thread, a power-of-two tree per
    channel); the tiles cover every element exactly once; the RefUNet's
    batch-16 shapes get 1024 blocks."""
    vec, threads, iters, tiles = fn._geometry(B, hw, C, elem, aligned)
    n, step = hw * C, threads * vec
    assert vec == (16 // elem if n % (16 // elem) == 0 and aligned else 1)
    assert step % C == 0 and (step // C) & (step // C - 1) == 0
    assert threads <= 1024 and step <= 4096
    assert (tiles - 1) * iters * step < n <= tiles * iters * step
    if hw == 65536:
        assert B * tiles == 1024
    with pytest.raises(ValueError, match="block step"):
        fn._geometry(1, 4, 4097, 4, True)


def _bridge(module, tree):
    """Load one norm's Flax ``{scale, bias}`` into the port's module."""
    sd = from_flax({"norm": tree})
    module.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return module


@pytest.mark.parametrize("kind", ["GroupNormSiLU", "NormAct"])
def test_modules_match_jax_modules(kind):
    """``GroupNormSiLU`` and ``NormAct`` against the JAX modules (the JAX
    ``GroupNormSiLU`` with ``fused=True``) on the same weights (bridged from
    the Flax tree), with FiLM."""
    x, gamma, beta, scale, shift = _inputs(2, 4, 8, 32, True, seed=3)
    tree = {"scale": gamma, "bias": beta}
    if kind == "GroupNormSiLU":
        jm, tm = jl.GroupNormSiLU(8, fused=True), tl.GroupNormSiLU(
            8, 32, device="cpu")
    else:
        jm, tm = jl.NormAct(8), tl.NormAct(8, 32, device="cpu")
    expect = jm.apply({"params": tree}, *_j((x, scale, shift)))
    with torch.no_grad():
        got = _bridge(tm, tree)(*_t((x, scale, shift)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-5)


def test_packed_chain_ignores_pack_and_matches_jax():
    """``groupnorm_film_silu``: ``pack=True`` equals ``pack=False`` (the
    fold is a TPU layout device), both equal the JAX function with the
    fold engaged, and ``out_dtype`` casts the result."""
    arrays = _inputs(2, 8, 8, 64, True, seed=11)
    args = _t(arrays)
    a = groupnorm_film_silu(args[0], args[1], args[2], 32, film_scale=args[3],
                            film_shift=args[4], pack=False)
    b = groupnorm_film_silu(args[0], args[1], args[2], 32, film_scale=args[3],
                            film_shift=args[4], pack=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    x, gamma, beta, scale, shift = _j(arrays)
    expect = j_packed(x, gamma, beta, 32, film_scale=scale, film_shift=shift,
                      pack=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-5)
    c = groupnorm_film_silu(args[0], args[1], args[2], 32,
                            out_dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="divisible"):
        groupnorm_film_silu(args[0], args[1], args[2], 7)
