"""Flash attention of the port, forward and backward: the plain versions
against the JAX Pallas kernels (interpret mode on CPU) and ``_xla_attention``,
the autograd Function, and the wrapper's rules on CPU. The CUDA kernels
themselves are checked on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superdiff_tpu.ops.attention import _xla_attention
from superdiff_tpu.ops.flash_attention import _flash_backward as j_flash_backward
from superdiff_tpu.ops.flash_attention import _flash_forward as j_flash_forward
from superdiff_torch.ops import flash_attention as fa
from superdiff_torch.ops.attention import _math_attention, multihead_attention

torch.set_num_threads(1)


def _qkv(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,D,block_k", [(256, 64, None), (1024, 32, "256")],
                         ids=["S256_D64", "S1024_D32_bk256"])
def test_plain_matches_pallas_kernel_interpret(monkeypatch, S, D, block_k):
    """out and lse of the plain version against the TPU kernel run in
    interpret mode. With SUPERDIFF_TPU_FLASH_BK=256 the S=1024 case spans 4
    K blocks, so the kernel's online-softmax carry runs. Tolerance 1e-5:
    float32 on both sides, softmax summed in a different order."""
    if block_k:
        monkeypatch.setenv("SUPERDIFF_TPU_FLASH_BK", block_k)
    q, k, v = _qkv(1, S, 2, D)
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = j_flash_forward(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    out, lse = fa._flash_forward(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,D", [(64, 32), (100, 64), (256, 128)])
def test_plain_and_math_match_xla_attention(S, D):
    """The port's two plain paths against ``_xla_attention`` (float32),
    including a ragged S; lse against a float64 numpy logsumexp."""
    q, k, v = _qkv(2, S, 2, D, seed=S)
    expect = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    out, lse = fa._flash_forward(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_math_attention(*_t(q, k, v)).numpy(), expect,
                               rtol=1e-5, atol=1e-5)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(D)
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(2 * 2, S),
                               rtol=1e-5, atol=1e-5)


def test_plain_bf16_rounds_p_like_the_kernel():
    """bf16 inputs: P is rounded to bf16 before P.V, as in the TPU kernel
    and ``_xla_attention``; outputs agree to bf16 resolution (2^-8)."""
    q, k, v = _qkv(1, 128, 2, 32, seed=5)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    expect = np.asarray(_xla_attention(qb, kb, vb).astype(jnp.float32))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    out, lse = fa._flash_forward(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), expect, rtol=2e-2,
                               atol=2e-2)


def test_wrapper_rules_on_cpu():
    fa.reset_launches()
    q, k, v = _t(*_qkv(1, 64, 2, 48))
    # D=48: the kernel does not take it -> the dispatcher's math path
    np.testing.assert_allclose(multihead_attention(q, k, v).numpy(),
                               _math_attention(q, k, v).numpy())
    with pytest.raises(ValueError, match="D in"):
        fa._flash_forward_cuda(q, k, v)       # raises before touching CUDA
    with pytest.raises(ValueError, match="shape"):
        fa._flash_forward(q, k[:, :32], v)
    # CPU tensors take the plain version and never count as launches
    q, k, v = _t(*_qkv(1, 64, 2, 32))
    np.testing.assert_allclose(multihead_attention(q, k, v).numpy(),
                               fa._flash_forward_plain(q, k, v)[0].numpy())
    assert fa.launches == 0 and not fa.launches_by_shape


# ---------------------------------------------------------------- backward

@pytest.mark.parametrize("S,D", [(256, 64), (1024, 32)],
                         ids=["S256_D64", "S1024_D32_multi_block"])
def test_backward_plain_matches_pallas_kernels_interpret(S, D):
    """dQ, dK, dV of the plain version against the two TPU backward kernels
    run in interpret mode on the same (q, k, v, out, lse, dO); S=1024 spans
    4 Q blocks x 2 K blocks, so the accumulator carries run. float32,
    rtol/atol 2e-3 as ``tests/test_ops.py`` holds the kernels to."""
    q, k, v = _qkv(1, S, 2, D, seed=S)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = j_flash_forward(*(jnp.asarray(a) for a in (q, k, v)))
        expect = j_flash_backward(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), j_out, j_lse,
                                  jnp.asarray(g))
    out, lse = (torch.from_numpy(np.array(j_out)),
                torch.from_numpy(np.array(j_lse)[..., 0]))
    got = fa._flash_backward(*_t(q, k, v), out, lse, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


@pytest.mark.parametrize("S,D,dtype,tol", [
    (100, 32, torch.float32, 1e-5), (256, 64, torch.float32, 1e-5),
    (64, 128, torch.float32, 1e-5), (128, 32, torch.bfloat16, 2e-2)])
def test_autograd_function_matches_autograd_of_math_attention(S, D, dtype,
                                                              tol):
    """``multihead_attention`` under autograd goes through FlashAttentionFn
    (forward plain + backward plain on CPU): gradients against autograd of
    ``_math_attention``, incl. a ragged S. f32: summation order only; bf16:
    P, dS and the results round to 2^-8."""
    q, k, v = (a.to(dtype).requires_grad_() for a in _t(*_qkv(2, S, 2, D,
                                                              seed=D)))
    g = torch.from_numpy(_qkv(2, S, 2, D, seed=9)[0]).to(dtype)
    out = multihead_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(_math_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * max(scale,
                                                                       1.0)


def test_autograd_function_against_finite_differences():
    """A gradcheck in float32: the directional derivative of
    ``sum(w * attention(q, k, v))`` along a random direction, by central
    differences (eps 1e-2), against the backward's inner product. Relative
    tolerance 2e-2: float32 cancellation in the difference quotient."""
    q, k, v = _t(*_qkv(1, 48, 2, 32, seed=3))
    w = torch.from_numpy(_qkv(1, 48, 2, 32, seed=4)[0])
    dirs = _t(*_qkv(1, 48, 2, 32, seed=5))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    loss = (fa.flash_attention(*leaves) * w).sum()
    grads = torch.autograd.grad(loss, leaves)
    eps = 1e-2
    for i in range(3):
        plus = [a + eps * d if j == i else a
                for j, (a, d) in enumerate(zip((q, k, v), dirs))]
        minus = [a - eps * d if j == i else a
                 for j, (a, d) in enumerate(zip((q, k, v), dirs))]
        with torch.no_grad():
            num = ((fa.flash_attention(*plus) * w).sum()
                   - (fa.flash_attention(*minus) * w).sum()).item() / (2 * eps)
        ana = (grads[i] * dirs[i]).sum().item()
        assert abs(num - ana) <= 2e-2 * max(abs(ana), 1.0), (i, num, ana)


def test_forward_keeps_nothing_unless_a_backward_will_run():
    q, k, v = _t(*_qkv(1, 64, 2, 32))
    assert multihead_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert multihead_attention(qg, k, v).grad_fn is None
    out = multihead_attention(qg, k, v)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (2, 64)     # ..., out, lse


def test_backward_wrapper_rules_on_cpu():
    fa.reset_launches()
    q, k, v = _t(*_qkv(1, 64, 2, 32))
    out, lse = fa._flash_forward(q, k, v)
    g = torch.ones_like(out)
    with pytest.raises(ValueError, match="lse"):
        fa._flash_backward(q, k, v, out, lse[:, :32], g)
    with pytest.raises(ValueError, match="dtype"):
        fa._flash_backward(q, k, v, out, lse, g.double())
    # a strided dO is taken as it is; CPU tensors never count as launches
    wide = torch.ones(1, 64, 2, 64)
    a = fa._flash_backward(q, k, v, out, lse, wide[..., :32])
    b = fa._flash_backward(q, k, v, out, lse, g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (0, 0, 0)
    assert not fa.bwd_dq_launches_by_shape and not fa.bwd_dkv_launches_by_shape
