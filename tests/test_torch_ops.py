"""Flash-attention forward of the port: its plain version against the JAX
Pallas kernel (interpret mode on CPU) and ``_xla_attention``, and the
wrapper's rules on CPU. The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superdiff_tpu.ops.attention import _xla_attention
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
