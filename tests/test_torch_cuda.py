"""Card-only checks of the hand-written CUDA kernels (skipped without a card).

This file imports torch and superdiff_torch only, so it also runs on a GPU
machine without jax (skip the JAX conftest there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from superdiff_torch.ops import flash_attention as fa
from superdiff_torch.ops.attention import _math_attention, multihead_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fused_qkv(B, S, H, D, dtype, dev, seed=0):
    """q, k, v as strided views of one fused projection (the model's
    layout)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * D), generator=g, device=dev).to(dtype)
    return [a.view(B, S, H, D) for a in qkv.split(H * D, dim=-1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,D", [(2, 1024, 4, 32), (2, 256, 4, 64),
                                     (2, 64, 4, 64), (1, 1000, 2, 128),
                                     (1, 70, 1, 32)])
def test_kernel_matches_plain_on_card(cuda, B, S, H, D, dtype):
    """Tolerance: bf16 output rounding (2^-8 relative) plus P rounded to
    bf16 at slightly different offsets -> 2e-2; f32 -> 1e-4; lse is f32 in
    both (exp2 with the log2(e) factor folded in) -> 1e-4."""
    q, k, v = _fused_qkv(B, S, H, D, dtype, cuda)
    before = fa.launches
    out, lse = fa._flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == (B, S, H, D) and lse.shape == (B * H, S)
    ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_rules_on_card(cuda):
    q, k, v = _fused_qkv(1, 64, 2, 48, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="D in"):
        fa._flash_forward(q, k, v)
    torch.testing.assert_close(multihead_attention(q, k, v).float(),
                               _math_attention(q, k, v).float())
    q, k, v = _fused_qkv(1, 64, 2, 32, torch.float16, cuda)
    with pytest.raises(ValueError, match="bfloat16/float32"):
        fa._flash_forward(q, k, v)
    q, k, v = _fused_qkv(1, 64, 2, 32, torch.float32, cuda)
    buf = torch.randn(64 * 97 + 64, device=cuda)
    odd = buf.as_strided((1, 64, 2, 32), (64 * 97, 97, 32, 1))
    with pytest.raises(ValueError, match="aligned"):
        fa._flash_forward(odd, k, v)        # row stride 97 floats: no 16 B


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,D", [(2, 1024, 4, 32), (2, 256, 4, 64),
                                     (2, 64, 4, 64), (1, 1000, 2, 128),
                                     (1, 70, 1, 32)])
def test_backward_kernels_match_plain_on_card(cuda, B, S, H, D, dtype):
    """dQ (B2) and dK/dV (B3) against ``_flash_backward_plain`` on the same
    inputs, with a non-contiguous dO. Tolerance relative to each gradient's
    largest entry: bf16 rounds P, dS and the output (2^-8 each) -> 2e-2;
    f32 differs only in summation order and exp2 vs exp -> 1e-4."""
    q, k, v = _fused_qkv(B, S, H, D, dtype, cuda)
    out, lse = fa._flash_forward(q, k, v)
    g = _fused_qkv(B, S, H, D, dtype, cuda, seed=1)[1]      # strided view
    assert not g.is_contiguous()
    n_dq, n_dkv = fa.bwd_dq_launches, fa.bwd_dkv_launches
    got = fa._flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert fa.bwd_dq_launches == n_dq + 1
    assert fa.bwd_dkv_launches == n_dkv + 1
    ref = fa._flash_backward_plain(q, k, v, out, lse, g)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == (B, S, H, D) and a.dtype == dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_autograd_function_runs_the_kernels_on_card(cuda):
    """``multihead_attention`` under autograd: one launch of each kernel,
    gradients close to autograd of the plain math path; with grad disabled
    only the forward runs."""
    q, k, v = (a.detach().clone().requires_grad_()
               for a in _fused_qkv(2, 256, 4, 64, torch.float32, cuda))
    fa.reset_launches()
    out = multihead_attention(q, k, v)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 1)
    ref = torch.autograd.grad(_math_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        multihead_attention(q, k, v)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (2, 1, 1)


@pytest.mark.cuda
def test_no_fallback_when_the_build_fails(cuda, monkeypatch):
    """A kernel that cannot be built raises; the wrapper never gives way to
    the plain version on a CUDA tensor."""
    q, k, v = _fused_qkv(1, 64, 2, 32, torch.float32, cuda)
    out, lse = fa._flash_forward(q, k, v)
    monkeypatch.setattr(fa, "_libs", {})
    monkeypatch.setattr(fa, "NVCC_FLAGS", fa.NVCC_FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa._flash_backward(q, k, v, out, lse, torch.ones_like(out))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa._flash_forward(q, k, v)
