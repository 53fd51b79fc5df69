"""Card-only checks of the hand-written CUDA kernels (skipped without a card).

This file imports torch and superdiff_torch only, so it also runs on a GPU
machine without jax (skip the JAX conftest there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools

import pytest
import torch

from superdiff_torch.ops import _build
from superdiff_torch.ops import flash_attention as fa
from superdiff_torch.ops import fused_norm as fn
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
                                     (1, 70, 1, 32), (3, 1, 2, 32),
                                     (2, 17, 4, 64), (1, 63, 2, 128),
                                     (2, 65, 1, 32), (1, 1000, 1, 64)])
def test_kernel_matches_plain_on_card(cuda, B, S, H, D, dtype):
    """Ragged S (1, 17, 63, 65, 70, 1000: partial query and key tiles),
    D=128. Tolerance: bf16 output rounding (2^-8 relative) plus P rounded to
    bf16 at slightly different offsets -> 2e-2; f32 -> 1e-4; lse is f32 in
    both (exp2 with the log2(e) factor folded in) -> 1e-4. A rerun gives the
    same bits."""
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
    out2, lse2 = fa._flash_forward(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


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
def test_kernel_takes_more_than_65535_batch_heads_on_card(cuda):
    """B*H = 65,600 goes on grid x; rows of every (b, h) agree with the
    plain version (bf16 tolerance as above)."""
    B, S, H, D = 16400, 17, 4, 32
    q, k, v = _fused_qkv(B, S, H, D, torch.bfloat16, cuda)
    assert fa._fwd_geometry(B, S, H, D, 2)[3][0] == B * H > 65535
    out, lse = fa._flash_forward(q, k, v)
    ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("code,D", sorted(fa._FWD_TILE))
def test_forward_instantiations_fit_without_spills_on_card(cuda, code, D):
    """Every built (dtype, D, bk, mt) at 1-8 warps: the kernel's shared
    memory is what ``_fwd_smem_bytes`` says, no register spills, at most
    255 registers, at least one resident block per SM."""
    dtype = torch.bfloat16 if code == 0 else torch.float32
    elem = 2 if code == 0 else 4
    bk, mt = fa._FWD_TILE[(code, D)]
    for warps in (1, 2, 4, 8):
        info = fa.fwd_kernel_info(D, dtype, warps, bk, mt)
        key = (bk, mt, warps, info)
        assert info["smem_bytes"] == fa._fwd_smem_bytes(
            D, elem, warps, bk, mt), key
        assert info["spill_bytes"] == 0 and info["registers"] <= 255, key
        assert info["blocks_per_sm"] >= 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_built_geometry_matches_plain_on_card(cuda, dtype):
    """Each D's built (bk, mt) at 1, 2, 4 and 8 warps, at a ragged S
    (partial query and key tiles): agrees with the plain version
    (tolerances as above) and reruns bit for bit."""
    code = fa._DTYPE_CODE[dtype]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for D in fa.SUPPORTED_HEAD_DIMS:
        q, k, v = _fused_qkv(2, 150, 2, D, dtype, cuda)
        ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
        bk, mt = fa._FWD_TILE[(code, D)]
        for warps in (1, 2, 4, 8):
            out, lse = fa._launch_fwd(q, k, v, warps, bk, mt)
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       rtol=tol, atol=tol)
            torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
            out2, lse2 = fa._launch_fwd(q, k, v, warps, bk, mt)
            assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,D", [(2, 1024, 4, 32), (2, 256, 4, 64),
                                     (2, 64, 4, 64), (1, 1000, 2, 128),
                                     (1, 70, 1, 32)])
def test_backward_kernels_match_plain_on_card(cuda, B, S, H, D, dtype):
    """dQ (B2) and dK/dV (B3) against ``_flash_backward_plain`` on the same
    inputs, with a non-contiguous dO. Tolerance relative to each gradient's
    largest entry: bf16 rounds P, dS and the output (2^-8 each) -> 2e-2;
    f32 differs only in summation order and exp2 vs exp -> 1e-4. A rerun
    gives the same bits."""
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
    again = fa._flash_backward(q, k, v, out, lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), name          # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("code,D,kernel", sorted(fa._BWD_TILE))
def test_backward_instantiations_fit_without_spills_on_card(cuda, code, D,
                                                            kernel):
    """Every built (kernel, dtype, D, bt, mt) at 1-8 warps: the kernel's
    shared memory is what ``_bwd_smem_bytes`` says, no register spills, at
    most 255 registers, at least one resident block per SM."""
    dtype = torch.bfloat16 if code == 0 else torch.float32
    elem = 2 if code == 0 else 4
    for (bt, mt), warps in itertools.product(fa._BWD_TILE[(code, D, kernel)],
                                             (1, 2, 4, 8)):
        info = fa.bwd_kernel_info(kernel, D, dtype, warps, bt, mt)
        key = (bt, mt, warps, info)
        assert info["smem_bytes"] == fa._bwd_smem_bytes(
            kernel, D, elem, warps, bt, mt), key
        assert info["spill_bytes"] == 0 and info["registers"] <= 255, key
        assert info["blocks_per_sm"] >= 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_built_backward_geometry_matches_plain_on_card(cuda, dtype):
    """Each kernel's built (bt, mt) tiles for each D at 1, 2, 4 and 8 warps,
    at a ragged S (partial row and looped tiles), with a strided dO: agrees
    with the plain version (tolerances as above, relative to each gradient's
    largest entry) and reruns bit for bit."""
    code = fa._DTYPE_CODE[dtype]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for D in fa.SUPPORTED_HEAD_DIMS:
        q, k, v = _fused_qkv(2, 150, 2, D, dtype, cuda)
        g = _fused_qkv(2, 150, 2, D, dtype, cuda, seed=1)[1]
        out, lse = fa._flash_forward(q, k, v)
        delta = fa._bwd_delta(out, g)
        for kernel, plain in (("dq", fa._flash_bwd_dq_plain),
                              ("dkv", fa._flash_bwd_dkv_plain)):
            ref = plain(q, k, v, g, lse, delta)
            ref = (ref,) if kernel == "dq" else ref
            for (bt, mt), warps in itertools.product(
                    fa._BWD_TILE[(code, D, kernel)], (1, 2, 4, 8)):
                run = lambda: fa._launch_bwd(kernel, q, k, v, g, lse, delta,
                                             warps, bt, mt)
                got, again = run(), run()
                got = (got,) if kernel == "dq" else got
                again = (again,) if kernel == "dq" else again
                for a, b, c in zip(got, ref, again):
                    err = (a.float() - b.float()).abs().max().item()
                    key = (D, kernel, warps, err)
                    assert err <= tol * b.float().abs().max().item(), key
                    assert torch.equal(a, c), key


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
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa._flash_backward(q, k, v, out, lse, torch.ones_like(out))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa._flash_forward(q, k, v)
    x, gamma, beta, _, _ = _gn_inputs(1, 4, 4, 8, False, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn.fused_groupnorm_silu(x, gamma, beta, 4)


def _gn_inputs(B, H, W, C, film, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x = (0.5 + 2 * r(B, H, W, C)).to(dtype)
    gamma, beta = 1 + 0.1 * r(C), 0.1 * r(C)
    if not film:
        return x, gamma, beta, None, None
    return x, gamma, beta, 0.2 * r(B, C), 0.2 * r(B, C)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,G,film", [
    (2, 256, 256, 1, 1, False), (2, 256, 256, 64, 4, False),
    (2, 64, 64, 128, 4, True), (2, 8, 8, 48, 16, True),
    (2, 8, 8, 384, 32, True), (1, 7, 9, 64, 4, True), (1, 7, 9, 1, 1, False)])
def test_group_norm_kernel_matches_plain_on_card(cuda, B, H, W, C, G, film,
                                                 dtype):
    """B4 against ``gn_silu_plain`` on the same inputs: the RefUNet's group
    widths 1 and 16/32, FiLM, group widths 3 and 12, ragged H*W (7x9, and
    63 elements that take the scalar path). Tolerance: f32 differs in
    summation order and __expf -> 1e-4; bf16 rounds the output once
    (2^-8 relative), and a float32 value near a rounding boundary may land
    one ulp away -> 1e-2. A rerun gives the same bits."""
    x, gamma, beta, scale, shift = _gn_inputs(B, H, W, C, film, dtype, cuda)
    before = fn.launches
    y = fn.fused_groupnorm_silu(x, gamma, beta, G, scale, shift)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert y.shape == x.shape and y.dtype == dtype
    ref = fn.gn_silu_plain(x, gamma, beta, G, scale, shift)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(y, fn.fused_groupnorm_silu(x, gamma, beta, G, scale,
                                                  shift))


@pytest.mark.cuda
def test_group_norm_wrapper_rules_and_autograd_on_card(cuda):
    """Dtypes and layouts the kernel does not take raise; a default-built
    ``GroupNormSiLU`` launches the kernel; under autograd the forward is the
    kernel and the gradients of all five inputs are autograd of the plain
    version."""
    from superdiff_torch.models.layers import GroupNormSiLU

    x, gamma, beta, scale, shift = _gn_inputs(2, 16, 16, 32, True,
                                              torch.float32, cuda)
    with pytest.raises(ValueError, match="bfloat16/float32"):
        fn.fused_groupnorm_silu(x.half(), gamma, beta, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fn.fused_groupnorm_silu(x.transpose(1, 2), gamma, beta, 8)
    fn.reset_launches()
    with torch.no_grad():
        GroupNormSiLU(8, 32, device=cuda)(x, scale, shift)
    assert fn.launches == 1
    fn.reset_launches()
    leaves = [a.detach().clone().requires_grad_()
              for a in (x, gamma, beta, scale, shift)]
    y = fn.fused_groupnorm_silu(*leaves[:3], 8, *leaves[3:])
    assert fn.launches == 1
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, g)
    ref = torch.autograd.grad(
        fn.gn_silu_plain(*leaves[:3], 8, *leaves[3:]), leaves, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_refunet_convs_ignore_the_process_tf32_default(cuda):
    """The RefUNet pins its convolutions to IEEE float32: a call is
    bit-equal with PyTorch's cuDNN TF32 on and off, and ``Fp32Conv3x3``'s
    gradients under TF32 on match autograd of ``F.conv2d`` under TF32 off
    at 1e-4 (other algorithms sum in other orders; TF32 would be off by
    ~1e-3)."""
    import torch.nn.functional as F

    from superdiff_torch.models.unet_ref import Fp32Conv3x3, RefUNet

    g = torch.Generator(device=cuda).manual_seed(0)
    model = RefUNet(base_channels=16, device=cuda).init_parameters(0)
    x = torch.randn((2, 64, 64, 1), generator=g, device=cuda)
    t = torch.tensor([3, 700], device=cuda)
    xc = torch.randn((2, 32, 16, 16), generator=g, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    w = torch.randn((24, 32, 3, 3), generator=g, device=cuda,
                    requires_grad=True)
    b = torch.randn((24,), generator=g, device=cuda, requires_grad=True)
    dy = torch.randn((2, 24, 16, 16), generator=g, device=cuda)
    prev = torch.backends.cudnn.allow_tf32
    try:
        outs = []
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = on
            with torch.no_grad():
                outs.append(model(x, t))
        torch.backends.cudnn.allow_tf32 = True
        got = torch.autograd.grad(Fp32Conv3x3.apply(xc, w, b), (xc, w, b), dy)
        torch.backends.cudnn.allow_tf32 = False
        ref = torch.autograd.grad(F.conv2d(xc, w, b, padding=1), (xc, w, b),
                                  dy)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.equal(outs[0], outs[1])
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
