"""Card-only checks of the hand-written CUDA kernels (skipped without a card).

This file imports torch and superdiff_torch only, so it also runs on a GPU
machine without jax (skip the JAX conftest there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools
import math

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


def _assert_out_close(out, ref):
    """B1's output against the plain version's. float32: 1e-4. bf16: at
    most 2e-2 of the reference's largest entry, and never above 2e-2. Both
    round once to bf16 from f32 sums that P's bf16 rounding (at other
    offsets: the kernel rounds exp2(s - running max), the plain version the
    normalised P) parts by a bf16 ulp or two of that entry, 2^-7 of it at
    most each. At S = 4096 the largest |out| is about 0.1 to 0.3, so the
    limit is a few 1e-3, which a dropped or misread 128-key V tile
    exceeds."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        return
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2e-2 * min(1.0, ref.float().abs().max().item())
    assert torch.isfinite(out.float()).all() and err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,D", [(2, 1024, 4, 32), (2, 256, 4, 64),
                                     (2, 64, 4, 64), (1, 1000, 2, 128),
                                     (1, 70, 1, 32), (3, 1, 2, 32),
                                     (2, 17, 4, 64), (1, 63, 2, 128),
                                     (2, 65, 1, 32), (1, 1000, 1, 64)])
def test_kernel_matches_plain_on_card(cuda, B, S, H, D, dtype):
    """Ragged S (1, 17, 63, 65, 70, 1000: partial query and key tiles),
    D=128. Tolerance: out as :func:`_assert_out_close`; lse is f32 in both
    (exp2 with the log2(e) factor folded in) -> 1e-4. A rerun gives the
    same bits."""
    q, k, v = _fused_qkv(B, S, H, D, dtype, cuda)
    before = fa.launches
    out, lse = fa._flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == (B, S, H, D) and lse.shape == (B * H, S)
    ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
    _assert_out_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    out2, lse2 = fa._flash_forward(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def _split_views(B, S, Skv, H, D, dev, layout, seed=0):
    """q, k, v bf16: ``"fused"`` as strided views of one projection (Skv =
    S), ``"sd"`` q from its own projection and k, v from theirs (SD's
    Attention), ``"bhsd"`` transposes of (B, H, L, D) tensors."""
    if layout == "fused":
        return _fused_qkv(B, S, H, D, torch.bfloat16, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda L: torch.randn((B, L, H * D), generator=g, device=dev).to(
        torch.bfloat16).view(B, L, H, D)
    if layout == "sd":
        return r(S), r(Skv), r(Skv)
    return [torch.randn((B, H, L, D), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2) for L in (S, Skv, Skv)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Skv,H,layout", [
    (2, 4096, 4096, 5, "fused"), (2, 1024, 1024, 10, "fused"),
    (2, 4096, 4096, 5, "sd"), (1, 1100, 1024, 3, "sd"),
    (2, 1024, 2048, 2, "bhsd")],
    ids=["S4096_H5", "S1024_H10", "sd_S4096", "ragged_q", "bhsd"])
def test_wgmma_design_matches_plain_on_card(cuda, B, S, Skv, H, layout):
    """B1's second design (bf16, D = 64, long sequences) against the plain
    version, with q, k, v as split views of one projection, as SD's
    separate projections, and as transposed (B, H, L, D) tensors; S = 1100
    ends in a partial query tile. Tolerance as for the first design: out
    as :func:`_assert_out_close`; lse in f32 (exp2 with log2(e) folded in,
    f32 sums in another order) -> 1e-4.
    A rerun gives the same bits, and the launch is counted as the design
    the rule picks."""
    q, k, v = _split_views(B, S, Skv, H, 64, cuda, layout)
    assert fa._fwd_design(S, Skv, 64, torch.bfloat16) == "wgmma"
    fa.reset_launches()
    out, lse = fa._flash_forward(q, k, v)
    torch.cuda.synchronize()
    key = (S, 64, "bfloat16") + (() if Skv == S else (Skv,))
    assert fa.launches_by_design == {key + ("wgmma",): 1}
    assert out.shape == (B, S, H, 64) and lse.shape == (B * H, S)
    ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
    _assert_out_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    out2, lse2 = fa._flash_forward(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_launches_by_design_follow_the_rule_on_card(cuda):
    """wide256's launches (S = 1024 at D = 32, S = 256 at D = 64), SD's
    cross-attention to 77 keys and a float32 launch keep the mma.sync
    design; SD's S = 1024 self-attention takes the wgmma design; inside a
    CUDA graph capture the same launches are also counted as captured."""
    fa.reset_launches()
    shapes = [(2, 1024, 1024, 4, 32, torch.bfloat16),
              (2, 256, 256, 4, 64, torch.bfloat16),
              (2, 1024, 77, 10, 64, torch.bfloat16),
              (2, 1024, 1024, 10, 64, torch.float32),
              (2, 1024, 1024, 10, 64, torch.bfloat16)]
    inputs = []
    for B, S, Skv, H, D, dtype in shapes:
        g = torch.Generator(device=cuda).manual_seed(S + Skv + D)
        inputs.append([torch.randn((B, L, H, D), generator=g,
                                   device=cuda).to(dtype)
                       for L in (S, Skv, Skv)])
    for q, k, v in inputs:
        fa._flash_forward(q, k, v)
    want = {(1024, 32, "bfloat16", "mma_sync"): 1,
            (256, 64, "bfloat16", "mma_sync"): 1,
            (1024, 64, "bfloat16", 77, "mma_sync"): 1,
            (1024, 64, "float32", "mma_sync"): 1,
            (1024, 64, "bfloat16", "wgmma"): 1}
    assert fa.launches_by_design == want and fa.captured_by_design == {}
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        outs = [fa._flash_forward(q, k, v)[0] for q, k, v in inputs]
    assert fa.captured_by_design == want
    graph.replay()
    torch.cuda.synchronize()
    eager = [fa._flash_forward(q, k, v)[0] for q, k, v in inputs]
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wgmma_instantiation_fits_without_spills_on_card(cuda):
    """What the compiler and the occupancy calculator say of the wgmma
    design: two blocks (each a producer and a consumer warpgroup) resident
    per SM, as its launch bounds ask and its overlap needs, so their
    shared memory fits an SM's 227 KB twice over; no register spills under
    the consumer's setmaxnreg budget."""
    info = fa.fwd_wgmma_kernel_info()
    assert info["blocks_per_sm"] == 2, info
    assert 0 < 2 * info["smem_bytes"] <= fa.MAX_SMEM, info
    assert info["spill_bytes"] == 0, info


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
    _assert_out_close(out, ref_out)
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
    for D in fa.SUPPORTED_HEAD_DIMS:
        q, k, v = _fused_qkv(2, 150, 2, D, dtype, cuda)
        ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
        bk, mt = fa._FWD_TILE[(code, D)]
        for warps in (1, 2, 4, 8):
            out, lse = fa._launch_fwd(q, k, v, warps, bk, mt)
            _assert_out_close(out, ref_out)
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
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc failed"):
        fn.gn_film_silu_policy(x, gamma, beta, 4, torch.bfloat16)


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


# the wide256 CondUNet's chain shapes (H, W, C), G = 32
_MAIN_PATH = [(128, 128, 128), (128, 128, 256), (64, 64, 256), (64, 64, 128),
              (32, 32, 384), (32, 32, 256), (32, 32, 128), (16, 16, 512),
              (16, 16, 384), (16, 16, 256), (16, 16, 128), (8, 8, 512),
              (8, 8, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,W,C", _MAIN_PATH)
def test_policy_b4_matches_the_plain_chain_at_every_main_path_shape_on_card(
        cuda, H, W, C, nd):
    """Policy-mode B4 (bf16 x, batch 16, G=32, with and without FiLM) in
    both regimes against ``gn_film_silu_policy_plain``: the same rounding
    points, so only the statistics' summation order differs. bf16 norm
    dtype: every element within 2 bf16 ulps (at the magnitude the chain
    rounds at: ``tools/tune_group_norm.py::bf16_ulps``), under 1 % differ
    at all (the counts are printed); float32: within 1e-4 of the largest
    output. A rerun gives the same bits."""
    from superdiff_torch.tools.tune_group_norm import (bf16_ulps,
                                                       chain_magnitude)

    for film in (True, False):
        x, gamma, beta, scale, shift = _gn_inputs(16, H, W, C, film,
                                                  torch.bfloat16, cuda,
                                                  seed=C + H)
        want = fn.gn_film_silu_policy_plain(x, gamma, beta, 32, nd, scale,
                                            shift)
        for regime in ("cluster", "three_pass"):
            call = lambda: fn._launch(x, gamma, beta, 32, scale, shift, 1e-5,
                                      nd, True, regime)
            got = call()
            torch.cuda.synchronize()
            assert got.dtype == nd and got.shape == x.shape
            ulps = bf16_ulps(got, want, chain_magnitude(
                fn, x, gamma, beta, 32, nd, scale, shift))
            differ = (got != want).sum().item()
            print(f"{(H, W, C)} film={film} {nd} {regime}: max "
                  f"{ulps.max().item():.3g} bf16 ulps, {differ} of "
                  f"{want.numel()} elements differ")
            assert torch.equal(got, call())
            if nd == torch.bfloat16:
                assert ulps.max().item() <= 2
                assert differ < 0.01 * want.numel()
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * (
                    1 + want.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["cluster", "three_pass"])
def test_b4_in_a_cuda_graph_equals_the_eager_launch_on_card(cuda, regime):
    """B4 captured into a CUDA graph (policy and folded mode) and replayed
    twice gives the eager launch's bits; its launches under capture are
    counted as captured."""
    x, gamma, beta, scale, shift = _gn_inputs(4, 32, 32, 128, True,
                                              torch.bfloat16, cuda)
    calls = [lambda: fn._launch(x, gamma, beta, 32, scale, shift, 1e-5,
                                torch.bfloat16, True, regime),
             lambda: fn._launch(x, gamma, beta, 32, scale, shift, 1e-5,
                                torch.bfloat16, False, regime)]
    want = [c() for c in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    fn.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    assert fn.launches == 2 and sum(fn.captured_by_shape.values()) == 2
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o, w)


@pytest.mark.cuda
def test_condunet_launches_b4_for_every_chain_without_grad_on_card(cuda):
    """One full-width wide256 call under no_grad launches B4 once per
    GroupNorm->(FiLM)->SiLU chain, 51 in all (25 with FiLM); one with
    gradients wanted at the bf16 norm dtype launches none (the plain chain
    under autograd); at the float32 norm dtype (the training policy) 51
    forward and 51 backward launches (25 of each with FiLM)."""
    from superdiff_torch.models.presets import build_model

    model = build_model("wide256", device=cuda).init_parameters(0)
    model.set_norm_dtype(torch.bfloat16)
    args = (torch.randn((2, 256, 256, 1), device=cuda),
            torch.tensor([5, 900], device=cuda),
            torch.tensor([0, 1], device=cuda))
    fn.reset_launches()
    with torch.no_grad():
        model(*args)
    torch.cuda.synchronize()
    assert fn.launches == 51
    assert sum(n for k, n in fn.launches_by_shape.items() if k[4]) == 25
    fn.reset_launches()
    model(*args).float().mean().backward()
    torch.cuda.synchronize()
    assert fn.launches == 0 and fn.bwd_launches == 0
    model.set_norm_dtype(torch.float32)
    fn.reset_launches()
    model(*args).float().mean().backward()
    torch.cuda.synchronize()
    assert fn.launches == fn.bwd_launches == 51
    for counts in (fn.launches_by_shape, fn.bwd_launches_by_shape):
        assert sum(n for k, n in counts.items() if k[4]) == 25
    assert fn.bwd_launches_by_shape == fn.launches_by_shape


def _chain_leaves(x, gamma, beta, scale, shift):
    return [None if a is None else a.detach().clone().requires_grad_()
            for a in (x, gamma, beta, scale, shift)]


def _assert_backward_close(got, want, what):
    """B4's backward against the plain closed form. dx (bf16 or float32)
    within 2^-7 of itself (a bf16 rounding of float32 values whose last bits
    differ lands an ulp, 2^-8 relative, away) plus 1e-3 of the largest
    |dx| (its three terms cancel, so the float32 sums' order shows at the
    scale of the largest term); the float32 sums dgamma, dbeta, dscale,
    dshift within 1e-4 of their largest value (sums of up to 67 M terms in
    another order)."""
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"),
                          got, want):
        assert (a is None) == (b is None), (what, name)
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        big = b.float().abs().max().item()
        rtol, atol = (2 ** -7, 1e-3 * big) if name == "dx" else (0,
                                                                  1e-4 * big)
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{what} {name}: "
                                   f"{m}")


def _backward_case(x, gamma, beta, G, scale, shift, regime, seed=0):
    """B4's forward (statistics written) and backward at ``regime``
    against the plain closed form, on one incoming gradient; a rerun of
    both gives the same bits. Returns the kernel's gradients."""
    g = torch.randn(x.shape, device=x.device,
                    generator=torch.Generator(device=x.device)
                    .manual_seed(seed))
    y, stats = fn._launch(x, gamma, beta, G, scale, shift, 1e-5,
                          torch.float32, True, regime, stats=True)
    assert torch.equal(y, fn._launch(x, gamma, beta, G, scale, shift, 1e-5,
                                     torch.float32, True, regime))
    got = fn._launch_backward(x, g, stats, gamma, beta, G, scale, shift,
                              regime)
    torch.cuda.synchronize()
    want = fn.gn_film_silu_policy_backward_plain(x, g, gamma, beta, G, scale,
                                                 shift)
    _assert_backward_close(got, want, f"{tuple(x.shape)} G={G} "
                           f"film={scale is not None} {regime}")
    again = fn._launch_backward(x, g, fn._launch(
        x, gamma, beta, G, scale, shift, 1e-5, torch.float32, True, regime,
        stats=True)[1], gamma, beta, G, scale, shift, regime)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C", _MAIN_PATH)
def test_b4_backward_matches_the_plain_backward_at_every_chain_shape_on_card(
        cuda, H, W, C):
    """B4's backward at the wide256 chain shapes at batch 16 (bf16 x, G=32;
    the 18 of a train step among them), with and without FiLM, in both
    regimes, against ``gn_film_silu_policy_backward_plain``
    (tolerances: ``_assert_backward_close``); two runs give the same
    bits."""
    for film in (True, False):
        x, gamma, beta, scale, shift = _gn_inputs(16, H, W, C, film,
                                                  torch.bfloat16, cuda,
                                                  seed=C + H)
        for regime in ("cluster", "three_pass"):
            _backward_case(x, gamma, beta, 32, scale, shift, regime, seed=H)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,G,dtype", [
    (3, 7, 9, 6, 3, torch.bfloat16), (2, 7, 9, 48, 16, torch.float32),
    (2, 5, 5, 64, 64, torch.bfloat16), (1, 16, 16, 128, 4, torch.float32),
    (4, 8, 8, 1024, 32, torch.bfloat16)])
def test_b4_backward_at_odd_shapes_and_strided_film_on_card(cuda, B, H, W, C,
                                                            G, dtype):
    """B4's backward off the main path: ragged lengths (scalar loads),
    group widths 2, 3, 1 and 32, float32 x, 1024 channels (three passes
    only: a cluster block step holds at most 256 x 4), and FiLM operands
    that are tensor-parallel views (a slice of a wider row, its own row
    stride and offset), against the plain closed form."""
    x, gamma, beta, _, _ = _gn_inputs(B, H, W, C, False, dtype, cuda,
                                      seed=C)
    wide = 0.2 * torch.randn((B, 4 * C), device=cuda)
    scale, shift = wide[:, C:2 * C], wide[:, 3 * C:]
    regimes = ["three_pass"]
    if C <= 1024 and fn.backward_geometry(B, H * W, C, G, dtype, True
                                          ).regime == "cluster":
        regimes.append("cluster")
    for regime in regimes:
        for film in (True, False):
            _backward_case(x, gamma, beta, G, *((scale, shift) if film
                                                else (None, None)), regime)


@pytest.mark.cuda
def test_training_chain_keeps_the_no_grad_bits_on_card(cuda):
    """With a gradient wanted at the float32 norm dtype the chain is
    ``PolicyChainFn``: its y is the no-grad launch's bit for bit, its
    gradients of all five inputs (FiLM as ``cond.chunk(2)`` views) are the
    backward kernel's, one forward and one backward launch are counted; a
    bf16 norm dtype keeps the plain chain under autograd."""
    x, gamma, beta, scale, shift = _gn_inputs(4, 32, 32, 128, True,
                                              torch.bfloat16, cuda)
    cond = torch.cat([scale, shift], dim=-1).requires_grad_()
    leaves = _chain_leaves(x, gamma, beta, None, None)
    s, t = cond.chunk(2, dim=-1)
    fn.reset_launches()
    y = fn.gn_film_silu_policy(leaves[0], leaves[1], leaves[2], 32,
                               torch.float32, s, t)
    assert type(y.grad_fn).__name__ == "PolicyChainFnBackward"
    with torch.no_grad():
        assert torch.equal(y, fn.gn_film_silu_policy(x, gamma, beta, 32,
                                                     torch.float32, s, t))
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves[:3] + [cond], g)
    assert (fn.launches, fn.bwd_launches) == (2, 1)
    want = fn.gn_film_silu_policy_backward_plain(x, g, gamma, beta, 32,
                                                 scale, shift)
    _assert_backward_close(
        (*got[:3], got[3][:, :128], got[3][:, 128:]), want, "autograd")
    fn.reset_launches()
    y = fn.gn_film_silu_policy(leaves[0], leaves[1], leaves[2], 32,
                               torch.bfloat16, s, t)
    torch.autograd.grad(y, leaves[:3] + [cond], g.bfloat16())
    assert (fn.launches, fn.bwd_launches) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["cluster", "three_pass"])
def test_b4_backward_in_a_cuda_graph_equals_the_eager_call_on_card(cuda,
                                                                   regime):
    """The training chain's forward and backward (through autograd)
    captured into a CUDA graph and replayed twice give the eager call's
    bits; the captured launches are counted as captured."""
    H = 32 if regime == "cluster" else 128
    x, gamma, beta, scale, shift = _gn_inputs(16, H, H, 128, True,
                                              torch.bfloat16, cuda)
    leaves = _chain_leaves(x, gamma, beta, scale, shift)
    g = torch.randn(x.shape, device=cuda)
    assert fn.backward_geometry(16, H * H, 128, 32, torch.bfloat16,
                                True).regime == regime

    def call():             # outputs detached: no autograd graph outlives it
        y = fn.gn_film_silu_policy(*leaves[:3], 32, torch.float32,
                                   *leaves[3:])
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    fn.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    assert sum(fn.captured_by_shape.values()) == 1
    assert sum(fn.bwd_captured_by_shape.values()) == 1
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o, w)


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


def _graph_cases(dev):
    """Plans of every sampler on a toy CondUNet whose attention level runs
    B1 (head dim 32), and the eager sampler that each must equal."""
    from superdiff_torch.diffusion import samplers as ts
    from superdiff_torch.diffusion import superdiff as tsd
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.inference import make_eps_fn_p
    from superdiff_torch.models.unet import CondUNet

    kw = dict(resolution=16, base_channels=32, channel_mults=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
              num_classes=2, time_emb_dim=32, groups=8,
              compute_dtype=torch.bfloat16, device=dev)
    m1 = CondUNet(**kw).init_parameters(1).eval()
    m2 = CondUNet(**kw).init_parameters(2).eval()
    s = make_schedule(20, device=dev)
    shape = (4, 16, 16, 1)
    per = make_eps_fn_p(m1, "per_sample")
    f = lambda *a: per(m1, *a)
    y = torch.tensor([0, 1, 2, 0], device=dev)
    cfg = dict(y=y, guidance_scale=3.0, null_label=2)
    a1, a2 = make_eps_fn_p(m1, 0), make_eps_fn_p(m2, 1)
    fns = [lambda x, t: a1(m1, x, t), lambda x, t: a2(m2, x, t)]
    return {
        "ddpm": (lambda: ts.DDPMPlan(s, f, shape, y=y),
                 lambda g: ts.ddpm_sample(s, f, shape, g, y=y)),
        "ddim_cfg": (lambda: ts.DDIMPlan(s, f, shape, num_steps=7, eta=0.5,
                                         **cfg),
                     lambda g: ts.ddim_sample(s, f, shape, g, num_steps=7,
                                              eta=0.5, **cfg)),
        "dpmpp": (lambda: ts.DPMppPlan(s, f, shape, num_steps=6, y=y),
                  lambda g: ts.dpmpp_sample(s, f, shape, g, num_steps=6,
                                            y=y)),
        "superdiff_or": (lambda: tsd.SuperDiffPlan(s, fns, shape),
                         lambda g: tsd.superdiff_sample(s, fns, shape, g)),
        "superdiff_and": (lambda: tsd.SuperDiffPlan(s, fns, shape,
                                                    mode="and"),
                          lambda g: tsd.superdiff_sample(s, fns, shape, g,
                                                         mode="and")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ddpm", "ddim_cfg", "dpmpp", "superdiff_or",
                                  "superdiff_and"])
def test_graphed_sampler_equals_the_eager_sampler_on_card(cuda, name):
    """One CUDA graph of one step, replayed per step, gives the eager
    sampler's bits with the same generator seed (B1 inside the graph: the
    Python counter moves during warm-up and capture only, and counts the
    captured step's launches as captured; the replays are counted), twice
    in a row from the same graph."""
    from superdiff_torch.diffusion import graphed as gr
    from superdiff_torch.diffusion.graphed import (WARMUP_STEPS,
                                                   GraphedSampler)

    make_plan, eager = _graph_cases(cuda)[name]
    plan = make_plan()
    fa.reset_launches()
    with torch.no_grad():
        plan.start(torch.zeros_like(plan.x))
        plan.step()
    per_step = fa.launches
    assert per_step > 0
    fa.reset_launches()
    gr.reset_counts()
    graphed = GraphedSampler(plan, pool=torch.cuda.graph_pool_handle())
    assert graphed.graph is not None and gr.captures == 1
    assert fa.launches == per_step * (WARMUP_STEPS + 1)
    assert sum(fa.captured_by_shape.values()) == per_step
    gen = lambda: torch.Generator(device=cuda).manual_seed(3)
    got = graphed(gen())
    again = graphed(gen())
    torch.cuda.synchronize()
    assert fa.launches == per_step * (WARMUP_STEPS + 1)  # replays: no Python
    assert gr.replays == 2 * plan.num_steps and gr.captures == 1
    want = eager(gen())
    got, again, want = ((o if isinstance(o, tuple) else (o,))
                        for o in (got, again, want))
    for a, b, w in zip(got, again, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, w) and torch.equal(b, w)


@pytest.mark.cuda
def test_graphed_refunet_launches_b4_inside_the_graph_on_card(cuda):
    """A RefUNet DDIM run as one graph per step: B4 is in the graph (the
    profiler sees its kernels in the replays: one ``gn_cluster`` or one
    ``gn_apply`` per GroupNorm->SiLU, 10 per step), and the samples equal
    the eager run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from superdiff_torch.diffusion import samplers as ts
    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.models.unet_ref import RefUNet

    model = RefUNet(base_channels=8, device=cuda).init_parameters(0).eval()
    s = make_schedule(50, device=cuda)
    shape = (2, 32, 32, 1)
    eps = lambda x, t: model(x, t)
    plan = ts.DDIMPlan(s, eps, shape, num_steps=5)
    graphed = GraphedSampler(plan)
    gen = lambda: torch.Generator(device=cuda).manual_seed(1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = graphed(gen())
        torch.cuda.synchronize()
    n_apply = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                  and ("gn_apply" in e.name or "gn_cluster" in e.name))
    assert n_apply == 10 * 5, n_apply
    want = ts.ddim_sample(s, eps, shape, gen(), num_steps=5)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_service_captures_once_per_spec_on_card(cuda):
    """The service on the card: one capture per spec, coalesced requests,
    a seeded request reproducible and equal to the eager sampler's bits."""
    import numpy as np

    from superdiff_torch.diffusion import samplers as ts
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.inference import make_eps_fn_p
    from superdiff_torch.models.unet import CondUNet
    from superdiff_torch.serve import SampleSpec, SamplerService

    model = CondUNet(resolution=16, base_channels=32, channel_mults=(1, 2),
                     num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
                     num_classes=2, time_emb_dim=32, groups=8,
                     device=cuda).init_parameters(4).eval()
    s = make_schedule(20, device=cuda)
    svc = SamplerService(model, s, resolution=16, conditional=True,
                         batch_size=4, autostart=False)
    spec = SampleSpec("ddim", 5)
    try:
        a = svc.submit(1, label=0, spec=spec)
        b = svc.submit(2, label=1, spec=spec)
        assert svc.step_once() == 2 and svc.stats["compiles"] == 1
        assert a.result.shape == (1, 16, 16, 1) and b.error is None
        first = svc.submit(3, label=1, spec=spec, seed=5)
        svc.step_once()
        second = svc.submit(3, label=1, spec=spec, seed=5)
        svc.step_once()
        assert svc.stats["compiles"] == 1 and svc.stats["graph_pool_gb"] > 0
        np.testing.assert_array_equal(first.result, second.result)
        fn = make_eps_fn_p(model, "per_sample")
        y = torch.tensor([1, 1, 1, 2], device=cuda)
        want = ts.ddim_sample(s, lambda *a: fn(model, *a), (4, 16, 16, 1),
                              torch.Generator(device=cuda).manual_seed(5),
                              num_steps=5, y=y, null_label=2)
        np.testing.assert_array_equal(first.result, want[:3].cpu().numpy())
    finally:
        svc.close()


@pytest.mark.cuda
def test_service_device_timer_on_card(cuda):
    """``stats["device_ms_total"]`` grows by each batch's device time (CUDA
    events around its draws and replays): more than nothing, less than the
    host's time around the batch, and the same for every batch of one
    spec once its graph is captured."""
    import time

    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.models.unet import CondUNet
    from superdiff_torch.serve import SampleSpec, SamplerService

    model = CondUNet(resolution=16, base_channels=32, channel_mults=(1, 2),
                     num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
                     num_classes=2, time_emb_dim=32, groups=8,
                     device=cuda).init_parameters(4).eval()
    svc = SamplerService(model, make_schedule(20, device=cuda),
                         resolution=16, conditional=True, batch_size=4,
                         autostart=False)
    spec = SampleSpec("ddim", 5)
    grown = []
    try:
        for n in (1, 2, 4, 3):
            before = svc.stats["device_ms_total"]
            svc.submit(n, label=1, spec=spec)
            tic = time.perf_counter()
            assert svc.step_once() == 1
            wall_ms = (time.perf_counter() - tic) * 1e3
            grown.append(svc.stats["device_ms_total"] - before)
            assert 0 < grown[-1] < wall_ms
    finally:
        svc.close()
    # after the first batch (the capture) every batch replays one graph
    assert max(grown[1:]) < 2 * min(grown[1:])


# ---- the data layer and the SmallCNN extractor (kernel B4 in float32) ----

SMALLCNN_SHAPES = [(16, 128, 128, 32), (16, 64, 64, 64), (16, 32, 32, 128),
                   (16, 16, 16, 256), (16, 8, 8, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", SMALLCNN_SHAPES)
def test_b4_at_the_smallcnn_shapes_matches_plain_on_card(cuda, B, H, W, C):
    """The SmallCNN's chains (float32, G=8, Flax's eps 1e-6): B4 within
    1e-4 of the plain chain, a rerun the same bits, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(C)
    x = 0.5 + 2 * torch.randn((B, H, W, C), generator=g, device=cuda)
    gamma = 1 + 0.1 * torch.randn((C,), generator=g, device=cuda)
    beta = 0.1 * torch.randn((C,), generator=g, device=cuda)
    fn.reset_launches()
    y = fn.fused_groupnorm_silu(x, gamma, beta, 8, eps=1e-6)
    assert fn.launches_by_shape == {(H, W, C, 8, False, "float32"): 1}
    ref = fn.gn_silu_plain(x, gamma, beta, 8, eps=1e-6)
    assert (y - ref).abs().max().item() < 1e-4
    assert torch.equal(y, fn.fused_groupnorm_silu(x, gamma, beta, 8,
                                                  eps=1e-6))


@pytest.mark.cuda
def test_smallcnn_extractor_runs_its_chains_through_b4_on_card(
        cuda, monkeypatch):
    """The trained extractor at 256², batch 16: 5 B4 launches per batch,
    one per chain shape; its features within 1e-4 (relative L2) of the
    same network with the plain chain in B4's place."""
    import os

    from superdiff_torch.analysis import FeatureExtractor

    npz = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "extractors",
        "smallcnn_trained_256.npz")
    ex = FeatureExtractor("classifier", checkpoint=npz, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((16, 256, 256, 1), generator=g, device=cuda) * 2 - 1
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    fn.reset_launches()
    got = torch.from_numpy(ex.extract(x))
    assert fn.launches_by_shape == {
        (H, W, C, 8, False, "float32"): 1
        for _, H, W, C in SMALLCNN_SHAPES}
    monkeypatch.setattr(fn, "_gn_silu_cuda", lambda x, gamma, beta, G,
                        scale, shift, eps: fn.gn_silu_plain(
                            x, gamma, beta, G, scale, shift, eps))
    want = torch.from_numpy(ex.extract(x))
    assert got.shape == (16, 256)
    assert (torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 1e-4


def _png_tree(root, per_class=12):
    """root/TB/{train,val,test}/{NORMAL,TB}/*.png written without PIL."""
    import numpy as np

    from superdiff_torch.data import split_dataset
    from superdiff_torch.utils.visualization import png_bytes

    rng = np.random.default_rng(0)
    for cls in ("NORMAL", "TB"):
        d = root / "flat" / cls
        d.mkdir(parents=True)
        for i in range(per_class):
            img = rng.integers(0, 256, (20 + i, 24), dtype=np.uint8)
            (d / f"{i}.png").write_bytes(png_bytes(img, filter=i % 5))
    split_dataset(str(root / "flat"), str(root / "tree" / "TB"))
    return str(root / "tree")


@pytest.mark.cuda
def test_device_batches_on_card_equal_the_cpu_result(cuda, tmp_path):
    """DataModule.device_batches on the card gives the CPU's batches (no
    augmentation draws: the test split, and train with augmentation none)
    within one float32 ulp of 1: the card divides by the scalar 255 as a
    product with its reciprocal, one rounding more than the CPU's
    division; labels equal."""
    from superdiff_torch import config as tcfg
    from superdiff_torch.data import DataModule

    root = _png_tree(tmp_path)
    cfg = tcfg.load_config(None, ["training.resolution=16",
                                  "training.batch_size=4",
                                  "training.augmentation=none",
                                  "training.use_native_loader=false"])
    cfg.task = "TB"
    for split in ("test", "train"):
        on_card = list(DataModule(cfg, root).device_batches(split, None,
                                                            device=cuda))
        on_cpu = list(DataModule(cfg, root).device_batches(split, None,
                                                           device="cpu"))
        assert len(on_card) == len(on_cpu) > 0
        for a, b in zip(on_card, on_cpu):
            assert a["image"].device.type == cuda.type
            torch.testing.assert_close(a["image"].cpu(), b["image"], rtol=0,
                                       atol=2.0 ** -23)
            assert torch.equal(a["label"].cpu(), b["label"])


@pytest.mark.cuda
def test_native_loader_feeds_a_train_step_on_card(cuda, tmp_path):
    """NativeBatchIterator's uint8 batches (shard built from a PNG tree)
    drive a CUDA train step of a small CondUNet: augmented and normalized
    inside the step, the loss finite, the step counted."""
    from superdiff_torch import config as tcfg
    from superdiff_torch.data import DataModule
    from superdiff_torch.data.native_loader import NativeBatchIterator
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.models.unet import CondUNet
    from superdiff_torch.training.state import create_train_state
    from superdiff_torch.training.steps import make_train_step

    root = _png_tree(tmp_path)
    cfg = tcfg.load_config(None, ["training.resolution=16",
                                  "training.batch_size=4"])
    cfg.task = "TB"
    it = DataModule(cfg, root).iterator("train")
    assert isinstance(it, NativeBatchIterator)
    model = CondUNet(resolution=16, base_channels=32, channel_mults=(1, 2),
                     num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
                     num_classes=2, time_emb_dim=32, groups=8,
                     device=cuda).init_parameters(0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = create_train_state(model, gen)
    step = make_train_step(make_schedule(20, device=cuda), conditional=True,
                           augmentation="low")
    n = 0
    for b in it:
        batch = {"image": torch.from_numpy(b["image"]).to(cuda),
                 "label": torch.from_numpy(b["label"]).long().to(cuda)}
        assert batch["image"].dtype == torch.uint8
        state, m = step(state, batch)
        assert torch.isfinite(m["loss"]).item()
        n += 1
    assert n == len(it) > 0 and state.step == n


@pytest.mark.cuda
def test_distill_step_launches_on_card(cuda):
    """One distillation step of a small conditional CondUNet (bf16 compute
    and norms): the teacher's two calls under no_grad launch B1 and B4 as
    two sampling calls do, the student's forward B1 once per attention
    layer and its backward B2 and B3 as often, and its chains no B4 (they
    run under autograd); the loss is finite."""
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.distill import make_distill_step
    from superdiff_torch.inference import make_eps_fn_p
    from superdiff_torch.models.unet import CondUNet
    from superdiff_torch.training.state import create_train_state

    kw = dict(resolution=16, base_channels=32, channel_mults=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
              num_classes=2, time_emb_dim=32, groups=8,
              compute_dtype=torch.bfloat16, norm_dtype=torch.bfloat16,
              device=cuda)
    teacher = CondUNet(**kw).init_parameters(0).eval().requires_grad_(False)
    student = CondUNet(**kw, parameterization="v")
    student.load_state_dict(teacher.state_dict())
    sched = make_schedule(40, device=cuda)
    tfn = make_eps_fn_p(teacher, "per_sample", schedule=sched)
    x = torch.randn((4, 16, 16, 1), device=cuda)
    t = torch.full((4,), 30, device=cuda)
    y = torch.tensor([0, 1, 2, 0], device=cuda)
    fa.reset_launches()
    fn.reset_launches()
    with torch.no_grad():
        tfn(teacher, x, t, y)
    torch.cuda.synchronize()
    b1_call, b4_call = fa.launches, fn.launches
    assert b1_call > 0 and b4_call > 0
    state = create_train_state(student, torch.Generator(device=cuda)
                               .manual_seed(0))
    step = make_distill_step(sched, tfn, 2, conditional=True,
                             parameterization="v", null_prob=0.5,
                             null_label=teacher.null_label)
    batch = {"image": torch.randint(0, 256, (4, 16, 16, 1), device=cuda,
                                    dtype=torch.uint8),
             "label": torch.tensor([0, 1, 1, 0], device=cuda)}
    fa.reset_launches()
    fn.reset_launches()
    state, m = step(state, teacher, batch)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches,
            fn.launches) == (3 * b1_call, b1_call, b1_call, 2 * b4_call)
    assert torch.isfinite(m["loss"]).item() and state.step == 1


@pytest.mark.cuda
def test_jpeg_fixtures_decode_to_the_manifest_on_card(cuda):
    """On the card's machine (no PIL there) every committed JPEG fixture
    decodes to the shape and SHA-256 of PIL's bits in the manifest."""
    import hashlib
    import json
    import os

    from superdiff_torch.data import image_io

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_jpeg")
    with open(os.path.join(root, "manifest.json")) as f:
        entries = json.load(f)["files"]
    assert entries
    for e in entries:
        img = image_io.read_gray(os.path.join(root, e["name"]))
        assert list(img.shape) == e["shape"], e["name"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == e["sha256"], \
            e["name"]


@pytest.mark.cuda
def test_graphed_trajectory_frames_equal_eager_on_card(cuda):
    """A captured sampler step records the eager run's 8 trajectory frames
    and samples bit for bit (the frames are copied between replays)."""
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.samplers import DDPMPlan
    from superdiff_torch.models.unet import CondUNet

    s = make_schedule(40, device=cuda)
    m = CondUNet(resolution=16, base_channels=16, channel_mults=(1, 2),
                 num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
                 num_classes=0, time_emb_dim=32, groups=4,
                 device="cpu").init_parameters(1).to(cuda).eval()
    fn_ = lambda x, t: m(x, t)

    def run(capture):
        sampler = GraphedSampler(DDPMPlan(s, fn_, (4, 16, 16, 1)),
                                 capture=capture)
        assert (sampler.graph is not None) == capture
        return sampler(torch.Generator(device=cuda).manual_seed(3),
                       num_frames=8)

    x, frames = run(True)
    ex, eframes = run(False)
    assert frames.shape == (8, 4, 16, 16, 1)
    assert torch.equal(x, ex) and torch.equal(frames, eframes)
    assert torch.equal(frames[-1], x)


@pytest.mark.cuda
def test_smallcnn_gradcam_through_b4_matches_plain_on_card(cuda,
                                                          monkeypatch):
    """Grad-CAM of the SmallCNN at 256²: 3 B4 launches per image (the
    feature map runs without gradients), the CAM within 1e-5 of the plain
    chain's (cuDNN's TF32 off), the same class."""
    from superdiff_torch.analysis import SmallCNN
    from superdiff_torch.analysis.gradcam import compute_gradcam

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = SmallCNN(2, device="cpu").init_parameters(4).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    img = torch.rand((256, 256, 1), generator=g, device=cuda)
    fn.reset_launches()
    cam, pred = compute_gradcam(model, img)
    assert fn.launches == 3 and cam.shape == (32, 32)
    monkeypatch.setattr(fn, "_gn_silu_cuda", lambda x, gamma, beta, G,
                        scale, shift, eps: fn.gn_silu_plain(
                            x, gamma, beta, G, scale, shift, eps))
    want, wpred = compute_gradcam(model, img)
    assert pred == wpred
    assert abs(cam - want).max() < 1e-5


@pytest.mark.cuda
def test_stacked_call_runs_b1_and_b4_through_their_ops_in_a_graph_on_card(
        cuda):
    """Two toy CondUNets stacked by ``stack_eps_fns``: one eager call
    launches B1 once per attention block (both models' rows in one launch)
    and B4 once per chain per model; the call captures in a CUDA graph and
    its replay gives the eager bits; the stacked output is within bf16
    rounding of the two sequential calls."""
    from superdiff_torch.inference import make_eps_fn, make_stacked_eps_fn
    from superdiff_torch.models.unet import CondUNet

    cfg = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
               attn_resolutions=(16,), num_heads=2, num_classes=2,
               time_emb_dim=32, groups=8, compute_dtype=torch.bfloat16,
               norm_dtype=torch.bfloat16)
    models = [CondUNet(resolution=32, device=cuda, **cfg).init_parameters(s)
              .eval() for s in (1, 2)]
    with torch.no_grad():           # no layer left at its zero init
        for m in models:
            for p in m.parameters():
                p.add_(0.02 * torch.randn_like(p))
    fn_ = make_stacked_eps_fn(models, label=1)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 32, 32, 1), device=cuda, generator=g)
    t = torch.tensor([10, 200, 500, 900], device=cuda)
    fa.reset_launches()
    fn.reset_launches()
    with torch.no_grad():
        eager = fn_(x, t)
        torch.cuda.synchronize()
        n_attn = sum(1 for n, _ in models[0].named_children() if "attn" in n)
        assert fa.launches == n_attn
        assert fn.launches == 2 * (2 * sum(
            1 for n, _ in models[0].named_children() if "block" in n) + 1)
        two = torch.stack([make_eps_fn(m, 1)(x, t) for m in models])
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn_(x, t)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            out = fn_(x, t)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
    rel = (torch.linalg.norm((eager - two).float())
           / torch.linalg.norm(two.float())).item()
    assert rel < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_hops_match_the_whole_sequence_on_card(cuda, dtype):
    """parallel/cp.py's hop arithmetic in one process over 4 chunks: B1 per
    key/value chunk merged by lse, B2/B3 per chunk with the merged lse and
    delta, against B1/B2/B3 on the whole sequence."""
    from superdiff_torch.parallel import cp

    B, S, H, D, n = 2, 512, 2, 64, 4
    per = S // n
    q, k, v, g = _fused_qkv(B, S, H, D, dtype, cuda) + [
        torch.randn((B, S, H, D), device=cuda).to(dtype)]
    chunk = lambda a, i: a[:, i * per:(i + 1) * per]
    outs, dq = [], []
    dk = [torch.zeros((B, per, H, D), device=cuda) for _ in range(n)]
    dv = [torch.zeros((B, per, H, D), device=cuda) for _ in range(n)]
    for i in range(n):
        out = lse = None
        for j in range(n):
            s = (i + j) % n
            out, lse = cp.merge(out, lse, *fa._flash_forward(
                chunk(q, i), chunk(k, s), chunk(v, s)))
        out = out.to(dtype)
        outs.append(out)
        delta = fa._bwd_delta(out, chunk(g, i))
        acc = torch.zeros((B, per, H, D), device=cuda)
        for j in range(n):
            s = (i + j) % n
            a, b, c = fa.flash_backward_hop(chunk(q, i), chunk(k, s),
                                            chunk(v, s), chunk(g, i), lse,
                                            delta)
            acc += a.float()
            dk[s] += b.float()
            dv[s] += c.float()
        dq.append(acc)
    ref_out, ref_lse = fa._flash_forward(q, k, v)
    ref = fa._flash_backward(q, k, v, ref_out, ref_lse, g)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(torch.cat(outs, 1).float(), ref_out.float(),
                               rtol=tol, atol=tol)
    for got, want in zip((dq, dk, dv), ref):
        got = torch.cat(got, 1)
        assert ((got - want.float()).abs().max()
                <= tol * want.float().abs().max())


@pytest.mark.cuda
def test_pipeline_on_one_card_matches_the_full_call(cuda):
    from superdiff_torch.models.unet import CondUNet
    from superdiff_torch.parallel import pp

    model = CondUNet(resolution=32, device=cuda, base_channels=32,
                     channel_mults=(1, 2), num_res_blocks=1,
                     attn_resolutions=(16,), num_heads=2, num_classes=2,
                     time_emb_dim=32, groups=8).init_parameters(3).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn_like(p))
    fn_ = pp.make_pp_denoiser(model, devices=(cuda, cuda),
                              num_microbatches=2)
    x = torch.randn((4, 32, 32, 1), device=cuda)
    t = torch.tensor([1, 50, 300, 999], device=cuda)
    y = torch.tensor([0, 1, 2, 1], device=cuda)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # float32 convolutions
    try:
        with torch.no_grad():
            torch.testing.assert_close(fn_(x, t, y), model(x, t, y),
                                       rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _train_setup(dev, preset="wide256", seed=0, grad_accum=1, **model_kw):
    """A train state (Adam with a warmup and clipping, EMA 0.995) and the
    train step of ``preset`` (class-conditional, label drop 0.1)."""
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.models.presets import build_model
    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)
    from superdiff_torch.training.steps import make_train_step

    model = build_model(preset, device=dev, **model_kw).init_parameters(seed)
    state = create_train_state(
        model, torch.Generator(device=dev).manual_seed(seed),
        tx=make_optimizer(learning_rate=2e-4, grad_clip_norm=1.0,
                          warmup_steps=2), ema_decay=0.995)
    step = make_train_step(make_schedule(1000, device=dev), conditional=True,
                           cfg_drop_prob=0.1, null_label=model.null_label,
                           grad_accum=grad_accum)
    return state, step


def _train_batches(dev, n, B=16, R=256):
    from superdiff_torch.data.synthetic import synthetic_xray_batch

    out = []
    for i in range(n):
        imgs, labels = synthetic_xray_batch(B, R, seed=100 + i)
        out.append({"image": torch.from_numpy(imgs).to(dev),
                    "label": torch.from_numpy(labels).long().to(dev)})
    return out


def _leaves(state):
    return {"params": [p.detach().clone() for p in state.params],
            "mu": [t.clone() for t in state.opt_state["mu"]],
            "nu": [t.clone() for t in state.opt_state["nu"]],
            "ema": [p.clone() for p in state.ema_params]}


def _worst_leaf_gap(a, b):
    """The largest ``|a - b| / |b|`` over the leaves of every group (0
    where both are 0), and where it is: ``(gap, group, leaf index)``."""
    worst = (0.0, None, None)
    for k in a:
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            num = torch.linalg.vector_norm((x - y).float()).item()
            den = torch.linalg.vector_norm(y.float()).item()
            gap = num / den if den else num
            if gap > worst[0]:
                worst = (gap, k, i)
    return worst


@pytest.mark.cuda
def test_graphed_train_step_equals_the_eager_step_on_card(cuda):
    """wide256 at batch 16, 5 steps: the split step (one warm-up step, then
    one capture and replays) against the eager step from the same weights,
    fed the same draws by injection (which takes the eager path). The
    graphed run's draws are the injected ones bit for bit; loss,
    parameters, moments and EMA are the same bits (both run one body and
    read the per-step numbers from a tensor); the captured step holds
    8 launches each of B1, B2 and B3 and 51 each of B4's forward and
    backward; the peak memory stays within 2.5x the eager step's."""
    from superdiff_torch.training import steps

    torch.backends.cudnn.deterministic = True
    try:
        batches = _train_batches(cuda, 5)
        state, step = _train_setup(cuda)
        g = torch.Generator(device=cuda).manual_seed(0)
        draws, eager_losses = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            d = {"drop": torch.rand((16,), generator=g, device=cuda) < 0.1,
                 "t": torch.randint(0, 1000, (16,), generator=g,
                                    device=cuda),
                 "noise": torch.randn(b["image"].shape, generator=g,
                                      device=cuda)}
            draws.append(d)
            state, m = step(state, b, d)
            eager_losses.append(m["loss"])
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated()
        eager = _leaves(state)
        del state, step
        torch.cuda.empty_cache()

        steps.reset_counts()
        fa.reset_launches()
        fn.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        state, step = _train_setup(cuda)
        losses = []
        for i, b in enumerate(batches):
            state, m = step(state, b)
            losses.append(m["loss"])
            got = step.split.draws[0]
            for k in ("drop", "t", "noise"):
                assert torch.equal(got[k], draws[i][k]), (i, k)
        torch.cuda.synchronize()
        graphed_peak = torch.cuda.max_memory_allocated()
        assert (steps.captures, steps.replays, steps.eager_steps) == (1, 4, 1)
        assert state.step == 5 and state.opt_state["count"] == 5
        assert torch.equal(state.generator.get_state(), g.get_state())
        for counts in (fa.captured_by_shape, fa.bwd_dq_captured_by_shape,
                       fa.bwd_dkv_captured_by_shape):
            assert sum(counts.values()) == 8
        for counts in (fn.captured_by_shape, fn.bwd_captured_by_shape):
            assert sum(counts.values()) == 51
        assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) \
            == (16, 16, 16)                 # the warm-up and the capture
        gap, group, leaf = _worst_leaf_gap(_leaves(state), eager)
        loss_gap = max(abs(a.item() - b.item()) / abs(b.item())
                       for a, b in zip(losses, eager_losses))
        print(f"graphed vs eager: worst leaf {gap:.3e} ({group} {leaf}), "
              f"loss {loss_gap:.3e}, peak {graphed_peak / 1e9:.2f} / "
              f"{eager_peak / 1e9:.2f} GB")
        assert gap == 0.0 and loss_gap == 0.0
        assert graphed_peak <= 2.5 * eager_peak
        # the metrics are copies: the next replay does not touch them
        kept = [v.item() for v in losses]
        state, _ = step(state, batches[0])
        assert [v.item() for v in losses] == kept
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_graphed_loss_gradients_equal_the_eager_ones_on_card(cuda):
    """wide256's loss and parameter gradients at batch 4 under the training
    policy (B1-B3, and B4's forward and backward at every chain), captured
    into a CUDA graph and replayed, equal the eager call's bit for bit."""
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.process import p_losses
    from superdiff_torch.models.presets import build_model

    torch.backends.cudnn.deterministic = True
    try:
        model = build_model("wide256", device=cuda).init_parameters(0)
        params = [p for p in model.parameters()]
        sched = make_schedule(1000, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(3)
        x = torch.randn((4, 256, 256, 1), generator=g, device=cuda)
        noise = torch.randn(x.shape, generator=g, device=cuda)
        t = torch.tensor([3, 300, 600, 999], device=cuda)
        y = torch.tensor([0, 1, 2, 1], device=cuda)

        def grads():        # the loss detached: no graph outlives a call
            loss = p_losses(sched, model, x, t, y=y, noise=noise)
            return (loss.detach(), *torch.autograd.grad(loss, params))

        want = grads()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            grads()
        torch.cuda.current_stream().wait_stream(side)
        fn.reset_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = grads()
        assert sum(fn.captured_by_shape.values()) == 51
        assert sum(fn.bwd_captured_by_shape.values()) == 51
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o, w)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_a_restore_between_replays_keeps_the_graph_on_card(cuda, tmp_path):
    """Three graphed steps, a checkpoint, one more step, the restore (in
    place), two more steps: the state equals five straight steps bit for
    bit, and the restore kept the one graph."""
    from superdiff_torch.checkpoint import CheckpointManager
    from superdiff_torch.training import steps

    torch.backends.cudnn.deterministic = True
    try:
        batches = _train_batches(cuda, 5)
        state, step = _train_setup(cuda)
        for b in batches:
            state, _ = step(state, b)
        straight = _leaves(state)
        del state, step
        torch.cuda.empty_cache()

        steps.reset_counts()
        state, step = _train_setup(cuda)
        ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
        for b in batches[:3]:
            state, _ = step(state, b)
        ckpt.save(state, force=True)
        state, _ = step(state, batches[3])
        state = ckpt.restore(state)
        assert state.step == 3
        for b in batches[3:]:
            state, _ = step(state, b)
        ckpt.close()
        assert (steps.captures, steps.replays, steps.eager_steps) == (1, 5, 1)
        assert _worst_leaf_gap(_leaves(state), straight)[0] == 0.0
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_graphed_train_step_with_remat_and_accumulation_on_card(cuda):
    """A small CondUNet with ``remat`` and ``grad_accum=2``: the graphed
    steps equal the eager steps on the same draws bit for bit."""
    from superdiff_torch.training import steps

    kw = dict(preset="small64", resolution=32, remat=True, grad_accum=2)
    batches = _train_batches(cuda, 4, B=8, R=32)
    torch.backends.cudnn.deterministic = True
    try:
        state, step = _train_setup(cuda, **kw)
        g = torch.Generator(device=cuda).manual_seed(0)
        for b in batches:
            d = [{"drop": torch.rand((4,), generator=g, device=cuda) < 0.1,
                  "t": torch.randint(0, 1000, (4,), generator=g,
                                     device=cuda),
                  "noise": torch.randn((4, 32, 32, 1), generator=g,
                                       device=cuda)} for _ in range(2)]
            state, _ = step(state, b, d)
        eager = _leaves(state)
        steps.reset_counts()
        state, step = _train_setup(cuda, **kw)
        for b in batches:
            state, _ = step(state, b)
        assert (steps.captures, steps.replays) == (1, 3)
        gap, group, leaf = _worst_leaf_gap(_leaves(state), eager)
        print(f"remat + grad_accum=2, graphed vs eager: worst leaf {gap:.3e}"
              f" ({group} {leaf})")
        assert gap == 0.0
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,D", [(2, 4096, 77, 5, 64),
                                          (2, 4096, 4096, 5, 64),
                                          (3, 1024, 13, 2, 32),
                                          (1, 256, 130, 2, 128),
                                          (2, 64, 77, 20, 64)])
def test_kernel_with_keys_of_their_own_length_matches_plain_on_card(
        cuda, B, Sq, Skv, H, D, dtype):
    """Cross-attention (Stable Diffusion's 77 text tokens, a key tile left
    partial) and self-attention at 4,096 positions: B1 against its plain
    version, tolerances as in the self-attention test; a rerun gives the
    same bits; the launch is counted under ``(Sq, D, dtype, Skv)`` where
    ``Skv`` differs from ``Sq``."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dtype)
    kv = torch.randn((B, Skv, 2 * H * D), generator=g, device=cuda).to(dtype)
    k, v = (a.view(B, Skv, H, D) for a in kv.split(H * D, dim=-1))
    fa.reset_launches()
    out, lse = fa._flash_forward(q, k, v)
    torch.cuda.synchronize()
    key = (Sq, D, str(dtype)[6:]) + ((Skv,) if Skv != Sq else ())
    assert fa.launches_by_shape == {key: 1}
    ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
    _assert_out_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    out2, lse2 = fa._flash_forward(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def _sd_weights(shapes, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = {}
    for name, shape in shapes.items():
        w = torch.randn(shape, generator=g, device=dev)
        if len(shape) > 1:
            w = w * math.prod(shape[1:]) ** -0.5
        elif "norm" in name and name.endswith("weight"):
            w = 1.0 + 0.1 * w
        else:
            w = 0.05 * w
        P[name] = w
    return P


@pytest.mark.cuda
def test_sd21base_call_under_the_sampling_policy_on_card(cuda):
    """One full-width ``sd21base`` call at 2 images (4 rows, the guided
    pair) under ``apply_sampling_policy``: B1 runs all 32 attention
    products (16 self, 16 cross-attention to 77 tokens) and B4 all 45
    GroupNorm -> SiLU chains, and the output holds to the float32 plain
    reference (TF32 off) on the same bf16-rounded weights within 5e-2
    relative L2: bf16 roundings carried through ~70 layers in series."""
    import plain_sd_unet as plain

    from superdiff_torch.inference import _keeps_f32, apply_sampling_policy
    from superdiff_torch.models.presets import build_model

    shapes = plain.param_shapes(dict(
        widths=(320, 640, 1280, 1280), heads=(5, 10, 20, 20),
        cross_levels=(True, True, True, False), layers_per_block=2,
        context_dim=1024, in_channels=4, out_channels=4))
    P = _sd_weights(shapes, cuda)
    model = build_model("sd21base", num_classes=0,
                        compute_dtype=torch.bfloat16, device="meta")
    model = model.to_empty(device=cuda)
    model.load_state_dict(P, strict=True)
    apply_sampling_policy(model.eval())
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 64, 64, 4), generator=g, device=cuda)
    t = torch.tensor([980, 980, 500, 500], device=cuda)
    ctx = torch.randn((4, 77, 1024), generator=g, device=cuda)
    fa.reset_launches()
    fn.reset_launches()
    with torch.no_grad():
        out = model(x, t, ctx)
        torch.cuda.synchronize()
        assert fa.launches == 32 and fn.launches == 45
        assert sum(n for k, n in fa.launches_by_shape.items()
                   if len(k) == 4 and k[3] == 77) == 16
        ref_P = {k: v if _keeps_f32(k) else v.bfloat16().float()
                 for k, v in P.items()}
        with plain.no_tf32():
            ref = plain.forward(ref_P, dict(
                widths=(320, 640, 1280, 1280), heads=(5, 10, 20, 20),
                cross_levels=(True, True, True, False), layers_per_block=2,
                groups=32, norm_eps=1e-5), x, t, ctx)
    rel = float((out.double() - ref.double()).norm() / ref.double().norm())
    print(f"sd21base bf16 policy vs float32 reference: rel L2 {rel:.3e}")
    assert out.dtype == torch.float32 and rel < 5e-2
