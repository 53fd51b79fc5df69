#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (superdiff_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the three kernel sources (csrc/flash_attn_fwd.cu,
   csrc/flash_attn_bwd.cu, csrc/group_norm_silu.cu), one nvcc each, started
   together; print the build time and the ptxas reports;
3. kernels vs their plain versions on the card, bf16 and f32:
   (a) the forward (B1) at the path's shapes (batch 16, and the CFG 2B batch)
       and at shapes with several K tiles, a ragged edge and D=128; a rerun
       must give the same bits; each row carries the launch geometry
       (ops/flash_attention.py::_fwd_geometry) and the instantiation's
       registers, spills and resident blocks per SM;
   (b) the backward kernels dQ (B2) and dK/dV (B3) at the three path shapes
       and a ragged D=128 shape, with a non-contiguous dO; a rerun must
       give the same bits; each row carries the launch geometry
       (ops/flash_attention.py::_bwd_geometry) and the instantiation's
       registers, spills and resident blocks per SM, the device time of
       the delta = rowsum(dO o O) expression that feeds both kernels, and
       B2 + B3 + delta beside SDPA's whole backward (which has its own
       delta pass);
   (c) the fused GroupNorm+FiLM+SiLU (B4) at the RefUNet's batch-16 shapes
       (C, G) = (1, 1), (64, 4), (128, 4), FiLM cases, group widths 3 and
       12, a ragged 7x9 image; a rerun must give the same bits;
   CUDA-event times of each kernel, its plain version and the library
   yardstick (F.scaled_dot_product_attention forward / backward for B1-B3;
   F.group_norm + F.silu for B4; timed only as yardsticks, the port never
   calls them), each kernel's own device time from the profiler, and for
   B1-B3 the device time of all kernels of the SDPA call (one
   torch.autograd.grad for the backward), so that kernel and yardstick
   compare device time with device time;
4. the sampling slice through the user entry points: the full-width wide256
   CondUNet with seeded random weights on every leaf, written as an exported
   run dir and loaded back through superdiff_torch.inference.load_run:
   (a) superdiff_torch.cli.sample DDPM-1000 at 256², batch 16, label 0;
   (b) one denoiser call at batch 2, bf16 kernel path on the card against the
       float32 plain path on the CPU; then the denoiser call's time at batch
       16 and a torch.profiler breakdown at batch 16 and 4; then every
       GroupNorm->(FiLM)->SiLU chain of one batch-16 call, counted by shape
       and timed against B4 on the same inputs (a measurement for a later
       decision; the CondUNet does not call B4);
   (c) superdiff_torch.cli.sample SuperDiff OR and AND of two differently
       seeded wide256 models, batch 4, T=1000;
   every run checks finite outputs and exactly 8 forward launches per
   denoiser call;
5. the training slice, full-width wide256 at 256², bf16 compute:
   (a) one loss at batch 2: gradients through the kernels against gradients
       through their plain versions on the card (relative L2 over all leaves,
       and per leaf for every attention block's qkv and proj weights);
   (b) superdiff_torch.cli.train --synthetic --device cuda at batch 16, 3
       epochs of 10 optimizer steps (the first is warm-up): images per
       second and ms per step of the last two, peak memory, validation loss
       finite and falling on the fixed stream, exactly 8/8/8 launches of
       B1/B2/B3 per train step and 8 of B1 per validation batch;
   (c) a short leg with model.remat=true and training.grad_accum=2 (16 B1
       launches per microbatch), and one in which this script swaps the
       backward kernels for autograd of the plain softmax attention, for its
       time only (the package has no such switch);
   (d) a train step alone on a fixed batch: CUDA-event time and a
       torch.profiler breakdown (device busy, idle share, B1+B2+B3 share);
   (e) resume at batch 4: 2 steps + checkpoint + 2 steps against 4 straight
       steps, every saved tensor bit for bit
       (torch.backends.cudnn.deterministic=True);
   (f) superdiff_torch.cli.export of the trained run, then cli.sample
       (DDIM, 20 steps) from it: finite samples;
6. the reference-model slice, full-width RefUNet (base 64, 256², float32):
   two reference-layout checkpoints (this script's torch rebuild of the
   reference UNet, seeds 1 and 2, saved as ema_epoch1.pt) through
   superdiff_torch.cli.import_torch, then
   (a) cli.sample DDPM-1000 at batch 16: finite, exactly 10 B4 launches per
       denoiser call and no B1;
   (b) one call at batch 2, B4 against the plain version on the card, and
       the same call bit-equal with PyTorch's cuDNN TF32 off and on (the
       RefUNet pins its convolutions to IEEE float32 itself); the call's
       time at batch 16 and a profile (device busy, idle, B4 share);
   (c) cli.sample SuperDiff OR of the two runs (TB x PNEUMONIA), batch 4,
       T=1000: finite samples and logq;
   (d) one wide256 call: 0 B4 launches (the CondUNet is untouched);
   (e) cli.train --synthetic on model.preset=ref, batch 4: loss finite and
       falling, 10 B4 launches per step and per validation batch; gradients
       of one loss at batch 2 with B4 against the plain version;
   these legs run under PyTorch's default (cuDNN TF32 on), as a user's
   CLI run does; the RefUNet's convolutions ignore it;
7. a JSON line per kernel shape, the card line, the kernels line, and last
   the result line {"ok": true, "device": {...}}.

float32 comparisons run with TF32 off (cudnn.allow_tf32=False, matmul
precision "highest"); phase 6 turns cuDNN's TF32 back on, PyTorch's default.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
IN_CHECKOUT = os.path.isdir(os.path.join(HERE, "superdiff_torch"))
if IN_CHECKOUT:
    sys.path.insert(0, HERE)
    from superdiff_torch.tools.timing import cuda_time_ms, kernel_device_ms
KERNEL_SRC = "superdiff_torch/csrc/flash_attn_fwd.cu"
TPU_KERNEL = "superdiff_tpu/ops/flash_attention.py:56"
BWD_SRC = "superdiff_torch/csrc/flash_attn_bwd.cu"
TPU_BWD_DQ = "superdiff_tpu/ops/flash_attention.py:189"
TPU_BWD_DKV = "superdiff_tpu/ops/flash_attention.py:221"
# H100 SXM peaks (NVIDIA data sheet): HBM, dense bf16 tensor core, f32 FMA;
# SFU exponentials: 16 per clock per SM.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SFU_PER_CLK_PER_SM = 16
NUM_SMS = 132
PATH_SHAPES = [(16, 1024, 4, 32), (16, 256, 4, 64), (16, 64, 4, 64)]
EXTRA_SHAPES = [(32, 1024, 4, 32), (2, 4096, 4, 64), (2, 1000, 2, 128)]
TOL = {"bfloat16": dict(out=2e-2, lse=2e-3), "float32": dict(out=1e-4,
                                                              lse=1e-4)}
SLICE_REL_TOL = 5e-2     # bf16 path vs float32 plain path, relative L2
BWD_SHAPES = PATH_SHAPES + [(2, 1000, 2, 128)]
# dQ/dK/dV against the plain version, relative to the gradient's largest
# entry: bf16 rounds P, dS and the result (2^-8 each); f32 differs only in
# summation order and exp2 vs exp.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# model gradients, kernels vs plain versions (bf16): all leaves pooled, and
# each attention block's qkv / proj weight on its own, so that a wrong dQ, dK
# or dV at one level cannot hide in the global norm
GRAD_REL_TOL = 1e-2
ATTN_LEAF_REL_TOL = 2e-2
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")
WIDE256 = ["--set", "model.preset=wide256", "--set",
           "training.resolution=256", "--set", "training.vis_every=0"]
GN_SRC = "superdiff_torch/csrc/group_norm_silu.cu"
TPU_GN = "superdiff_tpu/ops/fused_norm.py:78"
GN_KERNELS = ("gn_stats", "gn_finalize", "gn_apply")
# B4 shapes (B, H, W, C, G, film): the RefUNet path at batch 16 (first three,
# no FiLM), FiLM at a wide256 shape, group widths 3 and 12, ragged 7x9
GN_PATH_SHAPES = [(16, 256, 256, 1, 1, False), (16, 256, 256, 64, 4, False),
                  (16, 256, 256, 128, 4, False)]
GN_EXTRA_SHAPES = [(16, 128, 128, 128, 32, True), (4, 64, 64, 48, 16, True),
                   (16, 32, 32, 384, 32, True), (2, 7, 9, 64, 4, True),
                   (1, 7, 9, 1, 1, False)]
# B4 vs plain: f32 sums in another order and __expf; bf16 rounds the output
# once, a value near a rounding boundary may land one ulp away
GN_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
REF = ["--set", "model.preset=ref", "--set", "model.conditional=false",
       "--set", "training.resolution=256", "--set", "training.vis_every=0"]
REF_CALLS_B4 = 10        # GroupNorm->SiLU prologues per RefUNet call
# RefUNet kernel path vs plain path, one call / one gradient, float32 (its
# convolutions IEEE): only B4's summation order differs
REF_REL_TOL = 1e-4
REF_GRAD_REL_TOL = 1e-3


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def bound(B, S, H, D, dtype, sm_clock_hz, tensors=4, stats=1, products=2):
    """Least time for the function: bytes (each (B,S,H,D) tensor and each
    per-row f32 statistic moved once), tensor/FMA flops (2*S*S*D per head
    and product), and exponentials on the SFUs. Defaults: the forward (q,
    k, v, out; lse; 2 products). dQ: 5 tensors, lse and delta, 3 products;
    dK/dV: 6 tensors, 4 products."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * B * S * H * D * elt + stats * 4 * B * H * S
    t_bytes = nbytes / HBM_BPS
    t_flops = 2 * products * B * H * S * S * D / PEAK_FLOPS[dtype]
    t_exp = B * H * S * S / (SFU_PER_CLK_PER_SM * NUM_SMS * sm_clock_hz)
    t = max(t_bytes, t_flops, t_exp)
    by = "bytes" if t == t_bytes else "operations"
    detail = {t_bytes: "hbm", t_flops: "mma", t_exp: "exp"}[t]
    return t * 1e3, by, detail


def phase_kernels(fa, sm_clock_hz):
    """Kernel vs plain version at every listed shape and dtype."""
    import torch
    import torch.nn.functional as F

    rows = {}
    dev = torch.device("cuda")
    for (B, S, H, D) in PATH_SHAPES + EXTRA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            g = torch.Generator(device=dev).manual_seed(B * S + D)
            # q/k/v as strided views of one fused projection, the layout
            # SelfAttention2D hands the kernel
            qkv = torch.randn((B, S, 3 * H * D), generator=g,
                              device=dev).to(dtype)
            q, k, v = (a.view(B, S, H, D) for a in qkv.split(H * D, dim=-1))
            n0 = fa.launches
            out, lse = fa._flash_forward(q, k, v)
            torch.cuda.synchronize()
            if fa.launches != n0 + 1:
                raise AssertionError("kernel launch was not counted")
            ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            if not (torch.isfinite(out.float()).all() and
                    err <= TOL[dname]["out"] and
                    lse_err <= TOL[dname]["lse"]):
                raise AssertionError(
                    f"flash kernel disagrees with plain at {(B, S, H, D)} "
                    f"{dname}: out err {err:.3e}, lse err {lse_err:.3e}")
            out2, lse2 = fa._flash_forward(q, k, v)
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise AssertionError(f"flash kernel rerun at {(B, S, H, D)} "
                                     f"{dname} gave other bits")
            warps, bk, mt, grid, _ = fa._fwd_geometry(B, S, H, D,
                                                      q.element_size())
            plain_iters = 5 if S >= 4096 else 20
            ms = cuda_time_ms(lambda: fa._flash_forward(q, k, v), 50)
            dev_ms = kernel_device_ms(lambda: fa._flash_forward(q, k, v))
            plain_ms = cuda_time_ms(
                lambda: fa._flash_forward_plain(q, k, v), plain_iters)
            qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
            lib_ms = cuda_time_ms(sdpa, 50)
            lib_dev_ms = kernel_device_ms(sdpa, kernel=None)
            b_ms, b_by, b_detail = bound(B, S, H, D, dname, sm_clock_hz)
            row = dict(shape=[B, S, H, D], dtype=dname, max_abs_err=err,
                       lse_max_abs_err=lse_err, rerun_bit_equal=True, ms=ms,
                       kernel_device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_device_ms=lib_dev_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       bound_resource=b_detail, roofline_share=b_ms / ms,
                       device_roofline_share=b_ms / dev_ms
                       if isinstance(dev_ms, float) else "not measured",
                       geometry=dict(warps=warps, bk=bk, mt=mt,
                                     grid=list(grid),
                                     **fa.fwd_kernel_info(D, dtype, warps,
                                                          bk, mt)))
            rows[(B, S, H, D, dname)] = row
            log("kernel_check " + json.dumps(row))
    return rows


def phase_bwd_kernels(fa, sm_clock_hz):
    """dQ (B2) and dK/dV (B3) vs their plain versions at BWD_SHAPES."""
    import torch
    import torch.nn.functional as F

    rows = {}
    dev = torch.device("cuda")
    for (B, S, H, D) in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            gen = torch.Generator(device=dev).manual_seed(B * S + D + 1)
            fused = torch.randn((2, B, S, 3 * H * D), generator=gen,
                                device=dev).to(dtype)
            q, k, v = (a.view(B, S, H, D)
                       for a in fused[0].split(H * D, dim=-1))
            g = fused[1].split(H * D, dim=-1)[1].view(B, S, H, D)
            if g.is_contiguous():
                raise AssertionError("dO was meant to be a strided view")
            out, lse = fa._flash_forward(q, k, v)
            n_dq, n_dkv = fa.bwd_dq_launches, fa.bwd_dkv_launches
            got = fa._flash_backward(q, k, v, out, lse, g)
            torch.cuda.synchronize()
            if (fa.bwd_dq_launches, fa.bwd_dkv_launches) != (n_dq + 1,
                                                             n_dkv + 1):
                raise AssertionError("backward launches were not counted")
            ref = fa._flash_backward_plain(q, k, v, out, lse, g)
            errs = {}
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - b.float()).abs().max().item()
                peak = b.float().abs().max().item()
                errs[name] = err
                if not (torch.isfinite(a.float()).all()
                        and err <= BWD_TOL[dname] * peak):
                    raise AssertionError(
                        f"{name} disagrees with plain at {(B, S, H, D)} "
                        f"{dname}: err {err:.3e}, largest entry {peak:.3e}")
            delta = fa._bwd_delta(out, g)
            delta_dev_ms = kernel_device_ms(lambda: fa._bwd_delta(out, g),
                                            kernel=None)
            plain_iters = 10
            qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_()
                          for a in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            gh = g.transpose(1, 2).contiguous()
            sdpa_bwd = lambda: torch.autograd.grad(oh, (qh, kh, vh), gh,
                                                   retain_graph=True)
            lib_ms = cuda_time_ms(sdpa_bwd, 30)
            lib_dev_ms = kernel_device_ms(sdpa_bwd, kernel=None)
            shape_rows = []
            for kern, kname, launch, plain, shape_kw, mine in (
                    ("dq", "flash_bwd_dq_kernel", fa._flash_bwd_dq_cuda,
                     fa._flash_bwd_dq_plain,
                     dict(tensors=5, stats=2, products=3), got[:1]),
                    ("dkv", "flash_bwd_dkv_kernel", fa._flash_bwd_dkv_cuda,
                     fa._flash_bwd_dkv_plain,
                     dict(tensors=6, stats=2, products=4), got[1:])):
                call = lambda: launch(q, k, v, g, lse, delta)
                again = call()
                again = (again,) if kern == "dq" else again
                if not all(torch.equal(a, b) for a, b in zip(mine, again)):
                    raise AssertionError(f"{kern} rerun at {(B, S, H, D)} "
                                         f"{dname} gave other bits")
                ms = cuda_time_ms(call, 50)
                dev_ms = kernel_device_ms(call, kernel=(kname,))
                plain_ms = cuda_time_ms(
                    lambda: plain(q, k, v, g, lse, delta), plain_iters)
                b_ms, b_by, b_detail = bound(B, S, H, D, dname, sm_clock_hz,
                                             **shape_kw)
                warps, bt, mt, grid, _ = fa._bwd_geometry(
                    kern, B, S, H, D, q.element_size())
                err = errs["dq"] if kern == "dq" else max(errs["dk"],
                                                          errs["dv"])
                row = dict(kernel=kern, shape=[B, S, H, D], dtype=dname,
                           max_abs_err=err, rerun_bit_equal=True, ms=ms,
                           kernel_device_ms=dev_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_device_ms=lib_dev_ms,
                           library="SDPA backward (dQ, dK and dV together)",
                           bound_ms=b_ms, bound_by=b_by,
                           bound_resource=b_detail, roofline_share=b_ms / ms,
                           device_roofline_share=b_ms / dev_ms
                           if isinstance(dev_ms, float) else "not measured",
                           delta_device_ms=delta_dev_ms,
                           geometry=dict(warps=warps, bt=bt, mt=mt,
                                         grid=list(grid),
                                         **fa.bwd_kernel_info(
                                             kern, D, dtype, warps, bt, mt)))
                rows[(kern, B, S, H, D, dname)] = row
                shape_rows.append(row)
            # B2 + B3 + delta against SDPA's whole backward, which includes
            # its own delta pass: device time against device time
            parts = [r["kernel_device_ms"] for r in shape_rows]
            parts.append(delta_dev_ms)
            total = (sum(parts) if all(isinstance(x, float) for x in parts)
                     else "not measured")
            for row in shape_rows:
                row["b2_b3_delta_device_ms"] = total
                row["ratio_to_library_device"] = (
                    total / lib_dev_ms if isinstance(total, float)
                    and isinstance(lib_dev_ms, float) else "not measured")
                log("bwd_kernel_check " + json.dumps(row))
    return rows


def gn_inputs(B, H, W, C, film, dtype, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    x = (0.5 + 2 * r(B, H, W, C)).to(dtype)
    gamma, beta = 1 + 0.1 * r(C), 0.1 * r(C)
    scale = shift = None
    if film:
        scale, shift = 0.2 * r(B, C), 0.2 * r(B, C)
    return x, gamma, beta, scale, shift


def gn_library(x, gamma, beta, G, scale, shift):
    """The library yardstick of B4's function: ``F.group_norm`` on the
    channels-last NCHW view, the FiLM FMA where there is one, ``F.silu``
    (no single torch call computes the chain)."""
    import torch.nn.functional as F

    h = F.group_norm(x.permute(0, 3, 1, 2), G, gamma.to(x.dtype),
                     beta.to(x.dtype), 1e-5)
    if scale is not None:
        h = (h * (1 + scale.to(x.dtype))[:, :, None, None]
             + shift.to(x.dtype)[:, :, None, None])
    return F.silu(h)


def phase_gn_kernels(fn):
    """B4 against its plain version at every listed shape, f32 and bf16:
    times of the kernel (events and device), the plain version and the
    library chain, the bound (x read once, y written once) and the error."""
    import torch

    rows = {}
    for (B, H, W, C, G, film) in GN_PATH_SHAPES + GN_EXTRA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            x, gamma, beta, scale, shift = gn_inputs(B, H, W, C, film, dtype,
                                                     seed=C + G)
            call = lambda: fn.fused_groupnorm_silu(x, gamma, beta, G, scale,
                                                   shift)
            n0 = fn.launches
            y = call()
            torch.cuda.synchronize()
            if fn.launches != n0 + 1:
                raise AssertionError("B4 launch was not counted")
            ref = fn.gn_silu_plain(x, gamma, beta, G, scale, shift)
            err = (y.float() - ref.float()).abs().max().item()
            tol = GN_TOL[dname] * (1 + ref.float().abs()).max().item()
            if not (torch.isfinite(y.float()).all() and err <= tol
                    and torch.equal(y, call())):
                raise AssertionError(
                    f"B4 disagrees with plain (or with itself) at "
                    f"{(B, H, W, C, G, film)} {dname}: err {err:.3e}")
            big = x.numel() > 1 << 24
            row = dict(
                shape=[B, H, W, C], groups=G, film=film, dtype=dname,
                max_abs_err=err, ms=cuda_time_ms(call, 20 if big else 50),
                kernel_device_ms=kernel_device_ms(call, kernel=GN_KERNELS),
                plain_ms=cuda_time_ms(
                    lambda: fn.gn_silu_plain(x, gamma, beta, G, scale, shift),
                    5 if big else 20),
                library_ms=cuda_time_ms(
                    lambda: gn_library(x, gamma, beta, G, scale, shift),
                    20 if big else 50),
                library="F.group_norm + F.silu (+ FiLM FMA); no single "
                        "torch call computes the chain",
                bound_ms=2 * x.numel() * x.element_size() / HBM_BPS * 1e3,
                bound_by="bytes")
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            rows[(B, H, W, C, G, film, dname)] = row
            log("gn_kernel_check " + json.dumps(row))
            del x, y, ref
    torch.cuda.empty_cache()
    return rows


def wide256_norm_chains(fn, model):
    """Every GroupNorm->(FiLM)->SiLU chain one wide256 denoiser call runs at
    batch 16 under the bf16 sampling policy (ResBlock norm_0 / norm_1 and
    out_norm; the attention norm has no SiLU), counted by shape, then the
    port's chain as the model runs it against B4 on the same inputs. For a
    later decision only: the CondUNet does not call B4."""
    import torch
    import torch.nn.functional as F

    from superdiff_torch.models.layers import GroupNorm

    seen, hooks = {}, []
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, GroupNorm) and leaf in ("norm_0", "norm_1",
                                                 "out_norm"):
            def hook(mod, args, _out, film=(leaf == "norm_1")):
                x = args[0]
                key = (tuple(x.shape), mod.num_groups, film,
                       str(x.dtype).replace("torch.", ""))
                seen.setdefault(key, [mod, 0])[1] += 1
            hooks.append(m.register_forward_hook(hook))
    with torch.no_grad():
        model(torch.randn((16, 256, 256, 1), device="cuda"),
              torch.full((16,), 500, device="cuda", dtype=torch.long),
              torch.zeros((16,), device="cuda", dtype=torch.long))
    for h in hooks:
        h.remove()
    nd = model.norm_dtype
    rows, saved = [], {}
    for (shape, G, film, dname), (mod, count) in sorted(
            seen.items(), key=lambda kv: -kv[1][1] * kv[0][0][1]):
        B, H, W, C = shape
        x, _, _, scale, shift = gn_inputs(B, H, W, C, film,
                                          getattr(torch, dname), seed=C)
        w, b = mod.weight, mod.bias

        def chain():
            h = mod(x, nd)
            if film:
                h = (h * (1.0 + scale.to(nd)[:, None, None, :])
                     + shift.to(nd)[:, None, None, :])
            return F.silu(h)

        kern = lambda: fn.fused_groupnorm_silu(x, w, b, G, scale, shift)
        with torch.no_grad():
            row = dict(shape=list(shape), groups=G, film=film, dtype=dname,
                       launches_per_call=count,
                       chain_ms=cuda_time_ms(chain, 30),
                       b4_ms=cuda_time_ms(kern, 30),
                       chain_device_ms=kernel_device_ms(chain, kernel=None),
                       b4_device_ms=kernel_device_ms(kern, kernel=None),
                       max_abs_diff=(chain().float() - kern().float()
                                     ).abs().max().item())
        for k in ("", "device_"):
            a, b = row[f"chain_{k}ms"], row[f"b4_{k}ms"]
            measured = isinstance(a, float) and isinstance(b, float)
            saved[k] = (saved.get(k, 0.0) + count * (a - b)
                        if measured and saved.get(k, 0.0) != "not measured"
                        else "not measured")
        rows.append(row)
        log("wide256_chain " + json.dumps(row))
    return dict(rows=rows, chains_per_call=sum(r["launches_per_call"]
                                               for r in rows),
                sum_launches_x_chain_minus_b4_ms=saved[""],
                sum_launches_x_chain_minus_b4_device_ms=saved["device_"])


def reference_state_dict(seed, base=64, time_emb_dim=256):
    """A state dict in the reference trainer's own key layout
    (``downs.N.block.{0,2,3,5}``, ``mid``, ``ups.N``, ``time_mlp.{1,3}``,
    ``time_emb``), from this script's torch rebuild of its UNet: torch's
    default initialisation from ``seed``, GroupNorm affines moved off 1 / 0."""
    import torch
    from torch import nn

    torch.manual_seed(seed)

    def block(i, o):
        m = nn.Module()
        m.block = nn.Sequential(
            nn.GroupNorm(min(4, i), i), nn.SiLU(),
            nn.Conv2d(i, o, 3, padding=1), nn.GroupNorm(min(4, o), o),
            nn.SiLU(), nn.Conv2d(o, o, 3, padding=1))
        m.time_emb = nn.Linear(time_emb_dim, o)
        return m

    net = nn.Module()
    net.time_mlp = nn.Sequential(
        nn.Identity(), nn.Linear(time_emb_dim, 4 * time_emb_dim), nn.SiLU(),
        nn.Linear(4 * time_emb_dim, time_emb_dim))
    net.downs = nn.ModuleList([block(1, base), block(base, 2 * base)])
    net.mid = block(2 * base, 2 * base)
    net.ups = nn.ModuleList([block(2 * base, base), block(base, 1)])
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.GroupNorm):
                m.weight.add_(0.1 * torch.randn_like(m.weight))
                m.bias.add_(0.1 * torch.randn_like(m.bias))
    return net.state_dict()


def flash_counts(fa):
    return (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)


def run_train_cli(train_cli, work, run_id, batch, epochs, steps, extra=(),
                  model_args=WIDE256):
    """cli.train at 256² with the synthetic stream (full-width wide256
    unless ``model_args`` names another model); returns (run dir,
    metrics.jsonl rows)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main([
            "--synthetic", "--device", "cuda", "--experiment-id", "smoke",
            "--run-id", run_id, *model_args,
            "--set", f"training.batch_size={batch}",
            "--set", f"training.num_epochs={epochs}",
            "--set", f"training.steps_per_epoch={steps}",
            "--set", "training.save_every=0",
            "--set", "logging.stdout=false",
            "--set", f"paths.local_base={work}",
            "--set", f"paths.cluster_base={work}", *extra])
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    run_dir = os.path.join(work, "outputs", "PNEUMONIA",
                           f"experiment_smoke_run_{run_id}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    return run_dir, metrics


def epoch_rows(metrics, key):
    return [m for m in metrics if key in m]


def model_grad_check(fa, load_run, make_schedule, p_losses, run_dir):
    """One wide256 loss at batch 2 (bf16 compute, random weights on every
    leaf): parameter gradients through the kernels against gradients through
    their plain versions, both on the card."""
    import torch

    _, model, schedule = load_run(run_dir, device="cuda")
    model.train()
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    noise = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    t = torch.tensor([700, 20], device="cuda")
    y = torch.tensor([1, 2], device="cuda")
    names, params = zip(*model.named_parameters())

    def grads():
        loss = p_losses(schedule, model, x, t, y=y, noise=noise)
        return loss.item(), torch.autograd.grad(loss, params)

    fa.reset_launches()
    loss_k, g_kernel = grads()
    if flash_counts(fa) != (8, 8, 8):
        raise AssertionError(f"gradient check launched {flash_counts(fa)}, "
                             "expected (8, 8, 8)")
    kernels = (fa._flash_forward_cuda, fa._flash_backward_cuda)
    fa._flash_forward_cuda = fa._flash_forward_plain
    fa._flash_backward_cuda = fa._flash_backward_plain
    try:
        loss_p, g_plain = grads()
    finally:
        fa._flash_forward_cuda, fa._flash_backward_cuda = kernels
    if flash_counts(fa) != (8, 8, 8):
        raise AssertionError("the plain-version pass launched a kernel")
    num = sum(((a.float() - b.float()) ** 2).sum() for a, b in
              zip(g_kernel, g_plain)).sqrt().item()
    den = sum((b.float() ** 2).sum() for b in g_plain).sqrt().item()
    zero_leaves = sum(1 for b in g_plain if not b.abs().sum().item())
    rel = num / den
    if not (rel == rel and rel < GRAD_REL_TOL and zero_leaves == 0):
        raise AssertionError(f"model gradients, kernels vs plain: rel L2 "
                             f"{rel:.4e} (tolerance {GRAD_REL_TOL}), "
                             f"{zero_leaves} leaves with zero gradient")
    attn = {n: (torch.linalg.norm(a.float() - b.float())
                / torch.linalg.norm(b.float())).item()
            for n, a, b in zip(names, g_kernel, g_plain)
            if n.endswith((".qkv.weight", ".proj.weight"))}
    worst = max(attn, key=attn.get)
    if len(attn) != 16 or not attn[worst] < ATTN_LEAF_REL_TOL:
        raise AssertionError(f"attention leaves, kernels vs plain: "
                             f"{len(attn)} leaves (expected 16), worst "
                             f"{worst} rel L2 {attn[worst]:.4e} (tolerance "
                             f"{ATTN_LEAF_REL_TOL})")
    return dict(rel_l2=rel, loss_kernels=loss_k, loss_plain=loss_p,
                leaves=len(params), attn_leaves=len(attn),
                attn_leaf_worst=worst, attn_leaf_worst_rel_l2=attn[worst])


def math_backward(q, k, v, o, lse, g):
    """(dq, dk, dv) by autograd of the plain softmax attention: what the A/B
    leg puts in the backward kernels' place."""
    import torch

    from superdiff_torch.ops.attention import _math_attention

    with torch.enable_grad():
        qkv = [a.detach().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(_math_attention(*qkv), qkv, g)


def train_step_alone(fa, tcfg, model_from_config, make_schedule, training,
                     synthetic_xray_batch, batch=16, timed=10, profiled=3):
    """A train step on one fixed batch, through the package's own state and
    step constructors: CUDA-event time per step, then a torch.profiler breakdown
    (device busy, idle share, the flash kernels' share, top kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = tcfg.load_config(None, [a for a in WIDE256 if a != "--set"])
    model = model_from_config(cfg, device="cuda").init_parameters(0)
    schedule = make_schedule(1000, device="cuda")
    state = training.create_train_state(
        model, torch.Generator(device="cuda").manual_seed(0))
    step_fn = training.make_train_step(
        schedule, conditional=True, cfg_drop_prob=0.1,
        null_label=model.null_label)
    imgs, labels = synthetic_xray_batch(batch, 256, seed=0)
    data = {"image": torch.from_numpy(imgs).cuda(),
            "label": torch.from_numpy(labels).long().cuda()}
    for _ in range(3):
        step_fn(state, data)
    fa.reset_launches()
    step_ms = cuda_time_ms(lambda: step_fn(state, data), timed, warmup=0)
    if flash_counts(fa) != (8 * timed,) * 3:
        raise AssertionError(f"{timed} train steps launched "
                             f"{flash_counts(fa)}, expected 8 each per step")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(profiled):
            step_fn(state, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3 / profiled
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / profiled
    flash = {k: sum(v for n, v in by_name.items() if k in n) / 1e3 / profiled
             for k in FLASH_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    n_aten = sum(a.count for a in prof.key_averages()
                 if a.key.startswith("aten::"))
    return dict(
        batch=batch, step_ms_events=step_ms,
        images_per_s_step_alone=batch / step_ms * 1e3,
        wall_ms_per_step_profiled=wall_ms,
        device_busy_ms_per_step=busy_ms if busy_ms else "not measured",
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else
        "not measured",
        flash_kernels_ms_per_step=flash,
        flash_share_of_device=(sum(flash.values()) / busy_ms) if busy_ms
        else "not measured",
        aten_ops_per_step=n_aten / profiled,
        kernels_per_step=sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / profiled,
        top_kernels_ms_per_step=[[k[:80], v / 1e3 / profiled]
                                 for k, v in top])


def phase_training(fa, work, run1, tcfg, model_from_config, load_run,
                   sample):
    """The training slice (phase 5 of the module docstring)."""
    import numpy as np
    import torch

    from superdiff_torch import training
    from superdiff_torch.checkpoint import load_checkpoint_file
    from superdiff_torch.cli import export as export_cli
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.data.synthetic import synthetic_xray_batch
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.process import p_losses

    out = {}
    out["grad_check"] = model_grad_check(fa, load_run, make_schedule,
                                         p_losses, run1)
    log("phase 5a model gradients, kernels vs plain versions on the card: "
        + json.dumps(out["grad_check"]))

    # (b) the main training leg: 3 epochs x 10 steps at batch 16
    B, EPOCHS, STEPS, VAL = 16, 3, 10, 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    tic = time.time()
    main_dir, metrics = run_train_cli(
        train_cli, work, "main", B, EPOCHS, STEPS,
        ["--set", f"training.eval_batches={VAL}"])
    main_s = time.time() - tic
    counts = flash_counts(fa)
    train_launches = dict(fwd=dict(fa.launches_by_shape),
                          dq=dict(fa.bwd_dq_launches_by_shape),
                          dkv=dict(fa.bwd_dkv_launches_by_shape))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = EPOCHS * STEPS
    expect = (8 * (n_steps + EPOCHS * VAL), 8 * n_steps, 8 * n_steps)
    if counts != expect:
        raise AssertionError(f"training launched (B1, B2, B3) = {counts}, "
                             f"expected {expect}")
    tr, va = epoch_rows(metrics, "avg_loss"), epoch_rows(metrics, "val_loss")
    losses = [m["avg_loss"] for m in tr] + [m["val_loss"] for m in va]
    if len(tr) != EPOCHS or len(va) != EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"training metrics incomplete or not finite: "
                             f"{metrics}")
    if not (va[-1]["val_loss"] < va[0]["val_loss"]
            and tr[-1]["avg_loss"] < tr[0]["avg_loss"]):
        raise AssertionError(f"loss did not fall: train {tr}, val {va}")
    ips = [m["images_per_sec"] for m in tr[1:]]
    out["train"] = dict(
        batch=B, steps=n_steps, steps_after_warmup=(EPOCHS - 1) * STEPS,
        images_per_s_by_epoch=[m["images_per_sec"] for m in tr],
        images_per_s=float(np.mean(ips)),
        ms_per_step=float(np.mean([B / v * 1e3 for v in ips])),
        train_loss_by_epoch=[m["avg_loss"] for m in tr],
        val_loss_by_epoch=[m["val_loss"] for m in va],
        grad_norm_last=tr[-1]["grad_norm"], peak_mem_gb=peak_gb,
        launches=dict(B1=counts[0], B2=counts[1], B3=counts[2]),
        launches_by_shape={k: {str(s): n for s, n in v.items()}
                           for k, v in train_launches.items()},
        whole_leg_s=main_s)
    log("phase 5b cli.train wide256 256² batch 16: "
        + json.dumps(out["train"]))

    # (c) remat + grad_accum=2, then the math backward, for their times
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    _, m_remat = run_train_cli(
        train_cli, work, "remat", B, 2, 4,
        ["--set", "model.remat=true", "--set", "training.grad_accum=2",
         "--set", "training.eval_every=0"])
    counts = flash_counts(fa)
    if counts != (32 * 8, 16 * 8, 16 * 8):
        raise AssertionError(f"remat + grad_accum=2 launched {counts} in 8 "
                             "steps, expected (256, 128, 128)")
    tr = epoch_rows(m_remat, "avg_loss")
    out["remat_accum2"] = dict(
        batch=B, ms_per_step=B / tr[-1]["images_per_sec"] * 1e3,
        images_per_s=tr[-1]["images_per_sec"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_per_step=dict(B1=32, B2=16, B3=16),
        train_loss_by_epoch=[m["avg_loss"] for m in tr])
    log("phase 5c remat + grad_accum=2: " + json.dumps(out["remat_accum2"]))
    fa.reset_launches()
    kernel_backward = fa._flash_backward_cuda
    fa._flash_backward_cuda = math_backward
    try:
        _, m_math = run_train_cli(train_cli, work, "mathbwd", B, 2, 10,
                                  ["--set", "training.eval_every=0"])
    finally:
        fa._flash_backward_cuda = kernel_backward
    if flash_counts(fa) != (160, 0, 0):
        raise AssertionError(f"math-backward leg launched "
                             f"{flash_counts(fa)}, expected (160, 0, 0)")
    tr = epoch_rows(m_math, "avg_loss")
    out["math_backward"] = dict(
        batch=B, ms_per_step=B / tr[-1]["images_per_sec"] * 1e3,
        images_per_s=tr[-1]["images_per_sec"])
    log("phase 5c math backward (time only): "
        + json.dumps(out["math_backward"]))

    # (d) a train step alone, timed and profiled
    out["step_profile"] = train_step_alone(
        fa, tcfg, model_from_config, make_schedule, training,
        synthetic_xray_batch)
    log("train_profile " + json.dumps(out["step_profile"]))
    torch.cuda.empty_cache()

    # (e) resume: 2 + 2 steps against 4 straight, bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        straight, _ = run_train_cli(train_cli, work, "straight", 4, 2, 2,
                                    ["--set", "training.eval_every=0"])
        run_train_cli(train_cli, work, "resumed", 4, 1, 2,
                      ["--set", "training.eval_every=0"])
        resumed, _ = run_train_cli(train_cli, work, "resumed", 4, 2, 2,
                                   ["--set", "training.eval_every=0"])
    finally:
        torch.backends.cudnn.deterministic = False
    a = load_checkpoint_file(os.path.join(straight, "checkpoints"), 4)
    b = load_checkpoint_file(os.path.join(resumed, "checkpoints"), 4)
    n_cmp = 0
    for part in ("params", "ema_params"):
        for key in a[part]:
            n_cmp += 1
            if not torch.equal(a[part][key], b[part][key]):
                raise AssertionError(f"resume differs in {part}/{key}")
    for part in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(a["opt_state"][part],
                                       b["opt_state"][part])):
            n_cmp += 1
            if not torch.equal(x, y):
                raise AssertionError(f"resume differs in Adam {part}[{i}]")
    if not (all(torch.equal(a["rng"][k], b["rng"][k]) for k in a["rng"])
            and a["step"] == b["step"] == 4
            and a["opt_state"]["count"] == b["opt_state"]["count"] == 4):
        raise AssertionError("resume differs in rng, step or Adam count")
    moved = sum(1 for k, v in a["params"].items()
                if not torch.equal(v, a["ema_params"][k]))
    if not moved:
        raise AssertionError("parameters and EMA are identical after 4 steps")
    out["resume"] = dict(steps="2+2 vs 4", batch=4, tensors_equal=n_cmp,
                         bit_exact=True)
    log("phase 5e resume: " + json.dumps(out["resume"]))

    # (f) export the trained run and sample from it
    exported = os.path.join(work, "exported")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export_cli.main(["--run-dir", main_dir, "--out", exported,
                              "--device", "cuda"])
    log(buf.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.export returned {rc}")
    out_f = os.path.join(work, "trained_samples")
    fa.reset_launches()
    secs = run_cli(sample, [
        "--run-dir", exported, "--method", "ddim", "--num-steps", "20",
        "--batch-size", "4", "--label", "1", "--seed", "3", "--out", out_f,
        "--device", "cuda"])
    check_launches(fa, 20, "DDIM-20 from the trained run")
    xs = np.load(os.path.join(out_f, "samples.npy"))
    if xs.shape != (4, 256, 256, 1) or not np.isfinite(xs).all():
        raise AssertionError(f"samples from the trained run {xs.shape} not "
                             "finite/shaped")
    out["trained_sample"] = dict(method="ddim", steps=20, batch=4,
                                 s_per_batch=secs,
                                 abs_max=float(np.abs(xs).max()))
    log("phase 5f export + DDIM-20 from the trained run: "
        + json.dumps(out["trained_sample"]))
    return out, train_launches


def write_run(path, seed, fp, tcfg, model_from_config):
    """An exported run dir: config.yaml + ema_params.npz of the full-width
    wide256 with seeded random values on every leaf."""
    cfg = tcfg.Config()
    cfg.model.preset = "wide256"
    cfg.model.num_classes = 2
    cfg.model.conditional = True
    cfg.model.compute_dtype = "bfloat16"
    cfg.training.resolution = 256
    cfg.training.num_timesteps = 1000
    os.makedirs(path, exist_ok=True)
    tcfg.save_config(cfg, os.path.join(path, "config.yaml"))
    shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
    n = fp.export_params(fp.random_params(shapes, seed),
                         os.path.join(path, fp.EXPORT_FILE))
    return n


def run_cli(sample, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sample.main(argv)
    text = buf.getvalue()
    log(text.rstrip())
    if rc != 0:
        raise AssertionError(f"cli.sample returned {rc}")
    m = re.search(r"batch 0: ([0-9.]+)s", text)
    return float(m.group(1))


def profile_denoiser(model, batch, calls=5, kernels=FLASH_KERNELS[:1]):
    """Host wall time vs device busy time of ``calls`` denoiser calls
    (torch.profiler kernel events), the device's idle share, the share of
    device time of the kernels named in ``kernels`` (B1 by default), and the
    top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((batch, 256, 256, 1), device="cuda")
    t = torch.full((batch,), 500, device="cuda", dtype=torch.long)
    y = ([torch.zeros((batch,), device="cuda", dtype=torch.long)]
         if getattr(model, "num_classes", 0) else [])
    with torch.no_grad():
        for _ in range(3):
            model(x, t, *y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            for _ in range(calls):
                model(x, t, *y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) * 1e3 / calls
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / calls
    share_ms = sum(v for k, v in by_name.items()
                   if any(n in k for n in kernels)) / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    cpu_ops = sorted(((a.key, a.self_cpu_time_total, a.count)
                      for a in prof.key_averages()
                      if a.key.startswith("aten::")), key=lambda r: -r[1])
    return dict(
        aten_ops_per_call=sum(r[2] for r in cpu_ops) / calls,
        top_aten_self_cpu_ms_per_call=[
            [k, v / 1e3 / calls, n // calls] for k, v, n in cpu_ops[:8]],
        batch=batch, wall_ms_per_call=wall_ms,
        device_busy_ms_per_call=busy_ms if busy_ms else "not measured",
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else
        "not measured",
        kernels_share_of_device={"+".join(kernels): (
            share_ms / busy_ms) if busy_ms else "not measured"},
        kernels_per_call=sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / calls,
        top_kernels_ms_per_call=[[k[:80], v / 1e3 / calls] for k, v in top])


def phase_ref(fa, fn, work, sample, load_run, wide_model):
    """The reference-model slice (phase 6 of the module docstring): two
    reference-layout checkpoints through cli.import_torch, then cli.sample
    (DDPM, SuperDiff OR) and cli.train on the full-width RefUNet, every
    GroupNorm->SiLU through B4."""
    import numpy as np
    import torch

    from superdiff_torch.cli import import_torch
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.diffusion.process import p_losses
    from superdiff_torch.inference import apply_sampling_policy
    from superdiff_torch.models.layers import GroupNormSiLU

    out, runs = {}, {}
    tic = time.time()
    for seed, task in ((1, "TB"), (2, "PNEUMONIA")):
        ckpt_dir = os.path.join(work, f"reference_{task}")
        os.makedirs(ckpt_dir, exist_ok=True)
        pt = os.path.join(ckpt_dir, "ema_epoch1.pt")
        torch.save(reference_state_dict(seed), pt)
        runs[task] = os.path.join(work, f"imported_{task}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = import_torch.main(["--checkpoint", pt, "--out", runs[task],
                                    "--task", task])
        log(buf.getvalue().rstrip())
        if rc != 0:
            raise AssertionError(f"cli.import_torch returned {rc}")
    log(f"phase 6 setup: two reference checkpoints imported in "
        f"{time.time() - tic:.3f} s")

    # (a) DDPM-1000, 256², batch 16, unconditional: the main path
    out_a = os.path.join(work, "ref_ddpm")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fn.reset_launches()
    secs = run_cli(sample, ["--run-dir", runs["TB"], "--method", "ddpm",
                            "--batch-size", "16", "--seed", "0", "--out",
                            out_a, "--device", "cuda"])
    main_launches = dict(fn.launches_by_shape)
    if fn.launches != REF_CALLS_B4 * 1000 or fa.launches:
        raise AssertionError(f"ref DDPM-1000: {fn.launches} B4 and "
                             f"{fa.launches} B1 launches, expected "
                             f"{REF_CALLS_B4 * 1000} and 0")
    x = np.load(os.path.join(out_a, "samples.npy"))
    if x.shape != (16, 256, 256, 1) or not np.isfinite(x).all():
        raise AssertionError(f"ref DDPM samples {x.shape} not finite/shaped")
    out["ddpm"] = dict(s_per_batch=secs, batch=16, T=1000,
                       b4_launches=fn.launches,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       abs_max=float(np.abs(x).max()))
    log("phase 6a ref DDPM-1000 batch 16: " + json.dumps(out["ddpm"]))

    # (b) one call at batch 2, kernel path vs plain path on the card, and
    # the kernel path again with cuDNN's TF32 off (the phase runs with it
    # on), then the call's time and profile at batch 16
    _, model, _ = load_run(runs["TB"], device="cuda")
    strided = []               # norm inputs that GroupNormSiLU had to copy
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: strided.append(1) if not args[0].is_contiguous()
        else None) for m in model.modules() if isinstance(m, GroupNormSiLU)]
    g = torch.Generator(device="cuda").manual_seed(5)
    xb = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    tb = torch.tensor([999, 10], device="cuda")
    with torch.no_grad():
        fn.reset_launches()
        got = model(xb, tb)
        n_kernel = fn.launches
        with tf32(False):
            same_without_tf32 = torch.equal(got, model(xb, tb))
        with b4_swapped_for_plain(fn):
            expect = model(xb, tb)
    for h in hooks:
        h.remove()
    rel = (torch.linalg.norm(got - expect)
           / torch.linalg.norm(expect)).item()
    if not (n_kernel == REF_CALLS_B4
            and fn.launches == 2 * REF_CALLS_B4
            and torch.isfinite(got).all() and rel < REF_REL_TOL
            and not strided and same_without_tf32):
        raise AssertionError(f"RefUNet kernel path vs plain path: rel L2 "
                             f"{rel:.3e} (tolerance {REF_REL_TOL}), "
                             f"{n_kernel} B4 launches, {len(strided)} "
                             f"strided norm inputs; bit-equal without TF32: "
                             f"{same_without_tf32}")
    apply_sampling_policy(model)
    x16 = torch.randn((16, 256, 256, 1), device="cuda")
    t16 = torch.full((16,), 500, device="cuda", dtype=torch.long)
    with torch.no_grad():
        call_ms = cuda_time_ms(lambda: model(x16, t16), 20)
    out["call"] = dict(rel_l2_kernel_vs_plain=rel,
                       bit_equal_tf32_on_off=same_without_tf32,
                       batch16_ms=call_ms,
                       profile=profile_denoiser(model, 16,
                                                kernels=GN_KERNELS))
    log("phase 6b RefUNet call: " + json.dumps(out["call"]))
    del model

    # (c) SuperDiff OR of the two imported runs, batch 4, T=1000
    out_c = os.path.join(work, "ref_or")
    fn.reset_launches()
    secs = run_cli(sample, ["--run-dir", runs["TB"], "--run-dir2",
                            runs["PNEUMONIA"], "--mode", "or",
                            "--batch-size", "4", "--seed", "1", "--out",
                            out_c, "--device", "cuda"])
    xs = np.load(os.path.join(out_c, "samples.npy"))
    with open(os.path.join(out_c, "logq.json")) as f:
        lq = json.load(f)
    logq = np.array([lq["logq_model1"], lq["logq_model2"]])
    if (fn.launches != 2 * REF_CALLS_B4 * 1000
            or xs.shape != (4, 256, 256, 1) or not np.isfinite(xs).all()
            or logq.shape != (2, 4) or not np.isfinite(logq).all()):
        raise AssertionError(f"ref SuperDiff OR: {fn.launches} B4 launches, "
                             f"samples {xs.shape}, logq {logq.shape}")
    out["superdiff_or"] = dict(s_per_batch=secs, batch=4, T=1000,
                               b4_launches=fn.launches,
                               logq_gap_mean=lq["logq_gap_mean"])
    log("phase 6c ref SuperDiff OR TB x PNEUMONIA: "
        + json.dumps(out["superdiff_or"]))

    # (d) the CondUNet is untouched: one wide256 call launches no B4
    fa.reset_launches()
    fn.reset_launches()
    with torch.no_grad():
        wide_model(torch.randn((2, 256, 256, 1), device="cuda"),
                   torch.tensor([5, 900], device="cuda"),
                   torch.tensor([0, 1], device="cuda"))
    torch.cuda.synchronize()
    if fn.launches != 0 or fa.launches != 8:
        raise AssertionError(f"wide256 call: {fn.launches} B4 and "
                             f"{fa.launches} B1 launches, expected 0 and 8")
    log("phase 6d wide256 call: 0 B4 launches, 8 B1")

    # (e) cli.train on the ref preset, then gradients kernel vs plain
    STEPS, EPOCHS, VAL = 8, 3, 2
    fn.reset_launches()
    _, metrics = run_train_cli(
        train_cli, work, "ref", 4, EPOCHS, STEPS,
        ["--set", f"training.eval_batches={VAL}"], model_args=REF)
    expect_n = REF_CALLS_B4 * EPOCHS * (STEPS + VAL)
    tr, va = epoch_rows(metrics, "avg_loss"), epoch_rows(metrics, "val_loss")
    losses = [m["avg_loss"] for m in tr] + [m["val_loss"] for m in va]
    if fn.launches != expect_n or not np.isfinite(losses).all():
        raise AssertionError(f"ref training: {fn.launches} B4 launches "
                             f"(expected {expect_n}), losses {losses}")
    if not (va[-1]["val_loss"] < va[0]["val_loss"]
            and tr[-1]["avg_loss"] < tr[0]["avg_loss"]):
        raise AssertionError(f"ref loss did not fall: train {tr}, val {va}")
    out["train"] = dict(
        batch=4, steps=EPOCHS * STEPS, b4_launches=fn.launches,
        train_loss_by_epoch=[m["avg_loss"] for m in tr],
        val_loss_by_epoch=[m["val_loss"] for m in va],
        images_per_s_last_epoch=tr[-1]["images_per_sec"])
    log("phase 6e cli.train ref: " + json.dumps(out["train"]))

    _, model, schedule = load_run(runs["PNEUMONIA"], device="cuda")
    model.train()
    g = torch.Generator(device="cuda").manual_seed(11)
    x0 = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    noise = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    t = torch.tensor([700, 20], device="cuda")
    params = list(model.parameters())

    def grads():
        loss = p_losses(schedule, model, x0, t, noise=noise)
        return torch.autograd.grad(loss, params)

    fn.reset_launches()
    g_kernel = grads()
    n_kernel = fn.launches
    with b4_swapped_for_plain(fn):
        g_plain = grads()
    num = sum(((a - b) ** 2).sum() for a, b in zip(g_kernel, g_plain))
    den = sum((b ** 2).sum() for b in g_plain)
    rel = (num.sqrt() / den.sqrt()).item()
    if not (n_kernel == REF_CALLS_B4 and fn.launches == REF_CALLS_B4
            and rel < REF_GRAD_REL_TOL):
        raise AssertionError(f"RefUNet gradients, kernel vs plain: rel L2 "
                             f"{rel:.3e} (tolerance {REF_GRAD_REL_TOL}), "
                             f"{n_kernel} B4 launches")
    out["grad_check"] = dict(rel_l2=rel, leaves=len(params))
    log("phase 6e RefUNet gradients, B4 vs plain: "
        + json.dumps(out["grad_check"]))
    return out, main_launches


@contextlib.contextmanager
def b4_swapped_for_plain(fn):
    """B4's wrapper runs the plain version on CUDA tensors inside the block
    (the package has no such switch), for the kernel-vs-plain checks."""
    kernel = fn._gn_silu_cuda
    fn._gn_silu_cuda = (lambda x, gamma, beta, G, scale, shift, eps:
                        fn.gn_silu_plain(x, gamma, beta, G, scale, shift, eps))
    try:
        yield
    finally:
        fn._gn_silu_cuda = kernel


@contextlib.contextmanager
def tf32(on):
    """cuDNN's TF32 for float32 convolutions (PyTorch's default is on)."""
    import torch

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def check_launches(fa, calls, what):
    expect = 8 * calls
    if fa.launches != expect:
        raise AssertionError(f"{what}: {fa.launches} flash launches for "
                             f"{calls} denoiser calls, expected {expect}")


def main() -> int:
    if not IN_CHECKOUT:
        print("chip_smoke.py must run from a checkout of the repository "
              "(no superdiff_torch/ beside it)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 2
    t_start = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card_line = nvidia_smi("name,power.limit")
    max_clock = nvidia_smi("clocks.max.sm")
    sm_clock_hz = float(re.findall(r"[0-9.]+", max_clock)[0]) * 1e6
    log(f"phase 1 device: {card_line}; max SM clock {max_clock}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for f32")

    from superdiff_torch import config as tcfg
    from superdiff_torch.cli import sample
    from superdiff_torch.compat import flax_params as fp
    from superdiff_torch.inference import apply_sampling_policy, load_run
    from superdiff_torch.models.presets import model_from_config
    from superdiff_torch.ops import _build
    from superdiff_torch.ops import flash_attention as fa
    from superdiff_torch.ops import fused_norm as fn

    tic = time.time()
    sos = _build.build_all(verbose=True)
    build_s = time.time() - tic
    log(f"phase 2 build: {sorted(so.name for so in sos.values())} in "
        f"{build_s:.3f} s (one nvcc per source, started together)")

    rows = phase_kernels(fa, sm_clock_hz)
    log(f"phase 3a forward kernel checks: {len(rows)} shape/dtype cases "
        "agree")
    bwd_rows = phase_bwd_kernels(fa, sm_clock_hz)
    log(f"phase 3b backward kernel checks: {len(bwd_rows)} kernel/shape/"
        "dtype cases agree")
    gn_rows = phase_gn_kernels(fn)
    log(f"phase 3c B4 checks: {len(gn_rows)} shape/dtype cases agree")

    work = tempfile.mkdtemp(prefix="superdiff_smoke_")
    run1, run2 = os.path.join(work, "run1"), os.path.join(work, "run2")
    tic = time.time()
    n_arrays = write_run(run1, 1, fp, tcfg, model_from_config)
    write_run(run2, 2, fp, tcfg, model_from_config)
    log(f"phase 4 setup: two wide256 run dirs ({n_arrays} arrays each) in "
        f"{time.time() - tic:.3f} s")

    # (a) DDPM-1000, 256², batch 16, label 0 — the main path
    out_a = os.path.join(work, "ddpm")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ddpm_s = run_cli(sample, [
        "--run-dir", run1, "--method", "ddpm", "--batch-size", "16",
        "--label", "0", "--guidance", "1.0", "--seed", "0", "--out", out_a,
        "--device", "cuda"])
    main_launches = dict(fa.launches_by_shape)
    ddpm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(fa, 1000, "DDPM-1000")
    x = np.load(os.path.join(out_a, "samples.npy"))
    if x.shape != (16, 256, 256, 1) or not np.isfinite(x).all():
        raise AssertionError(f"DDPM samples {x.shape} not finite/shaped")
    log(f"phase 4a DDPM-1000 batch 16: {ddpm_s:.3f} s per batch (= ms per "
        f"sampler step), peak {ddpm_peak_gb:.3f} GB, launches "
        f"{main_launches}")

    # (b) one denoiser call at batch 2: bf16 kernel path vs f32 plain path
    _, model, _ = load_run(run1, device="cuda")
    apply_sampling_policy(model)
    _, ref, _ = load_run(run1, device="cpu")
    g = torch.Generator().manual_seed(5)
    xb = torch.randn((2, 256, 256, 1), generator=g)
    tb = torch.tensor([999, 10])
    yb = torch.tensor([0, 2])
    fa.reset_launches()
    with torch.no_grad():
        got = model(xb.cuda(), tb.cuda(), yb.cuda()).float().cpu()
        torch.cuda.synchronize()
        check_launches(fa, 1, "denoiser call")
        expect = ref(xb, tb, yb)
    rel = (torch.linalg.norm(got - expect) / torch.linalg.norm(expect)).item()
    if not (torch.isfinite(got).all() and rel < SLICE_REL_TOL):
        raise AssertionError(f"bf16 kernel path vs f32 plain path: rel L2 "
                             f"{rel:.4e} (tolerance {SLICE_REL_TOL})")
    x16 = torch.randn((16, 256, 256, 1), device="cuda")
    t16 = torch.full((16,), 500, device="cuda", dtype=torch.long)
    y16 = torch.zeros((16,), device="cuda", dtype=torch.long)
    with torch.no_grad():
        step_ms = cuda_time_ms(lambda: model(x16, t16, y16), 20)
    log(f"phase 4b denoiser batch 2 bf16 vs f32 plain: rel L2 {rel:.4e} "
        f"(tol {SLICE_REL_TOL}); denoiser call at batch 16: "
        f"{step_ms:.4f} ms")
    profiles = [profile_denoiser(model, b) for b in (16, 4)]
    for p in profiles:
        log("profile " + json.dumps(p))
    del ref
    chains = wide256_norm_chains(fn, model)
    log("phase 4b wide256 GroupNorm->SiLU chains vs B4 (measurement only): "
        + json.dumps({k: v for k, v in chains.items() if k != "rows"}))

    # (c) SuperDiff OR and AND, batch 4, T=1000, two models
    superdiff = {}
    for mode in ("or", "and"):
        out_c = os.path.join(work, mode)
        fa.reset_launches()
        secs = run_cli(sample, [
            "--run-dir", run1, "--run-dir2", run2, "--mode", mode,
            "--batch-size", "4", "--seed", "1", "--out", out_c,
            "--device", "cuda"])
        check_launches(fa, 2000, f"SuperDiff {mode}")
        xs = np.load(os.path.join(out_c, "samples.npy"))
        with open(os.path.join(out_c, "logq.json")) as f:
            lq = json.load(f)
        logq = np.array([lq["logq_model1"], lq["logq_model2"]])
        if (xs.shape != (4, 256, 256, 1) or not np.isfinite(xs).all()
                or logq.shape != (2, 4) or not np.isfinite(logq).all()):
            raise AssertionError(f"SuperDiff {mode}: samples {xs.shape}, "
                                 f"logq {logq.shape} not finite/shaped")
        superdiff[mode] = dict(s_per_batch=secs, T=1000, batch=4,
                               logq_gap_mean=lq["logq_gap_mean"])
        log(f"phase 4c SuperDiff {mode.upper()} T=1000 batch 4: {secs:.3f} s,"
            f" logq gap mean {lq['logq_gap_mean']:.4f}")

    training_out, train_launches = phase_training(
        fa, work, run1, tcfg, model_from_config, load_run, sample)

    # the reference-model slice runs under PyTorch's default cuDNN TF32 (on),
    # as a user's cli.sample / cli.train would; the RefUNet's convolutions
    # run IEEE float32 whatever it says, which phase 6b checks
    with tf32(True):
        ref_out, ref_launches = phase_ref(fa, fn, work, sample, load_run,
                                          model)
    del model

    summary = dict(card=card_line, build_s=build_s, training=training_out,
                   ddpm1000_batch16_s=ddpm_s, denoiser_ms_batch16=step_ms,
                   slice_rel_l2_bf16_vs_f32=rel, superdiff=superdiff,
                   profiles=profiles, ddpm_peak_mem_gb=ddpm_peak_gb,
                   wide256_norm_chains=chains, ref_slice=ref_out,
                   total_s=time.time() - t_start)
    log("slice " + json.dumps(summary))

    kernels = []
    for (B, S, H, D) in PATH_SHAPES:
        row = rows[(B, S, H, D, "bfloat16")]
        kernels.append(dict(
            name=f"flash_attn_fwd[bf16 B{B} S{S} H{H} D{D}]", route="cuda",
            source=KERNEL_SRC, replaces=TPU_KERNEL,
            launches=main_launches.get((S, D, "bfloat16"), 0),
            train_launches=train_launches["fwd"].get((S, D, "bfloat16"), 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            kernel_device_ms=row["kernel_device_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library_device_ms=row["library_device_ms"]))
        if not (kernels[-1]["launches"] and kernels[-1]["train_launches"]):
            raise AssertionError(f"path shape {(B, S, H, D)} never launched")
    for kern, name, replaces in (("dq", "flash_attn_bwd_dq", TPU_BWD_DQ),
                                 ("dkv", "flash_attn_bwd_dkv", TPU_BWD_DKV)):
        for (B, S, H, D) in PATH_SHAPES:
            row = bwd_rows[(kern, B, S, H, D, "bfloat16")]
            kernels.append(dict(
                name=f"{name}[bf16 B{B} S{S} H{H} D{D}]", route="cuda",
                source=BWD_SRC, replaces=replaces,
                launches=train_launches[kern].get((S, D, "bfloat16"), 0),
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                kernel_device_ms=row["kernel_device_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                library_device_ms=row["library_device_ms"]))
            if kernels[-1]["launches"] == 0:
                raise AssertionError(f"{name} never launched at path shape "
                                     f"{(B, S, H, D)} in training")
    for (B, H, W, C, G, film) in GN_PATH_SHAPES:
        row = gn_rows[(B, H, W, C, G, film, "float32")]
        kernels.append(dict(
            name=f"group_norm_silu[f32 B{B} {H}x{W} C{C} G{G}]",
            route="cuda", source=GN_SRC, replaces=TPU_GN,
            launches=ref_launches.get((H, W, C, G, film, "float32"), 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        if kernels[-1]["launches"] == 0:
            raise AssertionError(f"B4 never launched at path shape "
                                 f"{(B, H, W, C, G)} in the ref DDPM run")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
