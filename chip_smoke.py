#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (superdiff_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the flash-attention kernel (csrc/flash_attn_fwd.cu) with
   nvcc and print the build time and ptxas report;
3. kernel vs plain version on the card, bf16 and f32, at the sampling
   path's shapes (batch 16, and the CFG 2B batch) and at shapes with several
   K tiles, a ragged edge and D=128; CUDA-event times of the kernel, the
   plain version and F.scaled_dot_product_attention (timed only as the
   library yardstick; the port never calls it), and the kernel's own
   device time from the profiler;
4. the slice through the user entry points: the full-width wide256 CondUNet
   with seeded random weights on every leaf, written as an exported run dir
   and loaded back through superdiff_torch.inference.load_run:
   (a) superdiff_torch.cli.sample DDPM-1000 at 256², batch 16, label 0;
   (b) one denoiser call at batch 2, bf16 kernel path on the card against the
       float32 plain path on the CPU; then the denoiser call's time at batch
       16 and a torch.profiler breakdown at batch 16 and 4 (device busy and
       idle share, B1's share, top kernels and host ops);
   (c) superdiff_torch.cli.sample SuperDiff OR and AND of two differently
       seeded wide256 models, batch 4, T=1000;
   every run checks finite outputs and exactly 8 kernel launches per
   denoiser call;
5. a JSON line per kernel shape, the card line, the kernels line, and last
   the result line {"ok": true, "device": {...}}.

float32 comparisons run with TF32 off (cudnn.allow_tf32=False, matmul
precision "highest").
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
KERNEL_SRC = "superdiff_torch/csrc/flash_attn_fwd.cu"
TPU_KERNEL = "superdiff_tpu/ops/flash_attention.py:56"
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


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, iters=20):
    """Device time of the flash kernel itself per call (profiler kernel
    events): at small shapes the CUDA-event time of back-to-back calls is
    set by the host wrapper's enqueue rate, not by the kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "flash_fwd_kernel" in e.name)
    return us / 1e3 / iters if us else "not measured"


def bound(B, S, H, D, dtype, sm_clock_hz):
    """Least time for the function: bytes (q, k, v read once, out and lse
    written once), tensor/FMA flops, and exponentials on the SFUs."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * B * S * H * D * elt + 4 * B * H * S
    t_bytes = nbytes / HBM_BPS
    t_flops = 4 * B * H * S * S * D / PEAK_FLOPS[dtype]
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
            plain_iters = 5 if S >= 4096 else 20
            ms = cuda_time_ms(lambda: fa._flash_forward(q, k, v), 50)
            dev_ms = kernel_device_ms(lambda: fa._flash_forward(q, k, v))
            plain_ms = cuda_time_ms(
                lambda: fa._flash_forward_plain(q, k, v), plain_iters)
            qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            lib_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), 50)
            b_ms, b_by, b_detail = bound(B, S, H, D, dname, sm_clock_hz)
            row = dict(shape=[B, S, H, D], dtype=dname, max_abs_err=err,
                       lse_max_abs_err=lse_err, ms=ms,
                       kernel_device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_resource=b_detail,
                       roofline_share=b_ms / ms)
            rows[(B, S, H, D, dname)] = row
            log("kernel_check " + json.dumps(row))
    return rows


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


def profile_denoiser(model, batch, calls=5):
    """Host wall time vs device busy time of ``calls`` denoiser calls
    (torch.profiler kernel events), the device's idle share, B1's share of
    device time, and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((batch, 256, 256, 1), device="cuda")
    t = torch.full((batch,), 500, device="cuda", dtype=torch.long)
    y = torch.zeros((batch,), device="cuda", dtype=torch.long)
    with torch.no_grad():
        for _ in range(3):
            model(x, t, y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            for _ in range(calls):
                model(x, t, y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) * 1e3 / calls
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / calls
    flash_ms = sum(v for k, v in by_name.items()
                   if "flash_fwd_kernel" in k) / 1e3 / calls
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
        flash_share_of_device=(flash_ms / busy_ms) if busy_ms else
        "not measured",
        kernels_per_call=sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / calls,
        top_kernels_ms_per_call=[[k[:80], v / 1e3 / calls] for k, v in top])


def check_launches(fa, calls, what):
    expect = 8 * calls
    if fa.launches != expect:
        raise AssertionError(f"{what}: {fa.launches} flash launches for "
                             f"{calls} denoiser calls, expected {expect}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "superdiff_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(no superdiff_torch/ beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
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
    from superdiff_torch.ops import flash_attention as fa

    tic = time.time()
    so = fa.build(verbose=True)
    build_s = time.time() - tic
    log(f"phase 2 build: {so.name} in {build_s:.3f} s")

    rows = phase_kernels(fa, sm_clock_hz)
    log(f"phase 3 kernel checks: {len(rows)} shape/dtype cases agree")

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
    del model, ref

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

    summary = dict(card=card_line, build_s=build_s,
                   ddpm1000_batch16_s=ddpm_s, denoiser_ms_batch16=step_ms,
                   slice_rel_l2_bf16_vs_f32=rel, superdiff=superdiff,
                   profiles=profiles, ddpm_peak_mem_gb=ddpm_peak_gb,
                   total_s=time.time() - t_start)
    log("slice " + json.dumps(summary))

    kernels = []
    for (B, S, H, D) in PATH_SHAPES:
        row = rows[(B, S, H, D, "bfloat16")]
        kernels.append(dict(
            name=f"flash_attn_fwd[bf16 B{B} S{S} H{H} D{D}]", route="cuda",
            source=KERNEL_SRC, replaces=TPU_KERNEL,
            launches=main_launches.get((S, D, "bfloat16"), 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        if kernels[-1]["launches"] == 0:
            raise AssertionError(f"path shape {(B, S, H, D)} never launched")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
