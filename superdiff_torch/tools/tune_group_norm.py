#!/usr/bin/env python3
"""Kernel B4 (fused GroupNorm -> FiLM -> SiLU) at the wide256 CondUNet's
chain shapes on the card, in each of its regimes, against the plain chain.

    python3 superdiff_torch/tools/tune_group_norm.py [--batch 16]
        [--regimes cluster,three_pass] [--norm-dtype bfloat16] [--ref]

The chain shapes are those one full-width wide256 denoiser call launches
under the bf16 sampling policy (counted through B4's wrapper). For each
shape and regime (``ops/fused_norm.py::launch_geometry``; ``*`` marks the
one it picks) it prints a JSON line: the largest distance in bf16 ulps
from the plain chain (``gn_film_silu_policy_plain``; at the magnitude the
chain rounds at, see ``bf16_ulps``) and the elements that differ at all, whether a rerun gives the same bits, the
CUDA-event and device ms of B4, of the plain chain and of the library
yardstick (``F.group_norm`` + FiLM + ``F.silu``; no single torch call
computes the chain), the bound (x read once, y written once at 3.35 TB/s)
and the launch geometry with the clusters the card holds at once. A
summary line sums launches x time over the call. ``--ref`` adds the
RefUNet's three float32 shapes (folded chain, ``gn_silu_plain``).
``--train`` prints instead, per shape, the training chain (float32 norm
dtype, a gradient wanted): B4's forward and backward kernels against the
plain chain under autograd and the library's ``F.group_norm`` + FiLM +
``F.silu`` under autograd (``train_chain_row``). It also prints ptxas's
report of the build. About a minute on an H100.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys

HBM_BPS = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
# the RefUNet's chains at batch 16, 256^2, float32: (C, G) -> per call
REF_SHAPES = {(1, 1): 2, (64, 4): 4, (128, 4): 4}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def chain_inputs(B, H, W, C, film, dtype, seed=0):
    """x (B, H, W, C) in ``dtype`` around 0.5 with spread 2, gamma ~ 1,
    beta ~ 0, FiLM scale / shift ~ 0.2 (float32, or None), on the card."""
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
    channels-last NCHW view, the FiLM FMA where there is one, ``F.silu``."""
    import torch.nn.functional as F

    h = F.group_norm(x.permute(0, 3, 1, 2), G, gamma.to(x.dtype),
                     beta.to(x.dtype), 1e-5)
    if scale is not None:
        h = (h * (1 + scale.to(x.dtype))[:, :, None, None]
             + shift.to(x.dtype)[:, :, None, None])
    return F.silu(h)


# B4's policy mode against the plain chain: distances in bf16 ulps at the
# magnitude the chain rounds at, the largest of the output and the bf16
# intermediates that lead to it (the GroupNorm output, the FiLM product and
# sum): a flip of one of them by an ulp (the statistics sum in another
# order) moves the output by up to ~1.1 of its ulps (SiLU's slope), however
# small the output is after a cancellation in the FiLM sum or SiLU's
# squeeze of negative inputs. Not below ULP_FLOOR: there x - mean cancels,
# and the mean's last bits move h by ~1e-6, several of a tiny value's ulps.
ULP_FLOOR = 2.0 ** -10
MAX_ULPS = 2
MAX_SHARE_DIFFERING = 0.01


def chain_magnitude(fn, x, gamma, beta, G, nd, scale, shift):
    """Elementwise largest magnitude among the plain policy chain's
    intermediates in ``nd`` (float32)."""
    import torch

    h = fn.group_norm_plain(x, gamma, beta, G, 1e-5, nd)
    mag = h.float().abs()
    if scale is not None:
        h = h * (1.0 + scale.to(nd)[:, None, None, :])
        mag = torch.maximum(mag, h.float().abs())
        h = h + shift.to(nd)[:, None, None, :]
        mag = torch.maximum(mag, h.float().abs())
    return mag


def bf16_ulps(got, want, magnitude=None, floor=ULP_FLOOR):
    """Elementwise |got - want| over the bf16 ulp (8 significant bits) at
    the largest of ``|want|``, ``magnitude`` (if given) and ``floor``."""
    import torch

    mag = want.float().abs()
    if magnitude is not None:
        mag = torch.maximum(mag, magnitude)
    _, e = torch.frexp(mag.clamp_min(floor))
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return (got.float() - want.float()).abs() / ulp


def wide256_chain_shapes(fn, model, batch):
    """B4 launches by shape ``(H, W, C, G, film, dtype)`` of one no-grad
    call of ``model`` at ``batch``, 256² (label 0)."""
    import torch

    fn.reset_launches()
    with torch.no_grad():
        model(torch.randn((batch, 256, 256, 1), device="cuda"),
              torch.full((batch,), 500, device="cuda", dtype=torch.long),
              torch.zeros((batch,), device="cuda", dtype=torch.long))
    torch.cuda.synchronize()
    shapes = dict(fn.launches_by_shape)
    fn.reset_launches()
    return shapes


def chain_row(fn, batch, key, count, norm_dtype, regimes, policy=True,
              timed=True):
    """B4 at one chain shape in each of ``regimes`` (names or geometries)
    against the plain chain (see the module docstring); a regime that
    disagrees marks the row ``failed``. ``timed``: also the times of B4,
    the plain chain and the yardstick."""
    import torch

    from superdiff_torch.tools.timing import cuda_time_ms, kernel_device_ms

    H, W, C, G, film, dname = key
    dtype = getattr(torch, dname)
    x, gamma, beta, scale, shift = chain_inputs(batch, H, W, C, film, dtype,
                                                seed=C + G + H)
    nd = norm_dtype if policy else dtype
    if policy:
        plain = lambda: fn.gn_film_silu_policy_plain(x, gamma, beta, G, nd,
                                                     scale, shift)
    else:
        plain = lambda: fn.gn_silu_plain(x, gamma, beta, G, scale, shift)
    want = plain()
    magnitude = (chain_magnitude(fn, x, gamma, beta, G, nd, scale, shift)
                 if policy else None)
    n = x.numel()
    row = dict(shape=[batch, H, W, C], groups=G, film=film, dtype=dname,
               norm_dtype=str(nd).replace("torch.", ""), policy=policy,
               launches_per_call=count,
               bound_ms=(n * x.element_size() + n * want.element_size())
               / HBM_BPS * 1e3, bound_by="bytes")
    picked = fn.launch_geometry(batch, H * W, C, G, dtype, nd, True).regime
    for regime in regimes:
        geo = (regime if isinstance(regime, fn.Geometry) else
               fn.launch_geometry(batch, H * W, C, G, dtype, nd, True,
                                  regime))
        call = lambda: fn._launch(x, gamma, beta, G, scale, shift, 1e-5, nd,
                                  policy, geo=geo)
        n0 = fn.launches
        got = call()
        torch.cuda.synchronize()
        if fn.launches != n0 + 1:
            raise AssertionError("B4 launch was not counted")
        ulps = bf16_ulps(got, want, magnitude)
        differ = (got.float() != want.float()).float().mean().item()
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, call())
        r = dict(geometry=geo._asdict(), max_ulps=ulps.max().item(),
                 max_ulps_of_output=bf16_ulps(got, want, None,
                                              0.0).max().item(),
                 elements_differing=int((got != want).sum().item()),
                 share_differing=differ, max_abs_err=err,
                 rerun_same_bits=same)
        del ulps
        if geo.regime == "cluster":
            r["clusters_at_once"] = fn.max_active_clusters(geo, dtype, nd)
        if timed:
            r["ms"] = cuda_time_ms(call, 30)
            r["device_ms"] = kernel_device_ms(call, kernel=None)
            dev = r["device_ms"]
            r["roofline_share"] = (row["bound_ms"] / dev
                                   if isinstance(dev, float) else dev)
        name = (regime if isinstance(regime, str) else
                f"k{geo.cluster}_v{geo.vec}_t{geo.threads}"
                f"_r{geo.resident}of{geo.iters}")
        row[name + ("*" if regime == picked else "")] = r
        ok = same and torch.isfinite(got.float()).all().item()
        if policy and nd == torch.bfloat16:
            ok = (ok and r["max_ulps"] <= MAX_ULPS
                  and differ < MAX_SHARE_DIFFERING)
        else:
            ok = ok and err <= 1e-4 * (1 + want.float().abs().max().item())
        r["ok"] = ok
        if not ok:
            row["failed"] = True
    if timed:
        row["plain_device_ms"] = kernel_device_ms(plain, kernel=None)
        row["library_device_ms"] = kernel_device_ms(
            lambda: gn_library(x, gamma, beta, G, scale, shift), kernel=None)
        row["plain_ms"] = cuda_time_ms(plain, 10)
        row["library_ms"] = cuda_time_ms(
            lambda: gn_library(x, gamma, beta, G, scale, shift), 20)
    return row


# the backward kernel against the plain closed form: dx within 2^-7 of
# itself plus 1e-3 of the largest |dx| (a bf16 rounding lands an ulp away;
# dx's three terms cancel), the float32 sums within 1e-4 of their largest
TRAIN_TOL = {"dx": (2 ** -7, 1e-3), "sums": (0.0, 1e-4)}


def train_chain_row(fn, batch, key, count):
    """The training chain at one shape (float32 norm dtype; FiLM operands
    as the ResBlock's ``cond.chunk(2)`` views): B4's backward in each regime
    against ``gn_film_silu_policy_backward_plain`` (the largest error of dx
    and of the small gradients, as a share of each one's largest value;
    the row ``failed`` beyond ``TRAIN_TOL``); device ms of B4's forward
    (statistics written), of its backward, of both through autograd
    (``PolicyChainFn``), of the plain chain's forward + backward under
    autograd and of the library's; the bytes bound of forward + backward
    (x read and float32 y written; x and g read, dx written) at 3.35
    TB/s."""
    import torch

    from superdiff_torch.tools.timing import kernel_device_ms

    H, W, C, G, film, dname = key
    dtype = getattr(torch, dname)
    x, gamma, beta, scale, shift = chain_inputs(batch, H, W, C, False, dtype,
                                                seed=C + G + H)
    if film:
        cond = 0.2 * torch.randn((batch, 2 * C), device="cuda")
        scale, shift = cond.chunk(2, dim=-1)
    g = torch.randn(x.shape, device="cuda")
    n, e = x.numel(), x.element_size()
    row = dict(shape=[batch, H, W, C], groups=G, film=film, dtype=dname,
               launches_per_step=count,
               bound_ms=n * (3 * e + 8) / HBM_BPS * 1e3, bound_by="bytes")
    want = fn.gn_film_silu_policy_backward_plain(x, g, gamma, beta, G, scale,
                                                 shift)
    picked = fn.backward_geometry(batch, H * W, C, G, dtype, True).regime
    for regime in ("cluster", "three_pass"):
        try:
            fn.backward_geometry(batch, H * W, C, G, dtype, True, regime)
        except ValueError:
            continue
        y, stats = fn._launch(x, gamma, beta, G, scale, shift, 1e-5,
                              torch.float32, True, regime, stats=True)
        got = fn._launch_backward(x, g, stats, gamma, beta, G, scale, shift,
                                  regime)
        errs = {}
        for name, a, b in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"),
                              got, want):
            if a is not None:
                big = b.float().abs().max().item()
                rtol, atol = TRAIN_TOL["dx" if name == "dx" else "sums"]
                over = ((a.float() - b.float()).abs()
                        - rtol * b.float().abs()).max().item() / big
                errs[name] = over
                if not over <= atol:
                    row["failed"] = True
        again = fn._launch_backward(x, g, stats, gamma, beta, G, scale,
                                    shift, regime)
        if not all(a is None or torch.equal(a, b)
                   for a, b in zip(got, again)):
            row["failed"] = True
        r = dict(errors_over_rtol_share_of_max=errs,
                 fwd_device_ms=kernel_device_ms(
                     lambda: fn._launch(x, gamma, beta, G, scale, shift, 1e-5,
                                        torch.float32, True, regime,
                                        stats=True), kernel=None),
                 bwd_device_ms=kernel_device_ms(
                     lambda: fn._launch_backward(x, g, stats, gamma, beta, G,
                                                 scale, shift, regime),
                     kernel=None))
        row[regime + ("*" if regime == picked else "")] = r
        del y, stats, got, again
    leaves = [None if a is None else a.detach().requires_grad_()
              for a in (x, gamma, beta, scale, shift)]
    wanted = [a for a in leaves if a is not None]

    def through(chain):
        return lambda: torch.autograd.grad(chain(), wanted, g)

    row["kernels_fwd_bwd_device_ms"] = kernel_device_ms(through(
        lambda: fn.gn_film_silu_policy(*leaves[:3], G, torch.float32,
                                       *leaves[3:])), kernel=None)
    row["plain_fwd_bwd_device_ms"] = kernel_device_ms(through(
        lambda: fn.gn_film_silu_policy_plain(*leaves[:3], G, torch.float32,
                                             *leaves[3:])), kernel=None)
    row["library_fwd_bwd_device_ms"] = kernel_device_ms(through(
        lambda: gn_library(leaves[0].float(), *leaves[1:3], G,
                           *leaves[3:]).permute(0, 2, 3, 1)), kernel=None)
    dev = row["kernels_fwd_bwd_device_ms"]
    row["roofline_share"] = (row["bound_ms"] / dev if isinstance(dev, float)
                             else dev)
    return row


def summarize_train(rows):
    """Sums of launches per step x device ms over the training rows."""
    out = {}
    for k in ("kernels_fwd_bwd_device_ms", "plain_fwd_bwd_device_ms",
              "library_fwd_bwd_device_ms", "bound_ms"):
        vals = [r[k] for r in rows]
        out[k] = (sum(r["launches_per_step"] * r[k] for r in rows)
                  if all(isinstance(v, float) for v in vals)
                  else "not measured")
    out["launches_per_step"] = sum(r["launches_per_step"] for r in rows)
    return out


def summarize(rows, regimes):
    """Sums of launches x device ms over the rows, per regime (the picked
    one as ``picked``), for the plain chain, the library and the bound."""
    out = {}
    sums = lambda f: sum(r["launches_per_call"] * f(r) for r in rows)

    def regime_ms(r, name):
        for k in (name, name + "*"):
            if k in r:
                return r[k]["device_ms"]
        return 0.0

    def picked_ms(r):
        return next(v["device_ms"] for k, v in r.items() if k.endswith("*"))

    try:
        for name in regimes:
            out[f"{name}_device_ms"] = sums(lambda r: regime_ms(r, name))
        out["picked_device_ms"] = sums(picked_ms)
        out["plain_device_ms"] = sums(lambda r: r["plain_device_ms"])
        out["library_device_ms"] = sums(lambda r: r["library_device_ms"])
    except TypeError:                       # a "not measured" in a row
        out = {k: "not measured" for k in out}
    out["bound_ms"] = sums(lambda r: r["bound_ms"])
    out["launches_per_call"] = sum(r["launches_per_call"] for r in rows)
    return out


def warm_up(seconds=2.0):
    """Keep the card busy for ``seconds`` so that its clocks are up, and
    return the SM clock nvidia-smi reads then."""
    import time

    import torch

    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    tic = time.time()
    while time.time() - tic < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def trace(fn, batch, key, nd):
    """One cluster launch of a tracing build at ``key``: per phase, the
    median and largest clock64 cycles over the blocks (thread 0), and the
    spread of the blocks' start and end times (globaltimer ns)."""
    import ctypes
    import statistics

    import torch

    H, W, C, G, film, dname = key
    x, gamma, beta, scale, shift = chain_inputs(batch, H, W, C, film,
                                                getattr(torch, dname))
    geo = fn.launch_geometry(batch, H * W, C, G, x.dtype, nd, True,
                             "cluster")
    lib = fn._load(("SUPERDIFF_GN_TRACE",))
    saved = fn._DEFINES
    fn._DEFINES = ("SUPERDIFF_GN_TRACE",)
    try:
        for _ in range(3):
            fn._launch(x, gamma, beta, G, scale, shift, 1e-5, nd, True,
                       geo=geo)
        torch.cuda.synchronize()
    finally:
        fn._DEFINES = saved
    blocks = min(1024, batch * geo.cluster)
    buf = (ctypes.c_longlong * (10 * blocks))()
    if lib.superdiff_gn_trace(ctypes.addressof(buf), blocks) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    rows = [buf[10 * b:10 * b + 10] for b in range(blocks)]
    t0 = min(r[0] for r in rows)
    phases = ["issue+streamed", "wait+resident", "fold", "cluster_sync",
              "remote_reads", "chan", "apply"]
    out = dict(shape=[batch, H, W, C], film=film, geometry=geo._asdict(),
               start_ns_spread=max(r[0] for r in rows) - t0,
               end_ns_first=min(r[9] for r in rows) - t0,
               end_ns_last=max(r[9] for r in rows) - t0)
    for i, name in enumerate(phases):
        cyc = [r[i + 2] - r[i + 1] for r in rows]
        out[name] = [statistics.median(cyc), max(cyc)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--regimes", default="cluster,three_pass")
    p.add_argument("--norm-dtype", default="bfloat16")
    p.add_argument("--ref", action="store_true",
                   help="also the RefUNet's float32 shapes")
    p.add_argument("--root", default=None,
                   help="checkout whose superdiff_torch is imported "
                        "(default: this one)")
    p.add_argument("--ref-only", action="store_true",
                   help="only the RefUNet's shapes through the public "
                        "fused_groupnorm_silu (which older checkouts have "
                        "too), device ms: for parent-against-change runs")
    p.add_argument("--train", action="store_true",
                   help="the training chain's forward and backward kernels "
                        "(float32 norm dtype) instead")
    p.add_argument("--trace", action="store_true",
                   help="also a traced cluster launch at each shape")
    p.add_argument("--sweep", action="store_true",
                   help="also cluster sizes 4-16, 128 and 256 threads and "
                        "three shared-memory caps at each shape")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root or os.path.join(
        os.path.dirname(__file__), "..", "..")))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this tool needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from superdiff_torch.models.presets import build_model
    from superdiff_torch.ops import _build
    from superdiff_torch.ops import fused_norm as fn

    print(card_line(), flush=True)
    if args.ref_only:
        from superdiff_torch.tools.timing import kernel_device_ms

        warm_up()
        out = {}
        for (C, G) in REF_SHAPES:
            x, gamma, beta, _, _ = chain_inputs(16, 256, 256, C, False,
                                                torch.float32, seed=C + G)
            out[f"C{C}_G{G}"] = kernel_device_ms(
                lambda: fn.fused_groupnorm_silu(x, gamma, beta, G),
                kernel=None)
        print("gn_ref_only " + json.dumps(dict(root=args.root or ".",
                                                device_ms=out)), flush=True)
        return 0
    _build.build("gn", verbose=True)
    regimes = args.regimes.split(",")
    nd = getattr(torch, args.norm_dtype)
    model = build_model("wide256", device="cuda").init_parameters(0).eval()
    model.set_norm_dtype(nd)
    shapes = wide256_chain_shapes(fn, model, args.batch)
    del model
    print("clocks " + warm_up(), flush=True)
    if args.train:
        rows = []
        for key, count in sorted(shapes.items()):
            rows.append(train_chain_row(fn, args.batch, key, count))
            print("gn_train_chain " + json.dumps(rows[-1]), flush=True)
        print("gn_train_summary " + json.dumps(summarize_train(rows)),
              flush=True)
        failed = [r["shape"] + [r["film"]] for r in rows if r.get("failed")]
        if failed:
            print(f"{len(failed)} rows disagree: {json.dumps(failed)}",
                  file=sys.stderr)
        return 1 if failed else 0
    rows = []
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0]):
        rows.append(chain_row(fn, args.batch, key, count, nd, regimes))
        print("gn_chain " + json.dumps(rows[-1]), flush=True)
    print("gn_chain_summary " + json.dumps(summarize(rows, regimes)),
          flush=True)
    print("clocks " + warm_up(0.1), flush=True)
    failed = [r for r in rows if r.get("failed")]
    if args.ref:
        ref_rows = []
        for (C, G), count in REF_SHAPES.items():
            ref_rows.append(chain_row(fn, 16, (256, 256, C, G, False,
                                               "float32"), count, None,
                                      regimes, policy=False))
            print("gn_ref " + json.dumps(ref_rows[-1]), flush=True)
        print("gn_ref_summary " + json.dumps(summarize(ref_rows, regimes)),
              flush=True)
        failed += [r for r in ref_rows if r.get("failed")]
    if args.trace:
        for key in sorted(shapes):
            print("gn_trace " + json.dumps(trace(fn, args.batch, key, nd)),
                  flush=True)
    if args.sweep:
        for key, count in sorted(shapes.items()):
            H, W, C, G, film, dname = key
            geos = set()
            for k, t, cap in itertools.product(
                    (4, 8, 16), (128, 256), (57856, 115712, 230400)):
                geos.add(fn.launch_geometry(
                    args.batch, H * W, C, G, getattr(torch, dname), nd, True,
                    "cluster", cluster=k, threads=t, smem_cap=cap))
            row = chain_row(fn, args.batch, key, count, nd, sorted(geos))
            best = min((v["device_ms"], k) for k, v in row.items()
                       if isinstance(v, dict)
                       and isinstance(v["device_ms"], float))
            print("gn_sweep " + json.dumps(dict(
                shape=row["shape"], film=film, best=best, all={
                    k: [v["device_ms"], v.get("clusters_at_once")]
                    for k, v in row.items() if isinstance(v, dict)})),
                flush=True)
    if failed:
        print(f"{len(failed)} rows disagree: "
              + json.dumps([r["shape"] + [r["film"]] for r in failed]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
