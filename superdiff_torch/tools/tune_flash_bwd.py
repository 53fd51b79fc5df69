#!/usr/bin/env python3
"""Sweep the launch geometry of the flash-attention backward kernels (B2
dQ, B3 dK/dV) on the card, and read what the compiler made of them.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 superdiff_torch/tools/tune_flash_bwd.py [--dtype D] [--sweep]
        [--kernel dq|dkv] [--shape B,S,H,D]

For each shape (the wide256 path shapes by default: batch 16, H=4, S=1024 /
256 / 64) and each geometry (warps per block, rows per looped tile, 16-row
m-tiles per warp) it launches the kernel through
``ops/flash_attention.py::_launch_bwd``: 1-8 warps of each tile the kernel
is built with (``_BWD_TILE``), and with ``--sweep`` also of the tiles that
a variant build of the same source adds (``-DSUPERDIFF_BWD_SWEEP``;
``sweep_tiles``). It checks each result against
``_flash_bwd_{dq,dkv}_plain`` (relative to the gradient's largest entry)
and against a rerun of itself (same bits), and times it
(``tools/timing.py``): CUDA events over back-to-back calls and the kernel's
own device time from ``torch.profiler``. Beside each shape it times the
yardstick, SDPA's whole backward (one ``torch.autograd.grad`` of
``F.scaled_dot_product_attention`` for dQ, dK and dV: events, and the
device time of all its kernels), and the ``_bwd_delta`` expression that
feeds both kernels, and it marks the geometry ``_bwd_geometry`` picks. It
also prints the compiler's report (``ptxas -v``), per instantiation the
registers, spill bytes, shared memory and resident blocks per SM
(``bwd_kernel_info``), and the ``MUFU.EX2`` and ``HMMA`` instructions in
its SASS. One JSON line per measurement, the card's name and power limit
first.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from superdiff_torch.tools.timing import (  # noqa: E402
    cuda_time_ms, kernel_device_ms)
from superdiff_torch.tools.tune_flash_fwd import (  # noqa: E402
    PATH_SHAPES, sass_counts)

# relative to the gradient's largest entry: bf16 rounds P, dS and the
# result (2^-8 each); f32 differs only in summation order and exp2 vs exp
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SWEEP = "SUPERDIFF_BWD_SWEEP"
KERNEL_NAMES = {"dq": "flash_bwd_dq_kernel", "dkv": "flash_bwd_dkv_kernel"}


def sweep_tiles() -> dict:
    """The (bt, mt) a --sweep build adds, by (dtype code, D, kernel): the
    entries of ``SUPERDIFF_BWD_CASES`` under ``SUPERDIFF_BWD_SWEEP`` in
    ``csrc/flash_attn_bwd.cu``."""
    from superdiff_torch.ops import _build

    tiles = {}
    for k, code, D, bt, mt in _build.source_tiles("bwd",
                                                  "SUPERDIFF_BWD_CASES"):
        tiles.setdefault((code, D, ("dq", "dkv")[k]), []).append((bt, mt))
    return tiles


def bwd_inputs(B, S, H, D, dtype):
    """q, k, v as strided views of one fused projection and a strided dO
    (the layouts the training path hands the kernels), seeded."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(B * S + D + 1)
    fused = torch.randn((2, B, S, 3 * H * D), generator=gen,
                        device="cuda").to(dtype)
    q, k, v = (a.view(B, S, H, D) for a in fused[0].split(H * D, dim=-1))
    g = fused[1].split(H * D, dim=-1)[1].view(B, S, H, D)
    return q, k, v, g


def sdpa_backward(q, k, v, g):
    """A closure of SDPA's whole backward (dQ, dK, dV) on the same inputs,
    the yardstick of the two kernels."""
    import torch
    import torch.nn.functional as F

    qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    oh = F.scaled_dot_product_attention(qh, kh, vh)
    gh = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(oh, (qh, kh, vh), gh,
                                       retain_graph=True)


def max_rel_err(got, ref):
    """Largest |got - ref| over each gradient's largest |ref|, and the
    absolute error, over the pairs."""
    rel = ab = 0.0
    for a, b in zip(got, ref):
        err = (a.float() - b.float()).abs().max().item()
        rel = max(rel, err / max(b.float().abs().max().item(), 1e-30))
        ab = max(ab, err)
    return rel, ab


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--shape", action="append", default=None,
                   help="B,S,H,D (repeatable); default: the path shapes")
    p.add_argument("--kernel", action="append", default=None,
                   choices=["dq", "dkv"], help="default: both")
    p.add_argument("--sweep", action="store_true",
                   help="also the tiles of a variant build (sweep_tiles)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this tool times the kernels on a card",
              file=sys.stderr)
        return 2
    from superdiff_torch.ops import _build
    from superdiff_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card, torch=torch.__version__)), flush=True)
    defines = (SWEEP,) if args.sweep else ()
    so = _build.build("bwd", verbose=True, defines=defines)
    dtype = getattr(torch, args.dtype)
    code = fa._DTYPE_CODE[dtype]
    for name, c in sass_counts(so, _build._nvcc()).items():
        print(json.dumps(dict(sass=name, **c)), flush=True)

    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shape]
              if args.shape else PATH_SHAPES)
    kernels = args.kernel or ["dq", "dkv"]
    for (B, S, H, D) in shapes:
        q, k, v, g = bwd_inputs(B, S, H, D, dtype)
        out, lse = fa._flash_forward(q, k, v)
        delta = fa._bwd_delta(out, g)
        sdpa = sdpa_backward(q, k, v, g)
        print(json.dumps(dict(
            shape=[B, S, H, D], dtype=args.dtype,
            sdpa_bwd_ms=cuda_time_ms(sdpa, 30),
            sdpa_bwd_device_ms=kernel_device_ms(sdpa, kernel=None),
            delta_device_ms=kernel_device_ms(
                lambda: fa._bwd_delta(out, g), kernel=None))), flush=True)
        for kern in kernels:
            plain = (fa._flash_bwd_dq_plain if kern == "dq"
                     else fa._flash_bwd_dkv_plain)
            ref = plain(q, k, v, g, lse, delta)
            ref = (ref,) if kern == "dq" else ref
            chosen = fa._bwd_geometry(kern, B, S, H, D, q.element_size())[:3]
            tiles = (*fa._BWD_TILE[(code, D, kern)],
                     *(sweep_tiles().get((code, D, kern), ())
                       if args.sweep else ()))
            for (bt, mt), warps in itertools.product(tiles, (1, 2, 4, 8)):
                if fa._bwd_smem_bytes(kern, D, q.element_size(), warps, bt,
                                      mt) > fa.MAX_SMEM:
                    continue
                run = lambda: fa._launch_bwd(kern, q, k, v, g, lse, delta,
                                             warps, bt, mt, defines)
                got, again = run(), run()
                torch.cuda.synchronize()
                got = (got,) if kern == "dq" else got
                again = (again,) if kern == "dq" else again
                rel, ab = max_rel_err(got, ref)
                ok = (all(bool(torch.isfinite(a.float()).all()) for a in got)
                      and rel <= TOL[args.dtype])
                row = dict(kernel=kern, shape=[B, S, H, D],
                           dtype=args.dtype, warps=warps, bt=bt, mt=mt,
                           chosen=(warps, bt, mt) == chosen,
                           blocks=B * H * -(-S // (16 * mt * warps)),
                           agrees=ok, max_abs_err=ab, max_rel_err=rel,
                           rerun_bit_equal=all(torch.equal(a, b) for a, b
                                               in zip(got, again)),
                           ms=cuda_time_ms(run, 30),
                           device_ms=kernel_device_ms(
                               run, kernel=(KERNEL_NAMES[kern],)),
                           **fa.bwd_kernel_info(kern, D, dtype, warps, bt,
                                                mt, defines))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
