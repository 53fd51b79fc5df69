#!/usr/bin/env python3
"""Sweep the launch geometry of the flash-attention forward kernel (B1) on
the card, and read what the compiler made of it.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 superdiff_torch/tools/tune_flash_fwd.py [--dtype D] [--sweep]

For each shape (the wide256 path shapes by default: batch 16, H=4, S=1024 /
256 / 64) and each geometry (warps per block, keys per K/V tile, 16-row
m-tiles per warp) it launches the kernel through
``ops/flash_attention.py::_launch_fwd``: 1-8 warps of the tile the kernel
is built with, and with ``--sweep`` also of the tiles that a variant build
of the same source adds (``-DSUPERDIFF_FWD_SWEEP``; ``sweep_tiles``). It
checks the kernel against ``_flash_forward_plain`` and against a rerun of
itself (same bits), and times it (``tools/timing.py``): CUDA events over
back-to-back calls and the kernel's own device time from
``torch.profiler``. Beside each shape it times
``F.scaled_dot_product_attention`` (events, and the device time of all its
kernels) as the yardstick, and marks the geometry that ``_fwd_geometry``
picks. It also prints, per instantiation, the registers, spill bytes,
shared memory and resident blocks per SM (``fwd_kernel_info``) and the
``MUFU.EX2`` instructions in its SASS (``cuobjdump -sass``). One JSON line
per measurement, the card's name and power limit first.
"""

import argparse
import itertools
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from superdiff_torch.tools.timing import (  # noqa: E402
    cuda_time_ms, kernel_device_ms)

PATH_SHAPES = [(16, 1024, 4, 32), (16, 256, 4, 64), (16, 64, 4, 64)]
TOL = {"bfloat16": dict(out=2e-2, lse=2e-3), "float32": dict(out=1e-4,
                                                              lse=1e-4)}
SWEEP = "SUPERDIFF_FWD_SWEEP"


def sweep_tiles() -> dict:
    """The (bk, mt) a --sweep build adds, by (dtype code, D): the entries of
    ``SUPERDIFF_FWD_CASES`` under ``SUPERDIFF_FWD_SWEEP`` in
    ``csrc/flash_attn_fwd.cu``."""
    from superdiff_torch.ops import _build

    tiles = {}
    for code, D, bk, mt in _build.source_tiles("fwd", "SUPERDIFF_FWD_CASES"):
        tiles.setdefault((code, D), []).append((bk, mt))
    return tiles


def sass_counts(so_path, nvcc):
    """``{demangled kernel name: {"MUFU.EX2": n, "HMMA": n}}`` from
    ``cuobjdump -sass`` of the built library."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", str(so_path)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        return {"error": res.stderr.strip()[-500:]}
    counts, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"MUFU.EX2": 0, "HMMA": 0}
        elif name is not None:
            for op in counts[name]:
                if op in line:
                    counts[name][op] += 1
    names = list(counts)
    res = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True)
    if res.returncode == 0:
        counts = dict(zip(res.stdout.splitlines(), counts.values()))
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--shape", action="append", default=None,
                   help="B,S,H,D (repeatable); default: the path shapes")
    p.add_argument("--sweep", action="store_true",
                   help="also the tiles of a variant build (sweep_tiles)")
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device: this tool times the kernel on a card",
              file=sys.stderr)
        return 2
    from superdiff_torch.ops import _build
    from superdiff_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card, torch=torch.__version__)), flush=True)
    defines = (SWEEP,) if args.sweep else ()
    so = _build.build("fwd", defines=defines)
    dtype = getattr(torch, args.dtype)
    code = fa._DTYPE_CODE[dtype]
    for name, c in sass_counts(so, _build._nvcc()).items():
        print(json.dumps(dict(sass=name, **c)), flush=True)

    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shape]
              if args.shape else PATH_SHAPES)
    for (B, S, H, D) in shapes:
        g = torch.Generator(device="cuda").manual_seed(B * S + D)
        qkv = torch.randn((B, S, 3 * H * D), generator=g,
                          device="cuda").to(dtype)
        q, k, v = (a.view(B, S, H, D) for a in qkv.split(H * D, dim=-1))
        ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        print(json.dumps(dict(
            shape=[B, S, H, D], dtype=args.dtype,
            sdpa_ms=cuda_time_ms(sdpa, 50),
            sdpa_device_ms=kernel_device_ms(sdpa, kernel=None))), flush=True)
        chosen = fa._fwd_geometry(B, S, H, D, q.element_size())[:3]
        tiles = (fa._FWD_TILE[(code, D)],
                 *(sweep_tiles().get((code, D), ()) if args.sweep else ()))
        for (bk, mt), warps in itertools.product(tiles, (1, 2, 4, 8)):
            if fa._fwd_smem_bytes(D, q.element_size(), warps, bk,
                                  mt) > fa.MAX_SMEM:
                continue
            run = lambda: fa._launch_fwd(q, k, v, warps, bk, mt, defines)
            out, lse = run()
            out2, lse2 = run()
            torch.cuda.synchronize()
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = (bool(torch.isfinite(out.float()).all())
                  and err <= TOL[args.dtype]["out"]
                  and lse_err <= TOL[args.dtype]["lse"])
            row = dict(shape=[B, S, H, D], dtype=args.dtype, warps=warps,
                       bk=bk, mt=mt, chosen=(warps, bk, mt) == chosen,
                       blocks=B * H * -(-S // (16 * mt * warps)),
                       agrees=ok, max_abs_err=err, lse_max_abs_err=lse_err,
                       rerun_bit_equal=bool(torch.equal(out, out2)
                                            and torch.equal(lse, lse2)),
                       ms=cuda_time_ms(run, 50),
                       device_ms=kernel_device_ms(run),
                       **fa.fwd_kernel_info(D, dtype, warps, bk, mt,
                                            defines))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
