"""Export a trained run as a portable, compact inference artifact
(counterpart of ``superdiff_tpu.cli.export``).

A training checkpoint carries parameters, EMA and Adam moments: right for
resume, wrong for publishing. This CLI snapshots what sampling needs, the
EMA parameters as one compressed ``ema_params.npz`` (Flax-layout ``a/b/c``
keys, readable by both packages) next to the config snapshot;
``load_run`` loads such a directory wherever a run directory is accepted.

The EMA weights are loaded onto ``--device`` (default ``cuda``, which raises
when no card is there; pass ``--device cpu`` on a machine without one).

Usage:
    python -m superdiff_torch.cli.export --run-dir RUN --out artifacts/tb64
    python -m superdiff_torch.cli.sample --run-dir artifacts/tb64 ...
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Export a run's EMA params + config for inference")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from superdiff_torch.compat.flax_params import (
        EXPORT_FILE, export_params, to_flax)
    from superdiff_torch.config import save_config
    from superdiff_torch.inference import load_run

    cfg, model, _ = load_run(args.run_dir, step=args.step,
                             device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, EXPORT_FILE)
    # under a top "params" level, as Flax variables: the JAX package applies
    # what its load_run reads as it stands
    n = export_params({"params": to_flax(model)}, path, args.dtype)
    save_config(cfg, os.path.join(args.out, "config.yaml"))
    print(f"exported {n} arrays ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"{args.dtype}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
