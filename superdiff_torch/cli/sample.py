"""Sampling CLI of the port (counterpart of ``superdiff_tpu.cli.sample``).

Modes:
- single-run DDPM (full-T ancestral), DDIM (``--num-steps``/``--eta``) or
  DPM-Solver++(2M) (``--method dpmpp``);
- SuperDiff superposition of two runs (``--run-dir2``, ``--mode``).

Each batch writes into ``--out``: ``samples.npy`` (all batches, NHWC) and,
for SuperDiff, ``logq.json``. Run dirs are exported inference artifacts
(``config.yaml`` + ``ema_params.npz``).

Usage:
    python -m superdiff_torch.cli.sample --run-dir RUN --method ddim \
        --num-steps 50 --batch-size 8 --device cuda
    python -m superdiff_torch.cli.sample --run-dir TB_RUN --run-dir2 PNEU_RUN \
        --mode or --out superposed/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sample from exported runs")
    p.add_argument("--run-dir", required=True,
                   help="exported run dir (config.yaml + ema_params.npz)")
    p.add_argument("--run-dir2", default=None,
                   help="second run dir -> SuperDiff superposition")
    p.add_argument("--method", choices=["ddpm", "ddim", "dpmpp"],
                   default=None,
                   help="default: the run config's sampling.method")
    p.add_argument("--num-steps", type=int, default=None,
                   help="solver steps (DDIM default 50, dpmpp 20; ddpm "
                        "always runs the full T)")
    p.add_argument("--spacing", choices=["auto", "leading", "trailing"],
                   default="auto", help="DDIM grid spacing")
    p.add_argument("--eta", type=float, default=0.0,
                   help="DDIM stochasticity (0 = deterministic)")
    p.add_argument("--label", type=int, default=None,
                   help="class label (default: unconditional/null)")
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--mode", choices=["or", "and", "fixed"], default="or")
    p.add_argument("--kappa", type=float, nargs=2, default=(0.5, 0.5))
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-batches", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="samples")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from superdiff_torch.diffusion import (ddim_sample, ddpm_sample,
                                           dpmpp_sample)
    from superdiff_torch.diffusion.superdiff import superdiff_sample
    from superdiff_torch.inference import (apply_sampling_policy,
                                           check_superpose_compat, load_run,
                                           make_eps_fn_p,
                                           resolve_sampler_spec)

    device = torch.device(args.device)
    cfg, model, schedule = load_run(args.run_dir, device=device)
    apply_sampling_policy(model)
    R = cfg.training.resolution
    B = args.batch_size
    shape = (B, R, R, 1)
    os.makedirs(args.out, exist_ok=True)

    superpose = args.run_dir2 is not None
    if superpose:
        cfg2, model2, _ = load_run(args.run_dir2, device=device)
        check_superpose_compat(cfg, cfg2)
        apply_sampling_policy(model2)
        apply1 = make_eps_fn_p(model, args.label, schedule=schedule)
        apply2 = make_eps_fn_p(model2, args.label, schedule=schedule)
        fns = [lambda x, t: apply1(model, x, t),
               lambda x, t: apply2(model2, x, t)]

        def sample_fn(g):
            return superdiff_sample(
                schedule, fns, shape, g, mode=args.mode,
                kappa=list(args.kappa), temperature=args.temperature)
    else:
        method, num_steps, spacing, clip_x0 = resolve_sampler_spec(
            cfg, args.method, args.num_steps, args.spacing)
        if cfg.model.conditional and args.label is not None:
            y = torch.full((B,), args.label, dtype=torch.long, device=device)
            applyp = make_eps_fn_p(model, "per_sample", schedule=schedule)
            extra = dict(y=y, guidance_scale=args.guidance,
                         null_label=model.null_label)
        else:
            applyp = make_eps_fn_p(model, args.label, schedule=schedule)
            extra = {}
        fn = lambda *a: applyp(model, *a)

        if method == "ddim":
            steps = num_steps or 50

            def sample_fn(g):
                return ddim_sample(schedule, fn, shape, g, num_steps=steps,
                                   eta=args.eta, t_spacing=spacing,
                                   clip_x0=clip_x0, **extra)
        elif method == "dpmpp":
            if args.eta:
                raise SystemExit(
                    "--eta only applies to --method ddim; DPM-Solver++ is "
                    "a deterministic ODE solver (no stochasticity knob)")
            steps = num_steps or 20

            def sample_fn(g):
                return dpmpp_sample(schedule, fn, shape, g, num_steps=steps,
                                    clip_x0=clip_x0, **extra)
        else:
            def sample_fn(g):
                return ddpm_sample(schedule, fn, shape, g, **extra)

    all_batches, all_logq = [], []
    for b in range(args.num_batches):
        g = torch.Generator(device=device).manual_seed(args.seed + b)
        tic = time.time()
        out = sample_fn(g)
        if superpose:
            x, logq = out
            lq = logq.cpu().numpy()
            all_logq.append(lq)
            print(f"batch {b}: {time.time() - tic:.3f}s  logq1-logq2 mean "
                  f"{float(np.mean(lq[0] - lq[1])):.2f}")
        else:
            x = out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"batch {b}: {time.time() - tic:.3f}s")
        all_batches.append(x.float().cpu().numpy())

    stack = np.concatenate(all_batches)
    np.save(os.path.join(args.out, "samples.npy"), stack)
    if all_logq:
        lq = np.concatenate(all_logq, axis=1)
        gap = lq[0] - lq[1]
        with open(os.path.join(args.out, "logq.json"), "w") as f:
            json.dump({"mode": args.mode,
                       "logq_model1": lq[0].tolist(),
                       "logq_model2": lq[1].tolist(),
                       "logq_gap_mean": float(gap.mean()),
                       "logq_gap_std": float(gap.std())}, f)
    print(f"wrote {stack.shape[0]} samples to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
