"""Sampling CLI of the port (counterpart of ``superdiff_tpu.cli.sample``).

Modes:
- single-run DDPM (full-T ancestral), DDIM (``--num-steps``/``--eta``) or
  DPM-Solver++(2M) (``--method dpmpp``);
- SuperDiff superposition of two runs (``--run-dir2``, ``--mode``).

Each batch is one :class:`~superdiff_torch.diffusion.graphed.GraphedSampler`
run: on the card, one CUDA graph of one sampler step, captured once and
replayed per step (``main(argv, eager=True)`` runs the same step eagerly,
for comparison); on the CPU, the step eagerly. Each batch writes a PNG grid
``batch{b}.png`` into ``--out``; at the end come ``samples.npy`` (all
batches, NHWC) and, for SuperDiff, ``logq.json``. Run dirs are exported
inference artifacts (``config.yaml`` + ``ema_params.npz``) or the port's
training run dirs (``--step`` / ``--best`` pick the checkpoint).

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
    p = argparse.ArgumentParser(description="Sample from trained runs")
    p.add_argument("--run-dir", required=True,
                   help="exported run dir (config.yaml + ema_params.npz) or "
                        "a superdiff_torch training run dir")
    p.add_argument("--run-dir2", default=None,
                   help="second run dir -> SuperDiff superposition")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--best", action="store_true",
                   help="load the best-validation checkpoint "
                        "(<checkpoint_dir>_best) instead of the latest")
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


def main(argv=None, eager: bool = False) -> int:
    """Run the CLI. ``eager=True`` runs each sampler step eagerly on the
    card too (no CUDA graph): the same samples, for timing against the
    graph."""
    args = build_parser().parse_args(argv)

    import torch

    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.samplers import (DDIMPlan, DDPMPlan,
                                                    DPMppPlan)
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import (apply_sampling_policy,
                                           check_superpose_compat, load_run,
                                           make_eps_fn_p,
                                           resolve_sampler_spec)
    from superdiff_torch.utils.visualization import save_image_grid

    device = torch.device(args.device)
    cfg, model, schedule = load_run(args.run_dir, device=device,
                                    step=args.step, best=args.best)
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
        plan = SuperDiffPlan(schedule, fns, shape, mode=args.mode,
                             kappa=list(args.kappa),
                             temperature=args.temperature)
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
            plan = DDIMPlan(schedule, fn, shape, num_steps=num_steps or 50,
                            eta=args.eta, t_spacing=spacing,
                            clip_x0=clip_x0, **extra)
        elif method == "dpmpp":
            if args.eta:
                raise SystemExit(
                    "--eta only applies to --method ddim; DPM-Solver++ is "
                    "a deterministic ODE solver (no stochasticity knob)")
            plan = DPMppPlan(schedule, fn, shape, num_steps=num_steps or 20,
                             clip_x0=clip_x0, **extra)
        else:
            plan = DDPMPlan(schedule, fn, shape, **extra)

    tic = time.time()
    sampler = GraphedSampler(plan, capture=device.type == "cuda"
                             and not eager)
    if sampler.graph is not None:
        print(f"captured one {type(plan).__name__} step as a CUDA graph in "
              f"{time.time() - tic:.3f}s")

    all_batches, all_logq = [], []
    for b in range(args.num_batches):
        g = torch.Generator(device=device).manual_seed(args.seed + b)
        tic = time.time()
        out = sampler(g)
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
        imgs = x.float().cpu().numpy()
        all_batches.append(imgs)
        save_image_grid(imgs, os.path.join(args.out, f"batch{b}.png"))

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
