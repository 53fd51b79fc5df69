"""Progressive-distillation CLI of the port (counterpart of
``superdiff_tpu.cli.distill``): halve sampler steps phase by phase.

Drives ``diffusion/distill.py`` (arXiv:2202.00512) over a trained run:
phase k trains an N_k-step student whose single DDIM step matches two steps
of its teacher on the 2·N_k trailing grid. The first teacher is the run's
own EMA model (``load_run``: the run's config dtypes, float32 parameters,
as the JAX teacher runs inside its jitted step; not the sampling policy's
bfloat16 weight cast), every later teacher the previous student's EMA model,
rolled unclipped. Each student starts as a separate float32 copy of its
teacher's weights (the update is in place, so a teacher that aliased it
would drift) and trains with Adam under a cosine schedule whose warm-up is
kept inside the phase.

Each phase writes an exported inference artifact (``config.yaml`` +
``ema_params.npz``, the ``cli/export.py`` format, readable by both packages)
into ``<out>/s<N>/`` with ``sampling.method=ddim``,
``sampling.num_steps=N``, ``sampling.t_spacing=trailing``,
``sampling.eta=0`` and ``sampling.clip_x0=false`` stamped in (students
train on unclipped one-step inversions), so ``cli.sample``, ``cli.evaluate``
and ``cli.serve`` sample a student by its stamp. ``<out>/summary.json``
holds each phase's losses, ms per step and images/s (over the steps after
the first) and peak device memory.

Usage:
    python -m superdiff_torch.cli.distill --run-dir RUN \
        --dataset-root data/chest_xray --steps 8,4,2,1 --phase-epochs 60
    python -m superdiff_torch.cli.sample --run-dir RUN/distill/s4
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Progressively distill a trained run to few-step "
                    "sampling")
    p.add_argument("--run-dir", required=True,
                   help="teacher run dir (exported artifact or a "
                        "superdiff_torch training run dir)")
    p.add_argument("--dataset-root", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="distill on synthetic batches (smoke runs)")
    p.add_argument("--steps", default="8,4,2,1",
                   help="comma list of student step counts; each entry "
                        "must be half its predecessor (the student grid "
                        "must nest in its teacher's)")
    p.add_argument("--phase-epochs", type=int, default=60,
                   help="training epochs per phase")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the run's training batch size")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=50)
    p.add_argument("--parameterization", choices=["eps", "v", "x0"],
                   default="v",
                   help="student head (v recommended: eps heads carry no "
                        "x0 signal at the pure-noise node 1-2 step "
                        "samplers start from, arXiv:2202.00512 §2.4)")
    p.add_argument("--null-prob", type=float, default=0.5,
                   help="probability of distilling the null-label "
                        "(unconditional) path per example on conditional "
                        "runs; keep > 0 if you sample/evaluate "
                        "unconditionally")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output base (default: <run-dir>/distill)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def _parse_steps(spec: str):
    steps = [int(s) for s in spec.split(",") if s.strip()]
    if not steps or any(s < 1 for s in steps):
        raise SystemExit(f"bad --steps {spec!r}")
    for a, b in zip(steps, steps[1:]):
        if b * 2 != a:
            raise SystemExit(
                f"--steps must halve phase over phase (got {a} -> {b}): "
                "a student is only trained at its own grid nodes, so the "
                "next phase's teacher grid (2x its step count) must "
                "coincide with them")
    return steps


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    steps_list = _parse_steps(args.steps)

    import numpy as np
    import torch

    from superdiff_torch.compat.flax_params import (
        EXPORT_FILE, export_params, to_flax)
    from superdiff_torch.config import save_config
    from superdiff_torch.data.datamodule import DataModule
    from superdiff_torch.diffusion.distill import make_distill_step
    from superdiff_torch.inference import load_run, make_eps_fn_p
    from superdiff_torch.models.presets import model_from_config
    from superdiff_torch.training.loop import _synthetic_batches, _uint8_batch
    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)
    from superdiff_torch.utils.logger import init_logger

    init_logger(stdout=True)
    logger = logging.getLogger("superdiff_torch")
    device = torch.device(args.device)
    cfg, teacher, schedule = load_run(args.run_dir, device=device)
    teacher.requires_grad_(False)
    t = cfg.training
    B = args.batch_size or t.batch_size
    conditional = cfg.model.conditional
    out_base = args.out or os.path.join(args.run_dir, "distill")

    # student config: same architecture, the student head's
    # parameterization
    s_cfg = copy.deepcopy(cfg)
    s_cfg.model.parameterization = args.parameterization
    s_cfg.training.batch_size = B

    dm = None
    if not args.synthetic:
        if args.dataset_root is None:
            raise SystemExit("--dataset-root required (or --synthetic)")
        dm = DataModule(s_cfg, args.dataset_root)
        dm.index("train")

    def batches(epoch):
        if dm is not None:
            return (_uint8_batch(b, device)
                    for b in dm.iterator("train", epoch=epoch))
        return _synthetic_batches(s_cfg, epoch, device, augmentation="none")

    steps_per_epoch = (len(dm.iterator("train", epoch=0)) if dm
                       else (t.steps_per_epoch or 4))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the first teacher may be any parameterization (its eps adapter
    # converts); it rolls with its own sampler's clip policy, later teachers
    # (students trained on unclipped inversions) unclipped
    teacher_fn = make_eps_fn_p(teacher, "per_sample" if conditional else None,
                               schedule=schedule)
    teacher_clip = bool(getattr(cfg.sampling, "clip_x0", True))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    summary = {"run_dir": args.run_dir, "batch_size": B,
               "steps_per_epoch": steps_per_epoch, "phases": []}
    for phase_idx, N in enumerate(steps_list):
        phase_tic = time.time()
        total_steps = steps_per_epoch * args.phase_epochs
        # short phases: keep the warm-up strictly inside the phase so the
        # cosine decay always has positive length
        warmup = min(args.warmup_steps, total_steps // 2)
        tx = make_optimizer(learning_rate=args.lr, warmup_steps=warmup,
                            total_steps=total_steps, schedule="cosine")
        student = model_from_config(s_cfg, device=device)
        student.load_state_dict(teacher.state_dict())      # copies
        state = create_train_state(student, generator, tx=tx,
                                   ema_decay=t.ema_decay)
        step_fn = make_distill_step(
            schedule, teacher_fn, num_student_steps=N,
            conditional=conditional,
            parameterization=args.parameterization,
            null_prob=args.null_prob if conditional else 0.0,
            null_label=getattr(student, "null_label", 0),
            normalization=t.normalization, clip_x0=teacher_clip)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        all_losses, first_done = [], None
        for epoch in range(args.phase_epochs):
            losses = []
            tic = time.time()
            for batch in batches(epoch):
                if not conditional:
                    batch = {"image": batch["image"]}
                state, m = step_fn(state, teacher, batch)
                losses.append(m["loss"])
                if first_done is None:
                    sync()
                    first_done = (time.time(), state.step)
            losses = torch.stack(losses).float().cpu().tolist()
            all_losses += losses
            if (epoch + 1) % 10 == 0 or epoch == args.phase_epochs - 1:
                logger.info(
                    "phase %d (N=%d) epoch %d/%d: loss=%.5f (%.1f img/s)",
                    phase_idx + 1, N, epoch + 1, args.phase_epochs,
                    float(np.mean(losses)),
                    len(losses) * B / max(time.time() - tic, 1e-9))
        if first_done is None:
            raise RuntimeError(f"phase {phase_idx + 1} yielded zero batches "
                               "(empty dataset or steps_per_epoch=0?)")
        sync()
        timed = state.step - first_done[1]
        dt = time.time() - first_done[0]
        row = {"num_steps": N, "steps": state.step,
               "first_loss": all_losses[0], "last_loss": all_losses[-1],
               "mean_last_epoch_loss": float(np.mean(losses)),
               "ms_per_step": dt / timed * 1e3 if timed else None,
               "images_per_s": timed * B / dt if timed else None,
               "peak_memory_gb": (torch.cuda.max_memory_allocated(device)
                                  / 1e9 if device.type == "cuda" else None)}

        # export the student's EMA as an inference artifact with its stamp
        sdir = os.path.join(out_base, f"s{N}")
        os.makedirs(sdir, exist_ok=True)
        out_cfg = copy.deepcopy(s_cfg)
        out_cfg.sampling.method = "ddim"
        out_cfg.sampling.num_steps = N
        out_cfg.sampling.t_spacing = "trailing"
        out_cfg.sampling.eta = 0.0
        # the student learned the UNclipped one-step inversion: its x0
        # routinely leaves [-1, 1] at high-noise nodes, and clamping it at
        # inference would run a map other than the one trained
        out_cfg.sampling.clip_x0 = False
        save_config(out_cfg, os.path.join(sdir, "config.yaml"))
        export_params({"params": to_flax(state.ema_model)},
                      os.path.join(sdir, EXPORT_FILE))
        row["seconds"] = time.time() - phase_tic
        row["out"] = sdir
        summary["phases"].append(row)
        logger.info("phase %d done in %.0fs -> %s (sampled by its stamp: "
                    "trailing DDIM-%d, clip_x0 off)", phase_idx + 1,
                    row["seconds"], sdir, N)

        # the student's EMA model becomes the next phase's teacher (its own
        # parameterization; unclipped, as it trained)
        teacher = state.ema_model
        teacher_fn = make_eps_fn_p(teacher,
                                   "per_sample" if conditional else None,
                                   schedule=schedule)
        teacher_clip = False

    os.makedirs(out_base, exist_ok=True)
    with open(os.path.join(out_base, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"distilled {args.run_dir} -> {out_base} "
          f"(students: {steps_list})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
