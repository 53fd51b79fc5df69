"""Run-scoped visualization CLI of the port (counterpart of
``superdiff_tpu.cli.visualize``).

Operates on a trained run directory (an exported artifact or one of the
port's training run dirs): samples DDPM (full T) from the run under the
sampling dtype policy through one :class:`~superdiff_torch.diffusion.
graphed.GraphedSampler` (a CUDA graph of one step on the card, the 8
trajectory frames copied between replays), then renders real-vs-generated
rows, the reverse-trajectory and forward-diffusion strips, a t-SNE of real
against generated features (the ``diffusion`` extractor on the float32
model), the static dashboard and, with ``--run-dir2``, the A vs B vs
superposed panel. The JAX CLI's flags and file names, plus ``--device``
(default ``cuda``; raises when no card is there).

Usage:
    python -m superdiff_torch.cli.visualize --run-dir RUN \
        --dataset-root data/xray --tsne --trajectory
    python -m superdiff_torch.cli.visualize --run-dir A --run-dir2 B --compare
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize a trained run")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--run-dir2", default=None)
    p.add_argument("--dataset-root", default=None)
    p.add_argument("--out", default=None,
                   help="default: <run-dir>/viz")
    p.add_argument("--num-samples", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--real-vs-generated", action="store_true")
    p.add_argument("--trajectory", action="store_true")
    p.add_argument("--forward-strip", action="store_true")
    p.add_argument("--tsne", action="store_true",
                   help="project real vs generated features")
    p.add_argument("--compare", action="store_true",
                   help="A vs B vs superposed panel (needs --run-dir2)")
    p.add_argument("--dashboard", action="store_true",
                   help="write a self-contained dashboard.html "
                        "(needs --dataset-root)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def sample_trajectory(model, schedule, shape, seed: int,
                      eager: bool = False):
    """DDPM (full T) of a batch of ``shape`` (NHWC) from ``model`` under the
    sampling dtype policy (applied to a copy), through one
    :class:`~superdiff_torch.diffusion.graphed.GraphedSampler` (``eager``:
    its step run eagerly on the card too), drawing from a generator seeded
    with ``seed``. Returns ``(samples, frames)``, 8 trajectory frames."""
    import torch

    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.samplers import DDPMPlan
    from superdiff_torch.inference import apply_sampling_policy, make_eps_fn

    device = schedule.device
    s_model = apply_sampling_policy(copy.deepcopy(model))
    sampler = GraphedSampler(
        DDPMPlan(schedule, make_eps_fn(s_model, schedule=schedule), shape),
        capture=device.type == "cuda" and not eager)
    return sampler(torch.Generator(device=device).manual_seed(seed),
                   num_frames=8)


def main(argv=None, record=None) -> int:
    """Run the CLI. ``record``, a dict, receives the samples and frames,
    the seconds of each stage and the comparison's statistics."""
    args = build_parser().parse_args(argv)

    import torch

    from superdiff_torch.inference import load_run
    from superdiff_torch.utils.visualization import (
        save_forward_diffusion_strip, save_image_grid,
        save_real_vs_generated, save_reverse_trajectory_strip)

    record = {} if record is None else record
    seconds = record.setdefault("seconds", {})
    device = torch.device(args.device)
    out = args.out or os.path.join(args.run_dir, "viz")
    os.makedirs(out, exist_ok=True)
    cfg, model, schedule = load_run(args.run_dir, device=device)
    # sampling under the production dtype policy; the features below come
    # from the float32 model (comparable features)
    tic = time.time()
    R = cfg.training.resolution
    gen, frames = sample_trajectory(model, schedule,
                                    (args.num_samples, R, R, 1), args.seed)
    gen_np = gen.float().cpu().numpy()
    seconds["sample"] = time.time() - tic
    record["samples"], record["frames"] = gen, frames
    save_image_grid(gen_np, os.path.join(out, "generated.png"))
    print("wrote generated.png")

    if args.trajectory:
        tic = time.time()
        save_reverse_trajectory_strip(frames,
                                      os.path.join(out, "trajectory.png"))
        seconds["trajectory"] = time.time() - tic
        print("wrote trajectory.png")

    real = None
    if args.dataset_root:
        from superdiff_torch.data.datamodule import DataModule

        tic = time.time()
        dm = DataModule(cfg, args.dataset_root)
        batch = next(iter(dm.device_batches(
            "test", torch.Generator(device=device).manual_seed(1),
            device=device)))
        real = batch["image"].float().cpu().numpy()[:args.num_samples]
        seconds["real_batch"] = time.time() - tic

    if args.real_vs_generated:
        if real is None:
            print("--real-vs-generated needs --dataset-root", file=sys.stderr)
            return 2
        save_real_vs_generated(real, gen_np,
                               os.path.join(out, "real_vs_generated.png"))
        print("wrote real_vs_generated.png")

    if args.forward_strip:
        tic = time.time()
        T = schedule.num_timesteps
        save_forward_diffusion_strip(
            schedule, real if real is not None else gen_np,
            [0, T // 4, T // 2, 3 * T // 4, T - 1],
            torch.Generator(device=device).manual_seed(2),
            os.path.join(out, "forward_strip.png"))
        seconds["forward_strip"] = time.time() - tic
        print("wrote forward_strip.png")

    if args.tsne:
        from superdiff_torch.analysis import FeatureExtractor, run_projection

        tic = time.time()
        ex = FeatureExtractor("diffusion", model=model, schedule=schedule,
                              device=device)
        feats_gen = ex.extract(gen_np)
        if real is not None:
            feats_real = ex.extract(real)
            feats = np.concatenate([feats_real, feats_gen])
            labels = np.concatenate([np.zeros(len(feats_real), np.int32),
                                     np.ones(len(feats_gen), np.int32)])
            names = ["real", "generated"]
        else:
            feats, labels, names = feats_gen, np.zeros(
                len(feats_gen), np.int32), ["generated"]
        run_projection(feats, labels, "tsne",
                       os.path.join(out, "tsne_real_vs_gen.png"),
                       class_names=names, device=device)
        seconds["tsne"] = time.time() - tic
        print("wrote tsne_real_vs_gen.png")

    if args.dashboard:
        if not args.dataset_root:
            print("--dashboard needs --dataset-root", file=sys.stderr)
            return 2
        from superdiff_torch.analysis.dashboard import build_static_dashboard

        tic = time.time()
        build_static_dashboard(
            args.dataset_root, os.path.join(out, "dashboard.html"),
            run_dir=args.run_dir, task=cfg.task,
            histogram_equalization=cfg.training.histogram_equalization,
            device=device)
        seconds["dashboard"] = time.time() - tic
        print("wrote dashboard.html")

    if args.compare:
        if not args.run_dir2:
            print("--compare needs --run-dir2", file=sys.stderr)
            return 2
        from superdiff_torch.analysis.compare import compare_runs

        tic = time.time()
        stats = compare_runs(args.run_dir, args.run_dir2, out,
                             num_samples=min(args.num_samples, 4),
                             seed=args.seed, device=device)
        seconds["compare"] = time.time() - tic
        record["compare"] = stats
        print(f"wrote comparison.png; mean logq gap "
              f"{stats['mean_logq_gap']:.2f}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
