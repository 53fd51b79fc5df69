"""Training CLI of the port (counterpart of ``superdiff_tpu.cli.train``).

YAML config + dotted-path overrides, experiment/run ids, dataset/task
selection, logging toggles, ``--no-resume``, ``--synthetic`` for datasetless
runs, and ``--device`` (default ``cuda``; raises when no card is there).
Launched as several processes (``SUPERDIFF_TPU_MULTIHOST=1`` with the
``SUPERDIFF_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID`` triple,
or under torchrun), it trains data-parallel over all of them.

Usage:
    python -m superdiff_torch.cli.train --synthetic --device cuda \
        --experiment-id e1 --run-id r1 \
        --set model.preset=wide256 --set training.resolution=256 \
        --set training.batch_size=16
"""

from __future__ import annotations

import argparse
import sys

from superdiff_torch.config import load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a diffusion model")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--experiment-id", "--experiment_id", dest="experiment_id")
    p.add_argument("--run-id", "--run_id", dest="run_id")
    p.add_argument("--dataset")
    p.add_argument("--task")
    p.add_argument("--use-wandb", "--use_wandb", dest="use_wandb",
                   default=None)
    p.add_argument("--use-tensorboard", "--use_tensorboard",
                   dest="use_tensorboard", default=None)
    p.add_argument("--dataset-root", default=None,
                   help="explicit dataset directory (overrides paths)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (no dataset needed)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY.PATH=VALUE")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # a multi-process launch (SUPERDIFF_TPU_MULTIHOST=1) joins its group
    # before anything touches the device
    from superdiff_torch.parallel.mesh import (
        is_main_process, leave_distributed, maybe_init_distributed)
    joined = maybe_init_distributed(args.device)
    cfg = load_config(args.config, args.overrides)
    if args.experiment_id:
        cfg.experiment_id = args.experiment_id
    if args.run_id:
        cfg.run_id = args.run_id
    if args.dataset:
        cfg.dataset = args.dataset
        cfg.task = args.dataset
    if args.task:
        cfg.task = args.task
    for flag in ("use_wandb", "use_tensorboard"):
        v = getattr(args, flag)
        if v is not None:
            setattr(cfg.logging, flag,
                    str(v).strip().lower() not in ("false", "0", "no"))

    from superdiff_torch.training.loop import train
    main = is_main_process()
    try:
        summary = train(cfg, dataset_root=args.dataset_root,
                        resume=not args.no_resume,
                        use_synthetic=args.synthetic, device=args.device)
    finally:
        leave_distributed(joined)
    if main:
        print(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
