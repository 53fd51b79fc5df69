"""Import a reference-trained PyTorch checkpoint for sampling on the card
(counterpart of ``superdiff_tpu.cli.import_torch``).

The reference saves ``ddpm_epoch{N}.pt`` / ``ema_epoch{N}.pt`` every epoch
but has no code that loads one. This CLI converts one into an exported
inference artifact (``config.yaml`` + ``ema_params.npz``) that
``superdiff_torch.cli.sample`` (and the JAX package) read:

    python -m superdiff_torch.cli.import_torch \
        --checkpoint checkpoints/TB/ema_epoch100.pt --out runs/tb_imported
    python -m superdiff_torch.cli.sample --run-dir runs/tb_imported

Prefer the EMA file: the reference samples from the EMA weights.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert a reference ddpm_epochN.pt/ema_epochN.pt "
                    "into a sampleable run dir")
    p.add_argument("--checkpoint", required=True,
                   help=".pt state_dict from the reference trainer "
                        "(use the ema_epochN.pt: that is what it samples)")
    p.add_argument("--out", required=True, help="output artifact dir")
    p.add_argument("--resolution", type=int, default=256,
                   help="training resolution of the checkpoint "
                        "(reference default 256)")
    p.add_argument("--num-timesteps", type=int, default=1000)
    p.add_argument("--beta-start", type=float, default=1e-4)
    p.add_argument("--beta-end", type=float, default=0.02)
    p.add_argument("--normalization", default="tanh",
                   choices=["minmax", "zscore", "tanh", "none"],
                   help="pixel normalization the run trained under")
    p.add_argument("--task", default="TB", help="TB|PNEUMONIA (metadata)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from superdiff_torch.compat.torch_import import import_checkpoint

    arch = import_checkpoint(
        args.checkpoint, args.out, resolution=args.resolution,
        num_timesteps=args.num_timesteps, beta_start=args.beta_start,
        beta_end=args.beta_end, normalization=args.normalization,
        task=args.task)
    print(f"imported {args.checkpoint} -> {args.out} "
          f"(RefUNet base_channels={arch['base_channels']}, "
          f"{args.resolution}², T={args.num_timesteps}); sample with: "
          f"python -m superdiff_torch.cli.sample --run-dir {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
