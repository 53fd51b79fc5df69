"""One-shot train/val/test splitter with idempotency.

Port of ``superdiff_tpu/data/split.py``: ``source/CLASS/*`` ->
``dest/{train,val,test}/CLASS/*`` with the same seeded shuffle
(``random.Random(seed)``, one shuffle per class in sorted class order),
70/15/15 by default, symlinks by default (``link=False`` copies), and a
no-op when the destination is already split (unless ``force``).

Usage:
    python -m superdiff_torch.data.split SOURCE DEST [--ratios 0.7 0.15 0.15]
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Dict, Sequence

SPLITS = ("train", "val", "test")


def is_split_already_done(dest_dir: str) -> bool:
    """True when every split dir exists and is non-empty."""
    for split in SPLITS:
        sdir = os.path.join(dest_dir, split)
        if not os.path.isdir(sdir):
            return False
        if not any(files for _, _, files in os.walk(sdir)):
            return False
    return True


def split_dataset(source_dir: str,
                  dest_dir: str,
                  ratios: Sequence[float] = (0.7, 0.15, 0.15),
                  seed: int = 42,
                  link: bool = True,
                  force: bool = False) -> Dict[str, int]:
    """Split ``source/CLASS/*`` into ``dest/{train,val,test}/CLASS/*``.

    Returns per-split file counts. Raises if ratios don't sum to 1."""
    if abs(sum(ratios) - 1.0) > 1e-6:
        raise ValueError(f"split ratios must sum to 1, got {ratios}")
    if len(ratios) != 3:
        raise ValueError("need exactly (train, val, test) ratios")
    if not os.path.isdir(source_dir):
        raise FileNotFoundError(source_dir)
    if is_split_already_done(dest_dir) and not force:
        return {s: sum(len(files) for _, _, files in
                       os.walk(os.path.join(dest_dir, s)))
                for s in SPLITS}

    rng = random.Random(seed)
    counts = {s: 0 for s in SPLITS}
    classes = sorted(d for d in os.listdir(source_dir)
                     if os.path.isdir(os.path.join(source_dir, d)))
    if not classes:
        raise FileNotFoundError(f"no class dirs in {source_dir}")
    for cls in classes:
        files = sorted(os.listdir(os.path.join(source_dir, cls)))
        rng.shuffle(files)
        n = len(files)
        n_train = int(n * ratios[0])
        n_val = int(n * ratios[1])
        buckets = {
            "train": files[:n_train],
            "val": files[n_train:n_train + n_val],
            "test": files[n_train + n_val:],
        }
        for split, names in buckets.items():
            outdir = os.path.join(dest_dir, split, cls)
            os.makedirs(outdir, exist_ok=True)
            for name in names:
                src = os.path.abspath(os.path.join(source_dir, cls, name))
                dst = os.path.join(outdir, name)
                if os.path.lexists(dst):
                    os.remove(dst)
                if link:
                    os.symlink(src, dst)
                else:
                    shutil.copy2(src, dst)
                counts[split] += 1
    return counts


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source")
    p.add_argument("dest")
    p.add_argument("--ratios", type=float, nargs=3,
                   default=(0.7, 0.15, 0.15))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--copy", action="store_true",
                   help="copy files instead of symlinking")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    counts = split_dataset(args.source, args.dest, tuple(args.ratios),
                           seed=args.seed, link=not args.copy,
                           force=args.force)
    print(counts)


if __name__ == "__main__":
    main()
