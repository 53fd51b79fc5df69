"""Data-inspection CLI of the port (counterpart of
``superdiff_tpu.cli.inspect_data``).

Config-toggle-driven runner over a dataset, each output behind a ``viz.*``
flag (``--set viz.tsne=true``): class counts, the batch grid, the pixel
histogram, augmentation rows, ``random``-extractor features projected by
t-SNE / UMAP (2D, thumbnails, 3D, plotly HTML when plotly is installed),
and Grad-CAM through a SmallCNN trained here (150 steps) or a pretrained
backbone (``--gradcam-backbone resnet18|densenet121 --gradcam-checkpoint``).
The JAX CLI's flags and file names, plus ``--device`` (default ``cuda``;
raises when no card is there). The ``random`` extractor's weights,
``augment``'s draws and the data order come from torch generators, so they
differ from the JAX package's by design.

Usage:
    python -m superdiff_torch.cli.inspect_data --dataset-root data/xray \
        --set viz.show_class_counts=true --set viz.tsne=true
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Inspect a chest X-ray dataset")
    p.add_argument("--config", default=None)
    p.add_argument("--dataset-root", required=True)
    p.add_argument("--task", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--out", default="inspect_out")
    p.add_argument("--max-samples", type=int, default=120)
    p.add_argument("--gradcam-backbone", default=None,
                   choices=["resnet18", "densenet121"],
                   help="CAM a pretrained backbone (resnet18 layer4, "
                        "densenet121 relu(norm5)) instead of a SmallCNN "
                        "trained here; needs --gradcam-checkpoint")
    p.add_argument("--gradcam-checkpoint", default=None,
                   help="local torchvision-format state-dict (.pt/.npz) "
                        "WITH its classifier head")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from superdiff_torch.analysis import (
        FeatureExtractor, compare_tsne_umap_thumbnails, extract_features,
        run_gradcam, run_projection, run_projection_3d,
        run_projection_with_thumbnails)
    from superdiff_torch.analysis.classifier import train_classifier
    from superdiff_torch.config import load_config
    from superdiff_torch.data.datamodule import DataModule
    from superdiff_torch.data.transforms import augment
    from superdiff_torch.utils.logger import init_logger
    from superdiff_torch.utils.visualization import (save_image_grid,
                                                     save_pixel_histogram)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass --device cpu explicitly)")
    cfg = load_config(args.config, args.overrides)
    if args.task:
        cfg.task = args.task
    logger = init_logger(None, stdout=True, level=logging.INFO)
    os.makedirs(args.out, exist_ok=True)

    dm = DataModule(cfg, args.dataset_root)
    idx = dm.index(args.split)
    logger.info("dataset: %d images, classes %s", len(idx), idx.classes)

    if cfg.viz.show_class_counts:
        print("class counts:", dm.class_counts(args.split))

    # collect a working set
    batches = []
    n = 0
    g = torch.Generator(device=device).manual_seed(0)
    for b in dm.device_batches(args.split, g, device=device):
        batches.append({"image": b["image"].cpu().numpy(),
                        "label": b["label"].cpu().numpy()})
        n += len(b["label"])
        if n >= args.max_samples:
            break
    images = np.concatenate([b["image"] for b in batches])
    labels = np.concatenate([b["label"] for b in batches])

    if cfg.viz.show_batch or cfg.viz.image_grid:
        save_image_grid(images[:16], os.path.join(args.out, "batch.png"),
                        titles=[idx.classes[l] for l in labels[:16]])
        print("wrote batch.png")

    if cfg.viz.histograms:
        save_pixel_histogram(images, os.path.join(args.out, "hist.png"))
        print("wrote hist.png")

    if cfg.viz.show_augmented:
        base = torch.as_tensor(images[:4], device=device) * 0.5 + 0.5
        risk = (cfg.training.augmentation
                if cfg.training.augmentation != "none" else "low")
        rows = [base] + [
            augment(base, torch.Generator(device=device).manual_seed(10 + i),
                    risk=risk) for i in range(3)]
        save_image_grid(torch.cat(rows).cpu().numpy(),
                        os.path.join(args.out, "augmented.png"), ncols=4,
                        suptitle="rows: original + 3 augmentation draws")
        print("wrote augmented.png")

    needs_features = (cfg.viz.tsne or cfg.viz.tsne_thumbnails
                      or cfg.viz.tsne_umap_thumbnails
                      or cfg.viz.projection_3d
                      or cfg.viz.projection_3d_thumbnails
                      or cfg.viz.projection_3d_plotly)
    if needs_features:
        ex = FeatureExtractor("random", device=device)
        feats, flabels = extract_features(ex, batches,
                                          max_samples=args.max_samples)
        shown = images[:len(feats)]
        if cfg.viz.tsne:
            run_projection(feats, flabels, "tsne",
                           os.path.join(args.out, "tsne.png"),
                           class_names=idx.classes, device=device)
            print("wrote tsne.png")
        if cfg.viz.tsne_thumbnails:
            run_projection_with_thumbnails(
                feats, flabels, shown, "tsne",
                os.path.join(args.out, "tsne_thumbs.png"), device=device)
            print("wrote tsne_thumbs.png")
        if cfg.viz.tsne_umap_thumbnails:
            compare_tsne_umap_thumbnails(
                feats, flabels, shown,
                os.path.join(args.out, "tsne_vs_umap.png"), device=device)
            print("wrote tsne_vs_umap.png")
        if (cfg.viz.projection_3d or cfg.viz.projection_3d_thumbnails
                or cfg.viz.projection_3d_plotly):
            run_projection_3d(feats, flabels, "tsne",
                              os.path.join(args.out, "projection3d.png"),
                              class_names=idx.classes, device=device)
            print("wrote projection3d.png")
        if cfg.viz.projection_3d_plotly:
            from superdiff_torch.analysis import (
                run_plotly_projection_3d_with_thumbnails)
            try:
                run_plotly_projection_3d_with_thumbnails(
                    feats, flabels, shown,
                    os.path.join(args.out, "projection3d.html"),
                    class_names=idx.classes, device=device)
                print("wrote projection3d.html")
            except ImportError as e:
                print(f"skipped plotly HTML: {e}")

    if cfg.viz.gradcam:
        if args.gradcam_backbone:
            if not args.gradcam_checkpoint:
                print("--gradcam-backbone needs --gradcam-checkpoint",
                      file=sys.stderr)
                return 2
            from superdiff_torch.analysis.gradcam import run_gradcam_backbone

            paths = run_gradcam_backbone(
                args.gradcam_backbone, args.gradcam_checkpoint, images[:8],
                os.path.join(args.out, "gradcam"), device=device)
        else:
            model, metrics = train_classifier(batches, num_steps=150,
                                              device=device)
            print(f"classifier for CAM: acc={metrics['final_acc']:.2f}")
            paths = run_gradcam(model, images[:8],
                                os.path.join(args.out, "gradcam"),
                                class_names=idx.classes)
        print(f"wrote {len(paths)} gradcam overlays")

    return 0


if __name__ == "__main__":
    sys.exit(main())
