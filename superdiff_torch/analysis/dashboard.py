"""Dashboard: an image grid browser, an embedding explorer and the run's
explainability artifacts.

Port of ``superdiff_tpu/analysis/dashboard.py``. Two renderers:

- :func:`build_static_dashboard` writes the three sections as ONE
  self-contained HTML file, its t-SNE PNG and thumbnails inlined as base64
  data URIs; it needs no server and no optional package;
- :func:`launch_dashboard` / :func:`render_app` are the interactive
  streamlit app, gated on streamlit (an optional package; ``ImportError``
  without it).
"""

from __future__ import annotations

import base64
import glob
import html
import os
import subprocess
import sys

import torch


def launch_dashboard(dataset_root: str, run_dir: str = "") -> None:
    """Run :func:`render_app` under ``streamlit run``."""
    try:
        import streamlit  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "streamlit is not installed in this environment; install it to "
            "use the dashboard, or use superdiff_torch.cli.inspect_data / "
            "cli.visualize for static artifacts") from e
    env = dict(os.environ, SUPERDIFF_DASHBOARD_ROOT=dataset_root,
               SUPERDIFF_DASHBOARD_RUN=run_dir)
    subprocess.run([sys.executable, "-m", "streamlit", "run", __file__],
                   env=env, check=True)


def _png_data_uri(path: str) -> str:
    with open(path, "rb") as f:
        return ("data:image/png;base64,"
                + base64.b64encode(f.read()).decode("ascii"))


def build_static_dashboard(dataset_root: str,
                           out_html: str,
                           run_dir: str = "",
                           task: str = "PNEUMONIA",
                           num_images: int = 16,
                           max_embed_samples: int = 96,
                           histogram_equalization: bool = False,
                           device="cuda") -> str:
    """Render the dashboard's three sections into one standalone HTML: the
    first train batch's images (CLAHE as configured), a t-SNE of
    ``random``-extractor features of up to ``max_embed_samples`` train
    images (on ``device``), and every PNG in ``run_dir``."""
    from superdiff_torch.analysis.features import (FeatureExtractor,
                                                   extract_features)
    from superdiff_torch.analysis.plotly3d import thumbnail_data_uri
    from superdiff_torch.analysis.projection import run_projection
    from superdiff_torch.config import Config
    from superdiff_torch.data.datamodule import DataModule

    cfg = Config()
    cfg.task = task
    cfg.training.histogram_equalization = histogram_equalization
    cfg.training.batch_size = min(num_images, 32)
    dm = DataModule(cfg, dataset_root)
    idx = dm.index("train")
    batch = next(iter(dm.iterator("train", epoch=0)))
    imgs, labels = batch["image"], batch["label"]

    parts = ["<html><head><meta charset='utf-8'>"
             "<title>superdiff_torch dashboard</title>"
             "<style>body{font-family:sans-serif;margin:2em;}"
             "img.t{margin:2px;border:1px solid #888;}"
             "h2{border-bottom:1px solid #ccc;}</style></head><body>",
             f"<h1>superdiff_torch explorer — {html.escape(task)}</h1>",
             f"<p>dataset: {html.escape(os.path.abspath(dataset_root))}"
             f" · classes: {', '.join(map(html.escape, idx.classes))}"
             f" · CLAHE: {'on' if histogram_equalization else 'off'}</p>"]

    parts.append("<h2>Image grid</h2>")
    for i in range(min(num_images, len(imgs))):
        name = idx.classes[int(labels[i])]
        parts.append(
            f"<img class='t' title='{html.escape(name)}' "
            f"src='{thumbnail_data_uri(imgs[i], 96)}'>")

    parts.append("<h2>Embedding explorer (t-SNE, random-CNN features)</h2>")
    ex = FeatureExtractor("random", device=device)
    g = torch.Generator(device=device).manual_seed(0)
    feats, flabels = extract_features(
        ex, dm.device_batches("train", g, device=device),
        max_samples=max_embed_samples)
    tsne_png = out_html + ".tsne.png"
    run_projection(feats, flabels, "tsne", tsne_png,
                   class_names=idx.classes, device=device)
    parts.append(f"<img src='{_png_data_uri(tsne_png)}' width='480'>")
    os.remove(tsne_png)

    parts.append("<h2>Explainability / run artifacts</h2>")
    pngs = sorted(glob.glob(os.path.join(run_dir, "*.png"))) if run_dir \
        else []
    if pngs:
        for p in pngs:
            parts.append(f"<h3>{html.escape(os.path.basename(p))}</h3>"
                         f"<img src='{_png_data_uri(p)}' width='640'>")
    else:
        parts.append("<p>No run artifacts found; run "
                     "<code>python -m superdiff_torch.cli.inspect_data "
                     "--set viz.gradcam=true</code> for Grad-CAM "
                     "overlays.</p>")
    parts.append("</body></html>")

    os.makedirs(os.path.dirname(out_html) or ".", exist_ok=True)
    with open(out_html, "w") as f:
        f.write("\n".join(parts))
    return out_html


def render_app() -> None:  # pragma: no cover - needs the streamlit runtime
    """The streamlit app's body: the image grid (CLAHE toggle), an
    embedding explorer over an uploaded ``.npy`` of features, and a pointer
    to the Grad-CAM artifacts."""
    import numpy as np
    import streamlit as st

    from superdiff_torch.analysis.projection import run_projection
    from superdiff_torch.config import Config
    from superdiff_torch.data.datamodule import DataModule

    st.title("superdiff_torch explorer")
    root = os.environ.get("SUPERDIFF_DASHBOARD_ROOT", "data")
    cfg = Config()
    st.header("Image grid")
    n = st.slider("images", 4, 32, 8)
    cfg.training.histogram_equalization = st.checkbox("CLAHE")
    dm = DataModule(cfg, root)
    batch = next(iter(dm.iterator("train", batch_size=n, epoch=0)))
    st.image([batch["image"][i, :, :, 0] for i in range(n)], width=96)

    st.header("Embedding explorer")
    up = st.file_uploader("features .npy")
    if up is not None:
        feats = np.load(up)
        out = os.path.join(os.environ.get("SUPERDIFF_DASHBOARD_RUN") or ".",
                           "dashboard_tsne.png")
        st.image(run_projection(feats, np.zeros(len(feats), np.int64),
                                "tsne", out))

    st.header("Explainability")
    st.write("Run `python -m superdiff_torch.cli.inspect_data "
             "--set viz.gradcam=true` for Grad-CAM overlays.")


if __name__ == "__main__":  # pragma: no cover
    render_app()
