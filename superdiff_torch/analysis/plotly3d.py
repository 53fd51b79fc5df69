"""Interactive Plotly 3D projection with base64 thumbnail hovers.

Port of ``superdiff_tpu/analysis/plotly3d.py``: per-class ``Scatter3d``
traces whose hover text embeds each sample as a base64 PNG data URI,
exported as a standalone HTML file. The thumbnails need no PIL: the image
is scaled to uint8 as the JAX package scales it (min-max, truncated),
resized with PIL's default ``Image.resize`` filter, bicubic
(``data/image_io.py::resize_u8``, per channel for RGB), and encoded by the
port's own PNG writer. plotly stays an optional import that raises
``ImportError``.
"""

from __future__ import annotations

import base64
import os
from typing import Optional, Sequence

import numpy as np

from superdiff_torch.analysis.projection import _project
from superdiff_torch.utils.raster import CLASS_COLOR_NAMES

DEFAULT_CLASS_COLORS = CLASS_COLOR_NAMES


def thumbnail_data_uri(image, size: int = 64) -> str:
    """One grayscale or RGB image ((H, W), (H, W, 1) or (H, W, 3); any
    float range, min-max scaled and truncated to uint8, or uint8 as it is)
    resized to ``size``² as a PNG data URI."""
    from superdiff_torch.data.image_io import resize_u8
    from superdiff_torch.utils.visualization import png_bytes

    img = np.asarray(image.cpu() if hasattr(image, "cpu") else image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8:
        img = img.astype(np.float32)
        lo, hi = float(img.min()), float(img.max())
        img = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = resize_u8(img, (size, size), "bicubic")
    else:
        img = np.stack([resize_u8(img[..., c], (size, size), "bicubic")
                        for c in range(img.shape[-1])], axis=-1)
    b64 = base64.b64encode(png_bytes(img)).decode("ascii")
    return f"data:image/png;base64,{b64}"


def hover_html(label_name: str, image, size: int = 64) -> str:
    """Hover payload: the class name and the embedded thumbnail."""
    return f'{label_name}<br><img src="{thumbnail_data_uri(image, size)}">'


def run_plotly_projection_3d_with_thumbnails(
        features: np.ndarray,
        labels: np.ndarray,
        images: Optional[np.ndarray] = None,
        path: str = "projection3d.html",
        method: str = "tsne",
        class_names: Optional[Sequence[str]] = None,
        class_colors: Optional[Sequence[str]] = None,
        thumb_size: int = 64,
        title: Optional[str] = None,
        emb: Optional[np.ndarray] = None,
        device="cuda") -> str:
    """3D projection -> interactive HTML with thumbnail hovers
    (``images=None``: plain class-coloured markers). ``emb``: a
    precomputed ``(N, 3)`` projection. Raises ``ImportError`` naming
    plotly when it is not installed."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is not installed; install plotly for interactive 3D "
            "HTML export, or use run_projection_3d (PNG)") from e

    labels = np.asarray(labels)
    if emb is None:
        emb = _project(np.asarray(features), method, 3, device=device)
    colors = class_colors or DEFAULT_CLASS_COLORS
    fig = go.Figure()
    for cls in np.unique(labels):
        mask = labels == cls
        name = (class_names[cls] if class_names is not None
                and cls < len(class_names) else f"class {cls}")
        hover_kw = {}
        if images is not None:
            hover_kw = dict(hoverinfo="text",
                            hovertext=[hover_html(name, images[i], thumb_size)
                                       for i in np.where(mask)[0]])
        fig.add_trace(go.Scatter3d(
            x=emb[mask, 0], y=emb[mask, 1], z=emb[mask, 2],
            mode="markers", name=name,
            marker=dict(size=6, color=colors[int(cls) % len(colors)],
                        opacity=0.85),
            **hover_kw))
    fig.update_layout(
        scene=dict(xaxis_title="Component 1", yaxis_title="Component 2",
                   zaxis_title="Component 3"),
        margin=dict(l=0, r=0, b=0, t=40),
        title=title or f"3D {method.upper()} projection with thumbnails")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.write_html(path)
    return path
