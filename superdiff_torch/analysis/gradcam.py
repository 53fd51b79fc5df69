"""Grad-CAM through autograd, on the SmallCNN or a pretrained backbone.

Port of ``superdiff_tpu/analysis/gradcam.py``. The classifier is split into
a feature map and a head; the feature map runs under ``torch.no_grad()``
(for the SmallCNN on a CUDA tensor that is kernel B4, one launch per stage),
is detached and made a leaf, and the gradient of the chosen logit with
respect to it is one ``torch.autograd.grad`` through the head alone. CAM =
ReLU(sum_c mean(dA_c) * A_c) / max(max, 1e-8), as the JAX package computes
it.

Targets: the port's :class:`~superdiff_torch.analysis.features.SmallCNN`
(which carries its weights, so no parameter tree is passed), or a
``resnet18`` (``layer4``) / ``densenet121`` (``relu(norm5)``) from a local
torchvision-format checkpoint that keeps its classifier head. Panels
(input beside overlay) are drawn by ``utils/raster.py``; the class name
goes into the PNG's text. Everything runs on ``device`` (default
``cuda``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from superdiff_torch.analysis.features import SmallCNN, _params_to


def compute_gradcam_from_fns(fmap_fn: Callable, head_fn: Callable, image,
                             class_idx: Optional[int] = None,
                             device="cuda") -> Tuple[np.ndarray, int]:
    """Generic Grad-CAM: ``fmap_fn(x (1, H, W, C)) -> (1, h, w, C')``,
    ``head_fn(fmap) -> (1, n_classes)``. ``image`` ``(H, W, C)``, numpy or
    torch. Returns ``(heatmap in [0, 1] (h, w), predicted or requested
    class)``."""
    x = torch.as_tensor(np.asarray(image.cpu() if isinstance(
        image, torch.Tensor) else image, dtype=np.float32))[None].to(device)
    with torch.no_grad():
        feats = fmap_fn(x)
    feats = feats.detach().requires_grad_()
    with torch.enable_grad():
        logits = head_fn(feats)
        pred = int(logits[0].argmax()) if class_idx is None else class_idx
        (grads,) = torch.autograd.grad(logits[0, pred], feats)
    weights = grads[0].mean(dim=(0, 1))                    # (C',)
    cam = torch.clamp((weights * feats.detach()[0]).sum(dim=-1), min=0.0)
    cam = cam / torch.clamp(cam.max(), min=1e-8)
    return cam.cpu().numpy(), pred


def make_backbone_cam_fns(backbone: str, checkpoint: str, device="cuda"
                          ) -> Tuple[Callable, Callable]:
    """``(fmap_fn, head_fn)`` for a pretrained backbone from a local
    torchvision-format checkpoint, which must include its classifier head:
    ``resnet18`` at ``layer4``, ``densenet121`` at ``relu(norm5)``."""
    if backbone == "resnet18":
        from superdiff_torch.analysis.resnet import (
            load_torch_resnet18, resnet18_feature_map, resnet18_logits)

        params = load_torch_resnet18(checkpoint)
        if "fc" not in params:
            raise KeyError(f"{checkpoint} has no fc head — Grad-CAM needs "
                           "the classifier logits")
        params = _params_to(params, torch.device(device))
        return (lambda x: resnet18_feature_map(params, x),
                lambda f: resnet18_logits(params, f))
    if backbone == "densenet121":
        from superdiff_torch.analysis.densenet import (
            densenet121_feature_map, densenet121_logits,
            load_torch_densenet121)

        params = load_torch_densenet121(checkpoint)
        if "classifier" not in params:
            raise KeyError(f"{checkpoint} has no classifier head — "
                           "Grad-CAM needs the logits")
        params = _params_to(params, torch.device(device))
        return (lambda x: densenet121_feature_map(params, x),
                lambda f: densenet121_logits(params, f))
    raise ValueError(f"unknown Grad-CAM backbone {backbone!r} "
                     "(have resnet18, densenet121)")


def compute_gradcam(model: SmallCNN, image,
                    class_idx: Optional[int] = None
                    ) -> Tuple[np.ndarray, int]:
    """CAM for one image ``(H, W, C)`` under the SmallCNN, on the model's
    device: the last conv map (through B4 on a CUDA tensor), then the
    head on its global average pool."""
    device = next(model.parameters()).device
    return compute_gradcam_from_fns(
        lambda x: model(x, return_features=True)[1],
        lambda f: model.head(f.mean(dim=(1, 2))),
        image, class_idx, device=device)


def overlay_heatmap(image, cam, alpha: float = 0.45) -> np.ndarray:
    """The CAM resized bilinearly to the image (``F.interpolate``,
    ``align_corners=False``: what ``jax.image.resize(..., "bilinear")``
    gives when upsampling), through matplotlib's ``jet`` and blended over
    the min-max scaled image. Returns RGB float64 in [0, 1]."""
    from superdiff_torch.utils.raster import jet

    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    lo, hi = image.min(), image.max()
    gray = (image - lo) / max(hi - lo, 1e-6)
    cam_img = F.interpolate(
        torch.as_tensor(np.asarray(cam, dtype=np.float32))[None, None],
        size=image.shape[:2], mode="bilinear", align_corners=False)[0, 0]
    heat = jet(cam_img.numpy())
    base = np.stack([gray] * 3, axis=-1)
    return np.clip((1 - alpha) * base + alpha * heat, 0.0, 1.0)


def _save_cam_panels(cam_fn, images, out_dir: str, max_images: int,
                     class_names) -> list:
    from superdiff_torch.utils import raster
    from superdiff_torch.utils.visualization import _gray_u8

    os.makedirs(out_dir, exist_ok=True)
    images = images.cpu().numpy() if isinstance(images, torch.Tensor) \
        else np.asarray(images)
    paths = []
    for i, img in enumerate(images[:max_images]):
        cam, pred = cam_fn(img)
        name = (class_names[pred] if class_names and pred < len(class_names)
                else f"class {pred}")
        panel = raster.tile_rows([[_gray_u8(img), overlay_heatmap(img, cam)]],
                                 gap=4)
        paths.append(raster.write_png(
            os.path.join(out_dir, f"gradcam_{i}.png"), panel,
            {"Title": f"input | Grad-CAM ({name})"}))
    return paths


def run_gradcam(model: SmallCNN, images, out_dir: str,
                max_images: int = 8, class_names=None) -> list:
    """CAM panels (``gradcam_{i}.png``: input beside overlay) for a batch
    under the SmallCNN."""
    return _save_cam_panels(lambda img: compute_gradcam(model, img),
                            images, out_dir, max_images, class_names)


def run_gradcam_backbone(backbone: str, checkpoint: str, images,
                         out_dir: str, max_images: int = 8,
                         class_names=None, device="cuda") -> list:
    """CAM panels under a pretrained backbone (local checkpoint)."""
    fmap_fn, head_fn = make_backbone_cam_fns(backbone, checkpoint, device)
    return _save_cam_panels(
        lambda img: compute_gradcam_from_fns(fmap_fn, head_fn, img,
                                             device=device),
        images, out_dir, max_images, class_names)
