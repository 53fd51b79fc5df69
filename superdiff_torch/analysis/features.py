"""Feature extraction for FID (and, later, projections and Grad-CAM).

Port of ``superdiff_tpu/analysis/features.py``. ``FeatureExtractor`` is one
``extract(images_nhwc) -> (B, D) float32`` facade over these backends:

- ``"classifier"``: a trained :class:`SmallCNN` (``save_classifier``
  ``.npz``, the JAX package's format), features the GAP of its last conv
  map;
- ``"random"``: a :class:`SmallCNN` of ``feature_dim`` classes with
  Flax-default initial weights drawn from torch's generator (``seed``), so
  its features are not those of the JAX package's ``random`` backend;
- ``"diffusion"``: a trained diffusion UNet's bottleneck (the output of
  ``mid_attn``, else ``mid_block_1`` / ``mid_block_0``) at a fixed
  timestep, on the input noised with a seeded torch draw;
- ``"resnet18"`` / ``"densenet121"``: locally saved torchvision-format
  checkpoints (``analysis/resnet.py``, ``analysis/densenet.py``);
- ``"hf"``: a local HuggingFace vision checkpoint directory
  (``transformers``, imported when used);
- ``"torch"``: any callable ``numpy (B, H, W, 1) -> (B, D)``.

Every SmallCNN stage is a stride-2 SAME conv, then GroupNorm (``num_groups_for(
width, 8)`` groups, Flax's eps 1e-6) -> SiLU as one call of
``ops.fused_norm.fused_groupnorm_silu``: kernel B4 in float32 on the card
(5 launches per call of the trained extractor, 3 of the ``random`` one),
the plain chain on the CPU. Backends run on ``device`` (default ``cuda``;
``hf`` and ``torch`` on the host).
"""

from __future__ import annotations

import json
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from superdiff_torch.models.layers import (
    GroupNorm, conv_nhwc, init_flax_defaults, num_groups_for)

BOTTLENECK_NAMES = ("mid_attn", "mid_block_1", "mid_block_0", "mid")


class SmallCNN(nn.Module):
    """Compact classifier: conv pyramid -> GAP -> logits, with the Flax
    module's parameter names (``conv_{i}``, ``norm_{i}``, ``head``)."""

    def __init__(self, num_classes: int = 2,
                 widths: Sequence[int] = (32, 64, 128),
                 in_channels: int = 1, device="cuda"):
        super().__init__()
        self.num_classes, self.widths = num_classes, tuple(widths)
        cin = in_channels
        for i, w in enumerate(self.widths):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, w, 3, device=device))
            self.add_module(f"norm_{i}", GroupNorm(num_groups_for(w, 8), w,
                                                   eps=1e-6, device=device))
            cin = w
        self.head = nn.Linear(cin, num_classes, device=device)

    def init_parameters(self, seed: int = 0) -> "SmallCNN":
        """Flax's default initialisation (LeCun-normal kernels, zero biases,
        unit norm scales), drawn from ``seed`` on the CPU."""
        return init_flax_defaults(self, seed)

    def forward(self, x: torch.Tensor, *, return_features: bool = False):
        """``x (B, H, W, C)`` -> logits ``(B, num_classes)``; with
        ``return_features`` also the last conv map ``(B, h, w, C')``."""
        from superdiff_torch.ops.fused_norm import fused_groupnorm_silu

        h = x.float()
        for i in range(len(self.widths)):
            h = conv_nhwc(getattr(self, f"conv_{i}"), h, torch.float32,
                          stride=2)
            norm = getattr(self, f"norm_{i}")
            h = fused_groupnorm_silu(h.contiguous(), norm.weight, norm.bias,
                                     norm.num_groups, eps=norm.eps)
        logits = self.head(h.mean(dim=(1, 2)))
        if return_features:
            return logits, h
        return logits


def smallcnn_from_flax(params, widths: Sequence[int], num_classes: int,
                       device="cuda") -> SmallCNN:
    """A JAX ``SmallCNN`` parameter tree (numpy leaves, with or without the
    top ``params`` level) as the port's module: conv kernels HWIO -> OIHW,
    Dense kernels transposed, GroupNorm ``scale`` -> ``weight``
    (``compat/flax_params.py``)."""
    from superdiff_torch.compat.flax_params import (_strip_params,
                                                    load_state_dict)

    in_channels = int(np.shape(_strip_params(params)["conv_0"]["kernel"])[2])
    model = SmallCNN(num_classes, widths, in_channels, device="cpu")
    load_state_dict(model, params)
    return model.to(device).eval()


def _as_nhwc(images, device) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(images, dtype=np.float32)).to(device)


def find_bottleneck(model: nn.Module) -> nn.Module:
    """The submodule whose output is the probe's features, in
    ``_find_bottleneck``'s order of names."""
    for name in BOTTLENECK_NAMES:
        m = getattr(model, name, None)
        if isinstance(m, nn.Module):
            return m
    raise KeyError(f"no bottleneck ({', '.join(BOTTLENECK_NAMES)}) in "
                   f"{type(model).__name__}")


def diffusion_features(model: nn.Module, schedule, x: torch.Tensor,
                       timestep: int,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bottleneck's output of ``model`` on ``x`` noised to
    ``timestep`` (``noise`` default: ``torch.randn`` from a generator seeded
    with 0 on ``x``'s device, the same draw for every batch), averaged over
    positions -> ``(B, C)`` float32. The whole model runs (the output
    discarded), with the null label when it is class-conditional."""
    from superdiff_torch.diffusion.process import q_sample

    B = x.shape[0]
    t = torch.full((B,), timestep, dtype=torch.long, device=x.device)
    if noise is None:
        g = torch.Generator(device=x.device).manual_seed(0)
        noise = torch.randn(x.shape, generator=g, device=x.device)
    xt = q_sample(schedule, x, t, noise.to(x.device, x.dtype))
    args = (xt, t)
    if getattr(model, "num_classes", 0) > 0:
        args += (torch.full((B,), model.null_label, dtype=torch.long,
                            device=x.device),)
    captured = []
    hook = find_bottleneck(model).register_forward_hook(
        lambda mod, inp, out: captured.append(out))
    try:
        with torch.no_grad():
            model(*args)
    finally:
        hook.remove()
    return captured[0].float().mean(dim=(1, 2))


class FeatureExtractor:
    """Uniform ``extract(images) -> (B, D)`` facade over the backends.

    ``classifier``: ``model=`` a :class:`SmallCNN` (with ``params=`` a Flax
    tree to load into it) or ``checkpoint=`` a ``save_classifier`` archive.
    ``diffusion``: ``model=`` a UNet with its weights and ``schedule=``.
    ``resnet18`` / ``densenet121``: ``checkpoint=`` or converted
    ``params=``. ``random``: ``seed`` and ``feature_dim``."""

    def __init__(self, kind: str = "random",
                 params=None, model=None,
                 schedule=None, timestep: int = 100,
                 seed: int = 0, feature_dim: int = 256,
                 checkpoint: Optional[str] = None, device="cuda"):
        self.kind = kind
        self.device = torch.device(device)
        if (kind not in ("hf", "torch") and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available (pass device='cpu' explicitly)")
        if kind in ("resnet18", "densenet121"):
            if kind == "resnet18":
                from superdiff_torch.analysis.resnet import (
                    load_torch_resnet18 as load_ckpt)
            else:
                from superdiff_torch.analysis.densenet import (
                    load_torch_densenet121 as load_ckpt)
            if params is None:
                if checkpoint is None:
                    raise ValueError(
                        f"{kind} backend needs checkpoint= (path to a "
                        "torchvision-style state_dict) or params= "
                        "(converted)")
                params = load_ckpt(checkpoint)
            self._params = _params_to(params, self.device)
        elif kind == "random":
            self._model = SmallCNN(num_classes=feature_dim, device="cpu")
            self._model.init_parameters(seed)
            self._model = self._model.to(self.device).eval()
        elif kind == "classifier":
            if model is None and checkpoint is not None:
                model = load_classifier(checkpoint, device=self.device)
            if model is None:
                raise ValueError(
                    "classifier backend needs model= (a SmallCNN) or "
                    "checkpoint= (an .npz saved by save_classifier)")
            if params is not None:
                from superdiff_torch.compat.flax_params import (
                    load_state_dict)
                load_state_dict(model, params)
            self._model = model.to(self.device).eval()
        elif kind == "diffusion":
            if model is None or schedule is None:
                raise ValueError(
                    "diffusion backend needs model= (with its weights) and "
                    "schedule=")
            self._model, self._schedule, self._t = model, schedule, timestep
        elif kind == "torch":
            if model is None:
                raise ValueError("torch backend needs a callable model")
            self._host_fn = model
        elif kind == "hf":
            if checkpoint is None:
                raise ValueError(
                    "hf backend needs checkpoint= (a local directory saved "
                    "with save_pretrained())")
            self._host_fn = _make_hf_vision_fn(checkpoint)
        else:
            raise ValueError(f"unknown extractor kind {kind!r}")

    @torch.no_grad()
    def extract(self, images, noise=None) -> np.ndarray:
        """``(B, H, W, C)`` images (numpy or torch) -> ``(B, D)`` float32
        numpy features. ``noise`` (``diffusion`` only) replaces the probe's
        seeded draw."""
        if self.kind in ("torch", "hf"):
            return np.asarray(self._host_fn(np.asarray(
                images.cpu() if isinstance(images, torch.Tensor)
                else images)))
        x = _as_nhwc(images, self.device)
        if self.kind == "resnet18":
            from superdiff_torch.analysis.resnet import resnet18_features
            out = resnet18_features(self._params, x)
        elif self.kind == "densenet121":
            from superdiff_torch.analysis.densenet import (
                densenet121_features)
            out = densenet121_features(self._params, x)
        elif self.kind in ("random", "classifier"):
            _, feats = self._model(x, return_features=True)
            out = feats.mean(dim=(1, 2))
        else:
            out = diffusion_features(self._model, self._schedule, x,
                                     self._t, noise)
        return out.float().cpu().numpy()


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device) for v in tree]
    return tree.to(device)


def save_classifier(path: str, model: SmallCNN,
                    meta: Optional[dict] = None) -> None:
    """Persist a ``SmallCNN`` as the JAX package's flat ``.npz``: one array
    per Flax parameter leaf under ``params/...`` keys, plus a ``__meta__``
    JSON string with ``widths``, ``num_classes`` and the caller's
    ``meta``."""
    from superdiff_torch.compat.flax_params import _flatten, to_flax

    flat = _flatten({"params": to_flax(model)})
    arrays = {"/".join(k): np.asarray(v) for k, v in flat.items()}
    info = {"widths": list(model.widths),
            "num_classes": int(model.num_classes)}
    info.update(meta or {})
    arrays["__meta__"] = np.frombuffer(json.dumps(info).encode(),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def load_classifier(path: str, device="cuda") -> SmallCNN:
    """Load a ``save_classifier`` archive (either package's) -> a
    ``SmallCNN`` on ``device`` in eval mode; its ``meta`` attribute holds
    the archive's ``__meta__``."""
    from superdiff_torch.compat.flax_params import _unflatten

    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    info = json.loads(bytes(arrays.pop("__meta__").tobytes()).decode())
    tree = _unflatten({tuple(k.split("/")): v for k, v in arrays.items()})
    model = smallcnn_from_flax(tree, tuple(info["widths"]),
                               int(info["num_classes"]), device=device)
    model.meta = info
    return model


def _make_hf_vision_fn(checkpoint_dir: str):
    """Local HF vision model -> ``(B, H, W, 1) numpy -> (B, D)`` callable
    (``superdiff_tpu/analysis/features.py::_make_hf_vision_fn``): gray
    replicated to the model's channels, resized to its input size, min-max
    rescaled and standardized with the saved processor's statistics when
    there is one, pooled output (else the tokens' mean)."""
    from transformers import AutoModel

    model = AutoModel.from_pretrained(checkpoint_dir,
                                      local_files_only=True).eval()
    size = getattr(model.config, "image_size", 224)
    channels = getattr(model.config, "num_channels", 3)

    mean = std = None
    try:
        from transformers import AutoImageProcessor

        proc = AutoImageProcessor.from_pretrained(checkpoint_dir,
                                                  local_files_only=True)
        if getattr(proc, "image_mean", None) is not None:
            mean = torch.tensor(proc.image_mean,
                                dtype=torch.float32).view(1, -1, 1, 1)
            std = torch.tensor(proc.image_std,
                               dtype=torch.float32).view(1, -1, 1, 1)
        psize = getattr(proc, "size", None)
        if isinstance(psize, dict):
            size = (psize.get("height") or psize.get("shortest_edge")
                    or size)
    except (OSError, ValueError):   # no or unreadable processor config
        pass

    @torch.no_grad()
    def fn(images_nhwc: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(
            np.asarray(images_nhwc, dtype=np.float32).transpose(0, 3, 1, 2))
        if x.shape[1] == 1 and channels != 1:
            x = x.repeat(1, channels, 1, 1)
        if x.shape[-1] != size:
            x = torch.nn.functional.interpolate(
                x, size=(size, size), mode="bilinear", align_corners=False)
        if mean is not None:
            lo = x.amin(dim=(1, 2, 3), keepdim=True)
            hi = x.amax(dim=(1, 2, 3), keepdim=True)
            x = (x - lo) / torch.clamp(hi - lo, min=1e-8)
            m = mean if mean.shape[1] == x.shape[1] else mean.mean(
                dim=1, keepdim=True)
            s = std if std.shape[1] == x.shape[1] else std.mean(
                dim=1, keepdim=True)
            x = (x - m) / s
        out = model(pixel_values=x)
        pooled = getattr(out, "pooler_output", None)
        if pooled is None:
            pooled = out.last_hidden_state.mean(dim=1)
        return pooled.numpy()

    return fn


def extract_features(extractor: FeatureExtractor,
                     batches: Iterable,
                     max_samples: int = 300
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched extraction with a sample cap. ``batches`` yields dicts with
    ``image`` (and optionally ``label``) or bare image arrays; returns
    ``(features, labels)`` as numpy."""
    feats, labels = [], []
    n = 0
    for batch in batches:
        img = batch["image"] if isinstance(batch, dict) else batch
        feats.append(extractor.extract(img))
        if isinstance(batch, dict) and "label" in batch:
            lab = batch["label"]
            labels.append(np.asarray(lab.cpu() if isinstance(
                lab, torch.Tensor) else lab))
        else:
            labels.append(np.zeros(len(img), dtype=np.int32))
        n += len(img)
        if n >= max_samples:
            break
    f = np.concatenate(feats)[:max_samples]
    lab = np.concatenate(labels)[:max_samples]
    return f, lab

