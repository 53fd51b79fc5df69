"""Named model presets (the same table as ``superdiff_tpu/models/presets.py``).

The topology per preset is copied exactly so checkpoints move between the
two packages. ``"ref"`` is the reference's own graph
(:class:`~superdiff_torch.models.unet_ref.RefUNet`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from superdiff_torch.models.unet import CondUNet
from superdiff_torch.models.unet_ref import RefUNet

_PRESETS: Dict[str, Dict[str, Any]] = {
    "small64": dict(base_channels=64, channel_mults=(1, 2, 2, 4),
                    num_res_blocks=2, attn_resolutions=(16, 8),
                    num_heads=4),
    "base128": dict(base_channels=64, channel_mults=(1, 1, 2, 2, 4),
                    num_res_blocks=2, attn_resolutions=(16, 8),
                    num_heads=4),
    "base256": dict(base_channels=64, channel_mults=(1, 1, 2, 2, 4, 4),
                    num_res_blocks=2, attn_resolutions=(16,),
                    num_heads=4),
    "eff256": dict(base_channels=64, channel_mults=(1, 2, 2, 4, 4),
                   num_res_blocks=2, attn_resolutions=(16,),
                   num_heads=4, pixel_shuffle=2),
    "fast256": dict(base_channels=64, channel_mults=(1, 2, 4, 4),
                    num_res_blocks=2, attn_resolutions=(16,),
                    num_heads=4, pixel_shuffle=4),
    "attn256": dict(base_channels=64, channel_mults=(1, 2, 2, 4, 4),
                    num_res_blocks=2, attn_resolutions=(32, 16),
                    num_heads=4, pixel_shuffle=2),
    "fastattn256": dict(base_channels=64, channel_mults=(1, 2, 4, 4),
                        num_res_blocks=2, attn_resolutions=(32, 16),
                        up_attn_resolutions=(16,),
                        num_heads=4, pixel_shuffle=4),
    "attn256d": dict(base_channels=64, channel_mults=(1, 2, 2, 4, 4),
                     num_res_blocks=2, attn_resolutions=(32, 16),
                     up_attn_resolutions=(16,),
                     num_heads=4, pixel_shuffle=2),
    "attn256s": dict(base_channels=64, channel_mults=(1, 2, 2, 4, 4),
                     num_res_blocks=(1, 2, 2, 2, 2),
                     attn_resolutions=(32, 16),
                     up_attn_resolutions=(16,),
                     num_heads=4, pixel_shuffle=2),
    "slim256": dict(base_channels=64, channel_mults=(1, 2, 2, 4, 4),
                    num_res_blocks=(1, 1, 2, 2, 2),
                    attn_resolutions=(32, 16),
                    up_attn_resolutions=(16,),
                    num_heads=4, pixel_shuffle=2),
    # the 256² flagship: 38,624,004 parameters
    "wide256": dict(base_channels=128, channel_mults=(1, 1, 1, 2, 2),
                    num_res_blocks=(1, 2, 2, 2, 2),
                    attn_resolutions=(32, 16),
                    up_attn_resolutions=(16,),
                    num_heads=4, pixel_shuffle=2),
}

RESOLUTION_TO_PRESET = {64: "small64", 128: "base128", 256: "wide256"}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(preset: str = "small64",
                num_classes: int = 2,
                compute_dtype=torch.bfloat16,
                resolution: int = None,
                device="cuda",
                **overrides):
    """Build a CondUNet from a named preset (+ field overrides) for
    ``resolution``² inputs (default: the preset's working resolution).

    ``"ref"`` builds the RefUNet from its own graph fields only; the
    conditioning and dtype-policy fields do not exist on that graph, and
    ``parameterization`` is kept (it is what the head's output means)."""
    if preset == "ref":
        return RefUNet(device=device, **{
            k: v for k, v in overrides.items()
            if k in ("in_channels", "out_channels", "time_emb_dim",
                     "base_channels", "parameterization")})
    if preset not in _PRESETS:
        raise ValueError(
            f"unknown preset {preset!r} (have {['ref'] + sorted(_PRESETS)})")
    if resolution is None:
        resolution = int("".join(c for c in preset if c.isdigit()))
    cfg = dict(_PRESETS[preset])
    cfg.update(overrides)
    return CondUNet(resolution=resolution, num_classes=num_classes,
                    compute_dtype=compute_dtype, device=device, **cfg)


def model_from_config(cfg, device="cuda"):
    """Build the model a :class:`~superdiff_torch.config.Config` describes
    (the same overrides, in the same order, as the JAX package)."""
    overrides = {}
    if cfg.model.base_channels:
        overrides["base_channels"] = cfg.model.base_channels
    nrb = getattr(cfg.model, "num_res_blocks", None)
    if nrb:
        overrides["num_res_blocks"] = nrb[0] if len(nrb) == 1 else tuple(nrb)
    ar = getattr(cfg.model, "attn_resolutions", None)
    if ar:
        # an empty override is ignored, as in the JAX package (``if ar:``);
        # the preset's up-path policy is kept
        overrides["attn_resolutions"] = tuple(ar)
    nd = getattr(cfg.model, "norm_dtype", "float32")
    if nd not in _DTYPES or cfg.model.compute_dtype not in _DTYPES:
        raise ValueError("model.compute_dtype / model.norm_dtype must be "
                         f"one of {sorted(_DTYPES)}")
    if nd != "float32":
        overrides["norm_dtype"] = _DTYPES[nd]
    pz = getattr(cfg.model, "parameterization", "eps")
    if pz != "eps":
        overrides["parameterization"] = pz
    if getattr(cfg.model, "remat", False):
        overrides["remat"] = True
    return build_model(
        cfg.model.preset,
        num_classes=cfg.model.num_classes if cfg.model.conditional else 0,
        compute_dtype=_DTYPES[cfg.model.compute_dtype],
        resolution=cfg.training.resolution,
        device=device,
        dropout=cfg.model.dropout,
        **overrides)


def preset_for_resolution(resolution: int) -> str:
    if resolution not in RESOLUTION_TO_PRESET:
        raise ValueError(f"no preset for resolution {resolution} "
                         f"(have {sorted(RESOLUTION_TO_PRESET)})")
    return RESOLUTION_TO_PRESET[resolution]
