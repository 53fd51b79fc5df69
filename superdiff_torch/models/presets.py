"""Named model presets (the same table as ``superdiff_tpu/models/presets.py``).

The topology per preset is copied exactly so checkpoints move between the
two packages. ``"ref"`` is the reference's own graph
(:class:`~superdiff_torch.models.unet_ref.RefUNet`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from superdiff_torch.models.sd_unet import SDUNet
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

# Stable Diffusion 2.1-base's UNet (stabilityai/stable-diffusion-2-1-base,
# unet/config.json): 64x64x4 latents, a 77 x 1024 text context, every
# attention head 64 wide
_SD_PRESETS: Dict[str, Dict[str, Any]] = {
    "sd21base": dict(sample_size=64, in_channels=4, out_channels=4,
                     block_out_channels=(320, 640, 1280, 1280),
                     layers_per_block=2, attention_head_dim=(5, 10, 20, 20),
                     cross_attention_levels=(True, True, True, False),
                     cross_attention_dim=1024, norm_num_groups=32,
                     norm_eps=1e-5, freq_shift=0.0),
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

    ``"sd21base"`` builds Stable Diffusion 2.1-base's
    :class:`~superdiff_torch.models.sd_unet.SDUNet` (``resolution`` is the
    latent side, 64 by default); it is conditioned on a text context, so
    ``num_classes`` does not apply to it.

    ``"ref"`` builds the RefUNet from its own graph fields only; the
    conditioning and dtype-policy fields do not exist on that graph, and
    ``parameterization`` is kept (it is what the head's output means)."""
    if preset == "ref":
        return RefUNet(device=device, **{
            k: v for k, v in overrides.items()
            if k in ("in_channels", "out_channels", "time_emb_dim",
                     "base_channels", "parameterization")})
    if preset in _SD_PRESETS:
        cfg = dict(_SD_PRESETS[preset])
        cfg.update(overrides)
        if resolution is not None:
            cfg["sample_size"] = resolution
        return SDUNet(compute_dtype=compute_dtype, device=device, **cfg)
    if preset not in _PRESETS:
        raise ValueError(
            f"unknown preset {preset!r} (have "
            f"{['ref'] + sorted(_PRESETS) + sorted(_SD_PRESETS)})")
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
