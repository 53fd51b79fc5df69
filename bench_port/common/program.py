"""The system under test, built from a configuration file and seeded
weights, as the port's entry points build it (``inference.load_run`` then
``apply_sampling_policy`` for sampling; ``create_train_state`` for
training). The only module of the harness, with the drivers, that imports
the program."""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the configuration's sizes, passed to the preset as overrides: the file,
# not the preset table, says what is run
_WIDTHS = ("in_channels", "out_channels", "base_channels", "channel_mults",
           "num_res_blocks", "attn_resolutions", "up_attn_resolutions",
           "num_heads", "pixel_shuffle", "groups", "time_emb_dim")


def build_model(cfg, weights, device, sampling: bool):
    """The program's model of ``cfg`` holding ``weights`` (float32), on
    ``device``. With ``sampling``, as ``load_run`` leaves it (eval mode,
    channels-last conv weights) with the port's sampling policy applied;
    otherwise as ``cli.train`` builds it."""
    from superdiff_torch.inference import apply_sampling_policy
    from superdiff_torch.models.presets import build_model as build

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in _WIDTHS}
    if cfg["preset"] != "ref":
        kw.update(num_classes=cfg["num_classes"],
                  compute_dtype=_DTYPES[cfg["compute_dtype"]],
                  resolution=cfg["resolution"])
    model = build(cfg["preset"], device="meta", **kw)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    if not sampling:
        return model
    model = model.float().eval()
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d) and device.type == "cuda":
            m.weight.data = m.weight.data.contiguous(
                memory_format=torch.channels_last)
    return apply_sampling_policy(model)


def schedule(cfg, device):
    from superdiff_torch.diffusion.schedules import make_schedule

    return make_schedule(cfg["num_timesteps"], kind="linear",
                         beta_start=cfg["beta_start"],
                         beta_end=cfg["beta_end"], device=device)
