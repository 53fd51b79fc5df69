"""Import the reference's trained PyTorch checkpoints into the port.

Port of ``superdiff_tpu/compat/torch_import.py``. The reference saves
``ddpm_epoch{N}.pt`` and ``ema_epoch{N}.pt`` each epoch, both plain
``UNet.state_dict()`` dumps with one key layout, and has no code that loads
them. This module maps such a state dict onto
:class:`~superdiff_torch.models.unet_ref.RefUNet` and writes an inference
artifact in the shared export format (``config.yaml`` + ``ema_params.npz``
with Flax-layout keys under ``params/``), which ``load_run`` of either
package reads.

Both sides are torch, so no tensor is transposed: only the key names
change (``downs.0.block.2`` -> ``down_0.conv_0``, ``time_mlp.1`` ->
``time_mlp.dense_0``, ...). The architecture (base channels, time
embedding width, in/out channels) is read from the tensor shapes.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

# reference module path -> RefUNet submodule name
REF_BLOCKS: Tuple[Tuple[str, str], ...] = (
    ("downs.0", "down_0"),
    ("downs.1", "down_1"),
    ("mid", "mid"),
    ("ups.0", "up_0"),
    ("ups.1", "up_1"),
)
# reference layer inside ``<block>.block`` (a Sequential) -> RefUNet layer
_BLOCK_LAYERS = (("block.0", "norm_0"), ("block.2", "conv_0"),
                 ("block.3", "norm_1"), ("block.5", "conv_1"),
                 ("time_emb", "time_emb"))

# wrapper prefixes seen in the wild: DataParallel, and ema-pytorch's EMA
# object saved whole
_STRIP_PREFIXES = ("module.", "ema_model.", "online_model.")


def normalize_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """Strip wrapper prefixes, drop ema-pytorch's ``initted`` / ``step``
    bookkeeping, and return float32 CPU tensors.

    A whole-EMA-object save carries both ``ema_model.*`` and
    ``online_model.*``; the EMA weights are what the reference samples
    from, so when both are present only ``ema_model.*`` is kept."""
    keys = list(sd)
    if (any(k.startswith("ema_model.") for k in keys)
            and any(k.startswith("online_model.") for k in keys)):
        sd = {k: v for k, v in sd.items()
              if not k.startswith("online_model.")}
    out = {}
    for k, v in sd.items():
        for pre in _STRIP_PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
                break
        if k in ("initted", "step"):
            continue
        out[k] = torch.as_tensor(v).detach().to("cpu", torch.float32)
    return out


def infer_ref_arch(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Read the reference ``UNet`` constructor arguments back out of the
    tensor shapes."""
    try:
        w_mlp0 = sd["time_mlp.1.weight"]        # (4*dim, dim)
        w_in = sd["downs.0.block.2.weight"]     # (base, in_ch, 3, 3)
        w_out = sd["ups.1.block.5.weight"]      # (out_ch, out_ch, 3, 3)
    except KeyError as e:
        raise ValueError(
            f"state dict is missing reference-UNet key {e}: is this a "
            "ddpm_epochN.pt / ema_epochN.pt from the reference trainer? "
            f"(got keys like {sorted(sd)[:4]})")
    return dict(time_emb_dim=int(w_mlp0.shape[1]),
                base_channels=int(w_in.shape[0]),
                in_channels=int(w_in.shape[1]),
                out_channels=int(w_out.shape[0]))


def ref_state_dict_from_reference(sd: Dict) -> Dict[str, torch.Tensor]:
    """Reference ``UNet.state_dict()`` -> the port's RefUNet
    ``state_dict`` (float32 CPU tensors)."""
    sd = normalize_state_dict(sd)
    infer_ref_arch(sd)          # validates the key layout, with a useful error
    pairs = [("time_mlp.1", "time_mlp.dense_0"),
             ("time_mlp.3", "time_mlp.dense_1")]
    pairs += [(f"{ref}.{a}", f"{ours}.{b}") for ref, ours in REF_BLOCKS
              for a, b in _BLOCK_LAYERS]
    try:
        return {f"{ours}.{leaf}": sd[f"{ref}.{leaf}"]
                for ref, ours in pairs for leaf in ("weight", "bias")}
    except KeyError as e:
        raise ValueError(f"state dict is missing reference-UNet key {e}")


def import_checkpoint(checkpoint: str,
                      out_dir: str,
                      resolution: int = 256,
                      num_timesteps: int = 1000,
                      beta_start: float = 1e-4,
                      beta_end: float = 0.02,
                      normalization: str = "tanh",
                      task: str = "TB") -> Dict[str, int]:
    """Convert one reference ``.pt`` into an inference artifact directory.

    The defaults are the reference's training workload (linear betas 1e-4
    -> 0.02, T=1000, 256²); pass the run's own values if its config
    differed. Returns the inferred architecture."""
    from superdiff_torch.compat.flax_params import (
        EXPORT_FILE, export_params, to_flax)
    from superdiff_torch.config import Config, save_config
    from superdiff_torch.models.presets import model_from_config

    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{checkpoint} does not hold a state_dict "
                         f"(got {type(sd).__name__})")
    sd = normalize_state_dict(sd)
    arch = infer_ref_arch(sd)
    if (arch["in_channels"], arch["out_channels"]) != (1, 1):
        raise ValueError(f"expected grayscale 1->1 UNet, got {arch}")
    if arch["time_emb_dim"] != 256:
        # the config has no field for it, so a rebuild would be wrong
        raise ValueError(
            f"time_emb_dim {arch['time_emb_dim']} != 256: the reference "
            "trainer always builds UNet() with defaults; a custom graph "
            "needs a RefUNet/time_emb_dim field")
    state = ref_state_dict_from_reference(sd)

    cfg = Config()
    cfg.task = task
    cfg.model.preset = "ref"
    cfg.model.conditional = False
    cfg.model.compute_dtype = "float32"   # the reference graph runs fp32
    cfg.model.norm_dtype = "float32"
    cfg.model.base_channels = arch["base_channels"]
    cfg.training.resolution = resolution
    cfg.training.num_timesteps = num_timesteps
    cfg.training.schedule = "linear"
    cfg.training.beta_start = beta_start
    cfg.training.beta_end = beta_end
    cfg.training.normalization = normalization

    # shape-check against the RefUNet this config rebuilds, before writing:
    # a mis-shaped import would otherwise fail at the first load
    model = model_from_config(cfg, device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if want != got:
        raise ValueError(
            "imported parameter shapes do not match RefUNet "
            f"(base_channels={arch['base_channels']}):\n"
            f"want {want}\ngot  {got}")

    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    export_params({"params": to_flax(model, state)},
                  os.path.join(out_dir, EXPORT_FILE))
    return arch
