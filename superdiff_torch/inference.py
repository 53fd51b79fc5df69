"""Run-directory loading and epsilon-function construction for sampling.

Port of ``superdiff_tpu/inference.py``. A torch model carries its own
weights, so where the JAX functions take ``(model, params)`` these take the
module. ``load_run`` reads exported inference artifacts (``config.yaml`` +
``ema_params.npz``, the ``cli/export.py`` format of either package) and the
port's own training run dirs (``config.yaml`` + ``checkpoints/``); Orbax
training checkpoints of the JAX package need exporting first.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from superdiff_torch.compat.flax_params import (
    EXPORT_FILE, load_exported_params, load_state_dict)
from superdiff_torch.config import Config, load_config
from superdiff_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from superdiff_torch.models.presets import model_from_config

# Parameters that stay float32 under the sampling dtype policy: norm
# scales/biases, the conditioning MLPs, and the float32 output conv (the
# CondUNet's and the RefUNet's names, then the SDUNet's: its norms' names
# hold "norm", its ResBlocks' time projection "emb_proj")
_F32_NAME_TOKENS = ("norm", "time_mlp", "class_emb", "emb_proj", "out_conv",
                    "time_embedding", "conv_out")


def _keeps_f32(name: str) -> bool:
    return any(tok in part for part in name.split(".")
               for tok in _F32_NAME_TOKENS)


def cast_sampling_params(state_dict: Dict[str, torch.Tensor],
                         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Cast the conv / attention / dense weights that the model consumes in
    ``compute_dtype`` to ``dtype``; leaves consumed in float32 (see
    ``_F32_NAME_TOKENS``) are untouched."""
    return {k: (v.to(dtype) if v.dtype == torch.float32 and not _keeps_f32(k)
                else v)
            for k, v in state_dict.items()}


def inference_model(model):
    """Set the inference dtype policy on ``model`` in place (bfloat16 norm
    passes; statistics still reduce in float32). No-op for a model without
    the knob (the RefUNet) or when ``SUPERDIFF_TPU_SAMPLE_F32`` is set."""
    if os.environ.get("SUPERDIFF_TPU_SAMPLE_F32"):
        return model
    if hasattr(model, "set_norm_dtype"):
        model.set_norm_dtype(torch.bfloat16)
    return model


@torch.no_grad()
def apply_sampling_policy(model):
    """The production sampling configuration, applied in place: bfloat16
    norm passes and a one-time bfloat16 cast of the conv/attention/dense
    weights. On the RefUNet only the cast applies (its conv and
    ``time_emb`` weights): its float32 layers cast the rounded weights back,
    so the graph runs float32, as Flax's float32 layers promote them. Opt out
    with ``SUPERDIFF_TPU_SAMPLE_F32=1``."""
    if os.environ.get("SUPERDIFF_TPU_SAMPLE_F32"):
        return model
    inference_model(model)
    model.load_state_dict(cast_sampling_params(model.state_dict()),
                          assign=True)
    return model


def _to_channels_last(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(
                memory_format=torch.channels_last)
    return model


def load_run(run_dir: str, device="cuda", step: Optional[int] = None,
             best: bool = False) -> Tuple[
        Config, torch.nn.Module, DiffusionSchedule]:
    """Load ``(cfg, model, schedule)`` from an exported inference artifact
    (``config.yaml`` + ``ema_params.npz``) or from one of the port's training
    run dirs (``config.yaml`` + ``checkpoints/``): the model holds the EMA
    weights (float32) on ``device``, in eval mode.

    ``step`` picks a checkpoint other than the latest; ``best=True`` loads the
    best-validation checkpoint the training loop tags
    (``<checkpoint_dir>_best``)."""
    from superdiff_torch.checkpoint import (
        CheckpointManager, load_checkpoint_file)

    cfg_path = os.path.join(run_dir, "config.yaml")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"no config.yaml in {run_dir}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' explicitly)")
    cfg = load_config(cfg_path)
    export_path = os.path.join(run_dir, EXPORT_FILE)
    ckpt_dir = os.path.join(run_dir, cfg.paths.checkpoint_dir)
    if best:
        if not os.path.isdir(ckpt_dir + "_best"):
            raise FileNotFoundError(
                f"no best-val checkpoint in {run_dir} (train with "
                "training.eval_every > 0 to tag one)")
        ckpt_dir += "_best"
    from_export = os.path.exists(export_path) and not os.path.isdir(ckpt_dir)
    if from_export and step is not None:
        raise ValueError(
            f"{run_dir} is an exported inference artifact holding one "
            "snapshot; --step is only meaningful on a training run dir")
    if not from_export:
        steps = (CheckpointManager(ckpt_dir).all_steps()
                 if os.path.isdir(ckpt_dir) else [])
        if not steps:
            raise NotImplementedError(
                f"{run_dir} has no {EXPORT_FILE} and no superdiff_torch "
                "checkpoint; loading Orbax training checkpoints is not "
                "ported (export the run with superdiff_tpu.cli.export first)")
        if step is not None and step not in steps:
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{ckpt_dir} (have {steps})")
    t = cfg.training
    schedule = make_schedule(t.num_timesteps, kind=t.schedule,
                             beta_start=t.beta_start, beta_end=t.beta_end,
                             device=device)
    model = model_from_config(cfg, device="meta" if device.type == "cuda"
                              else device)
    if device.type == "cuda":
        model = model.to_empty(device=device)
    if from_export:
        load_state_dict(model, load_exported_params(export_path))
    else:
        saved = load_checkpoint_file(ckpt_dir,
                                     steps[-1] if step is None else step)
        model.load_state_dict(saved["ema_params"], strict=True)
    model = _to_channels_last(model.float().eval())
    return cfg, model, schedule


def resolve_sampler_spec(cfg: Config,
                         method: Optional[str] = None,
                         num_steps: Optional[int] = None,
                         spacing: str = "auto",
                         allowed=("ddpm", "ddim", "dpmpp"),
                         fallback: str = "ddpm"):
    """Where a run's stamped sampling block meets CLI overrides; returns
    ``(method, num_steps, t_spacing, clip_x0)`` (same rules as the JAX
    package: explicit values win; a stamped method in ``allowed`` is
    adopted with its step count except for ddpm)."""
    scfg = getattr(cfg, "sampling", None)
    if method is None:
        stamped = getattr(scfg, "method", None)
        if stamped in allowed:
            method = stamped
            if num_steps is None and method != "ddpm":
                num_steps = getattr(scfg, "num_steps", None)
        else:
            method = fallback
    if spacing in (None, "auto"):
        spacing = getattr(scfg, "t_spacing", "leading")
    clip_x0 = bool(getattr(scfg, "clip_x0", True))
    return method, num_steps, spacing, clip_x0


def check_superpose_compat(cfg: Config, cfg2: Config) -> None:
    """Raise unless two runs share the diffusion process (T, resolution and
    beta schedule)."""
    t, t2 = cfg.training, cfg2.training
    if t2.num_timesteps != t.num_timesteps:
        raise ValueError("runs have different T; cannot superpose")
    if t2.resolution != t.resolution:
        raise ValueError("runs have different resolutions")
    if (t2.schedule, t2.beta_start, t2.beta_end) != (
            t.schedule, t.beta_start, t.beta_end):
        raise ValueError(
            f"runs have different beta schedules "
            f"({t.schedule} {t.beta_start}..{t.beta_end} vs "
            f"{t2.schedule} {t2.beta_start}..{t2.beta_end}); "
            "cannot superpose")


def make_eps_fn_p(model, label=None,
                  schedule: Optional[DiffusionSchedule] = None) -> Callable:
    """Sampler-facing eps function with the module as the FIRST argument:
    ``fn(m, x, t)`` (or ``fn(m, x, t, y)`` for ``label="per_sample"``).

    For conditional models ``label=None`` means the null (unconditional)
    label and an int broadcasts over the batch. v/x0-headed models are
    converted to eps (``schedule`` required for those).

    A text-conditioned model (``context_dim`` > 0, the SDUNet) takes its
    context mode: ``label="context"`` gives ``fn(m, x, t, context)`` with a
    ``(B, L, C)`` context per call (a plan's context buffer), and a float
    tensor ``(L, C)`` or ``(B, L, C)`` binds that context, ``fn(m, x,
    t)``."""
    kind = getattr(model, "parameterization", "eps")
    if kind != "eps" and schedule is None:
        raise ValueError(
            f"model predicts {kind!r}; pass schedule= to make_eps_fn_p so "
            "the prediction can be converted to eps for the samplers")

    def _apply(m, x, t, *cond):
        pred = m(x, t, *cond)
        if kind == "eps":
            return pred
        from superdiff_torch.diffusion.process import eps_from_pred
        return eps_from_pred(schedule, x, t, pred, kind)

    if getattr(model, "context_dim", 0):
        if isinstance(label, str) and label == "context":
            return _apply
        if not (isinstance(label, torch.Tensor) and label.is_floating_point()
                and label.ndim in (2, 3)):
            raise ValueError(
                "a text-conditioned model takes label='context' or a bound "
                "(L, C) / (B, L, C) float context")
        bound = label if label.ndim == 3 else label[None]

        def fn_ctx(m, x, t):
            return _apply(m, x, t, bound.expand(x.shape[0], *bound.shape[1:]))

        return fn_ctx
    conditional = getattr(model, "num_classes", 0) > 0
    if not conditional or label == "per_sample":
        return _apply
    fixed = model.null_label if label is None else int(label)

    def fn(m, x, t):
        y = torch.full((x.shape[0],), fixed, dtype=torch.long,
                       device=x.device)
        return _apply(m, x, t, y)

    return fn


def make_eps_fn(model, label=None,
                schedule: Optional[DiffusionSchedule] = None) -> Callable:
    """:func:`make_eps_fn_p` with ``model`` bound: ``(x, t) -> eps`` (or
    ``(x, t, y)`` for ``label="per_sample"``)."""
    return functools.partial(make_eps_fn_p(model, label, schedule=schedule),
                             model)


def make_stacked_eps_fn(models, label=None,
                        schedule: Optional[DiffusionSchedule] = None
                        ) -> Callable:
    """One fused ``(x, t) -> (M, B, ...)`` eps call over M modules of the
    SAME architecture (:func:`superdiff_torch.diffusion.superdiff.
    stack_eps_fns`; the modules take the place of the JAX function's
    ``(model, params_list)``). ``label`` follows :func:`make_eps_fn`
    (None -> the null label); v/x0-headed models are converted to eps as in
    :func:`make_eps_fn_p` (``schedule`` required for those)."""
    from superdiff_torch.diffusion.superdiff import stack_eps_fns

    model = models[0]
    kind = getattr(model, "parameterization", "eps")
    if kind != "eps" and schedule is None:
        raise ValueError(
            f"model predicts {kind!r}; pass schedule= to "
            "make_stacked_eps_fn so the prediction can be converted to eps")
    if label == "per_sample":
        raise ValueError("make_stacked_eps_fn binds one label (or None); "
                         "per-sample labels are not supported")
    return stack_eps_fns(make_eps_fn_p(model, label, schedule=schedule),
                         models)


def same_architecture(cfg: Config, cfg2: Config) -> bool:
    """True when two run configs build identical model graphs (so their
    parameters can be stacked for the fused superposition call)."""
    import dataclasses

    return dataclasses.asdict(cfg.model) == dataclasses.asdict(cfg2.model)
