"""The training engine: epoch loop, metrics, checkpoints, periodic samples.

Port of ``superdiff_tpu/training/loop.py``:

- one train step per batch, EMA maintained inside the step, replayed as
  one CUDA graph on a card (``training/steps.py``; the share of an
  epoch's steps replayed is logged with it as ``graph_replay_share``); in
  a process group (``parallel/mesh.py``), an eager data-parallel step over
  a mesh of every rank, each rank on its rows of the global batch, and
  only rank 0 writing files (config, metrics, checkpoints, figures);
- checkpoints of the full state with resume (``checkpoint.py``);
- metrics reach jsonl / TensorBoard / wandb;
- validation on the EMA parameters over a fixed stream, with the best-val
  state tagged into ``<checkpoint_dir>_best`` and ``best_val.json``;
- every ``vis_every`` epochs: EMA-sampled images vs a real batch as a PNG,
  and a loss curve at the end, drawn by the port's own renderer
  (``utils/raster.py``; no matplotlib), only when ``training.vis_every >
  0`` (the JAX loop draws the loss curve unconditionally).

The loop never waits for the device inside an epoch: losses stay device
tensors and are fetched once per epoch. Data comes from a class-folder tree
through ``data/datamodule.py`` (``dataset_root``, else the run paths'
dataset directory) as raw uint8 batches, augmented and normalized inside
the train step; ``use_synthetic=True`` trains on generated images instead.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from superdiff_torch.checkpoint import CheckpointManager
from superdiff_torch.config import Config, save_config
from superdiff_torch.data.datamodule import DataModule
from superdiff_torch.data.synthetic import synthetic_xray_batch
from superdiff_torch.data.transforms import prepare_batch
from superdiff_torch.diffusion import ddpm_sample, make_schedule
from superdiff_torch.diffusion.process import eps_from_pred
from superdiff_torch.models.presets import (
    model_from_config, preset_for_resolution)
from superdiff_torch.parallel.mesh import (
    is_main_process, make_mesh, shard_batch)
from superdiff_torch.training import steps as train_steps
from superdiff_torch.training.state import create_train_state, make_optimizer
from superdiff_torch.training.steps import make_eval_step, make_train_step
from superdiff_torch.utils import profiling
from superdiff_torch.utils.env import resolve_paths, set_global_seeds
from superdiff_torch.utils.logger import init_logger
from superdiff_torch.utils.metrics import MetricsLogger
from superdiff_torch.utils.visualization import (
    save_loss_curve, save_real_vs_generated)

logger = logging.getLogger("superdiff_torch")


def _synthetic_batches(cfg: Config, epoch: int, device,
                       augmentation: str = None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Synthetic data path for smoke runs / missing datasets: batch ``i`` of
    ``epoch`` is made from the seed ``epoch * 10_000 + i`` (images on the
    host with numpy, augmentation draws from a device generator of the same
    seed). ``augmentation`` overrides the training tier (validation passes
    ``"none"``: validation sees clean data)."""
    t = cfg.training
    aug = t.augmentation if augmentation is None else augmentation
    steps = t.steps_per_epoch or 4
    for i in range(steps):
        seed = epoch * 10_000 + i
        imgs, labels = synthetic_xray_batch(
            t.batch_size, t.resolution, num_classes=cfg.model.num_classes,
            seed=seed, normalization="minmax")
        g = torch.Generator(device=device).manual_seed(seed)
        image = prepare_batch(
            torch.from_numpy((imgs * 255).astype(np.uint8)).to(device), g,
            augmentation=aug, normalization=t.normalization)
        yield {"image": image,
               "label": torch.from_numpy(labels).long().to(device)}


def _uint8_batch(batch: Dict[str, np.ndarray], device
                 ) -> Dict[str, torch.Tensor]:
    """A host batch from the tree on ``device``: uint8 images (augmented and
    normalized inside the step) and int64 labels."""
    return {"image": torch.from_numpy(batch["image"]).to(device),
            "label": torch.from_numpy(batch["label"]).long().to(device)}


def train(cfg: Config,
          dataset_root: Optional[str] = None,
          resume: bool = True,
          use_synthetic: bool = False,
          should_stop=None,
          device="cuda") -> Dict[str, float]:
    """Run training per config on ``device``; returns summary metrics.

    ``dataset_root`` overrides the resolved dataset path; with
    ``use_synthetic`` the synthetic generator stands in for the tree.

    Preemption safety: SIGTERM/SIGINT request a graceful stop; the loop
    finishes the current step, saves a checkpoint and returns, and a restart
    resumes from it. A custom ``should_stop() -> bool`` hook composes with
    the signal path (tests, schedulers).

    Profiling: ``logging.profile_steps = N`` traces steps 2..2+N of the first
    epoch with ``torch.profiler`` into ``<output>/profile/trace.json``
    (``profiling.trace``: the train step's spans name its phases there).
    """
    t = cfg.training
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' explicitly)")
    if not cfg.model.preset:
        cfg.model.preset = preset_for_resolution(t.resolution)
    import torch.distributed as dist

    mesh = None
    if dist.is_initialized():
        mesh = make_mesh(device=device)
        if t.batch_size % mesh.shape["data"]:
            raise ValueError(f"batch_size {t.batch_size} not divisible by "
                             f"{mesh.shape['data']} devices")
    main = is_main_process()
    paths = resolve_paths(cfg).make_all()
    if main:
        init_logger(paths.log_dir, stdout=cfg.logging.stdout)
        save_config(cfg, os.path.join(paths.output_dir, "config.yaml"))
    generator = set_global_seeds(t.seed, device=device)

    # data
    dm: Optional[DataModule] = None
    if not use_synthetic:
        dm = DataModule(cfg, dataset_root or paths.dataset_dir)
        dm.index("train")  # fail fast if the tree is missing
    steps_per_epoch = (t.steps_per_epoch if t.steps_per_epoch
                       else (len(dm.iterator("train", epoch=0)) if dm else 4))

    # model + schedule + state
    schedule = make_schedule(t.num_timesteps, kind=t.schedule,
                             beta_start=t.beta_start, beta_end=t.beta_end,
                             device=device)
    model = model_from_config(cfg, device=device)
    model.init_parameters(t.seed)
    conditional = cfg.model.conditional
    B, R = t.batch_size, t.resolution
    tx = make_optimizer(
        learning_rate=t.learning_rate, weight_decay=t.weight_decay,
        grad_clip_norm=t.grad_clip_norm, warmup_steps=t.warmup_steps,
        total_steps=steps_per_epoch * t.num_epochs,
        schedule=t.lr_schedule)
    state = create_train_state(model, generator, tx=tx,
                               ema_decay=t.ema_decay)
    n_params = sum(p.numel() for p in state.params)
    logger.info("model %s: %s params", cfg.model.preset, f"{n_params:,}")

    parameterization = getattr(cfg.model, "parameterization", "eps")
    step_fn = make_train_step(schedule, mesh=mesh, conditional=conditional,
                              cfg_drop_prob=t.cfg_drop_prob,
                              null_label=getattr(model, "null_label", 0),
                              loss_type=t.loss_type,
                              weighting=t.loss_weighting,
                              min_snr_gamma=t.min_snr_gamma,
                              augmentation=t.augmentation,
                              normalization=t.normalization,
                              parameterization=parameterization,
                              grad_accum=getattr(t, "grad_accum", 1))

    # validation: EMA loss on a fixed stream every eval_every epochs; the
    # best-val step is checkpointed separately so a late-training regression
    # never evicts the best model.
    eval_fn = make_eval_step(schedule, mesh=mesh, conditional=conditional,
                             loss_type=t.loss_type,
                             weighting=t.loss_weighting,
                             min_snr_gamma=t.min_snr_gamma,
                             normalization=t.normalization,
                             parameterization=parameterization) \
        if t.eval_every > 0 else None

    def _val_batches():
        """A fixed validation stream (the same batches every pass, so val
        curves are comparable across epochs): the tree's ``val`` split at
        epoch 0 as raw uint8 (normalized inside the eval step), None when
        the tree has no such split; synthetic batches of a constant seed
        otherwise."""
        if dm is not None:
            try:
                dm.index("val")
            except (FileNotFoundError, ValueError):
                return None
            return (_uint8_batch(b, device)
                    for b in dm.iterator("val", epoch=0))
        return _synthetic_batches(cfg, epoch=1_000_003, device=device,
                                  augmentation="none")

    def run_validation() -> Optional[float]:
        batches = _val_batches()
        if batches is None:
            return None
        losses = []
        for j, vb in enumerate(batches):
            if t.eval_batches and j >= t.eval_batches:
                break
            if mesh is not None:
                vb = shard_batch(vb, mesh, local=dm is not None
                                 and dm.resolve_shard() is not None)
            n = int(vb["image"].shape[0])
            want = B // (mesh.shape["data"] if mesh is not None else 1)
            if n != want:
                # wrap-pad a short batch up to B (deterministic duplicates),
                # so a val split smaller than the batch still has a curve
                reps = -(-want // n)
                vb = {k: v.repeat((reps,) + (1,) * (v.ndim - 1))[:want]
                      for k, v in vb.items()}
            losses.append(eval_fn(state, vb))
        if not losses:
            return None
        return float(torch.stack(losses).mean().cpu())

    # checkpointing / resume
    ckpt = CheckpointManager(paths.checkpoint_dir,
                             max_to_keep=t.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_epoch = state.step // max(steps_per_epoch, 1)
        logger.info("resumed from step %d (epoch %d)", state.step,
                    start_epoch)

    metrics_log = MetricsLogger(
        jsonl_path=os.path.join(paths.output_dir, "metrics.jsonl")
        if cfg.logging.use_jsonl and main else None,
        tensorboard_dir=paths.tensorboard_dir
        if cfg.logging.use_tensorboard and main else None,
        wandb_project=cfg.logging.wandb_project
        if cfg.logging.use_wandb and main else None,
        wandb_run_name=f"{cfg.experiment_id}_{cfg.run_id}",
        wandb_dir=paths.wandb_dir)

    # graceful-stop plumbing: SIGTERM/SIGINT (preemption) or a custom hook
    stop_flag = {"stop": False}

    def _request_stop(signum, frame):  # pragma: no cover - signal timing
        logger.info("signal %d: finishing step, checkpointing, exiting",
                    signum)
        stop_flag["stop"] = True

    prev_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _request_stop)
    except ValueError:  # not the main thread; hook-only stopping
        prev_handlers = {}

    def _stopping() -> bool:
        return stop_flag["stop"] or bool(should_stop and should_stop())

    def _every(n: int, epoch: int) -> bool:
        """Epoch-periodic trigger; n <= 0 disables the feature."""
        return n > 0 and (epoch + 1) % n == 0

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    profile_after = 1 if cfg.logging.profile_steps > 0 else -1
    profiler = None           # an open ``profiling.trace`` of a few steps

    def _stop_profiler():
        nonlocal profiler
        if profiler is not None:
            profiler.__exit__(None, None, None)
            profiler = None

    all_losses = []
    last_real = None
    summary: Dict[str, float] = {}
    stopped = False
    best_val = float("inf")
    best_val_step = -1
    ckpt_best: Optional[CheckpointManager] = None
    m = None
    try:
        for epoch in range(start_epoch, t.num_epochs):
            epoch_losses = []
            _sync()
            tic = time.time()
            counts0 = (train_steps.replays, train_steps.eager_steps)
            # tree batches ride as raw uint8: one small upload per batch
            batches = ((_uint8_batch(b, device) for b in dm.iterator("train"))
                       if dm else _synthetic_batches(cfg, epoch, device))
            for i, batch in enumerate(batches):
                if t.steps_per_epoch and i >= t.steps_per_epoch:
                    break
                if mesh is not None:
                    batch = shard_batch(batch, mesh, local=dm is not None
                                        and dm.resolve_shard() is not None)
                if not conditional:
                    batch = {"image": batch["image"]}
                if epoch == start_epoch and i == profile_after and main:
                    profiler = profiling.trace(
                        os.path.join(paths.output_dir, "profile"))
                    profiler.__enter__()
                state, m = step_fn(state, batch)
                # the loss stays a device scalar: reading it here would wait
                # for the device on every step
                epoch_losses.append(m["loss"])
                last_real = batch["image"]
                if (profiler is not None
                        and i >= profile_after + cfg.logging.profile_steps):
                    _stop_profiler()
                if _stopping():
                    if main:
                        ckpt.save(state, force=True)
                    stopped = True
                    break
            _stop_profiler()   # epoch shorter than the trace window
            if stopped:
                logger.info("stopped at step %d; checkpoint saved",
                            state.step)
                break
            if not epoch_losses:
                raise RuntimeError(
                    f"epoch {epoch + 1} yielded zero batches "
                    "(empty dataset or steps_per_epoch=0?)")
            epoch_losses = torch.stack(epoch_losses).float().cpu().tolist()
            dt = time.time() - tic
            avg = float(np.mean(epoch_losses))
            all_losses.extend(epoch_losses)
            imgs_per_sec = len(epoch_losses) * B / max(dt, 1e-9)
            replayed = train_steps.replays - counts0[0]
            share = replayed / max(
                replayed + train_steps.eager_steps - counts0[1], 1)

            if _every(t.log_every, epoch):
                logger.info("epoch %d: avg_loss=%.4f (%.1f img/s, %.0f%% "
                            "of steps replayed)", epoch + 1, avg,
                            imgs_per_sec, 100.0 * share)
            metrics_log.log(state.step,
                            {"epoch": epoch + 1, "avg_loss": avg,
                             "images_per_sec": imgs_per_sec,
                             "graph_replay_share": share,
                             "grad_norm": float(m["grad_norm"])})

            if eval_fn is not None and _every(t.eval_every, epoch):
                val_loss = run_validation()
                if val_loss is not None:
                    improved = val_loss < best_val
                    metrics_log.log(state.step,
                                    {"epoch": epoch + 1,
                                     "val_loss": val_loss,
                                     "best_val_loss": min(val_loss,
                                                          best_val)})
                    if _every(t.log_every, epoch):
                        logger.info("epoch %d: val_loss=%.4f%s", epoch + 1,
                                    val_loss, " (best)" if improved else "")
                    if improved and main:
                        # saves are synchronous here, so every improvement
                        # is tagged (the JAX loop defers behind async writes)
                        best_val, best_val_step = val_loss, state.step
                        if ckpt_best is None:
                            ckpt_best = CheckpointManager(
                                paths.checkpoint_dir + "_best",
                                max_to_keep=1)
                        with open(os.path.join(paths.output_dir,
                                               "best_val.json"), "w") as f:
                            json.dump({"step": best_val_step,
                                       "epoch": epoch + 1,
                                       "val_loss": best_val}, f)
                        ckpt_best.save(state, force=True)

            if _every(t.save_every, epoch) and main:
                ckpt.save(state)

            if (_every(t.vis_every, epoch) and last_real is not None
                    and main):
                n_vis = min(8, B)
                ema = state.ema_model       # float32, not the trained copy

                def fn(xx, tt, *yy):
                    pred = ema(xx, tt, *yy)
                    if parameterization == "eps":
                        return pred
                    return eps_from_pred(schedule, xx, tt, pred,
                                         parameterization)

                y_vis = (torch.arange(n_vis, device=device)
                         % cfg.model.num_classes) if conditional else None
                g_vis = torch.Generator(device=device).manual_seed(
                    t.seed + 7_000 + epoch)
                gen = ddpm_sample(schedule, fn, (n_vis, R, R, 1), g_vis,
                                  y=y_vis)
                save_real_vs_generated(
                    last_real[:n_vis].float().cpu().numpy(),
                    gen.float().cpu().numpy(),
                    os.path.join(paths.output_dir,
                                 f"samples_epoch{epoch + 1}.png"))

        if all_losses:
            if t.vis_every > 0 and main:
                save_loss_curve(all_losses, os.path.join(paths.output_dir,
                                                         "loss_curve.png"))
            summary["final_loss"] = all_losses[-1]
            summary["mean_last_epoch_loss"] = (
                avg if not stopped else float(np.mean(
                    torch.stack(epoch_losses).float().cpu().tolist())))
        if main:
            ckpt.save(state, force=True)
        if ckpt_best is not None:
            summary["best_val_loss"] = best_val
            summary["best_val_step"] = float(best_val_step)
    finally:
        # restore process-wide handlers and close an open trace and the
        # writers even when a step raises
        exc_in_flight = sys.exc_info()[0] is not None
        if profiler is not None:        # the trace keeps what it holds
            try:
                profiler.__exit__(*sys.exc_info())
            except Exception:         # a faulted card: the sync raises
                logger.exception("closing the profile trace failed")
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        close_err: Optional[BaseException] = None
        for closer in (ckpt.close,
                       ckpt_best.close if ckpt_best is not None else None,
                       metrics_log.close):
            if closer is None:
                continue
            try:
                closer()
            except Exception as e:  # pragma: no cover - teardown errors
                logger.exception("finalizing a writer failed")
                close_err = close_err or e
        if close_err is not None and not exc_in_flight:
            raise close_err
    summary["steps"] = state.step
    summary["stopped_early"] = float(stopped)
    return summary
