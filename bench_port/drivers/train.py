"""Training cells: the port's train step (``make_train_step`` on a
``create_train_state``, as ``cli.train --synthetic`` builds them: float32
parameters, the configuration's compute dtype, Adam with global-norm
clipping, EMA) over a pool of synthetic X-ray batches
(``data/synthetic.py::synthetic_xray_batch``) made from the seed and held
on the card before the window. The host runs at most ``max_ahead`` steps
ahead of the card.

Set-up builds the one train state, takes its first ``checked_steps``
steps on the pool's first batches (rows that all differ; they also warm
every shape) and hands the same state to the window. What is compared
against the reference's same steps from the same weights and draws: each
step's loss (``loss_rel_gap``), the first step's gradient as Adam took it
(``mu / (1 - b1)`` after one step; ``grad1_leaf_gap``), and the change of
the parameters and of the EMA after the checked steps
(``dparam_leaf_gap``, ``ema_leaf_gap``), by the worst leaf's gap of norms
over the larger of its reference norm and the median leaf's; the change
leaves out the elements whose reference gradient is under a thousandth of
the median leaf's root-mean-square gradient (``compare.moved``). Traffic keys: ``batch``, ``pool``, ``learning_rate``,
``grad_clip_norm``, ``ema_decay``, ``cfg_drop_prob``, ``checked_steps``,
``max_ahead``, ``trace_steps``.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from bench_port.common import counts, host, program, trace, weights
from bench_port.common.weights import derive
from bench_port.reference import compare, diffusion
from bench_port.reference import train as ref_train
from bench_port.reference.precision import Precision


def _batches(cell, seed, device):
    from superdiff_torch.data.synthetic import synthetic_xray_batch

    cfg, tr = cell.config, cell.traffic
    out = []
    for i in range(tr["pool"]):
        imgs, labels = synthetic_xray_batch(
            tr["batch"], cfg["resolution"], num_classes=cfg["num_classes"],
            seed=derive(seed, "batch", i), normalization="tanh")
        out.append((torch.from_numpy(imgs).to(device),
                    torch.from_numpy(labels).long().to(device)))
    return out


def run(cell, opt) -> dict:
    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)
    from superdiff_torch.training.steps import make_train_step

    dev, tr, cfg = opt.device, cell.traffic, cell.config
    ref = cell.reference()
    specs = ref.param_specs(cfg)
    model = program.build_model(
        cfg, weights.make(specs, derive(opt.seed, "weights", 0), dev), dev,
        sampling=False)
    names = [n for n, _ in model.named_parameters()]
    sched = program.schedule(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(derive(opt.seed, "draws"))
    tx = make_optimizer(learning_rate=tr["learning_rate"],
                        grad_clip_norm=tr["grad_clip_norm"])
    state = create_train_state(model, g, tx=tx, ema_decay=tr["ema_decay"])
    step_fn = make_train_step(sched, conditional=cfg["num_classes"] > 0,
                              cfg_drop_prob=tr["cfg_drop_prob"],
                              null_label=cfg["num_classes"])
    pool = _batches(cell, opt.seed, dev)
    losses, produced = [], {}
    for i in range(tr["checked_steps"]):
        state, m = step_fn(state, {"image": pool[i][0],
                                   "label": pool[i][1]})
        losses.append(m["loss"])
        if i == 0:
            b1 = state.tx.b1
            produced["grad1"] = {n: (mu / (1.0 - b1)).clone() for n, mu in
                                 zip(names, state.opt_state["mu"])}
    produced["params"] = {n: p.detach().clone()
                          for n, p in zip(names, state.params)}
    produced["ema"] = {n: p.detach().clone()
                       for n, p in zip(names, state.ema_params)}
    produced["losses"] = [float(v) for v in losses]
    _sync(dev)

    ahead = tr.get("max_ahead", 2)
    ring = ([torch.cuda.Event() for _ in range(ahead)]
            if dev.type == "cuda" else [])
    done = [0]

    def one():
        i = tr["checked_steps"] + done[0]
        if ring:
            ev = ring[done[0] % len(ring)]
            ev.synchronize()
        x, y = pool[i % len(pool)]
        step_fn(state, {"image": x, "label": y})
        if ring:
            ev.record()
        done[0] += 1

    def traced():
        n = tr.get("trace_steps", 3)
        for _ in range(n):
            one()
        return {"train_steps": n}

    setup_s = time.perf_counter() - opt.t0
    window = None
    marks = [0.25, 0.5, 0.75] if opt.trace else []
    with host.HostMeter() as meter:
        tic = meter.tic
        deadline = tic + opt.seconds
        while time.perf_counter() < deadline:
            if marks and time.perf_counter() >= tic + marks[0] * opt.seconds:
                marks.pop(0)
                w = trace.profile(traced)
                if window is None or len(w.device) > len(window.device):
                    window = w
            one()
            meter.step()
        _sync(dev)
    wall = time.perf_counter() - tic
    print(meter.line(), file=sys.stderr)
    out = {"setup_s": setup_s, "window_s": wall, "window": window,
           "attempted": done[0], "failed": 0,
           "e2e": {"train_images_per_s": done[0] * tr["batch"] / wall},
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0),
           "static": {"flops_per_step": counts.train_flops(
               ref, cfg, tr["batch"])}}
    del state, model, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    first = pool[:tr["checked_steps"]]
    ref_tic = time.perf_counter()
    ref_out = reference_steps(cell, opt.seed, dev, first)
    out["reference_s"] = time.perf_counter() - ref_tic
    out["readings"] = readings(cell, opt.seed, dev, produced, ref_out)
    out["controls"] = {
        mode: readings(cell, opt.seed, dev,
                       reference_steps(cell, opt.seed, dev, first, mode),
                       ref_out)
        for mode in getattr(opt, "controls", ())}
    out["faults"] = {
        f: readings(cell, opt.seed, dev,
                    reference_steps(cell, opt.seed, dev, first, fault=f),
                    ref_out)
        for f in getattr(opt, "faults", ())}
    return out


def reference_steps(cell, seed, dev, batches, mode="f32", fault=None):
    """The reference's checked steps from the seed's weights and draws, its
    products at precision ``mode``, with ``fault`` planted
    (``reference/train.py::run_steps``)."""
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    prec = Precision(mode, search=False)
    P0 = weights.make(ref.param_specs(cfg), derive(seed, "weights", 0), dev)
    g = torch.Generator(device=dev).manual_seed(derive(seed, "draws"))

    def fwd(P, x, t, y):
        return ref.forward(P, cfg, x, t, y, prec)

    with prec.context():
        return ref_train.run_steps(fwd, P0, diffusion.Schedule(cfg, dev),
                                   batches, g, tr, cfg["num_classes"],
                                   fault=fault)


def readings(cell, seed, dev, got, ref_out) -> dict:
    cfg = cell.config
    P0 = weights.make(cell.reference().param_specs(cfg),
                      derive(seed, "weights", 0), dev)
    moved = compare.moved(ref_out["grad1"])
    delta = lambda d: {k: (d[k] - P0[k])[m] for k, m in moved.items()}
    return {"loss_rel_gap": compare.rel_gap(got["losses"],
                                            ref_out["losses"]),
            "grad1_leaf_gap": compare.leaf_gap(got["grad1"],
                                               ref_out["grad1"]),
            "dparam_leaf_gap": compare.leaf_gap(delta(got["params"]),
                                                delta(ref_out["params"])),
            "ema_leaf_gap": compare.leaf_gap(delta(got["ema"]),
                                             delta(ref_out["ema"]))}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
