"""Sampling cells: chains of one sampler plan (``DDPMPlan``, or
``SuperDiffPlan`` over several models) captured as one CUDA graph of one
step (``GraphedSampler``, as ``cli.sample`` builds it) and run back to back
for the window, each chain from a fresh seeded ``x_T`` (and labels drawn
from the seed). The host runs at most ``max_ahead`` steps ahead of the
card (a ring of CUDA events), so the window ends with the work it timed.

What is compared (``x_rel_err.*``, ``dlogq_gap.*``): of chain 0, on
``check.rows`` rows drawn from the seed, the state after the first
``check.first_steps`` steps against the reference run from the same
``x_T`` and draws; and, where chain 0 ends inside the window, its output
against the reference run over the last ``check.last_steps`` steps from
the program's state at their start (``check.segments`` names which of
``first`` and ``last`` a cell compares). Each ``x_rel_err`` is the worst
row's relative L2 error; ``dlogq_gap`` is the worst (model, row) gap of
the change of log-density over the first steps (``compare.scaled_gap``).
SuperDiff splits the rows, by a rule on the reference, into those whose
two leading models' log-densities came within ``check.tie_nats`` of each
other after the first step (``near_tie_rows`` counts them) and the rest.
Every row starts tied (both models' densities at ``x_T`` are the one
standard normal's), so the first step mixes the models 1:1 on every row,
and a fault of the mixing weights (``FAULTS``, planted in the reference
put in the program's place) shows on the rest too. On a near-tie row the
weights turn round-off in the densities into another mixture, which
swings from seed to seed: its ``x_rel_err_tied`` (0 where a seed has
none) is recorded beside a null limit.
Traffic keys: ``sampler`` (``ddpm`` |
``superdiff``), ``mode``, ``models``, ``batch``, ``labels`` (``uniform``
over the classes and the null label, or null), ``max_ahead``,
``trace_steps``, ``check``.
"""

from __future__ import annotations

import gc
import time

import torch

from bench_port.common import counts, program, trace, weights
from bench_port.common.weights import derive
from bench_port.reference import compare, diffusion
from bench_port.reference.precision import Precision, stored


def _labels(cfg, tr, seed, chain, device):
    if tr.get("labels") != "uniform" or not cfg.get("num_classes"):
        return None
    g = torch.Generator().manual_seed(derive(seed, "labels", chain))
    return torch.randint(0, cfg["num_classes"] + 1, (tr["batch"],),
                         generator=g).to(device)


def build(cell, seed, device):
    """``(sampler, plan, models)`` of the cell at ``seed``."""
    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.samplers import DDPMPlan
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import make_eps_fn_p

    cfg, tr = cell.config, cell.traffic
    specs = cell.reference().param_specs(cfg)
    sched = program.schedule(cfg, device)
    models = [program.build_model(
        cfg, weights.make(specs, derive(seed, "weights", m), device), device,
        sampling=True) for m in range(tr["models"])]
    shape = (tr["batch"], cfg["resolution"], cfg["resolution"],
             cfg["in_channels"])
    y = _labels(cfg, tr, seed, 0, device)

    def eps_fn(model):
        applyp = make_eps_fn_p(model, "per_sample" if y is not None
                               else None, schedule=sched)
        return lambda *a: applyp(model, *a)

    if tr["sampler"] == "ddpm":
        plan = DDPMPlan(sched, eps_fn(models[0]), shape, y=y,
                        guidance_scale=1.0,
                        null_label=cfg.get("num_classes", 0))
    elif tr["sampler"] == "superdiff":
        plan = SuperDiffPlan(sched, [eps_fn(m) for m in models], shape,
                             mode=tr["mode"], y=y)
    else:
        raise ValueError(f"unknown sampler {tr['sampler']!r}")
    return GraphedSampler(plan), plan, models


def _state(plan):
    logq = getattr(plan, "logq", None)
    return (plan.x.clone(), None if logq is None else logq.clone())


class Chains:
    """The window's work: chains back to back, and chain 0's snapshots."""

    def __init__(self, cell, seed, sampler, plan, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.sampler, self.plan = sampler, plan
        chk = cell.traffic["check"]
        self.T = plan.num_steps
        self.marks = {chk["first_steps"]: "first",
                      self.T - chk["last_steps"]: "last_in", self.T: "end"}
        self.snaps = {}
        self.chain, self.k, self.steps = -1, 0, 0
        ahead = cell.traffic.get("max_ahead", 4)
        self.ring = ([torch.cuda.Event() for _ in range(ahead)]
                     if device.type == "cuda" else [])
        self._next_chain()

    def _next_chain(self):
        self.chain += 1
        self.k = 0
        self.g = torch.Generator(device=self.device).manual_seed(
            derive(self.seed, "chain", self.chain))
        x = torch.randn(self.plan.draw_shape, generator=self.g,
                        device=self.device)
        self.plan.start(x, _labels(self.cell.config, self.cell.traffic,
                                   self.seed, self.chain, self.device))

    def step(self):
        if self.ring:                       # at most len(ring) steps ahead
            ev = self.ring[self.steps % len(self.ring)]
            ev.synchronize()
        if self.plan.draws_noise:
            self.plan.draw(self.g)
        self.sampler.step()
        self.k += 1
        self.steps += 1
        if self.chain == 0 and self.k in self.marks:
            self.snaps[self.marks[self.k]] = _state(self.plan)
        if self.ring:
            ev.record()
        if self.k == self.T:
            self._next_chain()


def run(cell, opt) -> dict:
    dev, tr, cfg = opt.device, cell.traffic, cell.config
    sampler, plan, models = build(cell, opt.seed, dev)
    with torch.no_grad():                  # the captured step, once more
        plan.start(torch.zeros(plan.draw_shape, device=dev), plan.y)
        for _ in range(2):
            if plan.draws_noise:
                plan.draw(None, torch.zeros(plan.shape, device=dev))
            sampler.step()
    _sync(dev)
    work = Chains(cell, opt.seed, sampler, plan, dev)
    setup_s = time.perf_counter() - opt.t0
    window = None
    marks = [0.25, 0.5, 0.75] if opt.trace else []
    tic = time.perf_counter()
    deadline = tic + opt.seconds
    with torch.no_grad():
        while time.perf_counter() < deadline:
            if marks and time.perf_counter() >= tic + marks[0] * opt.seconds:
                marks.pop(0)
                w = trace.profile(lambda: _traced(work, tr))
                if window is None or len(w.device) > len(window.device):
                    window = w
            work.step()
        _sync(dev)
    wall = time.perf_counter() - tic
    out = {"setup_s": setup_s, "window_s": wall, "window": window,
           "attempted": (work.chain + 1) * tr["batch"], "failed": 0,
           "e2e": {"samples_per_s": work.steps * tr["batch"] / work.T
                   / wall},
           "memory_peak_bytes": _peak(dev)}
    out["static"] = _static(cell)
    produced = dict(work.snaps)
    del sampler, plan, models, work
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_tic = time.perf_counter()
    ref_out = reference_segments(cell, opt.seed, dev, produced)
    out["reference_s"] = time.perf_counter() - ref_tic
    out["readings"] = readings(cell, opt.seed, produced, ref_out)
    out["controls"] = {
        mode: readings(cell, opt.seed,
                       reference_segments(cell, opt.seed, dev, produced, mode),
                       ref_out, rows_selected=True)
        for mode in getattr(opt, "controls", ())}
    out["faults"] = {
        f: readings(cell, opt.seed,
                    reference_segments(cell, opt.seed, dev, produced,
                                       fault=f),
                    ref_out, rows_selected=True)
        for f in getattr(opt, "faults", ())}
    return out


# faults of SuperDiff's mixing weights: ``(logq, logq a step earlier) ->
# kappa``
FAULTS = {
    "hard_mix": lambda lq, prev: torch.nn.functional.one_hot(
        lq.argmax(dim=0), lq.shape[0]).T.to(lq.dtype),
    "stale_logq": lambda lq, prev: torch.softmax(prev, dim=0),
}


def _traced(work, tr):
    n = tr.get("trace_steps", 20)
    for _ in range(n):
        work.step()
    return {"steps": n, "calls": n * tr["models"]}


def _static(cell):
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    return {"flops_per_call": counts.forward_flops(ref, cfg, tr["batch"]),
            "b4_chains": counts.b4_chains(ref, cfg, tr["batch"]),
            "b4_elt_bytes": 2 if cfg["sampling_norm_dtype"] == "bfloat16"
            else 4}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reference_segments(cell, seed, dev, produced, mode="f32", fault=None):
    """The reference's states of chain 0 at the compared positions: from
    ``x_T`` over the first steps, and from the program's state
    ``produced["last_in"]`` over the last ones; rows ``rows(cell, seed)``.
    ``mode`` is the products' precision (a control lowers it); ``fault``
    names one of ``FAULTS``."""
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    prec = Precision(mode)
    sched = diffusion.Schedule(cfg, dev)
    T, chk = sched.T, tr["check"]
    rows = _rows(cell, seed)
    specs = ref.param_specs(cfg)
    Ps = [stored(weights.make(specs, derive(seed, "weights", m), dev),
                 cfg.get("sampling_weights"))
          for m in range(tr["models"])]
    y = _labels(cfg, tr, seed, 0, dev)
    y = None if y is None else y[rows]
    g = torch.Generator(device=dev).manual_seed(derive(seed, "chain", 0))
    shape = (tr["batch"], cfg["resolution"], cfg["resolution"],
             cfg["in_channels"])
    x = torch.randn(shape, generator=g, device=dev)[rows]
    superdiff = tr["sampler"] == "superdiff"
    logq = (diffusion.logq_start(x)[None].repeat(tr["models"], 1)
            if superdiff else None)
    out = {"start_logq": logq}
    gap = (torch.full((x.shape[0],), float("inf"), device=dev)
           if superdiff else None)
    prev = logq
    with torch.no_grad(), prec.context():
        for k in range(T):
            z = torch.empty(shape, device=dev).normal_(generator=g)[rows]
            if k == T - chk["last_steps"]:
                if "last_in" not in produced:
                    break
                xp, lp = produced["last_in"]
                x = xp[rows].float()
                logq = None if lp is None else lp[:, rows].float()
            if k >= chk["first_steps"] and k < T - chk["last_steps"]:
                continue
            t = T - 1 - k
            tt = torch.full((x.shape[0],), t, dtype=torch.long, device=dev)
            eps = [ref.forward(P, cfg, x, tt, y, prec) for P in Ps]
            if superdiff:
                if 0 < k < chk["first_steps"]:
                    top = logq.topk(2, dim=0).values
                    gap = torch.minimum(gap, top[0] - top[1])
                kappa = FAULTS[fault](logq, prev) if fault else None
                prev = logq
                x, logq = diffusion.superdiff_or_update(sched, x, logq, t,
                                                        eps, z, kappa=kappa)
            else:
                x = diffusion.ddpm_update(sched, x, t, eps[0], z)
            if k + 1 == chk["first_steps"]:
                out["first"] = (x.clone(), None if logq is None
                                else logq.clone())
                if superdiff:
                    out["away_from_ties"] = gap >= chk["tie_nats"]
            if k + 1 == T:
                out["end"] = (x.clone(), None if logq is None
                              else logq.clone())
    return out


def _rows(cell, seed):
    g = torch.Generator().manual_seed(derive(seed, "rows"))
    n = cell.traffic["check"]["rows"]
    return sorted(torch.randperm(cell.traffic["batch"], generator=g)[:n]
                  .tolist())


def readings(cell, seed, produced, ref_out, rows_selected=False) -> dict:
    """The compared numbers of ``produced`` (the program's states, all
    rows, or only the compared ones with ``rows_selected``) against the
    reference's."""
    rows = slice(None) if rows_selected else _rows(cell, seed)
    keep = ref_out.get("away_from_ties")
    r = {}
    for name in cell.traffic["check"]["segments"]:
        tag = "first" if name == "first" else "end"
        if tag not in produced or tag not in ref_out:
            r[f"x_rel_err.{name}"] = float("nan")
            continue
        xp, lp = produced[tag]
        xr, lr = ref_out[tag]
        xp = xp[rows].float()
        if keep is not None and tag == "first":
            r[f"near_tie_rows.{name}"] = float((~keep).sum())
            r[f"x_rel_err_tied.{name}"] = (
                compare.rel_err(xp[~keep], xr[~keep]) if (~keep).any()
                else 0.0)
            xp, xr = xp[keep], xr[keep]
            lp, lr = lp[:, rows][:, keep], lr[:, keep]
            l0 = ref_out["start_logq"][:, keep]
            r[f"dlogq_gap.{name}"] = compare.scaled_gap(lp - l0, lr - l0)
        r[f"x_rel_err.{name}"] = compare.rel_err(xp, xr)
    return r
