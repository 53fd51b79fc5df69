"""Serving cells: ``SamplerService`` (the micro-batcher of ``cli.serve``)
at the traffic's batch size and ``max_wait_ms``, one spec, under an open
loop of requests sent by ``submit`` on a schedule drawn from the seed,
whatever the service's progress.

The schedule: ``round(rate_per_s * seconds)`` requests, due at sorted
uniform times over the window (a Poisson process given its count). The
yardstick is one fixed arrival pattern: the times are drawn from the
traffic's ``arrival_seed``, not from ``--seed``, and the seed shuffles
sizes and labels, in the fixed proportions of ``sizes`` and ``labels``,
over those times, so every seed offers the same arrivals and the same
work in another order (arrival times drawn per seed moved the p95 by a
fifth from seed to seed, against a few percent between two runs of one
seed). A request's latency runs from when it was due to when its ``done``
event was seen set (polled every millisecond); requests are waited for up
to a minute past the window's close, and the latency counts the wait; one
that never comes enters the tail as infinite. The generator's lateness
(submit time after due time) is reported on standard error.

What is compared: every completed request's rows are found among the
batches the service launched (``_launch``, the call that also serves the
followers of a data-parallel group, is tapped for each batch's seed,
labels and images): ``rows_unmatched`` counts requests whose rows are not
one launch's consecutive rows, or share rows with another request;
``labels_mismatched`` counts located requests whose slots in their launch
carry another label than their own; ``requests_missing`` counts requests
that never came or failed. On a sample of ``check.requests`` requests
drawn from the seed, the largest in it, the reference samples the same
spec from the launch's ``x_T`` rows and the request's own label
(``x_rel_err``, the worst row); the fault ``label_swap`` gives the
reference each request's next label instead. Traffic keys: ``method``
(``ddim``), ``steps``, ``batch``, ``max_wait_ms``, ``rate_per_s``,
``arrival_seed``, ``sizes`` ([size, share] pairs), ``labels``,
``trace_seconds``, ``check``.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from bench_port.common import program, trace, weights
from bench_port.common.weights import derive
from bench_port.reference import compare, diffusion
from bench_port.reference.precision import Precision, stored

WAIT_PAST_CLOSE_S = 60.0


def _shares(items, n, rng):
    """``n`` items in the proportions of ``items`` ([value, share] pairs;
    largest remainders), shuffled by ``rng``."""
    raw = [s * n for _, s in items]
    counts = [int(r) for r in raw]
    order = sorted(range(len(items)), key=lambda i: raw[i] - counts[i],
                   reverse=True)
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    out = [v for (v, _), c in zip(items, counts) for _ in range(c)]
    rng.shuffle(out)
    return out


def schedule(tr, seed, seconds):
    """``(due offsets in s, sizes, labels)`` of the window's requests."""
    n = max(1, round(tr["rate_per_s"] * seconds))
    due = np.sort(np.random.default_rng(
        derive(tr["arrival_seed"], "arrivals")).uniform(0.0, seconds, n))
    rng = np.random.default_rng(derive(seed, "order"))
    sizes = _shares(tr["sizes"], n, rng)
    labels = _shares([[v, 1.0 / len(tr["labels"])] for v in tr["labels"]],
                     n, rng)
    return due.tolist(), sizes, labels


def run(cell, opt) -> dict:
    from superdiff_torch.serve import SampleSpec, SamplerService

    dev, tr, cfg = opt.device, cell.traffic, cell.config
    specs = cell.reference().param_specs(cfg)
    model = program.build_model(
        cfg, weights.make(specs, derive(opt.seed, "weights", 0), dev), dev,
        sampling=True)
    sched = program.schedule(cfg, dev)
    svc = SamplerService(model, sched, resolution=cfg["resolution"],
                         conditional=cfg["num_classes"] > 0,
                         batch_size=tr["batch"],
                         max_wait_ms=tr["max_wait_ms"])
    spec = SampleSpec(method=tr["method"], steps=tr["steps"])
    batch_s = svc.warmup(spec)
    launches = []
    launch = svc._launch

    def tapped(spec_, labels, seed, *a, **kw):
        imgs, logq = launch(spec_, labels, seed, *a, **kw)
        launches.append((seed, imgs, labels.copy()))
        return imgs, logq

    svc._launch = tapped
    due, sizes, labels = schedule(tr, opt.seed, opt.seconds)
    n = len(due)
    reqs, sent, done = [None] * n, [0.0] * n, [math.inf] * n
    state = {"next": 0, "open": []}

    def pump(until):
        """Send what is due and note what completed, until ``until`` or,
        past the window, until nothing is open."""
        while True:
            now = time.perf_counter()
            i = state["next"]
            while i < n and tic + due[i] <= now:
                reqs[i] = svc.submit(sizes[i], label=labels[i], spec=spec)
                sent[i] = time.perf_counter()
                state["open"].append(i)
                i += 1
            state["next"] = i
            still = []
            for j in state["open"]:
                if reqs[j].done.is_set():
                    done[j] = now
                else:
                    still.append(j)
            state["open"] = still
            if now >= until or (i == n and not still and now >= close):
                return {"served_s": until}
            wake = tic + due[i] if i < n else now + 1e-3
            time.sleep(max(0.0, min(wake - now, 1e-3)))

    setup_s = time.perf_counter() - opt.t0
    stats0 = dict(svc.stats)
    window = None
    tic = time.perf_counter()
    close = tic + opt.seconds
    stats1 = {}

    def until_close():
        pump(close)
        stats1.update(svc.stats)
        return {}

    if opt.trace:
        # the traced span ends the window: the profiler's stop stalls this
        # thread, and past the close nothing is left to send
        pump(close - tr.get("trace_seconds", 2.0))
        window = trace.profile(until_close)
    else:
        until_close()
    pump(close + WAIT_PAST_CLOSE_S)
    svc.close()
    lat = sorted(d - (tic + u) for d, u in zip(done, due))
    p95 = lat[max(0, math.ceil(0.95 * n) - 1)]
    late = sorted(s - (tic + u) for s, u in zip(sent, due))
    print(f"serve: {n} requests due in {opt.seconds} s; generator late by "
          f"median {late[n // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms;"
          f" warm-up batch {batch_s:.3f} s", file=sys.stderr)
    failed = sum(1 for j in range(n) if reqs[j] is None
                 or not reqs[j].done.is_set() or reqs[j].error is not None)
    out = {"setup_s": setup_s, "window_s": opt.seconds, "window": window,
           "attempted": n,
           "failed": failed, "e2e": {"request_p95_s": p95},
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0),
           "service_stats": {k: stats1[k] - stats0[k]
                             for k in ("samples", "batches", "requests")},
           "generator_late_s": {"median": late[n // 2], "max": late[-1]},
           "latency_by_due": [(u, d - (tic + u)) for d, u in zip(done, due)]}
    got = [(r.result, r.num, labels[j]) if r is not None
           and r.result is not None else None for j, r in enumerate(reqs)]
    del svc, model, reqs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    where, unmatched = locate(got, launches)
    null = cfg["num_classes"]
    mislabelled = sum(
        1 for j, (li, slot) in where.items()
        if not (launches[li][2][slot:slot + got[j][1]]
                == (null if got[j][2] is None else got[j][2])).all())
    picked = _sample(cell, opt.seed, got, where)
    ref_tic = time.perf_counter()
    ref_rows = reference_rows(cell, opt.seed, dev, picked, launches)
    out["reference_s"] = time.perf_counter() - ref_tic
    mine = torch.cat([torch.from_numpy(got[p[0]][0]) for p in picked])
    out["readings"] = {"requests_missing": float(failed),
                       "rows_unmatched": float(unmatched),
                       "labels_mismatched": float(mislabelled),
                       "x_rel_err": compare.rel_err(mine.to(dev), ref_rows)}
    out["controls"] = {
        mode: {"x_rel_err": compare.rel_err(
            reference_rows(cell, opt.seed, dev, picked, launches, mode),
            ref_rows)}
        for mode in getattr(opt, "controls", ())}
    out["faults"] = {
        f: {"x_rel_err": compare.rel_err(
            reference_rows(cell, opt.seed, dev, picked, launches, fault=f),
            ref_rows)}
        for f in getattr(opt, "faults", ())}
    return out


def locate(got, launches):
    """``(where, unmatched)``: for each completed request, ``(launch index,
    first slot)`` of its rows among the launches' images; ``unmatched``
    counts the requests whose rows are not one launch's consecutive rows
    or overlap another request's."""
    index = {}
    for li, (_, imgs, _) in enumerate(launches):
        for s in range(imgs.shape[0]):
            index.setdefault(imgs[s].tobytes(), (li, s))
    where, used, unmatched = {}, set(), 0
    for j, g in enumerate(got):
        if g is None:
            continue
        rows, num, _ = g
        hits = [index.get(rows[k].tobytes()) for k in range(num)]
        ok = (hits[0] is not None and all(
            h == (hits[0][0], hits[0][1] + k) for k, h in enumerate(hits))
            and not used & set(hits))
        if ok:
            where[j] = hits[0]
            used |= set(hits)
        else:
            unmatched += 1
    return where, unmatched


def _sample(cell, seed, got, where):
    """``[(request, launch, slot, num, label)]``: ``check.requests``
    located requests drawn from the seed, the largest among them."""
    js = sorted(where)
    rng = np.random.default_rng(derive(seed, "checked"))
    k = min(cell.traffic["check"]["requests"], len(js))
    largest = max(js, key=lambda j: got[j][1])
    rest = [j for j in js if j != largest]
    pick = [largest] + sorted(rng.choice(rest, size=k - 1, replace=False)
                              .tolist()) if k > 1 else [largest]
    return [(j, *where[j], got[j][1], got[j][2]) for j in pick]


def reference_rows(cell, seed, dev, picked, launches, mode="f32",
                   fault=None):
    """The reference's samples of the picked requests' rows: the spec's
    DDIM from each launch's ``x_T`` rows with each request's label (with
    the fault ``label_swap``, the next label of the traffic's)."""
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    prec = Precision(mode)
    P = stored(weights.make(ref.param_specs(cfg),
                            derive(seed, "weights", 0), dev),
               cfg.get("sampling_weights"))
    R, B = cfg["resolution"], tr["batch"]
    xs, ys = [], []
    for _, li, slot, num, label in picked:
        g = torch.Generator(device=dev).manual_seed(launches[li][0])
        x_T = torch.randn((B, R, R, cfg["in_channels"]), generator=g,
                          device=dev)
        xs.append(x_T[slot:slot + num])
        if fault == "label_swap":
            tl = tr["labels"]
            label = tl[(tl.index(label) + 1) % len(tl)]
        ys += [cfg["num_classes"] if label is None else label] * num
    x = torch.cat(xs)
    y = torch.tensor(ys, dtype=torch.long, device=dev)
    s = diffusion.Schedule(cfg, dev)
    grid = diffusion.ddim_grid(s.T, tr["steps"])
    ab = s.ab_host
    with torch.no_grad(), prec.context():
        for k, t in enumerate(grid):
            ab_next = float(ab[grid[k + 1]]) if k + 1 < len(grid) else 1.0
            tt = torch.full((x.shape[0],), int(t), dtype=torch.long,
                            device=dev)
            eps = ref.forward(P, cfg, x, tt, y, prec)
            x = diffusion.ddim_update(s, x, float(ab[t]), ab_next, eps)
    return x
