"""Sampling cells of a text-conditioned model (Stable Diffusion's UNet):
DDIM chains with classifier-free guidance over a text context, captured as
one CUDA graph of one step (``GraphedSampler`` over a ``DDIMPlan`` whose
conditioning is a float context buffer and a null context) and run back to
back for the window, each chain from a fresh seeded ``x_T`` and fresh
seeded contexts, copied into the plan's buffers by ``plan.start``. Each
step is one denoiser call of ``2 * batch`` rows (the conditional and the
null halves). The host runs at most ``max_ahead`` steps ahead of the card.

The model is built as the port's sampling entry points leave it (the
preset at the configuration's widths, seeded float32 weights loaded,
channels-last convolutions, ``apply_sampling_policy``), and sampled through
``make_eps_fn_p``'s context mode, ``DDIMPlan`` and ``GraphedSampler``.

What is compared (``x_rel_err.first``, ``x_rel_err.last``): of chain 0, on
``check.rows`` rows drawn from the seed, the state after the first
``check.first_steps`` steps against the reference run from the same
``x_T``, contexts and grid; and, where chain 0 ends inside the window, its
output against the reference run over the last ``check.last_steps`` steps
from the program's state at their start (``drivers/sample.py``'s
readings). Contexts: ``(batch, context_len, cross_attention_dim)`` N(0, 1)
per chain and one ``(context_len, cross_attention_dim)`` null context, from
the seed. Traffic keys: ``sampler`` (``ddim``), ``steps``, ``eta``,
``clip_x0``, ``guidance_scale``, ``batch``, ``contexts``
(``seeded_normal``), ``max_ahead``, ``trace_steps``, ``check``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_port.common import attn_counts, trace, weights
from bench_port.common.weights import derive
from bench_port.drivers.sample import Chains, _peak, _rows, _sync, readings
from bench_port.reference import diffusion
from bench_port.reference.precision import Precision, stored

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _contexts(cfg, tr, seed, chain, device):
    if tr.get("contexts") != "seeded_normal":
        raise ValueError(f"unknown contexts {tr.get('contexts')!r}")
    g = torch.Generator(device=device).manual_seed(
        derive(seed, "contexts", chain))
    return torch.randn((tr["batch"], cfg["context_len"],
                        cfg["cross_attention_dim"]), generator=g,
                       device=device)


def _null_context(cfg, seed, device):
    g = torch.Generator(device=device).manual_seed(
        derive(seed, "null_context"))
    return torch.randn((cfg["context_len"], cfg["cross_attention_dim"]),
                       generator=g, device=device)


def build_model(cfg, P, device):
    """The program's model of ``cfg`` holding the float32 weights ``P`` on
    ``device``, as the sampling entry points leave it."""
    from superdiff_torch.inference import apply_sampling_policy
    from superdiff_torch.models.presets import build_model as build

    model = build(
        cfg["preset"], num_classes=0,
        compute_dtype=_DTYPES[cfg["compute_dtype"]],
        resolution=cfg["sample_size"], device="meta",
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg["layers_per_block"],
        attention_head_dim=tuple(cfg["attention_head_dim"]),
        cross_attention_levels=tuple(k.startswith("CrossAttn")
                                     for k in cfg["down_block_types"]),
        cross_attention_dim=cfg["cross_attention_dim"],
        norm_num_groups=cfg["norm_num_groups"], norm_eps=cfg["norm_eps"],
        freq_shift=cfg["freq_shift"])
    model = model.to_empty(device=device)
    model.load_state_dict(P, strict=True)
    model = model.float().eval()
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d) and device.type == "cuda":
            m.weight.data = m.weight.data.contiguous(
                memory_format=torch.channels_last)
    return apply_sampling_policy(model)


def build(cell, seed, device):
    """``(sampler, plan, model, B1 launches of the captured step)``."""
    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.samplers import DDIMPlan
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.inference import make_eps_fn
    from superdiff_torch.ops import flash_attention as fa

    cfg, tr = cell.config, cell.traffic
    if tr["sampler"] != "ddim":
        raise ValueError(f"unknown sampler {tr['sampler']!r}")
    sched = make_schedule(cfg["num_train_timesteps"],
                          kind=cfg["beta_schedule"],
                          beta_start=cfg["beta_start"],
                          beta_end=cfg["beta_end"], device=device)
    P = weights.make(cell.reference().param_specs(cfg),
                     derive(seed, "weights", 0), device)
    model = build_model(cfg, P, device)
    del P
    R = cfg["sample_size"]
    # the buffer starts as the null context: every chain's contexts,
    # chain 0's too, reach the captured step only through ``plan.start``
    null = _null_context(cfg, seed, device)
    plan = DDIMPlan(sched, make_eps_fn(model, "context"),
                    (tr["batch"], R, R, cfg["in_channels"]),
                    num_steps=tr["steps"], eta=tr["eta"],
                    clip_x0=tr["clip_x0"], t_spacing="leading",
                    y=null.expand(tr["batch"], *null.shape),
                    guidance_scale=tr["guidance_scale"], null_context=null)
    fa.reset_launches()
    sampler = GraphedSampler(plan)
    captured = dict(fa.captured_by_shape)
    return sampler, plan, model, captured


class ContextChains(Chains):
    """``drivers/sample.py``'s chains, each starting from fresh seeded
    contexts instead of labels."""

    def _next_chain(self):
        self.chain += 1
        self.k = 0
        self.g = torch.Generator(device=self.device).manual_seed(
            derive(self.seed, "chain", self.chain))
        x = torch.randn(self.plan.draw_shape, generator=self.g,
                        device=self.device)
        self.plan.start(x, _contexts(self.cell.config, self.cell.traffic,
                                     self.seed, self.chain, self.device))


def _traced(work, tr):
    n = tr.get("trace_steps", 10)
    for _ in range(n):
        work.step()
    return {"steps": n, "calls": n}


def _static(cell, captured):
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    rows = 2 * tr["batch"] if tr["guidance_scale"] != 1.0 else tr["batch"]
    return {"flops_per_call": attn_counts.forward_flops(ref, cfg, rows),
            "b1_launches": attn_counts.b1_launches(ref, cfg, rows),
            "b1_captured": captured,
            "b1_elt_bytes": 2 if cfg["compute_dtype"] == "bfloat16" else 4,
            "b4_chains": attn_counts.b4_chains(ref, cfg, rows),
            "b4_elt_bytes": 2 if cfg["sampling_norm_dtype"] == "bfloat16"
            else 4}


def run(cell, opt) -> dict:
    dev, tr = opt.device, cell.traffic
    sampler, plan, model, captured = build(cell, opt.seed, dev)
    with torch.no_grad():                  # the captured step, once more
        plan.start(torch.zeros(plan.draw_shape, device=dev))
        for _ in range(2):
            plan.draw(None, torch.zeros(plan.shape, device=dev))
            sampler.step()
    _sync(dev)
    work = ContextChains(cell, opt.seed, sampler, plan, dev)
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
    out["static"] = _static(cell, captured)
    produced = dict(work.snaps)
    del sampler, plan, model, work
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
    out["faults"] = {}
    return out


def reference_segments(cell, seed, dev, produced, mode="f32"):
    """The reference's states of chain 0 at the compared positions: from
    ``x_T`` over the first steps, and from the program's state
    ``produced["last_in"]`` over the last ones; rows ``_rows(cell, seed)``.
    ``mode`` is the products' precision (a control lowers it); cuDNN's
    algorithm search is off (it costs more than the ten calls it would
    speed up). Guidance:
    the conditional and null halves as one call of twice the rows, the
    guided eps ``e_null + s (e_cond - e_null)``, DDIM with eta 0 on the
    leading grid, its last step to ``alpha_bar = 1``, tables rounded to
    float32 once."""
    cfg, tr = cell.config, cell.traffic
    ref = cell.reference()
    prec = Precision(mode, search=False)
    chk, T = tr["check"], tr["steps"]
    rows = _rows(cell, seed)
    P = stored(weights.make(ref.param_specs(cfg), derive(seed, "weights", 0),
                            dev), cfg.get("sampling_weights"))
    ab = ref.alpha_bars(cfg).astype(np.float32).astype(np.float64)
    ts = diffusion.ddim_grid(cfg["num_train_timesteps"], T)
    ctx = _contexts(cfg, tr, seed, 0, dev)[rows]
    ctx2 = torch.cat([ctx, _null_context(cfg, seed, dev).expand(ctx.shape)])
    g = torch.Generator(device=dev).manual_seed(derive(seed, "chain", 0))
    R = cfg["sample_size"]
    x = torch.randn((tr["batch"], R, R, cfg["in_channels"]), generator=g,
                    device=dev)[rows]
    s = tr["guidance_scale"]
    out = {}
    with torch.no_grad(), prec.context():
        for k in range(T):
            if k == T - chk["last_steps"]:
                if "last_in" not in produced:
                    break
                x = produced["last_in"][0][rows].float()
            if chk["first_steps"] <= k < T - chk["last_steps"]:
                continue
            t = int(ts[k])
            ab_next = float(ab[ts[k + 1]]) if k + 1 < T else 1.0
            tt = torch.full((2 * x.shape[0],), t, dtype=torch.long,
                            device=dev)
            e_c, e_u = ref.forward(P, cfg, torch.cat([x, x]), tt, ctx2,
                                   prec).chunk(2)
            x = diffusion.ddim_update(None, x, float(ab[t]), ab_next,
                                      e_u + s * (e_c - e_u), clip=False)
            if k + 1 == chk["first_steps"]:
                out["first"] = (x.clone(), None)
            if k + 1 == T:
                out["end"] = (x.clone(), None)
    return out
