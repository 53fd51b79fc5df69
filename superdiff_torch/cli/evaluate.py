"""Evaluation CLI of the port (counterpart of ``superdiff_tpu.cli.evaluate``):
FID against the test split and SuperDiff log-density statistics.

Samples a run under the production dtype policy through the port's graphed
samplers (one CUDA graph of one step per spec on the card, as
``cli.sample``; ``--method`` / ``--num-steps`` / ``--spacing`` resolved from
the run's stamp, DDIM-100 by default), then scores the samples against the
``test`` split of ``--dataset-root`` under each extractor of a comma list,
on the run's float32 model for the ``diffusion`` features. With
``--run-dir2`` it also samples SuperDiff OR of the two runs and reports the
log-densities. Writes ``eval.json`` with the JAX CLI's keys.

The ``random`` and ``diffusion`` extractors draw from torch's generator, so
their FIDs are comparable between runs of the port, not with the JAX
package's.

Usage:
    python -m superdiff_torch.cli.evaluate --run-dir RUN \
        --dataset-root TREE --num-samples 64 \
        --extractor classifier,resnet18 \
        --extractor-checkpoint classifier=a.npz,resnet18=b.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

EXTRACTORS = ("diffusion", "random", "classifier", "resnet18",
              "densenet121", "hf")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a trained run")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--run-dir2", default=None,
                   help="second run: also evaluate superposed samples")
    p.add_argument("--dataset-root", default=None,
                   help="required for FID (test split as the real set)")
    p.add_argument("--num-samples", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--method", choices=["ddpm", "ddim", "dpmpp"],
                   default=None,
                   help="default: the run config's sampling.method when it "
                        "names a fast sampler, else the ddim-100 FID "
                        "protocol")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--spacing", choices=["auto", "leading", "trailing"],
                   default="auto",
                   help="DDIM grid spacing; auto reads the run config's "
                        "sampling.t_spacing")
    p.add_argument("--extractor", default="diffusion",
                   help="feature space(s) for FID: one name or a comma list "
                        f"of {', '.join(EXTRACTORS)} (sampling runs once; "
                        "each extractor scores the same generated set)")
    p.add_argument("--extractor-checkpoint", default=None,
                   help="local checkpoint for classifier/resnet18/"
                        "densenet121/hf; with a comma list, pair per "
                        "extractor as NAME=PATH")
    p.add_argument("--guidance", type=float, default=1.0,
                   help="classifier-free guidance scale; values != 1 "
                        "sample class-conditionally (implies --labels "
                        "balanced unless set)")
    p.add_argument("--labels", choices=["null", "balanced"], default=None,
                   help="conditioning of the generated samples: 'null' = "
                        "unconditional (default), 'balanced' = cycle "
                        "through the model's classes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="write metrics JSON here (default: <run>/eval.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def parse_checkpoints(spec, names):
    """``--extractor-checkpoint``: ``NAME=PATH`` pairs, or one path for
    every extractor."""
    if not spec:
        return {}
    if "=" in spec:
        out = {}
        for pair in spec.split(","):
            k, _, v = pair.partition("=")
            out[k.strip()] = v.strip()
        return out
    return {e: spec for e in names}


def main(argv=None, record=None) -> int:
    """Run the CLI. ``record``, a dict, receives the seconds of sampling
    (``sample_s``) and of each extractor (``extract_s``), and the
    generated samples (``samples``, NHWC numpy)."""
    args = build_parser().parse_args(argv)

    import torch

    from superdiff_torch.analysis import FeatureExtractor, compute_fid
    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.samplers import (DDIMPlan, DDPMPlan,
                                                    DPMppPlan)
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import (apply_sampling_policy,
                                           check_superpose_compat, load_run,
                                           make_eps_fn_p,
                                           resolve_sampler_spec)

    device = torch.device(args.device)
    record = {} if record is None else record

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg, s_model, schedule = load_run(args.run_dir, device=device)
    # sampling under the production policy (bf16 norms + bf16 weights, as
    # cli.sample ships); the features below use the float32 model
    apply_sampling_policy(s_model)
    R = cfg.training.resolution
    B = args.batch_size
    labels_mode = args.labels or ("balanced" if args.guidance != 1.0
                                  else "null")
    conditional = cfg.model.conditional and labels_mode == "balanced"
    if args.guidance != 1.0 and not cfg.model.conditional:
        raise SystemExit("--guidance needs a class-conditional run")
    if args.guidance != 1.0 and labels_mode == "null":
        raise SystemExit("--guidance != 1 requires --labels balanced "
                         "(CFG steers class-conditional samples)")
    results = {}

    # --- generate ---
    shape = (B, R, R, 1)
    n_classes = max(cfg.model.num_classes, 1)

    def batch_labels(i):
        return torch.as_tensor((np.arange(B) + i * B) % n_classes,
                               dtype=torch.long, device=device)

    if conditional:
        applyp = make_eps_fn_p(s_model, "per_sample", schedule=schedule)
        extra = dict(y=batch_labels(0), guidance_scale=args.guidance,
                     null_label=s_model.null_label)
    else:
        applyp = make_eps_fn_p(s_model, schedule=schedule)
        extra = {}
    fn = lambda *a: applyp(s_model, *a)
    method, num_steps, spacing, clip_x0 = resolve_sampler_spec(
        cfg, args.method, args.num_steps, args.spacing,
        allowed=("ddim", "dpmpp"), fallback="ddim")
    if num_steps is None:
        num_steps = 100
    if method == "ddim":
        plan = DDIMPlan(schedule, fn, shape, num_steps=num_steps,
                        t_spacing=spacing, clip_x0=clip_x0, **extra)
    elif method == "dpmpp":
        plan = DPMppPlan(schedule, fn, shape, num_steps=num_steps,
                         clip_x0=clip_x0, **extra)
    else:
        plan = DDPMPlan(schedule, fn, shape, **extra)
    tic = time.time()
    sampler = GraphedSampler(plan)
    gen = []
    n_batches = (args.num_samples + B - 1) // B
    for i in range(n_batches):
        g = torch.Generator(device=device).manual_seed(args.seed + i)
        x = sampler(g, y=batch_labels(i) if conditional else None)
        gen.append(x.float().cpu().numpy())
    sync()
    record["sample_s"] = time.time() - tic
    gen = np.concatenate(gen)[:args.num_samples]
    record["samples"] = gen
    results["num_generated"] = int(len(gen))
    results["sample_mean"] = float(gen.mean())
    results["sample_std"] = float(gen.std())
    results["labels"] = labels_mode if cfg.model.conditional else "uncond"
    results["guidance"] = float(args.guidance)
    results["sampler"] = method
    if method != "ddpm":
        results["sampler_steps"] = int(num_steps)
    del sampler, plan

    # --- FID vs the test split ---
    if args.dataset_root:
        from superdiff_torch.data import DataModule

        names = [e.strip() for e in args.extractor.split(",") if e.strip()]
        for e in names:
            if e not in EXTRACTORS:
                raise SystemExit(f"unknown extractor {e!r} "
                                 f"(have {EXTRACTORS})")
        ckpts = parse_checkpoints(args.extractor_checkpoint, names)
        dm = DataModule(cfg, args.dataset_root)
        # the probe timestep must exist in the run's schedule
        probe_t = min(100, cfg.training.num_timesteps - 1)
        f_model = None

        def build_extractor(name):
            nonlocal f_model
            if name == "diffusion":
                if f_model is None:
                    _, f_model, _ = load_run(args.run_dir, device=device)
                return FeatureExtractor("diffusion", model=f_model,
                                        schedule=schedule, timestep=probe_t,
                                        device=device)
            if name == "random":
                return FeatureExtractor("random", device=device)
            return FeatureExtractor(name, checkpoint=ckpts.get(name),
                                    device=device)

        gen_batches = [{"image": gen[i:i + B],
                        "label": np.zeros(len(gen[i:i + B]), np.int32)}
                       for i in range(0, len(gen), B)]
        results["fid_by_extractor"] = {}
        record["extract_s"] = {}
        for name in names:
            tic = time.time()
            ex = build_extractor(name)
            real_batches = dm.device_batches("test", None, device=device)
            fid = compute_fid(ex, real_batches, gen_batches,
                              max_samples=args.num_samples)
            sync()
            record["extract_s"][name] = time.time() - tic
            results["fid_by_extractor"][name] = float(fid)
        results["fid"] = results["fid_by_extractor"][names[0]]
        results["fid_extractor"] = names[0]

    # --- superposed log-densities ---
    if args.run_dir2:
        cfg2, s_model2, _ = load_run(args.run_dir2, device=device)
        check_superpose_compat(cfg, cfg2)
        apply_sampling_policy(s_model2)
        # always the null-label (unconditional) densities
        apply1 = make_eps_fn_p(s_model, schedule=schedule)
        apply2 = make_eps_fn_p(s_model2, schedule=schedule)
        fns = [lambda x, t: apply1(s_model, x, t),
               lambda x, t: apply2(s_model2, x, t)]
        sd_sampler = GraphedSampler(SuperDiffPlan(schedule, fns, shape,
                                                  mode="or"))
        g = torch.Generator(device=device).manual_seed(args.seed)
        _, logq = sd_sampler(g)
        logq = logq.float().cpu().numpy()
        results["superdiff"] = {
            "logq_model1_mean": float(logq[0].mean()),
            "logq_model2_mean": float(logq[1].mean()),
            "logq_gap_mean": float((logq[0] - logq[1]).mean()),
            "logq_gap_std": float((logq[0] - logq[1]).std()),
        }

    out_path = args.out or os.path.join(args.run_dir, "eval.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
