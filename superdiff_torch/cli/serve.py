"""Serve a trained run over HTTP (counterpart of ``superdiff_tpu.cli.serve``).

Loads a run dir, applies the production sampling dtype policy, captures the
default spec's CUDA graph (warmup) and serves micro-batched requests (see
``superdiff_torch/serve.py`` for the batching and graph model). The flags
are the reference CLI's, without ``--data-parallel`` (one device) and with
``--device`` (default ``cuda``; raises without a card; ``--device cpu``
serves eagerly on the CPU).

Usage:
    python -m superdiff_torch.cli.serve --run-dir RUN --port 8000 \\
        [--batch-size 16] [--method dpmpp --steps 10]

    curl -s localhost:8000/healthz
    curl -s localhost:8000/info
    curl -s -X POST localhost:8000/sample \\
        -d '{"num": 4, "label": 1, "method": "dpmpp", "steps": 10}' \\
        | python -c "import sys, json, base64; r=json.load(sys.stdin); \\
open('out.png','wb').write(base64.b64decode(r['data']))"
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HTTP sampling service")
    p.add_argument("--run-dir", required=True,
                   help="training run dir or exported inference artifact")
    p.add_argument("--run-dir2", default=None,
                   help="second trained run: enables method=superdiff "
                        "(online superposition with Itô log-densities in "
                        "the response)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--best", action="store_true",
                   help="serve the best-validation checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=16,
                   help="fixed device batch (the micro-batching capacity)")
    p.add_argument("--max-wait-ms", type=float, default=20.0,
                   help="coalescing window before a partial batch launches")
    p.add_argument("--method",
                   choices=["ddpm", "ddim", "dpmpp", "superdiff"],
                   default=None,
                   help="spec warmed at startup (default: the run config's "
                        "sampling.method when it names a fast sampler — "
                        "distilled students stamp ddim + their trained "
                        "step count — else ddim)")
    p.add_argument("--mode", choices=["or", "and"], default="or",
                   help="superdiff mixing mode for the warmed spec")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if absent)")
    return p


def load_service(args):
    """``(service, cfg, spec)``: the run(s) loaded on ``args.device`` with
    the sampling policy, the service built, and the spec to warm."""
    from superdiff_torch.inference import (apply_sampling_policy,
                                           check_superpose_compat, load_run,
                                           resolve_sampler_spec)
    from superdiff_torch.serve import SamplerService, SampleSpec

    cfg, model, schedule = load_run(args.run_dir, device=args.device,
                                    step=args.step, best=args.best)
    apply_sampling_policy(model)

    model2 = None
    if args.run_dir2:
        cfg2, model2, _ = load_run(args.run_dir2, device=args.device)
        try:
            # shared forward SDE: T / resolution / beta schedule
            check_superpose_compat(cfg, cfg2)
        except ValueError as e:
            raise SystemExit(f"--run-dir2 incompatible: {e}")
        # conditioning must agree too: the service sends ONE per-slot label
        # vector to both models
        if (cfg2.model.conditional != cfg.model.conditional
                or cfg2.model.num_classes != cfg.model.num_classes):
            raise SystemExit(
                "--run-dir2 conditioning differs (conditional/num_classes "
                "must match --run-dir for superposed serving)")
        apply_sampling_policy(model2)
    elif args.method == "superdiff":
        raise SystemExit("--method superdiff requires --run-dir2")

    # --method omitted: warm a distilled student on the exact spec it
    # trained for; otherwise keep the ddim-50 default. t_spacing and
    # clip_x0 are run-level service policy, not request knobs.
    method, steps, t_spacing, clip_x0 = resolve_sampler_spec(
        cfg, args.method, args.steps,
        allowed=("ddim", "dpmpp"), fallback="ddim")

    service = SamplerService(
        model, schedule, resolution=cfg.training.resolution,
        conditional=cfg.model.conditional, batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms, model2=model2,
        t_spacing=t_spacing, clip_x0=clip_x0)
    steps = steps or (10 if method == "dpmpp" else 50)
    return service, cfg, SampleSpec(method=method, steps=steps,
                                    mode=args.mode)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from superdiff_torch.serve import make_http_server

    service, cfg, spec = load_service(args)
    print(f"warming {spec} at batch {args.batch_size} on {args.device} ...",
          flush=True)
    sec = service.warmup(spec)
    httpd = make_http_server(service, args.host, args.port,
                             info={"run_dir": args.run_dir,
                                   "preset": cfg.model.preset})
    host, port = httpd.server_address[:2]
    print(f"warm ({sec:.1f}s). serving on http://{host}:{port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
