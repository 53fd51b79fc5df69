#!/usr/bin/env python3
"""Time the full-width wide256 denoiser call of one checkout on the card.

For comparing two commits within one session on one machine (host times
differ too much between machines to compare across sessions): unpack each
commit into a directory and run, in turn,

    python3 superdiff_torch/tools/time_denoiser.py --root PARENT_DIR
    python3 superdiff_torch/tools/time_denoiser.py --root .
    python3 superdiff_torch/tools/time_denoiser.py --root .
    python3 superdiff_torch/tools/time_denoiser.py --root PARENT_DIR

The package is imported from ``--root``, so the script only uses what the
first slice of the port already had: an exported run dir of seeded random
weights, ``load_run`` and ``apply_sampling_policy``. It prints one JSON line:
the CUDA-event time per call at batch 16 and 256² (``--repeats`` groups of
``--calls`` calls: min, median, max), the device-busy time per call from
``torch.profiler``, and the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True,
                   help="checkout whose superdiff_torch is timed")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=7)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from superdiff_torch import config as tcfg
    from superdiff_torch.compat import flax_params as fp
    from superdiff_torch.inference import apply_sampling_policy, load_run
    from superdiff_torch.models.presets import model_from_config

    cfg = tcfg.Config()
    cfg.model.preset = "wide256"
    cfg.model.num_classes = 2
    cfg.model.conditional = True
    cfg.model.compute_dtype = "bfloat16"
    cfg.training.resolution = 256
    with tempfile.TemporaryDirectory() as run:
        tcfg.save_config(cfg, os.path.join(run, "config.yaml"))
        shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
        fp.export_params(fp.random_params(shapes, 1),
                         os.path.join(run, fp.EXPORT_FILE))
        _, model, _ = load_run(run, device="cuda")
    apply_sampling_policy(model)
    B = args.batch
    x = torch.randn((B, 256, 256, 1), device="cuda")
    t = torch.full((B,), 500, device="cuda", dtype=torch.long)
    y = torch.zeros((B,), device="cuda", dtype=torch.long)
    times = []
    with torch.no_grad():
        for _ in range(5):
            model(x, t, y)
        for _ in range(args.repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.calls):
                model(x, t, y)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / args.calls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                model(x, t, y)
            torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        root=args.root, card=card, batch=B, calls=args.calls,
        call_ms_min=min(times), call_ms_median=statistics.median(times),
        call_ms_max=max(times),
        device_busy_ms_per_call=busy_us / 1e3 / 5 if busy_us
        else "not measured")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
