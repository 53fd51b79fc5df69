"""Worker processes of the port's parallel tests (imports no JAX).

``run_group(world, cases, workdir)`` starts ``world`` processes of this
file, joined into one ``gloo`` group through the launch contract of
``superdiff_torch.parallel.mesh.maybe_init_distributed`` (the
``SUPERDIFF_TPU_*`` triple on 127.0.0.1). Each process runs the named
cases in order; a case reads its inputs from ``workdir/in.npz`` and
writes ``workdir/<case>_r<rank>.npz``. Every collective has a timeout and
the group a join limit, so a hang fails the test instead of holding the
suite. Inputs and outputs pass as numpy arrays, so the JAX side stays in
the pytest process.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attn_resolutions=(), num_heads=2, num_classes=2,
           time_emb_dim=16, groups=4)
R, T = 16, 50
DROP_P = 0.3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(world: int, cases, workdir: str, timeout: float = 120.0,
              wait: bool = True):
    """Start the group; with ``wait`` join it (raising on a failure or
    when it outlives ``timeout``), else return a function that does."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               SUPERDIFF_TPU_MULTIHOST="1",
               SUPERDIFF_TPU_COORDINATOR=f"127.0.0.1:{port}",
               SUPERDIFF_TPU_NUM_PROCESSES=str(world),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"log_r{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), workdir,
             json.dumps(cases)],
            env=dict(env, SUPERDIFF_TPU_PROCESS_ID=str(rank)),
            stdout=log, stderr=subprocess.STDOUT, cwd=workdir), log))
    start = time.time()

    def join():
        failed = []
        for rank, (p, log) in enumerate(procs):
            try:
                p.wait(max(1.0, timeout - (time.time() - start)))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            log.close()
            if p.returncode != 0:
                with open(os.path.join(workdir, f"log_r{rank}.txt")) as f:
                    failed.append(f"rank {rank} exit {p.returncode}:\n"
                                  + f.read()[-4000:])
        if failed:
            raise RuntimeError("\n".join(failed))

    if wait:
        join()
        return None
    return join


# ----------------------------------------------------------------- cases


def _toy(sd=None):
    import torch

    from superdiff_torch.models.unet import CondUNet

    m = CondUNet(resolution=R, device="cpu", **TOY)
    if sd is not None:
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m


def _inputs(workdir):
    import numpy as np

    with np.load(os.path.join(workdir, "in.npz")) as f:
        return {k: f[k] for k in f.files}


def _params_of(inp, prefix="p/"):
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def _state(inp):
    import torch

    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)

    return create_train_state(
        _toy(_params_of(inp)), torch.Generator().manual_seed(0),
        tx=make_optimizer(learning_rate=1e-3, grad_clip_norm=1.0),
        ema_decay=0.9)


def _save(workdir, name, rank, **arrays):
    import numpy as np

    np.savez(os.path.join(workdir, f"{name}_r{rank}.npz"), **arrays)


def _draws(inp, prefix="d/"):
    import torch

    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inp.items()
            if k.startswith(prefix)}


def case_train_step(rank, workdir, mode="dp", grad_accum=1):
    """One train step of the toy CondUNet on this rank's rows, with the
    whole batch's draws injected: ``mode`` dp, tp (model=2), fsdp, or
    tpfsdp (data=2, model=2). Saves the gathered state, the metrics and
    each leaf's local element count."""
    import torch

    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.parallel import fsdp, make_mesh, shard_batch, tp
    from superdiff_torch.training.steps import make_train_step

    inp = _inputs(workdir)
    mesh = make_mesh(model_parallelism=2 if "tp" in mode else 1,
                     device="cpu")
    st = _state(inp)
    sh = None
    if mode == "tp":
        sh = tp.state_shardings(st, mesh)
        tp.shard_state(st, mesh)
    elif mode in ("fsdp", "tpfsdp"):
        sh = fsdp.state_shardings(st, mesh, tensor_parallel=mode == "tpfsdp")
        fsdp.shard_state(st, mesh, tensor_parallel=mode == "tpfsdp")
    step = make_train_step(make_schedule(T, device="cpu"), mesh=mesh,
                           conditional=True, cfg_drop_prob=DROP_P,
                           null_label=TOY["num_classes"], state_shardings=sh,
                           grad_accum=grad_accum)
    batch = {"image": torch.from_numpy(inp["image"]),
             "label": torch.from_numpy(inp["label"])}
    draws = _draws(inp)
    if grad_accum > 1:
        mb = inp["image"].shape[0] // grad_accum
        draws = [{k: v[i * mb:(i + 1) * mb] for k, v in draws.items()}
                 for i in range(grad_accum)]
    st, m = step(st, shard_batch(batch, mesh), draws)
    from torch.distributed.tensor import DTensor

    local = {f"n/{n}": (p.to_local() if isinstance(p, DTensor) else p
                        ).numel() for n, p in st.model.named_parameters()}
    if sh is None:
        full = {"params": dict(st.model.named_parameters()),
                "ema_params": dict(st.ema_model.named_parameters())}
    else:
        full = tp.gather_state(st, mesh, sh)
    out = {f"{k}/{n}": v.detach().numpy() for k in ("params", "ema_params")
           for n, v in full[k].items()}
    _save(workdir, f"train_{mode}_{grad_accum}", rank, loss=m["loss"].numpy(),
          grad_norm=m["grad_norm"].numpy(), **out, **local)


def case_distill_step(rank, workdir):
    """One data-parallel distillation step (teacher = the toy model)."""
    import torch

    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.distill import make_distill_step
    from superdiff_torch.inference import make_eps_fn_p
    from superdiff_torch.parallel import make_mesh, shard_batch

    inp = _inputs(workdir)
    mesh = make_mesh(device="cpu")
    st = _state(inp)
    teacher = _toy(_params_of(inp)).eval().requires_grad_(False)
    schedule = make_schedule(T, device="cpu")
    step = make_distill_step(schedule, make_eps_fn_p(teacher, "per_sample"),
                             2, mesh=mesh, conditional=True,
                             parameterization="eps", null_prob=0.5,
                             null_label=TOY["num_classes"])
    batch = {"image": torch.from_numpy(inp["image"]),
             "label": torch.from_numpy(inp["label"])}
    st, m = step(st, teacher, shard_batch(batch, mesh))
    _save(workdir, "distill", rank, loss=m["loss"].numpy(),
          grad_norm=m["grad_norm"].numpy(),
          **{f"params/{n}": p.detach().numpy()
             for n, p in st.model.named_parameters()})


def case_tp_ddim(rank, workdir):
    """DDIM-5 sampling with the model split over model=2."""
    import torch

    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.samplers import ddim_sample
    from superdiff_torch.parallel import make_mesh, tp

    inp = _inputs(workdir)
    mesh = make_mesh(model_parallelism=2, device="cpu")
    model = tp.shard_params(_toy(_params_of(inp)).eval(), mesh)
    y = torch.from_numpy(inp["label"])
    out = ddim_sample(make_schedule(T, device="cpu"), model,
                      (y.shape[0], R, R, 1), torch.Generator().manual_seed(3),
                      num_steps=5, y=y)
    _save(workdir, "tp_ddim", rank, x=out.numpy())


def case_cli_sample(rank, workdir, run_dir):
    """``cli.sample --data-parallel`` on the group."""
    from superdiff_torch.cli import sample

    sample.main(["--run-dir", run_dir, "--device", "cpu", "--method",
                 "ddim", "--num-steps", "3", "--batch-size", "4",
                 "--data-parallel", "--out", os.path.join(workdir, "dp_out")])


def case_cli_train(rank, workdir, base):
    """``cli.train --synthetic`` on the group (data-parallel)."""
    from superdiff_torch.cli import train

    train.main(["--synthetic", "--device", "cpu", "--run-id", "dp",
                "--set", "model.preset=small64",
                "--set", "model.base_channels=8",
                "--set", "model.compute_dtype=float32",
                "--set", "training.resolution=16",
                "--set", "training.batch_size=4",
                "--set", "training.num_timesteps=8",
                "--set", "training.num_epochs=1",
                "--set", "training.steps_per_epoch=2",
                "--set", "training.vis_every=0",
                "--set", f"paths.local_base={base}"])


def case_serve(rank, workdir, run_dir):
    """A seeded request through the data-parallel service: rank 0 serves,
    the other ranks follow."""
    from superdiff_torch.cli import serve as serve_cli
    from superdiff_torch.serve import SampleSpec

    args = serve_cli.build_parser().parse_args(
        ["--run-dir", run_dir, "--device", "cpu", "--batch-size", "4",
         "--data-parallel"])
    service, _, _ = serve_cli.load_service(args, autostart=False)
    if rank != 0:
        service.follow()
        return
    req = service.submit(3, label=1, spec=SampleSpec("ddim", 3), seed=7)
    service.step_once()
    service.close()
    _save(workdir, "serve", rank, x=req.result)


def case_shard_batch(rank, workdir):
    """A group of one: the mesh, and ``shard_batch`` of a batch."""
    import numpy as np
    import torch

    from superdiff_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(device="cpu")
    b = shard_batch({"image": np.arange(8.0).reshape(4, 2)}, mesh)
    _save(workdir, "shard_batch", rank, image=b["image"].numpy(),
          shape=np.array([mesh.shape["data"], mesh.shape["model"]]),
          is_tensor=np.array(isinstance(b["image"], torch.Tensor)))


def case_ring(rank, workdir, dtype="float32"):
    """Ring attention over the whole group: the output and the gradients
    of ``sum(out * g)``, this rank's shards."""
    import torch

    from superdiff_torch.parallel import cp, make_mesh

    inp = _inputs(workdir)
    mesh = make_mesh(device="cpu")
    dt = getattr(torch, dtype)
    q, k, v = (cp.shard_sequence(torch.from_numpy(inp[n]).to(dt), mesh)
               .requires_grad_() for n in ("q", "k", "v"))
    out = cp.ring_attention(q, k, v, mesh)
    out.backward(cp.shard_sequence(torch.from_numpy(inp["g"]).to(dt), mesh))
    _save(workdir, f"ring_{dtype}", rank,
          **{n: a.detach().float().numpy() for n, a in (
              ("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))})


def case_ep(rank, workdir, mode="or"):
    """SuperDiff of two toy models, one per rank of ``model``, each rank on
    its ``data`` rows, with the whole batch's draws injected."""
    import torch

    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.samplers import _run_plan
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import make_eps_fn_p
    from superdiff_torch.parallel import ep, make_mesh
    from superdiff_torch.parallel.mesh import gather_rows, local_rows

    inp = _inputs(workdir)
    mesh = make_mesh(model_parallelism=2, device="cpu")
    models = [_toy(_params_of(inp, f"m{i}/")).eval() for i in range(2)]
    fn = ep.make_ep_eps_fn(make_eps_fn_p(models[0], 1), models, mesh)
    shape = tuple(inp["x_init"].shape)
    plan = SuperDiffPlan(make_schedule(8, device="cpu"), fn, shape,
                         mode=mode, num_models=2,
                         rows=local_rows(shape[0], mesh))
    (x, logq), _ = _run_plan(plan, None, torch.from_numpy(inp["x_init"]),
                             list(torch.from_numpy(inp["noise"])))
    _save(workdir, f"ep_{mode}", rank, x=gather_rows(x, mesh).numpy(),
          logq=gather_rows(logq, mesh, dim=1).numpy())


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def _main(workdir, cases):
    import torch
    import torch.distributed as dist

    from superdiff_torch.parallel import maybe_init_distributed

    torch.set_num_threads(1)
    maybe_init_distributed("cpu", timeout_s=60.0)
    rank = dist.get_rank()
    for name, kw in cases:
        CASES[name](rank, workdir, **kw)
    if dist.is_initialized():          # a CLI case leaves the group itself
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], json.loads(sys.argv[2]))
