"""Data parallelism of the port (``superdiff_torch/parallel/mesh.py`` and
its wiring into the train and distillation steps, the samplers, the
service and the CLIs) against the JAX package and against the port's own
single-process runs.

The port side runs in spawned ``gloo`` groups (``tests/torch_parallel_worker.py``,
no JAX there); the JAX side runs here on the virtual CPU mesh of
``tests/conftest.py``. The groups start first and run while the references
are computed. Every rank draws the whole batch's random numbers and keeps
its rows, so a data-parallel run equals the single-process run. Loss and
``grad_norm``: rtol 1e-5 (float32, the reductions run in another order).
Parameters after a step: each leaf within a relative L2 of 1e-5 (plus an
RMS of 5e-7 for leaves near 0), against
JAX's step and the port's single-process step alike: Adam divides each
gradient element by its own magnitude, so an element whose gradient is
near zero turns a different summation order into a visible elementwise
difference (``tests/test_torch_training.py`` holds three steps to 1e-4
per leaf the same way, and leaves out the key third of the fused ``qkv``
bias, whose gradient is rounding noise)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from superdiff_tpu.data.synthetic import synthetic_xray_batch
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.parallel import make_mesh as j_make_mesh
from superdiff_tpu.parallel import shard_batch as j_shard_batch
from superdiff_tpu.training.state import TrainState as JaxTrainState
from superdiff_tpu.training.state import make_optimizer as j_make_optimizer
from superdiff_tpu.training.steps import make_train_step as j_make_train_step
from superdiff_torch import config as tcfg
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.diffusion.samplers import DDIMPlan, DDPMPlan
from superdiff_torch.diffusion.superdiff import SuperDiffPlan
from superdiff_torch.models.presets import model_from_config
from superdiff_torch.parallel import mesh as pmesh
from superdiff_torch.training.steps import make_train_step

torch.set_num_threads(1)

B = 8
RTOL = 1e-5


def _flax_params(jm, seed=1):
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((B, W.R, W.R, 1)),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))
    return {"params": fp.random_params(shapes, seed)}


def _jax_draws(state_rng, step, x_shape):
    """The key chain of the JAX train step (float batch, conditional,
    cfg_drop_prob > 0): the draws of the whole batch."""
    rng, step_rng = jax.random.split(jnp.asarray(state_rng))
    step_rng = jax.random.fold_in(step_rng, step)
    loss_rng, drop_rng = jax.random.split(step_rng)
    drop = jax.random.bernoulli(drop_rng, W.DROP_P, (x_shape[0],))
    rng_t, rng_noise = jax.random.split(loss_rng)
    t = jax.random.randint(rng_t, (x_shape[0],), 0, W.T)
    noise = jax.random.normal(rng_noise, x_shape, jnp.float32)
    return {"drop": np.array(drop), "t": np.array(t).astype(np.int64),
            "noise": np.array(noise)}


def _tiny_run(path, seed):
    cfg = tcfg.Config()
    cfg.training.resolution, cfg.training.num_timesteps = 16, 8
    cfg.model.base_channels, cfg.model.num_res_blocks = 8, (1,)
    cfg.model.attn_resolutions = (8,)
    os.makedirs(path, exist_ok=True)
    tcfg.save_config(cfg, os.path.join(path, "config.yaml"))
    shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
    fp.export_params(fp.random_params(shapes, seed),
                     os.path.join(path, fp.EXPORT_FILE))
    return path


def _train_argv(base):
    return ["--synthetic", "--device", "cpu", "--run-id", "dp",
            "--set", "model.preset=small64", "--set", "model.base_channels=8",
            "--set", "model.compute_dtype=float32",
            "--set", "training.resolution=16",
            "--set", "training.batch_size=4",
            "--set", "training.num_timesteps=8",
            "--set", "training.num_epochs=1",
            "--set", "training.steps_per_epoch=2",
            "--set", "training.vis_every=0",
            "--set", f"paths.local_base={base}"]


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _comparable(name, a):
    """The key third of a fused ``qkv`` bias left out (its gradient is zero
    in exact arithmetic: softmax ignores a bias on the keys)."""
    a = np.asarray(a)
    if name.endswith("qkv.bias"):
        c = a.shape[0] // 3
        return np.concatenate([a[:c], a[2 * c:]])
    return a


def _close(got, want, name, tol=1e-5, atol=5e-7):
    """``|got - want| <= tol |want| + atol sqrt(n)`` in L2 over the leaf:
    relative for a leaf of size, an RMS of ``atol`` for one near 0 (a
    zero-initialised bias after a step)."""
    a, b = _comparable(name, got), _comparable(name, want)
    assert (np.linalg.norm(a - b) <= tol * np.linalg.norm(b)
            + atol * np.sqrt(a.size)), (name, _rel_l2(a, b))


def _load(work, name, rank):
    with np.load(os.path.join(work, f"{name}_r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dp"))
    jm = JaxCondUNet(**W.TOY)
    params = _flax_params(jm)
    tm = W._toy()
    fp.load_state_dict(tm, params)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    imgs, labels = synthetic_xray_batch(B, W.R, seed=0)
    labels = labels.astype(np.int64)
    rng0 = np.array(jax.random.PRNGKey(47))
    draws = _jax_draws(rng0, 0, imgs.shape)
    np.savez(os.path.join(work, "in.npz"), image=imgs, label=labels,
             **{f"p/{k}": v for k, v in sd.items()},
             **{f"d/{k}": v for k, v in draws.items()})
    run_dir = _tiny_run(os.path.join(work, "run"), seed=3)
    train_dir = os.path.join(work, "train_dp")
    os.makedirs(train_dir)
    joins = [
        W.run_group(2, [["train_step", {"mode": "dp"}],
                        ["train_step", {"mode": "dp", "grad_accum": 2}],
                        ["distill_step", {}],
                        ["serve", {"run_dir": run_dir}],
                        ["cli_sample", {"run_dir": run_dir}]],
                    work, wait=False),
        W.run_group(2, [["cli_train", {"base": train_dir}]], train_dir,
                    wait=False),
    ]
    one = os.path.join(work, "one")
    os.makedirs(one)
    joins.append(W.run_group(1, [["shard_batch", {}]], one, wait=False))

    # the JAX DP step on a 2-device mesh
    tx = j_make_optimizer(learning_rate=1e-3, grad_clip_norm=1.0)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=tx.init(params), rng=jnp.asarray(rng0),
        apply_fn=jm.apply, tx=tx, ema_decay=0.9)
    mesh = j_make_mesh(2)
    step = j_make_train_step(j_make_schedule(W.T), mesh=mesh,
                             conditional=True, cfg_drop_prob=W.DROP_P,
                             null_label=jm.null_label)
    new, jm_metrics = step(state, j_shard_batch(
        {"image": jnp.asarray(imgs), "label": jnp.asarray(labels)}, mesh))
    jax_params = {k: np.array(v) for k, v in fp.from_flax(
        jax.device_get(new.params)).items()}
    for j in joins:
        j()
    return dict(work=work, sd=sd, imgs=imgs, labels=labels, draws=draws,
                run_dir=run_dir, train_dir=train_dir, one=one,
                jax_params=jax_params,
                jax_loss=float(jm_metrics["loss"]),
                jax_grad_norm=float(jm_metrics["grad_norm"]))


def _single_step(dp, order=None, grad_accum=1):
    """The port's single-process step on the whole batch (rows in
    ``order``) with the same injected draws."""
    st = W._state({f"p/{k}": v for k, v in dp["sd"].items()})
    order = np.arange(B) if order is None else order
    batch = {"image": torch.from_numpy(dp["imgs"][order]),
             "label": torch.from_numpy(dp["labels"][order])}
    draws = {k: torch.from_numpy(v) for k, v in dp["draws"].items()}
    if grad_accum > 1:
        mb = B // grad_accum
        draws = [{k: v[i * mb:(i + 1) * mb] for k, v in draws.items()}
                 for i in range(grad_accum)]
    step = make_train_step(make_schedule(W.T, device="cpu"),
                           conditional=True, cfg_drop_prob=W.DROP_P,
                           null_label=W.TOY["num_classes"],
                           grad_accum=grad_accum)
    st, m = step(st, batch, draws)
    return st, m


def test_dp_step_matches_jax_and_single_process(dp):
    st, m = _single_step(dp)
    for rank in range(2):
        got = _load(dp["work"], "train_dp_1", rank)
        np.testing.assert_allclose(got["loss"], dp["jax_loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], dp["jax_grad_norm"],
                                   rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], m["grad_norm"].item(),
                                   rtol=RTOL)
        for n, p in st.model.named_parameters():
            _close(got[f"params/{n}"], dp["jax_params"][n], n)
            _close(got[f"params/{n}"], p.detach().numpy(), n)


def test_dp_grad_accum_reduces_once_per_step(dp):
    """grad_accum=2 on two ranks: rank r's microbatch i holds global rows
    ``4r + 2i, 4r + 2i + 1``; the gathered microbatch i is the
    single-process microbatch i of the batch in that row order."""
    order = np.array([0, 1, 4, 5, 2, 3, 6, 7])
    st, m = _single_step(dp, order=order, grad_accum=2)
    got = _load(dp["work"], "train_dp_2", 0)
    np.testing.assert_allclose(got["loss"], m["loss"].item(), rtol=RTOL)
    np.testing.assert_allclose(got["grad_norm"], m["grad_norm"].item(),
                               rtol=RTOL)
    for n, p in st.model.named_parameters():
        _close(got[f"params/{n}"], p.detach().numpy(), n)
        np.testing.assert_allclose(got[f"params/{n}"],
                                   _load(dp["work"], "train_dp_2", 1)[
                                       f"params/{n}"], rtol=0, atol=0)


def test_dp_distill_step_matches_single_process(dp):
    from superdiff_torch.diffusion.distill import make_distill_step
    from superdiff_torch.inference import make_eps_fn_p

    st = W._state({f"p/{k}": v for k, v in dp["sd"].items()})
    teacher = W._toy(dp["sd"]).eval().requires_grad_(False)
    step = make_distill_step(make_schedule(W.T, device="cpu"),
                             make_eps_fn_p(teacher, "per_sample"), 2,
                             conditional=True, parameterization="eps",
                             null_prob=0.5, null_label=W.TOY["num_classes"])
    st, m = step(st, teacher, {"image": torch.from_numpy(dp["imgs"]),
                               "label": torch.from_numpy(dp["labels"])})
    for rank in range(2):
        got = _load(dp["work"], "distill", rank)
        np.testing.assert_allclose(got["loss"], m["loss"].item(), rtol=RTOL)
        for n, p in st.model.named_parameters():
            _close(got[f"params/{n}"], p.detach().numpy(), n)


def test_dp_service_matches_one_process(dp):
    from superdiff_torch.cli import serve as serve_cli
    from superdiff_torch.serve import SampleSpec

    args = serve_cli.build_parser().parse_args(
        ["--run-dir", dp["run_dir"], "--device", "cpu", "--batch-size", "4"])
    service, _, _ = serve_cli.load_service(args, autostart=False)
    req = service.submit(3, label=1, spec=SampleSpec("ddim", 3), seed=7)
    service.step_once()
    service.close()
    got = _load(dp["work"], "serve", 0)["x"]
    assert got.shape == (3, 16, 16, 1)
    np.testing.assert_allclose(got, req.result, rtol=1e-5, atol=1e-6)


def test_cli_sample_data_parallel_rank0_writes(dp):
    from superdiff_torch.cli import sample

    out = os.path.join(dp["work"], "one_out")
    sample.main(["--run-dir", dp["run_dir"], "--device", "cpu", "--method",
                 "ddim", "--num-steps", "3", "--batch-size", "4",
                 "--out", out])
    got = np.load(os.path.join(dp["work"], "dp_out", "samples.npy"))
    np.testing.assert_allclose(got, np.load(os.path.join(out,
                                                         "samples.npy")),
                               rtol=1e-5, atol=1e-6)
    assert sorted(os.listdir(os.path.join(dp["work"], "dp_out"))) == [
        "batch0.png", "samples.npy"]
    with open(os.path.join(dp["work"], "log_r1.txt")) as f:
        assert "wrote" not in f.read()
    with open(os.path.join(dp["work"], "log_r0.txt")) as f:
        assert "wrote 4 samples" in f.read()


def test_cli_train_data_parallel_matches_one_process(dp, tmp_path):
    from superdiff_torch.cli import train
    from superdiff_torch.inference import load_run

    train.main(_train_argv(str(tmp_path)))
    runs = [os.path.join(base, "outputs", "PNEUMONIA", "experiment_exp0_run_dp")
            for base in (dp["train_dir"], str(tmp_path))]
    (_, dp_model, _), (_, one_model, _) = (load_run(r, device="cpu")
                                           for r in runs)
    one = dict(one_model.named_parameters())
    for n, p in dp_model.named_parameters():
        _close(p.detach().numpy(), one[n].detach().numpy(), n)
    logs = []
    for run in runs:
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    assert len(logs[0]) == len(logs[1]) == 2        # rank 0 alone logged
    np.testing.assert_allclose(logs[0][1]["val_loss"], logs[1][1]["val_loss"],
                               rtol=RTOL)
    np.testing.assert_allclose(logs[0][0]["avg_loss"], logs[1][0]["avg_loss"],
                               rtol=RTOL)
    with open(os.path.join(dp["train_dir"], "log_r1.txt")) as f:
        assert "steps" not in f.read()              # rank 1 printed nothing


def test_one_process_group_and_shard_batch(dp):
    got = _load(dp["one"], "shard_batch", 0)
    assert got["shape"].tolist() == [1, 1] and bool(got["is_tensor"])
    np.testing.assert_array_equal(got["image"],
                                  np.arange(8.0).reshape(4, 2))


def test_maybe_init_distributed_contract(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("SUPERDIFF_TPU_MULTIHOST", raising=False)
    pmesh.maybe_init_distributed("cpu")                 # no-op
    assert not dist.is_initialized()
    monkeypatch.setenv("SUPERDIFF_TPU_MULTIHOST", "1")
    monkeypatch.setenv("SUPERDIFF_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("SUPERDIFF_TPU_PROCESS_ID", raising=False)
    monkeypatch.setenv("SUPERDIFF_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="SUPERDIFF_TPU_NUM_PROCESSES and "
                                         "SUPERDIFF_TPU_PROCESS_ID"):
        pmesh.maybe_init_distributed("cpu")
    assert not dist.is_initialized()


def test_mesh_without_a_group():
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("data") is None and mesh.rank("model") == 0
    with pytest.raises(ValueError, match="needs a process group"):
        pmesh.make_mesh(model_parallelism=2, device="cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.local_rows(4, mesh) == slice(0, 4)
    assert torch.equal(pmesh.shard_batch({"image": x}, mesh)["image"], x)
    assert torch.equal(pmesh.gather_rows(x, mesh), x)
    assert pmesh.is_main_process()
    from torch.distributed.tensor import Replicate, Shard
    assert pmesh.batch_sharding(mesh) == (Shard(0), Replicate())
    assert pmesh.replicated_sharding(mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("plan_cls", [DDPMPlan, DDIMPlan, SuperDiffPlan])
def test_plan_rows_are_the_rows_of_the_whole_batch(plan_cls):
    """A plan that holds rows 2:4 of a batch of 4 draws the whole batch's
    noise, so its rows equal those of the whole run, bit for bit."""
    from superdiff_torch.diffusion.samplers import _run_plan

    sch = make_schedule(6, device="cpu")

    def eps(x, t, *y):
        return 0.3 * x + 0.01 * t.float().view(-1, 1, 1, 1)

    def build(rows):
        if plan_cls is SuperDiffPlan:
            return SuperDiffPlan(sch, [eps, lambda x, t: -0.2 * x],
                                 (4, 4, 4, 1), rows=rows)
        return plan_cls(sch, eps, (4, 4, 4, 1), rows=rows)

    whole, _ = _run_plan(build(None), torch.Generator().manual_seed(2),
                         None, None)
    part, _ = _run_plan(build(slice(2, 4)), torch.Generator().manual_seed(2),
                        None, None)
    if plan_cls is SuperDiffPlan:
        assert torch.equal(part[1], whole[1][:, 2:4])
        part, whole = part[0], whole[0]
    assert part.shape[0] == 2
    assert torch.equal(part, whole[2:4])
