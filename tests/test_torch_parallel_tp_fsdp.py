"""Tensor parallelism (``superdiff_torch/parallel/tp.py``), FSDP
(``parallel/fsdp.py``) and the two on one ``(data, model)`` mesh, against
the JAX package's steps and the port's replicated step.

The port side runs in spawned ``gloo`` groups of 2 and 4 ranks
(``tests/torch_parallel_worker.py``); the JAX side on the virtual CPU mesh
here, where its DP and TP+FSDP steps compile in threads while the groups
run. Tolerances as ``tests/test_torch_parallel_dp.py``: loss and
``grad_norm`` rtol 1e-5; each parameter leaf within a relative L2 of 1e-5
(plus an RMS of 5e-7 near 0), the key third of the ``qkv`` bias left out.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from superdiff_tpu.data.synthetic import synthetic_xray_batch
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.parallel import fsdp as j_fsdp
from superdiff_tpu.parallel import make_mesh as j_make_mesh
from superdiff_tpu.parallel import shard_batch as j_shard_batch
from superdiff_tpu.parallel import tp as j_tp
from superdiff_tpu.training.state import TrainState as JaxTrainState
from superdiff_tpu.training.state import make_optimizer as j_make_optimizer
from superdiff_tpu.training.steps import make_train_step as j_make_train_step
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.parallel import fsdp, tp
from superdiff_torch.parallel.mesh import Mesh
from superdiff_torch.training.steps import make_train_step

torch.set_num_threads(1)

B = 8
RTOL = 1e-5
MODES = ("tp", "fsdp", "tpfsdp")


def _flax_params(jm, seed=1):
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((B, W.R, W.R, 1)),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))
    return {"params": fp.random_params(shapes, seed)}


def _jax_draws(state_rng, x_shape):
    rng, step_rng = jax.random.split(jnp.asarray(state_rng))
    step_rng = jax.random.fold_in(step_rng, 0)
    loss_rng, drop_rng = jax.random.split(step_rng)
    drop = jax.random.bernoulli(drop_rng, W.DROP_P, (x_shape[0],))
    rng_t, rng_noise = jax.random.split(loss_rng)
    t = jax.random.randint(rng_t, (x_shape[0],), 0, W.T)
    noise = jax.random.normal(rng_noise, x_shape, jnp.float32)
    return {"drop": np.array(drop), "t": np.array(t).astype(np.int64),
            "noise": np.array(noise)}


def _comparable(name, a):
    a = np.asarray(a)
    if name.endswith("qkv.bias"):
        c = a.shape[0] // 3
        return np.concatenate([a[:c], a[2 * c:]])
    return a


def _close(got, want, name, tol=1e-5, atol=5e-7):
    a, b = _comparable(name, got), _comparable(name, want)
    assert (np.linalg.norm(a - b) <= tol * np.linalg.norm(b)
            + atol * np.sqrt(a.size)), name


def _load(work, name, rank):
    with np.load(os.path.join(work, f"{name}_r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def _fake_mesh(data, model):
    return Mesh(None, {"data": data, "model": model}, "cpu")


def _torch_dims_of(params, specs, axis):
    """``{torch name: torch dim split over axis, or None}`` from JAX's
    sharding tree of the Flax parameters ``params``."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    shardings = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda a: isinstance(a, jax.sharding.NamedSharding))
    out = {}
    for (path, leaf), sh in zip(leaves, shardings):
        names = tuple(str(k.key) for k in path)[1:]      # under "params"
        key, perm = fp.torch_key(names, leaf.ndim)
        dims = [i for i, a in enumerate(sh.spec) if a == axis]
        out[key] = None if not dims else (perm.index(dims[0]) if perm
                                          else dims[0])
    return out


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tpfsdp"))
    jm = JaxCondUNet(**W.TOY)
    params = _flax_params(jm)
    tm = W._toy()
    fp.load_state_dict(tm, params)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    imgs, labels = synthetic_xray_batch(B, W.R, seed=1)
    labels = labels.astype(np.int64)
    rng0 = np.array(jax.random.PRNGKey(5))
    draws = _jax_draws(rng0, imgs.shape)
    np.savez(os.path.join(work, "in.npz"), image=imgs, label=labels,
             **{f"p/{k}": v for k, v in sd.items()},
             **{f"d/{k}": v for k, v in draws.items()})
    four = os.path.join(work, "four")
    os.makedirs(four)
    np.savez(os.path.join(four, "in.npz"),
             **dict(np.load(os.path.join(work, "in.npz"))))
    joins = [W.run_group(2, [["train_step", {"mode": "tp"}],
                             ["train_step", {"mode": "fsdp"}],
                             ["tp_ddim", {}]], work, wait=False),
             W.run_group(4, [["train_step", {"mode": "tpfsdp"}]], four,
                         wait=False)]

    tx = j_make_optimizer(learning_rate=1e-3, grad_clip_norm=1.0)
    batch = {"image": jnp.asarray(imgs), "label": jnp.asarray(labels)}
    schedule = j_make_schedule(W.T)

    def state():
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            ema_params=jax.tree_util.tree_map(jnp.copy, params),
            opt_state=tx.init(params), rng=jnp.asarray(rng0),
            apply_fn=jm.apply, tx=tx, ema_decay=0.9)

    jobs = []
    for n, mp, shard in ((2, 1, False), (4, 2, True)):
        mesh = j_make_mesh(n, model_parallelism=mp)
        st, sh = state(), None
        if shard:
            sh = j_fsdp.state_shardings(st, mesh, tensor_parallel=True)
            st = j_fsdp.shard_state(st, mesh, tensor_parallel=True)
        step = j_make_train_step(schedule, mesh=mesh, conditional=True,
                                 cfg_drop_prob=W.DROP_P,
                                 null_label=jm.null_label,
                                 state_shardings=sh)
        b = j_shard_batch(batch, mesh)
        jobs.append((step.lower(st, b), st, b))
    with ThreadPoolExecutor(2) as pool:
        compiled = [pool.submit(lo.compile, compiler_options={
            "xla_backend_optimization_level": 0}) for lo, _, _ in jobs]
        results = [c.result()(st, b) for c, (_, st, b) in zip(compiled,
                                                               jobs)]
    jax_runs = {}
    for name, (new, m) in zip(("dp", "tpfsdp"), results):
        jax_runs[name] = dict(
            params={k: np.array(v) for k, v in fp.from_flax(
                jax.device_get(new.params)).items()},
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    # the port's replicated step
    st = W._state({f"p/{k}": v for k, v in sd.items()})
    step = make_train_step(make_schedule(W.T, device="cpu"),
                           conditional=True, cfg_drop_prob=W.DROP_P,
                           null_label=W.TOY["num_classes"])
    st, m = step(st, {"image": torch.from_numpy(imgs),
                      "label": torch.from_numpy(labels)},
                 {k: torch.from_numpy(v) for k, v in draws.items()})
    for j in joins:
        j()
    return dict(work=work, four=four, sd=sd, labels=labels, jm=jm,
                params=params, jax=jax_runs,
                single={n: p.detach().numpy()
                        for n, p in st.model.named_parameters()},
                single_ema={n: p.detach().numpy()
                            for n, p in st.ema_model.named_parameters()},
                single_loss=m["loss"].item(),
                single_grad_norm=m["grad_norm"].item())


def _run(par, mode, rank):
    return _load(par["four"] if mode == "tpfsdp" else par["work"],
                 f"train_{mode}_1", rank)


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax_and_the_replicated_step(par, mode):
    jref = par["jax"]["tpfsdp" if mode == "tpfsdp" else "dp"]
    for rank in range(4 if mode == "tpfsdp" else 2):
        got = _run(par, mode, rank)
        for want in (jref["loss"], par["single_loss"]):
            np.testing.assert_allclose(got["loss"], want, rtol=RTOL)
        # the global norm: split leaves summed over their axes, replicated
        # leaves counted once
        for want in (jref["grad_norm"], par["single_grad_norm"]):
            np.testing.assert_allclose(got["grad_norm"], want, rtol=RTOL)
        for n, want in par["single"].items():
            _close(got[f"params/{n}"], want, n)
            _close(got[f"params/{n}"], jref["params"][n], n)
            _close(got[f"ema_params/{n}"], par["single_ema"][n], n)


@pytest.mark.parametrize("mode", MODES)
def test_each_rank_holds_its_share_of_the_leaves(par, mode):
    """Local elements per leaf: 1/n of each split leaf (n the product of
    the axes it is split over), the whole of a replicated one; FSDP's
    leaves with no dim the data axis divides are the ones JAX replicates,
    and FSDP2 cuts them into unequal chunks (a difference by design)."""
    m = 2 if "tp" in mode else 1
    d = 2 if "fsdp" in mode else 1
    mesh = _fake_mesh(d, m)
    model = W._toy(par["sd"])
    tp_dims = tp.param_shardings(model, mesh)
    fs_dims = fsdp.param_shardings(model, mesh, tensor_parallel=m > 1)
    padded = set(fsdp.padded_leaves(model, mesh, tensor_parallel=m > 1))
    full = {n: p.numel() for n, p in model.named_parameters()}
    ranks = 4 if mode == "tpfsdp" else 2
    seen = {n: 0 for n in full}
    for rank in range(ranks):
        got = _run(par, mode, rank)
        for n, size in full.items():
            local = int(got[f"n/{n}"])
            share = size // (m if tp_dims[n] is not None else 1)
            if d > 1 and n not in padded:
                share //= d
            if d > 1 and n in padded:
                seen[n] += local
            else:
                assert local == share, (n, local, share)
    if d > 1:
        assert all(seen[n] == full[n] * ranks // d // (
            m if tp_dims[n] is not None else 1) for n in padded)
        assert all(fs_dims[n] is None for n in padded)
    if m > 1:
        assert sum(v is not None for v in tp_dims.values()) == 5 * len(
            [b for b, s in tp.split_blocks(model, m).items() if s])


@pytest.mark.parametrize("tensor_parallel", [False, True])
def test_fsdp_dims_follow_the_jax_rule(par, tensor_parallel):
    """The dim each leaf shards on over ``data``, mapped to the PyTorch
    layout, is the one ``superdiff_tpu.parallel.fsdp.param_shardings``
    picks (and the tensor-parallel dim the one ``tp.param_shardings``
    splits)."""
    n = 4 if tensor_parallel else 2
    mp = 2 if tensor_parallel else 1
    jmesh = j_make_mesh(n, model_parallelism=mp)
    specs = j_fsdp.param_shardings(par["params"], jmesh,
                                   tensor_parallel=tensor_parallel)
    want = _torch_dims_of(par["params"], specs, "data")
    got = fsdp.param_shardings(W._toy(par["sd"]),
                               _fake_mesh(n // mp, mp), tensor_parallel)
    assert got == want
    if tensor_parallel:
        want_tp = _torch_dims_of(
            par["params"], j_tp.param_shardings(par["params"], jmesh),
            "model")
        assert tp.param_shardings(W._toy(par["sd"]),
                                  _fake_mesh(n // mp, mp)) == want_tp


def test_tp_guard_keeps_blocks_whose_groups_would_span_shards():
    """A ResBlock splits only when its channels and its norm_1 group count
    divide by the axis; the toy's 4 groups split over 2 and 4 ranks, not 8
    (JAX's per-leaf guard keys on the channels alone)."""
    model = W._toy()
    assert all(tp.split_blocks(model, 2).values())
    assert all(tp.split_blocks(model, 4).values())
    assert not any(tp.split_blocks(model, 8).values())
    assert all(d is None for d in tp.param_shardings(
        model, _fake_mesh(1, 8)).values())
    leaf = jnp.zeros((3, 3, 4, 2))
    path = (jax.tree_util.DictKey("conv_0"), jax.tree_util.DictKey("kernel"))
    assert j_tp._guarded(j_tp.spec_for_path(path, leaf), leaf,
                         j_make_mesh(8, model_parallelism=4)) == \
        jax.sharding.PartitionSpec()


def test_tp_parts_in_one_process_sum_to_the_block():
    """Both ranks' parts of every ResBlock, built in one process through
    the same slicing, run one after the other with their ``conv_1``
    partial sums added, equal the unsplit block (the card's check of B4
    at the split shapes does the same)."""
    from superdiff_torch.models.layers import ResBlock

    g = torch.Generator().manual_seed(0)
    model = W._toy().init_parameters(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    mesh = _fake_mesh(1, 2)
    parts = [tp.shard_params(W._toy({k: v.numpy() for k, v in
                                     model.state_dict().items()}), mesh,
                             rank=r) for r in range(2)]
    with torch.no_grad():
        for name, block in model.named_modules():
            if not isinstance(block, ResBlock):
                continue
            x = torch.randn(3, 8, 8, block.conv_0.in_channels, generator=g)
            emb = torch.randn(3, block.emb_proj.in_features, generator=g)
            pieces = [p.get_submodule(name) for p in parts]
            partial = []
            pieces[1].tp.reduce = lambda h: partial.append(h) or h
            pieces[1](x, emb)
            pieces[0].tp.reduce = lambda h: h + partial[0]
            torch.testing.assert_close(pieces[0](x, emb), block(x, emb),
                                       rtol=1e-5, atol=1e-5)
            assert pieces[0].conv_0.weight.shape[0] == \
                block.conv_0.weight.shape[0] // 2
            assert pieces[0].norm_1.num_groups == block.norm_1.num_groups // 2


def test_tp_ddim_matches_unsharded(par):
    from superdiff_torch.diffusion.samplers import ddim_sample

    model = W._toy(par["sd"]).eval()
    y = torch.from_numpy(par["labels"])
    ref = ddim_sample(make_schedule(W.T, device="cpu"), model,
                      (B, W.R, W.R, 1), torch.Generator().manual_seed(3),
                      num_steps=5, y=y)
    for rank in range(2):
        got = _load(par["work"], "tp_ddim", rank)["x"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)
