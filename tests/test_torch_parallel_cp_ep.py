"""Ring attention (``superdiff_torch/parallel/cp.py``) and ensemble
parallelism (``parallel/ep.py``) against the JAX package.

The port runs in one spawned ``gloo`` group of 4 ranks
(``tests/torch_parallel_worker.py``): the ring over all 4, then SuperDiff
OR and AND with one model per rank of ``model`` (``(data=2, model=2)``, each
rank on its rows). The JAX side runs here on the virtual CPU mesh while the
group runs. The ring's hops are the flash kernels' plain versions on the
CPU; float32 values and gradients within 1e-5 of JAX's ring, bfloat16
inputs within the rounding of a bfloat16 output (each hop's output is
rounded to bfloat16 before the float32 merge, as B1 returns it).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion.superdiff import superdiff_sample as j_superdiff
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.parallel import cp as j_cp
from superdiff_tpu.parallel import ep as j_ep
from superdiff_tpu.parallel import make_mesh as j_make_mesh
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.diffusion.superdiff import superdiff_sample
from superdiff_torch.inference import make_eps_fn
from superdiff_torch.parallel import cp, ep
from superdiff_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

SHAPE = (4, W.R, W.R, 1)
QKV = (2, 64, 2, 32)            # (B, S, H, D), S over 4 ranks
SD_T = 8


def _load(work, name, rank):
    with np.load(os.path.join(work, f"{name}_r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def _jax_draws(seed, shape, steps):
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    x_init = np.array(jax.random.normal(init_rng, shape))
    key, noise = rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noise.append(np.array(jax.random.normal(nkey, shape)))
    return x_init, np.stack(noise)


@pytest.fixture(scope="module")
def cpep(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("cpep"))
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal(QKV).astype(np.float32)
                  for _ in range(4))
    jm = JaxCondUNet(**W.TOY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE), jnp.zeros((4,), jnp.int32),
                            jnp.zeros((4,), jnp.int32))
    params = [{"params": fp.random_params(shapes, s)} for s in (1, 2)]
    sds = {}
    for i, p in enumerate(params):
        tm = W._toy()
        fp.load_state_dict(tm, p)
        sds.update({f"m{i}/{n}": a.numpy() for n, a in
                    tm.state_dict().items()})
    x_init, noise = _jax_draws(11, SHAPE, SD_T)
    np.savez(os.path.join(work, "in.npz"), q=q, k=k, v=v, g=g,
             x_init=x_init, noise=noise, **sds)
    join = W.run_group(4, [["ring", {"dtype": "float32"}],
                           ["ring", {"dtype": "bfloat16"}],
                           ["ep", {"mode": "or"}], ["ep", {"mode": "and"}]],
                       work, wait=False)

    # JAX: the ring on 4 devices (output and vjp in one program, run on
    # the float32 inputs and on their bfloat16 roundings), and EP SuperDiff
    # on (data=2, model=2); the three compile in threads
    mesh4 = j_make_mesh(4)

    @jax.jit
    def ring(q_, k_, v_, g_):
        out, vjp = jax.vjp(
            lambda a, b, c: j_cp.ring_attention(a, b, c, mesh4), q_, k_, v_)
        return out, vjp(g_)

    def bf16(a):
        return torch.from_numpy(a).bfloat16().float().numpy()

    meshe = j_make_mesh(4, model_parallelism=2)

    def apply(p, x, t):
        return jm.apply(p, x, t, jnp.full((x.shape[0],), 1, jnp.int32))

    eps_fn = j_ep.make_ep_eps_fn(apply, params, meshe)
    schedule = j_make_schedule(SD_T)

    def run(mode):
        return j_superdiff(schedule, eps_fn, SHAPE, jax.random.PRNGKey(11),
                           mode=mode, num_models=2)

    def rings():
        return [jax.tree_util.tree_map(np.asarray, ring(*args)) for args in (
            (q, k, v, g), tuple(bf16(a) for a in (q, k, v, g)))]

    with ThreadPoolExecutor(3) as pool:
        jobs = {m: pool.submit(lambda m=m: jax.jit(lambda: run(m))())
                for m in ("or", "and")}
        ring_job = pool.submit(rings)
        jax_ep = {m: tuple(np.asarray(a) for a in f.result())
                  for m, f in jobs.items()}
        (ring_out, ring_grads), ring_bf16 = ring_job.result()
    join()
    return dict(work=work, q=q, k=k, v=v, g=g, ring_out=ring_out,
                ring_grads=ring_grads, ring_bf16=ring_bf16, jax_ep=jax_ep,
                sds=sds,
                x_init=x_init, noise=noise)


def _ring_whole(cpep, dtype):
    parts = [_load(cpep["work"], f"ring_{dtype}", r) for r in range(4)]
    return {n: np.concatenate([p[n] for p in parts], axis=1)
            for n in ("out", "dq", "dk", "dv")}


def test_ring_values_and_gradients_match_jax_f32(cpep):
    got = _ring_whole(cpep, "float32")
    np.testing.assert_allclose(got["out"], cpep["ring_out"], rtol=1e-5,
                               atol=1e-5)
    for name, want in zip(("dq", "dk", "dv"), cpep["ring_grads"]):
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_ring_bf16_inputs(cpep):
    """bfloat16 q/k/v (and output gradient): within 2^-7 relative of JAX's
    float32 ring on the same rounded inputs, gradients within 2^-6 (the
    backward's dS and P are rounded to bfloat16 as the kernels do)."""
    got = _ring_whole(cpep, "bfloat16")
    want, grads = cpep["ring_bf16"]
    assert np.abs(got["out"] - want).max() <= 2 ** -7 * np.abs(want).max()
    for name, w in zip(("dq", "dk", "dv"), grads):
        assert np.abs(got[name] - w).max() <= 2 ** -6 * np.abs(w).max(), name


def test_ring_rejects_an_indivisible_sequence():
    mesh = Mesh(None, {"data": 4, "model": 1}, "cpu")
    with pytest.raises(ValueError, match="sequence 30 not divisible by "
                                         "data=4"):
        cp.shard_sequence(torch.zeros(1, 30, 2, 32), mesh)
    with pytest.raises(ValueError, match="share one shape"):
        cp.ring_attention(torch.zeros(1, 8, 2, 32), torch.zeros(1, 4, 2, 32),
                          torch.zeros(1, 8, 2, 32), mesh)


def test_ring_of_one_is_attention():
    """Without a group the ring is one hop: the flash forward and backward
    (the plain versions here) on the whole sequence."""
    from superdiff_torch.ops.attention import _math_attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 2, 32, generator=g).requires_grad_()
               for _ in range(3))
    mesh = Mesh(None, {"data": 1, "model": 1}, "cpu")
    out = cp.ring_attention(q, k, v, mesh)
    ref = _math_attention(q, k, v)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    gq = torch.autograd.grad(out.sum(), q)[0]
    torch.testing.assert_close(gq, torch.autograd.grad(ref.sum(), q)[0],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["or", "and"])
def test_ep_superdiff_matches_jax_and_the_sequential_path(cpep, mode):
    """Samples and Itô log-densities on (data=2, model=2): JAX's EP run and
    the port's sequential per-model calls on the same draws. float32; logq
    is ~-800 after 8 steps of 256-term dot products."""
    jx, jlq = cpep["jax_ep"][mode]
    models = [W._toy({n[3:]: a for n, a in cpep["sds"].items()
                      if n.startswith(f"m{i}/")}).eval() for i in range(2)]
    tx, tlq = superdiff_sample(
        make_schedule(SD_T, device="cpu"),
        [make_eps_fn(m, 1) for m in models], SHAPE, mode=mode,
        x_init=torch.from_numpy(cpep["x_init"]),
        noise=list(torch.from_numpy(cpep["noise"])))
    for rank in range(4):
        got = _load(cpep["work"], f"ep_{mode}", rank)
        for want_x, want_lq in ((jx, jlq), (tx.numpy(), tlq.numpy())):
            np.testing.assert_allclose(got["x"], want_x, rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got["logq"], want_lq, rtol=1e-5,
                                       atol=1e-3)


def test_ep_rejects_a_wrong_model_count():
    mesh = Mesh(None, {"data": 1, "model": 2}, "cpu")
    with pytest.raises(ValueError, match="3 models need mesh model=3, "
                                         "have 2"):
        ep.make_ep_eps_fn(lambda m, x, t: x, [None] * 3, mesh)
