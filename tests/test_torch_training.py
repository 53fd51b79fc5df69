"""Optimizer, train step and eval step of the port against the JAX package
(CPU, float32, the toy CondUNet of ``tests/test_torch_models.py``). Both
start from the same seeded numpy parameters and see the same batch; the
random draws of JAX's step (label-drop mask, timesteps, noise) are replayed
from its key chain and injected into the port's step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from superdiff_tpu.data.synthetic import synthetic_xray_batch
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion.process import training_step as j_training_step
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_tpu.training.state import TrainState as JaxTrainState
from superdiff_tpu.training.state import make_optimizer as j_make_optimizer
from superdiff_tpu.training.steps import make_train_step as j_make_train_step
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.data.transforms import prepare_batch
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.training.state import (
    create_train_state, ema_update, make_lr_schedule, make_optimizer)
from superdiff_torch.training.steps import make_eval_step, make_train_step

torch.set_num_threads(1)

TOY = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attn_resolutions=(8,), num_heads=2, num_classes=2,
           time_emb_dim=16, groups=4)
T, B, R = 50, 4, 16
DROP_P = 0.3


def _batch(seed=0, n=B):
    imgs, labels = synthetic_xray_batch(n, R, seed=seed)
    return imgs, labels.astype(np.int64)


def _t_batch(imgs, labels):
    return {"image": torch.from_numpy(imgs), "label": torch.from_numpy(labels)}


def _flax_params(jm, seed=1):
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((B, R, R, 1)),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))
    return {"params": fp.random_params(shapes, seed)}


def _torch_state(params, **opt_kw):
    tm = CondUNet(resolution=R, device="cpu", **TOY)
    fp.load_state_dict(tm, params)
    return create_train_state(tm, torch.Generator().manual_seed(0),
                              tx=make_optimizer(**opt_kw), ema_decay=0.9)


def _jax_draws(state_rng, step, x_shape):
    """Replay the key chain of the JAX train step (float batch, conditional,
    cfg_drop_prob > 0): returns the next state key and the draws."""
    rng, step_rng = jax.random.split(jnp.asarray(state_rng))
    step_rng = jax.random.fold_in(step_rng, step)
    loss_rng, drop_rng = jax.random.split(step_rng)
    drop = jax.random.bernoulli(drop_rng, DROP_P, (x_shape[0],))
    rng_t, rng_noise = jax.random.split(loss_rng)
    t = jax.random.randint(rng_t, (x_shape[0],), 0, T)
    noise = jax.random.normal(rng_noise, x_shape, jnp.float32)
    draws = {"drop": torch.from_numpy(np.array(drop)),
             "t": torch.from_numpy(np.array(t)).long(),
             "noise": torch.from_numpy(np.array(noise))}
    return rng, loss_rng, draws


def _comparable(path, a):
    """Drop the key third of a fused ``qkv`` bias: softmax is invariant to a
    bias on the keys, so that gradient is zero in exact arithmetic and pure
    rounding noise in float32, which Adam then normalises into full-size
    steps; the two frameworks cannot agree on it."""
    if tuple(path[-2:]) == ("qkv", "bias"):
        c = a.shape[0] // 3
        return np.concatenate([a[:c], a[2 * c:]])
    return a


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


# ------------------------------------------------------------- optimizer ---

@pytest.mark.parametrize("kw", [
    dict(),
    dict(warmup_steps=3),
    dict(schedule="cosine", total_steps=8, warmup_steps=2),
    dict(schedule="cosine", total_steps=1),
    dict(weight_decay=0.01),
    dict(grad_clip_norm=1.0),
    dict(weight_decay=0.01, grad_clip_norm=1.0, schedule="cosine",
         total_steps=100, warmup_steps=10),
], ids=["constant", "warmup", "cosine", "cosine_one_step", "adamw", "clip",
        "all"])
def test_make_optimizer_matches_optax(kw):
    """The same gradient sequence through optax's chain and the port's
    Optimizer: parameters and Adam moments after every step. The gradient
    norms straddle the clip threshold. rtol 1e-5: the same float32 formulas
    with a few roundings placed differently (optax scales the update by
    -lr before adding; the learning rate is float64 on the host here);
    atol 5e-7 is a few float32 ulps of the O(1) parameters, against updates
    of 1e-2 per step."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[(scale * rng.standard_normal(p.shape)).astype(np.float32)
              for p in p0] for scale in (0.05, 3.0, 0.5, 0.01, 2.0, 1.0)]
    tx = j_make_optimizer(learning_rate=1e-2, **kw)
    jp = [jnp.asarray(p) for p in p0]
    jst = tx.init(jp)
    opt = make_optimizer(learning_rate=1e-2, **kw)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tst = opt.init(tp)
    for i, g in enumerate(grads):
        upd, jst = tx.update([jnp.asarray(a) for a in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.update(tp, [torch.from_numpy(a.copy()) for a in g], tst)
        np.testing.assert_allclose(
            norm.item(), np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                     for a in g)), rtol=1e-6)
        adam = jst[1][0] if "grad_clip_norm" in kw else jst[0]
        assert tst["count"] == int(adam.count) == i + 1
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=5e-7)
        for name in ("mu", "nu"):
            for a, b in zip(tst[name], getattr(adam, name)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-7)
    if kw.get("warmup_steps"):      # the first update has rate 0
        assert make_lr_schedule(1e-2, **{k: v for k, v in kw.items() if k in (
            "warmup_steps", "total_steps", "schedule")})(0) == 0.0


def test_make_optimizer_rejects_bad_schedules():
    with pytest.raises(ValueError, match="total_steps"):
        make_optimizer(schedule="cosine")
    with pytest.raises(ValueError, match="unknown lr schedule"):
        make_optimizer(schedule="poly")


def test_ema_update_rule_and_no_aliasing():
    """``eff = min(decay, (1 + step) / (10 + step))`` on the step before the
    increment, as ``superdiff_tpu.training.state.ema_update``."""
    from superdiff_tpu.training.state import ema_update as j_ema

    e = np.array([1.0, 2.0], np.float32)
    p = np.array([3.0, -1.0], np.float32)
    for step, decay in ((0, 0.995), (5, 0.995), (5000, 0.995), (3, 0.2)):
        te = [torch.from_numpy(e.copy())]
        ema_update(te, [torch.from_numpy(p)], decay, step)
        expect = j_ema([jnp.asarray(e)], [jnp.asarray(p)], decay,
                       jnp.asarray(step))
        np.testing.assert_allclose(te[0].numpy(), np.asarray(expect[0]),
                                   rtol=1e-6)
    st = _torch_state(_flax_params(JaxCondUNet(**TOY)))
    ours = {id(p) for p in st.params}
    assert not ours & {id(p) for p in st.ema_params}
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(st.params, st.ema_params))
    assert not any(p.requires_grad for p in st.ema_params)


# ------------------------------------------------------------ train step ---

@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, its parameters, the jitted train step run for 3 steps
    (states and metrics kept), and the gradients of step 0."""
    jm = JaxCondUNet(**TOY)
    params = _flax_params(jm)
    schedule = j_make_schedule(T)
    tx = j_make_optimizer(learning_rate=1e-3, grad_clip_norm=1.0,
                          warmup_steps=2)
    # the jitted step donates its state: keep the key as numpy
    rng0 = np.array(jax.random.PRNGKey(47))    # step 0 drops 2 of 4 labels
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=tx.init(params), rng=jnp.asarray(rng0),
        apply_fn=jm.apply, tx=tx, ema_decay=0.9)
    step_fn = j_make_train_step(schedule, conditional=True,
                                cfg_drop_prob=DROP_P,
                                null_label=jm.null_label)
    batches = [_batch(seed=s) for s in range(3)]
    # gradients of step 0, from the same key chain the step uses
    _, loss_rng, draws0 = _jax_draws(rng0, 0, batches[0][0].shape)
    y0 = np.where(draws0["drop"].numpy(), jm.null_label, batches[0][1])

    def loss_of(p):
        return j_training_step(
            schedule, lambda xt, t, yy: jm.apply(p, xt, t, yy),
            jnp.asarray(batches[0][0]), loss_rng, y=jnp.asarray(y0))

    loss0, grads0 = jax.jit(jax.value_and_grad(loss_of))(params)
    grads0 = jax.tree_util.tree_map(np.asarray, grads0)
    states, metrics = [], []
    for imgs, labels in batches:
        state, m = step_fn(state, {"image": jnp.asarray(imgs),
                                   "label": jnp.asarray(labels)})
        states.append(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "ema_params": state.ema_params,
            "mu": state.opt_state[1][0].mu, "nu": state.opt_state[1][0].nu}))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(model=jm, params=params, rng0=rng0, batches=batches,
                loss0=float(loss0), grads0=grads0, states=states,
                metrics=metrics)


def _port_steps(jax_side, n):
    st = _torch_state(jax_side["params"], learning_rate=1e-3,
                      grad_clip_norm=1.0, warmup_steps=2)
    step_fn = make_train_step(make_schedule(T, device="cpu"),
                              conditional=True, cfg_drop_prob=DROP_P,
                              null_label=st.model.null_label)
    rng, out = jax_side["rng0"], []
    for i in range(n):
        imgs, labels = jax_side["batches"][i]
        rng, _, draws = _jax_draws(rng, i, imgs.shape)
        st, m = step_fn(st, _t_batch(imgs, labels), draws)
        out.append({k: float(v) for k, v in m.items()})
    return st, out


def test_one_step_loss_and_gradients_match_jax(jax_side):
    """Loss, every gradient leaf and ``grad_norm`` of one step from the same
    parameters, batch, t, noise and drop mask. float32 on both sides:
    relative L2 <= 1e-4 per leaf (summation order across ~30 layers)."""
    st = _torch_state(jax_side["params"])
    imgs, labels = jax_side["batches"][0]
    _, _, draws = _jax_draws(jax_side["rng0"], 0, imgs.shape)
    assert draws["drop"].any() and not draws["drop"].all()
    y = torch.where(draws["drop"], torch.full((B,), st.model.null_label),
                    torch.from_numpy(labels))
    from superdiff_torch.diffusion.process import training_step
    loss = training_step(make_schedule(T, device="cpu"), st.model,
                         torch.from_numpy(imgs), y=y, t=draws["t"],
                         noise=draws["noise"])
    grads = torch.autograd.grad(loss, st.params)
    np.testing.assert_allclose(loss.item(), jax_side["loss0"], rtol=1e-5)
    got = fp._leaf_tree(st.model, grads)
    flat_got, flat_exp = fp._flatten(got), fp._flatten(
        jax_side["grads0"]["params"])
    assert set(flat_got) == set(flat_exp)
    for path, g in flat_got.items():
        assert np.abs(flat_exp[path]).max() > 0, path
        assert _rel_l2(g, flat_exp[path]) <= 1e-4, path
    _, m = _port_steps(jax_side, 1)
    np.testing.assert_allclose(m[0]["loss"], jax_side["metrics"][0]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(m[0]["grad_norm"],
                               jax_side["metrics"][0]["grad_norm"], rtol=1e-4)


def test_three_steps_parameters_ema_and_adam_moments_match_jax(jax_side):
    """Parameters, EMA and Adam mu / nu after 3 steps (clip at 1.0, warmup 2,
    so step 0 has rate 0). Relative L2 per leaf: 1e-4 for parameters and
    EMA, 5e-4 for the moments (nu squares the gradient's error)."""
    st, metrics = _port_steps(jax_side, 3)
    assert st.step == 3 and st.opt_state["count"] == 3
    for m, jm in zip(metrics, jax_side["metrics"]):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-3)
    got = fp.train_state_to_numpy(st)
    expect = jax_side["states"][2]
    moved = 0
    for name, tol in (("params", 1e-4), ("ema_params", 1e-4), ("mu", 5e-4),
                      ("nu", 5e-4)):
        g, e = fp._flatten(got[name]), fp._flatten(expect[name]["params"])
        assert set(g) == set(e)
        for path in g:
            assert _rel_l2(_comparable(path, g[path]),
                           _comparable(path, e[path])) <= tol, (name, path)
        if name == "params":
            start = fp._flatten(jax_side["params"]["params"])
            moved = sum(1 for path in g
                        if not np.array_equal(g[path], start[path]))
    assert moved == len(fp._flatten(got["params"]))


def test_grad_accum_is_the_mean_of_microbatch_gradients(jax_side):
    """``grad_accum=2``: one update on the mean of the two microbatch
    gradients, each with its own draws; metrics are the means too."""
    imgs, labels = _batch(seed=5)
    rng = np.random.default_rng(5)
    draws = [{"t": torch.from_numpy(rng.integers(0, T, 2)),
              "noise": torch.from_numpy(rng.standard_normal(
                  (2, R, R, 1)).astype(np.float32)),
              "drop": torch.tensor([i == 0, False])} for i in range(2)]
    schedule = make_schedule(T, device="cpu")
    kw = dict(conditional=True, cfg_drop_prob=DROP_P, null_label=2)
    # manual: gradients of each half, averaged, one Adam update
    ref = _torch_state(jax_side["params"])
    one = make_train_step(schedule, **kw)
    micro_grads, micro_losses = [], []
    for i in range(2):
        probe = _torch_state(jax_side["params"])
        sl = slice(2 * i, 2 * i + 2)
        seen = {}
        orig = probe.tx.update

        def spy(params, grads, opt_state, seen=seen, orig=orig):
            seen["g"] = [g.clone() for g in grads]
            return orig(params, grads, opt_state)

        probe.tx.update = spy
        _, m = one(probe, _t_batch(imgs[sl], labels[sl]), draws[i])
        micro_grads.append(seen["g"])
        micro_losses.append(m["loss"].item())
    mean = [(a + b) / 2 for a, b in zip(*micro_grads)]
    norm = ref.tx.update(ref.params, [g.clone() for g in mean],
                         ref.opt_state)
    acc = _torch_state(jax_side["params"])
    two = make_train_step(schedule, grad_accum=2, **kw)
    acc, m = two(acc, _t_batch(imgs, labels), draws)
    np.testing.assert_allclose(m["loss"].item(), np.mean(micro_losses),
                               rtol=1e-6)
    np.testing.assert_allclose(m["grad_norm"].item(), norm.item(), rtol=1e-5)
    for a, b in zip(acc.params, ref.params):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert acc.step == 1 and acc.opt_state["count"] == 1


def test_step_rejects_bad_accumulation(jax_side):
    schedule = make_schedule(T, device="cpu")
    with pytest.raises(ValueError, match="grad_accum must be"):
        make_train_step(schedule, grad_accum=0)
    st = _torch_state(jax_side["params"])
    step3 = make_train_step(schedule, conditional=True, grad_accum=3)
    with pytest.raises(ValueError, match="not divisible"):
        step3(st, _t_batch(*_batch()))
    assert st.step == 0


def test_eval_step_uses_ema_and_leaves_the_state_alone(jax_side):
    st = _torch_state(jax_side["params"])
    eval_fn = make_eval_step(make_schedule(T, device="cpu"), conditional=True)
    batch = _t_batch(*_batch(seed=2))
    before = st.generator.get_state().clone()
    l1 = eval_fn(st, batch).item()
    with torch.no_grad():
        for p in st.params:              # corrupt the raw parameters
            p.add_(100.0)
    l2 = eval_fn(st, batch).item()
    assert l1 == l2 and np.isfinite(l1)
    assert torch.equal(st.generator.get_state(), before)
    with torch.no_grad():
        for p in st.ema_params:
            p.mul_(0.5)
    assert eval_fn(st, batch).item() != l1


def test_uint8_batch_equals_prepared_float_batch(jax_side):
    """A uint8 batch is augmented and normalized inside the step: the same
    step on the float batch prepared outside with the same draws gives the
    same loss and the same update."""
    imgs, labels = synthetic_xray_batch(B, R, seed=3, normalization="minmax")
    u8 = torch.from_numpy((imgs * 255).astype(np.uint8))
    labels = torch.from_numpy(labels.astype(np.int64))
    rng = np.random.default_rng(9)
    aug = {"flip": torch.tensor([True, False, True, False]),
           "angles": torch.tensor([0.05, -0.02, 0.0, 0.08]),
           "rot": torch.tensor([True, True, False, True]),
           "bc": torch.tensor([False, True, False, True]),
           "bright": torch.tensor([0.1, -0.1, 0.0, 0.05]),
           "contrast": torch.tensor([-0.1, 0.15, 0.0, 0.2]),
           "noise_mask": torch.tensor([True, False, False, False]),
           "sigma": torch.full((B,), 0.03),
           "noise": torch.from_numpy(rng.standard_normal(
               (B, R, R, 1)).astype(np.float32))}
    draws = {"t": torch.tensor([1, 10, 20, 40]),
             "noise": torch.from_numpy(rng.standard_normal(
                 (B, R, R, 1)).astype(np.float32))}
    step_fn = make_train_step(make_schedule(T, device="cpu"),
                              conditional=True, augmentation="low",
                              normalization="tanh")
    a = _torch_state(jax_side["params"])
    a, ma = step_fn(a, {"image": u8, "label": labels}, {**draws, "aug": aug})
    prepared = prepare_batch(u8, None, "low", "tanh", draws=aug)
    assert prepared.dtype == torch.float32
    b = _torch_state(jax_side["params"])
    b, mb = step_fn(b, {"image": prepared, "label": labels}, draws)
    assert ma["loss"].item() == mb["loss"].item()
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)
    # and the augmentation did act
    clean = prepare_batch(u8, None, "none", "tanh")
    assert (prepared - clean).abs().max() > 0.05


def test_step_without_injection_is_reproducible_and_checkpointable(jax_side):
    """The generator drives every draw: the same seed gives the same
    trajectory, and its state after a step differs from before."""
    batch = _t_batch(*_batch(seed=4))
    schedule = make_schedule(T, device="cpu")
    step_fn = make_train_step(schedule, conditional=True, cfg_drop_prob=0.5,
                              null_label=2)
    runs = []
    for _ in range(2):
        st = _torch_state(jax_side["params"], learning_rate=1e-3)
        g0 = st.generator.get_state().clone()
        st, m1 = step_fn(st, batch)
        st, m2 = step_fn(st, batch)
        assert not torch.equal(st.generator.get_state(), g0)
        runs.append((m1["loss"].item(), m2["loss"].item(),
                     [p.detach().clone() for p in st.params]))
    assert runs[0][:2] == runs[1][:2] and runs[0][0] != runs[0][1]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))


# ------------------------------------------------------- remat / dropout ---

def test_remat_gradients_equal_plain_gradients(jax_side):
    """``remat=True`` recomputes each block in the backward: the same
    gradients to 1e-6 (float32, the same ops run twice)."""
    x, y = _t_batch(*_batch(seed=6)).values()
    t = torch.tensor([3, 9, 27, 45])
    grads = {}
    for remat in (False, True):
        tm = CondUNet(resolution=R, device="cpu", remat=remat, **TOY)
        fp.load_state_dict(tm, jax_side["params"])
        tm.train()
        loss = (tm(x, t, y) ** 2).mean()
        grads[remat] = torch.autograd.grad(loss, list(tm.parameters()))
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_remat_runs_the_flash_forward_twice_per_block():
    """A net whose head dim the flash wrapper takes (32): with remat the
    forward of each of its 4 attention blocks runs once more in the
    backward; eval mode does not checkpoint."""
    from superdiff_torch.ops import flash_attention as fa
    kw = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
              attn_resolutions=(4,), num_heads=2, num_classes=0,
              time_emb_dim=16, groups=4)
    x = torch.from_numpy(_batch(seed=7, n=2)[0][:, :8, :8])
    t = torch.tensor([3, 9])
    counts = {}
    for remat in (False, True):
        torch.manual_seed(0)
        tm = CondUNet(resolution=8, device="cpu", remat=remat, **kw)
        for name in ("out_conv", "mid_attn.proj"):
            torch.nn.init.normal_(tm.get_submodule(name).weight, std=0.1)
        tm.train()
        n = {"fwd": 0, "bwd": 0}
        f_orig, b_orig = fa._flash_forward, fa._flash_backward
        fa._flash_forward = lambda *a, n=n: (n.__setitem__(
            "fwd", n["fwd"] + 1), f_orig(*a))[1]
        fa._flash_backward = lambda *a, n=n: (n.__setitem__(
            "bwd", n["bwd"] + 1), b_orig(*a))[1]
        try:
            (tm(x, t) ** 2).mean().backward()
            n_train = dict(n)
            tm.eval()
            with torch.no_grad():
                tm(x, t)
        finally:
            fa._flash_forward, fa._flash_backward = f_orig, b_orig
        counts[remat] = (n_train, n["fwd"] - n_train["fwd"])
    assert counts[False] == ({"fwd": 4, "bwd": 4}, 4)
    assert counts[True] == ({"fwd": 8, "bwd": 4}, 4)


def test_dropout_acts_in_train_mode_only(jax_side):
    tm = CondUNet(resolution=R, device="cpu", dropout=0.5, **TOY)
    fp.load_state_dict(tm, jax_side["params"])
    ref = CondUNet(resolution=R, device="cpu", **TOY)
    fp.load_state_dict(ref, jax_side["params"])
    assert list(tm.state_dict()) == list(ref.state_dict())
    x, y = _t_batch(*_batch(seed=8)).values()
    t = torch.tensor([3, 9, 27, 45])
    with torch.no_grad():
        tm.eval()
        assert torch.equal(tm(x, t, y), ref.eval()(x, t, y))
        tm.train()
        torch.manual_seed(1)
        a = tm(x, t, y)
        torch.manual_seed(2)
        b = tm(x, t, y)
    assert not torch.equal(a, b)
    assert not torch.equal(a, ref(x, t, y))


def test_init_parameters_follow_the_flax_distributions():
    tm = CondUNet(resolution=R, device="cpu", **TOY).init_parameters(3)
    again = CondUNet(resolution=R, device="cpu", **TOY).init_parameters(3)
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 again.parameters()))
    sd = tm.state_dict()
    for key in ("down_0_block_0.conv_1.weight", "mid_attn.proj.weight",
                "out_conv.weight", "stem.bias", "out_norm.bias"):
        assert not sd[key].any(), key
    assert torch.equal(sd["out_norm.weight"], torch.ones(8))
    w = sd["mid_block_0.conv_0.weight"]             # (16, 16, 3, 3)
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.1
    assert w.abs().max().item() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    e = sd["class_emb.weight"]
    assert abs(e.std().item() * e.shape[1] ** 0.5 - 1.0) < 0.2
