"""The port's RefUNet slice against the JAX package (CPU, float32): the
model, the import of a reference-layout state dict, the artifact directory
in both directions, the sampling policy, DDPM with injected noise, and the
import's rejection cases."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.compat.torch_import import (
    import_checkpoint as j_import_checkpoint, ref_params_from_state_dict)
from superdiff_tpu.diffusion import samplers as js
from superdiff_tpu.diffusion import schedules as jsch
from superdiff_tpu.inference import apply_sampling_policy as j_policy
from superdiff_tpu.inference import load_run as j_load_run
from superdiff_tpu.inference import make_eps_fn as j_make_eps_fn
from superdiff_tpu.models.presets import build_model as j_build_model
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.compat.torch_import import (
    import_checkpoint, infer_ref_arch, normalize_state_dict,
    ref_state_dict_from_reference)
from superdiff_torch.diffusion import samplers as ts
from superdiff_torch.diffusion import schedules as tsch
from superdiff_torch.inference import (apply_sampling_policy, load_run,
                                       make_eps_fn)
from superdiff_torch.models.presets import build_model
from superdiff_torch.models.unet_ref import RefUNet

torch.set_num_threads(1)

R = 16          # image side of the toy runs
BASE = 8        # base channels (the reference uses 64)


def _reference_net(base_channels=BASE, time_emb_dim=256, in_channels=1,
                   seed=0):
    """An independent torch build of the reference UNet with its
    state_dict key layout (``downs.N.block.M``, ``mid``, ``ups.N``,
    ``time_mlp.{1,3}``, ``time_emb``)."""
    import torch.nn as nn

    torch.manual_seed(seed)

    def block(i, o):
        m = nn.Module()
        m.block = nn.Sequential(
            nn.GroupNorm(min(4, i), i), nn.SiLU(), nn.Conv2d(i, o, 3, padding=1),
            nn.GroupNorm(min(4, o), o), nn.SiLU(), nn.Conv2d(o, o, 3, padding=1))
        m.time_emb = nn.Linear(time_emb_dim, o)
        return m

    net = nn.Module()
    net.time_mlp = nn.Sequential(
        nn.Identity(), nn.Linear(time_emb_dim, time_emb_dim * 4), nn.SiLU(),
        nn.Linear(time_emb_dim * 4, time_emb_dim))
    bc = base_channels
    net.downs = nn.ModuleList([block(in_channels, bc), block(bc, bc * 2)])
    net.mid = block(bc * 2, bc * 2)
    net.ups = nn.ModuleList([block(bc * 2, bc), block(bc, 1)])
    with torch.no_grad():              # norms off their identity init
        for name, p in net.named_parameters():
            if name.endswith(("0.weight", "3.weight")) and p.ndim == 1:
                p.add_(0.1 * torch.randn_like(p))
            elif name.endswith(("0.bias", "3.bias")) and p.ndim == 1:
                p.add_(0.1 * torch.randn_like(p))
    return net


def _save_reference(path, **kw):
    torch.save(_reference_net(**kw).state_dict(), path)
    return path


def _xt(B=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, R, 1)).astype(np.float32)
    return x, np.array([3, 917][:B])


def _torch_out(model, x, t):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t)).numpy()


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_refunet_matches_jax(parameterization):
    """Random weights on every leaf, base 8 at 32², through the samplers'
    eps adapter (for "v" it converts the head's v to eps through the
    schedule). float32; sums in other orders -> rtol 1e-4, atol 1e-5."""
    jm = j_build_model("ref", base_channels=BASE,
                       parameterization=parameterization)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    t = np.array([5, 600])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 32, 32, 1)), jnp.zeros((2,), int))
    params = {"params": fp.random_params(shapes, 4)}
    j_sched, t_sched = jsch.make_schedule(1000), tsch.make_schedule(
        1000, device="cpu")
    j_fn = jax.jit(j_make_eps_fn(jm, params, schedule=j_sched))
    expect = np.asarray(j_fn(jnp.asarray(x), jnp.asarray(t)))
    tm = build_model("ref", base_channels=BASE, device="cpu",
                     parameterization=parameterization)
    assert isinstance(tm, RefUNet) and tm.parameterization == parameterization
    fp.load_state_dict(tm, params)
    with torch.no_grad():
        got = make_eps_fn(tm, schedule=t_sched)(
            torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(expect).max() > 0.1
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)


def test_refunet_gradients_match_jax_grad():
    """Gradients of a weighted sum of the output with respect to the input
    and every leaf: the port's backward (``Fp32Conv3x3``'s convolution
    backward, B4's autograd of the plain version) against ``jax.grad`` of
    the JAX RefUNet on the same random weights, base 8 at 16², float32;
    sums in other orders -> rtol 1e-3, atol 1e-4."""
    jm = j_build_model("ref", base_channels=BASE)
    x, t = _xt(seed=3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape), jnp.zeros((2,), int))
    params = fp.random_params(shapes, 6)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    loss = lambda p, xx: jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(t))
                                 * w)
    j_gp, j_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                         jnp.asarray(x))
    tm = build_model("ref", base_channels=BASE, device="cpu")
    fp.load_state_dict(tm, {"params": params})
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, torch.from_numpy(t))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tx, *tm.parameters()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_gx),
                               rtol=1e-3, atol=1e-4)
    got, expect = (fp._flatten(fp._leaf_tree(tm, grads[1:])),
                   fp._flatten(j_gp))
    assert got.keys() == expect.keys() and len(got) == 5 * 10 + 4
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(expect[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=str(k))


def test_import_matches_jax_import_leaf_for_leaf():
    """The port's mapping of a reference state dict, read back as a Flax
    tree, equals the JAX package's ``ref_params_from_state_dict``; and the
    imported model reproduces the reference net's own forward."""
    net = _reference_net(seed=3)
    sd = net.state_dict()
    assert infer_ref_arch(normalize_state_dict(sd)) == dict(
        time_emb_dim=256, base_channels=BASE, in_channels=1, out_channels=1)
    ours = ref_state_dict_from_reference(sd)
    tm = RefUNet(base_channels=BASE, device="cpu")
    tm.load_state_dict(ours, strict=True)
    got = fp._flatten(fp.to_flax(tm))
    want = fp._flatten(ref_params_from_state_dict(sd)["params"])
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path])

    x, t = _xt()
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                      * -(math.log(10000.0) / (half - 1)))
    args = torch.from_numpy(t).float()[:, None] * freqs[None, :]
    emb = net.time_mlp(torch.cat([torch.sin(args), torch.cos(args)], -1))
    with torch.no_grad():
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        for m in list(net.downs) + [net.mid] + list(net.ups):
            h = m.block(h) + m.time_emb(emb)[:, :, None, None]
    np.testing.assert_allclose(_torch_out(tm, x, t),
                               h.permute(0, 2, 3, 1).numpy(), rtol=1e-4,
                               atol=1e-5)


def test_artifacts_cross_both_ways(tmp_path, monkeypatch):
    """The port's import is read by the JAX ``load_run`` and the JAX
    import by the port's, with equal forwards; both write the same
    config and the same arrays. (The JAX import's shape check runs on
    ``jax.eval_shape`` here: its eager init compiles ~100 primitives.)"""
    import superdiff_tpu.utils.env as j_env

    monkeypatch.setattr(j_env, "host_init",
                        lambda init, *args: jax.eval_shape(init, *args))
    pt = _save_reference(str(tmp_path / "ema_epoch1.pt"), seed=5)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(resolution=R, num_timesteps=20, task="PNEUMONIA")
    assert import_checkpoint(pt, ours, **kw)["base_channels"] == BASE
    j_import_checkpoint(pt, theirs, **kw)
    with open(os.path.join(ours, "config.yaml")) as a, open(
            os.path.join(theirs, "config.yaml")) as b:
        assert a.read() == b.read()
    with np.load(os.path.join(ours, fp.EXPORT_FILE)) as a, np.load(
            os.path.join(theirs, fp.EXPORT_FILE)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    x, t = _xt(seed=6)
    for run in (ours, theirs):
        cfg, model, schedule = load_run(run, device="cpu")
        assert isinstance(model, RefUNet) and not cfg.model.conditional
        assert schedule.num_timesteps == 20 and cfg.task == "PNEUMONIA"
        j_cfg, jm, _, j_ema = j_load_run(run)
        expect = np.asarray(jax.jit(jm.apply)(j_ema, jnp.asarray(x),
                                              jnp.asarray(t)))
        np.testing.assert_allclose(_torch_out(model, x, t), expect,
                                   rtol=1e-4, atol=1e-5)


def test_sampling_policy_matches_jax(tmp_path):
    """The policy casts the conv and time-bias weights to bf16 (the same
    leaves as the JAX policy: no f32 name token matches them) while the
    graph still runs float32 on the rounded weights, as Flax's float32
    layers promote them: the forwards agree at float32 tolerance."""
    pt = _save_reference(str(tmp_path / "ema.pt"), seed=7)
    run = str(tmp_path / "run")
    import_checkpoint(pt, run, resolution=R, num_timesteps=20)
    _, model, _ = load_run(run, device="cpu")
    apply_sampling_policy(model)
    _, jm, _, j_ema = j_load_run(run)
    jm, jp = j_policy(jm, j_ema)
    cast = {n for n, p in model.named_parameters() if p.dtype == torch.bfloat16}
    j_cast = {fp.torch_key(tuple(k.key for k in path)[1:], leaf.ndim)[0]
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]
              if leaf.dtype == jnp.bfloat16}
    assert cast == j_cast and len(cast) == 5 * 6
    assert all(".conv_" in n or ".time_emb." in n for n in cast)
    x, t = _xt(seed=8)
    expect = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x), jnp.asarray(t)))
    got = _torch_out(model, x, t)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)


def test_ddpm_matches_jax_with_injected_noise(tmp_path):
    """DDPM at T=8 on an imported run: the JAX sampler's own draws (its key
    chain replayed) are injected into the port's sampler."""
    pt = _save_reference(str(tmp_path / "ema.pt"), seed=9)
    run = str(tmp_path / "run")
    import_checkpoint(pt, run, resolution=R, num_timesteps=8)
    _, model, schedule = load_run(run, device="cpu")
    _, jm, j_sched, j_ema = j_load_run(run)
    shape = (2, R, R, 1)
    expect = js.ddpm_sample(j_sched, j_make_eps_fn(jm, j_ema), shape,
                            jax.random.PRNGKey(4))
    rng, init = jax.random.split(jax.random.PRNGKey(4))
    x_init = torch.from_numpy(np.array(jax.random.normal(init, shape)))
    noise, key = [], rng
    for _ in range(8):
        key, nkey = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.normal(nkey,
                                                                 shape))))
    with torch.no_grad():
        got = ts.ddpm_sample(schedule, make_eps_fn(model), shape,
                             x_init=x_init, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_import_rejections_and_prefixes(tmp_path):
    """Wrapper prefixes are stripped (and a whole-EMA-object save keeps the
    EMA weights whatever the key order); non-reference state dicts, non-dict
    files, colour models and a non-default time embedding are refused; the
    ref preset validates its parameterization and keeps it through the
    config."""
    ema, online = _reference_net(seed=10), _reference_net(seed=11)
    sd = {f"online_model.{k}": v for k, v in online.state_dict().items()}
    sd.update({f"ema_model.{k}": v for k, v in ema.state_dict().items()})
    sd["initted"], sd["step"] = torch.tensor(True), torch.tensor(7)
    want = ema.state_dict()["downs.0.block.2.weight"]
    for order in (sd, dict(reversed(list(sd.items())))):
        got = normalize_state_dict(order)
        assert "initted" not in got and "step" not in got
        torch.testing.assert_close(got["downs.0.block.2.weight"], want)
    wrapped = {f"module.{k}": v for k, v in ema.state_dict().items()}
    assert "time_mlp.dense_0.weight" in ref_state_dict_from_reference(wrapped)

    with pytest.raises(ValueError, match="reference-UNet key"):
        ref_state_dict_from_reference({"foo.weight": torch.zeros(2, 2)})
    bad = str(tmp_path / "bad.pt")
    torch.save(torch.zeros(3), bad)
    with pytest.raises(ValueError, match="state_dict"):
        import_checkpoint(bad, str(tmp_path / "o"))
    rgb = _save_reference(str(tmp_path / "rgb.pt"), in_channels=3)
    with pytest.raises(ValueError, match="grayscale"):
        import_checkpoint(rgb, str(tmp_path / "o"))
    wide = _save_reference(str(tmp_path / "t128.pt"), time_emb_dim=128)
    with pytest.raises(ValueError, match="time_emb_dim"):
        import_checkpoint(wide, str(tmp_path / "o"))
    assert not os.path.exists(str(tmp_path / "o"))
    with pytest.raises(ValueError, match="parameterization"):
        build_model("ref", base_channels=BASE, parameterization="nope",
                    device="cpu")
    # a v-headed ref run rebuilt from its config keeps its head's meaning,
    # and the eps adapter then needs the schedule it converts through
    from superdiff_torch.config import Config
    from superdiff_torch.inference import make_eps_fn_p
    from superdiff_torch.models.presets import model_from_config

    cfg = Config()
    cfg.model.preset, cfg.model.conditional = "ref", False
    cfg.model.base_channels, cfg.model.parameterization = BASE, "v"
    assert model_from_config(cfg, device="meta").parameterization == "v"
    with pytest.raises(ValueError, match="schedule"):
        make_eps_fn_p(model_from_config(cfg, device="meta"))
