"""The port's weight bridge, config I/O, run loading and CLI (CPU), and its
independence from jax / flax / superdiff_tpu."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

import superdiff_tpu.config as jcfg
from superdiff_tpu.cli.export import export_params as j_export
from superdiff_tpu.cli.export import load_exported_params as j_load
from superdiff_tpu.inference import load_run as j_load_run
from superdiff_torch import config as tcfg
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.inference import load_run
from superdiff_torch.models.presets import model_from_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_CONFIG = os.path.join(REPO, "artifacts", "e2e_64", "tb", "config.yaml")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"stem": {"kernel": r(3, 3, 4, 8), "bias": r(8)},
            "blk": {"norm_0": {"scale": r(8), "bias": r(8)},
                    "qkv": {"kernel": r(8, 24), "bias": r(24)}},
            "class_emb": {"embedding": r(3, 16)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_round_trip_with_jax_export(tmp_path, dtype):
    """Both directions of the ema_params.npz format, incl. the bf16: uint16
    keys: what one package writes the other reads bit for bit."""
    import ml_dtypes

    tree = _tree()
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_export(tree, j_path, dtype)
    fp.export_params(tree, t_path, dtype)
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(k.startswith("bf16:") == (dtype == "bfloat16")
                   for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    got = fp.load_exported_params(j_path)
    back = j_load(t_path)
    for path, leaf in fp._flatten(tree).items():
        t_leaf = fp._flatten(got)[path]
        j_leaf = fp._flatten(back)[path]
        if dtype == "bfloat16":
            assert t_leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t_leaf.view(torch.int16).numpy().view(np.uint16),
                np.asarray(j_leaf).view(np.uint16))
            np.testing.assert_array_equal(
                t_leaf.float().numpy(),
                leaf.astype(ml_dtypes.bfloat16).astype(np.float32))
        else:
            np.testing.assert_array_equal(t_leaf, leaf)


def test_from_flax_layouts_and_flax_shapes():
    tree = _tree()
    sd = fp.from_flax({"params": tree})
    assert sd["stem.weight"].shape == (8, 4, 3, 3)
    np.testing.assert_array_equal(sd["stem.weight"][5, 2].numpy(),
                                  tree["stem"]["kernel"][:, :, 2, 5])
    np.testing.assert_array_equal(sd["blk.qkv.weight"].numpy(),
                                  tree["blk"]["qkv"]["kernel"].T)
    assert sd["blk.norm_0.weight"].shape == (8,)
    assert sd["class_emb.weight"].shape == (3, 16)

    # flax_shapes inverts the layout rules on a model's own parameters
    model = model_from_config(_tiny_cfg(), device="meta")
    shapes = fp._flatten(fp.flax_shapes(model))
    assert shapes[("class_emb", "embedding")].shape == (3, 1024)
    assert shapes[("stem", "kernel")].shape == (3, 3, 1, 8)
    back = {fp.torch_key(p, len(leaf.shape)) for p, leaf in shapes.items()}
    assert {k for k, _ in back} == set(model.state_dict())


def _tiny_cfg(T=4):
    cfg = tcfg.Config()
    cfg.training.resolution = 16
    cfg.training.num_timesteps = T
    cfg.model.base_channels = 8
    cfg.model.num_res_blocks = (1,)
    cfg.model.attn_resolutions = (8,)
    return cfg


def _export_run(path, cfg, seed):
    os.makedirs(path, exist_ok=True)
    tcfg.save_config(cfg, os.path.join(path, "config.yaml"))
    shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
    params = fp.random_params(shapes, seed)
    fp.export_params(params, os.path.join(path, fp.EXPORT_FILE))
    return params


def test_strict_loading_raises():
    cfg = _tiny_cfg()
    model = model_from_config(cfg, device="cpu")
    params = fp.random_params(fp.flax_shapes(model), 0)
    fp.load_state_dict(model, params)
    broken = fp.random_params(fp.flax_shapes(model), 0)
    del broken["stem"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        fp.load_state_dict(model, broken)
    broken = fp.random_params(fp.flax_shapes(model), 0)
    broken["stem"]["kernel"] = np.zeros((3, 3, 1, 4), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        fp.load_state_dict(model, broken)


def test_load_run_matches_jax_load_run(tmp_path):
    """The JAX package and the port read the same exported run dir (the
    port wrote both files) to the same weights and schedule."""
    run = str(tmp_path / "run")
    _export_run(run, _tiny_cfg(), 3)
    cfg, model, schedule = load_run(run, device="cpu")
    j_cfg, _, j_sched, j_ema = j_load_run(run)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    sd = model.state_dict()
    expect = fp.from_flax(jax_to_numpy(j_ema))
    assert sorted(sd) == sorted(expect)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), expect[k].numpy())
    np.testing.assert_array_equal(schedule.alpha_bars.numpy(),
                                  np.asarray(j_sched.alpha_bars))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_run(run)                       # default device is cuda


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_cli_sample_ddpm_and_superdiff_on_cpu(tmp_path):
    from superdiff_torch.cli import sample

    r1, r2 = str(tmp_path / "r1"), str(tmp_path / "r2")
    _export_run(r1, _tiny_cfg(), 1)
    _export_run(r2, _tiny_cfg(), 2)
    out = str(tmp_path / "out")
    assert sample.main(["--run-dir", r1, "--device", "cpu", "--batch-size",
                        "2", "--label", "0", "--guidance", "2.0",
                        "--out", out]) == 0
    x = np.load(os.path.join(out, "samples.npy"))
    assert x.shape == (2, 16, 16, 1) and np.isfinite(x).all()
    for mode in ("or", "and"):
        out = str(tmp_path / mode)
        assert sample.main(["--run-dir", r1, "--run-dir2", r2, "--mode",
                            mode, "--device", "cpu", "--batch-size", "3",
                            "--out", out]) == 0
        with open(os.path.join(out, "logq.json")) as f:
            lq = json.load(f)
        assert lq["mode"] == mode and len(lq["logq_model1"]) == 3
        assert np.isfinite(lq["logq_model2"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sample.main(["--run-dir", r1, "--out", out])


def test_config_reader_matches_yaml_and_jax():
    with open(E2E_CONFIG) as f:
        text = f.read()
    assert tcfg.parse_yaml(text) == yaml.safe_load(text)
    got = dataclasses.asdict(tcfg.load_config(E2E_CONFIG))
    assert got == dataclasses.asdict(jcfg.load_config(E2E_CONFIG))
    ov = ["model.num_res_blocks=1,2,2,2,2", "training.beta_end=0.03",
          "sampling.label=null", "superdiff.kappa=[0.25, 0.75]"]
    assert (dataclasses.asdict(tcfg.load_config(E2E_CONFIG, ov))
            == dataclasses.asdict(jcfg.load_config(E2E_CONFIG, ov)))


def test_config_writer_round_trips(tmp_path):
    cfg = tcfg.Config()
    cfg.model.num_res_blocks = (1, 2, 2, 2, 2)
    cfg.model.attn_resolutions = ()
    cfg.run_id = "yes"
    cfg.experiment_id = "1.5"
    cfg.paths.output_dir = "out: #x"
    cfg.training.beta_start = 1e-05
    path = str(tmp_path / "config.yaml")
    tcfg.save_config(cfg, path)
    with open(path) as f:
        text = f.read()
    expect = json.loads(json.dumps(dataclasses.asdict(cfg)))  # tuples->lists
    assert yaml.safe_load(text) == expect
    assert tcfg.parse_yaml(text) == expect
    jc = jcfg.Config()
    jc.model.num_res_blocks = (1, 2)
    jpath = str(tmp_path / "j.yaml")
    jcfg.save_config(jc, jpath)
    assert (dataclasses.asdict(tcfg.load_config(jpath))
            == dataclasses.asdict(jcfg.load_config(jpath)))


def test_train_state_round_trip_through_numpy():
    """A JAX ``TrainState`` given as numpy arrays (params, EMA, the Adam part
    of ``chain(clip_by_global_norm, adam)``, step) -> the port's TrainState
    -> numpy again, bit for bit; the port's tensors hold the torch layout."""
    import jax
    import jax.numpy as jnp

    from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
    from superdiff_tpu.training.state import make_optimizer as j_make_optimizer
    from superdiff_torch.models.unet import CondUNet
    from superdiff_torch.training.state import create_train_state

    kw = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
              attn_resolutions=(8,), num_heads=2, num_classes=2,
              time_emb_dim=16, groups=4)
    jm = JaxCondUNet(**kw)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    params = {"params": fp.random_params(shapes, 1)}
    ema = {"params": fp.random_params(shapes, 2)}
    tx = j_make_optimizer(grad_clip_norm=1.0)
    opt_state = tx.init(params)
    assert isinstance(opt_state, tuple)          # (clip state, adam states)
    adam = opt_state[1][0]._replace(
        count=jnp.asarray(7, jnp.int32),
        mu={"params": fp.random_params(shapes, 3)},
        nu={"params": fp.random_params(shapes, 4)})
    arrays = {"params": params, "ema_params": ema, "mu": adam.mu,
              "nu": adam.nu, "count": int(adam.count), "step": 7}

    st = create_train_state(CondUNet(resolution=16, device="cpu", **kw),
                            torch.Generator().manual_seed(0))
    rng_before = st.generator.get_state().clone()
    fp.train_state_from_numpy(st, arrays)
    assert st.step == 7 and st.opt_state["count"] == 7
    assert torch.equal(st.generator.get_state(), rng_before)
    names = [n for n, _ in st.model.named_parameters()]
    i = names.index("stem.weight")
    np.testing.assert_array_equal(
        st.opt_state["mu"][i].numpy(),
        np.transpose(adam.mu["params"]["stem"]["kernel"], (3, 2, 0, 1)))
    assert not torch.equal(st.params[i], st.ema_params[i])
    back = fp.train_state_to_numpy(st)
    assert back["count"] == 7 and back["step"] == 7
    for name in ("params", "ema_params", "mu", "nu"):
        got, want = fp._flatten(back[name]), fp._flatten(
            arrays[name]["params"])
        assert set(got) == set(want)
        for path in got:
            np.testing.assert_array_equal(got[path], want[path])


def test_port_imports_without_jax(tmp_path):
    """Every superdiff_torch module (and chip_smoke.py) imports, and the toy
    CondUNet runs on CPU, with jax, flax, optax, orbax, superdiff_tpu and
    PIL blocked; the training, checkpoint, CLI, group-norm, reference-import,
    serving, graphed-sampler, data-layer, evaluation and distillation
    modules are among them."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        BLOCK = ("jax", "jaxlib", "flax", "optax", "orbax", "superdiff_tpu",
                 "ml_dtypes", "yaml", "PIL")
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCK:
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, {REPO!r})
        import superdiff_torch, torch
        mods = [m.name for m in pkgutil.walk_packages(
            superdiff_torch.__path__, "superdiff_torch.")]
        for m in mods:
            importlib.import_module(m)
        importlib.import_module("chip_smoke")
        from superdiff_torch.models.unet import CondUNet
        m = CondUNet(resolution=16, base_channels=8, channel_mults=(1, 2),
                     num_res_blocks=1, attn_resolutions=(8,), num_heads=2,
                     num_classes=2, time_emb_dim=16, groups=4, device="cpu")
        with torch.no_grad():
            out = m(torch.zeros(2, 16, 16, 1), torch.tensor([1, 2]),
                    torch.tensor([0, 2]))
        assert out.shape == (2, 16, 16, 1)
        from superdiff_torch.models.unet_ref import RefUNet
        with torch.no_grad():
            out = RefUNet(base_channels=4, device="cpu")(
                torch.zeros(1, 8, 8, 1), torch.tensor([3]))
        assert out.shape == (1, 8, 8, 1)
        for m in ("training.loop", "training.steps", "checkpoint",
                  "cli.train", "cli.export", "data.transforms",
                  "ops._build", "ops.fused_norm", "ops.packed_norm",
                  "models.unet_ref", "compat.torch_import",
                  "cli.import_torch", "serve", "cli.serve",
                  "diffusion.graphed", "data.image_io", "data.dataset",
                  "data.split", "data.native_loader", "data.datamodule",
                  "analysis.features", "analysis.resnet",
                  "analysis.densenet", "analysis.classifier",
                  "analysis.fid", "cli.evaluate", "diffusion.distill",
                  "cli.distill"):
            assert "superdiff_torch." + m in mods, m
        bad = [n for n in sys.modules if n.split(".")[0] in BLOCK]
        assert not bad, bad
        print("ok", len(mods))
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
