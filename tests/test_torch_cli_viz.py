"""The port's visual CLIs (``cli.visualize``, ``cli.inspect_data``),
``analysis/compare.py`` and ``cli.train``'s figures, on the CPU.

``compare_runs``' log-densities are held against the JAX package's
superposition of the same two runs with JAX's draws injected (one JAX
compile, T=8). The CLIs run on toy runs and a toy tree (port side only)
and must write the JAX CLIs' file names; they, ``cli.train`` with its
figures on, and every module of the slice must run with matplotlib, PIL and
sklearn blocked, since the card's machine has none of them."""

import argparse
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdiff_tpu.config import load_config as j_load_config
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion import superdiff as jsd
from superdiff_tpu.models.presets import model_from_config as j_model
from superdiff_torch import config as tcfg
from superdiff_torch.analysis.compare import compare_runs
from superdiff_torch.cli import inspect_data, train, visualize
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.data.image_io import decode_png
from superdiff_torch.models.presets import model_from_config
from superdiff_torch.utils.visualization import png_bytes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
BLOCKED = ("matplotlib", "PIL", "sklearn")
RESNET_NPZ = os.path.join(REPO, "artifacts", "extractors",
                          "resnet18_rand_seed1234.npz")


@pytest.fixture
def blocked(monkeypatch):
    """matplotlib, PIL and sklearn (and every cached submodule) unimportable
    for the test's duration."""
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            monkeypatch.setitem(sys.modules, name, None)
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401


def _run(path, seed, T, conditional=True):
    """An exported toy run (random weights from ``seed``); returns its
    Flax-layout parameter tree."""
    cfg = tcfg.Config()
    cfg.training.resolution, cfg.training.num_timesteps = RES, T
    cfg.model.base_channels, cfg.model.num_res_blocks = 8, (1,)
    cfg.model.attn_resolutions = (8,)
    cfg.model.compute_dtype = cfg.model.norm_dtype = "float32"
    cfg.model.conditional = conditional
    os.makedirs(path, exist_ok=True)
    tcfg.save_config(cfg, os.path.join(path, "config.yaml"))
    params = fp.random_params(fp.flax_shapes(model_from_config(
        cfg, device="meta")), seed)
    fp.export_params(params, os.path.join(path, fp.EXPORT_FILE))
    return params


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A toy PNEUMONIA tree (train / val / test, two classes) written with
    the port's own PNG writer."""
    root = tmp_path_factory.mktemp("viz_tree")
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("val", 4), ("test", 4)):
        for cls in ("NORMAL", "PNEUMONIA"):
            d = root / "PNEUMONIA" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                (d / f"{i}.png").write_bytes(png_bytes(
                    rng.integers(0, 256, (20, 18), dtype=np.uint8)))
    return str(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Exported toy runs: a conditional one at T=104 (the ``diffusion``
    extractor probes at t=100), and two unconditional ones at T=8 with
    their Flax-layout weights."""
    base = tmp_path_factory.mktemp("viz_runs")
    out = {"long": str(base / "long")}
    _run(out["long"], 1, 104)
    for name, seed in (("a", 4), ("b", 5)):
        out[name] = str(base / name)
        out[name + "_params"] = _run(out[name], seed, 8, conditional=False)
    return out


def _jax_draws(seed, shape, steps):
    """The key chain of the JAX samplers: the initial sample, then one
    draw per step."""
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    x_init = np.array(jax.random.normal(init_rng, shape))
    key, noise = rng, []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.normal(nkey,
                                                                 shape))))
    return torch.from_numpy(x_init), noise


def test_compare_runs_stats_match_jax(runs, tmp_path):
    """Two exported runs, T=8: the superposed run's log-densities under
    both models and their mean gap against JAX's ``superdiff_sample`` on
    the same weights with the key ``compare_runs`` feeds it (its draws
    injected into all three of the port's runs), within 1e-4 of the
    log-densities' size; the panel is 3 rows of 2 tiles."""
    T, seed, shape = 8, 3, (2, RES, RES, 1)
    ra, rb = runs["a"], runs["b"]
    pa, pb = runs["a_params"], runs["b_params"]
    jm = j_model(j_load_config(os.path.join(ra, "config.yaml")))
    js = j_make_schedule(T)
    # one jitted apply for both models: the UNet is traced once; the
    # program is compiled at XLA's lowest backend optimisation level (it
    # runs once, so its compile is nearly all of its cost)
    apply = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))
    fns = [lambda x, t, p=p: apply(p, x, t) for p in (pa, pb)]
    key = jax.random.PRNGKey(seed)
    program = jax.jit(lambda r: jsd.superdiff_sample(
        js, fns, shape, r, mode="or")).lower(key).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    jlogq = np.asarray(program(key)[1])
    draws = _jax_draws(seed, shape, T)
    stats = compare_runs(ra, rb, str(tmp_path / "out"), num_samples=2,
                         seed=seed, device="cpu",
                         draws={"a": draws, "b": draws, "superposed": draws})
    scale = np.abs(jlogq).max()
    for got, want in ((stats["logq_model_a"], jlogq[0]),
                      (stats["logq_model_b"], jlogq[1])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    assert abs(stats["mean_logq_gap"] - float(np.mean(jlogq[0] - jlogq[1]))
               ) <= 1e-4 * scale
    with open(stats["panel"], "rb") as f:
        panel = decode_png(f.read())
    assert panel.shape == (3 * RES + 2 * 4, 2 * RES + 4)


def test_train_default_figures_need_no_matplotlib(tmp_path, blocked):
    """``cli.train`` with ``vis_every`` on writes ``samples_epoch1.png`` and
    ``loss_curve.png`` with matplotlib, PIL and sklearn blocked (the card's
    machine has none); the real-vs-generated PNG is two rows of tiles."""
    sets = ["model.preset=small64", "model.base_channels=8",
            "model.compute_dtype=float32", "training.resolution=16",
            "training.batch_size=4", "training.num_timesteps=8",
            "training.num_epochs=1", "training.steps_per_epoch=1",
            "training.vis_every=1", f"paths.local_base={tmp_path}"]
    argv = ["--synthetic", "--device", "cpu", "--run-id", "vis"]
    for s in sets:
        argv += ["--set", s]
    assert train.main(argv) == 0
    run = os.path.join(str(tmp_path), "outputs", "PNEUMONIA",
                       "experiment_exp0_run_vis")
    with open(os.path.join(run, "samples_epoch1.png"), "rb") as f:
        grid = decode_png(f.read())
    assert grid.shape == (2 * RES + 2, 4 * RES + 3 * 2)
    assert os.path.getsize(os.path.join(run, "loss_curve.png")) > 0


def test_visualize_cli_writes_the_jax_file_names(runs, tree, tmp_path,
                                                 blocked):
    """Every flag, with matplotlib, PIL and sklearn blocked: the JAX CLI's
    file names (``--compare`` on two short runs), and the trajectory strip
    of 8 frames."""
    out = str(tmp_path / "viz")
    assert visualize.main([
        "--run-dir", runs["long"], "--dataset-root", tree, "--device", "cpu",
        "--num-samples", "2", "--out", out, "--trajectory", "--forward-strip",
        "--real-vs-generated", "--tsne", "--dashboard"]) == 0
    assert visualize.main([
        "--run-dir", runs["a"], "--run-dir2", runs["b"], "--device", "cpu",
        "--num-samples", "2", "--out", out, "--compare"]) == 0
    assert sorted(os.listdir(out)) == [
        "comparison.png", "dashboard.html", "forward_strip.png",
        "generated.png", "real_vs_generated.png", "trajectory.png",
        "tsne_real_vs_gen.png"]
    with open(os.path.join(out, "trajectory.png"), "rb") as f:
        assert decode_png(f.read()).shape == (RES, 8 * RES + 7 * 2)
    with open(os.path.join(out, "dashboard.html")) as f:
        page = f.read()
    assert page.count("data:image/png;base64") >= 3


@pytest.mark.parametrize("flags,why", [
    (["--real-vs-generated"], "--real-vs-generated needs --dataset-root"),
    (["--compare"], "--compare needs --run-dir2"),
    (["--dashboard"], "--dashboard needs --dataset-root")])
def test_visualize_cli_refuses_missing_inputs(runs, tmp_path, capsys, flags,
                                              why):
    assert visualize.main(["--run-dir", runs["a"], "--device", "cpu",
                           "--num-samples", "1", "--out",
                           str(tmp_path / "v")] + flags) == 2
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("backbone", [None, "resnet18"])
def test_inspect_data_cli_writes_the_jax_file_names(tree, tmp_path, blocked,
                                                    capsys, backbone):
    """With matplotlib, PIL and sklearn blocked: every ``viz`` toggle gives
    the JAX CLI's file names (the plotly HTML skipped without plotly) and
    eight Grad-CAM panels through a SmallCNN trained here; with
    ``--gradcam-backbone`` the panels come from the committed ResNet-18
    (which carries ``fc``)."""
    out = str(tmp_path / "inspect")
    argv = ["--dataset-root", tree, "--out", out, "--device", "cpu",
            "--max-samples", "24", "--set", "training.resolution=16",
            "--set", "training.batch_size=8", "--set", "viz.gradcam=true"]
    toggles = ("show_class_counts", "show_batch", "show_augmented", "tsne",
               "tsne_thumbnails", "tsne_umap_thumbnails", "projection_3d",
               "projection_3d_thumbnails", "projection_3d_plotly",
               "histograms", "image_grid")
    if backbone:
        argv += ["--gradcam-backbone", backbone, "--gradcam-checkpoint",
                 RESNET_NPZ]
    else:
        for v in toggles:
            argv += ["--set", f"viz.{v}=true"]
    assert inspect_data.main(argv) == 0
    assert sorted(os.listdir(out)) == (["gradcam"] if backbone else [
        "augmented.png", "batch.png", "gradcam", "hist.png",
        "projection3d.png", "tsne.png", "tsne_thumbs.png",
        "tsne_vs_umap.png"])
    assert sorted(os.listdir(os.path.join(out, "gradcam"))) == [
        f"gradcam_{i}.png" for i in range(8)]
    printed = capsys.readouterr().out
    if not backbone:
        assert "class counts: {'NORMAL': 12, 'PNEUMONIA': 12}" in printed
        assert "skipped plotly HTML" in printed


def test_cli_flags_are_the_jax_flags():
    """Both CLIs take the JAX CLIs' flags, plus ``--device``."""
    from superdiff_tpu.cli import inspect_data as j_inspect
    from superdiff_tpu.cli import visualize as j_visualize

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings
                if not isinstance(a, argparse._HelpAction)}

    for port, ref in ((visualize, j_visualize), (inspect_data, j_inspect)):
        assert flags(port.build_parser()) == (flags(ref.build_parser())
                                              | {"--device"})


def test_no_port_module_imports_matplotlib_pil_sklearn_or_jax():
    """No import of matplotlib, PIL, sklearn, JAX or the JAX package in
    the port or ``chip_smoke.py``, but the JPEG fixture writer's PIL (a
    tool that runs where PIL is)."""
    pattern = re.compile(r"^\s*(from|import)\s+(matplotlib|PIL|sklearn|jax|"
                         r"flax|superdiff_tpu)\b", re.M)
    hits = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dp, _, files in os.walk(os.path.join(REPO, "superdiff_torch")):
        paths += [os.path.join(dp, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for m in pattern.finditer(f.read()):
                hits.append((os.path.relpath(path, REPO), m.group(2)))
    assert hits == [(os.path.join("superdiff_torch", "tools",
                                  "make_jpeg_fixtures.py"), "PIL")]
