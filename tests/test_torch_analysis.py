"""The port's evaluation suite (superdiff_torch.analysis, cli.evaluate)
against the JAX package's on the CPU: SmallCNN (the trained extractor of
record and Flax-initialised weights), ResNet-18, DenseNet-121, the
diffusion probe with JAX's noise injected, the Fréchet distance, the
classifier archive in both directions, and the evaluation CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from superdiff_tpu.analysis import densenet as jd
from superdiff_tpu.analysis import features as jf
from superdiff_tpu.analysis import fid as jfid
from superdiff_tpu.analysis import resnet as jr
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.models.unet import CondUNet as JaxCondUNet
from superdiff_torch.analysis import classifier as tcls
from superdiff_torch.analysis import densenet as td
from superdiff_torch.analysis import features as tf
from superdiff_torch.analysis import fid as tfid
from superdiff_torch.analysis import resnet as tr
from superdiff_torch.compat.flax_params import load_state_dict, random_params
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.ops import fused_norm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALLCNN_NPZ = os.path.join(REPO, "artifacts", "extractors",
                            "smallcnn_trained_256.npz")
RESNET_NPZ = os.path.join(REPO, "artifacts", "extractors",
                          "resnet18_rand_seed1234.npz")
TOY = dict(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
           attn_resolutions=(8,), num_heads=2, num_classes=2,
           time_emb_dim=16, groups=4)        # __graft_entry__.py's toy


def _rel(got, expect):
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    return float(np.linalg.norm(got - expect) / np.linalg.norm(expect))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def chain_calls(monkeypatch):
    """Records the (shape, groups, eps) of every fused_groupnorm_silu
    call."""
    calls = []
    real = fused_norm.fused_groupnorm_silu

    def spy(x, gamma, beta, num_groups, scale=None, shift=None, eps=1e-5):
        calls.append((tuple(x.shape), num_groups, eps))
        return real(x, gamma, beta, num_groups, scale, shift, eps)

    monkeypatch.setattr(fused_norm, "fused_groupnorm_silu", spy)
    return calls


def test_trained_smallcnn_matches_jax(chain_calls):
    """The extractor of record (smallcnn_trained_256.npz, as it is) at a 64²
    input: logits and features within 1e-5 relative of JAX's
    SmallCNN.apply; 5 GroupNorm->SiLU chains, each one fused call with
    Flax's eps 1e-6 and 8 groups."""
    x = _x((2, 64, 64, 1))
    jm, jp = jf.load_classifier(SMALLCNN_NPZ)
    jl, jfeat = jax.jit(lambda p, v: jm.apply(p, v, return_features=True))(
        jp, jnp.asarray(x))
    model = tf.load_classifier(SMALLCNN_NPZ, device="cpu")
    assert model.meta["widths"] == [32, 64, 128, 256, 256]
    with torch.no_grad():
        tl, tfeat = model(torch.from_numpy(x), return_features=True)
    assert _rel(tl, jl) < 1e-5 and _rel(tfeat, jfeat) < 1e-5
    assert [c[1:] for c in chain_calls] == [(8, 1e-6)] * 5
    assert [c[0][1:] for c in chain_calls] == [
        (32, 32, 32), (16, 16, 64), (8, 8, 128), (4, 4, 256), (2, 2, 256)]
    ex = tf.FeatureExtractor("classifier", checkpoint=SMALLCNN_NPZ,
                             device="cpu")
    np.testing.assert_allclose(ex.extract(x), np.asarray(jfeat).mean((1, 2)),
                               rtol=1e-5, atol=1e-6)


def test_flax_initialised_smallcnn_matches_jax():
    """A SmallCNN of the random backend's shape with JAX-initialised weights
    (HWIO -> OIHW, scale -> weight through the bridge) gives JAX's
    features; the port's own random backend is seeded and 128-wide."""
    x = _x((3, 32, 32, 1), seed=1)
    jm = jf.SmallCNN(num_classes=256)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, jfeat = jax.jit(lambda p, v: jm.apply(p, v, return_features=True))(
        jp, jnp.asarray(x))
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    ex = tf.FeatureExtractor("classifier", device="cpu", params=jp_np,
                             model=tf.SmallCNN(256, device="cpu"))
    assert _rel(ex.extract(x), np.asarray(jfeat).mean((1, 2))) < 1e-5
    r0 = tf.FeatureExtractor("random", seed=0, device="cpu").extract(x)
    assert r0.shape == (3, 128)
    np.testing.assert_array_equal(
        r0, tf.FeatureExtractor("random", seed=0, device="cpu").extract(x))
    assert not np.allclose(
        r0, tf.FeatureExtractor("random", seed=1, device="cpu").extract(x))


def test_resnet18_matches_jax(tmp_path):
    """resnet18_rand_seed1234.npz as it is (and as a torch.save file) at a
    32² input: features within 1e-4 relative of JAX's."""
    x = _x((2, 32, 32, 1), seed=2)
    expect = jax.jit(jr.resnet18_features)(
        jr.load_torch_resnet18(RESNET_NPZ), jnp.asarray(x))
    with np.load(RESNET_NPZ) as d:
        sd = {k: torch.from_numpy(d[k]) for k in d.files}
    torch.save(sd, tmp_path / "r18.pt")
    for path in (RESNET_NPZ, str(tmp_path / "r18.pt")):
        ex = tf.FeatureExtractor("resnet18", checkpoint=path, device="cpu")
        got = ex.extract(x)
        assert got.shape == (2, 512) and _rel(got, expect) < 1e-4
    with pytest.raises(KeyError, match="resnet18"):
        tr.convert_torch_resnet18({"conv1.weight": np.zeros((64, 1, 7, 7))})


def _densenet_state_dict(seed=0):
    """A seeded torchvision-layout DenseNet-121 state dict (RGB conv0)."""
    r = np.random.default_rng(seed)
    sd = {}

    def conv(key, o, i, k):
        sd[key] = (r.standard_normal((o, i, k, k))
                   / np.sqrt(i * k * k)).astype(np.float32)

    def bn(p, c):
        sd[p + ".weight"] = (1 + 0.1 * r.standard_normal(c)).astype(
            np.float32)
        sd[p + ".bias"] = (0.1 * r.standard_normal(c)).astype(np.float32)
        sd[p + ".running_mean"] = (0.1 * r.standard_normal(c)).astype(
            np.float32)
        sd[p + ".running_var"] = (0.5 + r.random(c)).astype(np.float32)

    conv("features.conv0.weight", 64, 3, 7)
    bn("features.norm0", 64)
    c = 64
    for i, n in enumerate((6, 12, 24, 16), 1):
        for j in range(1, n + 1):
            p = f"features.denseblock{i}.denselayer{j}"
            bn(p + ".norm1", c)
            conv(p + ".conv1.weight", 128, c, 1)
            bn(p + ".norm2", 128)
            conv(p + ".conv2.weight", 32, 128, 3)
            c += 32
        if i < 4:
            bn(f"features.transition{i}.norm", c)
            conv(f"features.transition{i}.conv.weight", c // 2, c, 1)
            c //= 2
    bn("features.norm5", c)
    return sd


def test_densenet121_matches_jax():
    """A seeded DenseNet-121 at 32², the smallest input its four
    transitions allow: 1024-d features within 1e-4 relative of JAX's."""
    sd = _densenet_state_dict()
    x = _x((2, 32, 32, 1), seed=3)
    expect = jax.jit(jd.densenet121_features)(
        jd.convert_torch_densenet121(sd), jnp.asarray(x))
    got = tf.FeatureExtractor(
        "densenet121", params=td.convert_torch_densenet121(sd),
        device="cpu").extract(x)
    assert got.shape == (2, 1024) and _rel(got, expect) < 1e-4


def test_frechet_distance_and_compute_fid_match_jax():
    """Same features -> the same Fréchet distance within 1e-6 relative;
    compute_fid through a host callable on both sides likewise."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((35, 6)) * 1.3 + 0.2
    for fa, fb in ((a, b), (a, a[::-1] + 1e-3)):
        expect = jfid.frechet_distance(*jfid._stats(fa), *jfid._stats(fb))
        got = tfid.frechet_distance(*tfid._stats(fa), *tfid._stats(fb))
        assert abs(got - expect) <= 1e-6 * abs(expect) + 1e-12
    imgs = rng.standard_normal((24, 8, 8, 1)).astype(np.float32)
    gen = imgs[::-1] * 0.8 + 0.1

    def feat(x):
        return np.asarray(x).reshape(len(x), 4, 16).mean(-1)

    def batches(arr):
        return [{"image": arr[i:i + 8]} for i in range(0, len(arr), 8)]

    expect = jfid.compute_fid(jf.FeatureExtractor("torch", model=feat),
                              batches(imgs), batches(gen), max_samples=20)
    got = tfid.compute_fid(tf.FeatureExtractor("torch", model=feat),
                           batches(imgs), batches(gen), max_samples=20)
    assert abs(got - expect) <= 1e-6 * abs(expect)


def test_diffusion_probe_matches_jax_with_injected_noise():
    """The diffusion extractor on the toy CondUNet (same weights), with
    JAX's probe draw injected: the mid_attn output's mean within 1e-4 of
    JAX's; without noise= it draws its own seeded noise, the same every
    call."""
    R = 16
    x = _x((2, R, R, 1), seed=5)
    jm = JaxCondUNet(**TOY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, R, R, 1)),
                            jnp.zeros((2,), jnp.int32),
                            jnp.zeros((2,), jnp.int32))
    params = {"params": random_params(shapes, 3)}
    j_ex = jf.FeatureExtractor("diffusion", params=params, model=jm,
                               schedule=j_make_schedule(100), timestep=37)
    expect = j_ex.extract(x)
    tm = CondUNet(resolution=R, device="cpu", **TOY)
    load_state_dict(tm, params)
    tm.eval()
    t_ex = tf.FeatureExtractor("diffusion", model=tm,
                               schedule=make_schedule(100, device="cpu"),
                               timestep=37, device="cpu")
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), x.shape))
    got = t_ex.extract(x, noise=torch.from_numpy(noise))
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_ex.extract(x), t_ex.extract(x))
    assert tf.find_bottleneck(tm) is tm.mid_attn


def test_classifier_archive_crosses_both_ways_and_training_learns(tmp_path):
    """train_classifier learns a separable toy task; its save_classifier
    archive loads in JAX with the same logits, and a JAX-written archive
    loads in the port."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((32, 16, 16, 1)).astype(np.float32)
    y = (rng.random(32) < 0.5).astype(np.int32)
    x[y == 1] += 1.5
    batches = [{"image": x[i:i + 16], "label": y[i:i + 16]}
               for i in (0, 16)]
    model, metrics = tcls.train_classifier(batches, num_steps=30,
                                           learning_rate=3e-3, device="cpu")
    assert metrics["final_acc"] > 0.9 and np.isfinite(metrics["final_loss"])
    path = str(tmp_path / "cls.npz")
    tf.save_classifier(path, model, meta={"seed": 0})
    jm, jp = jf.load_classifier(path)
    with torch.no_grad():
        tl = model(torch.from_numpy(x[:4])).numpy()
    np.testing.assert_allclose(np.asarray(jm.apply(jp, jnp.asarray(x[:4]))),
                               tl, rtol=1e-5, atol=1e-5)
    jpath = str(tmp_path / "jax.npz")
    jf.save_classifier(jpath, jp, widths=jm.widths, num_classes=2,
                       meta={"from": "jax"})
    back = tf.load_classifier(jpath, device="cpu")
    assert back.meta["from"] == "jax"
    with torch.no_grad():
        np.testing.assert_allclose(back(torch.from_numpy(x[:4])).numpy(),
                                   tl, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """A toy port run (one synthetic step) exported as a run dir, and a
    16² tree with a test split."""
    from superdiff_torch.cli import export, train

    base = tmp_path_factory.mktemp("eval")
    sets = ["model.preset=small64", "model.base_channels=8",
            "model.compute_dtype=float32", "training.resolution=16",
            "training.batch_size=4", "training.num_timesteps=8",
            "training.num_epochs=1", "training.steps_per_epoch=1",
            "training.vis_every=0", f"paths.local_base={base / 'runs'}"]
    argv = ["--synthetic", "--device", "cpu", "--run-id", "toy"]
    for s in sets:
        argv += ["--set", s]
    assert train.main(argv) == 0
    run = next((base / "runs").rglob("config.yaml")).parent
    assert export.main(["--run-dir", str(run), "--out", str(base / "exp"),
                        "--device", "cpu"]) == 0
    rng = np.random.default_rng(7)
    for cls in ("NORMAL", "PNEUMONIA"):
        d = base / "tree" / "PNEUMONIA" / "test" / cls
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (20, 18), dtype=np.uint8)
                            ).save(d / f"{i}.png")
    return str(base / "exp"), str(base / "tree")


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_cli_evaluate_writes_the_jax_keys(toy_run, tmp_path, monkeypatch):
    """cli.evaluate --device cpu on a toy run and tree: eval.json holds
    exactly the keys the JAX CLI writes for the same arguments (FID under
    two extractors, the checkpoint pairs, the SuperDiff block), with
    finite values. The JAX CLI runs with its samplers and FID stubbed out
    (zeros), which leaves the keys it writes as they are."""
    import superdiff_tpu.analysis as j_analysis
    import superdiff_tpu.diffusion as j_diffusion
    import superdiff_tpu.diffusion.superdiff as j_superdiff
    from superdiff_tpu.cli import evaluate as j_evaluate
    from superdiff_torch.cli import evaluate

    def zeros(schedule, fn, shape, rng, **kw):
        return jnp.zeros(shape)

    monkeypatch.setattr(j_diffusion, "ddim_sample", zeros)
    monkeypatch.setattr(j_superdiff, "superdiff_sample",
                        lambda schedule, fns, shape, rng, **kw:
                        (jnp.zeros(shape), jnp.zeros((2, shape[0]))))
    monkeypatch.setattr(j_analysis, "compute_fid", lambda *a, **k: 0.0)
    run, tree = toy_run
    args = ["--run-dir", run, "--run-dir2", run, "--dataset-root", tree,
            "--num-samples", "6", "--batch-size", "4", "--num-steps", "2",
            "--extractor", "random,classifier",
            "--extractor-checkpoint", f"classifier={SMALLCNN_NPZ}"]
    record = {}
    assert evaluate.main(args + ["--out", str(tmp_path / "port.json"),
                                 "--device", "cpu"], record=record) == 0
    assert j_evaluate.main(args + ["--out", str(tmp_path / "jax.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    expect = json.loads((tmp_path / "jax.json").read_text())
    assert _keys(got) == _keys(expect)
    assert got["num_generated"] == 6 and got["sampler_steps"] == 2
    assert all(np.isfinite(v) for v in got["fid_by_extractor"].values())
    assert np.isfinite(got["superdiff"]["logq_gap_mean"])
    assert set(record["extract_s"]) == {"random", "classifier"}
    assert record["samples"].shape == (6, 16, 16, 1)
