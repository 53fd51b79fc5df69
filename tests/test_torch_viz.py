"""The port's visual analysis slice against the JAX package, on the CPU: the
renderer (``utils/raster.py``: matplotlib's ``jet``, GIF), the image
artifacts of ``utils/visualization.py``, Grad-CAM (SmallCNN and backbones),
thumbnails, the projections (standardize, PCA, exact t-SNE against
sklearn's exact and Barnes-Hut runs, UMAP) and the graphed sampler's
trajectory frames. The same numpy inputs, made from a seed, go through both
packages; the JAX side runs with matplotlib, PIL and sklearn, which the
port never imports."""

import base64
import io
import os
import sys

import jax
import jax.numpy as jnp
import matplotlib.cm as mpl_cm
import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE, _t_sne, trustworthiness
from sklearn.metrics import pairwise_distances

from superdiff_tpu.analysis import features as jf
from superdiff_tpu.analysis import gradcam as jg
from superdiff_tpu.analysis import plotly3d as jp3
from superdiff_tpu.analysis import projection as jproj
from superdiff_tpu.analysis import umap_np as jumap
from superdiff_tpu.diffusion import make_schedule as j_make_schedule
from superdiff_tpu.diffusion import q_sample as j_q_sample
from superdiff_tpu.utils import visualization as jvis
from superdiff_torch.analysis import features as tf
from superdiff_torch.analysis import gradcam as tg
from superdiff_torch.analysis import plotly3d as tp3
from superdiff_torch.analysis import projection as tproj
from superdiff_torch.analysis import umap_np as tumap
from superdiff_torch.compat.flax_params import to_flax
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.diffusion import samplers as ts
from superdiff_torch.diffusion.graphed import GraphedSampler
from superdiff_torch.models.unet import CondUNet
from superdiff_torch.utils import raster
from superdiff_torch.utils import visualization as tvis
from test_analysis import (_fake_densenet121_state_dict,
                           _fake_torchvision_resnet18_state_dict,
                           _torch_resnet18_gradcam_oracle)

torch.set_num_threads(1)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im), dict(im.text)


def _blobs(n_per=20, dim=16, seed=0):
    """Three separated Gaussian blobs; ``dim`` >= N / 10 keeps sklearn's PCA
    on its full solver."""
    r = np.random.default_rng(seed)
    x = np.concatenate([r.normal(0, 1, (n_per, dim)) + c
                        for c in (0.0, 5.0, -5.0)])
    return x, np.repeat(np.arange(3), n_per)


# --------------------------------------------------------------- raster ----

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jet_matches_matplotlib(dtype):
    """The 256-entry LUT from jet's segment data and matplotlib's index
    rule, at every LUT boundary, 0, 1, out of range and NaN: <= 1e-7."""
    x = np.concatenate([np.linspace(-0.1, 1.1, 4097),
                        np.arange(257) / 256, [0.0, 1.0, np.nan]])
    x = x.astype(dtype)
    got = raster.jet(x)
    assert got.shape == x.shape + (3,)
    np.testing.assert_allclose(got, mpl_cm.jet(x)[..., :3], rtol=0,
                               atol=1e-7)


def test_gif_decodes_to_the_frames():
    """``gif_bytes``: a looping GIF89a that PIL decodes to the exact frames
    (few colours), or to the 6-level cube (many colours)."""
    r = np.random.default_rng(1)
    frames = (r.integers(0, 4, (3, 23, 37, 1)) * 60).repeat(3, -1)
    data = raster.gif_bytes(frames.astype(np.uint8))
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    with Image.open(io.BytesIO(data)) as im:
        assert im.n_frames == 3
        for k in range(3):
            im.seek(k)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          frames[k])
    many = r.integers(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    with Image.open(io.BytesIO(raster.gif_bytes(many))) as im:
        im.seek(1)
        got = np.asarray(im.convert("RGB")).astype(int)
    assert np.abs(got - many[1]).max() <= 26


# ------------------------------------------------------ visualization ------

def test_to_display_array_and_show_image_match_jax(tmp_path):
    """The JAX test's layouts (HW, HWC, CHW, batch of one, RGB, a PIL
    image) give JAX's arrays; ``show_image`` writes them as PNGs."""
    r = np.random.default_rng(2)
    cases = [r.normal(size=(9, 7)), r.normal(size=(9, 7, 1)),
             r.normal(size=(1, 9, 7)), r.normal(size=(1, 1, 9, 7)),
             r.normal(size=(9, 7, 3)), r.normal(size=(3, 9, 7)),
             Image.fromarray(r.integers(0, 256, (9, 7), dtype=np.uint8))]
    for img in cases:
        want = jvis.to_display_array(img)
        np.testing.assert_allclose(tvis.to_display_array(img), want,
                                   rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        tvis.to_display_array(torch.from_numpy(cases[2])),
        jvis.to_display_array(cases[2]), rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="cannot display"):
        tvis.to_display_array(np.zeros((2, 2, 2, 2, 2)))
    gray, text = _png(tvis.show_image(cases[0], str(tmp_path / "g.png"),
                                      title="t"))
    np.testing.assert_array_equal(
        gray, np.round(jvis.to_display_array(cases[0]) * 255))
    assert text == {"Title": "t"}
    rgb, _ = _png(tvis.show_image(cases[4], str(tmp_path / "c.png")))
    assert rgb.shape == (9, 7, 3)
    jet_png, _ = _png(tvis.show_image(cases[0], str(tmp_path / "j.png"),
                                      cmap="jet"))
    np.testing.assert_array_equal(
        jet_png, np.round(raster.jet(jvis.to_display_array(cases[0]))
                          * 255))


def test_image_artifacts(tmp_path):
    """Real-vs-generated rows, the reverse strip, the loss curve and the
    histogram: tiles as ``save_image_grid`` scales them, labels in the
    text, and the histogram's counts those of ``np.histogram(bins=50)``."""
    r = np.random.default_rng(3)
    real, gen = r.normal(size=(10, 8, 8, 1)), r.normal(size=(9, 8, 8, 1))
    img, text = _png(tvis.save_real_vs_generated(real, gen,
                                                 str(tmp_path / "rg.png")))
    assert img.shape == (2 * 8 + 2, 8 * 8 + 7 * 2, 3)     # 8 columns
    for row, src in ((0, real), (1, gen)):
        tile = img[row * 10:row * 10 + 8, 10:18, 0]
        want = src[1, ..., 0]
        want = np.round((want - want.min()) / (want.max() - want.min())
                        * 255)
        np.testing.assert_array_equal(tile, want)
    assert "real" in text["Title"]
    frames = r.normal(size=(5, 2, 8, 8, 1))
    strip, text = _png(tvis.save_reverse_trajectory_strip(
        frames, str(tmp_path / "tr.png")))
    assert strip.shape == (8, 5 * 8 + 4 * 2, 3)
    assert text["Comment"].split(" | ") == [f"frame {k}" for k in range(5)]
    curve, text = _png(tvis.save_loss_curve(np.linspace(1, 0, 30),
                                            str(tmp_path / "loss.png")))
    assert curve.shape == (350, 600, 3) and text["YLabel"] == "loss"
    assert (curve != 255).any(axis=-1).sum() > 600        # frame and line
    pixels = r.normal(size=(4, 8, 8, 1)).astype(np.float32)
    _, text = _png(tvis.save_pixel_histogram(pixels,
                                             str(tmp_path / "h.png")))
    counts, edges = np.histogram(pixels.ravel(), bins=50)
    assert [int(c) for c in text["Counts"].split()] == counts.tolist()
    np.testing.assert_allclose([float(e) for e in text["Edges"].split()],
                               edges, rtol=1e-8)


def test_forward_strip_frames_match_jax(tmp_path):
    """``q_sample`` frames of the first image at the CLI's five timesteps,
    with JAX's noise injected: <= 1e-6; the strip has six tiles."""
    T = 20
    x0 = np.random.default_rng(4).normal(size=(2, 8, 8, 1)).astype(
        np.float32)
    ts_ = [0, T // 4, T // 2, 3 * T // 4, T - 1]
    js = j_make_schedule(T)
    noise = jax.random.normal(jax.random.PRNGKey(2), (1, 8, 8, 1))
    jq = jax.jit(lambda x, t, n: j_q_sample(js, x, t, n))
    want = [x0[0]] + [np.asarray(jq(jnp.asarray(x0[:1]), jnp.asarray([t]),
                                    noise)[0]) for t in ts_]
    s = make_schedule(T, device="cpu")
    got = tvis.forward_diffusion_frames(s, x0, ts_,
                                        noise=np.asarray(noise))
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-6)
    strip, text = _png(tvis.save_forward_diffusion_strip(
        s, x0, ts_, torch.Generator().manual_seed(0),
        str(tmp_path / "f.png")))
    assert strip.shape == (8, 6 * 8 + 5 * 2, 3)
    assert text["Comment"] == "x0 | t=0 | t=5 | t=10 | t=15 | t=19"


def test_graphed_sampler_frames_equal_eager_frames():
    """``GraphedSampler(num_frames=8)`` (the step run eagerly on the CPU)
    records the eager ``ddpm_sample(num_frames=8)``'s frames and samples
    bit for bit, at ``make_frame_recorder``'s positions."""
    s = make_schedule(20, device="cpu")
    m = CondUNet(resolution=8, base_channels=8, channel_mults=(1, 2),
                 num_res_blocks=1, attn_resolutions=(4,), num_heads=2,
                 num_classes=0, time_emb_dim=16, groups=4,
                 device="cpu").init_parameters(3).eval()
    fn = lambda x, t: m(x, t)
    x, frames = ts.ddpm_sample(s, fn, (2, 8, 8, 1),
                               torch.Generator().manual_seed(5),
                               num_frames=8)
    gx, gframes = GraphedSampler(ts.DDPMPlan(s, fn, (2, 8, 8, 1)))(
        torch.Generator().manual_seed(5), num_frames=8)
    assert gframes.shape == (8, 2, 8, 8, 1)
    assert torch.equal(gx, x) and torch.equal(gframes, frames)
    assert torch.equal(gframes[-1], x)
    assert not torch.equal(gframes[0], gframes[1])


# ----------------------------------------------------------- Grad-CAM ------

@pytest.mark.parametrize("shape", [(4, 4, 32, 32), (2, 3, 17, 29),
                                   (1, 1, 8, 8), (7, 5, 7, 5)])
def test_overlay_heatmap_matches_jax(shape):
    """``F.interpolate`` bilinear against ``jax.image.resize`` when
    upsampling (and at the same size), every pixel including the edges,
    then jet and the blend: <= 1e-6."""
    h, w, H, W = shape
    r = np.random.default_rng(h * 10 + w)
    cam = r.random((h, w)).astype(np.float32)
    img = r.normal(size=(H, W, 1)).astype(np.float32)
    want = jg.overlay_heatmap(img, cam)
    got = tg.overlay_heatmap(img, cam)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("class_idx", [None, 1])
def test_smallcnn_gradcam_matches_jax(class_idx):
    """One Flax-layout weight tree (Flax-default initial weights, drawn by
    the port) in JAX's SmallCNN and, through ``smallcnn_from_flax``, in the
    port's: the CAM within 1e-5 and the same predicted class."""
    jm = jf.SmallCNN(num_classes=2)
    x = np.random.default_rng(6).normal(size=(32, 32, 1)).astype(np.float32)
    params = {"params": to_flax(tf.SmallCNN(2, device="cpu")
                                .init_parameters(3))}
    want, jpred = jg.compute_gradcam(jm, params, jnp.asarray(x), class_idx)
    model = tf.smallcnn_from_flax(params, jm.widths, 2, device="cpu")
    got, pred = tg.compute_gradcam(model, x, class_idx)
    assert pred == jpred and got.shape == want.shape == (4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _densenet_oracle(sd, img):
    """The reference's hook-style CAM on a torchvision-layout DenseNet-121
    written with ``F.batch_norm`` (grayscale fed three times): the
    ``relu(norm5)`` map detached as a leaf, the logit's gradient."""
    import torch.nn.functional as F

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}

    def bn(h, p):
        return F.batch_norm(h, t[f"{p}.running_mean"], t[f"{p}.running_var"],
                            t[f"{p}.weight"], t[f"{p}.bias"], training=False)

    h = torch.from_numpy(img[None]).permute(0, 3, 1, 2).repeat(1, 3, 1, 1)
    h = F.relu(bn(F.conv2d(h, t["features.conv0.weight"], stride=2,
                           padding=3), "features.norm0"))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for i, n in enumerate((6, 12, 24, 16), 1):
        for j in range(1, n + 1):
            p = f"features.denseblock{i}.denselayer{j}"
            y = F.conv2d(F.relu(bn(h, p + ".norm1")), t[p + ".conv1.weight"])
            y = F.conv2d(F.relu(bn(y, p + ".norm2")), t[p + ".conv2.weight"],
                         padding=1)
            h = torch.cat([h, y], dim=1)
        if i < 4:
            p = f"features.transition{i}"
            h = F.avg_pool2d(F.conv2d(F.relu(bn(h, p + ".norm")),
                                      t[p + ".conv.weight"]), 2)
    feats = F.relu(bn(h, "features.norm5")).detach().requires_grad_(True)
    logits = (feats.mean(dim=(2, 3)) @ t["classifier.weight"].T
              + t["classifier.bias"])
    pred = int(logits.argmax(dim=1))
    logits[0, pred].backward()
    weights = feats.grad[0].mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * feats.detach()[0]).sum(dim=0))
    return (cam / cam.max()).numpy(), pred


@pytest.mark.parametrize("backbone", ["resnet18", "densenet121"])
def test_backbone_gradcam_matches_jax_and_the_hook_oracle(backbone,
                                                          tmp_path):
    """A torchvision-layout checkpoint with its head: the port's CAM within
    1e-4 of JAX's (its feature map jitted) and of the hook-based torch
    oracle (the JAX tests' own for resnet18), the same class; a headless
    checkpoint raises JAX's ``KeyError``."""
    r = np.random.default_rng(8)
    if backbone == "resnet18":
        sd = _fake_torchvision_resnet18_state_dict(seed=5)
        size, oracle, head = 64, _torch_resnet18_gradcam_oracle, "fc"
    else:
        sd = _fake_densenet121_state_dict(seed=8)
        sd["classifier.weight"] = (r.standard_normal((3, 1024)) * 0.05
                                   ).astype(np.float32)
        sd["classifier.bias"] = np.zeros(3, np.float32)
        size, oracle, head = 64, _densenet_oracle, "classifier"
    path = str(tmp_path / f"{backbone}.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    img = r.standard_normal((size, size, 1)).astype(np.float32)
    jfmap, jhead = jg.make_backbone_cam_fns(backbone, path)
    # the feature map compiled once, at XLA's lowest backend optimisation
    # level (it runs once)
    jfmap = jax.jit(jfmap).lower(jnp.asarray(img[None])).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    want, jpred = jg.compute_gradcam_from_fns(jfmap, jhead,
                                              jnp.asarray(img))
    fmap, head_fn = tg.make_backbone_cam_fns(backbone, path, device="cpu")
    got, pred = tg.compute_gradcam_from_fns(fmap, head_fn, img,
                                            device="cpu")
    ocam, opred = oracle(sd, img)
    assert pred == jpred == opred and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, ocam, rtol=0, atol=1e-4)
    headless = {k: v for k, v in sd.items() if not k.startswith(head)}
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in headless.items()}, path)
    with pytest.raises(KeyError, match=f"{head} head"):
        tg.make_backbone_cam_fns(backbone, path, device="cpu")


def test_run_gradcam_writes_panels(tmp_path):
    """``run_gradcam``: ``gradcam_{i}.png``, input beside overlay, the
    overlay tile JAX's overlay of the port's CAM (to 8 bits)."""
    model = tf.SmallCNN(2, device="cpu").init_parameters(1).eval()
    imgs = np.random.default_rng(9).normal(size=(3, 16, 16, 1)).astype(
        np.float32)
    paths = tg.run_gradcam(model, imgs, str(tmp_path / "cam"),
                           max_images=2, class_names=["NORMAL", "TB"])
    assert [os.path.basename(p) for p in paths] == ["gradcam_0.png",
                                                    "gradcam_1.png"]
    panel, text = _png(paths[1])
    assert panel.shape == (16, 36, 3) and "Grad-CAM" in text["Title"]
    cam, _ = tg.compute_gradcam(model, imgs[1])
    np.testing.assert_array_equal(
        panel[:, 20:], np.round(jg.overlay_heatmap(imgs[1], cam) * 255))


# ---------------------------------------------------------- thumbnails -----

@pytest.mark.parametrize("kind", ["gray_float", "gray_u8_hw1",
                                  "rgb_float", "rgb_u8"])
def test_thumbnail_data_uri_pixels_equal_jax(kind):
    """The port's PNG data URI decodes to the pixels of JAX's PIL-made one
    (min-max scaling truncated to uint8, PIL's default bicubic resize), at
    a downscale and an upscale."""
    r = np.random.default_rng(len(kind))
    shape = {"gray_float": (37, 53), "gray_u8_hw1": (40, 30, 1),
             "rgb_float": (29, 41, 3), "rgb_u8": (64, 48, 3)}[kind]
    img = (r.integers(0, 256, shape, dtype=np.uint8) if "u8" in kind
           else r.normal(size=shape).astype(np.float32) * 3)

    def pixels(uri):
        head, b64 = uri.split(",", 1)
        assert head == "data:image/png;base64"
        with Image.open(io.BytesIO(base64.b64decode(b64))) as im:
            return np.asarray(im)

    for size in (24, 96):
        np.testing.assert_array_equal(
            pixels(tp3.thumbnail_data_uri(img, size)),
            pixels(jp3.thumbnail_data_uri(img, size)))
    assert tp3.hover_html("TB", img).startswith('TB<br><img src="data:')


# --------------------------------------------------------- projections -----

def test_standardize_and_pca_match_sklearn():
    """``_standardize`` equals the JAX package's; PCA equals sklearn's
    ``PCA(n).fit_transform`` (full solver, svd_flip signs): <= 1e-6."""
    x, _ = _blobs()
    x[:, 3] = 2.5                                  # a constant feature
    xs = tproj._standardize(x)
    np.testing.assert_allclose(xs, jproj._standardize(x), rtol=0, atol=1e-12)
    for k in (2, 3):
        np.testing.assert_allclose(tproj.pca(xs, k, "cpu").numpy(),
                                   PCA(k, random_state=42).fit_transform(xs),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_per", [7, 20])
def test_tsne_joint_probabilities_match_sklearn(n_per):
    """The binary search on the perplexity and the symmetrised P against
    sklearn's exact ``_joint_probabilities``: <= 1e-6."""
    x, _ = _blobs(n_per)
    xs = tproj._standardize(x)
    perp = tproj.perplexity_for(len(xs))
    want = _t_sne._joint_probabilities(
        pairwise_distances(xs, squared=True), perp, 0)
    got = tproj.joint_p(xs, perp, "cpu").numpy()
    iu = np.triu_indices(len(xs), 1)
    np.testing.assert_allclose(got[iu], want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.diag(got), 0.0)


@pytest.mark.parametrize("n_components", [2, 3])
def test_exact_tsne_matches_sklearn_exact_with_the_same_init(n_components):
    """From the same float32 init, the port's t-SNE and sklearn's
    ``TSNE(method="exact")`` (1000 iterations, early exaggeration, gains,
    checks) end at the same embedding: the largest difference found here
    is 0.0, asserted within 1e-5 of embedding values up to ~20."""
    x, _ = _blobs()
    xs = tproj._standardize(x)
    perp = tproj.perplexity_for(len(xs))
    init = PCA(n_components, random_state=42).fit_transform(xs).astype(
        np.float32)
    init = init / np.std(init[:, 0]) * 1e-4
    sk = TSNE(n_components, random_state=42, perplexity=perp, init=init,
              method="exact")
    want = sk.fit_transform(xs)
    got = tproj.tsne(xs, n_components, init=init, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _exact_kl(xs, emb):
    """KL(P || Q) of an embedding under the exact P (the port's)."""
    p = tproj.joint_p(xs, tproj.perplexity_for(len(xs)), "cpu")
    y = torch.from_numpy(np.asarray(emb, np.float32))
    off = ~torch.eye(len(xs), dtype=torch.bool)
    err, _ = tproj._kl_and_grad(y, p, float(max(emb.shape[1] - 1, 1)), off,
                                True)
    return float(err)


@pytest.mark.parametrize("seed", [0, 11])
def test_tsne_agrees_with_the_jax_default_barnes_hut(seed):
    """``_project("tsne", 2)`` against the JAX package's (sklearn's default
    Barnes-Hut) on separated blobs: trustworthiness (k=5) within 0.02 and
    the exact KL of the final embedding within 5 %. (In 3D, sklearn's own
    exact method, which the port equals, scores 0.73-0.78 here against
    Barnes-Hut's 0.83-0.84.)"""
    x, _ = _blobs(seed=seed)
    want = jproj._project(x, "tsne", 2)
    got = tproj._project(x, "tsne", 2, device="cpu")
    assert got.shape == want.shape == (60, 2)
    xs = tproj._standardize(x)
    assert abs(trustworthiness(xs, got, n_neighbors=5)
               - trustworthiness(xs, want, n_neighbors=5)) <= 0.02
    kl_got, kl_want = _exact_kl(xs, got), _exact_kl(xs, want)
    assert abs(kl_got - kl_want) <= 0.05 * kl_want


def test_umap_is_bit_equal_to_jax_and_pca_projection():
    """The port's NumPy UMAP copy gives the JAX package's bits; ``_project``
    routes umap and pca, and refuses an unknown method."""
    x, _ = _blobs(10, seed=12)
    np.testing.assert_array_equal(tumap.umap_embed(x, 2, n_epochs=60),
                                  jumap.umap_embed(x, 2, n_epochs=60))
    np.testing.assert_array_equal(tproj._project(x, "umap", 3),
                                  jproj._project(x, "umap", 3))
    np.testing.assert_allclose(tproj._project(x, "pca", 2, device="cpu"),
                               jproj._project(x, "pca", 2), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown projection"):
        tproj._project(x, "isomap", 2, device="cpu")


def test_projection_figures(tmp_path, monkeypatch):
    """The figures: a scatter with the legend in its text, thumbnails, the
    t-SNE / UMAP pair, the 3D view and its rotation GIF, and the plotly
    HTML refused with JAX's ImportError when plotly is missing."""
    x, y = _blobs(6, seed=13)
    imgs = np.random.default_rng(0).normal(size=(len(x), 12, 12, 1))
    names = ["TB", "NORMAL", "PNEUMONIA"]
    img, text = _png(tproj.run_projection(x, y, "pca", str(tmp_path / "p.png"),
                                          class_names=names, device="cpu"))
    assert img.shape == (500, 600, 3)
    assert text["Legend"] == "green: TB | red: NORMAL | royalblue: PNEUMONIA"
    for c in raster.CLASS_COLORS[:3]:
        assert (img == c).all(axis=-1).any()
    thumbs, _ = _png(tproj.run_projection_with_thumbnails(
        x, y, imgs, "pca", str(tmp_path / "t.png"), device="cpu"))
    assert thumbs.shape == (700, 800, 3)
    pair, _ = _png(tproj.compare_tsne_umap_thumbnails(
        x, y, imgs, str(tmp_path / "tu.png"), device="cpu"))
    assert pair.shape == (700, 1408, 3)
    gif = str(tmp_path / "rot.gif")
    view, text = _png(tproj.run_projection_3d(
        x, y, "pca", str(tmp_path / "3d.png"), class_names=names,
        animate_path=gif, animate_frames=3, device="cpu"))
    assert view.shape == (600, 700, 3) and text["Title"] == "pca 3D"
    with Image.open(gif) as im:
        assert im.n_frames == 3 and im.size == (560, 480)
    monkeypatch.setitem(sys.modules, "plotly", None)
    with pytest.raises(ImportError, match="plotly"):
        tp3.run_plotly_projection_3d_with_thumbnails(
            x, y, imgs, str(tmp_path / "p.html"), method="pca",
            device="cpu")
