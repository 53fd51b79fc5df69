"""The port's data layer (superdiff_torch.data) against the JAX package's and
against PIL / OpenCV, on the CPU: decode, host resize, CLAHE, the batch
iterators, the splitter, the native shard loader, the datamodule and
training on a tree."""

import json
import os
import shutil
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import superdiff_tpu.data.native_loader as j_native
from superdiff_tpu.config import Config as JConfig
from superdiff_tpu.data import DataModule as JDataModule
from superdiff_tpu.data.dataset import BatchIterator as JBatchIterator
from superdiff_tpu.data.dataset import ChestXrayIndex as JIndex
from superdiff_tpu.data.dataset import decode_image as j_decode_image
from superdiff_tpu.data.split import split_dataset as j_split
from superdiff_tpu.data.transforms import clahe as j_clahe
from superdiff_tpu.data.transforms import host_resize as j_host_resize
from superdiff_torch import config as tcfg
from superdiff_torch.data import (
    BatchIterator, ChestXrayIndex, DataModule, clahe, host_resize,
    prepare_batch, split_dataset)
from superdiff_torch.data import image_io
from superdiff_torch.data import native_loader
from superdiff_torch.data.dataset import decode_image
from superdiff_torch.ops import _build
from superdiff_torch.utils.visualization import png_bytes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(rng, h, w):
    """A smooth gradient plus noise: every filter type and value range."""
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 256
    return ((base + rng.integers(0, 40, (h, w))) % 256).astype(np.uint8)


def _pil_png(im, path):
    im.save(path, format="PNG")
    return path


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """PNG and BMP files of every kind the decoder takes, written by PIL
    (whose encoder picks row filters adaptively) and by the port's writer
    (each filter type in turn)."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    a = _image(rng, 37, 53)
    rgb = np.stack([a, a[::-1], 255 - a], axis=-1)
    files = {
        "gray8": _pil_png(Image.fromarray(a, "L"), d / "gray8.png"),
        "rgb": _pil_png(Image.fromarray(rgb, "RGB"), d / "rgb.png"),
        "rgba": _pil_png(Image.fromarray(np.dstack([rgb, a]), "RGBA"),
                         d / "rgba.png"),
        "gray_alpha": _pil_png(Image.fromarray(np.dstack([a, a[::-1]]),
                                               "LA"), d / "la.png"),
        "palette": _pil_png(Image.fromarray(rgb, "RGB").quantize(64),
                            d / "palette.png"),
        "palette4": _pil_png(Image.fromarray(rgb, "RGB").quantize(16),
                             d / "palette4.png"),
        "bilevel": _pil_png(Image.fromarray(a > 128), d / "bilevel.png"),
    }
    for name, fmt_im in (("bmp24", Image.fromarray(rgb, "RGB")),
                         ("bmp8", Image.fromarray(rgb, "RGB").quantize(64))):
        fmt_im.save(d / f"{name}.bmp", format="BMP")
        files[name] = d / f"{name}.bmp"
    # 16-bit grayscale: values above 255 (PIL's I;16 -> L clips them)
    wide = (a.astype(np.uint16) * 257 // 3 + np.uint16(100))
    (d / "gray16.png").write_bytes(png_bytes(wide, filter="cycle"))
    files["gray16"] = d / "gray16.png"
    for f in range(5):
        (d / f"filter{f}.png").write_bytes(png_bytes(a, filter=f))
        files[f"filter{f}"] = d / f"filter{f}.png"
        (d / f"rgb_filter{f}.png").write_bytes(png_bytes(rgb, filter=f))
        files[f"rgb_filter{f}"] = d / f"rgb_filter{f}.png"
    return {k: str(v) for k, v in files.items()}


def test_decode_equals_pil_convert_l(images):
    """read_gray equals PIL.Image.open(p).convert("L") bit for bit for 8-
    and 16-bit grayscale, RGB(A), gray+alpha, palette (8 and 4 bits),
    bilevel and BMP files, and for each row filter."""
    for name, path in images.items():
        with Image.open(path) as im:
            expect = np.asarray(im.convert("L"))
        got = image_io.read_gray(path)
        assert got.dtype == np.uint8 and got.shape == expect.shape, name
        np.testing.assert_array_equal(got, expect, err_msg=name)


def test_sixteen_bit_gray_clips_at_255(tmp_path):
    """16-bit grayscale becomes min(v, 255), as PIL's I;16 -> L does (the
    JAX package gets those bits), not v >> 8."""
    v = np.array([[0, 200, 255, 256, 1000, 65535]], dtype=np.uint16)
    path = tmp_path / "wide.png"
    path.write_bytes(png_bytes(v))
    with Image.open(path) as im:
        assert im.mode == "I;16"
        expect = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(expect, [[0, 200, 255, 255, 255, 255]])
    np.testing.assert_array_equal(image_io.read_gray(str(path)), expect)


@pytest.mark.parametrize("bpp,filt", [(1, "cycle"), (3, "cycle"), (2, 3),
                                      (1, 4)])
def test_native_unfilter_equals_plain(bpp, filt):
    """The C++ row unfilter (built by g++ into build/) equals its numpy
    plain version on every filter type."""
    rng = np.random.default_rng(bpp)
    img = (rng.integers(0, 256, (11, 13)).astype(np.uint16) * 257
           if bpp == 2 else _image(rng, 11, 13))
    if bpp == 3:
        img = np.dstack([img, img[::-1], img[:, ::-1]])
    data = png_bytes(img, filter=filt)
    i = data.index(b"IDAT")
    n = int.from_bytes(data[i - 4:i], "big")
    raw = np.frombuffer(zlib.decompress(data[i + 4:i + 4 + n]), np.uint8)
    rowbytes = 13 * bpp
    assert image_io.unfilter_backend() == "native"
    np.testing.assert_array_equal(
        image_io.unfilter(raw, 11, rowbytes, bpp),
        image_io.unfilter_plain(raw, 11, rowbytes, bpp))


def test_adam7_and_unknown_formats_raise(tmp_path, monkeypatch):
    a = np.zeros((8, 8), np.uint8)
    path = tmp_path / "inter.png"
    Image.fromarray(a).save(path, format="PNG")
    data = bytearray(path.read_bytes())
    data[28] = 1                                     # IHDR interlace byte
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Adam7"):
        image_io.decode_png(bytes(data))
    data[28], data[24], data[25] = 0, 4, 2           # RGB at 4 bits
    with pytest.raises(ValueError, match="colour type 2 at 4 bits"):
        image_io.decode_png(bytes(data))
    jpg = tmp_path / "x.jpg"
    Image.fromarray(a).save(jpg, format="JPEG")
    with Image.open(jpg) as im:
        expect = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(image_io.read_gray(str(jpg)), expect)
    # the JPEG decoder is the port's own: PIL's bits without PIL
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(image_io.read_gray(str(jpg)), expect)


@pytest.mark.parametrize("strategy", ["pad", "center_crop", "resize"])
@pytest.mark.parametrize("hw,R", [((37, 53), 16), ((37, 53), 64),
                                  ((200, 120), 64), ((9, 12), 16),
                                  ((64, 64), 64)])
def test_host_resize_equals_jax(strategy, hw, R):
    """host_resize on a uint8 array equals the JAX package's PIL-based
    host_resize, down- and up-scaling, and an image smaller than R."""
    rng = np.random.default_rng(hw[0] * R)
    a = _image(rng, *hw)
    expect = j_host_resize(Image.fromarray(a, "L"), R, strategy)
    got = host_resize(a, R, strategy)
    assert got.shape == (R, R)
    np.testing.assert_array_equal(got, expect)


def test_bilinear_bicubic_and_crop_equal_pil():
    rng = np.random.default_rng(3)
    a = _image(rng, 70, 45)
    for size in [(45, 140), (10, 7), (300, 20), (46, 70)]:
        for kind, flt in (("bilinear", Image.BILINEAR),
                          ("bicubic", Image.BICUBIC)):
            expect = np.asarray(Image.fromarray(a).resize(size, flt))
            np.testing.assert_array_equal(image_io.resize_u8(a, size, kind),
                                          expect)
    for box in [(-3, -2, 40, 90), (30, 60, 50, 75), (0, 0, 45, 70)]:
        np.testing.assert_array_equal(image_io.crop_u8(a, box),
                                      np.asarray(Image.fromarray(a).crop(box)))


def test_decode_image_equals_jax(tmp_path):
    """decode_image's pre-shrink (PIL's default bicubic) equals JAX's."""
    rng = np.random.default_rng(4)
    path = tmp_path / "big.png"
    Image.fromarray(_image(rng, 90, 61)).save(path)
    for size in (16, 40, 64):
        np.testing.assert_array_equal(decode_image(str(path), size),
                                      j_decode_image(str(path), size))


@pytest.mark.parametrize("hw", [(256, 256), (250, 190)])
def test_clahe_equals_opencv(hw):
    """clahe equals the JAX package's cv2 CLAHE bit for bit (0 levels off on
    every pixel) at 256² and at a size not divisible by the 8x8 grid, on a
    textured and on a low-contrast image (whose clipped histograms spread
    a residual)."""
    rng = np.random.default_rng(hw[1])
    for a in (_image(rng, *hw), rng.integers(100, 110, hw).astype(np.uint8)):
        expect = j_clahe(a)
        got = clahe(a)
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(
            got, cv2.createCLAHE(2.0, (8, 8)).apply(a))


# ------------------------------------------------------------ the tree ----

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/PNEUMONIA/{train,val,test}/{NORMAL,PNEUMONIA}/*.png of varied
    sizes and kinds (8-bit PIL PNGs, port-written 16-bit and RGB PNGs with
    every filter); val holds 3 images per class (smaller than a batch of
    8)."""
    root = tmp_path_factory.mktemp("xray")
    rng = np.random.default_rng(0)
    for split, n in (("train", 10), ("val", 3), ("test", 4)):
        for ci, cls in enumerate(["NORMAL", "PNEUMONIA"]):
            d = root / "PNEUMONIA" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                a = _image(rng, 30 + 7 * ci + i, 41 - 3 * i)
                if i % 3 == 0:
                    Image.fromarray(a, "L").save(d / f"img{i}.png")
                elif i % 3 == 1:
                    (d / f"img{i}.png").write_bytes(png_bytes(
                        a.astype(np.uint16) * 2, filter=i % 5))
                else:
                    (d / f"img{i}.png").write_bytes(png_bytes(
                        np.dstack([a, a[::-1], a]), filter="cycle"))
    return str(root)


def _same_batches(a, b, n_epochs=2):
    for _ in range(n_epochs):
        got, expect = list(a), list(b)
        assert len(got) == len(expect) == len(a) == len(b)
        for g, e in zip(got, expect):
            assert g["image"].dtype == np.uint8
            np.testing.assert_array_equal(g["image"], e["image"])
            np.testing.assert_array_equal(g["label"], e["label"])
            assert g["label"].dtype == np.int32


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
@pytest.mark.parametrize("strategy,he", [("pad", False), ("resize", True)])
def test_batch_iterator_equals_jax(tree, shard, strategy, he):
    """uint8 batches, labels and order equal the JAX BatchIterator's bit
    for bit over 2 epochs, with and without shard=, with CLAHE."""
    kw = dict(batch_size=3, resolution=16, seed=5, resize_strategy=strategy,
              histogram_equalization=he, shard=shard)
    idx = ChestXrayIndex(tree, task="PNEUMONIA", split="train")
    jidx = JIndex(tree, task="PNEUMONIA", split="train")
    assert idx.samples == jidx.samples and idx.classes == jidx.classes
    _same_batches(BatchIterator(idx, **kw), JBatchIterator(jidx, **kw))


def test_index_class_filter_and_counts(tree):
    idx = ChestXrayIndex(tree, task="PNEUMONIA", split="val",
                         class_filter=1)
    j = JIndex(tree, task="PNEUMONIA", split="val", class_filter=1)
    assert idx.samples == j.samples and idx.class_counts() == j.class_counts()
    with pytest.raises(FileNotFoundError):
        ChestXrayIndex(tree, task="TB", split="train")


def test_split_dataset_equals_jax(tmp_path):
    src = tmp_path / "flat"
    for cls in ("NORMAL", "TB"):
        (src / cls).mkdir(parents=True)
        for i in range(23):
            (src / cls / f"{cls}{i}.png").write_bytes(b"x")
    counts = {}
    for name, fn in (("port", split_dataset), ("jax", j_split)):
        counts[name] = fn(str(src), str(tmp_path / name), seed=7)
    assert counts["port"] == counts["jax"]

    def listing(root):
        return sorted((os.path.relpath(dp, root), sorted(
            (f, os.readlink(os.path.join(dp, f))) for f in fs))
            for dp, _, fs in os.walk(root))

    assert listing(tmp_path / "port") == listing(tmp_path / "jax")
    # a second call is a no-op; copy mode writes files
    assert split_dataset(str(src), str(tmp_path / "port")) == counts["port"]
    split_dataset(str(src), str(tmp_path / "copy"), link=False)
    f = next(p for p in (tmp_path / "copy").rglob("*.png"))
    assert f.is_file() and not f.is_symlink()
    res = subprocess.run([sys.executable, "-m", "superdiff_torch.data.split",
                          str(src), str(tmp_path / "cli"), "--seed", "7"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=60)
    assert res.returncode == 0, res.stderr
    assert listing(tmp_path / "cli") == listing(tmp_path / "jax")


@pytest.fixture
def jax_native_on_port_lib(monkeypatch):
    """The JAX NativeBatchIterator over the same C++ source, bound to the
    port's build in build/ (so this file never runs `make -C native`)."""
    lib = native_loader.get_lib()
    assert lib is not None
    monkeypatch.setattr(j_native, "_lib", lib)
    monkeypatch.setattr(j_native, "_lib_tried", True)
    return lib


@pytest.mark.parametrize("shard", [None, (1, 3)])
def test_native_shards_cross_both_ways(tree, tmp_path, shard,
                                       jax_native_on_port_lib):
    """A shard written by either package's build_shard_from_index is read
    by the port's NativeBatchIterator with batches equal to the JAX
    NativeBatchIterator's (same epoch seeds, shard semantics), and both
    shards hold the same bytes."""
    idx = ChestXrayIndex(tree, task="PNEUMONIA", split="train")
    jidx = JIndex(tree, task="PNEUMONIA", split="train")
    p_path = native_loader.build_shard_from_index(
        idx, str(tmp_path / "port.xrc"), 16)
    j_path = j_native.build_shard_from_index(jidx, str(tmp_path / "jax.xrc"),
                                             16)
    with open(p_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    for path in (p_path, j_path):
        _same_batches(
            native_loader.NativeBatchIterator(path, 4, seed=3, shard=shard),
            j_native.NativeBatchIterator(path, 4, seed=3, shard=shard))


def test_native_library_builds_into_build_not_native(monkeypatch):
    """The loader's .so comes from g++ into build/superdiff_torch/; no
    `make` runs and nothing is written into native/."""
    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", spy)
    so = _build.build_host("xraycache")
    assert os.path.dirname(so) == os.path.join(REPO, "build",
                                               "superdiff_torch")
    assert not any(os.path.basename(c[0]) == "make" for c in calls)
    assert all("native" not in os.path.relpath(c[c.index("-o") + 1], REPO)
               .split(os.sep)[0] for c in calls if "-o" in c)
    assert so.name.startswith("xraycache_")


def _cfgs(tree_root, **training):
    jc, tc = JConfig(), tcfg.Config()
    for c in (jc, tc):
        c.task = "PNEUMONIA"
        for k, v in dict(batch_size=4, resolution=16, seed=11,
                         **training).items():
            setattr(c.training, k, v)
    return jc, tc


@pytest.mark.parametrize("native", [False, True])
def test_datamodule_epoch_counter_equals_jax(tree, native, tmp_path,
                                             jax_native_on_port_lib):
    """DataModule.iterator advances the per-key epoch counter as JAX's
    does (explicit epoch= replays without advancing), on the Python and
    the native path, and keeps eval splits' partial tail."""
    root = tmp_path / "tree"
    shutil.copytree(tree, root, symlinks=True)
    jc, tc = _cfgs(str(root), use_native_loader=native)
    dm, jdm = DataModule(tc, str(root)), JDataModule(jc, str(root))
    for kw in ({}, {}, {"epoch": 0}, {}):
        a, b = dm.iterator("train", **kw), jdm.iterator("train", **kw)
        assert type(a).__name__ == type(b).__name__ == (
            "NativeBatchIterator" if native else "BatchIterator")
        _same_batches(a, b, n_epochs=1)
    val = list(dm.iterator("val"))
    assert [len(b["label"]) for b in val] == [4, 2]
    assert dm.class_counts("test") == jdm.class_counts("test")
    if native:
        assert os.path.exists(dm.shard_path("train"))


def test_resolve_shard_and_batch_split(tree):
    _, tc = _cfgs(tree, use_native_loader=False)
    assert DataModule(tc, tree).resolve_shard() is None
    dm = DataModule(tc, tree, data_shard=(1, 2))
    assert dm.resolve_shard() == (1, 2)
    it = dm.iterator("train")
    assert it.batch_size == 2 and it.shard == (1, 2)
    tc.training.batch_size = 3
    with pytest.raises(ValueError, match="not divisible"):
        DataModule(tc, tree, data_shard=(0, 2)).iterator("train")


def test_device_batches_prepare_the_iterator_batches(tree):
    """device_batches: the iterator's batches through prepare_batch with
    the training augmentation on train (draws from the generator), none on
    the other splits."""
    _, tc = _cfgs(tree, use_native_loader=False, augmentation="low")
    dm, ref = DataModule(tc, tree), DataModule(tc, tree)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    for split in ("train", "test"):
        for got, host in zip(dm.device_batches(split, g1, device="cpu"),
                             ref.iterator(split)):
            aug = "low" if split == "train" else "none"
            expect = prepare_batch(torch.from_numpy(host["image"]), g2,
                                   augmentation=aug, normalization="tanh")
            torch.testing.assert_close(got["image"], expect, rtol=0, atol=0)
            assert got["label"].dtype == torch.long


@pytest.mark.parametrize("native", [False, True])
def test_train_on_a_tree_with_wrap_padded_validation(tree, tmp_path,
                                                     native):
    """train(use_synthetic=False) reads the tree: steps per epoch from the
    train iterator (20 images // 8 = 2), 2 epochs, validation on a val
    split smaller than the batch (wrap-padded) writing best_val.json; then
    cli.train --dataset-root resumes the run for a third epoch."""
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.training.loop import train

    root = tmp_path / "tree"
    shutil.copytree(tree, root, symlinks=True)
    overrides = ["model.preset=small64", "model.base_channels=8",
                 "model.compute_dtype=float32", "training.resolution=16",
                 "training.batch_size=8", "training.num_timesteps=8",
                 "training.vis_every=0", "training.eval_every=1",
                 f"training.use_native_loader={str(native).lower()}",
                 "training.augmentation=low",
                 f"paths.local_base={tmp_path / 'runs'}"]
    cfg = tcfg.load_config(None, overrides + ["training.num_epochs=2"])
    cfg.task, cfg.run_id = "PNEUMONIA", "tree"
    summary = train(cfg, dataset_root=str(root), device="cpu")
    assert summary["steps"] == 4
    assert np.isfinite(summary["best_val_loss"])
    out = tmp_path / "runs" / cfg.paths.output_dir / "PNEUMONIA" / \
        "experiment_exp0_run_tree"
    best = json.loads((out / "best_val.json").read_text())
    assert best["val_loss"] == summary["best_val_loss"]
    argv = ["--dataset", "PNEUMONIA", "--dataset-root", str(root),
            "--run-id", "tree", "--device", "cpu"]
    for o in overrides + ["training.num_epochs=3"]:
        argv += ["--set", o]
    assert train_cli.main(argv) == 0
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert max(r.get("epoch", 0) for r in rows) == 3
    if native:
        assert (root / ".shards").is_dir()
