"""The port's JPEG decoder (``data/image_io.py`` over ``csrc/jpeg_decode.cpp``)
against PIL's ``Image.open(path).convert("L")`` (libjpeg-turbo), bit for
bit, on the CPU: the committed fixtures and their manifest, JPEGs written by
PIL in every form the decoder takes (each chroma subsampling, progressive,
optimised tables, restart markers, an Adobe RGB file, CMYK and YCCK) at
sizes down to 1x1, decoding with PIL blocked, the forms it refuses (and
those PIL refuses too), and a ``.jpg`` tree through the batch iterator
against the JAX package's."""

import hashlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from superdiff_tpu.data.dataset import BatchIterator as JBatchIterator
from superdiff_tpu.data.dataset import ChestXrayIndex as JIndex
from superdiff_torch.data import BatchIterator, ChestXrayIndex, image_io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]


def _pil_gray(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def _xray(rng, h, w, colour):
    """Smooth structure, fine noise and, for colour, chroma that varies."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 90 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    a = base[..., None] + rng.normal(0, 35, (h, w, 3 if colour else 1))
    if colour:
        a[..., 2] += 60 * np.sin(yy / 3.0)
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a if colour else a[..., 0]


def _jpeg(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **opts)
    return buf.getvalue()


# -------------------------------------------------------------- fixtures ---

@pytest.mark.parametrize("entry", MANIFEST, ids=[e["name"] for e in MANIFEST])
def test_committed_fixture_decodes_to_pil_bits(entry):
    """``read_gray`` of each committed fixture equals PIL's bits and the
    manifest's shape and SHA-256 (which the card's machine checks without
    PIL)."""
    path = os.path.join(FIXTURES, entry["name"])
    got = image_io.read_gray(path)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(got, _pil_gray(f.read()))
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_manifest_hashes_are_pil_bits():
    """The manifest describes the files as they are: PIL's ``convert("L")``
    hash of each, every form the decoder must cover, within the size
    budget (11 files, 1.5 MB)."""
    assert len(MANIFEST) <= 11
    assert sum(os.path.getsize(os.path.join(FIXTURES, e["name"]))
               for e in MANIFEST) <= 1_500_000
    for e in MANIFEST:
        with open(os.path.join(FIXTURES, e["name"]), "rb") as f:
            gray = _pil_gray(f.read())
        assert hashlib.sha256(gray.tobytes()).hexdigest() == e["sha256"]
        assert 512 <= max(gray.shape) <= 1024
    forms = " | ".join(e["form"] for e in MANIFEST)
    for want in ("gray baseline 1024²", "odd size", "4:2:0", "4:2:2", "4:4:4",
                 "gray progressive", "YCbCr 4:2:0 progressive", "optimised",
                 "restart", "CMYK, Adobe", "CMYK progressive", "YCCK"):
        assert want in forms, want


# --------------------------------------------------- PIL-written forms -----

FORMS = {
    "gray": (False, {}),
    "gray_q10": (False, {"quality": 10}),
    "gray_progressive": (False, {"progressive": True}),
    "gray_optimized_restart": (False, {"optimize": True,
                                       "restart_marker_blocks": 2}),
    "ycc444": (True, {"subsampling": 0}),
    "ycc422": (True, {"subsampling": 1}),
    "ycc420_q95": (True, {"subsampling": 2, "quality": 95}),
    "ycc420_progressive": (True, {"subsampling": 2, "progressive": True}),
    "ycc444_progressive_q100": (True, {"subsampling": 0, "progressive": True,
                                       "quality": 100}),
    "ycc422_restart_rows": (True, {"subsampling": 1,
                                   "restart_marker_rows": 1}),
    "ycc420_progressive_restart": (True, {"subsampling": 2,
                                          "progressive": True,
                                          "restart_marker_blocks": 3}),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_pil_written_forms_decode_to_pil_bits(form):
    """Each form at 1x1, 7x9, 17x33 (chroma planes of 1-2 samples: box
    upsampling; odd edges: replicated context) and 61x46."""
    colour, opts = FORMS[form]
    rng = np.random.default_rng(len(form))
    for h, w in ((1, 1), (7, 9), (17, 33), (61, 46)):
        data = _jpeg(_xray(rng, h, w, colour), **opts)
        got = image_io.decode_jpeg(data)
        assert got.shape == (h, w), (h, w)
        np.testing.assert_array_equal(got, _pil_gray(data), f"{h}x{w}")


# A small baseline encoder, for forms PIL cannot write: 4:4:0 (luma
# sampled 1x2), chroma sampled more finely than luma, 'R','G','B' component
# ids, one scan per component. Orthonormal float DCT, one flat quantisation
# table, and Huffman tables in which every DC size has a 4-bit code and
# every AC run/size an 8-bit code (none all ones).
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out += bytes([self.acc, 0] if self.acc == 0xFF
                                  else [self.acc])
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _encode_baseline(h, w, planes, factors, ids, q=4, interleaved=True):
    """A baseline JPEG of an ``h`` x ``w`` image from its component planes
    (each at its own sampled size), sampling factors ``(h, v)`` and ids."""
    from scipy.fft import dctn

    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    ac_code = {s: i for i, s in enumerate(_AC_SYMBOLS)}

    def coefficients(plane, fh, fv, single):
        ph, pw = plane.shape
        bw, bh = ((-(-pw // 8), -(-ph // 8)) if single
                  else (mx * fh, my * fv))
        x = np.pad(plane, ((0, bh * 8 - ph), (0, bw * 8 - pw)),
                   mode="edge").astype(np.float64) - 128
        c = dctn(x.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3), axes=(2, 3),
                 norm="ortho")
        return np.round(c / q).astype(np.int64).reshape(bh, bw, 64)[
            :, :, _ZIGZAG]

    def put_value(bits, v):
        size = abs(v).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    def block(bits, coef, pred):
        size, v = put_value(bits, int(coef[0]) - pred)
        bits.put(size, 4)
        bits.put(v, size)
        last = max([k for k in range(1, 64) if coef[k]], default=0)
        run = 0
        for k in range(1, last + 1):
            if not coef[k]:
                run += 1
                continue
            while run > 15:
                bits.put(ac_code[0xF0], 8)
                run -= 16
            size, v = put_value(bits, int(coef[k]))
            bits.put(ac_code[(run << 4) | size], 8)
            bits.put(v, size)
            run = 0
        if last < 63:
            bits.put(ac_code[0x00], 8)
        return int(coef[0])

    out = bytearray(b"\xff\xd8\xff\xdb\x00\x43\x00" + bytes([q] * 64))
    out += (b"\xff\xc0" + (8 + 3 * len(planes)).to_bytes(2, "big") + b"\x08"
            + h.to_bytes(2, "big") + w.to_bytes(2, "big")
            + bytes([len(planes)]))
    for cid, (fh, fv) in zip(ids, factors):
        out += bytes([cid, (fh << 4) | fv, 0])
    out += (b"\xff\xc4" + (48 + len(_AC_SYMBOLS)).to_bytes(2, "big")
            + b"\x00" + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
            + b"\x10" + bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8)
            + bytes(_AC_SYMBOLS))
    scans = ([list(range(len(planes)))] if interleaved
             else [[c] for c in range(len(planes))])
    for scan in scans:
        single = len(scan) == 1
        out += (b"\xff\xda" + (6 + 2 * len(scan)).to_bytes(2, "big")
                + bytes([len(scan)]) + b"".join(bytes([ids[c], 0])
                                                for c in scan)
                + b"\x00\x3f\x00")
        coefs = [coefficients(planes[c], *factors[c], single) for c in scan]
        bits, preds = _BitWriter(), [0] * len(scan)
        if single:
            for row in coefs[0]:
                for coef in row:
                    preds[0] = block(bits, coef, preds[0])
        else:
            for by in range(my):
                for bx in range(mx):
                    for j, c in enumerate(scan):
                        fh, fv = factors[c]
                        for yy in range(fv):
                            for xx in range(fh):
                                preds[j] = block(bits, coefs[j][
                                    by * fv + yy, bx * fh + xx], preds[j])
        out += bits.flush()
    return bytes(out + b"\xff\xd9")


ENCODED_FORMS = {
    "ycc440": ([(1, 2), (1, 1), (1, 1)], (1, 2, 3), True),
    "ycc420_one_scan_per_component": ([(2, 2), (1, 1), (1, 1)], (1, 2, 3),
                                      False),
    "chroma_finer_than_luma": ([(1, 1), (2, 2), (2, 2)], (1, 2, 3), True),
    "rgb_component_ids_422": ([(2, 1), (1, 1), (1, 1)], (82, 71, 66), True),
}


@pytest.mark.parametrize("form", list(ENCODED_FORMS))
def test_encoded_forms_decode_to_pil_bits(form):
    """Forms PIL cannot write, made by a small baseline encoder, at 1x1,
    2x5, 7x9, 17x33 and 40x30: h1v2 fancy upsampling, chroma upsampled
    while luma is not, the component ids that mean RGB without a JFIF or
    Adobe marker, and sequential scans of one component each."""
    factors, ids, interleaved = ENCODED_FORMS[form]
    rng = np.random.default_rng(len(form))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    for h, w in ((1, 1), (2, 5), (7, 9), (17, 33), (40, 30)):
        planes = [_xray(rng, -(-h * fv // vmax), -(-w * fh // hmax), False)
                  for fh, fv in factors]
        data = _encode_baseline(h, w, planes, factors, ids,
                                interleaved=interleaved)
        got = image_io.decode_jpeg(data)
        np.testing.assert_array_equal(got, _pil_gray(data), f"{h}x{w}")


def _strip_app0(data: bytes) -> bytes:
    assert data[2:4] == b"\xff\xe0"
    n = int.from_bytes(data[4:6], "big")
    return data[:2] + data[4 + n:]


@pytest.mark.parametrize("transform", [0, 1])
def test_adobe_marker_selects_rgb_or_ycbcr(transform):
    """Without a JFIF marker an Adobe APP14 marker decides the colour space:
    transform 0 means the three planes are RGB (no conversion), 1 YCbCr;
    both as libjpeg reads them."""
    data = _strip_app0(_jpeg(_xray(np.random.default_rng(7), 24, 40, True),
                             subsampling=0))
    app14 = (b"\xff\xee\x00\x0e" + b"Adobe" + b"\x00\x64\x00\x00\x00\x00"
             + bytes([transform]))
    data = data[:2] + app14 + data[2:]
    got = image_io.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil_gray(data))
    rgb = image_io.decode_jpeg_samples(data)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))


def _strip_adobe(data: bytes) -> bytes:
    i = data.find(b"\xff\xee")
    assert data[i + 4:i + 9] == b"Adobe"
    return data[:i] + data[i + 2 + ((data[i + 2] << 8) | data[i + 3]):]


CMYK_FORMS = {
    "cmyk": ({}, None),
    "cmyk_first_plane_2x2": ({"subsampling": 2}, None),
    "cmyk_progressive_restart": ({"progressive": True,
                                  "restart_marker_blocks": 2}, None),
    "cmyk_no_adobe_marker": ({}, "strip"),
    "ycck": ({}, 2),
    "ycck_first_plane_2x2_progressive": ({"subsampling": 2,
                                          "progressive": True}, 2),
    "ycck_unknown_transform": ({}, 7),
}


@pytest.mark.parametrize("form", list(CMYK_FORMS))
def test_cmyk_and_ycck_decode_to_pil_bits(form):
    """4-component files at 1x1, 7x9, 17x33 and 61x46: CMYK as PIL writes
    it (Adobe marker, transform 0) or with no Adobe marker (libjpeg: CMYK),
    and YCCK (transform 2, or an unknown one, which libjpeg takes for
    YCCK). PIL reads every 4-component JPEG inverted (``CMYK;I``): the
    port's samples are PIL's CMYK bytes inverted, its gray PIL's."""
    from superdiff_torch.tools.make_jpeg_fixtures import set_adobe_transform

    opts, change = CMYK_FORMS[form]
    rng = np.random.default_rng(len(form))
    for h, w in ((1, 1), (7, 9), (17, 33), (61, 46)):
        inks = np.dstack([_xray(rng, h, w, True), _xray(rng, h, w, False)])
        buf = io.BytesIO()
        Image.fromarray(inks, "CMYK").save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        if change == "strip":
            data = _strip_adobe(data)
        elif change is not None:
            data = set_adobe_transform(data, change)
        got = image_io.decode_jpeg(data)
        np.testing.assert_array_equal(got, _pil_gray(data), f"{h}x{w}")
        with Image.open(io.BytesIO(data)) as im:
            assert im.mode == "CMYK"
            np.testing.assert_array_equal(
                255 - image_io.decode_jpeg_samples(data), np.asarray(im))


def test_decoding_needs_no_pil(tmp_path, monkeypatch):
    """With PIL blocked from import, ``read_gray`` still decodes a fixture
    and a PIL-written progressive 4:2:0 file to PIL's bits (computed before
    the block): the decoder is the same code with PIL present or not."""
    data = _jpeg(_xray(np.random.default_rng(3), 33, 47, True),
                 subsampling=2, progressive=True)
    path = tmp_path / "p.jpeg"
    path.write_bytes(data)
    fixture = os.path.join(FIXTURES, MANIFEST[0]["name"])
    with open(fixture, "rb") as f:
        want_fixture = _pil_gray(f.read())
    want = _pil_gray(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    np.testing.assert_array_equal(image_io.read_gray(str(path)), want)
    np.testing.assert_array_equal(image_io.read_gray(fixture), want_fixture)


def test_no_port_module_imports_pil():
    """Only the fixture generator (a tool that runs where PIL is) names
    PIL; no module of the decoding path does."""
    hits = []
    for dp, _, files in os.walk(os.path.join(REPO, "superdiff_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dp, name)
            with open(path) as f:
                text = f.read()
            if re.search(r"^\s*(from|import) PIL\b", text, re.M):
                hits.append(os.path.relpath(path, REPO))
    assert hits == [os.path.join("superdiff_torch", "tools",
                                 "make_jpeg_fixtures.py")]


# ------------------------------------------------------- refused forms -----

def _sof_offset(data: bytes) -> int:
    for marker in (b"\xff\xc0", b"\xff\xc2"):
        i = data.find(marker)
        if i >= 0:
            return i
    raise AssertionError("no SOF0/SOF2")


def _patch(data: bytes, offset: int, value: int) -> bytes:
    return data[:offset] + bytes([value]) + data[offset + 1:]


def _bad(form):
    """A file of the form, made from a PIL-written one by patching its frame
    header (the decoder refuses it at the header), or written so."""
    rng = np.random.default_rng(5)
    gray = _jpeg(_xray(rng, 16, 16, False))
    sof = _sof_offset(gray)
    if form == "arithmetic coding (SOF9)":
        return _patch(gray, sof + 1, 0xC9)
    if form == "lossless JPEG (SOF3)":
        return _patch(gray, sof + 1, 0xC3)
    if form == "hierarchical JPEG (SOF5)":
        return _patch(gray, sof + 1, 0xC5)
    if form == "12-bit samples":
        return _patch(gray, sof + 4, 12)
    if form == "2 components":
        colour = _jpeg(_xray(rng, 16, 16, True), subsampling=0)
        return _patch(colour, _sof_offset(colour) + 9, 2)
    if form == "sampling factors 1x1 against 4x1":
        colour = _jpeg(_xray(rng, 16, 16, True), subsampling=1)
        sof = _sof_offset(colour)
        return _patch(colour, sof + 11, 0x41)   # Y: 4x1 against Cb/Cr 1x1
    if form == "truncated data":
        return gray[:len(gray) // 2]
    raise AssertionError(form)


@pytest.mark.parametrize("form", [
    "arithmetic coding (SOF9)", "lossless JPEG (SOF3)",
    "hierarchical JPEG (SOF5)", "12-bit samples",
    "2 components", "sampling factors 1x1 against 4x1",
    "truncated data"])
def test_unsupported_forms_raise_naming_file_and_form(form, tmp_path):
    path = tmp_path / "scan_0042.jpg"
    path.write_bytes(_bad(form))
    with pytest.raises(ValueError) as e:
        image_io.read_gray(str(path))
    msg = str(e.value)
    assert str(path) in msg and form in msg, msg


REFUSED_BY_BOTH = ("hierarchical JPEG (SOF5)", "12-bit samples",
                   "truncated data", "sampling factors too large")


@pytest.mark.parametrize("form", REFUSED_BY_BOTH)
def test_forms_refused_by_both_pil_and_the_port(form, tmp_path):
    """A committed fixture patched into a form PIL (libjpeg-turbo) refuses
    as well: its SOF marker to SOF5, its precision byte to 12, cut in half,
    or its three 1x1 components set to 2x2 (12 blocks in an interleaved MCU,
    over libjpeg's 10). Refusing them agrees with the reference."""
    with open(os.path.join(FIXTURES, "ycc444_512x640.jpg"), "rb") as f:
        data = f.read()
    sof = _sof_offset(data)
    if form == "hierarchical JPEG (SOF5)":
        data = _patch(data, sof + 1, 0xC5)
    elif form == "12-bit samples":
        data = _patch(data, sof + 4, 12)
    elif form == "truncated data":
        data = data[:len(data) // 2]
    else:
        for c in range(3):
            data = _patch(data, sof + 11 + 3 * c, 0x22)
    with pytest.raises(OSError):                # PIL refuses it
        _pil_gray(data)
    path = tmp_path / "film_3.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        image_io.read_gray(str(path))
    msg = str(e.value)
    assert str(path) in msg and form in msg, msg


def _dht_patched(form: str) -> bytes:
    """A PIL-written gray file whose first DHT segment (the DC table of its
    one scan: counts 0,1,5,1,1,1,1,1,1 for lengths 1-9, symbols 0-11) is
    patched. The segment keeps its length, so only the table is bad."""
    data = _jpeg(_xray(np.random.default_rng(6), 16, 16, False))
    i = data.find(b"\xff\xc4")
    assert data[i + 4] == 0x00                  # class 0 (DC), id 0
    assert list(data[i + 5:i + 21]) == [0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7
    if form == "more codes than fit":           # 12 codes of 1 bit
        return data[:i + 5] + bytes([12] + [0] * 15) + data[i + 21:]
    if form == "a DC symbol above 15":          # the 2-bit code means 16
        return data[:i + 21] + bytes([16]) + data[i + 22:]
    raise AssertionError(form)


@pytest.mark.parametrize("form", ["more codes than fit",
                                  "a DC symbol above 15"])
def test_corrupt_huffman_table_raises_naming_file(form, tmp_path):
    """A Huffman table that libjpeg refuses (JERR_BAD_HUFF_TABLE) is refused
    before the decoder fills its lookup table from it: 12 one-bit codes
    would index 2816 entries past a 512-entry table, and a DC size of 16
    would shift by more than the bit buffer holds."""
    data = _dht_patched(form)
    with pytest.raises(OSError):                # PIL refuses it too
        _pil_gray(data)
    path = tmp_path / "scan_0007.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        image_io.read_gray(str(path))
    msg = str(e.value)
    assert str(path) in msg and "bad Huffman table" in msg and form in msg, msg


@pytest.mark.parametrize("kept", [1, 2])
def test_missing_component_scans_decode_as_pil(kept):
    """A 4:2:0 file with one scan per component, cut to its first ``kept``
    scans and an EOI: libjpeg decodes the components no scan named as flat
    128 (pre-zeroed coefficients, a zeroed dequantisation table), and so
    does the port, sample for sample."""
    factors, ids, _ = ENCODED_FORMS["ycc420_one_scan_per_component"]
    rng = np.random.default_rng(8)
    h, w = 17, 33
    planes = [_xray(rng, -(-h * fv // 2), -(-w * fh // 2), False)
              for fh, fv in factors]
    data = _encode_baseline(h, w, planes, factors, ids, interleaved=False)
    sos = [m.start() for m in re.finditer(b"\xff\xda", data)]
    assert len(sos) == 3
    data = data[:sos[kept]] + b"\xff\xd9"
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil_gray(data))
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(image_io.decode_jpeg_samples(data),
                                      np.asarray(im.convert("RGB")))


def test_unknown_file_kind_raises_naming_the_file(tmp_path):
    path = tmp_path / "notes.jpg"
    path.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="notes.jpg: not a PNG, BMP or JPEG"):
        image_io.read_gray(str(path))


# ------------------------------------------------------------ the tree -----

def test_jpeg_tree_batches_equal_jax(tmp_path):
    """A class-folder tree of ``.jpg`` / ``.jpeg`` files in several forms
    (gray, 4:2:0, 4:2:2 progressive, restart markers) gives the JAX
    ``BatchIterator``'s uint8 batches and labels bit for bit, in order,
    over two epochs, with the pad and resize strategies."""
    rng = np.random.default_rng(0)
    kinds = [(False, {}), (True, {"subsampling": 2}),
             (True, {"subsampling": 1, "progressive": True}),
             (False, {"restart_marker_blocks": 1, "optimize": True})]
    for ci, cls in enumerate(["NORMAL", "TB"]):
        d = tmp_path / "TB" / "train" / cls
        d.mkdir(parents=True)
        for i in range(7):
            colour, opts = kinds[(i + ci) % len(kinds)]
            img = _xray(rng, 30 + 5 * i, 44 - 3 * i + ci, colour)
            ext = ".jpeg" if i % 2 else ".jpg"
            (d / f"img{i}{ext}").write_bytes(_jpeg(img, **opts))
    root = str(tmp_path)
    idx = ChestXrayIndex(root, task="TB", split="train")
    jidx = JIndex(root, task="TB", split="train")
    assert idx.samples == jidx.samples and len(idx) == 14
    for strategy in ("pad", "resize"):
        kw = dict(batch_size=4, resolution=16, seed=2,
                  resize_strategy=strategy)
        a, b = BatchIterator(idx, **kw), JBatchIterator(jidx, **kw)
        for _ in range(2):
            got, expect = list(a), list(b)
            assert len(got) == len(expect) == 3
            for g, e in zip(got, expect):
                np.testing.assert_array_equal(g["image"], e["image"])
                np.testing.assert_array_equal(g["label"], e["label"])
