"""The port's BMP and JPEG readers (``data/image_io.py``, the JPEG decoder
in ``data/_native.cc``) against ``cv2.imread`` with ``IMREAD_COLOR`` (then
BGR -> RGB) and ``IMREAD_GRAYSCALE``, bit for bit, on files that
``cv2.imwrite`` writes and on hand-made ones; the variants they do not take
raise ``IOError``; the committed JPEG fixtures still equal ``cv2.imread``."""
import glob
import itertools
import os
import struct

import cv2
import numpy as np
import pytest

from vit_unet_tpu_torch.data import image_io as io
from tests.test_torch_model import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
#: odd and MCU-sized sides, and images narrower than the fancy upsamplers'
#: three downsampled columns
SIZES = [(37, 53), (48, 64), (17, 3), (2, 5), (1, 1)]


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                     (x * 7 + y * 3) % 256.0], axis=-1)
    return np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_reads(path):
    rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    return rgb, cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def _same_as_cv2(path):
    rgb, gray = _cv2_reads(path)
    np.testing.assert_array_equal(io.imread_rgb(path), rgb, err_msg=path)
    np.testing.assert_array_equal(io.imread_gray(path), gray, err_msg=path)


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


# --- JPEG ---------------------------------------------------------------------

@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_matches_cv2(tmp_path, sampling, progressive):
    """Qualities 50/75/95, optimised tables off and on, restart intervals
    0 and 3 MCUs, at every size of SIZES."""
    for i, ((h, w), quality, opt, rst) in enumerate(itertools.product(
            SIZES, (50, 75, 95), (0, 1), (0, 3))):
        ok, buf = cv2.imencode(".jpg", _image(h, w, i), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
            cv2.IMWRITE_JPEG_OPTIMIZE, opt, cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok
        _same_as_cv2(_write(tmp_path / f"{i}.jpg", buf.tobytes()))


@pytest.mark.parametrize("progressive", [0, 1])
def test_gray_jpeg_matches_cv2(tmp_path, progressive):
    for i, (h, w) in enumerate(SIZES):
        ok, buf = cv2.imencode(".jpg", _image(h, w, i)[..., 0],
                               [cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        _same_as_cv2(_write(tmp_path / f"{i}.jpg", buf.tobytes()))


def _with_orientation(data: bytes, orientation: int, little: bool) -> bytes:
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    seg = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_matches_cv2(tmp_path, orientation):
    """cv2.imread applies the EXIF Orientation tag: a 64 x 40 file tagged 6
    reads back 40 wide and 64 high."""
    ok, buf = cv2.imencode(".jpg", _image(40, 64))
    for little in (True, False):
        path = _write(tmp_path / f"o{little}.jpg",
                      _with_orientation(buf.tobytes(), orientation, little))
        _same_as_cv2(path)
        want = (64, 40) if orientation >= 5 else (40, 64)
        assert io.imread_rgb(path).shape == want + (3,)


def test_gray_of_colour_jpeg_is_its_luma_plane(tmp_path):
    """IMREAD_GRAYSCALE of a colour JPEG is libjpeg's gray output, the Y
    plane, not a weighted sum of the colour decode."""
    ok, buf = cv2.imencode(".jpg", _image(48, 64), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
    path = _write(tmp_path / "c.jpg", buf.tobytes())
    gray = io.imread_gray(path)
    weighted = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)
    assert np.abs(gray.astype(int) - weighted).max() > 0
    np.testing.assert_array_equal(gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_damaged_jpeg_reads_as_cv2_reads_it(tmp_path):
    """Extraneous bytes before a marker, a flipped byte in the entropy data
    and a baseline file cut short (its missing blocks mid-gray, as libjpeg's
    file source supplies an EOI) decode as cv2.imread decodes them.  A
    progressive file cut short is one libjpeg block-smooths: it raises."""
    for progressive in (0, 1):
        ok, buf = cv2.imencode(".jpg", _image(40, 64),
                               [cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        data = buf.tobytes()
        dht = data.index(b"\xff\xc4")
        _same_as_cv2(_write(tmp_path / "x.jpg", data[:dht] + b"\x00\x12" + data[dht:]))
        sos = data.index(b"\xff\xda")
        flipped = bytearray(data)
        flipped[sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big") + 40] ^= 0xFF
        _same_as_cv2(_write(tmp_path / "f.jpg", bytes(flipped)))
        for share in (0.5, 0.8):
            cut = _write(tmp_path / "cut.jpg", data[:int(len(data) * share)])
            if not progressive:
                _same_as_cv2(cut)
                continue
            assert cv2.imread(cut) is not None
            with pytest.raises(IOError, match=r"cut\.jpg.*block-smooths"):
                io.imread_rgb(cut)


def _sof_patched(data: bytes, marker: int = None, precision: int = None) -> bytes:
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[sof + 1] = marker
    if precision is not None:
        out[sof + 4] = precision
    return bytes(out)


def _rgb_coded(data: bytes) -> bytes:
    """``data`` without its JFIF segment, its components renamed 'R', 'G',
    'B': libjpeg takes such a file for RGB-coded."""
    app0 = data.index(b"\xff\xe0")
    data = data[:app0] + data[app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big"):]
    out = bytearray(data)
    sof = data.index(b"\xff\xc0")
    for i, name in enumerate(b"RGB"):
        out[sof + 10 + 3 * i] = name
    sos = data.index(b"\xff\xda")
    for i, name in enumerate(b"RGB"):
        out[sos + 5 + 2 * i] = name
    return bytes(out)


def _header_only(components: int) -> bytes:
    sof = struct.pack(">BHHB", 8, 8, 8, components) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(components))
    return (b"\xff\xd8\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xd9")


@pytest.mark.parametrize("variant,match", [
    ("arithmetic", "arithmetic-coded JPEG"),
    ("lossless", "lossless JPEG"),
    ("hierarchical", "hierarchical JPEG"),
    ("12-bit", "12-bit"),
    ("cmyk", "CMYK"),
    ("two components", "other than 1 or 3 components"),
    ("rgb", "RGB-coded JPEG"),
])
def test_jpeg_variants_it_does_not_take_raise(tmp_path, variant, match):
    ok, buf = cv2.imencode(".jpg", _image(16, 16))
    data = {
        "arithmetic": lambda: _sof_patched(buf.tobytes(), marker=0xC9),
        "lossless": lambda: _sof_patched(buf.tobytes(), marker=0xC3),
        "hierarchical": lambda: _sof_patched(buf.tobytes(), marker=0xC5),
        "12-bit": lambda: _sof_patched(buf.tobytes(), precision=12),
        "cmyk": lambda: _header_only(4),
        "two components": lambda: _header_only(2),
        "rgb": lambda: _rgb_coded(buf.tobytes()),
    }[variant]()
    path = _write(tmp_path / "v.jpg", data)
    with pytest.raises(IOError, match=r"v\.jpg.*" + match + ".*not supported"):
        io.imread_rgb(path)
    with pytest.raises(IOError, match=match):
        io.imread_gray(path)


def test_jpeg_fixtures_still_match_cv2():
    """Each committed fixture's arrays are what cv2.imread gives for it
    here, and the port reads them back exactly (the card host, which has
    no cv2, holds the port against these arrays)."""
    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(paths) >= 12
    for path in paths:
        rgb, gray = _cv2_reads(path)
        np.testing.assert_array_equal(np.load(path[:-4] + ".rgb.npy"), rgb)
        np.testing.assert_array_equal(np.load(path[:-4] + ".gray.npy"), gray)
        _same_as_cv2(path)


# --- BMP ----------------------------------------------------------------------

def bmp_bytes(pixels, bpp, palette=None, top_down=False, header=40,
              compression=0, colours_used=None) -> bytes:
    """A BMP of ``pixels``: palette indices (bpp <= 8), 5-5-5 words (16) or
    BGR(A) bytes (24, 32); ``palette`` RGB rows; ``header`` 12 (core), 40,
    108 (V4) or 124 (V5) bytes."""
    h, w = pixels.shape[:2]
    pitch = (w * bpp + 31) // 32 * 4
    rows = []
    for r in range(h):
        if bpp <= 8:
            per = 8 // bpp
            vals = np.zeros(pitch * per, np.uint8)
            vals[:w] = pixels[r]
            packed = np.zeros(pitch, np.uint8)
            for k in range(per):
                packed |= (vals[k::per] << (8 - bpp * (k + 1))).astype(np.uint8)
            raw = packed.tobytes()
        else:
            raw = (pixels[r].astype("<u2") if bpp == 16
                   else pixels[r].astype(np.uint8)).tobytes()
        rows.append(raw + b"\0" * (pitch - len(raw)))
    body = b"".join(rows if top_down else rows[::-1])
    entry = 3 if header == 12 else 4
    table = b"".join(bytes([b, g, r] + [0] * (entry - 3))
                     for r, g, b in (palette if palette is not None else []))
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        used = len(table) // entry if colours_used is None else colours_used
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                           bpp, compression, len(body), 2835, 2835, used, 0)
        info += b"\0" * (header - 40)
    offset = 14 + len(info) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + table + body)


@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_paletted_bmp_matches_cv2(tmp_path, bpp):
    """Colour and gray palettes, full and short (entries past those listed
    are black), bottom-up and top-down, the info, V4 and V5 headers."""
    rng = np.random.default_rng(bpp)
    cases = itertools.product([(5, 7), (9, 33), (1, 1)], [False, True],
                              [40, 108, 124], [False, True], [False, True])
    for i, ((h, w), top_down, header, gray_palette, short) in enumerate(cases):
        count = 1 << bpp
        listed = count // 2 + 1 if short else count
        palette = rng.integers(0, 256, (listed, 3))
        if gray_palette:
            palette = np.repeat(palette[:, :1], 3, axis=1)
        index = rng.integers(0, count, (h, w))
        used = 0 if (not short and bpp < 8) else None
        path = _write(tmp_path / f"{i}.bmp", bmp_bytes(
            index, bpp, palette, top_down, header, colours_used=used))
        _same_as_cv2(path)


@pytest.mark.parametrize("bpp", [24, 32])
def test_direct_colour_bmp_matches_cv2(tmp_path, bpp):
    rng = np.random.default_rng(bpp)
    for i, ((h, w), top_down, header) in enumerate(itertools.product(
            [(5, 7), (16, 13), (1, 1)], [False, True], [40, 108, 124])):
        pixels = rng.integers(0, 256, (h, w, bpp // 8))
        _same_as_cv2(_write(tmp_path / f"{i}.bmp",
                            bmp_bytes(pixels, bpp, None, top_down, header)))


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3), (20, 31, 4)])
def test_bmp_written_by_cv2_matches_cv2(tmp_path, shape):
    """cv2.imwrite's 8-bit gray, 24-bit and 32-bit (BITFIELDS, V5 header)
    files."""
    rng = np.random.default_rng(len(shape))
    path = str(tmp_path / "cv.bmp")
    assert cv2.imwrite(path, rng.integers(0, 256, shape).astype(np.uint8))
    _same_as_cv2(path)


@pytest.mark.parametrize("compression,bpp,header,match", [
    (1, 8, 40, "RLE8"), (2, 4, 40, "RLE4"), (3, 16, 40, "BITFIELDS"),
    (3, 32, 40, "BITFIELDS"), (4, 24, 40, "embedded JPEG"),
    (5, 24, 40, "embedded PNG"), (0, 16, 40, "16 bits"), (0, 8, 12, "12-byte header"),
])
def test_bmp_variants_it_does_not_take_raise(tmp_path, compression, bpp, header, match):
    """Compressed BMP, BITFIELDS other than plain 32-bit BGRX (here 32-bit
    with no masks at all), 16-bit and the OS/2 core header."""
    rng = np.random.default_rng(0)
    pixels = (rng.integers(0, 1 << bpp, (4, 4)) if bpp <= 16
              else rng.integers(0, 256, (4, 4, bpp // 8)))
    palette = rng.integers(0, 256, (1 << bpp, 3)) if bpp <= 8 else None
    path = _write(tmp_path / "v.bmp", bmp_bytes(pixels, bpp, palette, header=header,
                                               compression=compression))
    with pytest.raises(IOError, match=r"v\.bmp.*" + match + ".*not supported"):
        io.imread_rgb(path)
    with pytest.raises(IOError, match=match):
        io.imread_gray(path)
