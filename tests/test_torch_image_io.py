"""The port's PNG reader, resize and affine warp against ``cv2``, which the
JAX package's readers use (``vit_unet_tpu/data/datasets.py``,
``augment.py``)."""
import struct
import zlib

import cv2
import numpy as np
import pytest

from vit_unet_tpu_torch.data import _native
from vit_unet_tpu_torch.data import image_io as io
from tests.test_torch_model import one_torch_thread  # noqa: F401

#: the warp's tolerance against cv2 in uint8 levels (measured worst case
#: 0 over the cases below), and for float32 images (measured 1.1e-5: cv2's
#: float path rounds its products in another order)
WARP_TOL = 1
WARP_F32_TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def codec():
    if all(_native.shutil.which(c) is None for c in ("c++", "g++", "clang++")):
        pytest.skip("no C++ compiler to build the native half")
    return _native.codec()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """Forward PNG filtering of (H, rowbytes) uint8 rows, row r with filter
    ``filters[r % len(filters)]``."""
    raw = raw.astype(np.int64)
    out = []
    for r in range(raw.shape[0]):
        ftype = filters[r % len(filters)]
        x = raw[r]
        up = raw[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
                4: _paeth(left, up, upleft)}[ftype]
        out.append(bytes([ftype]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def write_png(path, samples, ctype, depth, filters=(0,), palette=None,
              interlace=0):
    """A PNG of (H, W, C) samples (palette indices for colour type 3)."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, -1)
    if depth == 16:
        rows = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = flat.astype(np.uint8)
    else:
        per = 8 // depth
        pad = (-flat.shape[1]) % per
        v = np.pad(flat.astype(np.uint8), ((0, 0), (0, pad)))
        v = v.reshape(h, -1, per)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = np.bitwise_or.reduce(v << shifts, axis=-1).astype(np.uint8)
    bpp = max(1, io._CHANNELS[ctype] * depth // 8)
    data = io.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(_filter_rows(rows, bpp, filters)))
    data += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


# colour type, bit depth, samples a pixel
CASES = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (2, 8, 3),
         (2, 16, 3), (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2),
         (4, 16, 2), (6, 8, 4), (6, 16, 4)]


@pytest.mark.parametrize("ctype,depth,ch", CASES)
def test_decode_every_filter_matches_cv2(tmp_path, ctype, depth, ch):
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = 23, 37
    top = (1 << depth) if ctype != 3 else min(1 << depth, 200)
    smooth = np.cumsum(rng.integers(0, 3, (h, w, ch)), axis=1) % top
    samples = np.where(rng.random((h, w, ch)) < 0.3,
                       rng.integers(0, top, (h, w, ch)), smooth)
    palette = (rng.integers(0, 256, (top, 3)) if ctype == 3 else None)
    path = str(tmp_path / "f.png")
    write_png(path, samples, ctype, depth, filters=(0, 1, 2, 3, 4),
              palette=palette)
    want_rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    want_gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(io.imread_rgb(path), want_rgb)
    np.testing.assert_array_equal(io.imread_gray(path), want_gray)


@pytest.mark.parametrize("shape", [(40, 33, 3), (17, 64), (31, 8, 4)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decode_cv2_written_files(tmp_path, shape, dtype):
    """Files written by ``cv2.imwrite`` (its own filter choice, zlib level)."""
    rng = np.random.default_rng(sum(shape))
    top = np.iinfo(dtype).max + 1
    img = rng.integers(0, top, shape).astype(dtype)
    img[: shape[0] // 2] = img[: shape[0] // 2].mean(axis=1, keepdims=True).astype(dtype)
    path = str(tmp_path / "cv.png")
    assert cv2.imwrite(path, img)
    want_rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(io.imread_rgb(path), want_rgb)
    np.testing.assert_array_equal(io.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_unsupported_and_unreadable_raise(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    jpg = str(tmp_path / "a.jpg")
    bmp = str(tmp_path / "a.bmp")
    assert cv2.imwrite(jpg, img) and cv2.imwrite(bmp, img)
    # JPEG and BMP are read now (tests/test_torch_codecs.py); their
    # variants the port does not take raise, as other formats do
    data = bytearray(open(jpg, "rb").read())
    data[data.index(b"\xff\xc0") + 1] = 0xC9      # arithmetic coding
    open(jpg, "wb").write(bytes(data))
    with pytest.raises(IOError, match=r"a\.jpg.*JPEG"):
        io.imread_rgb(jpg)
    data = bytearray(open(bmp, "rb").read())
    data[30] = 1                                   # RLE8
    open(bmp, "wb").write(bytes(data))
    with pytest.raises(IOError, match=r"a\.bmp.*BMP"):
        io.imread_gray(bmp)
    gif = str(tmp_path / "a.gif")
    open(gif, "wb").write(b"GIF89a" + bytes(16))
    with pytest.raises(IOError, match=r"a\.gif.*GIF"):
        io.imread_rgb(gif)
    adam7 = str(tmp_path / "i.png")
    write_png(adam7, img, 2, 8, interlace=1)
    with pytest.raises(IOError, match="Adam7"):
        io.imread_rgb(adam7)
    with pytest.raises(IOError, match="could not read image"):
        io.imread_rgb(str(tmp_path / "missing.png"))
    bad = str(tmp_path / "bad.png")
    write_png(bad, img, 2, 8, filters=(2,))
    data = bytearray(open(bad, "rb").read())
    data[-20] ^= 0xFF            # inside IDAT: its CRC no longer holds
    open(bad, "wb").write(bytes(data))
    with pytest.raises(IOError, match="could not read image"):
        io.imread_rgb(bad)
    assert cv2.imread(bad) is None


def test_unknown_filter_type_raises(codec):
    with pytest.raises(ValueError, match="unknown filter type 7 in row 1"):
        codec.png_unfilter(b"\x00ab\x07cd", 2, 2, 1)


SIZES = [(256, 256, 224, 224), (100, 37, 64, 64), (64, 64, 128, 128),
         (300, 200, 224, 224), (224, 224, 112, 112), (17, 19, 50, 41),
         (5, 7, 3, 2), (64, 64, 64, 64)]


@pytest.mark.parametrize("h,w,oh,ow", SIZES)
@pytest.mark.parametrize("channels", [3, 0])
def test_resize_matches_cv2(h, w, oh, ow, channels):
    rng = np.random.default_rng(h * w + oh)
    shape = (h, w, channels) if channels else (h, w)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    lin = io.resize_linear(img, (ow, oh))
    want = cv2.resize(img, (ow, oh))
    assert lin.shape == want.shape and lin.dtype == np.uint8
    diff = np.abs(lin.astype(int) - want)
    assert diff.max() <= 1
    if oh <= h and ow <= w:          # downscales are bit for bit
        assert diff.max() == 0
    np.testing.assert_array_equal(
        io.resize_nearest(img, (ow, oh)),
        cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST))


def test_resize_float_matches_cv2():
    img = np.random.default_rng(1).random((50, 40)).astype(np.float32)
    np.testing.assert_allclose(io.resize_linear(img, (32, 24)),
                               cv2.resize(img, (32, 24)), atol=1e-5)


def test_rotation_matrix_matches_cv2():
    for c, a, s in [((112.0, 112.0), 33.3, 1.07), ((10.5, 3.0), -45.0, 0.9)]:
        np.testing.assert_allclose(io.rotation_matrix_2d(c, a, s),
                                   cv2.getRotationMatrix2D(c, a, s),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_warp_matches_cv2(seed):
    """Random ShiftScaleRotate-range affines over noise and sharp edges;
    uint8 within WARP_TOL, float32 masks within WARP_F32_TOL."""
    rng = np.random.default_rng(seed)
    h, w = (96, 80) if seed % 2 else (64, 64)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img[: h // 3, : w // 2] = 0
    img[: h // 3, w // 2:] = 255
    m = io.rotation_matrix_2d((w / 2, h / 2), rng.uniform(-45, 45),
                              1 + rng.uniform(-0.1, 0.1))
    m[0, 2] += rng.uniform(-0.0625, 0.0625) * w
    m[1, 2] += rng.uniform(-0.0625, 0.0625) * h
    got = io.warp_affine_reflect101(img, m, (w, h))
    want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT_101)
    assert np.abs(got.astype(int) - want).max() <= WARP_TOL
    mask = (rng.random((h, w)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        io.warp_affine_reflect101(mask, m, (w, h)),
        cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REFLECT_101), atol=WARP_F32_TOL)
