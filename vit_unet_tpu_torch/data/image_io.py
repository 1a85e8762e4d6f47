"""Image reading, resizing and warping on the host, without ``cv2``: the
port's own copy of the ``cv2`` behaviour the JAX package's readers use
(``vit_unet_tpu/data/datasets.py`` and ``augment.py``).

* ``imread_rgb`` / ``imread_gray``: ``cv2.imread`` with ``IMREAD_COLOR``
  (then BGR -> RGB) and ``IMREAD_GRAYSCALE``, for PNG, BMP and JPEG files,
  told apart by their first bytes:

  - PNG (``read_png``): the chunks are read here, ``IDAT`` is inflated with
    ``zlib``, and the row filters are reversed by ``vit_png_unfilter`` in
    ``_native.cc``.  Colour types 0, 2, 3, 4 and 6 at bit depths 1-16 (as
    the format allows them), non-interlaced.  As ``cv2`` does: gray is
    repeated to three channels, a palette is looked up, alpha is dropped
    (not composited), 16-bit samples keep their high byte, and gray from
    colour takes libpng's fixed-point BT.601 weights (9797, 19234, 3737) /
    2^15, truncated at 8 bits and rounded at 16 before the high byte is
    kept.
  - BMP (``read_bmp``): OpenCV's own reader (``grfmt_bmp``): the
    BITMAPINFOHEADER and the V4 / V5 headers, bottom-up and top-down rows
    padded to 4 bytes, uncompressed 1-, 4- and 8-bit palettes, 24- and
    32-bit (alpha dropped; BITFIELDS only with the plain BGRX masks, as
    ``cv2.imwrite`` writes it); gray from
    colour takes OpenCV's weights (4899, 9617, 1868) / 2^14, rounded (from
    BITFIELDS: float32 weights, truncated, as cv2 5.0 does there).
  - JPEG (``read_jpeg``): ``_native.cc``'s decoder, libjpeg-turbo's output
    with its defaults (ISLOW IDCT, fancy upsampling, its YCbCr -> RGB
    tables): baseline and progressive Huffman, restart markers, gray and
    YCbCr at any integer sampling.  Gray from a colour JPEG is its luma
    plane, as libjpeg's gray output is.  The EXIF orientation is applied,
    as ``cv2.imread`` applies it.

  Anything else (Adam7 PNG; RLE, other BITFIELDS, embedded-image, 16-bit
  or OS/2-header BMP; arithmetic-coded, lossless, 12-bit, CMYK, RGB-coded
  or block-smoothed progressive JPEG; other formats) raises ``IOError``
  naming the file and the format.
* ``resize_linear`` / ``resize_nearest``: ``cv2.resize`` with
  ``INTER_LINEAR`` / ``INTER_NEAREST``.  Linear on uint8 is ``cv2``'s
  fixed point (11-bit weights, the vector path's rounding): bit for bit on
  downscales, within 1 level on upscales.
* ``warp_affine_reflect101`` and ``rotation_matrix_2d``:
  ``cv2.warpAffine(..., INTER_LINEAR, BORDER_REFLECT_101)`` and
  ``cv2.getRotationMatrix2D``.  The warp maps each destination pixel
  through the inverted affine in float32, as ``cv2`` 4.11 and later do (no
  1/32-pixel quantisation of the source position).

All of it is numpy on the host: data preparation, not device work.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from vit_unet_tpu_torch.data import _native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples a pixel, by PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: bit depths the format allows, by colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
#: libpng's rgb_to_gray weights for (0.299, 0.587), in units of 2^-15
_GRAY_WEIGHTS = (9797, 19234, 3737)
_MAGIC = {b"\xff\xd8\xff": "JPEG", b"BM": "BMP", b"GIF8": "GIF",
          b"II*\x00": "TIFF", b"MM\x00*": "TIFF", b"RIFF": "WebP/RIFF"}
#: OpenCV's BGR -> gray weights for (0.299, 0.587), in units of 2^-14
#: (R, G, B), as its image codecs convert
_CV_GRAY_WEIGHTS = (4899, 9617, 1868)
#: BMP compression codes the reader does not take
_BMP_COMPRESSION = {1: "RLE8", 2: "RLE4", 3: "BITFIELDS", 4: "embedded JPEG",
                    5: "embedded PNG", 6: "ALPHABITFIELDS"}
#: the (R, G, B) masks of a 32-bit BITFIELDS BMP laid out as plain BGRX
_BGRX_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)


def _unsupported(path, what: str) -> IOError:
    return IOError(f"cannot read image {path!r}: {what} is not supported "
                   "(the port reads non-interlaced PNG, uncompressed BMP and "
                   "Huffman-coded 8-bit gray or YCbCr JPEG)")


def _read_bytes(path) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise IOError(f"could not read image {path!r}: {e}") from e


def _format_of(head: bytes) -> str:
    for magic, name in _MAGIC.items():
        if head.startswith(magic):
            return name
    return "an unknown format"


def read_png(path) -> tuple[np.ndarray, int, int]:
    """The samples of a PNG file as stored: ``(array, colour type, bit
    depth)``.  ``array`` is (H, W, C) uint8, uint16 at bit depth 16, with
    palette indices looked up into RGB (colour type 3 comes back as
    (H, W, 3) uint8) and depths below 8 unpacked to one sample a byte,
    unscaled."""
    data = _read_bytes(path)
    if not data.startswith(PNG_SIGNATURE):
        raise _unsupported(path, _format_of(data[:4]))
    pos, ihdr, palette, idat = len(PNG_SIGNATURE), None, None, []
    while True:
        if pos + 8 > len(data):
            raise IOError(f"could not read image {path!r}: truncated PNG")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise IOError(f"could not read image {path!r}: truncated PNG")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise IOError(f"could not read image {path!r}: bad CRC in "
                          f"{kind.decode(errors='replace')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise IOError(f"could not read image {path!r}: no IHDR or IDAT chunk")
    width, height, depth, ctype, method, filt, interlace = ihdr
    if interlace:
        raise _unsupported(path, "an Adam7-interlaced PNG")
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or method or filt:
        raise _unsupported(path, f"PNG colour type {ctype} at bit depth {depth}")
    if ctype == 3 and palette is None:
        raise IOError(f"could not read image {path!r}: palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    bits = width * channels * depth
    rowbytes = (bits + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
        rows = _native.codec().png_unfilter(raw, height, rowbytes,
                                            channels * depth // 8)
    except (zlib.error, ValueError) as e:
        raise IOError(f"could not read image {path!r}: {e}") from e
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    elif depth == 8:
        img = rows.reshape(height, width, channels)
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
        img = vals.reshape(height, rowbytes * per)[:, :width, None]
    if ctype == 3:
        if img.max(initial=0) >= len(palette):
            raise IOError(f"could not read image {path!r}: palette index "
                          "out of range")
        img = palette[img[..., 0]]
    return img, ctype, depth


def _to_8bit(samples: np.ndarray, ctype: int, depth: int) -> np.ndarray:
    """Samples -> uint8 as ``cv2`` scales them: the high byte of a 16-bit
    sample, a 1/2/4-bit gray level stretched to 0..255."""
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    if depth < 8 and ctype == 0:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def _png_rgb(path) -> np.ndarray:
    samples, ctype, depth = read_png(path)
    img = _to_8bit(samples, ctype, depth)
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _png_gray(path) -> np.ndarray:
    samples, ctype, depth = read_png(path)
    if ctype in (0, 4):
        return np.ascontiguousarray(_to_8bit(samples[..., 0], ctype, depth))
    rgb = samples[..., :3].astype(np.int64)
    gray = rgb @ np.asarray(_GRAY_WEIGHTS, np.int64)
    if depth == 16:
        return (((gray + (1 << 14)) >> 15) >> 8).astype(np.uint8)
    return (gray >> 15).astype(np.uint8)


def _cv_gray(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's fixed-point gray of (..., 3) RGB samples, rounded."""
    gray = rgb.astype(np.int64) @ np.asarray(_CV_GRAY_WEIGHTS, np.int64)
    return ((gray + (1 << 13)) >> 14).astype(np.uint8)


def read_bmp(path, gray: bool = False) -> np.ndarray:
    """A BMP file as ``cv2.imread`` reads it: (H, W, 3) uint8 RGB, or
    (H, W) uint8 with ``gray``.  A palette's entries past those the file
    lists are black."""
    data = _read_bytes(path)
    if not data.startswith(b"BM"):
        raise _unsupported(path, _format_of(data[:4]))
    if len(data) < 26:
        raise IOError(f"could not read image {path!r}: truncated BMP header")
    offset, hsize = struct.unpack_from("<II", data, 10)
    if hsize < 40 or len(data) < 54:     # BITMAPINFOHEADER, V4, V5 only
        raise _unsupported(path, f"a BMP with a {hsize}-byte header")
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    used = struct.unpack_from("<I", data, 46)[0]
    bitfields = compression == 3 and bpp == 32 and len(data) >= 66 and (
        struct.unpack_from("<III", data, 54) == _BGRX_MASKS)
    if bitfields:
        compression = 0     # the masks of plain 32-bit BGRX, as cv2 writes them
    if compression in _BMP_COMPRESSION:
        raise _unsupported(path, f"a {_BMP_COMPRESSION[compression]} BMP")
    if compression or bpp not in (1, 4, 8, 24, 32):
        raise _unsupported(path, f"a BMP of {bpp} bits a pixel, "
                                 f"compression {compression}")
    top_down, height = height < 0, abs(height)
    if width <= 0 or height == 0:
        raise IOError(f"could not read image {path!r}: BMP of {width} x {height}")
    pitch = (width * bpp + 31) // 32 * 4
    if offset + pitch * height > len(data):
        raise IOError(f"could not read image {path!r}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, pitch * height, offset).reshape(height, pitch)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        count = used or 1 << bpp
        if count > 256:
            raise IOError(f"could not read image {path!r}: {count} palette entries")
        start = 14 + hsize
        table = np.frombuffer(data[start:start + count * 4], np.uint8)
        palette = np.zeros((256, 3), np.uint8)    # BGR
        listed = table.reshape(-1, 4)[:, :3]
        palette[:len(listed)] = listed
        shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
        index = ((rows[:, :, None] >> shifts) & np.uint8((1 << bpp) - 1))
        index = index.reshape(height, -1)[:, :width]
        rgb_palette = palette[:, ::-1]
        if gray:
            return _cv_gray(rgb_palette)[index]
        return rgb_palette[index]
    rgb = rows[:, :width * bpp // 8].reshape(height, width, bpp // 8)[..., 2::-1]
    if gray and bitfields:
        # cv2's masked-channel path: float32 (0.299 R + 0.587 G) + 0.114 B,
        # truncated
        r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
        mixed = (np.float32(0.299) * r + np.float32(0.587) * g) + np.float32(0.114) * b
        return mixed.astype(np.uint8)
    if gray:
        return _cv_gray(rgb)
    return np.ascontiguousarray(rgb.astype(np.uint8))


# EXIF orientation -> what cv2.imread does to the stored image: transpose
# first, then flip (0 rows, 1 columns, -1 both), as cv2's
# ApplyExifOrientation does
_ORIENT = {1: (False, None), 2: (False, 1), 3: (False, -1), 4: (False, 0),
           5: (True, None), 6: (True, 1), 7: (True, -1), 8: (True, 0)}


def read_jpeg(path, gray: bool = False) -> np.ndarray:
    """A JPEG file as ``cv2.imread`` reads it: (H, W, 3) uint8 RGB, or
    (H, W) uint8 luma with ``gray``, the EXIF orientation applied."""
    data = _read_bytes(path)
    try:
        img, info = _native.codec().jpeg_decode(data, gray)
    except _native.JpegError as e:
        if e.unsupported:
            raise _unsupported(path, str(e)) from e
        raise IOError(f"could not read image {path!r}: {e}") from e
    transpose, flip = _ORIENT[info["orientation"]]
    if transpose:
        img = img.swapaxes(0, 1)
    if flip in (0, -1):
        img = img[::-1]
    if flip in (1, -1):
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def _kind(path) -> str:
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError as e:
        raise IOError(f"could not read image {path!r}: {e}") from e
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if head.startswith(b"\xff\xd8"):
        return "jpeg"
    raise _unsupported(path, _format_of(head))


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.imread(path, IMREAD_COLOR)`` followed by
    ``COLOR_BGR2RGB``."""
    kind = _kind(path)
    if kind == "bmp":
        return read_bmp(path)
    if kind == "jpeg":
        return read_jpeg(path)
    return _png_rgb(path)


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8, as ``cv2.imread(path, IMREAD_GRAYSCALE)``."""
    kind = _kind(path)
    if kind == "bmp":
        return read_bmp(path, gray=True)
    if kind == "jpeg":
        return read_jpeg(path, gray=True)
    return _png_gray(path)


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------

def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: first source index, second
    (clamped) and the first weight in [0, 1], half-pixel centres."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    low, high = i0 < 0, i0 >= src - 1
    f[low | high] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), 1.0 - f


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) for (H, W) or (H, W, C)
    images; ``size`` is (width, height) as ``cv2`` takes it.  uint8 takes
    cv2's fixed point (weights in 1/2048, the rounding of its vector
    path); float images bilinear in float32."""
    out_w, out_h = size
    h, w = img.shape[:2]
    ys, ys1, wy = _linear_taps(h, out_h)
    xs, xs1, wx = _linear_taps(w, out_w)
    extra = (1,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        ax = np.rint(wx * 2048).astype(np.int64).reshape(-1, *extra)
        by = np.rint(wy * 2048).astype(np.int64).reshape(-1, 1, *extra)
        im = img.astype(np.int64)
        rows = im[:, xs] * ax + im[:, xs1] * (2048 - ax)
        v = ((((rows[ys] >> 4) * by) >> 16)
             + (((rows[ys1] >> 4) * (2048 - by)) >> 16) + 2) >> 2
        return np.clip(v, 0, 255).astype(np.uint8)
    im = img.astype(np.float32)
    ax = wx.astype(np.float32).reshape(-1, *extra)
    by = wy.astype(np.float32).reshape(-1, 1, *extra)
    rows = im[:, xs] * ax + im[:, xs1] * (1 - ax)
    return (rows[ys] * by + rows[ys1] * (1 - by)).astype(img.dtype)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``: source index
    floor(dst · src/dst), in double as cv2 computes it."""
    out_w, out_h = size
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))), w - 1)
    return np.ascontiguousarray(img[ys.astype(np.int64)][:, xs.astype(np.int64)])


# --------------------------------------------------------------------------
# affine warp
# --------------------------------------------------------------------------

def rotation_matrix_2d(center: tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, ``angle`` in degrees,
    counter-clockwise about ``center`` (x, y)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``, in double."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 index: ... 2 1 | 0 1 2 ... n-1 | n-2 ..."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def warp_affine_reflect101(img: np.ndarray, m: np.ndarray,
                           size: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, size, flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT_101)`` for (H, W) or (H, W, C) uint8 or
    float32 images; ``size`` is (width, height).  Each destination pixel
    (x, y) reads the source at inv(m) · (x, y, 1), computed in float32 as
    ``a·x + (b·y + c)``, bilinearly from its four neighbours, each
    reflected into the image; uint8 rounds half to even."""
    out_w, out_h = size
    h, w = img.shape[:2]
    inv = invert_affine(m).astype(np.float32)
    xs = np.arange(out_w, dtype=np.float32)[None, :]
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    sx = inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])
    sy = inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])
    fx, fy = np.floor(sx), np.floor(sy)
    extra = (1,) * (img.ndim - 2)
    ax = (sx - fx).reshape(out_h, out_w, *extra)
    ay = (sy - fy).reshape(out_h, out_w, *extra)
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    xa, xb = _reflect101(x0, w), _reflect101(x0 + 1, w)
    ya, yb = _reflect101(y0, h), _reflect101(y0 + 1, h)
    src = img.astype(np.float32)
    p00, p01, p10, p11 = src[ya, xa], src[ya, xb], src[yb, xa], src[yb, xb]
    r0 = p00 + ax * (p01 - p00)
    r1 = p10 + ax * (p11 - p10)
    v = r0 + ay * (r1 - r0)
    if img.dtype == np.uint8:
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return v.astype(img.dtype)
