"""Build and load the data path's native half (``_native.cc``): the
TFRecord codec's CRC32C and record scan, PNG's row unfiltering, and the
JPEG decoder.

The source is compiled at first use with the host's C++ compiler into a
shared library with a plain C interface, under ``build/torch_native/`` at
the root of the checkout, and loaded with ``ctypes``.  The library's file
name carries a hash of the flags and the source.  A build that fails
raises: nothing falls back to the Python codec.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

SOURCE = Path(__file__).resolve().with_name("_native.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
SPANS_PER_CALL = 4096
_SCAN_FAULTS = {-1: "truncated record header", -2: "truncated record",
                -3: "corrupt record header", -4: "corrupt record payload"}
#: ``jpeg::Status`` -> (what it is, whether it is a variant the decoder does
#: not take, rather than damaged data)
JPEG_FAULTS = {
    -1: ("not a JPEG file", False),
    -2: ("corrupt JPEG data", False),
    -3: ("an arithmetic-coded JPEG", True),
    -4: ("a lossless JPEG", True),
    -5: ("a hierarchical JPEG", True),
    -6: ("a JPEG of a sample precision other than 8 bits (12-bit)", True),
    -7: ("a four-component (CMYK / YCCK) JPEG", True),
    -8: ("a JPEG with other than 1 or 3 components", True),
    -9: ("a JPEG with fractional sampling factors", True),
    -10: ("a JPEG without a frame header", False),
    -11: ("a progressive JPEG whose scans leave its low AC coefficients "
          "inexact (libjpeg block-smooths it; a file cut short)", True),
    -12: ("an RGB-coded JPEG (Adobe transform 0, or components 'R', 'G', 'B')",
          True),
}

_lock = threading.Lock()
_codec: "NativeCodec | None" = None


def compiler() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++, g++ or clang++) on the PATH: "
                       "the data path's native code is built from "
                       f"{SOURCE.name} at first use")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"native-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``_native.cc`` unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler(), *FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bytes(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


class NativeCodec:
    """The loaded library.  ``calls`` counts the bytes and calls that went
    through it, so a run can show that the native codec is the one that
    ran."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        lib.vit_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.vit_crc32c.restype = ctypes.c_uint32
        lib.vit_scan_records.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.vit_scan_records.restype = ctypes.c_int
        lib.vit_png_unfilter.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.vit_png_unfilter.restype = ctypes.c_int64
        lib.vit_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_void_p]
        lib.vit_jpeg_info.restype = ctypes.c_int64
        lib.vit_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_void_p]
        lib.vit_jpeg_decode.restype = ctypes.c_int64
        self._lib = lib
        self.calls = {"crc": 0, "crc_bytes": 0, "scan": 0, "scan_bytes": 0}

    def crc32c(self, data) -> int:
        data = _bytes(data)
        self.calls["crc"] += 1
        self.calls["crc_bytes"] += len(data)
        return int(self._lib.vit_crc32c(data, len(data)))

    def scan(self, data: bytes, verify_crc: bool = True
             ) -> Iterator[tuple[int, int]]:
        """(payload offset, length) of each record of ``data``, in order;
        raises ``IOError`` at the first faulty record."""
        self.calls["scan"] += 1
        self.calls["scan_bytes"] += len(data)
        spans = np.empty(2 * SPANS_PER_CALL, np.uint64)
        count, pos = ctypes.c_int64(0), ctypes.c_uint64(0)
        while True:
            rc = self._lib.vit_scan_records(
                data, len(data), int(verify_crc), spans.ctypes.data,
                SPANS_PER_CALL, ctypes.byref(count), ctypes.byref(pos))
            for i in range(count.value):
                yield int(spans[2 * i]), int(spans[2 * i + 1])
            if rc == 0:
                return
            if rc < 0:
                raise IOError(f"{_SCAN_FAULTS[rc]} at offset {pos.value}")

    def png_unfilter(self, data: bytes, height: int, rowbytes: int,
                     bpp: int) -> np.ndarray:
        """The (height, rowbytes) unfiltered bytes of a PNG image's inflated
        data ``data``: ``height`` rows of a filter type byte and
        ``rowbytes`` filtered bytes, ``bpp`` bytes a pixel.  Raises
        ``ValueError`` on a short buffer or an unknown filter type.  Safe to
        call from several threads (it counts nothing in ``calls``)."""
        if len(data) != height * (rowbytes + 1):
            raise ValueError(f"{len(data)} bytes of image data, expected "
                             f"{height * (rowbytes + 1)}")
        out = np.empty((height, rowbytes), np.uint8)
        rc = self._lib.vit_png_unfilter(data, out.ctypes.data, height,
                                        rowbytes, max(1, bpp))
        if rc:
            row = -rc - 1
            raise ValueError(f"unknown filter type "
                             f"{data[row * (rowbytes + 1)]} in row {row}")
        return out


    def jpeg_info(self, data: bytes) -> dict:
        """The header of a JPEG file's bytes: height, width, components,
        EXIF orientation (1-8) and progressive.  Raises ``JpegError``."""
        info = np.zeros(5, np.int64)
        rc = self._lib.vit_jpeg_info(data, len(data), info.ctypes.data)
        if rc:
            raise JpegError(int(rc))
        h, w, comps, orientation, progressive = (int(v) for v in info)
        return dict(height=h, width=w, components=comps,
                    orientation=orientation, progressive=bool(progressive))

    def jpeg_decode(self, data: bytes, gray: bool) -> tuple[np.ndarray, dict]:
        """A JPEG file's bytes decoded as libjpeg-turbo decodes them: (H, W,
        3) uint8 RGB, or (H, W) uint8 luma with ``gray``, in stored
        orientation, and its ``jpeg_info``.  Raises ``JpegError``.  Safe to
        call from several threads (it counts nothing in ``calls``)."""
        info = self.jpeg_info(data)
        shape = ((info["height"], info["width"]) if gray
                 else (info["height"], info["width"], 3))
        out = np.empty(shape, np.uint8)
        rc = self._lib.vit_jpeg_decode(data, len(data), int(gray),
                                       out.ctypes.data)
        if rc:
            raise JpegError(int(rc))
        return out, info


class JpegError(ValueError):
    """A JPEG the decoder cannot read: ``status`` is the ``jpeg::Status``,
    ``unsupported`` whether the file is a variant it does not take."""

    def __init__(self, status: int):
        what, self.unsupported = JPEG_FAULTS.get(status, ("corrupt JPEG data", False))
        self.status = status
        super().__init__(what)


def codec() -> NativeCodec:
    """Build (if needed) and load the codec once per process."""
    global _codec
    with _lock:
        if _codec is None:
            _codec = NativeCodec(build())
        return _codec
