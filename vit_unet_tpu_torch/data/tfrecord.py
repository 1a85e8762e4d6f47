"""TFRecord codec without TensorFlow: the port's own copy of
``vit_unet_tpu/data/tfrecord.py``.

* record framing: ``uint64 length | masked_crc32c(length) | payload |
  masked_crc32c(payload)`` (little-endian, CRC32-Castagnoli with TF's mask);
* a minimal ``tf.train.Example`` protobuf codec for bytes / float / int64
  feature lists;
* size-capped sharded conversion with the item count in each shard's name.

CRC32C and the whole-shard record scan run in the native codec
(``_native.cc``, built at first use by ``data/_native.py``); a build that
fails raises.  The pure-Python CRC and scanner are the plain version, taken
only by asking for them (``native=False``); the tests hold the native codec
against them.
"""
from __future__ import annotations

import os
import re
import struct
from typing import Iterable, Iterator, Mapping

import numpy as np

from vit_unet_tpu_torch.data import _native

# --------------------------------------------------------------------------
# CRC32-Castagnoli (polynomial 0x1EDC6F41, reflected 0x82F63B78) + TF mask
# --------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            crc = np.uint32(i)
            for _ in range(8):
                crc = (crc >> np.uint32(1)) ^ (np.uint32(0x82F63B78) *
                                               (crc & np.uint32(1)))
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, dtype=np.uint8)
    for b in arr:
        crc = table[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def crc32c(data: bytes, native: bool = True) -> int:
    """CRC32-Castagnoli of ``data``: the native codec, or with
    ``native=False`` the Python version."""
    if native:
        return _native.codec().crc32c(data)
    return _crc32c_py(data)


def masked_crc(data: bytes, native: bool = True) -> int:
    crc = crc32c(data, native)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# --------------------------------------------------------------------------
# Minimal protobuf for tf.train.Example
# --------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """length-delimited field (wire type 2)."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_feature(value) -> bytes:
    """Feature := bytes_list(1) | float_list(2) | int64_list(3)."""
    if isinstance(value, (bytes, bytearray, np.void)):
        value = [bytes(value)]
    if isinstance(value, str):
        value = [value.encode()]
    if isinstance(value, np.ndarray):
        if value.dtype == np.float32 or value.dtype == np.float64:
            value = value.astype(np.float32).ravel().tolist()
        elif value.dtype.kind in "iu":
            value = value.ravel().tolist()
        else:
            value = [value.tobytes()]
    if not isinstance(value, (list, tuple)):
        value = [value]
    first = value[0] if value else b""
    if isinstance(first, (bytes, bytearray)):
        inner = b"".join(_ld(1, bytes(v)) for v in value)
        return _ld(1, inner)                      # BytesList
    if isinstance(first, (float, np.floating)):
        packed = struct.pack(f"<{len(value)}f", *[float(v) for v in value])
        inner = _varint((1 << 3) | 2) + _varint(len(packed)) + packed
        return _ld(2, inner)                      # FloatList (packed)
    if isinstance(first, (int, np.integer)):
        packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                          for v in value)
        inner = _varint((1 << 3) | 2) + _varint(len(packed)) + packed
        return _ld(3, inner)                      # Int64List (packed)
    raise TypeError(f"unsupported feature value type {type(first)}")


def encode_example(features: Mapping[str, object]) -> bytes:
    """tf.train.Example{features: Features{feature: map<string, Feature>}}."""
    entries = b""
    for key, value in features.items():
        entry = _ld(1, key.encode()) + _ld(2, encode_feature(value))
        entries += _ld(1, entry)                  # map entry in Features
    return _ld(1, entries)                        # Example.features


def decode_example(buf: bytes) -> dict:
    """Decode Example -> {name: list[bytes] | np.ndarray}."""
    out: dict = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 != 1 or tag & 7 != 2:
            raise ValueError("not an Example message")
        flen, pos = _read_varint(buf, pos)
        features_buf = buf[pos:pos + flen]
        pos += flen
        fpos = 0
        while fpos < len(features_buf):
            ftag, fpos = _read_varint(features_buf, fpos)
            elen, fpos = _read_varint(features_buf, fpos)
            entry = features_buf[fpos:fpos + elen]
            fpos += elen
            key, feat = _decode_map_entry(entry)
            out[key] = feat
    return out


def _decode_map_entry(entry: bytes):
    pos = 0
    key = None
    feat = None
    while pos < len(entry):
        tag, pos = _read_varint(entry, pos)
        length, pos = _read_varint(entry, pos)
        body = entry[pos:pos + length]
        pos += length
        if tag >> 3 == 1:
            key = body.decode()
        else:
            feat = _decode_feature(body)
    return key, feat


def _decode_feature(body: bytes):
    if not body:                      # Feature with no list set
        return []
    tag, pos = _read_varint(body, 0)
    field = tag >> 3
    length, pos = _read_varint(body, pos)
    inner = body[pos:pos + length]
    if field == 2 and not inner:      # empty FloatList
        return np.empty(0, dtype="<f4")
    if field == 3 and not inner:      # empty Int64List
        return np.empty(0, dtype=np.int64)
    if field == 1:  # BytesList
        values = []
        ipos = 0
        while ipos < len(inner):
            _, ipos = _read_varint(inner, ipos)
            blen, ipos = _read_varint(inner, ipos)
            values.append(inner[ipos:ipos + blen])
            ipos += blen
        return values
    if field == 2:  # FloatList (packed)
        _, ipos = _read_varint(inner, 0)
        plen, ipos = _read_varint(inner, ipos)
        return np.frombuffer(inner, dtype="<f4", offset=ipos, count=plen // 4)
    if field == 3:  # Int64List (packed)
        _, ipos = _read_varint(inner, 0)
        plen, ipos = _read_varint(inner, ipos)
        values = []
        end = ipos + plen
        while ipos < end:
            v, ipos = _read_varint(inner, ipos)
            if v >= 1 << 63:
                v -= 1 << 64
            values.append(v)
        return np.asarray(values, dtype=np.int64)
    raise ValueError(f"unknown Feature field {field}")


# --------------------------------------------------------------------------
# Record-level IO
# --------------------------------------------------------------------------

def _open_binary(source, mode: str):
    """(file_obj, owns, display_name) for a path, URL, or file-like object.

    Remote URLs (``gs://``, ``s3://``, ``memory://``, ...) go through fsspec
    when it is installed.  File-like objects (anything with read/write) are
    used as-is and not closed.
    """
    if hasattr(source, "read") or hasattr(source, "write"):
        return source, False, getattr(source, "name", repr(source))
    path = os.fspath(source)
    scheme = path.split("://", 1)[0] if "://" in path else ""
    if scheme and scheme != "file":
        try:
            import fsspec
        except ImportError as e:
            raise ImportError(
                f"reading {path!r} needs fsspec (pip install fsspec"
                f"[+{scheme} backend]) or pass an open file-like object"
            ) from e
        return fsspec.open(path, mode).open(), True, path
    return open(path, mode), True, path


class TFRecordWriter:
    """Writes TFRecord framing to a local path, an fsspec URL, or an open
    binary file-like object."""

    def __init__(self, path, native: bool = True):
        self.native = native
        self._f, self._owns, self.name = _open_binary(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header, self.native)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload, self.native)))

    def write_example(self, features: Mapping[str, object]) -> None:
        self.write(encode_example(features))

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path, verify_crc: bool = True,
                 native: bool = True) -> Iterator[bytes]:
    """Yield record payloads from a local path, an fsspec URL (``gs://``
    etc.), or an open binary file-like object, read whole.  The native
    codec scans and checks the shard in one pass; ``native=False`` takes
    the Python scanner."""
    f, owns, path = _open_binary(path, "rb")
    try:
        data = f.read()
    finally:
        if owns:
            f.close()
    if native:
        try:
            for off, length in _native.codec().scan(data, verify_crc):
                yield data[off:off + length]
        except IOError as e:
            raise IOError(f"{e} in {path}") from None
        return
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 16 > n:
            raise IOError(f"truncated record header at offset {pos} in {path}")
        (length,) = struct.unpack_from("<Q", data, pos)
        if length > n - pos - 16:
            raise IOError(f"truncated record at offset {pos} in {path}")
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if verify_crc:
            if masked_crc(header, False) != hcrc:
                raise IOError(f"corrupt record header at offset {pos} in {path}")
            if masked_crc(payload, False) != pcrc:
                raise IOError(f"corrupt record payload at offset {pos} in {path}")
        yield payload
        pos += 16 + length


_READ_CHUNK = 1 << 26


def _read_at_most(f, n: int) -> bytes:
    """Up to ``n`` bytes of ``f``, read in chunks, so that a corrupt length
    field near 2^64 ends the read at the end of the file instead of asking
    for a buffer of that size."""
    parts, got = [], 0
    while got < n:
        part = f.read(min(n - got, _READ_CHUNK))
        if not part:
            break
        parts.append(part)
        got += len(part)
    return b"".join(parts)


def read_records_streaming(path, verify_crc: bool = True,
                           native: bool = True) -> Iterator[bytes]:
    """Yield record payloads reading the file incrementally: peak RAM is
    one record, not one shard.  The CRCs are the native codec's unless
    ``native=False``.  Works on local paths, fsspec URLs and open binary
    files."""
    f, owns, path = _open_binary(path, "rb")
    try:
        pos = 0
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise IOError(f"truncated record header at offset {pos} "
                              f"in {path}")
            (length,) = struct.unpack_from("<Q", head, 0)
            (hcrc,) = struct.unpack_from("<I", head, 8)
            body = _read_at_most(f, length + 4)
            if len(body) < length + 4:
                raise IOError(f"truncated record at offset {pos} in {path}")
            payload = body[:length]
            (pcrc,) = struct.unpack_from("<I", body, length)
            if verify_crc:
                if masked_crc(head[:8], native) != hcrc:
                    raise IOError(f"corrupt record header at offset {pos} "
                                  f"in {path}")
                if masked_crc(payload, native) != pcrc:
                    raise IOError(f"corrupt record payload at offset {pos} "
                                  f"in {path}")
            yield payload
            pos += 16 + length
    finally:
        if owns:
            f.close()


def read_examples(path: str, verify_crc: bool = True,
                  streaming: bool = False, native: bool = True) -> Iterator[dict]:
    records = (read_records_streaming if streaming else read_records)(
        path, verify_crc, native)
    for payload in records:
        yield decode_example(payload)


# --------------------------------------------------------------------------
# Sharded conversion
# --------------------------------------------------------------------------

def convert(
    items: Iterable,
    folder: str,
    prefix: str,
    serialize_fn,
    max_mb: int = 1000,
    zfill: int = 3,
) -> list[str]:
    """Write items into size-capped shards named ``{prefix}{idx}-{count}.tfrec``
    with the item count in the filename (the contract ``count_data_items``
    relies on).

    ``folder`` may be a local directory or an fsspec URL (``gs://bucket/dir``).
    Remote shards are buffered in memory (bounded by ``max_mb``) because the
    count in the file name is only known once the shard is full.
    """
    remote = "://" in str(folder) and not str(folder).startswith("file://")
    if not remote:
        os.makedirs(folder, exist_ok=True)
    join = (lambda *p: "/".join(s.strip("/") for s in p)) if remote else os.path.join
    paths: list[str] = []
    shard_idx = 0
    shard_bytes = 0
    shard_count = 0
    tmp_path = None
    writer = None

    def finish():
        nonlocal writer, tmp_path, shard_idx, shard_bytes, shard_count
        if writer is None:
            return
        final = join(
            folder, f"{prefix}{str(shard_idx).zfill(zfill)}-{shard_count}.tfrec")
        if remote:
            import fsspec
            buf = writer._f
            writer.close()
            with fsspec.open(final, "wb") as out:
                out.write(buf.getvalue())
        else:
            writer.close()
            os.replace(tmp_path, final)
        paths.append(final)
        shard_idx += 1
        shard_bytes = 0
        shard_count = 0
        writer = None

    for item in items:
        features = serialize_fn(item)
        payload = encode_example(features)
        if writer is not None and shard_bytes + len(payload) > max_mb * 2**20:
            finish()
        if writer is None:
            if remote:
                import io
                writer = TFRecordWriter(io.BytesIO())
            else:
                tmp_path = os.path.join(folder, f".{prefix}tmp{shard_idx}")
                writer = TFRecordWriter(tmp_path)
        writer.write(payload)
        shard_bytes += len(payload) + 16
        shard_count += 1
    finish()
    return paths


_COUNT_RE = re.compile(r"-(\d+)\.tfrec(?:ord)?$")


def count_data_items(filenames: Iterable[str]) -> int:
    """Sum the item counts encoded in shard filenames."""
    total = 0
    for name in filenames:
        m = _COUNT_RE.search(os.path.basename(name))
        if not m:
            raise ValueError(f"no item count in filename {name!r}")
        total += int(m.group(1))
    return total
