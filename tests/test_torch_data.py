"""The port's data layer on the CPU against the JAX package's: TFRecord
bytes, the native codec against the Python CRC and scanner, and the
loaders' batches and their order (numpy RNG in both) for the same seed."""
import struct
from unittest import mock

import numpy as np
import pytest
import torch

from vit_unet_tpu.data import loader as JL
from vit_unet_tpu.data import tfrecord as jtfr
from vit_unet_tpu_torch.data import _native
from vit_unet_tpu_torch.data import loader as TL
from vit_unet_tpu_torch.data import tfrecord as tfr
from tests.test_torch_model import one_torch_thread  # noqa: F401

FEATURES = [
    {"x": np.arange(12, dtype=np.uint8).tobytes(), "y": b"hi",
     "f": np.asarray([1.5, -2.25], np.float32), "i": [3, -4, 5]},
    {"label": np.int64(5), "score": np.float32(0.25),
     "empty_f": np.asarray([], np.float32), "empty_i": np.asarray([], np.int64)},
]


@pytest.fixture(scope="module")
def codec():
    if _native.shutil.which("c++") is None and _native.shutil.which("g++") is None \
            and _native.shutil.which("clang++") is None:
        pytest.skip("no C++ compiler to build the native codec with")
    return _native.codec()


def _images(n, seed=7, size=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def _shards(tmp_path, n=10, max_mb=1):
    items = [{"x": im.tobytes(), "y": (255 - im).tobytes()} for im in _images(n)]
    return tfr.convert(items, str(tmp_path), "fold_0_", lambda it: it, max_mb=max_mb)


def test_crc32c_native_matches_python(codec):
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, 4096):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert tfr.crc32c(data) == tfr.crc32c(data, native=False) == jtfr._crc32c_py(data), n
        assert tfr.masked_crc(data) == tfr.masked_crc(data, native=False), n
    assert tfr.crc32c(b"123456789") == 0xE3069283
    assert tfr.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert tfr.crc32c(bytearray(b"123456789")) == 0xE3069283


@pytest.mark.parametrize("native", [True, False])
def test_written_bytes_match_jax(tmp_path, codec, native):
    paths = {}
    for name, mod, kw in (("port", tfr, {"native": native}), ("jax", jtfr, {})):
        paths[name] = str(tmp_path / f"{name}.tfrec")
        with mod.TFRecordWriter(paths[name], **kw) as w:
            for feats in FEATURES:
                w.write_example(feats)
            w.write(b"")
    port, jax_ = (open(paths[k], "rb").read() for k in ("port", "jax"))
    assert port == jax_
    for feats, payload in zip(FEATURES, tfr.read_records(paths["port"])):
        got, want = tfr.decode_example(payload), jtfr.decode_example(payload)
        assert got.keys() == want.keys() == feats.keys()
        for k in got:
            if isinstance(want[k], list):
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k])


def test_convert_and_count_match_jax(tmp_path, codec):
    items = [{"x": bytes([i]) * 40000, "y": bytes([i])} for i in range(60)]
    port = tfr.convert(items, str(tmp_path / "p"), "ssid_fold_0_", lambda it: it, max_mb=1)
    want = jtfr.convert(items, str(tmp_path / "j"), "ssid_fold_0_", lambda it: it, max_mb=1)
    assert [p.split("/")[-1] for p in port] == [p.split("/")[-1] for p in want]
    assert len(port) > 1
    for a, b in zip(port, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert tfr.count_data_items(port) == jtfr.count_data_items(want) == 60
    with pytest.raises(ValueError, match="item count"):
        tfr.count_data_items(["no_count.tfrec"])


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", tfr.masked_crc(header, False)) + payload
            + struct.pack("<I", tfr.masked_crc(payload, False)))


FAULTS = {   # name -> (damage to two good records, what both readers say)
    "payload": (lambda r: r[:14] + bytes([r[14] ^ 0xFF]) + r[15:], "corrupt record payload"),
    "header crc": (lambda r: r[:8] + bytes([r[8] ^ 0xFF]) + r[9:], "corrupt record header"),
    "truncated record": (lambda r: r[:-6], "truncated record"),
    "truncated header": (lambda r: r + b"\x01\x02\x03", "truncated record header"),
    "huge length": (lambda r: struct.pack("<Q", 2**64 - 8) + b"\x00" * 24, "truncated record"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_native_scanner_matches_python_and_detects_faults(tmp_path, codec, fault):
    good = _record(b"payload-one") + _record(b"payload-two" * 50)
    path = tmp_path / "ok.tfrec"
    path.write_bytes(good)
    want = list(tfr.read_records(str(path), native=False))
    assert want == [b"payload-one", b"payload-two" * 50]
    assert list(tfr.read_records(str(path))) == want
    assert list(tfr.read_records_streaming(str(path))) == want
    assert list(tfr.read_records_streaming(str(path), native=False)) == want
    assert list(jtfr.read_records(str(path))) == want
    damage, message = FAULTS[fault]
    path.write_bytes(damage(good))
    for native in (True, False):
        with pytest.raises(IOError, match=message):
            list(tfr.read_records(str(path), native=native))
    for native in (True, False):
        with pytest.raises(IOError):
            list(tfr.read_records_streaming(str(path), native=native))


def test_scan_spans_cross_call_boundaries(codec, monkeypatch):
    monkeypatch.setattr(_native, "SPANS_PER_CALL", 3)
    payloads = [bytes([i]) * (i * 17 + 1) for i in range(10)]
    data = b"".join(_record(p) for p in payloads)
    spans = list(codec.scan(data))
    assert [data[o:o + n] for o, n in spans] == payloads
    assert list(codec.scan(data, verify_crc=False)) == spans


def test_native_codec_builds_or_raises(tmp_path, monkeypatch):
    """A failed build raises, and the codec's callers do not fall back to
    Python."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed"):
        _native.build()
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _native.compiler()
    with mock.patch.object(_native, "codec", side_effect=RuntimeError("no build")):
        with pytest.raises(RuntimeError, match="no build"):
            tfr.crc32c(b"abc")
        assert tfr.crc32c(b"123456789", native=False) == 0xE3069283


class _Numbers:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32), "y": np.asarray(i * 2)}


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=5, shuffle=True, drop_remainder=False, num_workers=0),
    dict(batch_size=2, shuffle=True, shard_id=1, num_shards=3, num_workers=3),
])
def test_dataloader_matches_jax(kw):
    port, jax_ = TL.DataLoader(_Numbers(), **kw), JL.DataLoader(_Numbers(), **kw)
    assert len(port) == len(jax_)
    for _ in range(2):                        # two epochs: reshuffled alike
        got, want = list(port), list(jax_)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("host_convert", [True, False])
@pytest.mark.parametrize("shuffle_buffer", [0, 4])
def test_tfrecord_stream_matches_jax(tmp_path, codec, host_convert, shuffle_buffer):
    paths = _shards(tmp_path, n=13, max_mb=1) + _shards(tmp_path / "b", n=6)
    kw = dict(shape=(8, 8, 3), batch_size=4, shuffle_buffer=shuffle_buffer,
              seed=5, host_convert=host_convert)
    port, jax_ = TL.TFRecordStream(paths, **kw), JL.TFRecordStream(paths, **kw)
    for _ in range(2):
        got, want = list(port), list(jax_)
        assert len(got) == len(want) == 19 // 4
        for a, b in zip(got, want):
            for k in ("x", "y"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_tfrecord_dataset_matches_jax(tmp_path, codec):
    paths = _shards(tmp_path)
    port = TL.tfrecord_dataset(paths, (8, 8, 3))
    want = JL.tfrecord_dataset(paths, (8, 8, 3))
    assert len(port) == len(want) == 10
    for i in range(10):
        for k in ("x", "y"):
            np.testing.assert_array_equal(port[i][k], want[i][k])


def test_device_normalize_matches_jax_on_the_cpu():
    rng = np.random.default_rng(2)
    batch = {"x": rng.integers(0, 255, (3, 8, 8, 3), dtype=np.uint8),
             "w": np.arange(3, dtype=np.float32)}
    want = JL.device_normalize()(batch)
    got = TL.device_normalize()({k: torch.from_numpy(v) for k, v in batch.items()})
    # XLA takes /255 as a multiply by the reciprocal: one ulp apart
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(got["w"].numpy(), batch["w"])
    assert got["x"].shape == (3, 3, 8, 8) and got["x"].is_contiguous()
    bf = TL.device_normalize(dtype=torch.bfloat16, channels_first=False)(
        {"x": torch.from_numpy(batch["x"])})["x"]
    assert bf.dtype == torch.bfloat16 and bf.shape == (3, 8, 8, 3)


@pytest.mark.parametrize("kw", [dict(batch_size=4, shuffle=False),
                                dict(batch_size=3, seed=1),
                                dict(batch_size=4, seed=2, drop_remainder=False)])
def test_device_resident_data_matches_jax_on_the_cpu(kw):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 255, (10, 8, 8, 3), dtype=np.uint8)
    port = TL.DeviceResidentData(x, 255 - x, device="cpu", **kw)
    jax_ = JL.DeviceResidentData(x, 255 - x, **kw)
    assert len(port) == len(jax_)
    for _ in range(2):
        got, want = list(port), list(jax_)
        assert len(got) == len(want) == len(port)
        for a, b in zip(got, want):
            for k in ("x", "y"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=0, atol=1.2e-7)


def test_prefetch_to_device_on_the_cpu(tmp_path, codec):
    paths = _shards(tmp_path)
    raw = TL.TFRecordStream(paths, (8, 8, 3), 4, host_convert=False)
    host = list(TL.TFRecordStream(paths, (8, 8, 3), 4))
    got = list(TL.prefetch_to_device(iter(raw), device="cpu",
                                     transform=TL.device_normalize()))
    assert len(got) == len(host) == 2
    for a, b in zip(got, host):
        for k in ("x", "y"):
            assert isinstance(a[k], torch.Tensor) and a[k].dtype == torch.float32
            np.testing.assert_allclose(a[k].numpy(), b[k], rtol=0, atol=1.2e-7)
    # a consumer that stops early stops the producer too
    it = TL.prefetch_to_device(iter(TL.DataLoader(_Numbers(), 1)), size=1, device="cpu")
    next(it)
    it.close()


def test_prefetch_propagates_producer_errors():
    def bad_iter():
        yield {"x": np.ones(2)}
        raise IOError("corrupt shard")

    it = TL.prefetch_to_device(bad_iter(), device="cpu")
    np.testing.assert_array_equal(next(it)["x"].numpy(), np.ones(2))
    with pytest.raises(IOError, match="corrupt shard"):
        next(it)


def test_feeds_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.DeviceResidentData(x, x, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(TL.prefetch_to_device(iter([{"x": x}])))
