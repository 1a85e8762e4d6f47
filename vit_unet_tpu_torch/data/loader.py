"""Input pipeline: dataset -> shuffled, batched batches on the card.  The
counterpart of ``vit_unet_tpu/data/loader.py``:

* ``DataLoader``: a thread pool decodes samples ahead of consumption,
  full batches by default, per-shard slices of equal length;
* ``tfrecord_dataset`` and ``TFRecordStream``: TFRecord shards of {x, y}
  raw-pixel records, materialised or streamed;
* ``tfdata_pipeline``: the ``tf.data`` recipe of the JAX package (cache,
  repeat, shuffle buffer, parse, batch) on the port's own TFRecord reader,
  without TensorFlow;
* ``device_normalize``, ``DeviceResidentData`` and ``prefetch_to_device``:
  uint8 NHWC batches converted on the card, a data set staged on the card
  once, and host batches copied ahead of the consumer.

Batch order and shuffles are those of the JAX loaders for the same seed:
both draw them from numpy's generators.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from vit_unet_tpu_torch.data import tfrecord as tfr
from vit_unet_tpu_torch.utils.device import resolve_device


class DataLoader:
    """Iterable of {'x','y'} numpy batches from an indexable dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_remainder: bool = True, num_workers: int = 2,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            idx = rng.permutation(idx)
        # every shard gets the same number of samples, so that replicas
        # take the same number of steps
        per_shard = len(idx) // self.num_shards
        return idx[self.shard_id::self.num_shards][:per_shard]

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        self._epoch += 1
        bs = self.batch_size

        def fetch(i: int) -> dict:
            return self.dataset[int(i)]

        if self.num_workers == 0:
            samples: Iterable[dict] = (fetch(i) for i in indices)
        else:
            samples = self._windowed_map(fetch, indices)

        batch: list[dict] = []
        for s in samples:
            batch.append(s)
            if len(batch) == bs:
                yield _collate(batch)
                batch = []
        if batch and not self.drop_remainder:
            yield _collate(batch)

    def _windowed_map(self, fn, items) -> Iterator[dict]:
        """Thread-pool map with a bounded in-flight window: decodes stay a
        couple of batches ahead of consumption without materialising the
        whole epoch."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        window = max(2 * self.batch_size, 4 * self.num_workers)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque()
            for item in items:
                pending.append(pool.submit(fn, item))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()


def _collate(samples: Sequence[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def tfrecord_dataset(paths: Sequence[str], shape: tuple, dtype=np.uint8,
                     normalize: bool = True, channels_first: bool = True):
    """An indexable dataset of every {x, y} raw-pixel record of ``paths``
    (``shape``: one image's (H, W, C)), decoded into memory up front."""
    xs, ys = [], []
    for p in paths:
        for ex in tfr.read_examples(p):
            xs.append(np.frombuffer(ex["x"][0], dtype=dtype).reshape(shape))
            ys.append(np.frombuffer(ex["y"][0], dtype=dtype).reshape(shape))

    class _InMemory:
        def __len__(self):
            return len(xs)

        def __getitem__(self, i):
            x = xs[i].astype(np.float32)
            y = ys[i].astype(np.float32)
            if normalize:
                x = x / 255.0
                y = y / 255.0
            if channels_first:
                x = x.transpose(2, 0, 1)
                y = y.transpose(2, 0, 1)
            return {"x": x, "y": y}

    return _InMemory()


class TFRecordStream:
    """Streaming {'x','y'} batches straight off TFRecord shards: one record
    and the shuffle buffer in memory, never a whole shard.

    Records are read incrementally (``tfrecord.read_records_streaming``,
    CRCs in the native codec) and collated into fixed-size batches.
    ``host_convert=True`` gives float32 (C, H, W) in [0, 1] on the host;
    ``False`` gives the stored uint8 (H, W, C), to be converted on the card
    by ``device_normalize`` (a quarter of the bytes to copy).
    ``shuffle_buffer > 0`` shuffles the shard order and the records through
    a reservoir, with a fresh seed per epoch.  Re-iterable, so it can feed
    ``Fitter.fit`` directly.
    """

    def __init__(self, paths: Sequence[str], shape: tuple, batch_size: int,
                 dtype=np.uint8, normalize: bool = True,
                 channels_first: bool = True, shuffle_buffer: int = 0,
                 seed: int = 0, drop_remainder: bool = True,
                 verify_crc: bool = True, host_convert: bool = True):
        self.paths = list(paths)
        self.shape = shape
        self.batch_size = batch_size
        self.dtype = dtype
        self.normalize = normalize
        self.channels_first = channels_first
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.verify_crc = verify_crc
        self.host_convert = host_convert
        self._epoch = 0

    def _decode(self, ex: dict) -> dict:
        out = {}
        for k in ("x", "y"):
            a = np.frombuffer(ex[k][0], dtype=self.dtype).reshape(self.shape)
            if not self.host_convert:
                out[k] = a
                continue
            a = a.astype(np.float32)
            if self.normalize:
                a = a / 255.0
            if self.channels_first:
                a = a.transpose(2, 0, 1)
            out[k] = a
        return out

    def _samples(self, rng) -> Iterator[dict]:
        paths = list(self.paths)
        if rng is not None:
            rng.shuffle(paths)
        buf: list[dict] = []
        for p in paths:
            for ex in tfr.read_examples(p, verify_crc=self.verify_crc,
                                        streaming=True):
                s = self._decode(ex)
                if rng is None:
                    yield s
                    continue
                buf.append(s)
                if len(buf) >= self.shuffle_buffer:
                    j = int(rng.integers(len(buf)))
                    buf[j], s = buf[-1], buf[j]
                    buf.pop()
                    yield s
        if rng is not None:
            rng.shuffle(buf)
            yield from buf

    def __iter__(self) -> Iterator[dict]:
        rng = (np.random.default_rng(self.seed + self._epoch)
               if self.shuffle_buffer > 0 else None)
        self._epoch += 1
        batch: list[dict] = []
        for s in self._samples(rng):
            batch.append(s)
            if len(batch) == self.batch_size:
                yield _collate(batch)
                batch = []
        if batch and not self.drop_remainder:
            yield _collate(batch)


def _interleave(iterators: list, cycle: int) -> Iterator:
    """tf.data's deterministic interleave with block length 1: one element
    from each of ``cycle`` open iterators in turn; an exhausted one is
    replaced in its slot by the next unopened iterator, which is read at
    once."""
    pending = iter(iterators)
    slots = [it for _, it in zip(range(cycle), pending)]
    i = 0
    while slots:
        i %= len(slots)
        try:
            yield next(slots[i])
            i += 1
        except StopIteration:
            nxt = next(pending, None)
            if nxt is None:
                del slots[i]
            else:
                slots[i] = nxt


def tfdata_pipeline(
    filenames: Sequence[str],
    shape: tuple,
    batch_size: int = 32,
    shuffle: bool = False,
    repeat: bool = False,
    drop_remainder: bool = True,
    replicas: int = 1,
    dtype: str = "uint8",
    normalize: bool = True,
    channels_first: bool = True,
    cache: bool = True,
) -> Iterator[dict]:
    """The JAX package's ``tf.data`` recipe without TensorFlow: records of
    ``filenames`` read in parallel (interleaved one at a time across up to
    one shard per CPU) -> cache -> repeat -> shuffle (a buffer of 1024 x
    ``replicas``, unseeded, like tf.data's nondeterministic shuffle) ->
    parse {x, y} raw bytes of ``dtype`` into ``shape`` (H, W, C) -> float32,
    /255 when ``normalize``, (C, H, W) when ``channels_first`` -> batches of
    ``batch_size`` (the short last one dropped when ``drop_remainder``).
    Yields numpy {'x', 'y'} batches.  Local paths only: ``gs://`` raises."""
    remote = [f for f in filenames if "://" in str(f)]
    if remote:
        raise ValueError(f"tfdata_pipeline reads local files only, got "
                         f"{remote[0]!r}: copy the shards to local disk")
    h, w, c = shape
    dt = np.dtype(dtype).newbyteorder("<")
    cycle = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)

    def read_all() -> Iterator[bytes]:
        return _interleave([tfr.read_records_streaming(f) for f in filenames],
                           cycle)

    cached: list[bytes] = []

    def records() -> Iterator[bytes]:
        if not cache:
            yield from read_all()
            return
        if not cached:
            for r in read_all():
                cached.append(r)
                yield r
            return
        yield from cached

    def epochs() -> Iterator[bytes]:
        while True:
            yield from records()
            if not repeat:
                return

    stream: Iterator[bytes] = epochs()
    if shuffle:
        stream = _shuffled(stream, 1024 * replicas, np.random.default_rng())

    def parse(record: bytes) -> dict:
        ex = tfr.decode_example(record)
        out = {}
        for k in ("x", "y"):
            a = np.frombuffer(ex[k][0], dtype=dt).reshape(h, w, c)
            a = a.astype(np.float32)
            if normalize:
                a = a / 255.0
            if channels_first:
                a = a.transpose(2, 0, 1)
            out[k] = a
        return out

    batch: list[dict] = []
    for record in stream:
        batch.append(parse(record))
        if len(batch) == batch_size:
            yield _collate(batch)
            batch = []
    if batch and not drop_remainder:
        yield _collate(batch)


def _shuffled(items: Iterator, size: int, rng: np.random.Generator) -> Iterator:
    """tf.data's shuffle: fill a buffer of ``size``, then emit a random
    element and put the next input in its place; drain at the end."""
    buf: list = []
    for item in items:
        if len(buf) < size:
            buf.append(item)
            continue
        j = int(rng.integers(size))
        yield buf[j]
        buf[j] = item
    rng.shuffle(buf)
    yield from buf


def _convert_images(a: torch.Tensor, dtype: torch.dtype, normalize: bool,
                    channels_first: bool) -> torch.Tensor:
    """(B, H, W, C) -> float ``dtype``, /255 when ``normalize``, (B, C, H, W)
    when ``channels_first``."""
    a = a.to(dtype)
    if normalize:
        a = a / 255.0
    if channels_first:
        a = a.permute(0, 3, 1, 2).contiguous()
    return a


def device_normalize(normalize: bool = True, channels_first: bool = True,
                     dtype: Optional[torch.dtype] = None
                     ) -> Callable[[dict], dict]:
    """The batch converter for raw uint8 NHWC batches, the ``transform``
    companion of ``TFRecordStream(host_convert=False)``: float conversion,
    /255 and NHWC -> NCHW run where the batch lies (on the card after
    ``prefetch_to_device``).  Leaves that are not 4-D (labels, weights)
    pass through untouched."""
    dt = dtype or torch.float32

    def convert(batch: dict) -> dict:
        return {k: _convert_images(v, dt, normalize, channels_first)
                if v.ndim == 4 else v for k, v in batch.items()}

    return convert


class DeviceResidentData:
    """A data set staged on the card once, as it is stored (uint8 NHWC, a
    quarter of float32's size); each batch is an on-card gather of its
    indices and a conversion, so only the index vector crosses from the
    host per batch.

    ``x``/``y``: (N, H, W, C) arrays.  Batches come out as float ``dtype``,
    /255 when ``normalize`` and (B, C, H, W) when ``channels_first``,
    matching ``TFRecordStream``'s host-converted output.  Shuffles per epoch
    with a numpy permutation of the indices; re-iterable, so it can feed
    ``Fitter.fit`` directly.  ``device`` defaults to the card.
    """

    def __init__(self, x, y, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, normalize: bool = True,
                 channels_first: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 drop_remainder: bool = True, device=None):
        self.device = resolve_device(device)
        self.x = torch.as_tensor(np.ascontiguousarray(x)).to(self.device)
        self.y = torch.as_tensor(np.ascontiguousarray(y)).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)       # staged up front
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.normalize = normalize
        self.channels_first = channels_first
        self.dtype = dtype or torch.float32
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = self.x.shape[0] // self.batch_size
        if not self.drop_remainder and self.x.shape[0] % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[dict]:
        n = self.x.shape[0]
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_remainder and len(idx) < self.batch_size:
                break
            idx = torch.from_numpy(idx).to(self.device, non_blocking=True)
            yield {key: _convert_images(arr.index_select(0, idx), self.dtype,
                                        self.normalize, self.channels_first)
                   for key, arr in (("x", self.x), ("y", self.y))}


def _host_tensor(value, pin: bool) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(value)) if isinstance(
        value, np.ndarray) else torch.as_tensor(value)
    return t.pin_memory() if pin else t


def prefetch_to_device(iterator: Iterable[dict], size: int = 2, device=None,
                       transform: Optional[Callable[[dict], dict]] = None
                       ) -> Iterator[dict]:
    """Copy batches to ``device`` (default: the card) ahead of the
    consumer, overlapping the copies with its compute.

    A producer thread takes each host batch, pins it, and on the card
    copies it without blocking on a side stream, applies ``transform``
    (e.g. ``device_normalize()``) there, and records an event; the consumer
    makes its own stream wait on that event before it sees the batch.  At
    most ``size`` batches wait in the queue.  An error in the producer is
    raised in the consumer.  On ``device="cpu"`` the batches become tensors
    and are transformed in the producer."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()
    error: list[BaseException] = []
    side = torch.cuda.Stream(dev) if cuda else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce(batch: dict):
        if not cuda:
            out = {k: _host_tensor(v, False) for k, v in batch.items()}
            return (transform(out) if transform else out), None
        with torch.cuda.stream(side):
            out = {k: _host_tensor(v, True).to(dev, non_blocking=True)
                   for k, v in batch.items()}
            if transform is not None:
                out = transform(out)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def producer():
        try:
            for batch in iterator:
                if not put(produce(batch)):
                    return
        except BaseException as e:  # raised again in the consumer
            error.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if error:
                    raise error[0]
                return
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for t in batch.values():
                    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                        t.record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
