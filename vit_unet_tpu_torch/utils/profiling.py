"""Profiling and tracing: the counterpart of
``vit_unet_tpu/utils/profiling.py``, on ``torch.profiler`` and
``torch.cuda``'s memory statistics.

* ``trace(logdir)``: a ``torch.profiler`` trace of the enclosed block (host
  and, on the card, CUDA activity), written as a Chrome trace into
  ``logdir``.
* ``annotate(name)``: a labelled range in that trace
  (``torch.profiler.record_function``), as a decorator or a context.
* ``device_memory_report()``: the card's allocator statistics, the
  ``memory_summary`` stand-in.
* ``StageTimer``: wall-clock stage accounting for host-side loops.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; the trace lands in
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing).  The
    profiler is yielded, so its ``key_averages()`` can be read after the
    block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Label a model stage in the profile: usable as a decorator or a
    context manager (``with annotate('encoder_l0'): ...``)."""
    return torch.profiler.record_function(name)


def device_memory_report(device=None) -> dict:
    """One CUDA device's allocator statistics (default: the current one):
    {'device', 'bytes_in_use', 'peak_bytes_in_use', 'bytes_reserved',
    'num_buffers', 'by_dtype'}.  ``by_dtype`` stays empty: the caching
    allocator does not record dtypes.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_report reads a CUDA device's "
                           "allocator; no CUDA device is available")
    device = torch.device("cuda" if device is None else device)
    stats = torch.cuda.memory_stats(device)
    return {
        "device": f"{device} ({torch.cuda.get_device_name(device)})",
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        "num_buffers": stats.get("allocation.all.current", 0),
        "by_dtype": {},
    }


class StageTimer:
    """Wall-clock stage accounting for host-side loops.

    >>> t = StageTimer()
    >>> with t.stage("compile"): ...
    >>> with t.stage("step"): ...
    >>> t.summary()   # {'compile': {'total_s': ..., 'count': ..., 'mean_s': ...}}

    The clock is the host's: to time work on the card, end the stage with
    ``torch.cuda.synchronize()``.
    """

    def __init__(self):
        self._acc: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(sum(v), 4),
                "count": len(v),
                "mean_s": round(sum(v) / len(v), 4),
            }
            for name, v in self._acc.items()
        }

    def report(self) -> str:
        lines = [f"{name}: n={s['count']} total={s['total_s']}s "
                 f"mean={s['mean_s']}s"
                 for name, s in self.summary().items()]
        return "\n".join(lines)
