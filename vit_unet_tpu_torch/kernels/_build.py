"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``kernels/csrc/`` is compiled on first use for ``sm_90a``
into a shared library with a plain C interface, under ``build/torch_kernels/``
at the root of the checkout.  The library's file name carries a hash of its
source and of the headers it includes, so an edited source or header is
rebuilt, a stale library is never loaded, and work on one kernel's header
leaves the other libraries alone.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from the CUDA toolkit")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_closure(source: str) -> list[Path]:
    """``csrc/<source>`` and every file under ``csrc/`` it includes with
    ``#include "..."``, directly or through another header, in sorted order
    after the source itself."""
    seen: dict[Path, None] = {}
    todo = [CSRC / source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = None
        for name in _INCLUDE.findall(path.read_text()):
            for base in (path.parent, CSRC):
                if (base / name).is_file():
                    todo.append((base / name).resolve())
                    break
    first = CSRC / source
    return [first] + sorted(p for p in seen if p != first)


def library_path(source: str) -> Path:
    """The library's path; its hash covers the flags, the source and the
    headers under ``csrc/`` the source includes, so an edit of a header
    rebuilds only the libraries that use it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_closure(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(source: str, extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<source>`` unless its library already exists; returns
    the library's path.  ``extra_flags`` (e.g. ``-Xptxas=-v``) only apply
    to a build that happens."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    if proc.stderr.strip():
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
