"""The native host feed: the counterpart of ``dctpu/native.py``'s
``build_blocks``, the C++ core of the flat host feed
(``codec/api.build_blocks_flat``).

``csrc/host/host_feed.cpp`` is built at first use with ``g++`` (C++17,
std::thread; ``CXX`` names another compiler) into
``build/dctpu_torch/host-<hash>/`` at the repository root, keyed by a hash
of the source, the flags and the compiler's version, and bound with
ctypes. Each build
goes into a directory of its own and is renamed into place, so that
processes that build at once do not see each other's half-written files.
A failed build raises with the compiler's output: there is no fallback.
The reference's other entry points (``vert_compact``, ``vert_stage``,
``segment_gather``, ``segment_scatter``, ``squeeze``) compact and stage
payloads on the host; the port does that work on the card (CP, and K4 and
K5b reading the words in place), so they have no counterpart.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "host_feed.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "dctpu_torch"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-pthread", "-shared")
LIB_NAME = "libdctpu_torch_host.so"

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Build the host library if its source or flags changed; returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    try:  # a library built by another compiler (another machine) is not reused
        h.update(subprocess.run([cxx, "--version"], capture_output=True).stdout)
    except OSError:
        pass  # no such compiler: the build below raises
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="host-build-", dir=BUILD_ROOT))
    try:
        res = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build the host feed:\n{res.stdout}")
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not lib.exists():  # not a build of another process that won
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call in this process)."""
    lib = ctypes.CDLL(str(library_path()))
    lib.dctpu_torch_build_blocks.argtypes = [
        _i32p, _i64p, _i64p, ctypes.c_int64, ctypes.c_uint32,
        _i32p, _i32p, _i32p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.dctpu_torch_build_blocks.restype = None
    return lib


def build_blocks(
    flat: np.ndarray, sstart: np.ndarray, first: np.ndarray,
    block_len: int, num_blocks: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x [B, L], n [B], hist [B, 4]) int32 of the streams whose samples are
    flat[sstart[s] : sstart[s + 1]], stream s's blocks from first[s] on:
    the reference's native build_blocks, which the library computes on up
    to :func:`host_threads` threads, one per run of streams of at least
    2**20 samples of x. Every row of x is written whole (copy and tail
    fill), so x starts empty."""
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    sstart = np.ascontiguousarray(sstart, dtype=np.int64)
    first = np.ascontiguousarray(first, dtype=np.int64)
    S = sstart.size - 1
    x = np.empty((num_blocks, block_len), dtype=np.int32)
    n = np.empty(num_blocks, dtype=np.int32)
    hist = np.empty((num_blocks, 4), dtype=np.int32)
    if S > 0 and num_blocks > 0:
        library().dctpu_torch_build_blocks(flat, sstart, first, S, block_len,
                                          x, n, hist, num_blocks, host_threads())
    return x, n, hist


def host_threads() -> int:
    """The CPUs this process may run on: the most threads the feed uses."""
    return len(os.sched_getaffinity(0))
