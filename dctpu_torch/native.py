"""The native host feed: the counterpart of ``dctpu/native.py``'s
``build_blocks``, the C++ core of the flat host feed
(``codec/api.build_blocks``, ``build_blocks_flat``): one walk over the
stream list (:func:`stream_addresses`) and the block build from each
stream's own buffer (:func:`build_streams`).

``csrc/host/host_feed.cpp`` is built at first use with ``g++`` (C++17,
std::thread; ``CXX`` names another compiler) against Python's and numpy's
headers into ``build/dctpu_torch/host-<hash>/`` at the repository root,
keyed by a hash of the source, the flags (the two include directories
among them), numpy's version and the compiler's version, and bound with
ctypes: the walk through a ``ctypes.PyDLL`` handle, which holds the GIL,
the build through a ``ctypes.CDLL`` handle, which releases it. Each build
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
import sysconfig
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


def build_flags() -> Tuple[str, ...]:
    """The compiler's flags: CXX_FLAGS and the include directories of this
    Python and this numpy (the walk reads ndarrays by numpy's headers)."""
    return (*CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
            f"-I{np.get_include()}")


def build_key(cxx: str) -> str:
    """The build directory's key: a hash of the flags, numpy's version, the
    source and ``cxx``'s version. A library built against another numpy or
    another Python, or by another compiler (another machine), is not
    reused."""
    h = hashlib.sha256(" ".join(build_flags()).encode())
    h.update(np.__version__.encode())
    h.update(SOURCE.read_bytes())
    try:
        h.update(subprocess.run([cxx, "--version"], capture_output=True).stdout)
    except OSError:
        pass  # no such compiler: the build raises
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Build the host library if its key changed; returns its path. Raises
    RuntimeError with the compiler's output on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out_dir = BUILD_ROOT / f"host-{build_key(cxx)}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="host-build-", dir=BUILD_ROOT))
    try:
        res = subprocess.run(
            [cxx, *build_flags(), "-o", str(tmp / LIB_NAME), str(SOURCE)],
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
    """The loaded host library (built on first call in this process), its
    block build bound without the GIL."""
    lib = ctypes.CDLL(str(library_path()))
    lib.dctpu_torch_build_blocks.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_uint32,
        _i32p, _i32p, _i32p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.dctpu_torch_build_blocks.restype = None
    return lib


@functools.cache
def _walker() -> ctypes.PyDLL:
    """The host library again, its stream walk bound with the GIL held."""
    lib = ctypes.PyDLL(str(library_path()))
    lib.dctpu_torch_stream_addresses.argtypes = [
        ctypes.py_object, ctypes.py_object, _i64p, _i64p]
    lib.dctpu_torch_stream_addresses.restype = ctypes.c_int64
    return lib


def stream_addresses(items: tuple) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lens [S], addr [S] int64, marked): one native walk over a tuple of
    streams. A stream that is exactly an ``np.ndarray``, C-contiguous,
    aligned and native-endian int32 (of any number of dimensions) is read
    in place: lens[s] is its size and addr[s] the address of its samples.
    Any other stream (a subclass, a strided view, another dtype or byte
    order, a list) is left for the caller to cast: its index is in
    ``marked`` and its lens and addr are -1 and 0. The addresses hold while
    the caller holds ``items``; no reference is taken."""
    if type(items) is not tuple:
        raise TypeError(f"a tuple of streams, not {type(items).__name__}")
    lens = np.empty(len(items), np.int64)
    addr = np.empty(len(items), np.int64)
    left = _walker().dctpu_torch_stream_addresses(items, np.ndarray, lens, addr)
    marked = np.flatnonzero(lens < 0) if left else np.empty(0, np.int64)
    return lens, addr, marked


def build_streams(
    addr: np.ndarray, lens: np.ndarray, first: np.ndarray,
    block_len: int, num_blocks: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x [B, L], n [B], hist [B, 4]) int32 of the streams whose lens[s]
    int32 samples lie at address addr[s], stream s's blocks from first[s]
    on, computed on up to :func:`host_threads` threads, one per run of
    streams of at least 2**20 samples of x, without the GIL. Every row of
    x is written whole (copy and tail fill), so x starts empty. The caller
    keeps the samples alive."""
    addr = np.ascontiguousarray(addr, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    first = np.ascontiguousarray(first, dtype=np.int64)
    x = np.empty((num_blocks, block_len), dtype=np.int32)
    n = np.empty(num_blocks, dtype=np.int32)
    hist = np.empty((num_blocks, 4), dtype=np.int32)
    if lens.size > 0 and num_blocks > 0:
        library().dctpu_torch_build_blocks(addr, lens, first, lens.size, block_len,
                                          x, n, hist, num_blocks, host_threads())
    return x, n, hist


def build_blocks(
    flat: np.ndarray, sstart: np.ndarray, first: np.ndarray,
    block_len: int, num_blocks: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x [B, L], n [B], hist [B, 4]) int32 of the streams whose samples are
    flat[sstart[s] : sstart[s + 1]], stream s's blocks from first[s] on:
    the reference's native build_blocks, by :func:`build_streams`."""
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    sstart = np.ascontiguousarray(sstart, dtype=np.int64)
    return build_streams(flat.ctypes.data + 4 * sstart[:-1], np.diff(sstart),
                         first, block_len, num_blocks)


def host_threads() -> int:
    """The CPUs this process may run on: the most threads the feed uses."""
    return len(os.sched_getaffinity(0))
