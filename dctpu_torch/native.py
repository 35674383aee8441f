"""The native host library. The host feed: the counterpart of
``dctpu/native.py``'s ``build_blocks``, the C++ core of the flat host feed
(``codec/api.build_blocks``, ``build_blocks_flat``): one walk over the
stream list (:func:`stream_addresses`) and the block build from each
stream's own buffer (:func:`build_streams`). Frame I/O
(``format/frame.py``): the frame's one output buffer (:func:`new_bytes`),
its rows written from their columns (:func:`dir_rows`,
:func:`block_rows`) and read back into columns (:func:`dir_columns`,
:func:`block_columns`), copies (:func:`copy_bytes`) and section CRCs
(:func:`crc32`), each cut over :func:`frame_threads` threads. The decode's
copies of streams out of one flat array into arrays of their own
(:func:`scatter`, ``codec/api.py``), cut over the caller's thread count.

``csrc/host/host_feed.cpp`` and ``frame_io.cpp`` are built at first use
into one library with ``g++`` (C++17,
std::thread; ``CXX`` names another compiler) against Python's and numpy's
headers into ``build/dctpu_torch/host-<hash>/`` at the repository root,
keyed by a hash of the source, the flags (the two include directories
among them), numpy's version and the compiler's version, and bound with
ctypes: the walk and the frame's allocation through a ``ctypes.PyDLL``
handle, which holds the GIL, the rest through a ``ctypes.CDLL`` handle,
which releases it. Each build
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

SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / "host" / name
                for name in ("host_feed.cpp", "frame_io.cpp"))
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
    sources and ``cxx``'s version. A library built against another numpy or
    another Python, or by another compiler (another machine), is not
    reused."""
    h = hashlib.sha256(" ".join(build_flags()).encode())
    h.update(np.__version__.encode())
    for src in SOURCES:
        h.update(src.read_bytes())
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
            [cxx, *build_flags(), "-o", str(tmp / LIB_NAME), *map(str, SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed to build the host feed and frame I/O:\n{res.stdout}")
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
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.dctpu_torch_crc32.argtypes = [vp, i64, c_int]
    lib.dctpu_torch_crc32.restype = ctypes.c_uint32
    lib.dctpu_torch_copy.argtypes = [vp, vp, i64, c_int]
    lib.dctpu_torch_copy.restype = None
    lib.dctpu_torch_scatter.argtypes = [vp, i64, _i64p, _i64p, _i64p, c_int]
    lib.dctpu_torch_scatter.restype = None
    lib.dctpu_torch_dir_rows.argtypes = [vp, i64, *[vp] * 5, c_int]
    lib.dctpu_torch_dir_rows.restype = None
    lib.dctpu_torch_block_rows.argtypes = [vp, i64, *[vp] * 7, c_int]
    lib.dctpu_torch_block_rows.restype = None
    lib.dctpu_torch_dir_columns.argtypes = [vp, i64, *[vp] * 5, c_int]
    lib.dctpu_torch_dir_columns.restype = None
    lib.dctpu_torch_block_columns.argtypes = [vp, i64, *[vp] * 7, c_int]
    lib.dctpu_torch_block_columns.restype = None
    return lib


@functools.cache
def _walker() -> ctypes.PyDLL:
    """The host library again, its stream walk and the frame's allocation
    bound with the GIL held."""
    lib = ctypes.PyDLL(str(library_path()))
    lib.dctpu_torch_stream_addresses.argtypes = [
        ctypes.py_object, ctypes.py_object, _i64p, _i64p]
    lib.dctpu_torch_stream_addresses.restype = ctypes.c_int64
    lib.dctpu_torch_new_bytes.argtypes = [ctypes.c_int64, _i64p]
    lib.dctpu_torch_new_bytes.restype = ctypes.py_object
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


# Bytes of a frame section a thread is worth starting for (4 MiB, as the
# feed's kSamplesPerThread is 4 MiB of x): tests' and single files' frames
# take one thread and no thread start-up.
FRAME_BYTES_PER_THREAD = 4 << 20


def frame_threads(nbytes: int) -> int:
    """Threads for frame I/O on a section of ``nbytes`` bytes: one per
    FRAME_BYTES_PER_THREAD, at least one, at most :func:`host_threads`."""
    return max(1, min(host_threads(), nbytes // FRAME_BYTES_PER_THREAD))


def _u8(buf) -> np.ndarray:
    """The bytes of ``buf`` (bytes, bytearray, memoryview, C-contiguous
    ndarray) as a uint8 array over the same memory."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError("frame I/O takes C-contiguous arrays")
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


def crc32(buf, threads: int) -> int:
    """zlib.crc32 of the bytes of ``buf``, its pieces on up to ``threads``
    threads and combined in order, without the GIL."""
    a = _u8(buf)
    return library().dctpu_torch_crc32(a.ctypes.data, a.size, threads)


def copy_bytes(dst: np.ndarray, src) -> None:
    """dst[:] = the bytes of ``src`` (same size, both contiguous), on
    :func:`frame_threads` threads without the GIL."""
    d, s = _u8(dst), _u8(src)
    if d.size != s.size:
        raise ValueError(f"copy of {s.size} bytes into {d.size}")
    library().dctpu_torch_copy(d.ctypes.data, s.ctypes.data, s.size,
                               frame_threads(s.size))


def scatter(src: np.ndarray, starts: np.ndarray, out: tuple, threads: int) -> None:
    """out[s][:] = src[starts[s] : starts[s] + out[s].size] for every s:
    ``src`` a C-contiguous int32 array, ``out`` a tuple of C-contiguous,
    aligned, writable int32 ndarrays, in one native call on up to
    ``threads`` threads without the GIL (the streams' bytes end to end, cut
    into equal pieces). ValueError for any other array, or a stream that
    runs outside ``src``."""
    if not (isinstance(src, np.ndarray) and src.dtype == np.int32
            and src.flags.c_contiguous):
        raise ValueError("scatter takes a C-contiguous int32 source")
    if type(out) is not tuple:
        raise TypeError(f"a tuple of arrays, not {type(out).__name__}")
    lens, addr, marked = stream_addresses(out)
    if marked.size or not all(a.flags.writeable for a in out):
        raise ValueError("scatter writes into C-contiguous, writable int32 arrays")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if starts.shape != lens.shape:
        raise ValueError(f"{starts.size} starts for {lens.size} arrays")
    if lens.size and ((starts < 0).any() or (starts + lens > src.size).any()):
        raise ValueError(f"a stream outside the source's {src.size} samples")
    library().dctpu_torch_scatter(src.ctypes.data, lens.size, addr, 4 * starts,
                                  4 * lens, threads)


def new_bytes(n: int) -> Tuple[bytes, np.ndarray]:
    """A new ``bytes`` of ``n`` > 0 bytes, its contents unset, and a
    writable uint8 array over them. The caller fills every byte through
    the array before the bytes object is used, and lets the array go."""
    if n <= 0:  # size 0 is Python's one shared empty bytes
        raise ValueError(f"a frame buffer of {n} bytes")
    addr = np.empty(1, np.int64)
    out = _walker().dctpu_torch_new_bytes(n, addr)
    view = np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(int(addr[0])))
    return out, view


def _col(a, rows: int, dtype, *shape) -> np.ndarray:
    """A column as the frame's rows take it: broadcast to its rows and cast
    as a structured array's field assignment casts (ValueError where its
    shape does not fit), contiguous."""
    return np.ascontiguousarray(np.broadcast_to(a, (rows, *shape)), dtype=dtype)


def dir_rows(out: np.ndarray, stream_id, cadence_s, num_blocks, num_samples,
             first_block) -> None:
    """The stream directory's 32-byte rows (FORMAT §5) into ``out`` (uint8,
    32 bytes a row), straight from its five columns; reserved fields
    zero."""
    rows = out.size // 32
    cols = [_col(c, rows, t) for c, t in (
        (stream_id, np.uint64), (cadence_s, np.uint32), (num_blocks, np.uint32),
        (num_samples, np.uint64), (first_block, np.uint32))]
    library().dctpu_torch_dir_rows(out.ctypes.data, rows, *(c.ctypes.data for c in cols),
                                   frame_threads(out.size))


def block_rows(out: np.ndarray, predictor, k, n, bit_len, table_idx, coder,
               history) -> None:
    """The block table's 32-byte rows (FORMAT §5) into ``out`` (uint8, 32
    bytes a row), straight from its seven columns (``coder`` None: all 0);
    reserved fields zero."""
    rows = out.size // 32
    cols = [_col(c, rows, t) for c, t in (
        (predictor, np.uint8), (k, np.uint8), (n, np.uint16), (bit_len, np.uint32),
        (table_idx, np.uint8))]
    coder = None if coder is None else _col(coder, rows, np.uint8)
    history = _col(history, rows, np.int32, 4)
    library().dctpu_torch_block_rows(
        out.ctypes.data, rows, *(c.ctypes.data for c in cols),
        None if coder is None else coder.ctypes.data, history.ctypes.data,
        frame_threads(out.size))


def dir_columns(rows_b: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(stream_id, cadence_s, num_blocks, num_samples, first_block): the
    stream directory's columns, each a new array, from its 32-byte rows
    (uint8)."""
    rows = rows_b.size // 32
    cols = tuple(np.empty(rows, t) for t in (np.uint64, np.uint32, np.uint32,
                                             np.uint64, np.uint32))
    library().dctpu_torch_dir_columns(rows_b.ctypes.data, rows,
                                      *(c.ctypes.data for c in cols),
                                      frame_threads(rows_b.size))
    return cols


def block_columns(rows_b: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(predictor, k, n, bit_len, table_idx, coder, history [B, 4]): the
    block table's columns, each a new array, from its 32-byte rows
    (uint8)."""
    rows = rows_b.size // 32
    cols = tuple(np.empty(rows, t) for t in (np.uint8, np.uint8, np.uint16,
                                             np.uint32, np.uint8, np.uint8))
    history = np.empty((rows, 4), np.int32)
    library().dctpu_torch_block_columns(rows_b.ctypes.data, rows,
                                        *(c.ctypes.data for c in cols),
                                        history.ctypes.data,
                                        frame_threads(rows_b.size))
    return (*cols, history)
