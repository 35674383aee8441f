"""Build the port's CUDA kernels at first use and bind them with ctypes.

``dctpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc`` per source, all started together, and link into one shared
library with a plain C interface, under ``build/dctpu_torch/`` at the
repository root, keyed by a hash of the sources and flags: a changed source
rebuilds, an unchanged one loads the cached library. Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()``;
every wrapper calls one through :func:`launch`, which sets the tensor's
device and turns a non-zero code into an error.

Nothing here runs at import time: the CPU tests import every module on
machines that have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dctpu_torch"
SOURCES = (
    "select.cu", "vemit.cu", "vdec.cu", "pack.cu", "unpack.cu", "exc.cu",
    "transpose.cu", "recon.cu",
)
HEADERS = ("bitplane.cuh", "residual.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every int as c_int
SIGNATURES = {
    "dct_select_xbp": (_P, _P, _P, _P, _I, _I, _I, _P),
    "dct_select_bp": (_P, _P, _P, _I, _I, _I, _P),
    "dct_select_lpc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dct_vemit_rows": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P),
    "dct_vemit_rows_z": (_P, _P, _P, _P, _I, _I, _P),
    "dct_vdec_words": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "dct_rice_totals": (_P, _P, _P, _I, _I, _I, _P),
    "dct_rice_totals_xbp": (_P, _P, _P, _P, _I, _I, _I, _P),
    "dct_rice_totals_lpc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dct_rice_pack": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dct_rice_pack_rows": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P),
    "dct_rice_unpack_words": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dct_select_reduce": (_P, _P, _P, _I, _I, _I, _P),
    "dct_exc_extract": (_P, _P, _P, _P, _I, _P),
    "dct_bit_planes32": (_P, _P, _I, _P),
    "dct_reconstruct": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P),
    "dct_vertical_cost_xbp": (_P, _P, _P, _P, _I, _I, _P),
    "dct_vertical_cost_lpc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Build the library if its sources changed; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libdctpu_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out_dir / f"{Path(src).stem}.{os.getpid()}.o" for src in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    log = [f"== {src}\n{p.communicate()[0]}" for src, p in zip(SOURCES, procs)]
    ok = all(p.returncode == 0 for p in procs)
    tmp = out_dir / f"libdctpu_kernels.{os.getpid()}.so"
    if ok:
        res = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{res.stdout}")
        ok = res.returncode == 0
    (out_dir / "build.log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if not ok:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_tensors(name: str, *tensors) -> None:
    """Kernel arguments: contiguous int32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expects contiguous int32 tensors on one device, got "
                f"{t.dtype} on {t.device}"
            )


def block_args(name: str, words, start, *per_block):
    """The arguments of a kernel that reads blocks in place from a frame's
    words: start as contiguous int64 (a word offset may pass 2**31), each
    other per-block tensor as contiguous int32, all on words' device."""
    start = start.to(torch.int64).contiguous()
    rest = [t.to(torch.int32).contiguous() for t in per_block]
    if start.device != words.device:
        raise ValueError(f"{name}: start on {start.device}, words on {words.device}")
    check_tensors(name, words, *rest)
    return (start, *rest)


def stream_of(t) -> int:
    """The current CUDA stream of a tensor's device, as a pointer int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, t, *args) -> None:
    """Calls the library's entry point ``name`` with ``args`` and the
    current stream of t's device, and raises on a non-zero return.

    The call runs under t's device: a ctypes call launches on the CUDA
    runtime's current device, which for a tensor on another card (a shard
    of ``dctpu_torch.dist``) would not be the device of its stream."""
    with torch.cuda.device(t.device):
        err = getattr(library(), name)(*args, stream_of(t))
    check(err, name)
