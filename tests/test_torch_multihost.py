"""The port's compress_multihost (dctpu_torch.dist.multihost) in local
processes over gloo on the CPU, mirroring tests/test_multihost.py: process
0's frame is byte-identical to the JAX reference's compress frame of the
same streams, and for coder="adaptive" to the reference's
compress_multihost frame, which is its all-RICE frame.

The workers are ``chip_smoke.py --multihost-worker`` processes on the CPU;
they import neither jax nor dctpu, and each has a time limit well under a
minute.
"""

import dataclasses
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import run_multihost
from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.dist import multihost as ref_multihost
from dctpu.format import write_frame as ref_write_frame
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig, from_reference
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.dist import multihost
from dctpu_torch.format import read_frame, write_frame

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 50  # seconds, each process


def _corpus(n_streams):
    return {"num_streams": n_streams, "samples_per_stream": 2000, "seed": 77,
            "mixed_cadence": True, "cumulative_frac": 0.4}


def _run(tmp_path, nproc, n_streams, coder, gather):
    spec = {"corpus": _corpus(n_streams), "block_len": 256, "coder": coder,
            "gather": gather, "device": "cpu", "out": str(tmp_path / "mh.dcf"),
            "parts_dir": str(tmp_path / "parts") if gather == "files" else None}
    lines, _ = run_multihost(spec, nproc, timeout=WORKER_TIMEOUT)
    return (tmp_path / "mh.dcf").read_bytes(), lines


def _reference_rice(n_streams):
    streams, ids, cads = synth_corpus(**_corpus(n_streams))
    frame = ref_api.compress(streams, RefConfig(block_len=256), stream_ids=ids,
                             cadences=cads)
    return streams, ref_write_frame(frame)


@pytest.mark.parametrize("coder", ["rice", "adaptive"])
def test_two_process_allgather(tmp_path, coder):
    data, lines = _run(tmp_path, 2, 6, coder, "allgather")
    streams, want = _reference_rice(6)
    assert data == want
    assert [line["local_blocks"] for line in lines] == [24, 24]
    assert {line["global_blocks"] for line in lines} == {48}
    if coder == "adaptive":
        # the reference's multi-process frame for an adaptive config, in
        # one process over the 8 fake devices: its all-RICE frame
        s, i, c = synth_corpus(**_corpus(6))
        ref, _ = ref_multihost.compress_multihost(
            s, RefConfig(block_len=256, coder="adaptive"), i, c)
        assert ref_write_frame(ref) == data
    out = api.decompress(read_frame(data), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))


def test_four_process_files_gather(tmp_path):
    data, lines = _run(tmp_path, 4, 8, "rice", "files")
    streams, want = _reference_rice(8)
    assert data == want
    # one ordered part per process; together they are the payload section
    parts = sorted((tmp_path / "parts").glob("payload-*.u32"))
    assert len(parts) == 4
    frame = read_frame(data)
    assert sum(f.stat().st_size for f in parts) == frame.payload_words.nbytes
    assert {line["compressed_words"] for line in lines} == {frame.payload_words.size}
    out = api.decompress(frame, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))


def test_worker_failure_is_reported(tmp_path):
    """A worker that fails (here: an unknown gather name) fails the run."""
    with pytest.raises(RuntimeError, match="unknown gather mode"):
        _run(tmp_path, 2, 4, "rice", "bogus")


def test_one_process_group(tmp_path, monkeypatch):
    """In this process: a one-process gloo group gives compress's frame
    (vertical keeps its coder), uneven stream lengths included; a second
    initialize does nothing; without a device and without CUDA it raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        multihost.initialize(f"127.0.0.1:{port}", 1, 0)
        streams, ids, cads = synth_corpus(3, 1700, seed=5, cumulative_frac=0.5)
        streams.append(np.zeros(0, np.int32))
        ids, cads = ids + [99], cads + [60]
        for coder in ("vertical", "rice"):
            ref_cfg = RefConfig(block_len=256, coder=coder)
            cfg = from_reference(dataclasses.asdict(ref_cfg))
            frame, stats = multihost.compress_multihost(
                streams, cfg, ids, cads, device="cpu")
            want = ref_write_frame(ref_api.compress(streams, ref_cfg, ids, cads))
            assert write_frame(frame) == want
            assert stats["local_blocks"] == stats["global_blocks"] == 21
        with pytest.raises(ValueError, match="unknown gather mode"):
            multihost.compress_multihost(streams, cfg, gather="bogus", device="cpu")
        with pytest.raises(ValueError, match="parts_dir"):
            multihost.compress_multihost(streams, cfg, gather="files", device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.compress_multihost(streams, CodecConfig(block_len=256))
    finally:
        dist.destroy_process_group()


def test_workers_import_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke, dctpu_torch.dist.multihost\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dctpu' or m.startswith('dctpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    assert res.returncode == 0, res.stderr
