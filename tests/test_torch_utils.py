"""The port's utilities (dctpu_torch.utils: resume, metrics) vs the JAX
reference's dctpu.utils, mirroring tests/test_aux.py: the merged frame of
the port's EncodeJob is byte-identical to the reference EncodeJob's merge
of the same parts, and RunMetrics gives the reference's object.
"""

import json

import numpy as np
import pytest

from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.corpus import synth_corpus
from dctpu.utils.metrics import RunMetrics as RefRunMetrics
from dctpu.utils.resume import EncodeJob as RefEncodeJob
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.format import read_frame, write_frame
from dctpu_torch.utils import EncodeJob, RunMetrics, with_retry


def test_resume_job(tmp_path):
    streams, ids, cads = synth_corpus(6, 1500, seed=44)
    cfg = CodecConfig(block_len=256)
    job = EncodeJob(tmp_path / "job", cfg, device="cpu")
    job.encode_part("0", streams[:3], ids[:3], cads[:3])
    assert job.done("0")

    # a restart: the new job reads the manifest and skips part 0
    job2 = EncodeJob(tmp_path / "job", cfg, device="cpu")
    assert job2.done("0")
    job2.encode_part("1", streams[3:], ids[3:], cads[3:])
    out = job2.merge(tmp_path / "merged.dcf").read_bytes()

    # the reference's merge of the same parts, and its compress of the lot
    ref = RefEncodeJob(tmp_path / "job", RefConfig(block_len=256))
    assert out == ref.merge(tmp_path / "ref_merged.dcf").read_bytes()
    dec = api.decompress(read_frame(out), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(streams, dec))
    assert out == write_frame(api.compress(streams, cfg, ids, cads, device="cpu"))


def test_merge_rejects_mismatched_parts(tmp_path):
    streams, ids, cads = synth_corpus(2, 600, seed=3)
    job = EncodeJob(tmp_path / "job", CodecConfig(block_len=256), device="cpu")
    with pytest.raises(ValueError, match="no completed parts"):
        job.merge(tmp_path / "m.dcf")
    job.encode_part("0", streams[:1], ids[:1], cads[:1])
    job.cfg = CodecConfig(block_len=512)
    job.encode_part("1", streams[1:], ids[1:], cads[1:])
    with pytest.raises(ValueError, match="disagree"):
        job.merge(tmp_path / "m.dcf")


@pytest.mark.parametrize("coder", ["rice", "adaptive"])
def test_run_metrics_json(coder):
    streams, _, _ = synth_corpus(3, 1000, seed=2)
    frame = api.compress(streams, CodecConfig(block_len=256, coder=coder),
                         device="cpu")
    size = len(write_frame(frame))
    d = json.loads(RunMetrics.from_frame(frame, "encode", 0.5, size).to_json())
    ref = json.loads(RefRunMetrics.from_frame(frame, "encode", 0.5, size).to_json())
    d.pop("timestamp"), ref.pop("timestamp")
    assert d == ref
    assert d["mode"] == "encode" and d["ratio"] > 1
    assert sum(d["predictor_histogram"].values()) == frame.blocks.num_blocks
    listed = read_frame(write_frame(frame))
    listed.streams = list(listed.streams)
    assert RunMetrics.from_frame(listed, "encode", 0.5, size).raw_bytes == d["raw_bytes"]


def test_with_retry():
    calls, errors = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("transient")
        return "ok"

    assert with_retry(flaky, on_error=lambda i, e: errors.append(i)) == "ok"
    assert len(calls) == 2 and errors == [0]
    with pytest.raises(RuntimeError, match="always"):
        with_retry(lambda: (_ for _ in ()).throw(RuntimeError("always")), attempts=2)


def test_failing_shard_recovers(tmp_path, monkeypatch):
    """The first encode attempt of a part dies; the job's with_retry
    re-encodes it, and the merged frame is byte-identical to a clean run's
    and to the reference's compress."""
    real_compress = api.compress
    streams, ids, cads = synth_corpus(4, 1200, seed=45)
    cfg = CodecConfig(block_len=256)

    fails = {"left": 1}

    def dying_compress(*a, **kw):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("injected device failure")
        return real_compress(*a, **kw)

    monkeypatch.setattr(api, "compress", dying_compress)
    job = EncodeJob(tmp_path / "job", cfg, device="cpu")
    job.encode_part("0", streams[:2], ids[:2], cads[:2])  # survives via retry
    job.encode_part("1", streams[2:], ids[2:], cads[2:])
    out = job.merge(tmp_path / "merged.dcf")
    assert fails["left"] == 0  # the failure really happened

    monkeypatch.setattr(api, "compress", real_compress)
    clean = EncodeJob(tmp_path / "clean", cfg, device="cpu")
    clean.encode_part("0", streams[:2], ids[:2], cads[:2])
    clean.encode_part("1", streams[2:], ids[2:], cads[2:])
    ref = clean.merge(tmp_path / "clean.dcf")
    assert out.read_bytes() == ref.read_bytes()
    from dctpu.format import write_frame as ref_write_frame

    assert out.read_bytes() == ref_write_frame(ref_api.compress(streams, RefConfig(
        block_len=256), stream_ids=ids, cadences=cads))
