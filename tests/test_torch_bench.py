"""The port's bench (dctpu_torch.bench and the CLI's bench verb) on the CPU.

One small run (4 streams x 8192 samples, block_len 256, 2 repeats) is
shared by the module: its exit code, headline and results keys, and its
ratios, coder groups and frame hashes against the JAX reference's frames
of the same corpus (the reference on its portable CPU path). Smaller runs
check that failures are loud, that --device cuda never falls back to the
CPU, and the CLI verb.
"""

import argparse
import contextlib
import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.corpus import synth_corpus as ref_synth_corpus
from dctpu.format import write_frame as ref_write_frame
from dctpu_torch import bench
from dctpu_torch.cli import main as cli

REPO = Path(__file__).resolve().parents[1]
STREAMS, SAMPLES, L = 4, 8192, 256
SMALL = ["--device", "cpu", "--streams", str(STREAMS), "--samples", str(SAMPLES),
         "--block-len", str(L), "--repeats", "2"]
TINY = ["--device", "cpu", "--streams", "2", "--samples", "1024",
        "--block-len", "256", "--repeats", "1"]
# every coder's keys; the stages of its coder groups are added below
COMMON = [
    "enc_kernel_gbps", "enc_pipeline_gbps", "dec_kernel_gbps",
    "dec_pipeline_gbps", "ratio", "e2e_ratio", "e2e_encode_gbps",
    "e2e_decode_gbps", "e2e_encode_ms", "e2e_decode_ms", "select_ms",
    "compact_ms", "reconstruct_ms", "enc_upload_ms", "enc_download_ms",
    "dec_upload_ms", "dec_download_ms", "host_build_blocks_ms",
    "host_frame_assembly_ms", "host_write_frame_ms", "host_read_frame_ms",
    "host_block_table_ms", "host_split_streams_ms", "enc_device_ms",
    "dec_device_ms", "enc_host_ms", "dec_host_ms", "enc_peak_bytes_per_byte",
    "dec_peak_bytes_per_byte", "rice_blocks", "vertical_blocks",
    "frame_bytes", "frame_sha256", "bit_exact", "repeats",
]
GROUPS = {"rice": ("rice",), "vertical": ("vertical",),
          "adaptive": ("rice", "vertical")}


def run_bench(fn, argv):
    """fn(argv) with stdout and stderr captured: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def headline(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "results.json"
    root_results = REPO / "bench_results.json"
    before = root_results.read_bytes()
    rc, stdout, stderr = run_bench(bench.main, [*SMALL, "--out", str(path)])
    return {"rc": rc, "stdout": stdout, "stderr": stderr,
            "results": json.loads(path.read_text()),
            "root_untouched": root_results.read_bytes() == before}


@pytest.fixture(scope="module")
def ref_frames():
    streams, ids, cads = ref_synth_corpus(
        STREAMS, SAMPLES, seed=123, mixed_cadence=True, cumulative_frac=0.25)
    raw = sum(s.nbytes for s in streams)
    frames = {coder: ref_api.compress(streams, RefConfig(block_len=L, coder=coder),
                                      ids, cads)
              for coder in bench.CODERS}
    return raw, frames


def test_bench_exits_0_with_the_headline(run):
    assert run["rc"] == 0, run["stderr"]
    line = headline(run["stdout"])
    assert line["metric"] == "adaptive_encode_gbps_per_chip"
    assert line["unit"] == "GB/s"
    assert line["value"] > 0
    assert line["device"] == "cpu"
    assert "error" not in line and "vs_baseline" not in line
    assert line["value"] == run["results"]["adaptive"]["enc_pipeline_gbps"]


@pytest.mark.parametrize("coder", ["vertical", "rice", "adaptive"])
def test_bench_results_have_every_key(run, coder):
    res = run["results"][coder]
    stages = [f"{side}_{g}_ms" for g in GROUPS[coder] for side in ("emit", "dec")]
    missing = [k for k in COMMON + stages if k not in res]
    assert not missing
    assert res["bit_exact"] is True
    assert res["repeats"] == 2
    timed = [k for k in COMMON + stages if k.endswith(("_ms", "_gbps"))]
    for key in timed:
        assert res[key] > 0, key
        assert 0 <= res[f"{key}_spread"], key
    # peak device memory is not measured on the CPU
    assert res["enc_peak_bytes_per_byte"] is None
    assert res["dec_kernel_gbps"] == res["dec_pipeline_gbps"]
    top = run["results"]
    assert top["device"]["platform"] == "cpu"
    assert (top["streams"], top["samples_per_stream"], top["block_len"],
            top["repeats"]) == (STREAMS, SAMPLES, L, 2)
    assert top["raw_bytes"] == STREAMS * SAMPLES * 4
    assert top["blocks"] == STREAMS * -(-SAMPLES // L)
    assert "error" not in top


@pytest.mark.parametrize("coder", ["vertical", "rice", "adaptive"])
def test_bench_frames_equal_the_reference(run, ref_frames, coder):
    raw, frames = ref_frames
    ref, res = frames[coder], run["results"][coder]
    data = ref_write_frame(ref)
    assert res["ratio"] == raw / ref.payload_words.nbytes
    assert res["e2e_ratio"] == raw / len(data)
    assert res["frame_sha256"] == hashlib.sha256(data).hexdigest()
    counts = np.bincount(np.asarray(ref.blocks.coder), minlength=2)
    assert (res["rice_blocks"], res["vertical_blocks"]) == tuple(counts)
    if coder == "adaptive":
        assert counts.min() > 0  # both groups, so both emit and decode stages


def test_bench_leaves_the_root_results_untouched(run):
    assert run["root_untouched"]


def test_default_out_lies_under_build():
    assert bench.DEFAULT_OUT.is_relative_to(REPO / "build")
    p = argparse.ArgumentParser()
    bench.add_arguments(p)
    assert p.parse_args([]).out == bench.DEFAULT_OUT
    assert p.parse_args([]).device == "cuda"


def test_a_failing_compress_is_loud(monkeypatch, tmp_path):
    real = bench.compress

    def compress(streams, cfg, *args, **kwargs):
        if cfg.coder == "rice":
            raise RuntimeError("injected compress failure")
        return real(streams, cfg, *args, **kwargs)

    monkeypatch.setattr(bench, "compress", compress)
    out = tmp_path / "b.json"
    rc, stdout, stderr = run_bench(bench.main, [*TINY, "--out", str(out)])
    assert rc == 1
    line = headline(stdout)
    assert line["value"] == 0.0
    assert "injected compress failure" in line["error"]
    assert "Traceback" in stderr and "injected compress failure" in stderr
    assert "injected compress failure" in json.loads(out.read_text())["error"]


def test_a_wrong_decode_is_loud(monkeypatch, tmp_path):
    real = bench.decompress

    def decompress(*args, **kwargs):
        out = real(*args, **kwargs)
        out[-1] = out[-1].copy()
        out[-1][-1] ^= 1
        return out

    monkeypatch.setattr(bench, "decompress", decompress)
    rc, stdout, stderr = run_bench(
        bench.main, [*TINY, "--out", str(tmp_path / "b.json")])
    assert rc == 1
    line = headline(stdout)
    assert line["value"] == 0.0 and "not bit-exact" in line["error"]
    assert "Traceback" in stderr


def test_cuda_without_a_card_does_not_fall_back(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "compress", lambda *a, **k: calls.append(a))
    argv = [*TINY, "--device", "cuda", "--out", str(tmp_path / "b.json")]
    rc, stdout, _ = run_bench(bench.main, argv)
    assert rc == 1
    line = headline(stdout)
    assert line["value"] == 0.0 and "no CUDA device" in line["error"]
    assert "device" not in line  # not marked as a CPU run: none ran
    assert calls == []


def test_cli_bench_verb(tmp_path):
    out = tmp_path / "b.json"
    rc, stdout, _ = run_bench(cli.main, ["bench", *TINY, "--out", str(out)])
    assert rc == 0
    assert headline(stdout)["value"] > 0
    res = json.loads(out.read_text())
    assert all(res[c]["bit_exact"] for c in bench.CODERS)


@pytest.mark.parametrize("side, name, key", [
    ("enc", "upload", "enc_upload_ms"), ("dec", "download", "dec_download_ms"),
    ("enc", "emit_vertical", "emit_vertical_ms"),
    ("dec", "decode_rice", "dec_rice_ms"), ("dec", "reconstruct", "reconstruct_ms"),
    ("dec", "host_split_streams", "host_split_streams_ms"),
])
def test_stage_keys(side, name, key):
    assert bench.stage_key(side, name) == key


def test_spread_is_range_over_median():
    assert bench.spread([2.0, 1.0, 4.0]) == 1.5
    assert bench.spread([3.0]) == 0.0
