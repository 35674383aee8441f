"""The yardstick without the program: the reference's frames equal the C++
oracle's bytes (``oracle/oracle.cpp``, built here with the C++ compiler)
on small seeded inputs of each configuration's shape."""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, generator, registry
from portbench.reference import codec, frame

ORACLE = Path(__file__).resolve().parents[2] / "oracle" / "oracle.cpp"


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler"
    exe = tmp_path_factory.mktemp("oracle") / "dcomp_oracle"
    subprocess.run([cxx, "-std=c++20", "-O2", "-o", str(exe), str(ORACLE)], check=True)
    return exe


def raw_container(streams, ids, cads) -> bytes:
    """docs/FORMAT.md §6."""
    out = [b"DCR1", struct.pack("<I", len(streams))]
    out += [struct.pack("<QIIQ", i, c, 0, s.size) for s, i, c in zip(streams, ids, cads)]
    out += [np.asarray(s, "<i4").tobytes() for s in streams]
    return b"".join(out)


def oracle_frame(exe, tmp_path, streams, ids, cads, block_len, coder) -> bytes:
    src, dst = tmp_path / "in.dcr", tmp_path / "out.dcf"
    src.write_bytes(raw_container(streams, ids, cads))
    subprocess.run([str(exe), "encode", str(src), str(dst), "--block-len", str(block_len),
                    "--coder", coder], check=True, capture_output=True)
    return dst.read_bytes()


def reference_frame(streams, ids, cads, cfg) -> bytes:
    s = check.settings(cfg)
    lens = np.array([a.size for a in streams], np.int64)
    blocks = codec.encode(torch.from_numpy(np.concatenate(streams)), lens, s)
    return frame.frame_bytes(blocks, s.block_len, ids, cads, lens, s.lpc_tables)


def generated(cfg, count, samples, seed):
    x = generator.load_profiles(cfg["signal"], count, samples, cfg["cadence_s"], seed, "cpu")
    streams = [r.numpy() for r in x]
    # ragged tails: every stream ends in a short block of its own length
    streams = [s[: s.size - (7 * i) % s.size] for i, s in enumerate(streams)]
    return streams, list(range(100, 100 + count)), [cfg["cadence_s"]] * count


def adversarial(block_len, seed):
    """Escapes, wrapping and sparse spikes: every code path of the coders."""
    rng = np.random.default_rng(seed)
    streams = []
    for i in range(12):
        n = int(rng.integers(1, 3 * block_len))
        s = np.cumsum(rng.integers(-3, 4, n)) + int(rng.integers(-2**31, 2**31 - 1))
        hit = rng.random(n) < (0.0, 0.01, 0.05, 0.3)[i % 4]
        s[hit] = rng.integers(-2**31, 2**31 - 1, hit.sum())
        streams.append(((s + 2**31) % 2**32 - 2**31).astype(np.int32))
    return streams, list(range(12)), [60] * 12


@pytest.mark.parametrize("config, count, samples, coder", [
    ("headend-15min", 300, 96, "adaptive"),
    ("headend-15min", 40, 700, "adaptive"),
    ("dataport-1min", 2, 12000, "adaptive"),
    ("headend-15min", 60, 400, "rice"),
    ("dataport-1min", 2, 9000, "vertical"),
])
def test_reference_frames_equal_the_oracles(oracle, tmp_path, config, count, samples, coder):
    cfg = dict(registry.config(config), coder=coder)
    streams, ids, cads = generated(cfg, count, samples, seed=count + samples)
    want = oracle_frame(oracle, tmp_path, streams, ids, cads, cfg["block_len"], coder)
    assert reference_frame(streams, ids, cads, cfg) == want


@pytest.mark.parametrize("block_len, coder", [
    (128, "adaptive"), (4096, "adaptive"), (128, "vertical"), (4096, "rice")])
def test_reference_frames_equal_the_oracles_on_hard_data(oracle, tmp_path, block_len, coder):
    cfg = dict(registry.config("headend-15min"), block_len=block_len, coder=coder)
    streams, ids, cads = adversarial(block_len, seed=block_len)
    want = oracle_frame(oracle, tmp_path, streams, ids, cads, block_len, coder)
    assert reference_frame(streams, ids, cads, cfg) == want


def test_both_coders_appear_in_the_adaptive_case(oracle):
    cfg = registry.config("headend-15min")
    streams, _, _ = adversarial(128, seed=128)
    lens = np.array([a.size for a in streams])
    blocks = codec.encode(torch.from_numpy(np.concatenate(streams)), lens, check.settings(cfg))
    assert set(np.unique(blocks.coder)) == {0, 1}
    assert blocks.k.max() > 0


def test_frames_of_a_batch_split_as_frames_alone():
    cfg = registry.config("dataport-1min")
    s = check.settings(cfg)
    streams, ids, cads = generated(cfg, 3, 9000, seed=4)
    lens = np.array([a.size for a in streams])
    blocks = codec.encode(torch.from_numpy(np.concatenate(streams)), lens, s)
    nb = [-(-int(n) // s.block_len) for n in lens]
    parts = codec.split_frames(blocks, np.cumsum([0] + nb[:-1]), nb)
    for p, st, i in zip(parts, streams, ids):
        alone = reference_frame([st], [i], [60], cfg)
        assert frame.frame_bytes(p, s.block_len, [i], [60], [st.size], s.lpc_tables) == alone
