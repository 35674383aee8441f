"""The frozen work counts and the profiler-name table."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, registry, work
from portbench.reference import codec

CSRC = Path(__file__).resolve().parents[2] / "dctpu_torch" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def kernels_in_csrc():
    return sorted({m for p in CSRC.glob("*.cu") for m in GLOBAL.findall(p.read_text())})


def test_csrc_has_kernels():
    assert len(kernels_in_csrc()) >= 10


@pytest.mark.parametrize("name", kernels_in_csrc())
def test_every_global_has_an_entry(name):
    assert name in work.BASES


@pytest.mark.parametrize("name, want", [
    ("void dct::select_lengths_kernel<(dct::Src)1, true>(int const*, int const*, int)", "K1"),
    ("void dct::select_lengths_kernel<(dct::Src)2, true>(int const*)", "K2-lpc"),
    ("void dct::select_lengths_kernel<dct::Src::kLpc, false>(int const*)", "K6-lpc"),
    ("void dct::rice_pack_kernel<(dct::PackSrc)1, true>(dct::PackIn, int*)", "K5a"),
    ("void dct::rice_pack_kernel<(dct::PackSrc)1, false>(dct::PackIn, int*)", "K5a"),
    ("void dct::vemit_rows_kernel<true>(int const*)", "K3"),
    ("void dct::vdec_words_kernel<false>(unsigned int const*)", "K4"),
    ("dct::recon_kernel(int const*, int const*)", "R"),
    ("void dct::compact_range_kernel(dct::Groups, int const*)", "CP"),
    ("void dct::count_range_kernel(int const*, long const*, int)", "CP-count"),
])
def test_profiler_names_map_to_work_keys(name, want):
    assert work.classify(name)[0] == want


def test_torch_kernels_are_not_the_ports():
    assert work.classify("void at::native::vectorized_elementwise_kernel<4>(int)") is None
    assert work.classify("Memcpy HtoD (Pageable -> Device)") is None
    assert work.classify("void dct::select_lengths_kernel<(dct::Src)7, true>()") == ("?", None)


def test_bound_is_the_larger_of_bytes_and_ops():
    assert work.bound(3.35e9, 0) == (1.0, "bytes")
    assert work.bound(0, 67e9 * 2) == (2.0, "operations")


def test_groups_of_a_reference_frame():
    cfg = registry.config("headend-15min")
    rng = np.random.default_rng(3)
    flat = np.cumsum(rng.integers(-3, 4, 96 * 40))
    hit = rng.random(flat.size) < np.repeat(np.resize([0.0, 0.01, 0.05, 0.3], 40), 96)
    flat[hit] = rng.integers(-2**31, 2**31 - 1, hit.sum())  # spikes: both coders
    flat = flat.astype(np.int32)
    lens = np.full(40, 96)
    blocks = codec.encode(torch.from_numpy(flat), lens, check.settings(cfg))
    g = work.frame_groups(blocks, cfg)
    assert g["all"]["B"] == 40 == g["rice"]["B"] + g["vertical"]["B"]
    assert g["all"]["rows_words"]["CP"] == blocks.words.size
    assert g["vertical"]["b"].shape == (g["vertical"]["B"], 1)
    assert g["rice"]["B"] > 0 and g["vertical"]["B"] > 0
    for key, group in (("K1", "all"), ("K2-lpc", "all"), ("K5a", "rice"), ("K3", "vertical"),
                       ("K5b", "rice"), ("K4", "vertical"), ("R", "all"), ("CP", "all"),
                       ("CP-count", "all")):
        ms = work.launch_bound_ms(key, g[group], cfg["block_len"])
        assert ms >= 0 and (ms > 0) == (g[group]["B"] > 0)


def test_emission_and_decode_are_charged_the_live_words():
    """K3 and K5a write, K4 and K5b read, each coder group's words in the
    frame, and the samples counted are the valid ones: a block half full
    needs half the sample bytes."""
    cfg = registry.config("headend-15min")
    rng = np.random.default_rng(4)
    flat = np.cumsum(rng.integers(-3, 4, 96 * 20)).astype(np.int32)
    blocks = codec.encode(torch.from_numpy(flat), np.full(20, 96), check.settings(cfg))
    g = work.frame_groups(blocks, cfg)
    for group in ("rice", "vertical"):
        sel = blocks.coder == (group == "vertical")
        words = int(np.diff(blocks.word_off)[sel].sum())
        assert {k: g[group]["rows_words"][k] for k in ("K3", "K5a", "K4", "K5b", "CP")} == dict.fromkeys(
            ("K3", "K5a", "K4", "K5b", "CP"), words)
    rw = {"K3": 0, "K5a": 0, "K4": 0, "K5b": 0, "CP": 0, "cands": 0, "tables": 0}
    preds = {k: np.zeros(10, np.int64) for k in ("K3", "K5a", "R")}
    full = work.work("K2", 10, 128, np.full(10, 128), np.zeros((10, 1)), rw, preds)[0]
    half = work.work("K2", 10, 128, np.full(10, 64), np.zeros((10, 1)), rw, preds)[0]
    assert full - half == 4 * 10 * 64
