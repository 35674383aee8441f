"""The port's CLI (dctpu_torch.cli.main) on the CPU, mirroring tests/test_cli.py.

Encode DCR1 -> DCF1 and back for each coder, verify, bare int32 input, a
predictor subset and --fit-tables, all with ``--device cpu``; the port's
frames are byte-identical to the reference CLI's and the reference CLI
decodes them.
"""

import numpy as np
import pytest

from dctpu.cli.main import main as ref_main
from dctpu.config import DEFAULT_LPC_TABLES
from dctpu_torch.cli.main import main as cli_main
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.format import read_frame, read_raw, write_raw

CPU = ["--device", "cpu"]


@pytest.fixture()
def corpus_file(tmp_path):
    streams, ids, cads = synth_corpus(3, 900, seed=21, mixed_cadence=True)
    p = tmp_path / "in.dcr"
    p.write_bytes(write_raw(streams, ids, cads))
    return p, streams, ids, cads


def _same(streams, path):
    back, _, _ = read_raw(path.read_bytes())
    return len(back) == len(streams) and all(
        np.array_equal(a, b) for a, b in zip(streams, back)
    )


@pytest.mark.parametrize("coder", ["rice", "vertical", "adaptive"])
def test_cli_encode_decode_roundtrip(tmp_path, corpus_file, coder):
    p, streams, ids, cads = corpus_file
    out_f, back_f = tmp_path / "out.dcf", tmp_path / "back.dcr"
    assert cli_main(["encode", str(p), str(out_f), "--block-len", "512",
                     "--coder", coder, *CPU]) == 0
    assert cli_main(["decode", str(out_f), str(back_f), *CPU]) == 0
    rs, rids, rcads = read_raw(back_f.read_bytes())
    assert rids == list(ids) and rcads == list(cads)
    assert _same(streams, back_f)
    assert out_f.stat().st_size < sum(s.nbytes for s in streams)


@pytest.mark.parametrize("coder", ["rice", "adaptive"])
def test_reference_cli_reads_port_cli_frames(tmp_path, corpus_file, coder):
    p, streams, _, _ = corpus_file
    port_f, ref_f = tmp_path / "port.dcf", tmp_path / "ref.dcf"
    assert cli_main(["encode", str(p), str(port_f), "--block-len", "512",
                     "--coder", coder, *CPU]) == 0
    ref_main(["encode", str(p), str(ref_f), "--block-len", "512",
              "--coder", coder])
    assert port_f.read_bytes() == ref_f.read_bytes()
    back_f = tmp_path / "back.dcr"
    ref_main(["decode", str(port_f), str(back_f)])
    assert _same(streams, back_f)


def test_cli_verify_ok(corpus_file):
    p, *_ = corpus_file
    assert cli_main(["verify", str(p), "--block-len", "512", *CPU]) == 0
    assert cli_main(["verify", str(p), "--block-len", "512", "--coder",
                     "rice", *CPU]) == 0


def test_cli_bare_int32_input(tmp_path):
    x = (np.arange(2000, dtype=np.int32) * 7 + 3).astype("<i4")
    p = tmp_path / "bare.bin"
    p.write_bytes(x.tobytes())
    out_f, back_f = tmp_path / "out.dcf", tmp_path / "back.dcr"
    assert cli_main(["encode", str(p), str(out_f), "--block-len", "512", *CPU]) == 0
    assert cli_main(["decode", str(out_f), str(back_f), *CPU]) == 0
    assert _same([x], back_f)


def test_cli_predictor_subset(tmp_path, corpus_file):
    p, streams, _, _ = corpus_file
    out_f, back_f = tmp_path / "out.dcf", tmp_path / "b.dcr"
    assert cli_main(["encode", str(p), str(out_f), "--block-len", "512",
                     "--predictors", "delta", "--coder", "rice", *CPU]) == 0
    assert set(read_frame(out_f.read_bytes()).blocks.predictor) == {0}
    assert cli_main(["decode", str(out_f), str(back_f), *CPU]) == 0
    assert _same(streams, back_f)


def test_cli_fit_tables_roundtrip(tmp_path):
    """--fit-tables: corpus-fit LPC tables go into the frame, the same
    tables as the reference CLI's, and the round trip stays bit-exact."""
    streams, ids, cads = synth_corpus(4, 2000, seed=9, mixed_cadence=True)
    src = tmp_path / "in.dcr"
    src.write_bytes(write_raw(streams, ids, cads))
    enc, dec, ref = tmp_path / "out.dcf", tmp_path / "back.dcr", tmp_path / "r.dcf"
    assert cli_main(["encode", str(src), str(enc), "--block-len", "256",
                     "--fit-tables", *CPU]) == 0
    assert cli_main(["decode", str(enc), str(dec), *CPU]) == 0
    assert _same(streams, dec)
    tables = read_frame(enc.read_bytes()).tables
    assert [(t.order, t.coeffs) for t in tables] != [
        (t.order, t.coeffs) for t in DEFAULT_LPC_TABLES
    ]
    ref_main(["encode", str(src), str(ref), "--block-len", "256", "--fit-tables"])
    assert enc.read_bytes() == ref.read_bytes()
