"""The port's native host feed (``dctpu_torch.native``, C++ on host threads)
against the reference's ``build_blocks_flat`` and the port's numpy twin
``build_blocks_flat_plain``: empty and one-sample streams, lengths that
the block length does not divide, 20 000 tiny streams. The library builds
from ``csrc/host/host_feed.cpp`` into the repository's build directory,
raises when it cannot, and the port never opens the reference's
``native/libdctpu_host.so``. Integer arrays: exact equality.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dctpu.codec import api as ref_api
from dctpu_torch import native
from dctpu_torch.codec import api

REPO = Path(__file__).resolve().parent.parent


def _feed(lens, seed):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    flat = rng.integers(-(2**31), 2**31, size=int(lens.sum()), dtype=np.int64)
    return flat.astype(np.int32), lens


def _equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


CASES = {
    "edges": [0, 1, 0, 127, 128, 129, 1, 300, 0, 255, 257, 1000],
    "all_empty": [0, 0, 0],
    "one_sample_each": [1] * 50,
    "tiny_20000": np.random.default_rng(5).integers(0, 40, size=20_000),
}


@pytest.mark.parametrize("case, L", [
    (case, L) for case in sorted(CASES) for L in (1, 128, 300)
] + [("edges", 4096), ("one_sample_each", 4096)])
def test_native_feed_equals_reference_and_plain(case, L):
    flat, lens = _feed(CASES[case], seed=len(CASES[case]) + L)
    got = api.build_blocks_flat(flat, lens, L)
    assert _equal(got, ref_api.build_blocks_flat(flat, lens, L))
    assert _equal(got, api.build_blocks_flat_plain(flat, lens, L))
    with pytest.raises(ValueError, match="samples for stream lengths"):
        api.build_blocks_flat(np.append(flat, 1), lens, L)


def test_native_build_blocks_matches_reference_signature():
    """native.build_blocks takes the reference's arguments (flat, sstart,
    first, block_len, num_blocks) and gives its (x, n, hist)."""
    flat, lens = _feed([5, 0, 9, 3], seed=1)
    sstart = np.concatenate([[0], np.cumsum(lens)])
    x, n, hist, nb, first = api.build_blocks_flat_plain(flat, lens, 4)
    got = native.build_blocks(flat, sstart, first, 4, int(nb.sum()))
    assert _equal(got, (x, n, hist))


@pytest.mark.parametrize("case, L", [
    (case, L) for case in sorted(CASES) for L in (1, 128)])
def test_native_core_reads_each_stream_where_it_lies(case, L):
    """native.build_streams fed each stream's own buffer (separate arrays,
    laid out in memory in another order than the streams) gives the flat
    entry's arrays and the plain twin's."""
    flat, lens = _feed(CASES[case], seed=len(CASES[case]) + L + 1)
    parts = np.split(flat, np.cumsum(lens)[:-1])
    order = np.random.default_rng(L).permutation(len(parts))
    owned = [None] * len(parts)
    for i in order:  # allocated out of stream order
        owned[i] = parts[i].copy()
    addr = np.array([a.ctypes.data for a in owned], np.int64)
    x, n, hist, nb, first = api.build_blocks_flat_plain(flat, lens, L)
    got = native.build_streams(addr, lens, first, L, int(nb.sum()))
    assert _equal(got, (x, n, hist))
    assert _equal(api.build_blocks_at(addr, lens, L),
                  api.build_blocks_flat(flat, lens, L))


def test_stream_walk_takes_a_tuple():
    """The walk reads a tuple only: build_blocks makes one of any other
    sequence."""
    with pytest.raises(TypeError, match="tuple of streams"):
        native.stream_addresses([np.zeros(3, np.int32)])
    lens, addr, marked = native.stream_addresses(())
    assert lens.size == addr.size == marked.size == 0


def test_build_key_follows_numpy_and_python(monkeypatch):
    """The walk is compiled against numpy's and Python's headers: another
    numpy version or include directory is another build."""
    key = native.build_key("g++")
    assert native.build_key("g++") == key
    monkeypatch.setattr(native.np, "__version__", "0.0.0")
    assert native.build_key("g++") != key
    monkeypatch.undo()
    monkeypatch.setattr(native.sysconfig, "get_paths",
                        lambda: {"include": "/elsewhere/include/python3"})
    assert native.build_key("g++") != key
    assert "-I/elsewhere/include/python3" in native.build_flags()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build the host feed"):
        native.library_path()
    assert list(tmp_path.iterdir()) == []  # nothing half built is left


def test_builds_at_once_agree(tmp_path):
    """Processes that build the library at once all load one finished
    copy: each build goes to its own directory and is renamed into place."""
    code = (
        "import sys; from pathlib import Path; from dctpu_torch import native\n"
        "native.BUILD_ROOT = Path(sys.argv[1])\n"
        "print(native.library_path())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(outs) == 1
    assert [d.name for d in tmp_path.iterdir()] == [Path(outs.pop()).parent.name]


def test_port_never_opens_the_reference_library():
    """A process that runs the port's flat feed maps the port's host
    library and not native/libdctpu_host.so."""
    code = (
        "import numpy as np\n"
        "from dctpu_torch.codec import api\n"
        "api.build_blocks([np.arange(n, dtype=np.int32) for n in range(300)], 128)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libdctpu_torch_host.so' in maps\n"
        "assert 'native/libdctpu_host.so' not in maps, 'reference library'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
