"""Host orchestration: numpy streams <-> device codec <-> DCF1 frames.

The counterpart of ``dctpu/codec/api.py`` for all three coders:
``CodecConfig(coder="rice")`` (the default of ``CodecConfig()``),
``"vertical"`` and ``"adaptive"`` (the CLI default). Block planning and
frame assembly are host numpy; every per-sample stage runs on ``device``.
The samples cross to the device once, the compact payload words cross
back once; decode does the reverse.

Encode and decode both reduce to one range of contiguous blocks at a time
(:func:`encode_range`, :func:`decode_range`): the compact words of a range
are its blocks' words in block order (FORMAT §2.1), so ranges concatenate
into the frame. An int ``chunk_blocks`` bounds the blocks per pass, as the
reference's ``chunk_blocks`` does, and gives the same frame.
``chunk_blocks=None`` (the default) runs the whole batch as one range on
the CPU, and on a card ranges of as many blocks as fit a fixed share of
its memory (:func:`range_blocks`): up to 32,000 blocks of 4096 samples
(500 MiB) a range on an H100. ``dctpu_torch.dist`` splits each range once
more over a list of devices.

``stage_ms``: pass a dict to have each stage's time added to it in
milliseconds, measured with CUDA events on a CUDA device (the device
timeline between the stage's start and end) and with the host clock on
the CPU. The entries named ``host_*`` are the host numpy work around the
device stages, on the host clock on every device: ``host_build_blocks``
and ``host_frame_assembly`` of an encode, ``host_block_table`` (the
block table's check and word offsets) and ``host_split_streams`` of a
decode, ``host_flatten`` of :func:`decompress_flat`. While a
``torch.profiler`` session records, every stage, the steps inside the
host stages and each host read of device results are ranges of the
profiler's own (``dctpu_torch/trace.py``), whether or not ``stage_ms`` is
given.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dctpu_torch import native
from dctpu_torch.codec.decode import decode_z, reconstruct
from dctpu_torch.codec.encode import (
    adaptive_select,
    candidate_ids,
    emit_blocks,
    select_blocks,
)
from dctpu_torch.config import CodecConfig
from dctpu_torch.constants import CODER_RICE, CODER_VERTICAL, HISTORY_LEN, LPC
from dctpu_torch.format.frame import BlockHeaders, Frame, StreamDir, plan_blocks
from dctpu_torch.kernels.api import UNPACK_BACKENDS
from dctpu_torch.kernels.compact import (
    CODER_GROUPS,
    compact_range_flagged,
    host_words,
)
from dctpu_torch.kernels.rice_pack import padded_words
from dctpu_torch.kernels.vdec import raise_if_bad
from dctpu_torch.trace import Stages, span

DEFAULT_CHUNK_BLOCKS = 2048  # the reference's, and the sharded paths' default
# The default pass's bound on device memory (range_blocks): a range may take
# 1 / DEVICE_SHARE of the card's total memory, at DEVICE_BYTES_PER_SAMPLE
# bytes a sample. The most measured is the staged emission's compress,
# 26.2 bytes per input byte (vertical, backend="pallas"; the default paths
# 4.4-5.3, every decompress 2.3; chip_smoke.py on an H100, PERF.md §7):
# 105 bytes a sample, here with a margin of half again.
DEVICE_BYTES_PER_SAMPLE = 160
DEVICE_SHARE = 4
# decompress downloads the samples of streams shorter than this on average
# (samples) into one array and copies each stream out of it, so that a
# million streams make no million device copies; longer ones go straight
# into each stream's own array, touched ahead on _TOUCH_THREADS. The value
# was measured as the host feed's switch (chip_smoke.py, PERF.md §6) and is
# kept for the decode. Of the benchmark's cells, lcl.bulk (39,792 samples a
# stream) takes the short path and dataport.bulk (525,600) the long one;
# headend.daily decodes by decompress_flat, which has no switch
_FLAT_PATH_MAX_MEAN_LEN = 131072
# decompress makes the arrays of long streams on this many host threads,
# each touched one sample a 4 KiB page, ahead of the copies into them, so
# that a copy finds its pages mapped. On an H100 machine's host (8 cores),
# dataport.bulk's 240 fresh arrays of 2.1 MB took 450 ms to touch on one
# thread; a decompress took 183-247 ms (medians of two processes) with the
# arrays made and touched on 4 threads, 200-258 ms made on the calling
# thread and touched on 4, 320-449 ms touched on 2, 318-804 ms not touched
# (PERF.md §6). It also caps the threads of the short streams' copies out of
# the flat download (_split), which take the same first touches of fresh
# pages: one thread a native.FRAME_BYTES_PER_THREAD of samples
_TOUCH_THREADS = 4
_PAGE_SAMPLES = 1024
# the reference decoder's backend names (dctpu/codec/api.py
# _decode_blocks_array, dctpu/kernels/api.py unpack)
DECODE_BACKENDS = (None, *UNPACK_BACKENDS)
_CODERS = CODER_GROUPS  # in the order CP stacks their payload rows
_CODER_ID = {name: gid for gid, name in _CODERS}


# ------------------------------------------------------------ block building


def build_blocks(
    streams: Sequence[np.ndarray], block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack streams into [B, L] padded blocks + lengths + histories (numpy).

    One native walk over the streams (``native.stream_addresses``) finds
    each stream's length and, where the stream can be read in place, its
    samples; every stream the walk could not read in place is cast by
    ``np.asarray(s, np.int32).ravel()`` (span ``feed.cast``); then
    :func:`build_blocks_at` (the native host feed, C++ on host threads)
    builds the blocks from each stream's own buffer, for every batch."""
    return _feed(streams, block_len)[1:]


def _feed(streams, block_len: int):
    """(lens int64 [S], then :func:`build_blocks`' five arrays): the
    stream lengths of the feed's one walk beside the blocks."""
    with span("feed.gather"):
        # a tuple holds every stream alive while the build reads it
        items = streams if type(streams) is tuple else tuple(streams)
        lens, addr, marked = native.stream_addresses(items)
        for i in marked.tolist():
            lens[i] = np.asarray(items[i]).size
        if marked.size:
            with span("feed.cast"):
                cast = _cast(items, marked, lens, addr)
    return (lens, *build_blocks_at(addr, lens, block_len))  # cast lives till here


def _cast(items, marked, lens, addr) -> List[np.ndarray]:
    """The streams items[marked] as int32 samples
    (``np.asarray(s, np.int32).ravel()``), their addresses written into
    addr: the arrays, which must outlive the build. ValueError where a
    cast's size is not lens[i]."""
    cast = []
    for i in marked.tolist():
        a = np.asarray(items[i], np.int32).ravel()
        if a.size != lens[i]:
            raise ValueError(f"{a.size} samples for a stream of length {lens[i]}")
        addr[i] = a.ctypes.data
        cast.append(a)
    return cast


def build_blocks_at(
    addr: np.ndarray, lens: np.ndarray, block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`build_blocks` of the streams whose lens[s] int32 samples lie
    at address addr[s], by the native host feed (``native.build_streams``:
    C++ on host threads, one copy per block from where the samples lie).
    The caller keeps the samples alive."""
    with span("feed.native"):
        nb, first = plan_blocks(lens, block_len)
        x, n, hist = native.build_streams(addr, lens, first, block_len,
                                          int(nb.sum()))
    return x, n, hist, nb, first


def _flat_offsets(flat, lens):
    """(flat int32, lens int64, sstart [S + 1] int64 stream offsets) of a
    flat feed; ValueError if lens do not sum to flat's size."""
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    lens = np.asarray(lens, dtype=np.int64)
    sstart = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=sstart[1:])
    if flat.size != sstart[-1]:
        raise ValueError(f"{flat.size} samples for stream lengths summing to {sstart[-1]}")
    return flat, lens, sstart


def build_blocks_flat(
    flat: np.ndarray, lens: np.ndarray, block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`build_blocks` over concatenated samples, by the native host
    feed (:func:`build_blocks_at` on the streams' offsets into ``flat``).
    Raises if the library does not build.

    flat: all streams' samples concatenated (int32); lens: per-stream
    sample counts."""
    flat, lens, sstart = _flat_offsets(flat, lens)
    return build_blocks_at(flat.ctypes.data + 4 * sstart[:-1], lens, block_len)


def build_blocks_flat_plain(
    flat: np.ndarray, lens: np.ndarray, block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`build_blocks_flat` in numpy, the native feed's plain twin
    (for the tests), with no per-stream Python work: the block -> stream
    map by one repeat, the samples moved by one scatter per slice of
    streams, the histories by HISTORY_LEN whole-column gathers."""
    L = block_len
    flat, lens, sstart = _flat_offsets(flat, lens)
    nb, first = plan_blocks(lens, L)
    B = int(nb.sum())
    x = np.zeros((B, L), dtype=np.int32)
    n = np.zeros(B, dtype=np.int32)
    hist = np.zeros((B, HISTORY_LEN), dtype=np.int32)
    if B == 0:
        return x, n, hist, nb, first

    sid = np.repeat(np.arange(lens.size, dtype=np.int64), nb)   # [B]
    local = np.arange(B, dtype=np.int64) - first[sid]           # [B]
    base = sstart[sid] + local * L                               # [B]
    end = sstart[sid] + lens[sid]                                # [B]
    n[:] = np.minimum(end - base, L)

    # A stream's blocks are consecutive and full but for its tail, so its
    # sample p lands at first[s] * L + p: one scatter of unique indices,
    # over slices of streams of at most 16 Mi samples to bound the index
    # arrays.
    xf = x.reshape(-1)
    S_n = lens.size
    chunk_samples = 16 << 20
    a = 0
    while a < S_n:
        b = a
        while b < S_n and (sstart[b + 1] - sstart[a]) <= chunk_samples:
            b += 1
        b = max(b, a + 1)  # always advance (a single huge stream)
        cnt = int(sstart[b] - sstart[a])
        sid_s = np.repeat(np.arange(a, b, dtype=np.int64), lens[a:b])
        within = np.arange(cnt, dtype=np.int64)
        within -= sstart[sid_s] - sstart[a]
        xf[first[sid_s] * L + within] = flat[sstart[a] : sstart[b]]
        a = b

    for j in range(HISTORY_LEN):
        hidx = base - 1 - j
        ok = hidx >= sstart[sid]
        hist[:, j] = np.where(ok, flat[np.maximum(hidx, 0)], 0)
    return x, n, hist, nb, first


def _stream_metas(lens, stream_ids, cadences, nb, first) -> StreamDir:
    S = lens.size
    return StreamDir(
        stream_id=(
            np.asarray(stream_ids, np.uint64)
            if stream_ids is not None
            else np.arange(S, dtype=np.uint64)
        ),
        cadence_s=(
            np.asarray(cadences, np.uint32)
            if cadences is not None
            else np.full(S, 900, np.uint32)
        ),
        num_samples=lens,
        num_blocks=nb,
        first_block=first,
    )


def block_ranges(B: int, chunk_blocks: int | None) -> List[Tuple[int, int]]:
    """[(b0, b1)]: contiguous ranges of at most chunk_blocks blocks covering
    0..B, or the whole batch as one range when chunk_blocks is None."""
    if chunk_blocks is None or B == 0:
        return [(0, B)]
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be positive, got {chunk_blocks}")
    return [(a, min(a + chunk_blocks, B)) for a in range(0, B, chunk_blocks)]


def range_blocks(chunk_blocks: int | None, total_memory: int | None,
                 block_len: int) -> int | None:
    """Blocks per range: chunk_blocks when given; else None (one pass) off
    the card (total_memory None), and on a card of total_memory bytes as
    many blocks as fit 1 / DEVICE_SHARE of it at DEVICE_BYTES_PER_SAMPLE
    bytes a sample. Total, not free, memory: the split is the same from
    run to run."""
    if chunk_blocks is not None or total_memory is None:
        return chunk_blocks
    per_block = DEVICE_SHARE * DEVICE_BYTES_PER_SAMPLE * block_len
    return max(1, total_memory // per_block)


def device_memory(devices) -> int | None:
    """The least total memory of the devices in bytes, or None when one of
    them is not a CUDA device."""
    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        return None
    return min(torch.cuda.get_device_properties(d).total_memory for d in devices)


def shard_ranges(b0: int, b1: int, ndev: int) -> List[Tuple[int, int, int]]:
    """[(device index, s0, s1)]: blocks b0..b1 cut into ndev contiguous
    shards of ceil((b1 - b0) / ndev) blocks, as the reference's shard_map
    cuts its padded chunk; empty shards are left out (an empty range is one
    empty shard on device 0)."""
    per = max(-(-(b1 - b0) // ndev), 1)
    return [
        (i, b0 + i * per, min(b0 + (i + 1) * per, b1))
        for i in range(ndev)
        if b0 + i * per < b1 or (i == 0 and b0 == b1)
    ]


# ------------------------------------------------------------------ encode


def select_range(x_h, n_h, hist_h, cfg: CodecConfig, device, backend=None,
                 stage=None):
    """First half of a range's encode: upload its blocks (host [b, L],
    [b], [b, 4]) to ``device`` and select there. Returns the device
    tensors (x, n, hist, choice, coder, k) and reads nothing back, so that
    ranges on several devices can all be launched before the first
    waits."""
    stage = stage or Stages(None, device)
    with stage("upload"):
        x, n, hist = (torch.from_numpy(a).to(device) for a in (x_h, n_h, hist_h))
    with stage("select"):
        if cfg.coder == "adaptive":
            choice, coder, kk = adaptive_select(x, n, hist, cfg, backend)
        else:
            choice, kk = select_blocks(x, n, hist, cfg, backend)
            coder = torch.full_like(choice, _CODER_ID[cfg.coder])
    return x, n, hist, choice, coder, kk


def emit_range(sel, cfg: CodecConfig, backend=None, stage=None):
    """Second half of a range's encode, from :func:`select_range`'s
    tensors: group the blocks by coder (one host read), emit each group,
    stacking its payload rows behind the previous group's, then CP
    (``kernels/compact.py``: its count pass, one host read of the range's
    word total, its copy) writes every block's compact words in block
    order, and the words and the per-block arrays cross to the host.
    Returns host arrays (choice, coder, k, bit_len, words uint32)."""
    x, n, hist, choice, coder, kk = sel
    device = x.device
    stage = stage or Stages(None, device)
    L = cfg.block_len
    B = x.shape[0]
    with span("sync.coders"):
        coder_h = coder.cpu().numpy()

    bit_len = torch.zeros(B, dtype=torch.int64, device=device)
    # each group's rows in block order, the groups in CP's order
    rows = []
    for gid, gname in _CODERS:
        idx_h = np.nonzero(coder_h == gid)[0]
        if idx_h.size == 0:
            continue
        idx = torch.from_numpy(idx_h).to(device)
        with stage(f"emit_{gname}"):
            payload, bl = emit_blocks(
                x[idx], n[idx], hist[idx], choice[idx], kk[idx], cfg, gname,
                backend,
            )
        bit_len[idx] = bl
        rows.append(payload)
    rows += [None] * (2 - len(rows))

    with stage("compact"):
        buf, _ = compact_range_flagged(rows[0], rows[1], coder, bit_len, L)
    with stage("download"):
        words_h = host_words(buf)
        out = []
        for what, t in (("choice", choice), ("k", kk), ("bit_len", bit_len)):
            with span(f"sync.{what}"):
                out.append(t.cpu().numpy())
    return out[0], coder_h, out[1], out[2], words_h


def encode_range(x_h, n_h, hist_h, cfg: CodecConfig, device, backend=None,
                 stage=None):
    """One contiguous range of blocks -> host (choice, coder, k, bit_len,
    compact words): :func:`select_range`, then :func:`emit_range`."""
    sel = select_range(x_h, n_h, hist_h, cfg, device, backend, stage)
    return emit_range(sel, cfg, backend, stage)


def candidate_maps(cfg: CodecConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(predictor, table_idx) of each candidate index, as uint8 arrays."""
    return tuple(t.numpy().astype(np.uint8)
                 for t in candidate_ids(cfg, torch.device("cpu")))


def _cat(arrays):
    return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)


def encode_frame(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig,
    stream_ids,
    cadences,
    devices,
    stage_ms: dict | None,
    backend: str | None,
    chunk_blocks: int | None,
) -> Frame:
    """Streams -> frame, each range of ``chunk_blocks`` blocks cut into one
    shard per device of ``devices``: every shard of a range is selected
    before the first one's emission reads its coders back, so selection
    overlaps across devices; emission then reads each shard back (coders,
    sizes, words) before the next shard's emission is launched, so the
    shards emit in turn. The results are concatenated in block order.
    Each range's launches and reads are one span ``range``."""
    if cfg.coder not in ("adaptive", *_CODER_ID):
        raise ValueError(f"unknown coder {cfg.coder!r}")
    L = cfg.block_len
    host = Stages(stage_ms, "cpu")
    with host("host_build_blocks"):
        lens, x_h, n_h, hist_h, nb, first = _feed(streams, L)
    stages = [Stages(stage_ms, d) for d in devices]
    chunk_blocks = range_blocks(chunk_blocks, device_memory(devices), L)
    parts = []
    for c0, c1 in block_ranges(x_h.shape[0], chunk_blocks):
        with span("range"):
            shards = shard_ranges(c0, c1, len(devices))
            sels = [
                select_range(x_h[a:b], n_h[a:b], hist_h[a:b], cfg, devices[i],
                             backend, stages[i])
                for i, a, b in shards
            ]
            parts += [
                emit_range(sel, cfg, backend, stages[i])
                for sel, (i, _, _) in zip(sels, shards)
            ]
    for stage in stages:
        stage.finish()

    with host("host_frame_assembly"):
        with span("assembly.columns"):
            choice, coder, kk, bit_len, words = (_cat(col) for col in zip(*parts))
            pred_map, ti_map = candidate_maps(cfg)
            blocks = BlockHeaders(
                predictor=pred_map[choice],
                k=kk.astype(np.uint8),
                n=n_h.astype(np.uint16),
                bit_len=bit_len.astype(np.uint32),
                table_idx=ti_map[choice],
                history=hist_h,
                coder=coder.astype(np.uint8),
            )
        with span("assembly.stream_dir"):
            sdir = _stream_metas(lens, stream_ids, cadences, nb, first)
        frame = Frame(
            block_len=L,
            streams=sdir,
            blocks=blocks,
            tables=cfg.lpc_tables,
            payload_words=words,
        )
    return frame


def compress(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    stream_ids: Sequence[int] | None = None,
    cadences: Sequence[int] | None = None,
    device="cuda",
    stage_ms: dict | None = None,
    backend: str | None = None,
    chunk_blocks: int | None = None,
) -> Frame:
    """Streams -> DCF1 frame, with ``cfg`` (default ``CodecConfig()``, the
    RICE coder, as in the reference).

    Selection runs on the device: the (candidate, coder, k) per block for
    coder="adaptive" (FORMAT §4.1), the (candidate, k) per block for
    "rice" and "vertical". The blocks are grouped by coder, each group is
    emitted, and one compaction (CP) writes the compact words of both
    groups in block-table order on the device.

    ``backend`` goes to selection and emission as in the reference's
    compress: every name gives the same frame and picks the kernels of
    each stage (``codec/encode.py``). A RICE group raises ValueError for a
    name the reference's packer does not know ("reduce", "bp", ...).
    ``chunk_blocks`` bounds the blocks per pass (default: one pass on the
    CPU, :func:`range_blocks` on a card)."""
    cfg = cfg or CodecConfig()
    return encode_frame(streams, cfg, stream_ids, cadences, [device],
                        stage_ms, backend, chunk_blocks)


# ------------------------------------------------------------------ decode


def decompress(
    frame: Frame,
    device="cuda",
    stage_ms: dict | None = None,
    chunk_blocks: int | None = None,
    backend: str | None = None,
) -> List[np.ndarray]:
    """Frame -> streams (int32 numpy arrays, each owning its samples).

    ``backend`` takes the reference decoder's names (``DECODE_BACKENDS``);
    the port has one decode path, K5b and K4 then R, and runs it for each
    of them. As in the reference, a RICE group raises ValueError for any
    other name. ``chunk_blocks`` bounds the blocks per pass (default: one
    pass on the CPU, :func:`range_blocks` on a card)."""
    return decode_frame(frame, [device], stage_ms, chunk_blocks, backend)


def decode_frame(
    frame: Frame,
    devices,
    stage_ms: dict | None,
    chunk_blocks: int | None,
    backend: str | None,
) -> List[np.ndarray]:
    """Frame -> streams, each range of ``chunk_blocks`` blocks cut into one
    shard per device of ``devices`` (:func:`decode_flat`).

    R writes each shard's samples in stream order, and the host takes them
    by the mean stream length (:func:`takes_flat_path`): streams long on
    average each get their own array, made and its pages touched on
    ``_TOUCH_THREADS`` host threads ahead of the copies, and filled by one
    copy from the device per shard it spans (span ``download.streams``);
    short ones are downloaded into one array (span ``download.flat``), then
    copied out of it into arrays of their own in one native call on host
    threads (:func:`_split`, span ``split.copies``), so that a million
    streams make no million device copies."""
    host = Stages(stage_ms, "cpu")
    soff, ranges = decode_flat(frame, devices, stage_ms, chunk_blocks, backend)
    with host("host_split_streams"):
        lens, starts = _stream_samples(frame, soff)
    if takes_flat_path(lens):
        flat = _download_flat(soff, ranges)
        with host("host_split_streams"), span("split.copies"):
            return _split(flat, starts, lens)
    ends = starts + lens
    with ThreadPoolExecutor(_TOUCH_THREADS) as pool:
        out = [pool.submit(_fresh, k) for k in lens.tolist()]
        for x, s0, s1, stage in ranges:
            lo, hi = np.maximum(starts, s0), np.minimum(ends, s1)
            cut = np.nonzero(lo < hi)[0]
            with stage("download"), span("download.streams"), span("sync.download"):
                for i, a, b in zip(cut.tolist(), lo[cut].tolist(), hi[cut].tolist()):
                    t = int(starts[i])
                    dst = out[i].result()[a - t : b - t]
                    torch.from_numpy(dst).copy_(x[a - s0 : b - s0])
        return [f.result() for f in out]


def takes_flat_path(lens: np.ndarray) -> bool:
    """Whether :func:`decompress` downloads streams of these lengths into
    one flat array: a mean below ``_FLAT_PATH_MAX_MEAN_LEN`` samples."""
    return bool(lens.sum() < _FLAT_PATH_MAX_MEAN_LEN * lens.size)


def _split(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> List[np.ndarray]:
    """flat[starts[i] : starts[i] + lens[i]] for each stream i, each in a
    new array of its own made on the calling thread. The copies run in one
    native call (``native.scatter``) on one thread a
    ``native.FRAME_BYTES_PER_THREAD`` of samples, at most
    ``_TOUCH_THREADS``, so that the fresh pages' first touches are spread
    over them (span ``split.parallel`` when more than one). Called only
    after every download has landed: threads taking first touches stall a
    pageable copy that runs beside them."""
    out = tuple(np.empty(k, np.int32) for k in lens.tolist())
    threads = max(1, min(_TOUCH_THREADS,
                         4 * int(lens.sum()) // native.FRAME_BYTES_PER_THREAD))
    if threads == 1:
        native.scatter(flat, starts, out, 1)
    else:
        with span("split.parallel"):
            native.scatter(flat, starts, out, threads)
    return list(out)


def _fresh(k: int) -> np.ndarray:
    """A new int32 array of k samples with one sample written in each 4 KiB
    page, so that the host has mapped its pages before a copy lands there."""
    a = np.empty(k, np.int32)
    a[::_PAGE_SAMPLES] = 0
    return a


def _stream_samples(frame: Frame, soff: np.ndarray):
    """(lens, starts) int64: each stream's sample count and its first
    sample among the blocks' valid samples in block order (soff, the
    exclusive prefix sum of n); ValueError for a stream whose samples run
    past its own blocks."""
    sd = frame.streams
    if isinstance(sd, StreamDir):
        lens, first, nb = (a.astype(np.int64) for a in
                           (sd.num_samples, sd.first_block, sd.num_blocks))
    else:
        lens, first, nb = (
            np.fromiter((getattr(s, f) for s in sd), np.int64, len(sd))
            for f in ("num_samples", "first_block", "num_blocks"))
    B = soff.size - 1
    last = first + nb
    if (last > B).any() or (soff[np.minimum(last, B)] - soff[np.minimum(first, B)]
                            < lens).any():
        raise ValueError("malformed DCF1 stream directory: a stream's samples "
                         "run past its blocks")
    return lens, soff[first]


def decompress_flat(
    frame: Frame,
    device="cuda",
    stage_ms: dict | None = None,
    chunk_blocks: int | None = None,
    backend: str | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`decompress`, returning (all streams' samples concatenated,
    per-stream lengths): blocks are in stream order and every block but a
    stream's last is full, so the blocks' valid samples in block order are
    the streams' samples. R writes them so on the device
    (:func:`decode_flat`), and each range's download lands in its slice of
    the one output array."""
    soff, ranges = decode_flat(frame, [device], stage_ms, chunk_blocks, backend)
    flat = _download_flat(soff, ranges)
    with Stages(stage_ms, "cpu")("host_flatten"):
        if isinstance(frame.streams, StreamDir):
            lens = frame.streams.num_samples.astype(np.int64)
        else:
            lens = np.array([s.num_samples for s in frame.streams], np.int64)
    return flat, lens


def _download_flat(soff: np.ndarray, ranges) -> np.ndarray:
    """The samples of :func:`decode_flat`'s shards, each downloaded into its
    slice of one host array of soff[-1] samples."""
    flat = np.empty(int(soff[-1]), np.int32)
    for x, s0, s1, stage in ranges:
        with stage("download"), span("download.flat"), span("sync.download"):
            torch.from_numpy(flat[s0:s1]).copy_(x)
    return flat


def _check_block_table(frame: Frame) -> None:
    """Reject block tables whose fields would index outside the frame."""
    hb = frame.blocks
    L = frame.block_len
    if hb.num_blocks == 0:
        return
    off = hb.word_offsets(L)
    lpc = hb.predictor == LPC
    rice = hb.coder_arr() == CODER_RICE
    problems = {
        "coder id": hb.coder_arr().max() > CODER_VERTICAL,
        "predictor id": hb.predictor.max() > LPC,
        "LPC table index": lpc.any() and hb.table_idx[lpc].max() >= len(frame.tables),
        "valid count n": hb.n.max() > L,
        "RICE k": rice.any() and hb.k[rice].max() > 30,
        "payload size": off[-1] > frame.payload_words.size,
        "RICE bit_len": rice.any() and np.diff(off)[rice].max() > padded_words(L),
    }
    bad = [name for name, is_bad in problems.items() if is_bad]
    if bad:
        raise ValueError(f"malformed DCF1 block table: {', '.join(bad)}")


def decode_range(
    frame: Frame, off_h: np.ndarray, soff: np.ndarray, coeffs: torch.Tensor,
    b0: int, b1: int, backend: str | None = None, stage=None,
):
    """Blocks b0..b1 of the frame -> (their soff[b1] - soff[b0] valid
    samples on coeffs' device, block b's at soff[b] - soff[b0]; K4's flags
    for ``vdec.raise_if_bad``, or None): each coder group decoded by its
    kernel, then one R over the whole range in its flat form. soff: the
    exclusive prefix sum of the frame's n, [B + 1] int64.

    Only the range's compact words, [off_h[b0], off_h[b1]), cross to the
    device, with each block's start rebased to them; each coder group's
    decode kernel reads its blocks' words there in place. Every copy to
    the device comes before the first launch (a copy from pageable host
    memory waits for the device's stream) and nothing is read back, so
    ranges on several devices all run at once. coeffs: the frame's LPC
    tables as [T, 4] int32 on the device."""
    device = coeffs.device
    stage = stage or Stages(None, device)
    L = frame.block_len
    hb = frame.blocks
    w0, w1 = int(off_h[b0]), int(off_h[b1])
    coders = hb.coder_arr()[b0:b1]
    groups = []
    # each block's row in its group's z: >= 0 in the first group, -1 - row
    # in the second
    src_h = np.empty(b1 - b0, np.int32)
    for gid, gname in _CODERS:
        idx_h = np.nonzero(coders == gid)[0]
        if idx_h.size == 0:
            continue
        if gid == CODER_RICE and backend not in DECODE_BACKENDS:
            raise ValueError(f"unknown kernel backend {backend!r}")
        rows = np.arange(idx_h.size, dtype=np.int32)
        src_h[idx_h] = -1 - rows if groups else rows
        groups.append((gname, idx_h))
    with stage("upload"):
        words = torch.from_numpy(np.ascontiguousarray(
            frame.payload_words[w0:w1], dtype=np.uint32).view(np.int32)
        ).to(device)
        heads = {
            name: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for name, a in (
                ("k", hb.k[b0:b1]), ("n", hb.n[b0:b1]),
                ("predictor", hb.predictor[b0:b1]),
                ("table_idx", hb.table_idx[b0:b1]),
                ("history", hb.history[b0:b1]),
                ("count", np.diff(off_h[b0 : b1 + 1])), ("src", src_h),
            )
        }
        heads["start"] = torch.from_numpy(off_h[b0:b1] - w0).to(device)
        heads["out_off"] = torch.from_numpy(soff[b0:b1] - soff[b0]).to(device)
        groups = [(gname, torch.from_numpy(idx_h).to(device))
                  for gname, idx_h in groups]
    zs, bad = [], None
    for gname, idx in groups:
        g = {name: heads[name][idx] for name in ("start", "count", "k", "n")}
        with stage(f"decode_{gname}"):
            z, flags = decode_z(words, g["start"], g["count"], g["k"], g["n"], L,
                                gname)
        bad = flags if flags is not None else bad
        zs.append(z)
    if not zs:  # an empty range
        return torch.empty(0, dtype=torch.int32, device=device), bad
    with stage("reconstruct"):
        xs = reconstruct(zs, heads["src"], heads["n"], heads["predictor"],
                         heads["table_idx"], heads["history"], coeffs,
                         out_off=heads["out_off"],
                         out_len=int(soff[b1] - soff[b0]))
    return xs, bad


def decode_flat(
    frame: Frame,
    devices,
    stage_ms: dict | None = None,
    chunk_blocks: int | None = None,
    backend: str | None = None,
):
    """Frame -> (soff, shards), each range of ``chunk_blocks`` blocks cut
    into one shard per device of ``devices``, as :func:`encode_frame` cuts
    them. soff [B + 1] int64 is the exclusive prefix sum of the blocks' n,
    block b's first sample among all blocks' valid samples in block order
    (for a frame of blocks in stream order, the streams' samples
    concatenated). Every shard of a range is launched before the first
    host read, K4's flags of each shard in turn, so the shards of a range
    overlap across devices; then shards yields, in block order, (x, s0,
    s1, stage) for each shard of blocks a..b: x its samples s0 = soff[a]
    to s1 = soff[b] on its device, as R's flat form writes them, and its
    device's ``Stages`` for the caller's ``download`` of them, which comes
    before the next range is launched. The stages' times are added once
    the last shard is taken. Each range is one span ``range``, from its
    launches to the caller's downloads of its shards."""
    L = frame.block_len
    B = frame.blocks.num_blocks
    with Stages(stage_ms, "cpu")("host_block_table"):
        _check_block_table(frame)
        off_h = frame.blocks.word_offsets(L)
        soff = np.zeros(B + 1, np.int64)
        np.cumsum(frame.blocks.n, out=soff[1:])
    tables = [list(t.coeffs) for t in frame.tables] or [[0, 0, 0, 0]]
    coeffs = [torch.tensor(tables, dtype=torch.int32, device=d) for d in devices]
    stages = [Stages(stage_ms, d) for d in devices]
    chunk_blocks = range_blocks(chunk_blocks, device_memory(devices), L)

    def decoded():
        for c0, c1 in block_ranges(B, chunk_blocks):
            with span("range"):
                shards = shard_ranges(c0, c1, len(devices))
                res = [decode_range(frame, off_h, soff, coeffs[i], a, b, backend,
                                    stages[i])
                       for i, a, b in shards]
                for _, bad in res:
                    raise_if_bad(bad)
                for (x, _), (i, a, b) in zip(res, shards):
                    yield x, int(soff[a]), int(soff[b]), stages[i]
        for stage in stages:
            stage.finish()

    return soff, decoded()
