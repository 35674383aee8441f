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
the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dctpu_torch.codec.decode import decode_z, reconstruct
from dctpu_torch.codec.encode import adaptive_select, emit_blocks, select_blocks
from dctpu_torch.config import CodecConfig
from dctpu_torch.constants import CODER_RICE, CODER_VERTICAL, HISTORY_LEN, LPC
from dctpu_torch.format.frame import BlockHeaders, Frame, StreamDir, plan_blocks
from dctpu_torch.kernels import ragged
from dctpu_torch.kernels.pack import padded_words
from dctpu_torch.kernels.vdec import raise_if_bad

DEFAULT_CHUNK_BLOCKS = 2048  # the reference's, and the sharded paths' default
# The default pass's bound on device memory (range_blocks): a range may take
# 1 / DEVICE_SHARE of the card's total memory, at DEVICE_BYTES_PER_SAMPLE
# bytes a sample. The most measured is the staged emission's compress,
# 26.2 bytes per input byte (vertical, backend="pallas"; the default paths
# 4.4-5.3, every decompress 2.3; chip_smoke.py on an H100, PERF.md §7):
# 105 bytes a sample, here with a margin of half again.
DEVICE_BYTES_PER_SAMPLE = 160
DEVICE_SHARE = 4
# build_blocks takes the flat path below this mean stream length (samples):
# the crossover of its two numpy paths on the CPU of an H100 host
# (chip_smoke.py's host feed sweep, PERF.md §6)
_FLAT_PATH_MAX_MEAN_LEN = 1536
# the reference decoder's backend names (dctpu/codec/api.py
# _decode_blocks_array, dctpu/kernels/api.py unpack)
DECODE_BACKENDS = (None, "auto", "scan", "scan_xla", "xla", "pallas")
_CODERS = ((CODER_RICE, "rice"), (CODER_VERTICAL, "vertical"))
_CODER_ID = {name: gid for gid, name in _CODERS}


# ------------------------------------------------------------ block building


def build_blocks(
    streams: Sequence[np.ndarray], block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack streams into [B, L] padded blocks + lengths + histories (numpy).

    Two host paths that give the same arrays: :func:`build_blocks_flat` on
    one concatenation for streams shorter than ``_FLAT_PATH_MAX_MEAN_LEN``
    samples on average, where per-stream Python work dominates, and
    :func:`build_blocks_loop` for longer ones, where the flat path's index
    arrays cost more than the per-stream copies. The reference picks the
    flat path from 256 streams on, tuned with its native C helper, which
    is a host tuning and is not ported."""
    lens = np.fromiter((np.asarray(s).size for s in streams), np.int64, len(streams))
    if takes_flat_path(lens):
        flat = np.concatenate([np.asarray(s, np.int32).ravel() for s in streams])
        return build_blocks_flat(flat, lens, block_len)
    return build_blocks_loop(streams, block_len)


def takes_flat_path(lens: np.ndarray) -> bool:
    """Whether :func:`build_blocks` takes the flat path for streams of
    these lengths: a mean below ``_FLAT_PATH_MAX_MEAN_LEN`` samples."""
    return bool(lens.sum() < _FLAT_PATH_MAX_MEAN_LEN * lens.size)


def build_blocks_loop(
    streams: Sequence[np.ndarray], block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`build_blocks` by one copy per stream."""
    L = block_len
    lens = [int(np.asarray(s).size) for s in streams]
    nb, first = plan_blocks(lens, L)
    B = int(nb.sum())
    x = np.zeros((B, L), dtype=np.int32)
    n = np.zeros(B, dtype=np.int32)
    hist = np.zeros((B, HISTORY_LEN), dtype=np.int32)
    for si, s in enumerate(streams):
        s = np.asarray(s, dtype=np.int32)
        ns, k, f = s.size, int(nb[si]), int(first[si])
        if k == 0:
            continue
        buf = np.zeros(k * L, dtype=np.int32)
        buf[:ns] = s
        x[f : f + k] = buf.reshape(k, L)
        n[f : f + k] = L
        n[f + k - 1] = ns - (k - 1) * L
        starts = np.arange(k, dtype=np.int64) * L
        for j in range(HISTORY_LEN):
            idx = starts - 1 - j
            hist[f : f + k, j] = np.where(idx >= 0, s[np.maximum(idx, 0)], 0)
    return x, n, hist, nb, first


def build_blocks_flat(
    flat: np.ndarray, lens: np.ndarray, block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`build_blocks` over concatenated samples, with no per-stream
    Python work: the block -> stream map by one repeat, the samples moved
    by one scatter per slice of streams, the histories by HISTORY_LEN
    whole-column gathers.

    flat: all streams' samples concatenated (int32); lens: per-stream
    sample counts."""
    L = block_len
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    lens = np.asarray(lens, dtype=np.int64)
    nb, first = plan_blocks(lens, L)
    B = int(nb.sum())
    x = np.zeros((B, L), dtype=np.int32)
    n = np.zeros(B, dtype=np.int32)
    hist = np.zeros((B, HISTORY_LEN), dtype=np.int32)
    if B == 0:
        return x, n, hist, nb, first
    sstart = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=sstart[1:])
    if flat.size != sstart[-1]:
        raise ValueError(f"{flat.size} samples for stream lengths summing to {sstart[-1]}")

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


def _stream_metas(streams, stream_ids, cadences, nb, first) -> StreamDir:
    S = len(streams)
    lens = np.fromiter((np.asarray(s).size for s in streams), np.int64, S)
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


class _Stages:
    """Adds per-stage milliseconds into ``out`` (a dict) when one is given;
    CUDA events are recorded on the current stream of ``device``."""

    def __init__(self, out, device):
        self.out = out
        self.device = torch.device(device)
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
            return
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            self.events.append((name, start, end))
            return
        t0 = time.perf_counter()
        yield
        self._add(name, (time.perf_counter() - t0) * 1e3)

    def _add(self, name, ms):
        self.out[name] = self.out.get(name, 0.0) + ms

    def finish(self):
        for name, start, end in self.events:
            end.synchronize()
            self._add(name, start.elapsed_time(end))
        self.events = []


# ------------------------------------------------------------------ encode


def compact_enc_payload(
    payload: torch.Tensor, bit_len: torch.Tensor, block_len: int, coder: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One coder group's payload rows -> (compact disk words, words per
    block), on the rows' device (the semantics of the reference's
    compact_enc_payload_device)."""
    if coder == "vertical":
        return ragged.compact_vertical(payload, block_len)
    return (
        ragged.compact_payload(payload, bit_len, block_len),
        ragged.payload_word_counts(bit_len, block_len),
    )


def select_range(x_h, n_h, hist_h, cfg: CodecConfig, device, backend=None,
                 stage=None):
    """First half of a range's encode: upload its blocks (host [b, L],
    [b], [b, 4]) to ``device`` and select there. Returns the device
    tensors (x, n, hist, choice, coder, k) and reads nothing back, so that
    ranges on several devices can all be launched before the first
    waits."""
    stage = stage or _Stages(None, device)
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
    tensors: group the blocks by coder (one host read), emit and compact
    each group, interleave the compact words in block order. Returns host
    arrays (choice, coder, k, bit_len, words uint32)."""
    x, n, hist, choice, coder, kk = sel
    device = x.device
    stage = stage or _Stages(None, device)
    L = cfg.block_len
    B = x.shape[0]
    coder_h = coder.cpu().numpy()

    bit_len = torch.zeros(B, dtype=torch.int64, device=device)
    wc = torch.zeros(B, dtype=torch.int64, device=device)
    groups = []
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
        with stage(f"compact_{gname}"):
            words, wcg = compact_enc_payload(payload, bl, L, gname)
        bit_len[idx] = bl
        wc[idx] = wcg
        groups.append((idx, words, wcg))

    with stage("interleave"):
        off = torch.cumsum(wc, 0) - wc
        out = torch.zeros(int(wc.sum()), dtype=torch.int32, device=device)
        for idx, words, wcg in groups:
            ragged.copy_segments(out, off[idx], words, torch.cumsum(wcg, 0) - wcg, wcg)
        words_h = out.cpu().numpy().view(np.uint32)
    return (choice.cpu().numpy(), coder_h, kk.cpu().numpy(),
            bit_len.cpu().numpy(), words_h)


def encode_range(x_h, n_h, hist_h, cfg: CodecConfig, device, backend=None,
                 stage=None):
    """One contiguous range of blocks -> host (choice, coder, k, bit_len,
    compact words): :func:`select_range`, then :func:`emit_range`."""
    sel = select_range(x_h, n_h, hist_h, cfg, device, backend, stage)
    return emit_range(sel, cfg, backend, stage)


def candidate_maps(cfg: CodecConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(predictor, table_idx) of each candidate index, as uint8 arrays."""
    cands = cfg.candidates()
    pred_map = np.array([p for p, _ in cands], dtype=np.uint8)
    ti_map = np.array([ti if p == LPC else 0 for p, ti in cands], dtype=np.uint8)
    return pred_map, ti_map


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
    shards emit in turn. The results are concatenated in block order."""
    if cfg.coder not in ("adaptive", *_CODER_ID):
        raise ValueError(f"unknown coder {cfg.coder!r}")
    L = cfg.block_len
    x_h, n_h, hist_h, nb, first = build_blocks(streams, L)
    stages = [_Stages(stage_ms, d) for d in devices]
    chunk_blocks = range_blocks(chunk_blocks, device_memory(devices), L)
    parts = []
    for c0, c1 in block_ranges(x_h.shape[0], chunk_blocks):
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
    return Frame(
        block_len=L,
        streams=_stream_metas(streams, stream_ids, cadences, nb, first),
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=words,
    )


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
    emitted and compacted, and the compact words are interleaved back into
    block-table order on the device.

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
    """Frame -> streams (int32 numpy arrays).

    ``backend`` takes the reference decoder's names (``DECODE_BACKENDS``);
    the port has one decode path, K5b and K4 then R, and runs it for each
    of them. As in the reference, a RICE group raises ValueError for any
    other name. ``chunk_blocks`` bounds the blocks per pass (default: one
    pass on the CPU, :func:`range_blocks` on a card)."""
    xs = decode_blocks_array(frame, [device], stage_ms, chunk_blocks, backend)
    return split_streams(xs, frame.streams)


def split_streams(xs: np.ndarray, streams) -> List[np.ndarray]:
    """[B, L] decoded blocks -> one array per stream of the directory."""
    out = []
    for s in streams:
        flat = xs[s.first_block : s.first_block + s.num_blocks].reshape(-1)
        out.append(flat[: s.num_samples].copy())
    return out


def decompress_flat(
    frame: Frame,
    device="cuda",
    stage_ms: dict | None = None,
    chunk_blocks: int | None = None,
    backend: str | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`decompress`, returning (all streams' samples concatenated,
    per-stream lengths): blocks are in stream order and every block but a
    stream's last is full, so the blocks' valid prefixes, concatenated, are
    the streams' samples, with no per-stream split."""
    xs = decode_blocks_array(frame, [device], stage_ms, chunk_blocks, backend)
    L = frame.block_len
    n = frame.blocks.n.astype(np.int64)
    mask = np.arange(L, dtype=np.int64)[None, :] < n[:, None]
    flat = xs.reshape(-1)[mask.reshape(-1)]
    if isinstance(frame.streams, StreamDir):
        lens = frame.streams.num_samples.astype(np.int64)
    else:
        lens = np.array([s.num_samples for s in frame.streams], np.int64)
    return flat, lens


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
    frame: Frame, off_h: np.ndarray, coeffs: torch.Tensor, b0: int, b1: int,
    backend: str | None = None, stage=None,
):
    """Blocks b0..b1 of the frame -> ([b1 - b0, L] decoded blocks, zeros
    past n, on coeffs' device; K4's flags for ``vdec.raise_if_bad``, or
    None): each coder group decoded by its kernel, then one R over the
    whole range, which writes every output row in block order.

    Only the range's compact words, [off_h[b0], off_h[b1]), cross to the
    device, with each block's start rebased to them; each coder group's
    decode kernel reads its blocks' words there in place. Every copy to
    the device comes before the first launch (a copy from pageable host
    memory waits for the device's stream) and nothing is read back, so
    ranges on several devices all run at once. coeffs: the frame's LPC
    tables as [T, 4] int32 on the device."""
    device = coeffs.device
    stage = stage or _Stages(None, device)
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
        return torch.empty((0, L), dtype=torch.int32, device=device), bad
    with stage("reconstruct"):
        xs = reconstruct(zs, heads["src"], heads["n"], heads["predictor"],
                         heads["table_idx"], heads["history"], coeffs)
    return xs, bad


def decode_blocks_array(
    frame: Frame,
    devices,
    stage_ms: dict | None = None,
    chunk_blocks: int | None = None,
    backend: str | None = None,
) -> np.ndarray:
    """Frame -> [B, L] decoded blocks (zeros past n), each range of
    ``chunk_blocks`` blocks cut into one shard per device of ``devices``:
    every shard of a range is launched before the first host read (K4's
    flags, then the downloads), so the shards of a range overlap across
    devices."""
    _check_block_table(frame)
    L = frame.block_len
    B = frame.blocks.num_blocks
    off_h = frame.blocks.word_offsets(L)
    tables = [list(t.coeffs) for t in frame.tables] or [[0, 0, 0, 0]]
    coeffs = [torch.tensor(tables, dtype=torch.int32, device=d) for d in devices]
    stages = [_Stages(stage_ms, d) for d in devices]
    chunk_blocks = range_blocks(chunk_blocks, device_memory(devices), L)
    ranges = block_ranges(B, chunk_blocks)
    out = None if len(ranges) == 1 and len(devices) == 1 else np.empty((B, L), np.int32)
    for c0, c1 in ranges:
        shards = shard_ranges(c0, c1, len(devices))
        res = [decode_range(frame, off_h, coeffs[i], a, b, backend, stages[i])
               for i, a, b in shards]
        for _, bad in res:
            raise_if_bad(bad)
        for (x, _), (i, a, b) in zip(res, shards):
            with stages[i]("download"):
                if out is None:
                    out = x.cpu().numpy()
                else:  # straight into the output, no second host copy
                    torch.from_numpy(out[a:b]).copy_(x)
    for stage in stages:
        stage.finish()
    return out
