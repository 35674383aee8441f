"""Host orchestration: numpy streams <-> device codec <-> DCF1 frames.

The counterpart of ``dctpu/codec/api.py`` for all three coders:
``CodecConfig(coder="rice")`` (the default of ``CodecConfig()``),
``"vertical"`` and ``"adaptive"`` (the CLI default). Block planning and
frame assembly are host numpy; every per-sample stage runs on ``device``.
The samples cross to the device once, the compact payload words cross
back once; decode does the reverse.

The reference splits the batch into ``chunk_blocks`` pieces only to bound
TPU compile geometries. PyTorch compiles nothing, so the port runs the
whole batch in one pass.

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

_CODERS = ((CODER_RICE, "rice"), (CODER_VERTICAL, "vertical"))
_CODER_ID = {name: gid for gid, name in _CODERS}


# ------------------------------------------------------------ block building


def build_blocks(
    streams: Sequence[np.ndarray], block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack streams into [B, L] padded blocks + lengths + histories (numpy).

    The reference's flat path (``build_blocks_flat``) and its native
    helper are host-feed tunings for millions of streams; the per-stream
    loop gives the same arrays."""
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


class _Stages:
    """Adds per-stage milliseconds into ``out`` (a dict) when one is given."""

    def __init__(self, out, device):
        self.out = out
        self.cuda = torch.device(device).type == "cuda"
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
            return
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.events.append((name, start, end))
            return
        t0 = time.perf_counter()
        yield
        self._add(name, (time.perf_counter() - t0) * 1e3)

    def _add(self, name, ms):
        self.out[name] = self.out.get(name, 0.0) + ms

    def finish(self):
        if self.events:
            torch.cuda.synchronize()
            for name, start, end in self.events:
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


def compress(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    stream_ids: Sequence[int] | None = None,
    cadences: Sequence[int] | None = None,
    device="cuda",
    stage_ms: dict | None = None,
    backend: str | None = None,
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
    name the reference's packer does not know ("reduce", "bp", ...)."""
    cfg = cfg or CodecConfig()
    if cfg.coder not in ("adaptive", *_CODER_ID):
        raise ValueError(f"unknown coder {cfg.coder!r}")
    stage = _Stages(stage_ms, device)
    L = cfg.block_len
    x_h, n_h, hist_h, nb, first = build_blocks(streams, L)
    B = x_h.shape[0]

    with stage("upload"):
        x, n, hist = (torch.from_numpy(a).to(device) for a in (x_h, n_h, hist_h))
    with stage("select"):
        if cfg.coder == "adaptive":
            choice, coder, kk = adaptive_select(x, n, hist, cfg, backend)
        else:
            choice, kk = select_blocks(x, n, hist, cfg, backend)
            coder = torch.full_like(choice, _CODER_ID[cfg.coder])
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
        payload_words = out.cpu().numpy().view(np.uint32)
    stage.finish()

    cands = cfg.candidates()
    pred_map = np.array([p for p, _ in cands], dtype=np.uint8)
    ti_map = np.array([ti if p == LPC else 0 for p, ti in cands], dtype=np.uint8)
    choice_h = choice.cpu().numpy()
    blocks = BlockHeaders(
        predictor=pred_map[choice_h],
        k=kk.cpu().numpy().astype(np.uint8),
        n=n_h.astype(np.uint16),
        bit_len=bit_len.cpu().numpy().astype(np.uint32),
        table_idx=ti_map[choice_h],
        history=hist_h,
        coder=coder_h.astype(np.uint8),
    )
    return Frame(
        block_len=L,
        streams=_stream_metas(streams, stream_ids, cadences, nb, first),
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=payload_words,
    )


# ------------------------------------------------------------------ decode


def decompress(
    frame: Frame, device="cuda", stage_ms: dict | None = None
) -> List[np.ndarray]:
    """Frame -> streams (int32 numpy arrays)."""
    xs = _decode_blocks_array(frame, device, stage_ms)
    streams = []
    for s in frame.streams:
        flat = xs[s.first_block : s.first_block + s.num_blocks].reshape(-1)
        streams.append(flat[: s.num_samples].copy())
    return streams


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


def _decode_blocks_array(
    frame: Frame, device="cuda", stage_ms: dict | None = None
) -> np.ndarray:
    """Frame -> [B, L] decoded blocks (zeros past n), grouped by coder.

    The compact disk words cross to the device once; each coder group's
    decode kernel reads its blocks' words there in place."""
    _check_block_table(frame)
    stage = _Stages(stage_ms, device)
    L = frame.block_len
    hb = frame.blocks
    B = hb.num_blocks
    coders = hb.coder_arr()
    coeffs = torch.tensor(
        [list(t.coeffs) for t in frame.tables] or [[0, 0, 0, 0]],
        dtype=torch.int32, device=device,
    )
    off_h = hb.word_offsets(L)

    with stage("upload"):
        words = torch.from_numpy(
            np.ascontiguousarray(frame.payload_words, dtype=np.uint32).view(np.int32)
        ).to(device)
        heads = {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for name, a in (
                ("k", hb.k.astype(np.int32)), ("n", hb.n.astype(np.int32)),
                ("predictor", hb.predictor.astype(np.int32)),
                ("table_idx", hb.table_idx.astype(np.int32)),
                ("history", hb.history.astype(np.int32)),
                ("start", off_h[:-1]), ("count", np.diff(off_h).astype(np.int32)),
            )
        }
    xs = torch.zeros((B, L), dtype=torch.int32, device=device)
    for gid, gname in _CODERS:
        idx_h = np.nonzero(coders == gid)[0]
        if idx_h.size == 0:
            continue
        idx = torch.from_numpy(idx_h).to(device)
        g = {name: t[idx] for name, t in heads.items()}
        with stage(f"decode_{gname}"):
            z = decode_z(words, g["start"], g["count"], g["k"], g["n"], L, gname)
        with stage("reconstruct"):
            xs[idx] = reconstruct(
                z, g["n"], g["predictor"], g["table_idx"], g["history"], coeffs
            )
    with stage("download"):
        out = xs.cpu().numpy()
    stage.finish()
    return out
