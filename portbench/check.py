"""What decides ``correct``: every answer of the window against the plain
reference, after the window.

The round trips compared (``loop.closed_loop``: the first of each
distinct input and a sample drawn from the seed) left two digests: of the
frame's bytes and of the decoded samples. The reference (``reference/``)
encodes each distinct input once, from the samples the benchmark made,
and writes its frame; a call is right when its frame's bytes equal that
frame's and its decoded samples equal the input. Every count below has the limit 0: the format is exact (FORMAT
§4 makes the frame's every byte normative) and the codec lossless.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import codec, frame

LIMITS = {"frames_differing": 0, "decodes_differing": 0, "answers_missing": 0}


def settings(cfg: dict) -> codec.Settings:
    return codec.Settings(
        block_len=cfg["block_len"], predictors=tuple(cfg["predictors"]),
        lpc_tables=tuple((o, tuple(c)) for o, c in cfg["lpc_tables"]),
        k_max=cfg["k_max"], coder=cfg["coder"],
    )


def reference(inputs, cfg: dict, device, transform=None):
    """(frame bytes, blocks) of each input by the reference, all inputs'
    blocks encoded together; ``transform`` (for the control) changes the
    samples the reference encodes."""
    s = settings(cfg)
    flat = np.concatenate([i.flat for i in inputs])
    lens = np.concatenate([i.lens for i in inputs])
    x = torch.from_numpy(flat).to(device)
    if transform is not None:
        x = transform(x)
    blocks = codec.encode(x, lens, s)
    del x
    nb = [int((-(-i.lens // s.block_len)).sum()) for i in inputs]
    first = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int64)
    parts = codec.split_frames(blocks, first, nb)
    return [(frame.frame_bytes(p, s.block_len, i.ids, i.cadences, i.lens, s.lpc_tables), p)
            for p, i in zip(parts, inputs)]


def counts(calls, frame_shas: dict, input_shas: dict) -> dict:
    """Each compared number of the window's calls: the compared ones
    (those with digests) against the reference, every call for a missing
    answer."""
    compared = [c for c in calls if c.frame_sha is not None]
    return {
        "frames_differing": sum(c.frame_sha != frame_shas[c.input] for c in compared),
        "decodes_differing": sum(c.decoded_sha != input_shas[c.input] for c in compared),
        "answers_missing": sum(c.error is not None for c in calls),
    }


def verdict(values: dict, calls) -> bool:
    return (any(c.frame_sha is not None for c in calls)
            and all(values[k] <= lim for k, lim in LIMITS.items()))
