"""The inputs of a cell and the closed loop that drives the program.

Two modes, named by the traffic file's ``mode``:

  * ``batch``: each input is the configuration's whole batch of meters,
    handed over as a list of numpy views of one flat array (as a head-end
    job reads a day's file);
  * ``per_call``: each input is one meter's stream.

Both run the same closed loop with one caller: round trip after round
trip, input after input in turn, until the window has passed. A round
trip is the encode (``compress`` then ``write_frame``) and the decode
(``read_frame`` then the traffic's decode entry), each half timed on the
host clock; a traced run wraps each half and each of the four calls in a
span of its own (``pb.encode``, ``pb.compress``, ...).

Nothing else runs between calls, and the loop allocates nothing there:
it copies the answers (frame bytes and decoded samples) of the first
round trip of each distinct input, and of a sample of the round trips
drawn from the seed by reservoir sampling (the traffic's ``compare`` of
them), into room made before the window (:class:`Answers`), and digests
them after the window. On an H100 host, hashing each answer between
calls doubled a 5 ms call of ``dataport.file``; holding answers that the
loop allocated and freed at random calls would change the heap that the
program's own allocations meet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import random
import time
from typing import List

import numpy as np
import torch

from portbench import generator


@dataclasses.dataclass
class Input:
    streams: list          # numpy int32 arrays, views of flat
    flat: np.ndarray       # every stream's samples, concatenated
    lens: np.ndarray       # int64 samples per stream
    ids: np.ndarray        # uint64 stream ids
    cadences: np.ndarray   # uint32 seconds

    @property
    def raw_bytes(self) -> int:
        return int(self.flat.nbytes)

    def digest(self) -> str:
        return samples_digest(self.flat, self.lens)


@dataclasses.dataclass
class Call:
    input: int
    encode_s: float = 0.0      # compress + write_frame
    decode_s: float = 0.0      # read_frame + decode
    write_s: float = 0.0
    read_s: float = 0.0
    encode_stages: dict | None = None
    decode_stages: dict | None = None
    frame_sha: str | None = None
    decoded_sha: str | None = None
    error: str | None = None


def samples_digest(flat: np.ndarray, lens: np.ndarray) -> str:
    h = hashlib.sha256(np.ascontiguousarray(lens, np.int64).tobytes())
    h.update(memoryview(np.ascontiguousarray(flat, np.int32)).cast("B"))
    return h.hexdigest()


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> List[Input]:
    """The cell's distinct inputs, made on ``device`` from the seed and
    handed to the host in one copy."""
    per_input = cfg["num_streams"] if traffic["mode"] == "batch" else 1
    count = traffic["inputs"]
    n, cad = cfg["samples_per_stream"], cfg["cadence_s"]
    x = generator.load_profiles(cfg["signal"], count * per_input, n, cad, seed, device)
    host = x.cpu().numpy().reshape(count, per_input * n)
    del x
    out = []
    for i in range(count):
        flat = host[i]
        out.append(Input(
            streams=[flat[j * n:(j + 1) * n] for j in range(per_input)],
            flat=flat,
            lens=np.full(per_input, n, np.int64),
            ids=np.arange(i * per_input, (i + 1) * per_input, dtype=np.uint64),
            cadences=np.full(per_input, cad, np.uint32),
        ))
    return out


def round_trip(prog, settings, inp: Input, index: int, decode: str, device,
               stages: bool, span=None):
    """One encode and one decode of ``inp``: (its :class:`Call`, its
    answer (frame bytes, decoded output) or None if a call raised); with
    ``stages``, the program's ``stage_ms`` of each; ``span(name)`` wraps
    each half and each call."""
    span = span or (lambda name: contextlib.nullcontext())
    call = Call(index)
    enc = {} if stages else None
    dec = {} if stages else None
    try:
        with span("pb.encode"):
            t0 = time.perf_counter()
            with span("pb.compress"):
                frame = prog.compress(inp.streams, settings, inp.ids, inp.cadences,
                                      device=device, stage_ms=enc)
            t1 = time.perf_counter()
            with span("pb.write_frame"):
                data = prog.write_frame(frame)
            t2 = time.perf_counter()
        del frame
        with span("pb.decode"):
            t3 = time.perf_counter()
            with span("pb.read_frame"):
                back = prog.read_frame(data)
            t4 = time.perf_counter()
            with span(f"pb.{decode}"):
                out = getattr(prog, decode)(back, device=device, stage_ms=dec)
            t5 = time.perf_counter()
    except Exception as exc:  # a call that raises is an answer that never came
        call.error = f"{type(exc).__name__}: {exc}"
        return call, None
    call.encode_s, call.write_s = t2 - t0, t2 - t1
    call.decode_s, call.read_s = t5 - t3, t4 - t3
    call.encode_stages, call.decode_stages = enc, dec
    return call, (data, out)


def parts(out, decode: str):
    """(the decoded arrays, samples per stream) of a decode's output."""
    if decode == "decompress_flat":
        flat, lens = out
        return [flat], lens
    return out, [a.size for a in out]


def digest(call: Call, answer, decode: str) -> None:
    """Set the call's digests of its frame bytes and decoded samples."""
    data, out = answer
    arrays, lens = parts(out, decode)
    call.frame_sha = hashlib.sha256(data).hexdigest()
    flat = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
    call.decoded_sha = samples_digest(flat, np.asarray(lens, np.int64))


class Slot:
    """Room for one answer: a frame of up to ``frame_bytes`` bytes and up
    to ``samples`` decoded samples in ``streams`` streams."""

    def __init__(self, frame_bytes: int, samples: int, streams: int):
        self.frame = bytearray(frame_bytes)
        self.samples = np.empty(samples, np.int32)
        self.lens = np.empty(streams, np.int64)
        self.call = None
        self.sizes = (0, 0, 0)

    def store(self, call: Call, answer, decode: str) -> bool:
        """Copy the answer in, without allocating; False, and nothing
        stored, when it does not fit."""
        data, out = answer
        arrays, lens = parts(out, decode)
        n = sum(a.size for a in arrays)
        if len(data) > len(self.frame) or n > self.samples.size or len(lens) > self.lens.size:
            return False
        memoryview(self.frame)[:len(data)] = data
        np.concatenate(arrays, out=self.samples[:n], casting="unsafe")
        self.lens[:len(lens)] = lens
        self.call, self.sizes = call, (len(data), n, len(lens))
        return True

    def digest(self) -> None:
        if self.call is None or self.call.frame_sha is not None:
            return
        f, n, k = self.sizes
        self.call.frame_sha = hashlib.sha256(memoryview(self.frame)[:f]).hexdigest()
        self.call.decoded_sha = samples_digest(self.samples[:n], self.lens[:k])


class Answers:
    """The answers the loop keeps: the first of each input, each in a slot
    sized by that input's warm-up frame, and ``compare`` more, a uniform
    sample of all answers drawn from ``seed``. An answer that does not fit
    its slot (a frame longer than the warm-up's) is digested at once."""

    def __init__(self, inputs: List[Input], frame_bytes: List[int], compare: int,
                 seed: int):
        self.first = [Slot(f, inp.flat.size, inp.lens.size)
                      for inp, f in zip(inputs, frame_bytes)]
        most = (max(frame_bytes), max(i.flat.size for i in inputs),
                max(i.lens.size for i in inputs))
        self.sample = [Slot(*most) for _ in range(compare)]
        self.pick = random.Random(seed)
        self.answered = 0

    def keep(self, call: Call, answer, decode: str) -> None:
        slots = []
        if self.first[call.input].call is None:
            slots.append(self.first[call.input])
        self.answered += 1  # reservoir sampling: each answer kept alike
        j = (self.answered - 1 if self.answered <= len(self.sample)
             else self.pick.randrange(self.answered))
        if j < len(self.sample):
            slots.append(self.sample[j])
        for slot in slots:
            if not slot.store(call, answer, decode) and call.frame_sha is None:
                digest(call, answer, decode)

    def digest(self) -> None:
        for slot in self.first + self.sample:
            slot.digest()


def closed_loop(prog, settings, inputs: List[Input], decode: str, device,
                seconds: float, stages: bool, answers: Answers,
                span=None) -> List[Call]:
    """Round trips, one after another over the inputs in turn, until
    ``seconds`` have passed; the call under way at the close runs to its
    end and counts. Then the digests of the answers that ``answers``
    kept; the other calls have none."""
    calls = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        i = len(calls)
        call, answer = round_trip(prog, settings, inputs[i % len(inputs)],
                                  i % len(inputs), decode, device, stages, span)
        calls.append(call)
        if answer is not None:
            answers.keep(call, answer, decode)
        del answer
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    answers.digest()
    return calls
