"""The port's tracing: named spans on the profiler's clock, and stage times.

:func:`span` marks a step of the program. While a ``torch.profiler``
session records, it opens a host range named ``dctpu.<name>`` in the
profiler's own events, on the clock of the device's kernels and copies;
otherwise it costs one check of the profiler's flag. The range is
``RecordFunctionFast``'s, which gives the device's timeline no copy of it:
the device events of a traced call are the same with the spans as
without.

:class:`Stages` is ``codec/api.py``'s ``stage_ms``: each stage is a span
and, when a dict is given, adds its milliseconds there (CUDA events on a
card, the host clock on the CPU). Spans nested in a stage go to the
profiler only, so that a sum over ``stage_ms`` counts no time twice.

The names, by where they are opened:

* ``codec/api.py``: the stages (``host_build_blocks``, ``upload``,
  ``select``, ``emit_<coder>``, ``compact``, ``download``,
  ``host_frame_assembly``; ``host_block_table``, ``decode_<coder>``,
  ``reconstruct``, ``host_split_streams``, ``host_flatten``), around the
  device stages of each range of blocks ``range`` (on a decode it holds
  the caller's download of the range too), inside the stages the host
  feed's ``feed.gather`` (with ``feed.cast`` inside it when a stream has
  to be cast to int32) and ``feed.native``, the assembly's
  ``assembly.columns`` and ``assembly.stream_dir``,
  ``download.streams``, a range's copies straight into the streams' own
  arrays (``decompress`` of long streams), ``download.flat``, a range's
  copy into one array of all samples (``decompress_flat``, and
  ``decompress`` of short streams), and ``split.copies``, the copies of
  short streams out of that array (with ``split.parallel`` inside it when
  they are cut over more than one host thread);
* ``format/frame.py``: ``write_frame`` with ``.tables``, ``.payload`` and
  ``.crc``; ``read_frame`` with ``.sections``, ``.crc``, ``.tables`` and
  ``.payload``; inside either ``.crc``, ``crc.parallel`` for each section
  whose CRC is cut over more than one host thread;
* each host read of device results, ``sync.<what>``: ``sync.coders``,
  ``sync.total``, ``sync.words``, ``sync.choice``, ``sync.k`` and
  ``sync.bit_len`` of an encode range, ``sync.flags`` and
  ``sync.download`` of a decode range, ``sync.flag`` of the block
  API's compaction. :meth:`Stages.finish`'s waits are the tracer's own
  and have none.
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "dctpu."


def recording() -> bool:
    """Whether a ``torch.profiler`` session is recording in this thread."""
    return torch._C._autograd._profiler_enabled()


def _range(name: str):
    """The profiler's host range of that name, as a context manager."""
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def span(name: str):
    """The step ``name``: a range ``dctpu.<name>`` while the profiler
    records, nothing otherwise."""
    if not recording():
        yield
        return
    with _range(PREFIX + name):
        yield


class Stages:
    """Adds per-stage milliseconds into ``out`` (a dict) when one is given;
    CUDA events are recorded on the current stream of ``device``. Each
    stage is a :func:`span` too."""

    def __init__(self, out, device):
        self.out = out
        self.device = torch.device(device)
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span(name):
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
