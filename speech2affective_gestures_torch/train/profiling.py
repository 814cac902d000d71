"""The program's spans and its Chrome trace (JAX `train/profiling.py`).

- `annotate(name, step=None)`: a span of the program, recorded only while
  a `torch.profiler` session is open (one read of the profiler's own flag)
  and no CUDA graph is being captured on the current stream. A span keeps
  its name, its start and end on `time.time_ns()`'s clock (the epoch
  nanoseconds that Kineto stamps its events with), the span it opened
  inside, the `GanStep.step` it belongs to (its own `step`, else its
  parent's) and its session's origin (below). A recorded span also opens
  a `record_function` of its name, so the profiler's own views
  (`key_averages`, its Chrome trace) show it. With recording off it
  returns one shared no-op context: no allocation, no device work, no
  `record_function`.
- A span's `origin_ns` is its session's `trace_start_ns()`: the epoch ns
  of time 0 of that session's events, whose times `prof.events()` gives
  in µs after it, so `(start_ns - origin_ns) / 1e3` places the span among
  them. torch keeps no handle to the open profiler: at a session's first
  span the recorder finds it among the local variables of the span's
  callers (`trace` hands its own over). Where none is found, or the
  session is still open when the span is drained, `origin_ns` is None.
- `drain()`: the spans closed so far, in the order they opened, taken out
  of memory (the benchmark's span readers call it).
- `trace(log_dir)`: a context that records `torch.profiler`'s CPU and,
  with a card, CUDA activities, and writes them on exit as a Chrome trace,
  `<log_dir>/trace.json` (kernel names, launches, device spans), with the
  spans the block recorded as events of their own under their names.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _torch_profiler


class Span(NamedTuple):
    """A closed span (module docstring); `parent` is its parent's `id`."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    step: int | None
    origin_ns: int | None


class _Off:
    """The context `annotate` returns with recording off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """One recorded span; its record is [id, name, start, end, parent,
    step, session's profiler]."""

    __slots__ = ("recorder", "rec", "function")

    def __init__(self, recorder: Recorder, rec: list):
        self.recorder, self.rec = recorder, rec
        self.function = torch.profiler.record_function(rec[1])

    def __enter__(self):
        self.function.__enter__()
        self.recorder._push(self.rec)
        self.rec[2] = time.time_ns()

    def __exit__(self, *exc):
        self.rec[3] = time.time_ns()
        # `with` blocks close in the order opposite to their opening
        self.recorder._stack.pop()
        self.function.__exit__(*exc)
        return False


def _open_profiler(frame):
    """The open session's `torch.autograd.profiler.profile`, held (or held
    by a `torch.profiler.profile`) in a local variable of `frame` or of a
    frame that called it; else None."""
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                value = value.profiler
            if (isinstance(value, _torch_profiler.profile) and value.entered
                    and value.kineto_results is None):
                return value
        frame = frame.f_back
    return None


def _origin_ns(session) -> int | None:
    results = None if session is None else session.kineto_results
    return None if results is None else results.trace_start_ns()


class Recorder:
    """The spans of one process, kept in memory until drained."""

    def __init__(self):
        self._records: list[list] = []
        self._stack: list[list] = []
        self._ids = itertools.count()
        # the open session's torch.autograd.profiler.profile
        self._session = None

    def span(self, name: str, step: int | None = None):
        if not _torch_profiler._is_profiler_enabled:
            return _OFF
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            return _OFF
        session = self._session
        if session is None or session.kineto_results is not None:
            # a session's first span (or one whose profiler was not found)
            session = self._session = _open_profiler(sys._getframe(1))
        return _Open(self, [next(self._ids), name, None, None, None, step, session])

    def bind(self, prof: torch.profiler.profile):
        """Give the spans of `prof`'s session its origin."""
        self._session = prof.profiler

    def _push(self, rec: list):
        if self._stack:
            parent = self._stack[-1]
            rec[4] = parent[0]
            if rec[5] is None:
                rec[5] = parent[5]
        self._stack.append(rec)
        self._records.append(rec)

    def drain(self) -> list[Span]:
        """The closed spans in the order they opened; spans still open
        stay."""
        records = self._records
        self._records = [r for r in records if r[3] is None]
        if _origin_ns(self._session) is not None:
            # its session closed: let its events go
            self._session = None
        return [Span(*r[:6], _origin_ns(r[6])) for r in records if r[3] is not None]


RECORDER = Recorder()


def annotate(name: str, step: int | None = None):
    """A span named `name` (module docstring) around a `with` block."""
    return RECORDER.span(name, step)


def drain() -> list[Span]:
    return RECORDER.drain()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write `<log_dir>/trace.json` with the
    block's spans in it. Yields the `torch.profiler.profile`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    drain()
    with torch.profiler.profile(activities=activities) as prof:
        RECORDER.bind(prof)
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the trace's times are microseconds after its base (0: the epoch)
    base = doc.get("baseTimeNanoseconds", 0)
    doc["traceEvents"] += [
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": os.getpid(),
         "tid": "program spans", "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "step": s.step}}
        for s in drain()]
    with open(path, "w") as f:
        json.dump(doc, f)
