"""Tracing and step timing (JAX `train/profiling.py`).

- `trace(log_dir)`: a context that records `torch.profiler`'s CPU and,
  with a card, CUDA activities, and writes them on exit as a Chrome trace,
  `<log_dir>/trace.json` (kernel names, launches, device spans);
- `annotate(name)`: a named span in that trace
  (`torch.profiler.record_function`);
- `StepTimer`: per-step wall times, each ended by a value fetch
  (`timing.fetch_scalar`), so that a step's interval covers its kernels.
  A timed step thus includes its launches and the fetch: an upper bound.
  For throughput use `timing.marginal_step_time`, which cancels the
  constant part.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .timing import fetch_scalar


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write `<log_dir>/trace.json`. Yields the
    `torch.profiler.profile`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Collects per-step wall times (seconds), synchronized by a value fetch.

    Pass the step's result (its metrics dict, say) to `stop`/`measure`: the
    timer fetches one scalar of it, so the interval covers the step's
    kernels. `sync=False` records the launch times alone."""

    def __init__(self, sync: bool = True):
        self.times: list[float] = []
        self.sync = sync
        self._t0: float | None = None

    @contextlib.contextmanager
    def measure(self, result=None):
        t0 = time.perf_counter()
        yield
        if self.sync and result is not None:
            fetch_scalar(result)
        self.times.append(time.perf_counter() - t0)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if self.sync and result is not None:
            fetch_scalar(result)
        assert self._t0 is not None
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps_per_sec": float(1.0 / t.mean()),
        }
