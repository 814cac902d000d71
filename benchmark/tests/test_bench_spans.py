"""The readers of the program's spans (`metrics/_spans.py` and the readers
beside it) on a synthetic trace whose spans and gaps are known: the idle
given to the innermost span, a gap across a span's end split, the phases
and the remainder adding up to the union's idle, the spans placed by their
session's origin, the traced pass told from the labelling pass and from a
session taken again, the host's wait for the device left out of its step
time, and nothing read without a recorder, spans or origin. Then both
training cells through the driver on the CPU with the program's spans
recorded."""

import itertools
import sys
import time

import pytest

from bench_tiny import core, run_tiny  # noqa: F401
from benchmark.metrics import _spans
from speech2affective_gestures_torch.train import profiling

T0 = 1_800_000_000_000_000_000     # the trace's time 0, epoch ns
BASE = 100.0                       # the traced pass's first span, µs after it
NEW = ["host_step_ms.train", "data_idle_ms.train", "forward_idle_ms.train",
       "backward_idle_ms.train", "update_idle_ms.train"]
IDS = itertools.count()


class Spans:
    """Spans on the trace's clock in µs, made into the recorder's, of the
    session whose time 0 is `origin_us` µs after T0 (None: no origin)."""

    def __init__(self, origin_us: float | None = 0.0):
        self.out = []
        self.origin = None if origin_us is None else T0 + int(origin_us * 1e3)

    def add(self, name, start_us, end_us, parent=None, step=0):
        origin = T0 if self.origin is None else self.origin
        span = profiling.Span(next(IDS), name,
                              origin + int((BASE + start_us) * 1e3),
                              origin + int((BASE + end_us) * 1e3),
                              parent.id if parent else None, step, self.origin)
        self.out.append(span)
        return span


def one_step(spans, at, step):
    """A per-step unit at `at` µs: data.batch [0, 10], gan.train_step
    [10, 1000] with its phases."""
    spans.add("data.batch", at, at + 10, step=step)
    top = spans.add("gan.train_step", at + 10, at + 1000, step=step)
    for name, s, e in (("gan.dis.forward", 20, 300), ("gan.dis.backward", 300, 500),
                       ("gan.dis.update", 500, 600), ("gan.gen.forward", 600, 800),
                       ("gan.gen.backward", 800, 900), ("gan.gen.update", 900, 950),
                       ("gan.tri.forward", 950, 990)):
        spans.add(name, at + s, at + e, top, step)


# busy stretches of one unit, µs after its start: the upload, then kernels
BUSY = [(0, 5), (30, 290), (310, 490), (520, 590), (610, 790), (810, 880), (920, 940),
        (960, 985)]


def trace_of(units, lead_us=0.0, tail_us=0.0):
    """The device's events of `units` per-step units 1000 µs apart from
    BASE, then the metrics' read-back 20 µs after the last unit, in a host
    window that opened `lead_us` before the first span and closed
    `tail_us` after the read-back's end."""
    dev = [("k", BASE + u * 1000 + s, BASE + u * 1000 + e) for u in range(units)
           for s, e in BUSY]
    dev.append(("Memcpy DtoH (Device -> Pageable)", BASE + units * 1000 + 20,
                BASE + units * 1000 + 22))
    last = max(e for _, _, e in dev)
    window_us = last + tail_us - (BASE - lead_us)
    busy = core.union_seconds([(s, e) for _, s, e in dev])
    return {"device": dev, "window_s": window_us / 1e6, "busy_s": busy / 1e6,
            "launches": len(dev), "by_op": {}}


def ctx_of(trace, steps, k=1):
    return {"trace": trace, "steps": steps, "traffic": {"steps_per_program": k}}


@pytest.fixture
def recorded(monkeypatch):
    """Spans handed to the readers as the program's recorder would."""
    box = {}
    monkeypatch.setattr(profiling, "drain", lambda: box.pop("spans", []))
    return box


def read(ctx):
    specs = [{"name": n, "unit": "ms"} for n in NEW + ["idle_share.train"]]
    return {k: v["value"] for k, v in core.read_metrics(specs, ctx).items()}


def test_idle_goes_to_the_innermost_span_and_splits_at_span_ends(recorded):
    spans = Spans()
    one_step(spans, 0, 5)
    one_step(spans, 1000, 6)
    recorded["spans"] = spans.out
    ctx = ctx_of(trace_of(2), steps=2)
    by = _spans.idle_by_phase(ctx)
    # a unit's idle: data.batch 5-10; gan.train_step's own 10-20 and
    # 990-1000; dis.forward 20-30, 290-300; dis.backward 300-310, 490-500;
    # dis.update 500-520, 590-600; gen.forward 600-610, 790-800;
    # gen.backward 800-810, 880-900 and gen.update 900-920 (the gap 880-920
    # split at the span's end), 940-950; tri.forward 950-960, 985-990.
    # 2000-2020, before the read-back, lies outside every span.
    assert by["data"] == pytest.approx(2 * 5)
    assert by["forward"] == pytest.approx(2 * (10 + 10 + 10 + 10 + 10 + 5))
    assert by["backward"] == pytest.approx(2 * (10 + 10 + 10 + 20))
    assert by["update"] == pytest.approx(2 * (20 + 10 + 20 + 10))
    assert by["none"] == pytest.approx(2 * (10 + 10) + 20)
    assert by["total"] == pytest.approx(2022 - 2 * 810 - 2)
    got = read(ctx)
    assert got["backward_idle_ms.train"] == pytest.approx(by["backward"] / 1e3 / 2)
    assert got["update_idle_ms.train"] == pytest.approx(by["update"] / 1e3 / 2)
    assert got["host_step_ms.train"] == pytest.approx(0.990)


def test_phases_and_remainder_are_the_unions_idle(recorded):
    """Also with idle outside every span, at the window's two ends."""
    spans = Spans()
    for u in range(8):
        one_step(spans, u * 1000, u)
    recorded["spans"] = spans.out
    trace = trace_of(8, lead_us=40, tail_us=25)
    ctx = ctx_of(trace, steps=8)
    got = read(ctx)
    by = _spans.idle_by_phase(ctx)
    window_us = trace["window_s"] * 1e6
    idle_us = got["idle_share.train"] / 100 * window_us
    assert sum(by[p] for p in _spans.PHASES) + by["none"] == pytest.approx(idle_us)
    assert by["total"] == pytest.approx(idle_us)
    assert sum(got[n] for n in NEW[1:]) * 8 * 1e3 <= idle_us


def test_spans_sit_on_the_trace_by_their_sessions_origin(recorded):
    """Wherever the host's window opened and closed, a span's place is its
    epoch ns less its session's time 0."""
    spans = Spans()
    for u in range(4):
        one_step(spans, u * 1000, u)
    recorded["spans"] = spans.out
    got = _spans.traced(ctx_of(trace_of(4, lead_us=40, tail_us=25), steps=4))
    assert got["origin_ns"] == T0
    assert got["spans"][0] == ("data.batch", pytest.approx(BASE), pytest.approx(BASE + 10))
    assert got["spans"][-1][2] == pytest.approx(BASE + 3990)


def test_the_traced_pass_is_told_from_the_other_sessions(recorded):
    """A session taken again before it (no device events were recorded
    there) and the one-unit labelling pass after it: only the traced
    pass's spans are read, on its own origin."""
    retried, traced_, label = Spans(-50_000), Spans(), Spans(60_000)
    for u in range(4):
        one_step(retried, u * 1000, u)
        one_step(traced_, u * 1000, 4 + u)
    one_step(label, 0, 8)
    recorded["spans"] = retried.out + traced_.out + label.out
    got = _spans.traced(ctx_of(trace_of(4), steps=4))
    assert [n for n, _, _ in got["spans"]] == [s.name for s in traced_.out]
    assert got["origin_ns"] == T0
    assert got["spans"][0][1] == pytest.approx(BASE)
    assert got["host_ns"] == 4 * 990_000


def test_the_hosts_wait_for_the_device_is_not_host_time(recorded):
    """`host_step_ms.train.graph`: `program.run` less its
    `program.replay`, over the steps."""
    spans = Spans()
    for u in range(2):
        run = spans.add("program.run", u * 1000, u * 1000 + 900, step=4 * u)
        spans.add("program.replay", u * 1000 + 5, u * 1000 + 805, run, 4 * u)
    recorded["spans"] = spans.out
    ctx = ctx_of(trace_of(2), steps=8, k=4)
    got = core.read_metrics([{"name": "host_step_ms.train.graph", "unit": "ms"}], ctx)
    assert got["host_step_ms.train.graph"]["value"] == pytest.approx(2 * 0.1 / 8)


@pytest.mark.parametrize("case", ["no recorder", "no spans", "no origin", "no trace",
                                  "one unit", "wrong count"])
def test_every_reader_finds_nothing(recorded, monkeypatch, case):
    spans = Spans()
    one_step(spans, 0, 0)
    one_step(spans, 1000, 1)
    recorded["spans"] = spans.out
    ctx = ctx_of(trace_of(2), steps=2)
    if case == "no recorder":
        monkeypatch.delattr(profiling, "drain")
    elif case == "no spans":
        recorded["spans"] = []
    elif case == "no origin":
        recorded["spans"] = [x._replace(origin_ns=None) for x in spans.out]
    elif case == "no trace":
        ctx["trace"] = None
    elif case == "one unit":
        ctx["steps"] = 1
    else:
        ctx["steps"] = 3
    got = read(ctx)
    assert not set(got) & set(NEW), got


def _cpu_profile(fn, device, host=False, attempts=3, agree=lambda ok: ok):
    """`core.profile` on the CPU: the CPU profiler's aten ops in place of
    the device's operations, the last one standing for the synchronize
    that closes the window. It waits 50 ms first, as the
    card's profiler takes tens of ms to start."""
    import torch

    time.sleep(0.05)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.ones(1).add_(1)
        wall = time.perf_counter() - t0
    ops = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("aten::")]
    return {"device": ops, "host": ops if host else [], "wall_s": wall}


@pytest.mark.parametrize("workload,names", [
    ("train.s2ag.f32", NEW), ("train.abl_aff.mixed_k4", ["host_step_ms.train.graph"])])
def test_training_cells_read_the_spans_through_the_driver(monkeypatch, workload, names):
    """A traced tiny run whose profiler is the CPU's: the cell's span
    metrics are on the line. Without a profiler session (the CPU run as
    the benchmark makes it) they are left out."""
    result, _ = run_tiny(workload, 4_100_000_003, True)
    assert not set(result["metrics"]) & set(names)
    monkeypatch.setattr(core, "profile", _cpu_profile)
    files = core.cell_files(workload)
    k = files["traffic"]["steps_per_program"]
    result, _ = run_tiny(workload, 4_100_000_003, True, traffic={"trace_steps": 2 * k})
    assert set(names) <= set(result["metrics"]), result["metrics"]
    for n in names:
        assert result["metrics"][n]["unit"] == "ms" and result["metrics"][n]["value"] >= 0
    assert profiling.drain() == []


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
