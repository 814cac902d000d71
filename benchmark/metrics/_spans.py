"""What the readers of the program's spans share: the spans of the traced
sub-window (`train.profiling.drain()`), placed on the device trace's
clock, and the device's idle time split by the phase span innermost at
each instant of it.

Each drained span carries its profiling session's `trace_start_ns()`
(`origin_ns`), the epoch ns of that session's time 0; the device events
the readers get are µs after it, so `(start_ns - origin_ns) / 1e3` puts a
span on their timeline on Kineto's own clock, with no offset to guess.
The spans of every session since the last drain come back together: the
traced pass, then the one-unit pass that labels the breakdown's gaps (and
a session that recorded no device activity, taken again); the traced pass
is the last session with the sub-window's count of units, which has to be
more than the labelling pass's one.

Where the program records no spans (one without `profiling.drain`), its
spans carry no origin, or no session holds the sub-window's units, every
reader returns None."""

from __future__ import annotations

import bisect

STEP_SPANS = ("program.run", "gan.train_step")
# spans inside a step span whose host time is not the host's own work:
# the graph's launch, which waits for the device once its queue holds
# earlier replays, and under the device trace costs the profiler ~30 ms
# (~1.5 ms untraced, on an H100)
WAIT_SPANS = ("program.replay",)
PHASES = ("data", "forward", "backward", "update")


def _drain():
    try:
        from speech2affective_gestures_torch.train import profiling
    except ImportError:
        return None
    drain = getattr(profiling, "drain", None)
    return None if drain is None else drain()


def step_spans(spans) -> list:
    """The outermost step-level spans: `program.run` where there is one,
    else `gan.train_step`."""
    for name in STEP_SPANS:
        found = [s for s in spans if s.name == name and s.parent is None]
        if found:
            return found
    return []


def sessions(spans) -> list[list]:
    """The spans grouped by their session (`origin_ns`), in the sessions'
    order; spans with no origin are left out."""
    groups = {}
    for s in spans:
        origin = getattr(s, "origin_ns", None)
        if origin is not None:
            groups.setdefault(origin, []).append(s)
    return [groups[o] for o in sorted(groups)]


def traced(ctx) -> dict | None:
    """{"spans": the traced pass's spans as (name, start_us, end_us) on
    the device trace's clock, "host_ns": host ns in its step-level spans
    outside WAIT_SPANS, "origin_ns": the epoch ns of the trace's time 0},
    or None. Drained once, kept in ctx for the other readers."""
    if "program_spans" not in ctx:
        ctx["program_spans"] = _traced(ctx, _drain())
    return ctx["program_spans"]


def _traced(ctx, spans):
    trace = ctx.get("trace")
    if not spans or not trace or not trace.get("device") or not trace.get("window_s"):
        return None
    units = ctx["steps"] // ctx["traffic"]["steps_per_program"]
    if units < 2:
        # as many units as the labelling pass: the two cannot be told apart
        return None
    found = [g for g in sessions(spans) if len(step_spans(g)) == units]
    if not found:
        return None
    spans = found[-1]
    origin = spans[0].origin_ns
    steps = step_spans(spans)
    tops = {s.id for s in steps}
    waits = [s for s in spans if s.name in WAIT_SPANS and s.parent in tops]
    return {"spans": [(s.name, (s.start_ns - origin) / 1e3, (s.end_ns - origin) / 1e3)
                      for s in spans],
            "host_ns": (sum(s.end_ns - s.start_ns for s in steps)
                        - sum(s.end_ns - s.start_ns for s in waits)),
            "origin_ns": origin}


def phase_of(name: str) -> str | None:
    if name == "data.batch":
        return "data"
    parts = name.split(".")
    if len(parts) == 3 and parts[0] == "gan" and parts[2] in PHASES:
        return parts[2]
    return None


def innermost(spans) -> list[tuple]:
    """[(start, end, name)]: the stretches of time in which the span
    `name` of the (name, start, end) `spans` was the innermost one open,
    in order. Spans nest; at one instant ends come before starts, and of
    two starts the longer span (the parent) first."""
    events = sorted([(s, 1, -e, i) for i, (_, s, e) in enumerate(spans)]
                    + [(e, 0, 0, i) for i, (_, _, e) in enumerate(spans)])
    out, stack, at = [], [], None
    for t, opening, _, i in events:
        if stack and t > at:
            out.append((at, t, spans[stack[-1]][0]))
        at = t
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def idle(device, window_us: float) -> list[tuple]:
    """The device's idle intervals in the window that closes at the end of
    its last operation: the complement of the union of its events'
    spans."""
    spans = sorted((s, e) for _, s, e in device)
    end = max(e for _, e in spans)
    out, reach = [], end - window_us
    for s, e in spans:
        if s > reach:
            out.append((reach, s))
        reach = max(reach, e)
    return out


def idle_by_phase(ctx) -> dict | None:
    """Device idle µs of the traced sub-window by phase (PHASES; "none":
    the idle with no phase span innermost, inside `gan.train_step`'s own
    time or outside every span; "total": all of it, idle_share x window),
    or None. A phase with no span in the sub-window is left out."""
    if "idle_by_phase" not in ctx:
        ctx["idle_by_phase"] = _idle_by_phase(ctx)
    return ctx["idle_by_phase"]


def _idle_by_phase(ctx):
    got = traced(ctx)
    if got is None:
        return None
    trace = ctx["trace"]
    gaps = idle(trace["device"], trace["window_s"] * 1e6)
    segments = [(s, e, phase_of(n)) for s, e, n in innermost(got["spans"])]
    starts = [s for s, _, _ in segments]
    out = {p: 0.0 for p in {phase_of(n) for n, _, _ in got["spans"]} if p}
    total = sum(e - s for s, e in gaps)
    for lo, hi in gaps:
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(segments) and segments[i][0] < hi:
            s, e, phase = segments[i]
            overlap = min(e, hi) - max(s, lo)
            if phase and overlap > 0:
                out[phase] += overlap
            i += 1
    out["none"] = total - sum(out.values())
    out["total"] = total
    return out


def phase_idle_ms(ctx, phase: str) -> float | None:
    """Device idle ms a step with `phase` innermost, or None."""
    by = idle_by_phase(ctx)
    if by is None or phase not in by:
        return None
    return by[phase] / 1e3 / ctx["steps"]
