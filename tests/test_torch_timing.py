"""The port's honest timing (`train/timing.py`) against the JAX package's
(`train/timing.py`), and the port's spans and trace
(`train/profiling.py`).

The estimator cases are JAX's tests/test_timing.py's, run through both
packages with the same synthetic `run_window` (a clock of constant
overhead plus a per-step time; a spike in one repeat): the results must be
equal. No case times real work over short windows: JAX's own case with
windows of 4 and 12 failed on a loaded machine, so `measure_peak_flops`'s
arithmetic is checked through an injected window, and the timed steps
are trivial ones whose times are only checked to be finite. The spans are
checked against the CPU profiler's own events, and in GAN steps and an
eager K-step program at a tiny width.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.config import ModelConfig
from speech2affective_gestures_torch.data.ted_db import DeviceDataset, PackedDataset
from speech2affective_gestures_torch.train import builder
from speech2affective_gestures_torch.train import profiling as tprof
from speech2affective_gestures_torch.train import timing as ttiming
from speech2affective_gestures_tpu.train import timing as jtiming


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while these tests run (beside the other test
    files' worker processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fetch_scalar_first_element_of_first_leaf():
    """JAX's leaf order: a dict's values by sorted key."""
    tree_t = {"b": torch.zeros(2), "a": torch.arange(6.0).reshape(2, 3) + 5.0}
    tree_j = {"b": jnp.zeros(2), "a": jnp.arange(6.0).reshape(2, 3) + 5.0}
    assert ttiming.fetch_scalar(tree_t) == jtiming.fetch_scalar(tree_j) == 5.0
    assert ttiming.fetch_scalar(torch.tensor(3)) == jtiming.fetch_scalar(jnp.asarray(3)) == 3.0
    nested_t = [("names", "x"), {"k": [torch.full((2, 2), 7.0)]}]
    nested_j = [{"k": [jnp.full((2, 2), 7.0)]}]
    assert ttiming.fetch_scalar(nested_t) == jtiming.fetch_scalar(nested_j) == 7.0
    # a StepProgram's (metric names, (K, n) tensor)
    assert ttiming.fetch_scalar((["loss", "dis"], torch.tensor([[2.5, 1.0]]))) == 2.5
    with pytest.raises(ValueError):
        ttiming.fetch_scalar({"a": 1.0})


def test_marginal_step_time_cancels_constant_overhead():
    for mod in (ttiming, jtiming):
        calls = []

        def run_window(n):
            calls.append(n)
            return 0.7 + 0.01 * n

        res = mod.marginal_step_time(run_window, windows=(20, 60), reps=3)
        assert res["sec_per_step"] == pytest.approx(0.01)
        assert res["steps_per_sec"] == pytest.approx(100.0)
        assert calls == [20, 60] * 3
    got = ttiming.marginal_step_time(lambda n: 0.7 + 0.01 * n)
    want = jtiming.marginal_step_time(lambda n: 0.7 + 0.01 * n)
    assert got == want


def test_marginal_step_time_median_rejects_spikes():
    def window_fn():
        seq = iter([(0.0, 1.0), (0.0, 1.0), (0.0, 41.0)])
        pair = None

        def run_window(n):
            nonlocal pair
            if n == 20:
                pair = next(seq)
                return pair[0]
            return pair[1]
        return run_window

    got = ttiming.marginal_step_time(window_fn(), windows=(20, 60), reps=3)
    want = jtiming.marginal_step_time(window_fn(), windows=(20, 60), reps=3)
    assert got == want
    assert got["sec_per_step"] == pytest.approx(1.0 / 40)
    assert len(got["slope_samples"]) == 3


def test_marginal_step_time_rejects_bad_windows():
    with pytest.raises(AssertionError):
        ttiming.marginal_step_time(lambda n: 0.0, windows=(5, 5))


@pytest.mark.parametrize("size", [256, 4096])
def test_measure_peak_flops_arithmetic(size):
    """2 size^3 flops an iteration over the slope of an injected window."""
    calls = []

    def run_window(n):
        calls.append(n)
        return 0.03 + n * 2.5e-4

    peak = ttiming.measure_peak_flops(size, windows=(200, 600), reps=5, run_window=run_window)
    assert peak == pytest.approx(2.0 * size ** 3 / 2.5e-4)
    assert calls == [200, 600] * 5


def test_measure_peak_flops_defaults_to_the_card():
    """No card here: the default device raises rather than timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttiming.measure_peak_flops(8, windows=(1, 2), reps=1)


def test_measure_peak_flops_chain_on_the_cpu():
    """The chain itself runs where asked (a tiny size on the CPU): its
    value stays bounded and the estimate is a finite number."""
    peak = ttiming.measure_peak_flops(16, torch.float32, windows=(2, 6), reps=1,
                                      device="cpu")
    assert np.isfinite(peak)


def test_time_compiled_step_counts_real_iterations():
    counts = {}
    for name, mod, zero, inc in (
            ("torch", ttiming, torch.zeros(()), lambda x: x + 1.0),
            ("jax", jtiming, jnp.zeros(()), jax.jit(lambda x: x + 1.0))):
        n_exec = 0

        def step(x, inc=inc):
            nonlocal n_exec
            n_exec += 1
            return inc(x)

        res = mod.time_compiled_step(step, zero, windows=(3, 7), reps=2)
        counts[name] = n_exec
        assert np.isfinite(res["sec_per_step"])
        assert res["windows"] == (3, 7) and res["reps"] == 2
    # warm (1) + reps * (3 + 7)
    assert counts["torch"] == counts["jax"] == 1 + 2 * (3 + 7)


def test_time_compiled_step_carry_factory_called_per_window():
    made = {}
    for name, mod, zeros in (("torch", ttiming, torch.zeros), ("jax", jtiming, jnp.zeros)):
        n_made = 0

        def make(zeros=zeros):
            nonlocal n_made
            n_made += 1
            return zeros(())

        mod.time_compiled_step(lambda x: x + 1.0, make, windows=(2, 4), reps=2)
        made[name] = n_made
    # warm (1) + 2 reps * 2 windows
    assert made["torch"] == made["jax"] == 5


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    """`trace` writes <log_dir>/trace.json; `annotate`'s span is in it."""
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("s2ag_span"):
            (torch.ones(16, 16) @ torch.ones(16, 16)).sum().item()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "s2ag_span" in names
    assert any(str(n).startswith("aten::mm") for n in names)


def test_trace_writes_the_program_spans_on_its_timeline(tmp_path):
    """Each span is an event of its own, nested in time as recorded, and
    holds the profiler's event of the work it opened around."""
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("outer", step=7):
            with tprof.annotate("inner"):
                with torch.profiler.record_function("work"):
                    (torch.ones(16, 16) @ torch.ones(16, 16)).sum().item()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert inner["args"] == {"id": inner["args"]["id"], "parent": outer["args"]["id"],
                             "step": 7}
    assert outer["args"]["parent"] is None and outer["args"]["step"] == 7
    work = next(e for e in events if e.get("name") == "work" and e.get("ph") == "X")
    assert outer["ts"] <= inner["ts"] <= work["ts"]
    assert work["ts"] + work["dur"] <= inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert tprof.drain() == []


def test_annotate_without_a_profiler_records_nothing():
    tprof.drain()
    off = tprof.annotate("a")
    assert tprof.annotate("b", step=3) is off
    with off:
        with tprof.annotate("c"):
            pass
    assert tprof.drain() == []


def test_span_holds_its_record_function_on_the_kineto_clock():
    """Placed by its origin, Kineto's own trace start, a span contains the
    profiler's event of the `record_function` range it was opened around,
    and shows in the profiler's events under its own name."""
    tprof.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.annotate("outer"):
            with torch.profiler.record_function("inner"):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum().item()
    (span,) = tprof.drain()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    assert span.origin_ns == start_ns
    inner = next(e for e in prof.events() if e.name == "inner")
    assert (span.start_ns - start_ns) / 1e3 <= inner.time_range.start
    assert inner.time_range.end <= (span.end_ns - start_ns) / 1e3
    assert span.end_ns - span.start_ns < 10**9
    outer = next(e for e in prof.events() if e.name == "outer")
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.trace_start_ns()


def test_each_session_gives_its_spans_its_origin():
    """Sessions back to back, with no span between them: each span takes
    its own session's trace start. A profiler that no caller holds in a
    variable leaves the origin unknown."""
    tprof.drain()

    def spans():
        with tprof.annotate("a"):
            with tprof.annotate("b"):
                pass

    first, second = _profiled(spans), _profiled(spans)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans()
    got = tprof.drain()
    assert [(s.name, s.origin_ns) for s in got] == [
        ("a", first), ("b", first), ("a", second), ("b", second), ("a", None), ("b", None)]
    assert first < second


@pytest.fixture(scope="module")
def tiny_steps():
    """Per variant, a GAN step at width 16 and batch 4 on the CPU, and a
    device loader over 8 random rows."""
    cfg = ModelConfig(batch_size=4, hidden_size=16, hidden_size_s2eg=16, wordembed_dim=16)
    rng = np.random.default_rng(0)
    n = 8
    packed = PackedDataset(
        extended_word_seq=rng.integers(0, 50, (n, cfg.n_poses)),
        vec_seq=rng.normal(size=(n, cfg.n_poses, 27)).astype(np.float32) * 0.1,
        audio=rng.integers(-3000, 3000, (n, cfg.expected_audio_length)).astype(np.int16),
        audio_max=np.full(n, 0.3),
        mfcc_features=rng.normal(size=(n, cfg.num_mfcc_combined,
                                       cfg.mfcc_length)).astype(np.float16),
        vid_indices=rng.integers(0, 10, n))
    steps = {v: builder.init_training(cfg, 0, n_words=50, n_speakers=10, device="cpu",
                                      variant=v)["step"] for v in ("s2ag", "abl_aff")}
    return steps, DeviceDataset(packed, "cpu")


GAN_PHASES = ["gan.dis.forward", "gan.dis.backward", "gan.dis.update"]
GEN_PHASES = ["gan.gen.forward", "gan.gen.backward", "gan.gen.update", "gan.tri.forward"]


@pytest.mark.parametrize("variant", ["s2ag", "abl_aff"])
@pytest.mark.parametrize("gan_on,fused", [(True, False), (False, False), (True, True)])
def test_gan_step_records_its_phases(tiny_steps, variant, gan_on, fused):
    """The batch's span, then `gan.train_step` with its phases as children
    in call order, every span of the step carrying the step's count and
    all the session's origin."""
    steps, data = tiny_steps
    step = copy.copy(steps[variant])
    step.cfg = dataclasses.replace(step.cfg, fused_pass=fused)
    tprof.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step.train_step(data.batch(np.arange(4), np.arange(4)),
                        torch.Generator().manual_seed(0), gan_on=gan_on)
    spans = tprof.drain()
    assert [s.name for s in spans] == (["data.batch", "gan.train_step"]
                                       + (GAN_PHASES if gan_on else []) + GEN_PHASES)
    top = spans[1]
    assert [s.parent for s in spans] == [None, None] + [top.id] * (len(spans) - 2)
    # the batch is gathered before the step it feeds, knowing no step
    assert [s.step for s in spans] == [None] + [step.step - 1] * (len(spans) - 1)
    assert {s.origin_ns for s in spans} == {prof.profiler.kineto_results.trace_start_ns()}
    for a, b in zip(spans[2:], spans[3:]):
        assert top.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= top.end_ns


def test_eager_step_program_records_its_steps(tiny_steps):
    from speech2affective_gestures_torch.train.step_program import StepProgram

    steps, data = tiny_steps
    step = steps["abl_aff"]
    prog = StepProgram(step, data, torch.Generator().manual_seed(0))
    first = step.step
    tprof.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prog.run(np.arange(8).reshape(2, 4), np.arange(8).reshape(2, 4) % 10, True)
    spans = tprof.drain()
    run = spans[0]
    assert (run.name, run.parent, run.step) == ("program.run", None, first)
    children = [s for s in spans if s.parent == run.id]
    assert [(s.name, s.step) for s in children] == [("gan.train_step", first),
                                                     ("gan.train_step", first + 1)]
    assert len(spans) == 1 + 2 * (1 + len(GAN_PHASES) + len(GEN_PHASES))
