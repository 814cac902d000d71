"""The port's honest timing and step timer (`train/timing.py`,
`train/profiling.py`) against the JAX package's (`train/timing.py`,
`train/profiling.py`).

The estimator cases are JAX's tests/test_timing.py's, run through both
packages with the same synthetic `run_window` (a clock of constant
overhead plus a per-step time; a spike in one repeat): the results must be
equal. No case times real work over short windows: JAX's own case with
windows of 4 and 12 failed on a loaded machine, so `measure_peak_flops`'s
arithmetic is checked through an injected window, and the step timers run
trivial steps whose times are only checked to be positive or of a sane
magnitude.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.train import profiling as tprof
from speech2affective_gestures_torch.train import timing as ttiming
from speech2affective_gestures_tpu.train import profiling as jprof
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


def test_step_timer_value_fetch_sync():
    for timer, f, x in ((tprof.StepTimer(), lambda x: x * 2.0, torch.ones(8, 8)),
                        (jprof.StepTimer(), jax.jit(lambda x: x * 2.0), jnp.ones((8, 8)))):
        for _ in range(3):
            timer.start()
            y = f(x)
            timer.stop(y)
        with timer.measure(y):
            y = f(x)
        s = timer.summary()
        assert s["steps"] == 4
        assert s["steps_per_sec"] > 0
        assert set(s) == {"steps", "mean_s", "p50_s", "p95_s", "steps_per_sec"}
    assert tprof.StepTimer().summary() == jprof.StepTimer().summary() == {}


def test_step_timer_summary_matches_jax():
    """The same recorded times give the same summary in both packages."""
    times = [0.1, 0.3, 0.2, 0.25]
    a, b = tprof.StepTimer(), jprof.StepTimer()
    a.times, b.times = list(times), list(times)
    assert a.summary() == b.summary()


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    """`trace` writes <log_dir>/trace.json; `annotate`'s span is in it."""
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("s2ag_span"):
            (torch.ones(16, 16) @ torch.ones(16, 16)).sum().item()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "s2ag_span" in names
    assert any(str(n).startswith("aten::mm") for n in names)
