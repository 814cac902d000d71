"""Honest device timing under asynchronous launches (JAX `train/timing.py`).

A CUDA launch returns before its kernel runs, so a host clock read right
after a step times the launches, not the work. The barrier this module
trusts is a value fetch: copying one element of a step's result to the
host cannot return before the kernels that made it have run.

- `fetch_scalar(x)`: the first element of the first tensor leaf of `x`
  copied to the host, the timing barrier.
- `marginal_step_time(run_window)`: the slope estimator. One timed window
  of N iterations takes `t(N) = overhead + N * step_time`, where the
  overhead holds the launch queue's fill and the final fetch; two window
  sizes and `(t(N2) - t(N1)) / (N2 - N1)` cancel it. The median over
  repeats rejects outliers.
- `measure_peak_flops`: the same estimator on a chain of dense products,
  the card's measured ceiling to hold an MFU against beside the spec
  sheet's.
- `time_compiled_step(step, init_carry)`: steps/s of `carry = step(carry)`.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device


def _first_tensor(x):
    """The first tensor leaf of `x` in JAX's leaf order (a dict's values
    by sorted key, a list's or tuple's in order), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        items = [x[k] for k in sorted(x)]
    elif isinstance(x, (list, tuple)):
        items = list(x)
    else:
        return None
    for item in items:
        leaf = _first_tensor(item)
        if leaf is not None:
            return leaf
    return None


def fetch_scalar(x) -> float:
    """The first element of the first tensor leaf of `x` (a tensor, or a
    nested dict, list or tuple of them) as a host float. Only that element
    crosses to the host, and the copy waits for the kernels that made it:
    use it as the timing barrier."""
    leaf = _first_tensor(x)
    if leaf is None:
        raise ValueError("fetch_scalar: no tensor in the argument")
    if leaf.ndim:
        leaf = leaf[(0,) * leaf.ndim]
    return float(leaf.item())


def marginal_step_time(
    run_window: Callable[[int], float],
    windows: tuple[int, int] = (20, 60),
    reps: int = 3,
) -> dict:
    """Per-iteration device time by the two-window slope.

    `run_window(n)` runs n iterations, ends with a value fetch of the last
    result (`fetch_scalar`) and returns the elapsed wall seconds. Returns
    the median slope over `reps` repeats and the samples."""
    n1, n2 = windows
    assert n2 > n1 > 0
    slopes = []
    for _ in range(reps):
        t1 = run_window(n1)
        t2 = run_window(n2)
        slopes.append((t2 - t1) / (n2 - n1))
    slopes = sorted(slopes)
    return {
        "sec_per_step": float(np.median(slopes)),
        "steps_per_sec": float(1.0 / np.median(slopes)),
        "slope_samples": slopes,
        "windows": windows,
        "reps": reps,
    }


def measure_peak_flops(
    size: int = 4096, dtype: torch.dtype = torch.bfloat16,
    windows: tuple[int, int] = (200, 600), reps: int = 5,
    device: str | torch.device | None = None,
    run_window: Callable[[int], float] | None = None,
) -> float:
    """Dense-product FLOP/s on `device` (the card by default), by the slope
    estimator: 2 * size**3 flops an iteration over its seconds.

    Each iteration is `sum((x + c) @ x) * 1e-12` with `x` a constant
    (size, size) matrix of 1/size and `c` the previous iteration's scalar:
    the values stay bounded, the chain keeps the iterations in order, and
    the sum reads every output element, so no part of the product can be
    skipped. `torch.matmul` is the probe here (cuBLAS), the card's ceiling
    for one product; float32 follows `torch.backends.cuda.matmul.allow_tf32`.
    `run_window`, when given, replaces the timed chain (a test's clock)."""
    if run_window is None:
        dev = resolve_device(device)
        x = torch.full((size, size), 1.0 / size, dtype=dtype, device=dev)

        def mm(c):
            return torch.sum(torch.matmul(x + c, x)) * 1e-12

        fetch_scalar(mm(torch.zeros((), dtype=dtype, device=dev)))

        def run_window(n):
            c = torch.zeros((), dtype=dtype, device=dev)
            t0 = time.perf_counter()
            for _ in range(n):
                c = mm(c)
            fetch_scalar(c)
            return time.perf_counter() - t0

    res = marginal_step_time(run_window, windows, reps)
    return 2.0 * size ** 3 / res["sec_per_step"]


def time_compiled_step(
    step: Callable, init_carry, windows: tuple[int, int] = (20, 60),
    reps: int = 3,
) -> dict:
    """Steps/s of `carry = step(carry)` (a dependent chain), by the slope
    estimator; each window ends with a value fetch of its last carry.

    `init_carry` may be a factory of no arguments, called before each
    window outside its timed part (for a step that consumes its carry). One
    untimed step runs first (warm-up: builds, plans, captures)."""
    make = init_carry if callable(init_carry) else (lambda: init_carry)

    def run_window(n):
        carry = make()
        t0 = time.perf_counter()
        for _ in range(n):
            carry = step(carry)
        fetch_scalar(carry)
        return time.perf_counter() - t0

    fetch_scalar(step(make()))
    return marginal_step_time(run_window, windows, reps)
