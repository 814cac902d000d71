"""Every cell of BENCHMARK.json end to end on the CPU at a tiny size: the
result line's shape, `correct` true, and no module of the JAX stack
loaded; on the card, each cell's own command."""

import json
import os
import subprocess
import sys

import pytest

from bench_tiny import ROOT, card, cell_files, core, last_line, run_tiny, workloads  # noqa: F401

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_cpu(workload, trace, capsys):
    files = cell_files(workload)
    result, compared = run_tiny(workload, 4_000_000_017 + trace, trace)
    assert result.pop("forbidden", []) == []
    core.finish(result, compared)
    line = last_line(capsys)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert DEVICE_KEYS <= set(line["device"])
    assert set(line["compared"]) == set(files["limits"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        # no device on the CPU: no device metric is read
        assert line["metrics"] == {}
    else:
        want = {m["name"] for m in files["end_to_end"]}
        assert set(line["metrics"]) == want
        for m in files["end_to_end"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]


def test_no_module_of_the_jax_stack_is_loaded():
    """A tiny run of each driver, the data-parallel one over two ranks, in
    a fresh interpreter; then every loaded module's top-level name, in
    that process and in each rank after its window, against jax, jaxlib,
    flax and the JAX package."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from bench_tiny import run_tiny
from benchmark import core
ranks = []
for w in ("train.s2ag.f32", "render.s2ag.batch", "train.s2ag.dp4"):
    ranks += run_tiny(w, 5, False)[0].get("forbidden", [])
print(core.forbidden_modules(), ranks)
"""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def _rank_loading_jax(mesh, job):
    """A data-parallel rank that has a module named jax loaded by the time
    its window closes."""
    import types

    from benchmark.drivers import train

    sys.modules.setdefault("jax", types.ModuleType("jax"))
    train.worker(mesh, job)


def test_a_rank_that_loads_jax_is_reported(monkeypatch):
    from benchmark.drivers import train

    monkeypatch.setattr(train, "rank_main", _rank_loading_jax)
    result, _ = run_tiny("train.s2ag.dp4", 6, False)
    assert result["forbidden"] == ["jax"]
    assert "jax" not in sys.modules


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("speech2affective_gestures_torch_probe", sys)
    try:
        assert "speech2affective_gestures_torch_probe" not in core.forbidden_modules()
        sys.modules["speech2affective_gestures_tpu.probe"] = sys
        assert core.forbidden_modules() == ["speech2affective_gestures_tpu.probe"]
    finally:
        sys.modules.pop("speech2affective_gestures_tpu.probe", None)
        sys.modules.pop("speech2affective_gestures_torch_probe", None)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in core.benchmark_file()["workloads"]])
def test_cell_on_the_card(workload, card):
    import torch

    if torch.cuda.device_count() < core.cell_files(workload)["cell"]["chips"]:
        pytest.skip("needs more cards")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          "3000000001", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
