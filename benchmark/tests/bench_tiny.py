"""Shared by the benchmark's tests: every cell of BENCHMARK.json, and the
cells that PERF.md keeps under Open questions whose traffic and limits
files are here, run end to end on the CPU at a tiny size, with the
program's plain PyTorch versions of its kernels (a data-parallel cell
over two gloo ranks)."""

import copy
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import core  # noqa: E402

TINY_DIMS = dict(hidden_size=16, hidden_size_s2eg=16, wordembed_dim=16, n_words=50,
                 n_speakers=10)
# proved on the chip, not in BENCHMARK.json (PERF.md, Open questions): the
# drivers they need are tested here until a later benchmark change adds them
LATER = [{"name": "render.s2ag.batch", "config": "s2ag", "traffic": "render_batch", "chips": 1},
         {"name": "train.s2ag.dp4", "config": "s2ag", "traffic": "train_f32_dp4", "chips": 4}]
LATER_RATES = {"render.s2ag.batch": "audio_s/s", "train.s2ag.dp4": "samples/s"}


def bench() -> dict:
    """BENCHMARK.json with the later cells, each reporting its rate."""
    b = copy.deepcopy(core.benchmark_file())
    b["workloads"] += LATER
    for name, unit in LATER_RATES.items():
        b["end_to_end"].append({"name": f"rate.{name}", "unit": unit, "workloads": [name]})
    return b


def cell_files(workload: str) -> dict:
    return core.cell_files(workload, bench())


def tiny_traffic(traffic: dict) -> dict:
    if traffic["driver"] == "train":
        ranks = min(traffic["ranks"], 2)
        return dict(split_rows=32, batch_per_rank=8 // ranks, draw_pool_steps=16,
                    trace_steps=traffic["steps_per_program"], warmup_steps=1, ranks=ranks)
    return dict(clips_per_call=6, distinct_calls=2, clip_seconds=[3.0, 6.0], trace_calls=1,
                compared_clips_per_call=3)


def workloads() -> list[str]:
    return [w["name"] for w in bench()["workloads"]]


def run_tiny(workload: str, seed: int, trace: bool, traffic: dict | None = None):
    """(result line as printed, compared numbers) of one tiny run; `traffic`
    overrides more of the mix."""
    files = cell_files(workload)
    driver = core.load_driver(files["traffic"]["driver"])
    return driver.run(files, seed, 0.2, trace, time.time(), device="cpu",
                      dims_override=TINY_DIMS,
                      traffic_override={**tiny_traffic(files["traffic"]), **(traffic or {})})


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, not
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")
