"""The controls on the card, at each cell's own sizes: the plain
reference in the precision below the configuration's (TF32 for a float32
cell, float8 e4m3 for a bf16 mixed-precision one), put in the program's
place, fails at least one of the cell's limits, and so does each planted
fault of a training cell; the program passes them all. One seed a cell
(calibrate.py reads a dozen)."""

import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT, card, core  # noqa: F401


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in core.benchmark_file()["workloads"]])
def test_control_and_faults_fail_the_limits(workload, card):
    import torch

    files = core.cell_files(workload)
    if torch.cuda.device_count() < files["cell"]["chips"]:
        pytest.skip("needs more cards")
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", workload,
                          "--seeds", "2900000017"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = files["limits"]
    assert all(line["sound"][k] <= v for k, v in limits.items()), line
    for name, numbers in line.items():
        if name.startswith(("control_", "fault_")):
            assert any(numbers[k] > v for k, v in limits.items()), (name, numbers)
