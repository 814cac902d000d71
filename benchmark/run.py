"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics from a profiled sub-window. Either way the
run checks what the timed path produced against the plain reference in
benchmark/reference/ and prints the numbers compared beside their limits.
It needs as many CUDA devices as the cell asks for."""

import time

T_START = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.use_checkout_caches()
    files = core.cell_files(args.workload)

    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    core.phase("torch imported", T_START)
    driver = core.load_driver(files["traffic"]["driver"])
    result, compared = driver.run(files, args.seed, args.seconds, bool(args.trace), T_START)
    # this process's modules, and those each rank of the cell found after
    # its own window
    found = sorted(set(core.forbidden_modules()) | set(result.pop("forbidden", [])))
    if found:
        print(f"modules of the JAX stack were loaded: {found}", file=sys.stderr)
        return 3
    core.finish(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
