"""What every cell of the benchmark shares: finding a cell's files by the
names in BENCHMARK.json, the caches inside the checkout, the look for the
JAX package, the device record, the profiler's reduction to busy time and
a breakdown, the per-layer metric readers, and the result line."""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in the process that prints
# a result (compared whole: the program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "speech2affective_gestures_tpu")


def use_checkout_caches() -> None:
    """Every kernel and JIT cache of the run at a fixed path inside the
    checkout (the program's own nvcc builds already live in its package's
    `_build/`)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def benchmark_file() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise SystemExit(f"{path} is missing")
    return json.loads(path.read_text())


def cell_files(workload: str, bench: dict | None = None) -> dict:
    """The cell `workload` of BENCHMARK.json (or of `bench`) with its
    configuration file, its traffic mix (benchmark/traffic/
    <traffic>.json), its correctness limits (benchmark/limits/
    <workload>.json) and the metrics it reports."""
    bench = bench or benchmark_file()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def model_dims(config: dict) -> dict:
    """The configuration's model section with the sizes derived from it
    (reference loader_v2.py:480-484, processor_v2.py:124) and the assumed
    vocabulary sizes."""
    m = dict(config["model"])
    m["expected_audio_length"] = int(round(m["n_poses"] / m["motion_resampling_framerate"]
                                           * m["audio_sr"]))
    m["mfcc_length"] = int(math.ceil(m["expected_audio_length"] / 512))
    m["num_mfcc_combined"] = 3 * m["num_mfcc"] - 5
    m.update(config["assumed"])
    return m


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def seed_parts(seed: int, n: int = 4) -> list[int]:
    """n independent 32-bit seeds from one seed of any size."""
    import numpy as np

    ss = np.random.SeedSequence(abs(int(seed)) + (1 << 70 if seed < 0 else 0))
    return [int(x) for x in ss.generate_state(n)]


# ------------------------------------------------------------------ device
def device_record(devices: list, peak_bytes: int) -> dict:
    import torch

    if devices and str(devices[0]).startswith("cuda"):
        kind = torch.cuda.get_device_name(torch.device(devices[0]))
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": len(devices),
            "memory_peak_bytes": int(peak_bytes)}


def phase(name: str, t_start: float) -> None:
    """A set-up phase's end, in seconds since the process started, on
    standard error."""
    print(f"phase {name}: {time.time() - t_start:.3f} s", file=sys.stderr, flush=True)


def host_report(unit_ms) -> None:
    """The window's units as the host paced them (ms from one unit's
    dispatch to the next), the host's load and its cores' clocks, on
    standard error: what a run that reads slow was doing."""
    import numpy as np

    q = np.percentile(unit_ms, [10, 50, 90, 100]) if len(unit_ms) else []
    print("window units ms p10/p50/p90/max: " + " ".join(f"{v:.3f}" for v in q)
          + f" over {len(unit_ms)}", file=sys.stderr)
    try:
        load = Path("/proc/loadavg").read_text().split()[:3]
        mhz = [float(line.split(":")[1]) for line in
               Path("/proc/cpuinfo").read_text().splitlines() if line.startswith("cpu MHz")]
        print(f"host load {' '.join(load)}; cores {len(os.sched_getaffinity(0))} of "
              f"{os.cpu_count()}; cpu MHz min/median/max {min(mhz):.0f}/"
              f"{sorted(mhz)[len(mhz) // 2]:.0f}/{max(mhz):.0f}", file=sys.stderr)
    except (OSError, ValueError, IndexError):
        pass


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- profiler
def union_seconds(spans) -> float:
    """The time in which at least one of the (start, end) spans ran."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def profile(fn, device, host: bool = False, attempts: int = 3,
            agree=lambda ok: ok) -> dict | None:
    """fn() under torch.profiler: the device's kernels and copies as
    (name, start_us, end_us), the wall time and, with `host`, the host's
    spans. Without `host` only the device's activity is recorded, so that
    the host runs at its untraced pace (recording every operator on the
    host slows a host-paced step by about half). A session that records
    no device activity (it happens now and then on the H100 machines) is
    taken again; None after `attempts`. `agree(ok)` is whether every
    rank's session recorded some (the ranks of a data-parallel run retry
    together). Off CUDA, fn() runs untraced and None is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    if not str(device).startswith("cuda"):
        fn()
        return None
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(attempts):
        with torch_profile(activities=acts) as prof:
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall = time.perf_counter() - t0
        events = prof.events()
        dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
                 if host and getattr(e, "device_type", None) == DeviceType.CPU]
        if agree(bool(dev)):
            return {"device": dev, "host": spans, "wall_s": wall} if dev else None
    return None


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def reduce_trace(trace: dict) -> dict:
    """busy_s (the union of the device's spans), window_s (the host's wall
    time of the traced work), the kernel launches, the device time by
    operation, and the longest idle gaps of the device, each labelled by
    the innermost host span open at its middle where the trace holds the
    host's spans."""
    dev = trace["device"]
    busy = union_seconds([(s, e) for _, s, e in dev]) / 1e6
    by_op = collections.Counter()
    for name, s, e in dev:
        by_op[name] += (e - s) / 1e6
    spans = sorted((s, e) for _, s, e in dev)
    gaps, reach = [], spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    labelled = []
    for lo, hi in gaps[:10]:
        mid = (lo + hi) / 2
        inside = [(e - s, n) for n, s, e in trace["host"] if s <= mid <= e]
        label = min(inside)[1] if inside else "host idle"
        labelled.append([label, (hi - lo) / 1e6])
    return {"busy_s": busy, "window_s": trace["wall_s"],
            "launches": sum(1 for n, _, _ in dev if is_kernel(n)),
            "by_op": by_op, "gaps": labelled, "device": dev}


def breakdown(reduced: dict, labelled: dict | None = None) -> dict:
    """The top device operations of `reduced`, and the longest idle gaps
    of `labelled` (a short pass traced with the host's spans), or of
    `reduced` where there is none."""
    top = sorted(reduced["by_op"].items(), key=lambda kv: kv[1], reverse=True)[:10]
    gaps = (labelled or reduced)["gaps"]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}


# ------------------------------------------------------------ metric readers
def reader_path(name: str) -> Path:
    """benchmark/metrics/<name>.py, or the reader of the name with its last
    dotted parts taken off (idle_share.train.graph -> idle_share.train.py
    -> idle_share.py): one quantity split by the end-to-end metric it
    moves keeps one reader."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise SystemExit(f"no reader benchmark/metrics/<{name} or a prefix>.py")


def read_metrics(specs: list, ctx: dict) -> dict:
    """Each per-layer metric of `specs` from its reader (`reader_path`;
    `read(ctx)`: a number, or None where it finds nothing to read, and the
    metric is then left out)."""
    out = {}
    for spec in specs:
        path = reader_path(spec["name"])
        mod_spec = importlib.util.spec_from_file_location(
            "bench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def rate_metrics(specs: list, unit: str, value: float) -> dict:
    """The cell's end-to-end metrics in `unit`, each the rate `value`: a
    cell reports its rate under the name that BENCHMARK.json gives it."""
    return {m["name"]: {"value": value, "unit": unit} for m in specs if m["unit"] == unit}


# --------------------------------------------------------------- the result
def finish(result: dict, compared: dict) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, and the result line, with those numbers under the last
    key, as the last line of standard output."""
    for name, (value, limit) in compared.items():
        print(f"compared {name}: {value!r} limit {limit!r}", file=sys.stderr)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def load_driver(name: str):
    """The general driver of a traffic mix: benchmark/drivers/<name>.py."""
    return importlib.import_module(f"benchmark.drivers.{name}")
