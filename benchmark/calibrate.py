"""The readings that the correctness limits are set from, on the chip at a
cell's own sizes: for each seed, the numbers that the benchmark compares
for the program (sound runs), for the control (the plain reference in the
precision below the configuration's, in the program's place) and, for a
training cell, for the faults planted in the reference put in the
program's place (the step on half of the batch; on several ranks also on
one rank's share, the exchange between the cards left out). A state left
unchanged reads 1 on grad_gap's and delta_gap's measure and needs no run.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]

One JSON line a seed; the benchmark's own runs never run this."""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import check, core  # noqa: E402


def train_readings(files, seeds, device, dims_override=None, traffic_override=None):
    import torch

    from benchmark.drivers import train

    dims = {**core.model_dims(files["config"]), **(dims_override or {})}
    traffic = {**files["traffic"], **(traffic_override or {})}
    ranks = traffic["ranks"]
    job = dict(dims=dims, traffic=traffic, config=files["config"], seconds=0, trace=False,
               per_layer=[], t_start=time.time(), device=device)
    records = {}
    if ranks == 1:
        for seed in seeds:
            records[seed] = train.worker(None, {**job, "seed": seed, "follow_only": True})["record"]
    else:
        from speech2affective_gestures_torch.parallel import mesh as P

        job.update(seeds=list(seeds), out_dir=tempfile.mkdtemp(prefix="bench_cal_"))
        cuda = device.startswith("cuda")
        devices = [f"cuda:{r}" for r in range(ranks)] if cuda else ["cpu"] * ranks
        try:
            P.launch(train.rank_follow, ranks, "nccl" if cuda else "gloo", devices,
                     args=(job,), timeout=3000)
            for seed in seeds:
                with open(os.path.join(job["out_dir"], f"seed{seed}.json")) as f:
                    records[seed] = json.load(f)
        finally:
            shutil.rmtree(job["out_dir"], ignore_errors=True)
    dev = torch.device(device)
    control = "fp8" if traffic["precision"] == "mixed" else "tf32"
    for seed in seeds:
        rec = records[seed]
        args = (dims, traffic, seed, dev, rec["n_follow"], rec["first_grad"])
        ref = train.reference_record(*args)
        ctl = train.reference_record(*args, mode=control)
        line = {"seed": seed, "sound": check.train_numbers(rec, ref),
                "control_" + control: check.train_numbers(ctl, ref),
                "fault_half_batch": check.train_numbers(
                    train.reference_record(*args, fraction=0.5), ref),
                "detail_sound": check.train_detail(rec, ref),
                "detail_control": check.train_detail(ctl, ref)}
        if ranks > 1:
            line["fault_no_exchange"] = check.train_numbers(
                train.reference_record(*args, fraction=1.0 / ranks), ref)
        line["losses"] = [r["g_total"] for r in rec["losses"]]
        print(json.dumps(line), flush=True)


def render_readings(files, seeds, device, dims_override=None, traffic_override=None):
    import torch

    from benchmark.drivers import render

    dims = {**core.model_dims(files["config"]), **(dims_override or {})}
    traffic = {**files["traffic"], **(traffic_override or {})}
    dev = torch.device(device)
    for seed in seeds:
        s_w, s_calls = core.seed_parts(seed, 2)
        service = render._service(dims, traffic, render.make_weights(dims, s_w, dev), dev)
        calls = render.make_calls(dims, traffic, s_calls, dev)
        outs = [[r["dir_vec"] for r in service.synthesize_batch(c["requests"], eps=c["eps"])]
                for c in calls]
        del service
        picks = render.sample(calls, seed, traffic["compared_clips_per_call"])
        ref = render.reference_outputs(dims, traffic, seed, dev, picks)
        ctl = render.reference_outputs(dims, traffic, seed, dev, picks, mode="tf32")
        flat = [o[i] for o, p in zip(outs, picks) for i in p]
        flat_ref = [x for r in ref for x in r]
        print(json.dumps({"seed": seed, "sound": check.render_numbers(flat, flat_ref),
                          "control_tf32": check.render_numbers([x for c in ctl for x in c],
                                                               flat_ref)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    core.use_checkout_caches()
    files = core.cell_files(args.workload)
    fn = train_readings if files["traffic"]["driver"] == "train" else render_readings
    fn(files, args.seeds, args.device)


if __name__ == "__main__":
    main()
