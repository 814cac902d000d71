"""The training driver: the cells whose traffic names `"driver": "train"`.

One process (or one rank a card, `ranks` > 1, over `parallel.mesh.launch`
with NCCL) builds the program's GAN step (`train.builder.init_training` at
the configuration's variant and precision), loads the benchmark's weights
into it, puts a random packed split on the device (`data.ted_db.
DeviceDataset`), and drives that one object: first through the steps
that the reference follows, then through the warm-up, then through the
measured window. A step is `GanStep.train_step` on a batch gathered on the
device (per-step traffic), or one replay of `train.step_program.
StepProgram` of K steps; each step's metrics are read `metrics_lag` steps
later, as the trainer's per-step loop reads them. Rows and speakers of
every step, weights, split and the step generator's seed come from
--seed."""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np
import torch

from .. import core
from .. import weights as W
from ..reference import nets as ref_nets


def _port_config(dims: dict, batch: int):
    from speech2affective_gestures_torch.config import ModelConfig

    keys = ("num_mfcc", "dropout_prob", "n_layers", "hidden_size", "hidden_size_s2eg",
            "z_type", "input_context", "motion_resampling_framerate", "n_poses", "n_pre_poses",
            "learning_rate", "discriminator_lr_weight", "loss_regression_weight",
            "loss_gan_weight", "loss_kld_weight", "loss_reg_weight", "wordembed_dim")
    return ModelConfig(batch_size=batch, **{k: dims[k] for k in keys})


def make_weights(dims: dict, seed: int, device) -> dict:
    """{"gen.<name>" | "dis.<name>" | "tri.<name>": tensor} on `device`."""
    nets = ref_nets.build(dims)       # on the CPU: its shapes are read
    out = {}
    for prefix, net, part in zip(("gen.", "dis.", "tri."), nets, range(3)):
        out.update({prefix + k: v for k, v in
                    W.make_state(net, core.seed_parts(seed, 3)[part], device).items()})
    return out


def make_split(dims: dict, rows: int, seed: int, device) -> dict:
    """A packed split of `rows` random rows in the cache's dtypes, made on
    the device: word ids, poses (0.1 N(0, 1)), int16 audio with its row's
    maximum, float16 MFCCs, speakers."""
    g = torch.Generator(device=device).manual_seed(seed)
    t, n_aud = dims["n_poses"], dims["expected_audio_length"]
    return {
        "words": torch.randint(0, dims["n_words"], (rows, t), generator=g, device=device,
                               dtype=torch.int32),
        "poses": torch.randn(rows, t, 27, generator=g, device=device) * 0.1,
        "audio": torch.randint(-32767, 32768, (rows, n_aud), generator=g, device=device,
                               dtype=torch.int16),
        "audio_max": torch.rand(rows, generator=g, device=device) * 0.45 + 0.05,
        "mfcc": torch.randn(rows, dims["num_mfcc_combined"], dims["mfcc_length"], generator=g,
                            device=device).half(),
        "vids": torch.randint(0, dims["n_speakers"], (rows,), generator=g, device=device),
    }


def make_draws(dims: dict, traffic: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, speakers), each (pool steps, global batch) int64."""
    rng = np.random.default_rng(seed)
    shape = (traffic["draw_pool_steps"], traffic["batch_per_rank"] * traffic["ranks"])
    return (rng.integers(0, traffic["split_rows"], shape),
            rng.integers(0, dims["n_speakers"], shape))


def _leaf_norms(named) -> dict:
    names, tensors = zip(*named)
    norms = torch.stack([torch.linalg.vector_norm(t.detach().double()) for t in tensors])
    return dict(zip(names, norms.tolist()))


class Program:
    """The program's GAN step over the split, as the window drives it."""

    def __init__(self, dims, traffic, weights, split, device, mesh, gen_seed, phase):
        from speech2affective_gestures_torch.data.ted_db import DeviceDataset, PackedDataset
        from speech2affective_gestures_torch.parallel import mesh as P
        from speech2affective_gestures_torch.train import builder

        self.traffic, self.mesh, self.device = traffic, mesh, device
        self.k = traffic["steps_per_program"]
        cfg = _port_config(dims, traffic["batch_per_rank"] * traffic["ranks"])
        setup = builder.init_training(
            cfg, 0, n_words=dims["n_words"], n_speakers=dims["n_speakers"], device=device,
            variant=dims["variant"], mixed_precision=traffic["precision"] == "mixed",
            mesh=mesh)
        phase("program: init_training")
        self.nets = {"gen": setup["gen"], "dis": setup["dis"], "tri": setup["tri"]}
        for prefix, net in self.nets.items():
            net.load_state_dict({k[len(prefix) + 1:]: v for k, v in weights.items()
                                 if k.startswith(prefix + ".")})
        self.step = setup["step"]
        if mesh is not None:
            P.replicate_state(tuple(self.nets.values()),
                              (self.step.gen_opt, self.step.dis_opt), mesh)
        host = {k: v.cpu().numpy() for k, v in split.items()}
        packed = PackedDataset(extended_word_seq=host["words"], vec_seq=host["poses"],
                               audio=host["audio"], audio_max=host["audio_max"],
                               mfcc_features=host["mfcc"], vid_indices=host["vids"])
        self.data = DeviceDataset(packed, device)
        phase("program: weights loaded, DeviceDataset built")
        self.generator = torch.Generator(device=device).manual_seed(gen_seed)
        self.program = None
        if self.k > 1:
            from speech2affective_gestures_torch.train.step_program import StepProgram
            self.program = StepProgram(self.step, self.data, self.generator)
        self.rows = slice(None) if mesh is None else mesh.rows(
            traffic["batch_per_rank"] * traffic["ranks"])

    def run(self, idx: np.ndarray, adv: np.ndarray) -> torch.Tensor:
        """One unit of work on the (k, global batch) draws: (k, n_metrics)
        metrics on the device, not yet read."""
        idx, adv = idx[:, self.rows], adv[:, self.rows]
        if self.program is not None:
            self.keys, values = self.program.run(idx, adv, self.traffic["gan_on"])
            return values
        metrics = self.step.train_step(self.data.batch(idx[0], adv[0]), self.generator,
                                       gan_on=self.traffic["gan_on"], tri_metric=True)
        self.keys = list(metrics)
        return torch.stack(list(metrics.values()))[None]

    def moments(self) -> dict:
        """Each net's first moment over (1 - beta1), by leaf: after one
        update the gradient that Adam was handed."""
        out = []
        for who in ("gen", "dis"):
            opt = getattr(self.step, f"{who}_opt")
            beta1 = opt.param_groups[0]["betas"][0]
            # a parameter that Adam never updated holds no moment: zero
            out += [(f"{who}.{k}", opt.state[p]["exp_avg"] / (1.0 - beta1)
                     if "exp_avg" in opt.state.get(p, {}) else torch.zeros((), device=p.device))
                    for k, p in self.nets[who].named_parameters()]
        return _leaf_norms(out)

    def delta(self, weights: dict) -> dict:
        return _leaf_norms([(f"{who}.{k}", p.detach() - weights[f"{who}.{k}"])
                            for who in ("gen", "dis")
                            for k, p in self.nets[who].named_parameters()])


class Reader:
    """Each unit's metrics read `lag` steps later (as the trainer reads
    them); a non-finite one counts as failed."""

    def __init__(self, lag: int):
        self.lag, self.pending, self.failed = lag, collections.deque(), 0

    def push(self, values: torch.Tensor):
        self.pending.append(values)
        while sum(len(v) for v in self.pending) - len(self.pending[0]) > self.lag:
            self._pop()

    def _pop(self):
        rows = self.pending.popleft().tolist()
        self.failed += sum(1 for r in rows if not np.all(np.isfinite(r)))

    def drain(self):
        while self.pending:
            self._pop()


def worker(mesh, job: dict) -> dict:
    """One process's (one rank's) run: set-up with the followed steps and
    the warm-up, then the window (--trace 0) or the traced sub-window
    (--trace 1). Returns its record, timings and metrics; a rank writes it
    to job["out_dir"]."""
    from speech2affective_gestures_torch.ops import gru_cuda
    from speech2affective_gestures_torch.parallel import mesh as P

    dims, traffic = job["dims"], job["traffic"]
    device = torch.device(job["device"] if mesh is None else mesh.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t_start = job["t_start"]
    rank0 = mesh is None or mesh.rank == 0
    s_w, s_split, s_draws, s_gen = core.seed_parts(job["seed"], 4)
    weights = make_weights(dims, s_w, device)
    split = make_split(dims, traffic["split_rows"], s_split, device)
    idx, adv = make_draws(dims, traffic, s_draws)
    if rank0:
        core.phase("weights, split and draws made", t_start)

    def phase(name):
        if rank0:
            core.phase(name, t_start)

    prog = Program(dims, traffic, weights, split, device, mesh, s_gen, phase)
    if rank0:
        core.phase("program built", t_start)
    k, pool = prog.k, len(idx)

    # the steps the reference follows: through the window's own call
    n_follow = k if k > 1 else 3
    losses, grad = [], None
    for first in range(0, n_follow, k):
        values = prog.run(idx[first:first + k], adv[first:first + k]).tolist()
        losses += [dict(zip(prog.keys, row)) for row in values]
        if first == 0 and k == 1:
            grad = prog.moments()
    record = {"losses": losses, "grad": grad or prog.moments(), "delta": prog.delta(weights),
              "n_follow": n_follow, "first_grad": k == 1}
    del weights
    if rank0:
        core.phase("followed steps run", t_start)
    if job.get("follow_only"):
        return {"record": record}
    # the warm-up
    at = n_follow
    for _ in range(max(1, traffic["warmup_steps"] // k)):
        prog.run(idx[at % pool:at % pool + k], adv[at % pool:at % pool + k])
        at += k
    core.sync(device)
    if rank0:
        core.phase("warm-up run", t_start)

    def units(n, reader):
        nonlocal at
        for _ in range(n):
            j = at % (pool - pool % k)
            with torch.profiler.record_function("bench.train_unit"):
                values = prog.run(idx[j:j + k], adv[j:j + k])
            with torch.profiler.record_function("bench.metrics_read"):
                reader.push(values)
            at += k

    out = {"record": record if rank0 else None, "rank": 0 if mesh is None else mesh.rank}
    if job["trace"]:
        n = max(1, traffic["trace_steps"] // k)
        reader = Reader(traffic["metrics_lag"])
        counted = {}

        def traced():
            before = [c.copy() for c in (gru_cuda.shape_launches, gru_cuda.batch_launches,
                                         P.traffic)]
            units(n, reader)
            reader.drain()
            counted["gru"] = [c - b for c, b in zip((gru_cuda.shape_launches,
                                                     gru_cuda.batch_launches), before)]
            counted["mesh"] = P.traffic - before[2]

        def agree(ok: bool) -> bool:
            if mesh is None:
                return ok
            flag = torch.tensor([1.0 if ok else 0.0], device=device)
            torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
            return bool(flag.item())

        trace = core.profile(traced, device, agree=agree)
        # a short pass with the host's spans, to label the idle gaps
        label_reader = Reader(traffic["metrics_lag"])

        def labelled():
            units(1, label_reader)
            label_reader.drain()

        labels = core.profile(labelled, device, host=True, agree=agree)
        out["busy_s"] = out["window_s"] = None
        if trace is not None:
            red = core.reduce_trace(trace)
            out["busy_s"], out["window_s"] = red["busy_s"], red["window_s"]
            if rank0:
                ctx = {"trace": red, "steps": n * k, "dims": dims, "traffic": traffic,
                       "config": job["config"], "shape_launches": counted["gru"][0],
                       "batch_launches": counted["gru"][1], "mesh_traffic": counted["mesh"]}
                out["per_layer"] = core.read_metrics(job["per_layer"], ctx)
                out["breakdown"] = core.breakdown(
                    red, core.reduce_trace(labels) if labels is not None else None)
                out["mesh_traffic"] = {name: v / (n * k) for name, v in counted["mesh"].items()}
        out["steps"], out["failed"] = n * k + k, reader.failed + label_reader.failed
    else:
        reader = Reader(traffic["metrics_lag"])
        if mesh is None:
            t0 = time.perf_counter()
            setup_s = time.time() - job["t_start"]
            steps, marks = 0, [t0]
            while True:
                units(1, reader)
                steps += k
                marks.append(time.perf_counter())
                if marks[-1] - t0 >= job["seconds"]:
                    break
            reader.drain()
            core.sync(device)
            window = time.perf_counter() - t0
            core.host_report(np.diff(marks) * 1e3)
        else:
            # every rank runs the same number of steps: rank 0 times a few
            # and sets the count that fills --seconds
            t_probe = time.perf_counter()
            units(2, reader)
            reader.drain()
            core.sync(device)
            per_unit = (time.perf_counter() - t_probe) / 2
            count = torch.tensor([max(1, round(job["seconds"] / per_unit))],
                                 device=device, dtype=torch.float64)
            P.all_reduce_(count, mesh)
            n_units = int(count.item() / mesh.world)
            mesh.barrier()
            t0 = time.perf_counter()
            setup_s = time.time() - job["t_start"]
            units(n_units, reader)
            reader.drain()
            core.sync(device)
            mesh.barrier()
            window = time.perf_counter() - t0
            steps = n_units * k
        out.update(steps=steps, window_s_e2e=window, setup_s=setup_s, failed=reader.failed)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                         else 0)
    out["forbidden"] = core.forbidden_modules()
    out["device"] = str(device)
    if mesh is not None:
        with open(os.path.join(job["out_dir"], f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
    return out


def rank_main(mesh, job):
    worker(mesh, job)


def rank_follow(mesh, job):
    """The followed steps of every seed of job["seeds"], rank 0 writing
    each record (calibrate.py)."""
    for seed in job["seeds"]:
        out = worker(mesh, {**job, "seed": seed, "follow_only": True})
        if mesh.rank == 0:
            with open(os.path.join(job["out_dir"], f"seed{seed}.json"), "w") as f:
                json.dump(out["record"], f)


def reference_record(dims, traffic, seed, device, n_follow, first_grad, mode="f32",
                     fraction=1.0) -> dict:
    """The plain reference's record of the first `n_follow` steps of the
    run with --seed `seed`, from the same weights, split, draws and step
    seed, on the global batch."""
    from ..reference import step as ref_step

    s_w, s_split, s_draws, s_gen = core.seed_parts(seed, 4)
    weights = make_weights(dims, s_w, device)
    split = make_split(dims, traffic["split_rows"], s_split, device)
    idx, adv = make_draws(dims, traffic, s_draws)
    draws = [(torch.from_numpy(idx[i]).to(device), torch.from_numpy(adv[i]).to(device))
             for i in range(n_follow)]
    return ref_step.follow(dims, weights, split, draws, s_gen, device, n_follow, first_grad,
                           mode=mode, fraction=fraction)


def run(files: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda:0", dims_override: dict | None = None,
        traffic_override: dict | None = None) -> tuple[dict, dict]:
    """One run of a training cell: (result, compared numbers)."""
    import gc
    import shutil
    import tempfile

    from .. import check

    dims = {**core.model_dims(files["config"]), **(dims_override or {})}
    traffic = {**files["traffic"], **(traffic_override or {})}
    job = dict(dims=dims, traffic=traffic, config=files["config"], seed=seed, seconds=seconds,
               trace=trace, per_layer=files["per_layer"], t_start=t_start, device=device)
    ranks = traffic["ranks"]
    if ranks == 1:
        outs = [worker(None, job)]
        devices = [device]
    else:
        from speech2affective_gestures_torch.parallel import mesh as P

        job["out_dir"] = tempfile.mkdtemp(prefix="bench_ranks_")
        cuda = device.startswith("cuda")
        devices = [f"cuda:{r}" for r in range(ranks)] if cuda else ["cpu"] * ranks
        try:
            P.launch(rank_main, ranks, "nccl" if cuda else "gloo", devices, args=(job,),
                     timeout=900)
            outs = []
            for r in range(ranks):
                with open(os.path.join(job["out_dir"], f"rank{r}.json")) as f:
                    outs.append(json.load(f))
        finally:
            shutil.rmtree(job["out_dir"], ignore_errors=True)
        device = devices[0]
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    lead = outs[0]
    peak = max(o["peak_bytes"] for o in outs)
    core.phase("window closed", t_start)
    record = lead["record"]
    ref = reference_record(dims, traffic, seed, torch.device(device), record["n_follow"],
                           record["first_grad"])
    core.phase("reference run", t_start)
    correct, compared = check.judged(check.train_numbers(record, ref), files["limits"])
    global_batch = traffic["batch_per_rank"] * ranks
    result = {"correct": correct, "attempted": lead["steps"], "failed": lead["failed"],
              "device": core.device_record(devices, peak),
              "forbidden": sorted({m for o in outs for m in o["forbidden"]})}
    if trace:
        busy = [o["busy_s"] for o in outs if o.get("busy_s") is not None]
        result["metrics"] = lead.get("per_layer", {})
        result["device"]["busy_s"] = sum(busy) / len(busy) if busy else None
        result["device"]["window_s"] = lead.get("window_s")
        if "breakdown" in lead:
            result["breakdown"] = lead["breakdown"]
        if lead.get("mesh_traffic"):
            print(f"collectives a step on rank 0: {lead['mesh_traffic']}", file=sys.stderr)
    else:
        rate = lead["steps"] * global_batch / lead["window_s_e2e"]
        result["metrics"] = {
            **core.rate_metrics(files["end_to_end"], "samples/s", rate),
            "setup_s": {"value": lead["setup_s"], "unit": "s"},
            "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"}}
    return result, compared
