"""The rendering driver: the cells whose traffic names `"driver": "render"`.

A closed loop with one caller: `serve.SynthesisService.synthesize_batch`
calls of `clips_per_call` clips, dispatched back to back. Every call holds
the same set of clip lengths, spread evenly over `clip_seconds`, in an
order drawn from --seed; each clip has a seeded 16 kHz waveform, timed
words at `words_per_second` drawn from the vocabulary, a speaker, zero
seed poses and the per-window noise. `distinct_calls` such calls are made
in set-up and the window cycles through them. The generator's weights
are the benchmark's, made on the device from --seed."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import core
from .. import weights as W
from ..reference import nets as ref_nets


def make_calls(dims: dict, traffic: dict, seed: int, device) -> list[dict]:
    """The calls' requests, their noise (S, clips, z) and their clips'
    lengths."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    n = traffic["clips_per_call"]
    lo, hi = traffic["clip_seconds"]
    lengths = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    sr = dims["audio_sr"]
    fps, t, n_pre = dims["motion_resampling_framerate"], dims["n_poses"], dims["n_pre_poses"]
    unit, stride = t / fps, (t - n_pre) / fps
    calls = []
    for _ in range(traffic["distinct_calls"]):
        secs = rng.permutation(lengths)
        samples = [int(s * sr) for s in secs]
        total = sum(samples)
        # noise under a 4 Hz syllable envelope, made on the device in one call
        noise = torch.randn(total, generator=g, device=device)
        phase = torch.rand(len(samples), generator=g, device=device)
        audio = []
        at = 0
        for i, m in enumerate(samples):
            tt = torch.arange(m, device=device) / sr
            env = 0.5 + 0.5 * torch.sin(2 * np.pi * (4.0 * tt + phase[i]))
            audio.append(noise[at:at + m] * env * traffic["audio_rms"])
            at += m
        audio = [a.cpu().numpy().astype(np.float32) for a in audio]
        requests = []
        for s, a in zip(secs, audio):
            k = int(round(traffic["words_per_second"] * s))
            starts = np.sort(rng.uniform(0.0, max(s - 0.3, 0.01), k))
            ends = np.minimum(starts + rng.uniform(0.15, 0.4, k), s)
            ids = rng.integers(4, dims["n_words"], k)
            words = [[f"w{i}", float(b), float(e)] for i, b, e in zip(ids, starts, ends)]
            requests.append({"audio": a, "words": words,
                             "vid_idx": int(rng.integers(0, dims["n_speakers"])),
                             "fade_out": traffic["fade_out"]})
        windows = [1 if s < unit else int(np.ceil((s - unit) / stride)) + 1 for s in secs]
        eps = torch.randn(max(windows), n, 16, generator=torch.Generator().manual_seed(
            int(rng.integers(0, 1 << 62))))
        calls.append({"requests": requests, "eps": eps, "seconds": secs,
                      "windows": windows})
    return calls


def make_weights(dims: dict, seed: int, device) -> dict:
    gen = ref_nets.build(dims)[0]     # on the CPU: its shapes are read
    return W.make_state(gen, seed, device)


def _service(dims: dict, traffic: dict, weights: dict, device):
    from speech2affective_gestures_torch.data.vocab import Vocab
    from speech2affective_gestures_torch.models.generator import make_pose_generator
    from speech2affective_gestures_torch.serve import SynthesisService

    from .train import _port_config

    cfg = _port_config(dims, traffic["clips_per_call"])
    gen = make_pose_generator(cfg, dims["n_words"], dims["n_speakers"], dims["variant"])
    gen.load_state_dict(weights)
    vocab = Vocab("benchmark")
    for i in range(4, dims["n_words"]):
        vocab.index_word(f"w{i}")
    return SynthesisService(cfg, gen.to(device).eval(), vocab, precision=traffic["precision"])


def sample(calls: list, seed: int, per_call: int) -> list[list[int]]:
    """The clips of each call that the reference renders: `per_call` drawn
    from the seed, the longest among them."""
    rng = np.random.default_rng(seed)
    out = []
    for c in calls:
        longest = int(np.argmax(c["seconds"]))
        rest = [i for i in rng.permutation(len(c["seconds"])) if i != longest]
        out.append(sorted([longest] + rest[:per_call - 1]))
    return out


def reference_outputs(dims, traffic, seed, device, picks, mode="f32") -> list[list[np.ndarray]]:
    """The plain reference's dir_vec of each picked clip of each call."""
    from ..reference import step as ref_step
    from ..reference import synth

    s_w, s_calls = core.seed_parts(seed, 2)
    weights = make_weights(dims, s_w, device)
    calls = make_calls(dims, traffic, s_calls, device)
    gen = ref_nets.build(dims)[0]
    gen.load_state_dict(weights)
    gen = gen.to(device).eval()
    word_ids = {f"w{i}": i for i in range(4, dims["n_words"])}
    out = []
    with ref_step.precision(mode, (gen,)):
        for c, pick in zip(calls, picks):
            got = {}
            for s in sorted({c["windows"][i] for i in pick}):
                group = [i for i in pick if c["windows"][i] == s]
                clips = [(c["requests"][i]["audio"], c["requests"][i]["words"],
                          c["requests"][i]["vid_idx"], c["eps"][:, i]) for i in group]
                got.update(zip(group, synth.render(
                    lambda *a, **k: ref_step.call(gen, *a, **k), clips, word_ids, dims, device)))
            out.append([got[i] for i in pick])
    return out


def run(files: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda:0", dims_override: dict | None = None,
        traffic_override: dict | None = None) -> tuple[dict, dict]:
    """One run of a rendering cell: (result, compared numbers)."""
    import gc

    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    from .. import check

    dims = {**core.model_dims(files["config"]), **(dims_override or {})}
    traffic = {**files["traffic"], **(traffic_override or {})}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    s_w, s_calls = core.seed_parts(seed, 2)
    service = _service(dims, traffic, make_weights(dims, s_w, dev), dev)
    core.phase("service built", t_start)
    calls = make_calls(dims, traffic, s_calls, dev)
    core.phase("calls made", t_start)
    outputs = [[] for _ in calls]

    def one(j: int):
        c = calls[j % len(calls)]
        with torch.profiler.record_function("bench.synthesize_batch"):
            res = service.synthesize_batch(c["requests"], eps=c["eps"])
        outputs[j % len(calls)].append([r["dir_vec"] for r in res])
        return c

    for j in range(2):            # warm-up: the cell's one bucket shape
        one(j)
    core.sync(dev)
    core.phase("warm-up run", t_start)
    done = 0
    result = {"correct": False, "failed": 0}
    if trace:
        n = traffic["trace_calls"]
        counted = {}

        def traced():
            before = [c.copy() for c in (gru_cuda.shape_launches, gru_cuda.batch_launches,
                                         mel_cuda.launches)]
            service.reset_metrics()
            counted["calls"] = [one(j) for j in range(2, 2 + n)]
            counted["counts"] = [c - b for c, b in zip(
                (gru_cuda.shape_launches, gru_cuda.batch_launches, mel_cuda.launches), before)]
            counted["phases"] = service.metrics()["synthesize_batch"].get("phase_mean_ms", {})

        prof = core.profile(traced, dev)
        # a short pass with the host's spans, to label the idle gaps
        labels = core.profile(lambda: one(2 + n), dev, host=True)
        done = n + 1
        result["metrics"] = {}
        result["device"] = {"busy_s": None, "window_s": None}
        if prof is not None:
            red = core.reduce_trace(prof)
            real = sum(sum(c["windows"]) for c in counted["calls"])
            ctx = {"trace": red, "calls": n, "real_windows": real, "dims": dims,
                   "traffic": traffic, "config": files["config"],
                   "shape_launches": counted["counts"][0], "batch_launches": counted["counts"][1],
                   "mel_launches": counted["counts"][2], "phases": counted["phases"],
                   "frames_per_window": 1 + int(dims["n_poses"] * dims["audio_sr"]
                                                / dims["motion_resampling_framerate"]) // 512}
            result["metrics"] = core.read_metrics(files["per_layer"], ctx)
            result["device"] = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
            result["breakdown"] = core.breakdown(
                red, core.reduce_trace(labels) if labels is not None else None)
    else:
        audio_s = 0.0
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        times = []
        while True:
            t_call = time.perf_counter()
            c = one(2 + done)
            times.append(time.perf_counter() - t_call)
            audio_s += float(np.sum(c["seconds"]))
            done += 1
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(dev)
        window = time.perf_counter() - t0
        core.host_report(np.array(times) * 1e3)
        result["metrics"] = {
            **core.rate_metrics(files["end_to_end"], "audio_s/s", audio_s / window),
            "setup_s": {"value": setup_s, "unit": "s"}}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if not trace:
        result["metrics"]["peak_mem_gib"] = {"value": peak / 2**30, "unit": "GiB"}
    result["device"] = {**core.device_record([device], peak), **result.get("device", {})}
    result["attempted"] = done
    del service
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # every call of the window, each sampled clip against the reference
    core.phase("window closed", t_start)
    picks = sample(calls, seed, traffic["compared_clips_per_call"])
    want = reference_outputs(dims, traffic, seed, dev, picks)
    got, ref = [], []
    failed = 0
    for pick, outs, w in zip(picks, outputs, want):
        for res in outs:
            if len(res) != traffic["clips_per_call"]:
                failed += 1
                continue
            got += [res[i] for i in pick]
            ref += w
    core.phase("reference run", t_start)
    result["failed"] = failed
    correct, compared = check.judged(check.render_numbers(got, ref), files["limits"])
    result["correct"] = correct and failed == 0 and bool(got)
    print(f"calls {done}, clips compared {len(got)}", file=sys.stderr)
    return result, compared
