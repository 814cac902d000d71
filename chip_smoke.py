"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit. In order:

1. prints the card's name and power limit, and builds the hand-written
   kernels from `speech2affective_gestures_torch/csrc/` with nvcc for
   sm_90a (one nvcc per source, started together);
2. kernel phase: each kernel against its plain PyTorch version on the card
   at the serving path's shapes, within a stated tolerance;
3. service phase: a full-width s2ag generator (config/multimodal_context_v2.yml:
   hidden 300, 4 GRU layers, embed 300; 1000 words, 100 speakers; random
   weights from seed 0) behind the HTTP server answers /synthesize for a
   10 s clip and /synthesize_batch for four clips of 3-12 s. The launch
   counters are set to 0 just before and read just after: both kernels
   must have run. The same requests through the same weights on the CPU
   (the plain path, same noise) must agree within tolerance;
4. timing: each kernel's time, its plain version's, a PyTorch library
   call's that computes the same function, and the least time the card
   could take (bound); then the service's synthesize p50.

It prints one `{"kernels": [...]}` line before the last, and as the last
line `{"ok": true, "device": {...}}`. It exits non-zero, with no result
line, when CUDA is unavailable, when the package is missing beside it, or
when any phase fails.
"""

from __future__ import annotations

import base64
import copy
import http.client
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PKG = ROOT / "speech2affective_gestures_torch"
CONFIG = ROOT / "config" / "multimodal_context_v2.yml"

# H100 SXM, NVIDIA data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

GRU_TOL = 1e-4        # absolute, h in [-1, 1] after 34 steps
# mel power, each value against its own magnitude: |got - want| <=
# MEL_RTOL |want| + MEL_FLOOR max|want|. Float32 sums of 2048 products in
# another order differ by ~1e-5 relative even in the quiet bands; the floor
# only covers values near zero.
MEL_RTOL = 1e-4
MEL_FLOOR = 1e-7
SERVE_TOL = 1e-3      # absolute, card vs CPU plain path, whole service


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() on the card over `iters` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_inputs(T, B, cin, H, D, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    bound = H ** -0.5
    x = torch.randn(T, B, cin, generator=g)
    w_ih = torch.empty(D * 3 * H, cin).uniform_(-bound, bound, generator=g)
    w_hh = torch.empty(D, H, 3 * H).uniform_(-bound, bound, generator=g)
    b_ih = torch.empty(D, 3 * H).uniform_(-bound, bound, generator=g)
    b_hh = torch.empty(D, 3 * H).uniform_(-bound, bound, generator=g)
    return [t.to(device).contiguous() for t in (x @ w_ih.t(), w_hh, b_ih, b_hh)]


def speech_frames(rows, device):
    """Hann-windowed frames of a synthetic voiced signal with noise."""
    import torch
    from speech2affective_gestures_torch.ops import dsp

    rng = np.random.default_rng(0)
    n = (rows + 8) * 512
    t = np.arange(n) / 16000
    y = (0.4 * np.sin(2 * np.pi * (150 + 60 * np.sin(3 * t)) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    frames = dsp.windowed_frames(torch.from_numpy(y).to(device))
    return frames.reshape(-1, 2048)[:rows].contiguous()


def kernel_phase(device) -> dict:
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    errs = {"gru_fwd": 0.0, "mel_power": 0.0}
    H, T, D = 300, 34, 2
    for B in (1, 2, 16):
        for cin in (88, 600):
            args = gru_inputs(T, B, cin, H, D, seed=B * 1000 + cin, device=device)
            ys, h_last = gru_cuda.gru_layer(*args)
            want_ys, want_h = gru_cuda.gru_layer_plain(*args)
            err = max((ys - want_ys).abs().max().item(),
                      (h_last - want_h).abs().max().item())
            log(f"kernel gru_fwd T={T} B={B} cin={cin} H={H} D={D}: "
                f"max_abs_err={err:.3e} (tol {GRU_TOL})")
            if not err <= GRU_TOL:
                raise AssertionError(f"gru_fwd disagrees with its plain version: {err}")
            errs["gru_fwd"] = max(errs["gru_fwd"], err)
    for rows in (568, 2272, 601):
        frames = speech_frames(rows, device)
        got = mel_cuda.mel_power(frames)
        want = mel_cuda.mel_power_plain(frames)
        diff = (got - want).abs()
        scale = want.abs().max().item()
        ok = bool((diff <= MEL_RTOL * want.abs() + MEL_FLOOR * scale).all())
        band_rel = (diff / want.abs()).amax(dim=0)    # worst of each band
        worst = int(band_rel.argmax())
        log(f"kernel mel_power R={rows}: max_abs_err={diff.max().item():.3e} "
            f"(max |mel| {scale:.3e}); worst relative error per band: max "
            f"{band_rel[worst].item():.3e} in band {worst} (its smallest |mel| "
            f"{want[:, worst].abs().min().item():.3e}), median "
            f"{band_rel.median().item():.3e}; smallest |mel| "
            f"{want.abs().min().item():.3e}; tol {MEL_RTOL} |want| + "
            f"{MEL_FLOOR} max|want|")
        if not ok:
            raise AssertionError(f"mel_power disagrees with its plain version: "
                                 f"band {worst} off by {band_rel[worst].item():.3e}")
        errs["mel_power"] = max(errs["mel_power"], diff.max().item())
    return errs


def clip_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)
    return (0.3 * env * np.sin(2 * np.pi * (140 + 40 * np.sin(2 * t)) * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def post(server, path, payload):
    conn = http.client.HTTPConnection(*server.server_address, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path} answered {resp.status}: {data}")
    return data


def unb64(blob, shape):
    return np.frombuffer(base64.b64decode(blob), "<f4").reshape(shape)


def service_phase(device):
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.vocab import placeholder_vocab
    from speech2affective_gestures_torch.models.generator import build_generator
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda
    from speech2affective_gestures_torch.train import synthesis

    cfg = ModelConfig.from_yaml(CONFIG)
    vocab = placeholder_vocab(1000)
    gen = build_generator(cfg, vocab.n_words, 100, device=device, seed=0)
    log(f"generator: hidden {cfg.hidden_size_s2eg}, {cfg.n_layers} GRU layers, "
        f"embed {cfg.wordembed_dim}, {sum(p.numel() for p in gen.parameters())} "
        "parameters")
    words = [[f"<w{5 + i}>", 0.4 + 0.9 * i, 0.8 + 0.9 * i] for i in range(12)]
    single = clip_audio(10.0, 1)
    batch = [{"audio_b64": serve.encode_f32_b64(clip_audio(s, 10 + i)),
              "words": [w for w in words if w[2] < s], "vid_idx": 7 * i,
              "binary": True}
             for i, s in enumerate((3.0, 6.0, 9.0, 12.0))]

    service = serve.SynthesisService(cfg, gen, vocab, seed=0)
    service.warmup()
    server = serve.serve(service, port=0)
    try:
        gru_cuda.launches = 0
        mel_cuda.launches = 0
        one = post(server, "/synthesize", {
            "audio_b64": serve.encode_f32_b64(single), "words": words,
            "vid_idx": 3, "binary": True})
        after_one = {"gru_fwd": gru_cuda.launches, "mel_power": mel_cuda.launches}
        many = post(server, "/synthesize_batch", {"requests": batch,
                                                  "binary": True})
        launches = {"gru_fwd": gru_cuda.launches, "mel_power": mel_cuda.launches}
    finally:
        server.shutdown()
        server.server_close()
    after_many = {k: launches[k] - after_one[k] for k in launches}
    log(f"service launches: /synthesize {after_one}, /synthesize_batch "
        f"{after_many}, total {launches}")
    for name in launches:
        if after_one[name] < 1 or after_many[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path: "
                                 f"{after_one[name]} in /synthesize, "
                                 f"{after_many[name]} in /synthesize_batch")

    gpu = [unb64(one["dir_vec_b64"], one["dir_vec_shape"])]
    gpu += [unb64(r["dir_vec_b64"], r["dir_vec_shape"]) for r in many["results"]]
    gpu_poses = [unb64(one["poses_b64"], one["poses_shape"])]
    gpu_poses += [unb64(r["poses_b64"], r["poses_shape"]) for r in many["results"]]
    audios = [single] + [np.frombuffer(base64.b64decode(r["audio_b64"]), "<f4")
                         for r in batch]
    for dv, ps, a in zip(gpu, gpu_poses, audios):
        n_win = len(synthesis.plan_subdivisions(len(a) / 16000, cfg)[0])
        frames = (n_win - 1) * (cfg.n_poses - cfg.n_pre_poses) + cfg.n_poses
        if dv.shape != (frames, 27) or ps.shape != (frames, 10, 3):
            raise AssertionError(f"bad output shapes {dv.shape} {ps.shape}, "
                                 f"expected {frames} frames")
        if not (np.isfinite(dv).all() and np.isfinite(ps).all()):
            raise AssertionError("non-finite output")
    log(f"service outputs: frames {[len(d) for d in gpu]}, all finite")

    # the same requests, same weights and same noise on the CPU plain path
    cpu_service = serve.SynthesisService(cfg, copy.deepcopy(gen).cpu(), vocab, seed=0)
    cpu_service.warmup()
    cpu_one = cpu_service.synthesize(single, words, vid_idx=3)
    cpu_many = cpu_service.synthesize_batch(batch)
    cpu = [cpu_one["dir_vec"]] + [r["dir_vec"] for r in cpu_many]
    cpu_poses = [cpu_one["poses"]] + [r["poses"] for r in cpu_many]
    err = max(max(np.abs(g - c).max() for g, c in zip(gpu, cpu)),
              max(np.abs(g - c).max() for g, c in zip(gpu_poses, cpu_poses)))
    log(f"service card vs CPU plain path: max_abs_err={err:.3e} (tol {SERVE_TOL})")
    if not err <= SERVE_TOL:
        raise AssertionError(f"card output disagrees with the CPU path: {err}")

    # request latency on the card, the service called directly
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        service.synthesize(single, words, vid_idx=3)
        times.append((time.perf_counter() - t0) * 1e3)
    btimes = []
    for _ in range(5):
        t0 = time.perf_counter()
        service.synthesize_batch(batch)
        btimes.append((time.perf_counter() - t0) * 1e3)
    log(f"synthesize 10 s clip (5 windows, bucket 8): p50 {np.median(times):.3f} ms "
        f"over {len(times)} requests; all {[round(t, 3) for t in times]}")
    log(f"synthesize_batch 4 clips 3-12 s (bucket 8): p50 {np.median(btimes):.3f} ms "
        f"over {len(btimes)} requests")
    log(f"service phases (mean ms): {service.metrics()}")
    profile_requests(service, single, words)
    return launches


def profile_requests(service, audio, words, n: int = 3) -> None:
    """Where a /synthesize request's time goes on the card: device time by
    kernel and the device's busy share of the wall time, from
    torch.profiler over `n` requests (the profiler's own cost is inside the
    wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            service.synthesize(audio, words, vid_idx=3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / n
    log(f"profile of /synthesize (10 s clip): wall {wall_ms:.3f} ms/request "
        f"under the profiler, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels) / n:.0f} "
        "kernel launches/request")
    for e in sorted(kernels, key=device_us, reverse=True)[:10]:
        log(f"  {device_us(e) / 1e3 / n:8.3f} ms {e.count / n:6.1f}x  {e.key[:90]}")


def timing_phase(device, errs, launches) -> list[dict]:
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    # GRU at the /synthesize shape: generator batch 1, T=34, H=300, both directions
    T, B, H, D = 34, 1, 300, 2
    args = gru_inputs(T, B, 600, H, D, seed=5, device=device)
    xp, w_hh, b_ih, b_hh = args
    gru_ms = time_ms(lambda: gru_cuda.gru_layer(*args))
    gru_plain_ms = time_ms(lambda: gru_cuda.gru_layer_plain(*args), iters=5)
    # cuDNN's GRU on the same inputs: input weights [I, 0] / [0, I] make its
    # input product pass xp through, so it computes the same function
    lib = torch.nn.GRU(D * 3 * H, H, bidirectional=True).to(device)
    eye = torch.eye(3 * H, device=device)
    zero = torch.zeros(3 * H, 3 * H, device=device)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.cat([eye, zero], 1))
        lib.weight_ih_l0_reverse.copy_(torch.cat([zero, eye], 1))
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lib, f"weight_hh_l0{sfx}").copy_(w_hh[d].t())
            getattr(lib, f"bias_ih_l0{sfx}").copy_(b_ih[d])
            getattr(lib, f"bias_hh_l0{sfx}").copy_(b_hh[d])
        lib_out, _ = lib(xp)
        ys, _ = gru_cuda.gru_layer(*args)
        log(f"gru_fwd vs cuDNN GRU on the same inputs: max_abs_err="
            f"{(lib_out - ys).abs().max().item():.3e}")
        gru_lib_ms = time_ms(lambda: lib(xp))
    gru_bytes = 4 * (xp.numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                     + T * B * D * H + D * B * H)
    gru_flops = T * D * B * (2 * H * 3 * H + 3 * H + 12 * H)
    for extra_b in (4, 16):
        a = gru_inputs(T, extra_b, 600, H, D, seed=6, device=device)
        log(f"gru_fwd B={extra_b}: {time_ms(lambda: gru_cuda.gru_layer(*a)):.4f} ms")

    # mel at the /synthesize shape: 8 windows x 71 frames
    rows = 568
    frames = speech_frames(rows, device)
    cos, sin, mel = mel_cuda.device_constants(frames.device, 16000, 2048, 128)
    mel_ms = time_ms(lambda: mel_cuda.mel_power(frames))
    mel_plain_ms = time_ms(lambda: mel_cuda.mel_power_plain(frames))
    mel_lib = mel[:1025].contiguous()

    def rfft_mel():
        spec = torch.fft.rfft(frames, dim=-1)
        return (spec.real ** 2 + spec.imag ** 2) @ mel_lib

    log(f"mel_power vs rfft mel on the same frames: max_abs_err="
        f"{(rfft_mel() - mel_cuda.mel_power(frames)).abs().max().item():.3e}")
    mel_lib_ms = time_ms(rfft_mel)
    # The least work of the function, not of this kernel's dense DFT: a real
    # FFT of each row (5 (n/2) log2 n operations), the power of each of the
    # 1025 bins, and a product with the filterbank's nonzeros; the least
    # bytes: the frames read once, the filterbank's nonzeros, the output.
    n_fft, n_bins = 2048, 1025
    nnz = int(np.count_nonzero(mel_cuda.padded_constants(16000, n_fft, 128)[2]))
    mel_flops = rows * (5 * (n_fft // 2) * int(np.log2(n_fft)) + 3 * n_bins
                        + 2 * nnz)
    mel_bytes = 4 * (frames.numel() + nnz + rows * 128)
    frames_big = speech_frames(2272, device)
    log(f"mel_power R=2272: {time_ms(lambda: mel_cuda.mel_power(frames_big)):.4f} ms, "
        f"plain {time_ms(lambda: mel_cuda.mel_power_plain(frames_big)):.4f} ms")

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    rows_out = []
    for name, source, replaces, ms, plain, lib_ms, nbytes, flops in (
            ("gru_fwd", "speech2affective_gestures_torch/csrc/gru_fwd.cu",
             "speech2affective_gestures_tpu/ops/gru_pallas.py:338",
             gru_ms, gru_plain_ms, gru_lib_ms, gru_bytes, gru_flops),
            ("mel_power", "speech2affective_gestures_torch/csrc/mel_power.cu",
             "speech2affective_gestures_tpu/ops/dsp_pallas.py:57",
             mel_ms, mel_plain_ms, mel_lib_ms, mel_bytes, mel_flops)):
        b_ms, b_by = bound(nbytes, flops)
        rows_out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
        })
        log(f"{name}: {ms:.4f} ms, plain {plain:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}; {nbytes} bytes, {flops} FLOP)")
    return rows_out


def main() -> int:
    if not (PKG / "csrc").is_dir() or not CONFIG.is_file():
        print(f"chip_smoke: the port ({PKG.name}/) and config/ must sit beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.ops import _build

    set_f32_numerics()
    t0 = time.perf_counter()
    libs = _build.build(["gru_fwd", "mel_power"])
    log(f"built {sorted(libs)} with nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, out in sorted(_build.build_logs.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    device = torch.device("cuda", 0)
    errs = kernel_phase(device)
    launches = service_phase(device)
    kernels = timing_phase(device, errs, launches)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
