"""Where a served request's host time goes with the thread it runs on.

    python speech2affective_gestures_torch/tools/serve_threads.py

On one CUDA GPU, the full-width s2ag generator (config/multimodal_context_v2.yml,
1000 words, 100 speakers, random weights from seed 0) synthesizes a 10 s
clip, and a live stream runs one window, each 10 times:
- from the main thread, which has run them before;
- from a fresh thread each time, as the HTTP server's thread per request
  ran them before the service had its device thread;
- through `SynthesisService` from a fresh thread each time, as the HTTP
  handlers run them now (the service hands the work to its device
  thread).
cuDNN keeps its convolution plans per thread, so a fresh thread plans
every convolution again. Prints the card's name and power limit, the p50
of each (host clock, ended by a synchronize), then the host time of one
cuDNN convolution call in a clip from the main thread and from a fresh
thread (torch.profiler, CPU activity).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from speech2affective_gestures_torch import serve, streaming  # noqa: E402
from speech2affective_gestures_torch.config import ModelConfig  # noqa: E402
from speech2affective_gestures_torch.data.vocab import placeholder_vocab  # noqa: E402
from speech2affective_gestures_torch.train import synthesis  # noqa: E402

CONFIG = pathlib.Path(__file__).resolve().parents[2] / "config" / "multimodal_context_v2.yml"


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def in_fresh_thread(fn) -> float:
    out = []
    thread = threading.Thread(target=lambda: out.append(timed(fn)))
    thread.start()
    thread.join()
    return out[0]


def report(label: str, runs) -> None:
    times = [run() for run in runs]
    print(f"{label}: p50 {np.median(times):.3f} ms over {len(times)}; all "
          f"{[round(t, 3) for t in times]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_threads: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    cfg = ModelConfig.from_yaml(CONFIG)
    vocab = placeholder_vocab(1000)
    service = serve.SynthesisService.from_config(cfg, vocab, 100, device="cuda", seed=0)
    service.warmup()
    gen = service.gen
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(160000)).astype(np.float32)
    words = [[f"<w{5 + i}>", 0.4 + 0.9 * i, 0.8 + 0.9 * i] for i in range(12)]
    eps = torch.randn(5, 1, gen.z_size)

    def clip():
        synthesis.synthesize_clips_batched(gen, [(audio, words, 3)], vocab, cfg, eps=eps)

    unit = int(cfg.n_poses / cfg.motion_resampling_framerate * 16000)

    def window():
        stream = streaming.StreamingSynthesizer(gen, vocab, cfg, generator=torch.Generator())
        stream.feed(audio[:unit], words)

    def served_window():
        sid = service.stream_start()
        service.stream_feed(sid, audio[:unit], words)
        service.stream_flush(sid)   # the rest of the clip's last window

    clip()
    window()
    n = 10
    report("10 s clip, main thread", [lambda: timed(clip)] * n)
    report("10 s clip, a fresh thread each", [lambda: in_fresh_thread(clip)] * n)
    report("10 s clip, SynthesisService.synthesize from a fresh thread each",
           [lambda: in_fresh_thread(lambda: service.synthesize(audio, words, vid_idx=3))] * n)
    report("stream window, main thread", [lambda: timed(window)] * n)
    report("stream window, a fresh thread each", [lambda: in_fresh_thread(window)] * n)
    report("stream window and flush through SynthesisService, a fresh thread each",
           [lambda: in_fresh_thread(served_window)] * n)
    for label, run in (("main thread", lambda f: f()), ("a fresh thread", in_fresh_thread)):
        print(f"cuDNN convolution host time in a 10 s clip, {label}: "
              f"{conv_host_us(clip, run):.1f} us a call", flush=True)
    return 0


def conv_host_us(fn, run) -> float:
    """The mean host time of `aten::cudnn_convolution` in fn(), run by
    `run` (in this thread or a fresh one)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}

    def profiled():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        [conv] = [e for e in prof.key_averages() if e.key == "aten::cudnn_convolution"]
        out["us"] = conv.cpu_time_total / conv.count
        return 0.0

    run(profiled)
    return out["us"]


if __name__ == "__main__":
    sys.exit(main())
