"""Gesture-synthesis serving on the GPU.

Loads a trained generator once and serves synthesis requests over HTTP,
with the same JSON contract as the JAX package's `serve.py`:

  GET  /healthz           -> {"status": "ok", "device": ..., "n_poses": ...,
                              "precision": "f32" | "bf16"}
  GET  /metrics           -> per-endpoint latency aggregates and precision,
                             and "active_streams"
  POST /synthesize        body: {
        "audio": [float, ...] | null,   # 16 kHz waveform; null = silence
                                        # covering the words' time range
        "audio_b64": base64 str,        # OR raw little-endian float32
                                        # samples (wins over "audio")
        "words": [[word, start_s, end_s], ...],
        "vid_idx": int (optional),
        "fade_out": bool (optional),
        "binary": bool (optional)       # arrays back as base64 float32 +
                                        # shape fields (dir_vec_b64, ...)
      }
      -> {"dir_vec": [[27 floats] x F], "poses": [[10][3] x F],
          "frames": F, "elapsed_ms": ...}
  POST /synthesize_batch  body: {"requests": [<synthesize body>, ...]}
      -> {"results": [<synthesize response>, ...]}: the clips run as one
      generator batch; elapsed_ms on each result is the batch wall time.
      With --auto-batch-ms N, /synthesize requests arriving within N ms
      coalesce into one such batch.
  POST /stream/start      body: {"vid_idx": int?, "seed": int?}
      -> {"stream_id": str}: a live session (`streaming.py`); at most 256
      are open, and one idle for 600 s is dropped
  POST /stream/feed       body: {"stream_id": str, "audio" | "audio_b64":
      the next chunk, "words": newly known timed words?, "binary": bool?}
      -> {"dir_vec": [[27 floats] x k], "frames": k} (or dir_vec_b64 and
      dir_vec_shape): the frames that became final, k >= 0
  POST /stream/flush      body: {"stream_id": str, "words": ...?}
      -> the last frames, as /stream/feed; the session closes. A stream's
      frames together equal /synthesize's dir_vec for the same audio,
      words, vid_idx and per-window noise. An unknown or flushed
      stream_id answers 400.

Run, after `main_v2` has trained into the same base path and config:

    python -m speech2affective_gestures_torch.serve -b BASE -c CONFIG \
        [--packed-data ARCH | --synthetic-data true] [--port 8787]

It takes `main_v2`'s flags, reads the test split's vocabulary from the
same data, and serves the best checkpoint of `main_v2`'s work dir
(`--torch-checkpoint` a reference `.pth.tar` instead); without either it
refuses to start, unless `--s2ag-load-last-best false` asks for random
weights. On the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from os.path import join as jn

import numpy as np
import torch

from . import constants as C
from . import main_v2
from .config import ModelConfig
from .data.vocab import Vocab
from .device import resolve_device, set_f32_numerics
from .models.generator import build_generator
from .streaming import StreamingSynthesizer
from .train import synthesis
from .train.trainer import Trainer


def encode_f32_b64(arr) -> str:
    """Array -> base64 of raw little-endian float32 (C order)."""
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype="<f4").tobytes()
    ).decode("ascii")


def decode_f32_b64(blob: str) -> np.ndarray:
    """base64 of raw little-endian float32 -> 1-D float32 array."""
    try:
        raw = base64.b64decode(blob, validate=True)
    except (binascii.Error, TypeError) as e:
        raise ValueError(f"bad base64 audio: {e}") from None
    if len(raw) % 4:
        raise ValueError(
            f"audio_b64 decodes to {len(raw)} bytes, not a multiple of 4 "
            "(expected raw little-endian float32 samples)"
        )
    return np.frombuffer(raw, dtype="<f4").astype(np.float32, copy=True)


def audio_from_request(req: dict) -> np.ndarray | None:
    """The waveform of a request: 'audio_b64' wins over 'audio'; both
    absent or null -> None (silence covering the words)."""
    b64 = req.get("audio_b64")
    if b64 is not None:
        return decode_f32_b64(b64)
    raw = req.get("audio")
    return None if raw is None else np.asarray(raw, np.float32)


class SynthesisService:
    """Owns the generator and the vocabulary and serves synthesis calls.

    The generator's device is the service's device; on the card the f32
    numerics are pinned (`device.set_f32_numerics`). Device work runs on
    one worker thread that lives as long as the service, so concurrent
    callers are served one at a time: cuDNN keeps its convolution plans
    per thread, and the HTTP server's thread per request would otherwise
    plan every convolution of every request again (about 0.7 ms each on
    the H100, PERF.md). Each request draws its noise from its own
    `torch.Generator`, seeded with `seed` plus the request's number; a
    stream's from its "seed" or else the same. The generator eats each
    window's MFCCs, or with `use_mfcc=False` (the abl_audio ablation's)
    its raw audio.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.nn.Module, lang_model: Vocab,
                 seed: int = 0, auto_batch_ms: float = 0.0,
                 auto_batch_max: int = 16, precision: str = "f32",
                 use_mfcc: bool = True):
        if precision not in synthesis.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (expected 'f32' or 'bf16')")
        self.cfg = cfg
        # the generator's precision (`synthesis.precision_wrap`): "f32", or
        # "bf16" forwards with the MFCC front-end, crossfade and FK float32
        self.precision = precision
        self.use_mfcc = use_mfcc
        self.gen = gen.eval()
        self.lang = lang_model
        self.device = next(gen.parameters()).device
        if self.device.type == "cuda":
            set_f32_numerics()
        self.seed = seed
        self._lock = threading.Lock()
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="s2ag-device")
        self._counter = 0
        self.auto_batch_ms = float(auto_batch_ms)
        self.auto_batch_max = int(auto_batch_max)
        self._ab_lock = threading.Lock()
        self._ab_pending: list[dict] = []
        self._metrics: dict = {}
        self._metrics_lock = threading.Lock()
        # live sessions, each a StreamingSynthesizer; idle ones are dropped
        self._streams: dict[str, StreamingSynthesizer] = {}
        self._stream_last_used: dict[str, float] = {}
        self.stream_idle_ttl = 600.0
        self.max_streams = 256

    @classmethod
    def from_trainer(cls, trainer: Trainer, precision: str = "f32",
                     **kwargs) -> "SynthesisService":
        """A service over a trainer's generator, with the vocabulary of its
        test split (its train split's when it has none); raw audio windows
        for an abl_audio trainer's (`trainer.variant`)."""
        data = trainer.test_data or trainer.train_data
        return cls(trainer.cfg, trainer.gen, data.lang_model, precision=precision,
                   use_mfcc=getattr(trainer, "variant", "s2ag") != "abl_audio", **kwargs)

    @classmethod
    def from_config(cls, cfg: ModelConfig, lang_model: Vocab, n_speakers: int,
                    device: str | torch.device | None = None, seed: int = 0,
                    variant: str = "s2ag", **kwargs) -> "SynthesisService":
        """A service over a fresh generator of `variant` with random weights
        from `seed`, on the card unless `device="cpu"`."""
        gen = build_generator(cfg, lang_model.n_words, n_speakers,
                              device=resolve_device(device), seed=seed, variant=variant)
        return cls(cfg, gen, lang_model, seed=seed, use_mfcc=variant != "abl_audio",
                   **kwargs)

    # ------------------------------------------------------------ metrics

    def _record(self, endpoint: str, elapsed_ms: float, clips: int = 1,
                phases: dict | None = None):
        with self._metrics_lock:
            m = self._metrics.setdefault(endpoint, {
                "requests": 0, "clips": 0, "total_ms": 0.0,
                "max_ms": 0.0, "recent_ms": [], "phase_ms": {},
            })
            m["requests"] += 1
            m["clips"] += clips
            m["total_ms"] += elapsed_ms
            m["max_ms"] = max(m["max_ms"], elapsed_ms)
            m["recent_ms"].append(round(elapsed_ms, 2))
            del m["recent_ms"][:-64]  # bounded window for percentiles
            for k, v in (phases or {}).items():
                m["phase_ms"][k] = m["phase_ms"].get(k, 0.0) + float(v)

    def reset_metrics(self):
        with self._metrics_lock:
            self._metrics.clear()

    def metrics(self) -> dict:
        out = {}
        with self._metrics_lock:
            for endpoint, m in self._metrics.items():
                recent = sorted(m["recent_ms"])
                out[endpoint] = {
                    "requests": m["requests"],
                    "clips": m["clips"],
                    "mean_ms": round(m["total_ms"] / max(m["requests"], 1), 2),
                    "max_ms": round(m["max_ms"], 2),
                    "p50_ms": recent[len(recent) // 2] if recent else None,
                    "p90_ms": recent[int(len(recent) * 0.9)] if recent else None,
                    "precision": self.precision,
                }
                if m["phase_ms"]:
                    n = max(m["requests"], 1)
                    out[endpoint]["phase_mean_ms"] = {
                        k: round(v / n, 2) for k, v in m["phase_ms"].items()
                    }
        out["active_streams"] = len(self._streams)
        return out

    # --------------------------------------------------------- synthesis

    def warmup(self):
        """Build the CUDA kernels and warm the libraries with one short
        request, then drop its latency from the metrics."""
        self.synthesize(None, [["<UNK>", 0.1, 0.4]])
        self.reset_metrics()

    def _generators(self, n: int) -> list[torch.Generator]:
        with self._lock:
            base = self._counter + 1
            self._counter += n
        return [torch.Generator().manual_seed(self.seed + base + i)
                for i in range(n)]

    def _eps(self, generators, n_windows: int) -> torch.Tensor:
        """(S, B, z_size) noise, clip b's from its own generator."""
        z = self.gen.z_size
        return torch.stack([torch.randn(n_windows, z, generator=g)
                            for g in generators], dim=1)

    @staticmethod
    def _fill_audio(audio, words):
        if audio is None:
            end = max((w[2] for w in words), default=1.0) + 0.5
            return np.zeros(int(end * C.AUDIO_SR), np.float32)
        return np.asarray(audio, np.float32)

    def _on_worker(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) on the service's device thread."""
        return self._worker.submit(fn, *args, **kwargs).result()

    def synthesize(self, audio: np.ndarray | None, words, vid_idx: int = 0,
                   fade_out: bool = False, eps: torch.Tensor | None = None) -> dict:
        """One clip. eps: optional (S, 1, z_size) per-window noise."""
        return self._run("synthesize", [(audio, words, vid_idx)], [fade_out],
                         eps)[0]

    def synthesize_batch(self, requests, eps: torch.Tensor | None = None) -> list[dict]:
        """Many clips as one generator batch. requests: dicts {audio |
        audio_b64, words, vid_idx?, fade_out?}; eps: optional (S, B, z_size)."""
        if not requests:
            return []
        clips = [(audio_from_request(r), r.get("words", []),
                  int(r.get("vid_idx", 0))) for r in requests]
        fades = [bool(r.get("fade_out", False)) for r in requests]
        return self._run("synthesize_batch", clips, fades, eps)

    def _run(self, endpoint, clips, fades, eps):
        t0 = time.perf_counter()
        clips = [(self._fill_audio(a, w), w, v) for a, w, v in clips]
        if eps is None:
            n_max = max(len(synthesis.plan_subdivisions(
                len(a) / C.AUDIO_SR, self.cfg)[0]) for a, _, _ in clips)
            eps = self._eps(self._generators(len(clips)), n_max)
        phases: dict = {}
        outs = self._on_worker(
            synthesis.synthesize_clips_batched, self.gen, clips, self.lang, self.cfg,
            eps=eps, fade_out=fades, timings=phases, precision=self.precision,
            use_mfcc=self.use_mfcc)
        elapsed = (time.perf_counter() - t0) * 1e3
        self._record(endpoint, elapsed, clips=len(clips), phases=phases)
        return [{"dir_vec": dv, "poses": ps, "frames": int(len(dv)),
                 "elapsed_ms": elapsed} for dv, ps in outs]

    # -------------------------------------------- request micro-batching

    def synthesize_auto(self, audio, words, vid_idx: int = 0,
                        fade_out: bool = False) -> dict:
        """/synthesize honouring auto_batch_ms: requests that arrive while
        one is waiting coalesce into one `synthesize_batch`; with
        auto_batch_ms == 0 this is `synthesize`. A request waits at most
        auto_batch_ms; a full auto_batch_max group runs at once. A failure
        of the shared batch surfaces on every member request."""
        if self.auto_batch_ms <= 0:
            return self.synthesize(audio, words, vid_idx=vid_idx,
                                   fade_out=fade_out)
        entry = {
            "req": {"audio": audio, "words": words, "vid_idx": vid_idx,
                    "fade_out": fade_out},
            "event": threading.Event(), "out": None, "err": None,
        }
        with self._ab_lock:
            self._ab_pending.append(entry)
            first = len(self._ab_pending) == 1
            full = len(self._ab_pending) >= self.auto_batch_max
        if full:
            self._ab_drain()
        elif first:
            # the first waiter of a group owns its flush timer
            threading.Thread(target=self._ab_drain_later, daemon=True).start()
        entry["event"].wait()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    def _ab_drain_later(self):
        time.sleep(self.auto_batch_ms / 1e3)
        self._ab_drain()

    def _ab_drain(self):
        with self._ab_lock:
            pending, self._ab_pending = self._ab_pending, []
        if not pending:
            return
        try:
            results = self.synthesize_batch([e["req"] for e in pending])
            for e, r in zip(pending, results):
                e["out"] = r
        except Exception as ex:  # noqa: BLE001 — fan the error out
            for e in pending:
                e["err"] = ex
        finally:
            for e in pending:
                e["event"].set()

    # ---------------------------------------------------- live streaming

    def stream_start(self, vid_idx: int = 0, seed: int | None = None) -> str:
        """Open a live session; its noise comes from `seed`, else from
        the service's seed plus the session's number, as a request's does.
        Window i's noise is then row i of one (S, z_size) draw from a
        generator with that seed, the `eps` that gives `synthesize` the
        same clip."""
        with self._lock:
            self._prune_streams()
            if len(self._streams) >= self.max_streams:
                raise ValueError(f"too many open streams ({self.max_streams}); flush "
                                 "or let idle sessions expire")
            self._counter += 1
            stream_id = f"s{self._counter:06d}"
            generator = torch.Generator().manual_seed(
                self.seed + self._counter if seed is None else int(seed))
            self._streams[stream_id] = StreamingSynthesizer(
                self.gen, self.lang, self.cfg, vid_idx=vid_idx, generator=generator,
                precision=self.precision, use_mfcc=self.use_mfcc)
            self._stream_last_used[stream_id] = time.monotonic()
        return stream_id

    def _prune_streams(self):
        """Drop sessions idle past stream_idle_ttl (a client that vanished
        without /stream/flush would keep its audio forever). Caller holds
        the lock."""
        cutoff = time.monotonic() - self.stream_idle_ttl
        for sid in [sid for sid, ts in self._stream_last_used.items() if ts < cutoff]:
            self._streams.pop(sid, None)
            self._stream_last_used.pop(sid, None)

    def _stream(self, stream_id: str) -> StreamingSynthesizer:
        try:
            stream = self._streams[stream_id]
        except KeyError:
            raise ValueError(f"unknown stream_id {stream_id!r}") from None
        self._stream_last_used[stream_id] = time.monotonic()
        return stream

    # A session is looked up on the device thread, in the same task as its
    # feed or flush: a flush that removes it runs wholly before or after a
    # feed, so a feed after the flush finds no session (ValueError, 400).

    def stream_feed(self, stream_id: str, audio, words=()) -> np.ndarray:
        def feed():
            with self._lock:
                self._prune_streams()
                stream = self._stream(stream_id)
            return stream.feed(audio, words)

        t0 = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        out = self._on_worker(feed)
        self._record("stream_feed", (time.perf_counter() - t0) * 1e3)
        return out

    def stream_flush(self, stream_id: str, words=()) -> np.ndarray:
        def flush():
            with self._lock:
                stream = self._stream(stream_id)
                del self._streams[stream_id]
                self._stream_last_used.pop(stream_id, None)
            return stream.flush(words)

        t0 = time.perf_counter()
        out = self._on_worker(flush)
        self._record("stream_flush", (time.perf_counter() - t0) * 1e3)
        return out


def make_handler(service: SynthesisService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, service.metrics())
            elif self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "device": str(service.device),
                    "n_poses": service.cfg.n_poses,
                    "precision": service.precision,
                })
            else:
                self._send(404, {"error": "unknown path"})

        @staticmethod
        def _result_payload(result: dict, binary: bool = False) -> dict:
            if binary:
                dv, ps = result["dir_vec"], result["poses"]
                return {
                    "dir_vec_b64": encode_f32_b64(dv),
                    "dir_vec_shape": list(np.shape(dv)),
                    "poses_b64": encode_f32_b64(ps),
                    "poses_shape": list(np.shape(ps)),
                    "frames": result["frames"],
                    "elapsed_ms": result["elapsed_ms"],
                }
            return {
                "dir_vec": result["dir_vec"].tolist(),
                "poses": result["poses"].tolist(),
                "frames": result["frames"],
                "elapsed_ms": result["elapsed_ms"],
            }

        @staticmethod
        def _frames_payload(out: np.ndarray, binary: bool = False) -> dict:
            if binary:
                return {"dir_vec_b64": encode_f32_b64(out),
                        "dir_vec_shape": list(np.shape(out)), "frames": int(len(out))}
            return {"dir_vec": out.tolist(), "frames": int(len(out))}

        def do_POST(self):
            try:
                t0 = time.perf_counter()
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                binary = bool(req.get("binary", False))
                if self.path == "/synthesize":
                    if "audio" not in req and "audio_b64" not in req:
                        raise KeyError("audio")
                    audio = audio_from_request(req)
                    t_parse = time.perf_counter()
                    result = service.synthesize_auto(
                        audio, req.get("words", []),
                        vid_idx=int(req.get("vid_idx", 0)),
                        fade_out=bool(req.get("fade_out", False)),
                    )
                    t_run = time.perf_counter()
                    self._send(200, self._result_payload(result, binary))
                    service._record(
                        "synthesize.http", (time.perf_counter() - t0) * 1e3,
                        phases={
                            "parse_ms": (t_parse - t0) * 1e3,
                            "run_ms": (t_run - t_parse) * 1e3,
                            "encode_ms": (time.perf_counter() - t_run) * 1e3,
                        })
                elif self.path == "/synthesize_batch":
                    results = service.synthesize_batch(req["requests"])
                    self._send(200, {
                        "results": [self._result_payload(r, binary)
                                    for r in results],
                    })
                elif self.path == "/stream/start":
                    self._send(200, {"stream_id": service.stream_start(
                        vid_idx=int(req.get("vid_idx", 0)), seed=req.get("seed"))})
                elif self.path == "/stream/feed":
                    chunk = audio_from_request(req)
                    out = service.stream_feed(req["stream_id"],
                                              chunk if chunk is not None else [],
                                              req.get("words", ()))
                    self._send(200, self._frames_payload(out, binary))
                elif self.path == "/stream/flush":
                    out = service.stream_flush(req["stream_id"], req.get("words", ()))
                    self._send(200, self._frames_payload(out, binary))
                else:
                    self._send(404, {"error": "unknown path"})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
            except Exception as e:  # noqa: BLE001 — surface as HTTP 500
                self._send(500, {"error": f"synthesis failed: {e}"})

    return Handler


def serve(service: SynthesisService, port: int = 8787,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; `shutdown()` stops it."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_parser() -> argparse.ArgumentParser:
    """`main_v2`'s flags (the base path, the config, the data route, the
    checkpoint), plus the server's own."""
    p = main_v2.build_parser()
    p.description = ("Serve gesture synthesis over HTTP on the GPU, from the "
                     "checkpoint that main_v2 trained with the same flags")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--auto-batch-ms", type=float, default=0.0,
                   help="coalesce concurrent /synthesize requests arriving "
                   "within this window into one batch (0 = off)")
    p.add_argument("--serve-precision", choices=synthesis.PRECISIONS, default="f32",
                   help="the generator's precision: 'f32' (default), or 'bf16' "
                   "(parameters and activations bf16, the GRU kernels' bf16 "
                   "instances; the MFCC front-end, crossfade and FK stay f32). "
                   "Its drift depends on the model's recurrent dynamics: check "
                   "the checkpoint being served against 'f32' first")
    return p


def build_service(argv=None) -> SynthesisService:
    """The service `main` serves, on the JAX package's terms (its
    serve.py:583-628): the test split's vocabulary from `main_v2`'s data
    route, and the generator of a trainer on `main_v2`'s work dir,
    `<base>/models/s2ag_v2_mfcc_torch/<dataset_s2ag>`, with the weights of
    `--torch-checkpoint`, or else of its best checkpoint. Raises
    SystemExit when neither is there, unless `--s2ag-load-last-best false`
    asks for random weights. The generator's speaker embedding is sized
    from the checkpoint: the speaker vocabularies are per split, and the
    weights were trained with the train split's."""
    args = build_parser().parse_args(argv)
    args.train_s2ag = False  # serving needs the test split alone
    device = resolve_device(args.device)
    cfg = ModelConfig.from_yaml(args.config, batch_size=args.batch_size)
    work_dir = jn(args.base_path, "models", "s2ag_v2_mfcc_torch", args.dataset_s2ag)
    path = main_v2.checkpoint_to_load(args, work_dir)
    if path is None and args.s2ag_load_last_best:
        raise SystemExit(f"no checkpoint found in {work_dir}; pass --torch-checkpoint "
                         "or --s2ag-load-last-best false to serve random weights")
    _, _, test_data = main_v2.load_datasets(args, cfg, device)
    trainer = Trainer(cfg, work_dir, test_data=test_data, device=device,
                      seed=cfg.random_seed, n_speakers=main_v2.checkpoint_speakers(path))
    if args.torch_checkpoint:
        trainer.load_torch_checkpoint(args.torch_checkpoint)
    elif path is not None:
        trainer.load_checkpoint("best" if args.s2ag_start_epoch == 0
                                else args.s2ag_start_epoch)
    return SynthesisService.from_trainer(trainer, precision=args.serve_precision,
                                         auto_batch_ms=args.auto_batch_ms)


def main(argv=None):
    args = build_parser().parse_args(argv)
    service = build_service(argv)
    print("warming up (builds the CUDA kernels)...", flush=True)
    service.warmup()
    server = serve(service, port=args.port, host=args.host)
    print(f"serving on {args.host}:{server.server_address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
