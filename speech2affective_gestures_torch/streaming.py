"""Incremental gesture synthesis of a live audio stream (the port's
counterpart of the JAX package's `streaming.py`).

The offline path (`train/synthesis.py`) needs the whole waveform; its
window mechanics need less: window i depends only on the audio up to
i * stride_time + unit_time and on the previous window's output.
`StreamingSynthesizer` takes audio chunks of any size as they arrive and
returns pose frames as soon as each window's audio is complete, with the
offline path's seeding, text frame mapping, crossfade and final-window
padding. `flush` closes the clip and returns the tail. The whole stream
equals `synthesis.synthesize_clip_fused` on the concatenated audio with the
same per-window noise; a frame comes out at most `unit_time` (2.27 s) of
audio after the audio it depends on.

Each window runs the MFCC front-end on its own audio (the fused mel kernel
on the card) and one generator forward (the GRU kernels); with
`use_mfcc=False` (the abl_audio ablation's generator) the window's raw
audio goes to the generator and no MFCC is computed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constants as C
from .config import ModelConfig
from .train import synthesis


class StreamingSynthesizer:
    """Windowed synthesis of one stream, on the generator's device.

        stream = StreamingSynthesizer(gen, lang, cfg, vid_idx=3,
                                      generator=torch.Generator().manual_seed(0))
        for chunk, words in source:            # e.g. a microphone and an ASR
            frames = stream.feed(chunk, words)  # (k, POSE_DIM), k >= 0
        frames = stream.flush()                # the last (partial) window

    Words may arrive any time before the window that covers them is
    synthesized (an ASR lag of up to `unit_time` is absorbed). Window i's
    speaker noise is `eps[i]` (1, z_size) when `eps` is given, else a draw
    of (1, z_size) from `generator` (CPU): the same numbers as the offline
    path's one (S, z_size) draw from a generator with the same seed.
    `seed_dir_vec` (>= n_pre, POSE_DIM) seeds the first window, as the
    offline path's; without it the seed poses are zeros (the mean pose).
    `use_mfcc` as the offline path's.
    """

    def __init__(self, gen: torch.nn.Module, lang_model, cfg: ModelConfig,
                 vid_idx: int = 0, generator: torch.Generator | None = None,
                 eps: torch.Tensor | None = None, precision: str = "f32",
                 seed_dir_vec: np.ndarray | None = None, use_mfcc: bool = True):
        self.gen = gen
        self.lang = lang_model
        self.cfg = cfg
        self.precision = precision
        self.use_mfcc = use_mfcc
        self.device = next(gen.parameters()).device
        self.vid_idx = torch.tensor([vid_idx], device=self.device)
        self.generator = generator if generator is not None else torch.Generator()
        self.eps = eps
        self.unit_time = cfg.n_poses / cfg.motion_resampling_framerate
        self.stride_time = (cfg.n_poses - cfg.n_pre_poses) / cfg.motion_resampling_framerate
        self.audio_len = int(self.unit_time * C.AUDIO_SR)
        self._audio = np.zeros(0, np.float32)
        self._words: list = []
        self._n_done = 0                          # windows synthesized
        self._prev_raw: np.ndarray | None = None  # the last window's raw output
        # the first window's seed poses, as the offline path's
        self._seed = torch.zeros(1, cfg.n_pre_poses, C.POSE_DIM, device=self.device)
        if seed_dir_vec is not None:
            self._seed[0] = torch.as_tensor(
                np.asarray(seed_dir_vec[:cfg.n_pre_poses], np.float32), device=self.device)
        self._flushed = False

    # ---------------------------------------------------------- internals

    def _window_start_samples(self, i: int) -> int:
        # the offline path slices window i at floor(start / clip_length *
        # len(audio)) (ref processor_v2.py:1241), through a clip length a
        # stream does not know yet; floor(start * sr) is the same whenever
        # the clip length is exactly representable, within one sample else
        return math.floor(i * self.stride_time * C.AUDIO_SR)

    def _noise(self, i: int) -> torch.Tensor:
        if self.eps is not None:
            return self.eps[i].to(self.device)
        return torch.randn(1, self.gen.z_size, generator=self.generator).to(self.device)

    def _run_window(self, audio_window: np.ndarray, start: float, end: float) -> np.ndarray:
        text = synthesis.window_text(self._words, start, end, self.lang, self.cfg.n_poses)
        feat = torch.from_numpy(audio_window)[None].to(self.device)
        if self.use_mfcc:
            feat = synthesis.window_features(feat, self.cfg)
        with synthesis.precision_wrap(self.gen, self.precision) as run:
            out = synthesis.window_forward(
                run, self.cfg, feat, torch.from_numpy(text)[None].to(self.device),
                self.vid_idx, self._seed, eps=self._noise(self._n_done))
        self._seed = out[:, -self.cfg.n_pre_poses:]
        self._n_done += 1
        return out[0].cpu().numpy()

    def _emit(self, raw: np.ndarray, final: bool) -> np.ndarray:
        """The frames that are final now: window i's head blended with
        window i-1's raw tail (`synthesis.crossfade_weights`); a window that
        is not the last withholds its last n_pre frames, the next seam."""
        n_pre = self.cfg.n_pre_poses
        out = raw.copy()
        if self._prev_raw is not None:
            w_prev, w_next = synthesis.crossfade_weights(n_pre, out.dtype)
            out[:n_pre] = (self._prev_raw[-n_pre:] * w_prev[:, None]
                           + raw[:n_pre] * w_next[:, None])
        self._prev_raw = raw
        return out if final else out[:len(out) - n_pre]

    @staticmethod
    def _joined(frames: list) -> np.ndarray:
        return (np.concatenate(frames, axis=0) if frames
                else np.zeros((0, C.POSE_DIM), np.float32))

    # ------------------------------------------------------------- public

    def feed(self, audio_chunk, words=()) -> np.ndarray:
        """Append audio (float32 at 16 kHz) and any newly known timed words
        [word, start_s, end_s]; return the pose frames that became final,
        (k, POSE_DIM) with k possibly 0."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        audio_chunk = np.asarray(audio_chunk, np.float32).reshape(-1)
        if audio_chunk.size:
            self._audio = np.concatenate([self._audio, audio_chunk])
        self._words.extend(list(w) for w in words)
        emitted = []
        while True:
            a_start = self._window_start_samples(self._n_done)
            if a_start + self.audio_len > len(self._audio):
                break
            start = self._n_done * self.stride_time
            raw = self._run_window(self._audio[a_start:a_start + self.audio_len],
                                   start, start + self.unit_time)
            emitted.append(self._emit(raw, final=False))
        return self._joined(emitted)

    def flush(self, words=()) -> np.ndarray:
        """Close the clip: the remaining windows of the offline schedule for
        the stream's length (`synthesis.plan_subdivisions`), the last one
        zero-padded as the offline path pads it; returns the last frames."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        self._words.extend(list(w) for w in words)
        self._flushed = True
        windows, _, _ = synthesis.plan_subdivisions(len(self._audio) / C.AUDIO_SR, self.cfg)
        emitted = []
        for i in range(self._n_done, len(windows)):
            start, end = windows[i]
            a_start = self._window_start_samples(i)
            seg = self._audio[a_start:a_start + self.audio_len]
            window_audio = np.zeros(self.audio_len, np.float32)
            window_audio[:len(seg)] = seg
            raw = self._run_window(window_audio, start, end)
            emitted.append(self._emit(raw, final=(i == len(windows) - 1)))
        if not emitted and self._prev_raw is not None:
            # every window was streamed; the last one's withheld seam is final
            return self._prev_raw[-self.cfg.n_pre_poses:].copy()
        return self._joined(emitted)
