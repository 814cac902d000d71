"""Long-clip gesture synthesis: windowed and autoregressive.

Capability parity with the reference's `render_clip` (processor_v2.py
:1144-1439): a clip of any length is synthesized in 34-frame windows with a
stride of (n_poses - n_pre_poses) frames. Each window is seeded with the
previous window's last 4 output poses, and the windows are blended with a
4-frame linear crossfade; an optional fade-out to the mean pose ends the
clip with a quadratic polyfit.

The serving path (`clip_body`) runs a batch of clips at once: the MFCC
front-end for every window of every clip in one call (the fused mel kernel
on the card), then a Python loop over windows with the clips as the
generator batch, then the validity-masked crossfade and assembly, the mean
re-add and forward kinematics. `synthesize_clip_fused` is that body at one
clip, `synthesize_clips_batched` at many. `precision` "bf16" runs the
generator's forwards at bf16 (`precision_wrap`); the MFCC front-end, the
crossfade and FK stay float32. With `use_mfcc=False` the windows' raw
audio goes to the generator as it is (the TriModal baseline's
WavEncoder), and no MFCC is computed.

`synthesize_clips_batched(mesh=, pad_to=)` splits the clip axis over a
mesh's data axis, as the JAX package's `make_batched_clip_fn(mesh=)`
shards it (`train/synthesis.py:393-430`): each rank runs its lanes with
the generator whole (on a (data, model) grid its split tables and GRU
weights gathered first) and every rank gets every clip's result.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from .. import constants as C
from ..config import ModelConfig
from ..ops import dsp
from ..ops import pose as pose_ops
from ..parallel import mesh as P
from .builder import bf16_parameters, cast_floats


def get_words_in_time_range(word_list, start_time, end_time):
    """ref utils/data_preprocessor.py:187-202."""
    words = []
    for word in word_list:
        word_s, word_e = word[1], word[2]
        if word_s >= end_time:
            break
        if word_e <= start_time:
            continue
        words.append(word)
    return words


def plan_subdivisions(clip_length: float, cfg: ModelConfig,
                      unit_time: float | None = None):
    """Window schedule (ref processor_v2.py:1200-1235)."""
    if unit_time is None:
        unit_time = cfg.n_poses / cfg.motion_resampling_framerate
    stride_time = (cfg.n_poses - cfg.n_pre_poses) / cfg.motion_resampling_framerate
    if clip_length < unit_time:
        num = 1
    else:
        num = math.ceil((clip_length - unit_time) / stride_time) + 1
    windows = []
    for i in range(num):
        start = min(i * stride_time, clip_length)
        end = min(start + unit_time, clip_length)
        if start >= end:
            continue
        windows.append((start, end))
    return windows, unit_time, stride_time


def prepare_window_inputs(clip_audio: np.ndarray, clip_words, lang_model,
                          cfg: ModelConfig, sample_rate: int = C.AUDIO_SR,
                          unit_time: float | None = None):
    """Slice audio and build frame-aligned word ids for every window.

    Returns (audio_windows (S, L), text_windows (S, T), end_padding_samples).
    """
    clip_length = len(clip_audio) / sample_rate
    windows, unit_time, _ = plan_subdivisions(clip_length, cfg, unit_time)
    audio_len = int(unit_time * sample_rate)
    n_frames = cfg.n_poses

    audio_windows = np.zeros((len(windows), audio_len), np.float32)
    text_windows = np.zeros((len(windows), n_frames), np.int64)
    end_padding = 0
    for i, (start, end) in enumerate(windows):
        a_start = math.floor(start / clip_length * len(clip_audio))
        seg = clip_audio[a_start : a_start + audio_len]
        if len(seg) < audio_len and i == len(windows) - 1:
            end_padding = audio_len - len(seg)
        audio_windows[i, : len(seg)] = seg  # zero ('constant') padding
        text_windows[i] = window_text(clip_words, start, end, lang_model, n_frames)
    return audio_windows, text_windows, end_padding


def window_text(words, start: float, end: float, lang_model, n_frames: int) -> np.ndarray:
    """(n_frames,) word ids of the window [start, end): each word of the
    window at the frame where it starts, PAD elsewhere."""
    text = np.zeros(n_frames, np.int64)
    frame_duration = (end - start) / n_frames
    for word in get_words_in_time_range(words, start, end):
        idx = max(0, int(np.floor((word[1] - start) / frame_duration)))
        if idx < n_frames:
            text[idx] = lang_model.get_word_index(word[0])
    return text


def window_bucket(n_windows: int) -> int:
    """Window counts are padded to a power of two >= 4 (the JAX package
    compiles one program per bucket; here the bucket fixes the shapes the
    MFCC front-end sees)."""
    return 1 << max(2, (n_windows - 1).bit_length())


def crossfade_weights(n_pre: int, dtype=np.float32):
    """The reference's linear seam ramp (processor_v2.py:1302-1331): frame
    j of a window's first n_pre frames mixes the previous window's raw
    tail with weight (n_pre-j)/(n_pre+1) and its own output with
    (j+1)/(n_pre+1)."""
    j = np.arange(n_pre, dtype=dtype)
    return (n_pre - j) / (n_pre + 1), (j + 1) / (n_pre + 1)


def fade_frame_range(n_frames: int, end_padding_samples: int,
                     cfg: ModelConfig, sample_rate: int = C.AUDIO_SR):
    """The (start, end) frames the fade-out smoothing covers
    (ref processor_v2.py:1336-1339)."""
    start = n_frames - int(
        end_padding_samples / sample_rate * cfg.motion_resampling_framerate
    )
    return start, start + cfg.n_pre_poses * 2


def polyfit_smooth(dir_vec: np.ndarray, start_frame: int,
                   end_frame: int) -> np.ndarray:
    """Quadratic weighted polyfit over [start, end) with pinned endpoints
    (ref processor_v2.py:1358-1391)."""
    y = dir_vec[start_frame:end_frame]
    if len(y) < 3:
        return dir_vec
    x = np.arange(y.shape[0])
    w = np.ones(len(y))
    w[0] = w[-1] = 5
    coeffs = np.polyfit(x, y, 2, w=w)
    interpolated = np.stack(
        [np.poly1d(coeffs[:, k])(x) for k in range(y.shape[1])], axis=1
    )
    dir_vec[start_frame:end_frame] = interpolated
    return dir_vec


def fade_out_poses(out_dir_vec: np.ndarray, end_padding_samples: int,
                   cfg: ModelConfig, sample_rate: int = C.AUDIO_SR) -> np.ndarray:
    """Fade to the mean pose + quadratic polyfit smoothing over the seam
    (ref processor_v2.py:1334-1391); host numpy."""
    n_smooth = cfg.n_pre_poses
    start_frame, end_frame = fade_frame_range(
        len(out_dir_vec), end_padding_samples, cfg, sample_rate
    )
    if len(out_dir_vec) < end_frame:
        out_dir_vec = np.pad(
            out_dir_vec, [(0, end_frame - len(out_dir_vec)), (0, 0)],
            mode="constant",
        )
    out_dir_vec[end_frame - n_smooth :] = 0.0  # mean pose in normalized space
    return polyfit_smooth(out_dir_vec, start_frame, end_frame)


PRECISIONS = ("f32", "bf16")


@contextlib.contextmanager
def precision_wrap(gen: torch.nn.Module, precision: str):
    """The generator's call at a serving precision, for the block, as the
    JAX package's `precision_wrap` (train/synthesis.py:260-300): "f32" the
    generator itself (float32, TF32 off on the card); "bf16" the generator
    with its parameters cast to bf16 (`builder.bf16_parameters`, once for
    the block: a request's windows share them, where JAX's program casts
    them once per request too), its float32 inputs cast to bf16 per call
    (the GRU kernels' bf16 instances on the card) and its outputs cast back
    to float32. The drift of bf16 depends on the model's recurrent
    dynamics (the JAX package's tests/test_serve.py measured 63% relative
    on an expansive random GRU, a few % on a contractive one), so it is
    opt-in."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (expected 'f32' or 'bf16')")
    if precision == "f32":
        yield gen
        return
    with bf16_parameters(gen):
        yield lambda *args, **kwargs: cast_floats(
            gen(*cast_floats(args, torch.float32, torch.bfloat16), **kwargs),
            torch.bfloat16, torch.float32)


def _device_of(gen: torch.nn.Module) -> torch.device:
    return next(gen.parameters()).device


def window_features(audio_windows: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(N, L) window audio -> (N, 37, mfcc_length) MFCC features (the fused
    mel kernel on the card)."""
    return dsp.get_mfcc_features_fast(
        audio_windows, sr=C.AUDIO_SR, num_mfcc=cfg.num_mfcc)[..., : cfg.mfcc_length]


@torch.no_grad()
def window_forward(run, cfg: ModelConfig, feat: torch.Tensor, text: torch.Tensor,
                   vid_idx: torch.Tensor, seed: torch.Tensor,
                   eps: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """One window of B clips through the generator call `run` (the
    generator, or `precision_wrap`'s): the pre-sequence holds the `seed`
    poses (B, n_pre, D) with their constraint bit; returns the raw window
    output (B, T, D)."""
    n_pre = cfg.n_pre_poses
    pre = torch.zeros(feat.shape[0], cfg.n_poses, C.POSE_DIM + 1, device=feat.device)
    pre[:, :n_pre, :-1] = seed
    pre[:, :n_pre, -1] = 1.0
    out, *_ = run(pre, text, feat, vid_idx, eps=eps, generator=generator)
    return out


@torch.no_grad()
def clip_body(gen, cfg: ModelConfig, audio_windows: torch.Tensor,
              text_windows: torch.Tensor, vid_idx: torch.Tensor,
              seed: torch.Tensor, n_valid, eps: torch.Tensor | None = None,
              generator: torch.Generator | None = None, precision: str = "f32",
              use_mfcc: bool = True, n_run: int | None = None):
    """The serving computation for B clips at once, the generator at
    `precision` (`precision_wrap`).

    audio_windows (B, S, L) float32, text_windows (B, S, T) int64, vid_idx
    (B,), seed (B, n_pre, D), n_valid: each clip's real window count (a
    sequence of B ints), eps: optional per-window noise (>= max(n_valid),
    B, z_size), else drawn from `generator`. The generator eats each
    window's MFCCs, or with `use_mfcc=False` its raw audio (B, L).

    Returns dir_vec (B, F, D) and poses (B, F, J, 3) with F = (S' - 1) *
    stride + T, S' = max(n_valid), or `n_run` windows where given (ranks
    that split a batch run its longest clip's count). Rows past a clip's
    own (n_valid - 1) * stride + T are not its output; the caller slices
    them off. Windows past max(n_valid) only ever append such rows, so the
    loop stops there.
    """
    n_pre, t = cfg.n_pre_poses, cfg.n_poses
    stride = t - n_pre
    b, s, _ = audio_windows.shape
    device = audio_windows.device
    n_valid = [int(n) for n in n_valid]
    s_run = max(n_valid) if n_run is None else n_run

    if use_mfcc:
        feat = window_features(audio_windows.reshape(b * s, -1), cfg)
        feat = feat.reshape(b, s, *feat.shape[1:])
    else:
        feat = audio_windows

    outs = []
    sd = seed
    with precision_wrap(gen, precision) as run:
        for i in range(s_run):
            out = window_forward(run, cfg, feat[:, i], text_windows[:, i], vid_idx, sd,
                                 eps=None if eps is None else eps[i], generator=generator)
            outs.append(out)
            sd = out[:, -n_pre:]
    outs = torch.stack(outs, dim=1)                            # (B, S', T, D)

    # each window's first n_pre frames mixed with the previous window's
    # last n_pre raw frames (ref processor_v2.py:1302-1331)
    blended = outs.clone()
    if s_run > 1:
        wp, wn = (torch.from_numpy(w).to(device)[:, None]
                  for w in crossfade_weights(n_pre))
        blended[:, 1:, :n_pre] = outs[:, :-1, -n_pre:] * wp + outs[:, 1:, :n_pre] * wn

    valid = torch.tensor(n_valid, device=device)[:, None, None]
    dir_vec = torch.zeros(b, (s_run - 1) * stride + t, outs.shape[-1], device=device)
    for i in range(s_run):
        lo = i * stride
        dir_vec[:, lo:lo + t] = torch.where(i < valid, blended[:, i],
                                            dir_vec[:, lo:lo + t])
    mean_vec = torch.from_numpy(cfg.mean_dir_vec_array).to(device)
    poses = pose_ops.convert_dir_vec_to_pose(dir_vec + mean_vec)
    return dir_vec, poses


def _poses_of(dir_vec: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    vec = torch.from_numpy(dir_vec + cfg.mean_dir_vec_array)
    return pose_ops.convert_dir_vec_to_pose(vec).numpy()


def synthesize_clips_batched(gen, clips, lang_model, cfg: ModelConfig,
                             eps: torch.Tensor | None = None,
                             generator: torch.Generator | None = None,
                             sample_rate: int = C.AUDIO_SR, fade_out=False,
                             seeds=None, timings: dict | None = None,
                             precision: str = "f32", use_mfcc: bool = True,
                             mesh: P.DataMesh | P.Mesh2D | None = None,
                             pad_to: int | None = None):
    """Synthesize many clips in one pass, the clips as the generator batch.

    clips: iterable of (clip_audio, clip_words, vid_idx). All clips are
    padded to one window-count bucket (`window_bucket` of the longest).
    eps: optional (S, B, z_size) per-window noise, column b clip b's own
    (so that a clip draws the same noise alone and in a batch); seeds:
    optional per-clip (n_pre, D) seed vectors (default zeros, the mean
    pose); fade_out: a bool or one per clip; precision: the generator's,
    "f32" or "bf16" (`precision_wrap`); use_mfcc: False for a generator
    that eats raw audio (`clip_body`). pad_to: pad the clip axis to a
    multiple of it with dummy lanes (speaker 0, one window of silence,
    zero noise), whose results are dropped. mesh: split the lanes over its
    data axis (JAX `make_batched_clip_fn(mesh=)`), which they must divide
    (ValueError otherwise), and which takes `pad_to`; a collective, every
    rank of the mesh calls it with the same clips; the noise drawn from
    `generator` is then the draw over all lanes. Returns a list of
    (dir_vec (F_i, D), poses (F_i, J, 3)) numpy pairs, every clip's on
    every rank. timings, if given, receives prep_ms (host window
    planning), device_ms (the body and the copy back) and post_ms (host
    slicing and fades).
    """
    t_start = time.perf_counter()
    clips = list(clips)
    if not clips:
        return []
    if mesh is not None and pad_to is None:
        raise ValueError("synthesis over a mesh takes pad_to")
    grid = mesh if isinstance(mesh, P.Mesh2D) else None
    data = mesh.data if grid is not None else mesh
    n_clips = len(clips)
    n_lanes = n_clips + ((-n_clips) % pad_to if pad_to else 0)
    lanes = slice(None) if data is None else data.rows(n_lanes)
    fades = (list(fade_out) if isinstance(fade_out, (list, tuple, np.ndarray))
             else [fade_out] * n_clips)
    device = _device_of(gen)
    prepped = [prepare_window_inputs(audio, words, lang_model, cfg, sample_rate)
               for audio, words, _ in clips]
    n_windows = [len(a) for a, _, _ in prepped]
    bucket = window_bucket(max(n_windows))
    audio_w = np.zeros((n_lanes, bucket, prepped[0][0].shape[1]), np.float32)
    text_w = np.zeros((n_lanes, bucket, cfg.n_poses), np.int64)
    for i, (a, tx, _) in enumerate(prepped):
        audio_w[i, : len(a)] = a
        text_w[i, : len(tx)] = tx
    seed_arr = np.zeros((n_lanes, cfg.n_pre_poses, C.POSE_DIM), np.float32)
    if seeds is not None:
        seed_arr[:n_clips] = np.stack([np.asarray(s[: cfg.n_pre_poses], np.float32)
                                       for s in seeds])
    vids = np.array([int(vid) for _, _, vid in clips] + [0] * (n_lanes - n_clips))
    n_valid = np.array(n_windows + [1] * (n_lanes - n_clips))
    if eps is not None and n_lanes > n_clips:
        eps = torch.cat([eps, eps.new_zeros(eps.shape[0], n_lanes - n_clips, *eps.shape[2:])],
                        dim=1)
    t_prep = time.perf_counter()
    with (P.gathered((gen,), grid) if grid is not None else contextlib.nullcontext()), \
            P.stepping(data, len(vids[lanes])):
        dir_vec_full, poses_full = clip_body(
            gen, cfg,
            torch.from_numpy(audio_w[lanes]).to(device),
            torch.from_numpy(text_w[lanes]).to(device),
            torch.from_numpy(vids[lanes]).to(device),
            torch.from_numpy(seed_arr[lanes]).to(device), n_valid[lanes],
            eps=None if eps is None else eps[:, lanes].to(device), generator=generator,
            precision=precision, use_mfcc=use_mfcc, n_run=max(n_windows))
    if data is not None:
        dir_vec_full = P.all_gather_rows(dir_vec_full, data)
        poses_full = P.all_gather_rows(poses_full, data)
    dir_vec_full = dir_vec_full.cpu().numpy()
    poses_full = poses_full.cpu().numpy()
    t_device = time.perf_counter()
    stride = cfg.n_poses - cfg.n_pre_poses
    out = []
    for i, (_, _, end_padding) in enumerate(prepped):
        n_real = (n_windows[i] - 1) * stride + cfg.n_poses
        dv = dir_vec_full[i, :n_real]
        ps = poses_full[i, :n_real]
        if fades[i]:
            dv = fade_out_poses(dv.copy(), end_padding, cfg, sample_rate)
            ps = _poses_of(dv, cfg)
        out.append((dv, ps))
    if timings is not None:
        t_end = time.perf_counter()
        timings["prep_ms"] = (t_prep - t_start) * 1e3
        timings["device_ms"] = (t_device - t_prep) * 1e3
        timings["post_ms"] = (t_end - t_device) * 1e3
    return out


def synthesize_clip_fused(gen, clip_audio: np.ndarray, clip_words, lang_model,
                          cfg: ModelConfig, vid_idx: int = 0,
                          eps: torch.Tensor | None = None,
                          generator: torch.Generator | None = None,
                          sample_rate: int = C.AUDIO_SR, fade_out: bool = False,
                          timings: dict | None = None, precision: str = "f32",
                          seed_dir_vec: np.ndarray | None = None,
                          use_mfcc: bool = True):
    """One clip through `clip_body` (generator batch 1). eps: optional
    (S, 1, z_size); seed_dir_vec: the first window's seed poses, (>= n_pre,
    D) mean-normalized direction vectors (default zeros, the mean pose).
    Returns (dir_vec (F, D), poses (F, J, 3)) numpy arrays."""
    return synthesize_clips_batched(
        gen, [(clip_audio, clip_words, vid_idx)], lang_model, cfg, eps=eps,
        generator=generator, sample_rate=sample_rate, fade_out=fade_out,
        seeds=None if seed_dir_vec is None else [seed_dir_vec],
        timings=timings, precision=precision, use_mfcc=use_mfcc)[0]
