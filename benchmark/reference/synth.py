"""The plain reference of long-clip gesture synthesis (reference
processor_v2.py:1144-1439, `render_clip`, with the MFCC front-end of
utils/common.py:340-349 at librosa 0.8's defaults): each clip cut into
34-frame windows at a stride of 30 frames, each window's MFCCs computed
from its audio, each window's generator forward seeded with the previous
window's last 4 poses, the windows crossfaded over 4 frames. Plain
PyTorch and numpy, float32 with TF32 off; it imports nothing of the
program under test, and no clip's result depends on another's."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_MELS = 2048, 512, 128


# ------------------------------------------------------------ MFCC front-end
def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz)
                    / (np.log(6.4) / 27.0), f / f_sp)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(np.log(6.4) / 27.0 * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) Slaney-scale, Slaney-normalized filterbank."""
    fft_f = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]).astype(np.float32)


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    n, k = np.arange(n_in), np.arange(n_out)[:, None]
    d = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


def mfcc(windows: torch.Tensor, sr: int, num_mfcc: int) -> torch.Tensor:
    """(N, L) window audio -> (N, 3 num_mfcc - 5, frames): centred
    reflect-padded frames under a periodic Hann window, power spectrum,
    mel, dB with an 80 dB floor under each window's peak, orthonormal
    DCT-II, / 1000, with its first and second coefficient differences."""
    y = F.pad(windows[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = y.unfold(-1, N_FFT, HOP)
    hann = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(N_FFT, device=y.device,
                                                            dtype=torch.float64) / N_FFT)
    spec = torch.fft.rfft(frames * hann.float(), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(sr, N_FFT, N_MELS)).to(y.device)
    mel = power @ fb.t()
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - 80.0)
    dct = torch.from_numpy(dct_matrix(num_mfcc, N_MELS)).to(y.device)
    m = (db @ dct.t()).transpose(-1, -2) / 1000.0
    d1 = m[..., 2:, :] - m[..., 1:-1, :]
    d2 = d1[..., 1:, :] - d1[..., :-1, :]
    return torch.cat((m, d1, d2), dim=-2)


# ------------------------------------------------------------- windowing
def plan(clip_seconds: float, m: dict):
    """The windows [(start, end)] of a clip (ref processor_v2.py:1200-1235)."""
    fps = m["motion_resampling_framerate"]
    unit = m["n_poses"] / fps
    stride = (m["n_poses"] - m["n_pre_poses"]) / fps
    n = 1 if clip_seconds < unit else math.ceil((clip_seconds - unit) / stride) + 1
    out = []
    for i in range(n):
        start = min(i * stride, clip_seconds)
        end = min(start + unit, clip_seconds)
        if start < end:
            out.append((start, end))
    return out, unit


def window_inputs(audio: np.ndarray, words, word_ids: dict, m: dict):
    """(audio windows (S, L), word ids (S, T)): each window's audio from
    its start, zero-padded; each word of a window at the frame where it
    starts, the padding id elsewhere and 3 for an unknown word."""
    sr = m["audio_sr"]
    length = len(audio) / sr
    windows, unit = plan(length, m)
    audio_len = int(unit * sr)
    t = m["n_poses"]
    aw = np.zeros((len(windows), audio_len), np.float32)
    tw = np.zeros((len(windows), t), np.int64)
    for i, (start, end) in enumerate(windows):
        a0 = math.floor(start / length * len(audio))
        seg = audio[a0:a0 + audio_len]
        aw[i, :len(seg)] = seg
        dur = (end - start) / t
        for word, ws, we in words:
            if ws >= end:
                break
            if we <= start:
                continue
            f = max(0, int(np.floor((ws - start) / dur)))
            if f < t:
                tw[i, f] = word_ids.get(word, 3)
    return aw, tw


# ---------------------------------------------------------------- clips
@torch.no_grad()
def render(gen, clips, word_ids: dict, m: dict, device) -> list[np.ndarray]:
    """Each clip's dir_vec (F, 27), for clips [(audio, words, speaker, eps
    (>= S, z))] of one window count S, run side by side (eval mode, no
    state shared between them): each window seeded with the previous
    window's last raw poses (zeros, the mean pose, before the first), the
    windows crossfaded over n_pre frames."""
    inputs = [window_inputs(a, w, word_ids, m) for a, w, _, _ in clips]
    s = len(inputs[0][0])
    if any(len(aw) != s for aw, _ in inputs):
        raise ValueError("render takes clips of one window count")
    b, n_pre, t = len(clips), m["n_pre_poses"], m["n_poses"]
    aw = torch.from_numpy(np.stack([x[0] for x in inputs])).to(device)
    feat = mfcc(aw.reshape(b * s, -1), m["audio_sr"], m["num_mfcc"])[..., :m["mfcc_length"]]
    feat = feat.reshape(b, s, *feat.shape[1:])
    text = torch.from_numpy(np.stack([x[1] for x in inputs])).to(device)
    vids = torch.tensor([v for _, _, v, _ in clips], device=device)
    eps = torch.stack([e[:s] for _, _, _, e in clips], dim=1).to(device)   # (S, B, z)
    seed = torch.zeros(b, n_pre, 27, device=device)
    outs = []
    for i in range(s):
        pre = torch.zeros(b, t, 28, device=device)
        pre[:, :n_pre, :-1] = seed
        pre[:, :n_pre, -1] = 1.0
        out = gen(pre, text[:, i], feat[:, i], vids, eps=eps[i])[0]
        outs.append(out)
        seed = out[:, -n_pre:]
    stride = t - n_pre
    j = torch.arange(n_pre, device=device, dtype=torch.float32)[:, None]
    w_prev, w_next = (n_pre - j) / (n_pre + 1), (j + 1) / (n_pre + 1)
    dir_vec = torch.zeros(b, (s - 1) * stride + t, 27, device=device)
    for i, o in enumerate(outs):
        if i > 0:
            o = torch.cat([outs[i - 1][:, -n_pre:] * w_prev + o[:, :n_pre] * w_next,
                           o[:, n_pre:]], dim=1)
        dir_vec[:, i * stride:i * stride + t] = o
    return list(dir_vec.cpu().numpy())
