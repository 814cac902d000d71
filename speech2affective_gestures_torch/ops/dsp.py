"""Batched STFT -> mel -> log-mel -> MFCC on device.

The reference computes these features with librosa on the host
(`utils/common.py:340-349`); here the whole batch of windows is framed with
one `unfold`. The DFT -> power -> mel chain goes through
`mel_cuda.mel_power`: the fused mel kernel on a CUDA tensor, its plain
float32 products on a CPU tensor.
Numerics follow librosa 0.8 defaults (`ops/dsp_ref.py`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import dsp_ref, mel_cuda


@functools.lru_cache(maxsize=None)
def _hann(n_fft: int, device: str) -> torch.Tensor:
    return torch.from_numpy(dsp_ref.hann_window(n_fft).astype("float32")).to(device)


@functools.lru_cache(maxsize=None)
def _dct(n_mfcc: int, n_mels: int, device: str) -> torch.Tensor:
    return torch.from_numpy(dsp_ref.dct_matrix(n_mfcc, n_mels).T.copy()).to(device)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Centred framing with reflect padding: (..., L) -> (..., T, n_fft)."""
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2),
              mode="reflect")
    frames = y[:, 0].unfold(-1, n_fft, hop_length)
    return frames.reshape(lead + frames.shape[-2:])


def windowed_frames(y: torch.Tensor, n_fft: int = 2048,
                    hop_length: int = 512) -> torch.Tensor:
    """Hann-windowed frames (..., T, n_fft) of a float32 waveform."""
    frames = frame_signal(y.to(torch.float32), n_fft, hop_length)
    return frames * _hann(n_fft, str(frames.device))


def mel_power_spectrogram(y: torch.Tensor, sr: int = 16000, n_fft: int = 2048,
                          hop_length: int = 512, n_mels: int = 128) -> torch.Tensor:
    """(..., L) waveform -> (..., T, n_mels) mel power spectrogram."""
    frames = windowed_frames(y, n_fft, hop_length)
    lead = frames.shape[:-1]
    mel = mel_cuda.mel_power(frames.reshape(-1, n_fft), sr, n_mels)
    return mel.reshape(lead + (n_mels,))


def power_to_db(s: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0,
                max_axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """librosa power_to_db; `max_axes` are the axes the top_db clamp takes
    its maximum over (per window for batched inputs; None = all axes)."""
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        if max_axes is None:
            m = log_spec.max()
        else:
            m = log_spec.amax(dim=max_axes, keepdim=True)
        log_spec = torch.maximum(log_spec, m - top_db)
    return log_spec


def mfcc_tail_from_mel(mel: torch.Tensor, num_mfcc: int, n_mels: int) -> torch.Tensor:
    """power_to_db -> DCT -> /1000 -> coefficient-axis differences
    (ref utils/common.py:340-349). mel (..., T, n_mels) ->
    (..., 3*num_mfcc-5, T)."""
    s_db = power_to_db(mel, max_axes=(-2, -1))
    m = (s_db @ _dct(num_mfcc, n_mels, str(mel.device))).transpose(-1, -2) / 1000.0
    d1 = m[..., 2:, :] - m[..., 1:-1, :]
    d2 = d1[..., 1:, :] - d1[..., :-1, :]
    return torch.cat((m, d1, d2), dim=-2)


def get_mfcc_features(audio: torch.Tensor, sr: int = 16000, num_mfcc: int = 14,
                      n_mels: int = 128) -> torch.Tensor:
    """(..., L) -> (..., 3*num_mfcc-5, T) MFCC + differences."""
    mel = mel_power_spectrogram(audio, sr=sr, n_mels=n_mels)
    return mfcc_tail_from_mel(mel, num_mfcc, n_mels)


# the JAX package's name for its kernel path; here the device decides
get_mfcc_features_fast = get_mfcc_features
