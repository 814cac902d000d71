"""Numpy constants of the MFCC front-end, librosa 0.8 conventions.

Periodic Hann window, Slaney-scale 128-band mel filterbank with Slaney area
normalization, orthonormal DCT-II over the mel axis — the pieces the
reference's `librosa.feature.mfcc` call (`utils/common.py:340-349`) is built
from. `ops/dsp.py` turns them into device tensors.
"""

from __future__ import annotations

import functools

import numpy as np


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', n, fftbins=True))."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa hz_to_mel(htk=False))."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) Slaney-normalized triangular mel filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in): rows k, X = D @ x."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    d = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * n_in))
    d *= np.sqrt(2.0 / n_in)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)
