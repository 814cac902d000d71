"""Fused mel power of windowed frames: CUDA kernel and plain version.

Replaces the TPU kernel `speech2affective_gestures_tpu/ops/dsp_pallas.py
::_mel_kernel` (reached there through `fused_mel_power_frames`):
mel = ((F.C)^2 + (F.S)^2).M for Hann-windowed frames F, real-DFT matrices C
and S and the Slaney mel filterbank M, without the power spectrum ever
reaching device memory. The TPU kernel computes the spectrum as two dense
products, a fit for its matrix unit; the kernel here, `csrc/mel_power.cu`,
computes it with a real FFT in shared memory instead: each row of n_fft
samples is packed as an n_fft/2-point complex sequence, transformed by a
Stockham radix-4 FFT, split into the 1 + n_fft/2 real-FFT bins and squared,
and each mel band sums its own contiguous run of bins from a packed table
(`kernel_tables`). One launch, no workspace; each band's sum runs in a
fixed order, so the result is deterministic. The plain version keeps the
dense products (`dft_constants`).

`mel_power` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, dsp_ref

N_MELS = 128     # the kernel's NMEL
# the n_fft the kernel takes: powers of two whose n_fft/2 complex points
# fill its 2048-point shared-memory buffer with whole rows
MIN_N_FFT, MAX_N_FFT = 512, 4096

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


@functools.lru_cache(maxsize=None)
def dft_constants(sr: int, n_fft: int, n_mels: int):
    """cos, sin (n_fft, 1 + n_fft/2) and mel (1 + n_fft/2, n_mels) float32
    numpy arrays: the plain version's real-DFT matrices and filterbank."""
    n_bins = 1 + n_fft // 2
    ang = 2.0 * np.pi * (np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :]) / n_fft
    mel = np.ascontiguousarray(dsp_ref.mel_filterbank(sr, n_fft, n_mels).T)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32), mel


@functools.lru_cache(maxsize=None)
def kernel_tables(sr: int, n_fft: int, n_mels: int):
    """The kernel's constants, float64 rounded once to float32:

    fft_tw (M, 2): e^{-2 pi i k / M}, k < M = n_fft/2, the FFT's twiddles;
    split_tw (M/2 + 1, 2): (cos, sin) of 2 pi k / n_fft, k <= M/2, the
      real-FFT split's;
    bands (n_mels, 3) int32: each band's first bin, its bin count and the
      offset of its weights in `weights`;
    weights: the filterbank's entries from each band's first to its last
      nonzero bin, band after band (the dense filterbank's own float32
      values, so the table rebuilds it exactly).
    """
    m = n_fft // 2
    k = np.arange(m)
    fft_tw = np.stack([np.cos(2.0 * np.pi * k / m), -np.sin(2.0 * np.pi * k / m)], -1)
    k = np.arange(m // 2 + 1)
    split_tw = np.stack([np.cos(2.0 * np.pi * k / n_fft),
                         np.sin(2.0 * np.pi * k / n_fft)], -1)
    mel = dft_constants(sr, n_fft, n_mels)[2]
    bands, weights = [], []
    for col in mel.T:
        nz = np.flatnonzero(col)
        lo, n = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        bands.append((lo, n, sum(len(w) for w in weights)))
        weights.append(col[lo:lo + n])
    return (fft_tw.astype(np.float32), split_tw.astype(np.float32),
            np.asarray(bands, np.int32), np.concatenate(weights).astype(np.float32))


_device_tensors: dict = {}


def _on_device(fn, device: torch.device, sr: int, n_fft: int, n_mels: int):
    """fn(sr, n_fft, n_mels)'s numpy arrays as tensors on `device`, built
    once per device."""
    key = (fn.__name__, str(device), sr, n_fft, n_mels)
    if key not in _device_tensors:
        _device_tensors[key] = tuple(torch.from_numpy(a).to(device)
                                     for a in fn(sr, n_fft, n_mels))
    return _device_tensors[key]


def mel_power_plain(frames: torch.Tensor, sr: int = 16000,
                    n_mels: int = N_MELS) -> torch.Tensor:
    """Windowed frames (R, n_fft) -> mel power (R, n_mels), three float32
    products."""
    cos, sin, mel = _on_device(dft_constants, frames.device, sr, frames.shape[-1], n_mels)
    re = frames @ cos
    im = frames @ sin
    return (re * re + im * im) @ mel


def check_kernel_shape(n_fft: int, n_mels: int) -> None:
    """Raise unless the kernel takes this n_fft and n_mels."""
    if (n_fft & (n_fft - 1) or not MIN_N_FFT <= n_fft <= MAX_N_FFT
            or n_mels != N_MELS):
        raise ValueError(f"mel_power: the kernel takes n_fft a power of two in "
                         f"[{MIN_N_FFT}, {MAX_N_FFT}] and n_mels={N_MELS}, got "
                         f"n_fft={n_fft}, n_mels={n_mels}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("mel_power").s2ag_mel_power
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mel_power(frames: torch.Tensor, sr: int = 16000,
              n_mels: int = N_MELS) -> torch.Tensor:
    """`mel_power_plain`'s contract; the CUDA kernel for CUDA tensors."""
    global launches
    if frames.device.type == "cpu":
        return mel_power_plain(frames, sr, n_mels)
    if frames.device.type != "cuda":
        raise ValueError(f"mel_power: unsupported device {frames.device}")
    if frames.dtype != torch.float32:
        raise TypeError(f"mel_power: frames must be float32, got {frames.dtype}")
    if frames.dim() != 2 or frames.shape[0] < 1:
        raise ValueError(f"mel_power: frames must be (R, n_fft), got {tuple(frames.shape)}")
    if not frames.is_contiguous() or frames.data_ptr() % 16:
        raise ValueError("mel_power: frames must be contiguous and 16-byte "
                         "aligned (the kernel loads float4)")
    R, n_fft = frames.shape
    check_kernel_shape(n_fft, n_mels)
    fft_tw, split_tw, bands, weights = _on_device(kernel_tables, frames.device, sr,
                                                  n_fft, n_mels)
    out = torch.empty((R, n_mels), device=frames.device, dtype=torch.float32)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = _kernel()(frames.data_ptr(), fft_tw.data_ptr(), split_tw.data_ptr(),
                       bands.data_ptr(), weights.data_ptr(), out.data_ptr(), R, n_fft,
                       stream)
    if rc != 0:
        raise RuntimeError(f"mel_power kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
