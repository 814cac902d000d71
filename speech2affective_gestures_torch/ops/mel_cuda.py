"""Fused mel power of windowed frames: CUDA kernel and plain version.

Replaces the TPU kernel `speech2affective_gestures_tpu/ops/dsp_pallas.py
::_mel_kernel` (reached there through `fused_mel_power_frames`):
mel = ((F.C)^2 + (F.S)^2).M for Hann-windowed frames F, real-DFT matrices C
and S and the Slaney mel filterbank M, without the power spectrum ever
reaching device memory. The kernel is `csrc/mel_power.cu`: one block per
(row tile, bin chunk), so that the few hundred rows of a request fill the
card, then a second pass that adds the chunks' partial mel sums in a fixed
order. It computes the dense DFT, as the TPU kernel does, in plain float32
FMA (no TF32) to match the JAX package's Precision.HIGHEST products, so it
is bound by the float32 FMA rate and by reading C and S from L2 once per
row tile; the function's own least time, with an FFT, is that of reading
the frames. `csrc/mel_power.cu` says more.

`mel_power` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, dsp_ref

BIN_CHUNK = 32   # the kernel's NBC: bins are zero-padded to a multiple
N_MELS = 128     # the kernel's NMEL
K_TILE = 32      # the kernel's KT: n_fft must be a multiple

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


@functools.lru_cache(maxsize=None)
def padded_constants(sr: int, n_fft: int, n_mels: int):
    """cos, sin (n_fft, nbp) and mel (nbp, n_mels) float32 numpy arrays,
    the bin axis zero-padded from 1 + n_fft/2 to a multiple of BIN_CHUNK."""
    n_bins = 1 + n_fft // 2
    nbp = -(-n_bins // BIN_CHUNK) * BIN_CHUNK
    t = np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    cos = np.zeros((n_fft, nbp), np.float32)
    sin = np.zeros((n_fft, nbp), np.float32)
    cos[:, :n_bins] = np.cos(ang)
    sin[:, :n_bins] = np.sin(ang)
    mel = np.zeros((nbp, n_mels), np.float32)
    mel[:n_bins] = dsp_ref.mel_filterbank(sr, n_fft, n_mels).T
    return cos, sin, mel


_device_constants: dict = {}


def device_constants(device: torch.device, sr: int, n_fft: int, n_mels: int):
    """`padded_constants` as tensors on `device`, built once per device."""
    key = (str(device), sr, n_fft, n_mels)
    if key not in _device_constants:
        _device_constants[key] = tuple(
            torch.from_numpy(a).to(device)
            for a in padded_constants(sr, n_fft, n_mels))
    return _device_constants[key]


def mel_power_plain(frames: torch.Tensor, sr: int = 16000,
                    n_mels: int = N_MELS) -> torch.Tensor:
    """Windowed frames (R, n_fft) -> mel power (R, n_mels), three float32
    products."""
    cos, sin, mel = device_constants(frames.device, sr, frames.shape[-1], n_mels)
    re = frames @ cos
    im = frames @ sin
    return (re * re + im * im) @ mel


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
    if n_fft % K_TILE or n_mels != N_MELS:
        raise ValueError(f"mel_power: the kernel takes n_fft a multiple of "
                         f"{K_TILE} and n_mels={N_MELS}, got {n_fft}, {n_mels}")
    cos, sin, mel = device_constants(frames.device, sr, n_fft, n_mels)
    lib = _build.load("mel_power")
    fn = lib.s2ag_mel_power
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbp = cos.shape[1]
    part = torch.empty((nbp // BIN_CHUNK, R, n_mels), device=frames.device,
                       dtype=torch.float32)
    out = torch.empty((R, n_mels), device=frames.device, dtype=torch.float32)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                mel.data_ptr(), part.data_ptr(), out.data_ptr(), R, n_fft,
                nbp, n_mels, stream)
    if rc != 0:
        raise RuntimeError(f"mel_power kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
