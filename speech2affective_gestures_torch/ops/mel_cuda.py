"""Fused mel power of windowed frames: CUDA kernel and plain version.

Replaces the TPU kernel `speech2affective_gestures_tpu/ops/dsp_pallas.py
::_mel_kernel` (reached there through `fused_mel_power_frames`):
mel = ((F.C)^2 + (F.S)^2).M for Hann-windowed frames F, real-DFT matrices C
and S and the Slaney mel filterbank M, without the power spectrum ever
reaching device memory. The TPU kernel computes the spectrum as two dense
products, a fit for its matrix unit; the kernel here, `csrc/mel_power.cu`,
computes it with a real FFT in shared memory instead: each row of n_fft
samples is packed as an n_fft/2-point complex sequence, transformed by a
Stockham FFT (radix 4 and 2 passes, and radix 3 and 5 where n_fft/2 has
those factors), split into the 1 + n_fft/2 real-FFT bins and squared, and
each mel band sums its own contiguous run of bins from a packed table
(`kernel_tables`). One launch, no workspace; each band's sum runs in a
fixed order, so the result is deterministic. That is the FFT tier, for
even n_fft in [MIN_N_FFT, MAX_N_FFT] with n_fft/2 = 2^a 3^b 5^c (the
serving and corpus shapes, Whisper's 400; `fft_radices`). Every other
n_fft takes the DFT tier, the TPU kernel's own design:
a tiled product of the frames with the cos and sin of the real DFT (from
one table of N twiddles, `dft_tables`), squared and summed in registers and
multiplied by the filterbank in the same launch. Both tiers take any band
count; `mel_plan` names the tier of a shape. The plain version keeps the
dense products (`dft_constants`).

`mel_power` takes the plain version for a CPU tensor and launches a kernel
for a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, dsp_ref

N_MELS = 128     # the serving and corpus band count
# the n_fft of the FFT tier: even, with n_fft/2 = 2^a 3^b 5^c complex
# points, at most its 2048-point shared-memory buffer (whole rows of it a
# block) and at least 32 (at most 64 rows a block, so that a request's
# rows still spread over the SMs)
FFT_POINTS = 2048
MIN_N_FFT, MAX_N_FFT = 64, 2 * FFT_POINTS
# the DFT tier's rows a block, samples a stage and threads, and the most
# shared memory a block may opt into on the H100 (`csrc/mel_power.cu`)
DFT_ROWS, DFT_KT, DFT_THREADS = 8, 256, 256
SMEM_LIMIT = 232448

# kernel launches since the last reset, by (kernel, dtype): ("mel_fft",
# "float32") and ("mel_dft", "float32") (chip_smoke.py reads and resets it);
# the FFT tier's by its CUDA kernel, "power of two" (`mel_fft_kernel`) or
# "mixed radix" (`mel_fft_mixed_kernel`)
launches: collections.Counter = collections.Counter()
fft_launches: collections.Counter = collections.Counter()
# both; a launch recorded into a CUDA graph is counted at each replay
COUNTERS = (launches, fft_launches)


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
    return (fft_tw.astype(np.float32), split_tw.astype(np.float32)) + band_tables(
        sr, n_fft, n_mels)


@functools.lru_cache(maxsize=None)
def dft_tables(sr: int, n_fft: int, n_mels: int):
    """The DFT tier's constants: tw (N, 2), (cos, sin) of 2 pi m / N for m <
    N = n_fft, float64 rounded once to float32 (entry (n k) mod N is the
    dense matrices' (n, k) value), and `kernel_tables`' band table and
    weights."""
    m = np.arange(n_fft)
    tw = np.stack([np.cos(2.0 * np.pi * m / n_fft), np.sin(2.0 * np.pi * m / n_fft)], -1)
    return (tw.astype(np.float32),) + band_tables(sr, n_fft, n_mels)


@functools.lru_cache(maxsize=None)
def band_tables(sr: int, n_fft: int, n_mels: int):
    """bands (n_mels, 3) int32: each band's first bin, its bin count and the
    offset of its weights; weights: the dense filterbank's float32 entries
    from each band's first to its last nonzero bin, band after band (so the
    table rebuilds the filterbank exactly)."""
    mel = dft_constants(sr, n_fft, n_mels)[2]
    bands, weights = [], []
    for col in mel.T:
        nz = np.flatnonzero(col)
        lo, n = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        bands.append((lo, n, sum(len(w) for w in weights)))
        weights.append(col[lo:lo + n])
    return np.asarray(bands, np.int32), np.concatenate(weights).astype(np.float32)


class MelPlan(NamedTuple):
    """A launch of `csrc/mel_power.cu`: its tier ("fft" or "dft"), rows a
    block, blocks, dynamic shared-memory bytes (0 for the FFT tier's static
    buffers) and whether the DFT tier's twiddle table sits in it."""
    tier: str
    rows: int
    blocks: int
    smem: int
    tw_in_smem: bool


def fft_radices(n_fft: int) -> tuple[int, ...] | None:
    """The FFT tier's Stockham passes for n_fft, in the kernel's order
    (radix 2 when n_fft/2 holds an odd power of two, then radix 4, 3, 5),
    or None where the tier does not take n_fft: odd, outside [MIN_N_FFT,
    MAX_N_FFT], or n_fft/2 with a prime factor above 5."""
    if n_fft % 2 or not MIN_N_FFT <= n_fft <= MAX_N_FFT:
        return None
    m, count = n_fft // 2, {}
    for p in (2, 3, 5):
        count[p] = 0
        while m % p == 0:
            m //= p
            count[p] += 1
    if m != 1:
        return None
    return ((2,) * (count[2] % 2) + (4,) * (count[2] // 2) + (3,) * count[3]
            + (5,) * count[5])


def mel_plan(R: int, n_fft: int, n_mels: int) -> MelPlan:
    """The kernel's launch for R frames of n_fft samples into n_mels bands:
    the FFT tier where `fft_radices` takes n_fft (FFT_POINTS // (n_fft/2)
    whole rows a block), else the DFT tier, with its twiddles in shared
    memory where they fit."""
    if R < 1 or n_fft < 1 or n_mels < 1:
        raise ValueError(f"mel_power: no launch for R={R}, n_fft={n_fft}, n_mels={n_mels}")
    if fft_radices(n_fft) is not None:
        rows = FFT_POINTS // (n_fft // 2)
        return MelPlan("fft", rows, -(-R // rows), 0, False)
    base = 4 * (DFT_KT * DFT_ROWS + DFT_ROWS * DFT_THREADS + -(-DFT_ROWS * n_mels // 4) * 4)
    if base > SMEM_LIMIT:
        raise ValueError(f"mel_power: {n_mels} bands need more than {SMEM_LIMIT} bytes "
                         "of shared memory in the DFT tier")
    in_smem = base + 8 * n_fft <= SMEM_LIMIT
    return MelPlan("dft", DFT_ROWS, -(-R // DFT_ROWS), base + 8 * n_fft * in_smem, in_smem)


_device_tensors: dict = {}


def _on_device(fn, device: torch.device, sr: int, n_fft: int, n_mels: int):
    """fn(sr, n_fft, n_mels)'s numpy arrays as tensors on `device`, built
    once per device."""
    key = (fn.__name__, str(device), sr, n_fft, n_mels)
    if key not in _device_tensors:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"mel_power: the tables of n_fft {n_fft}, {n_mels} bands are "
                               "first asked for inside a CUDA graph capture: run the call "
                               "eagerly before capturing it")
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


@functools.lru_cache(maxsize=None)
def _kernel(tier: str):
    if tier == "fft":
        fn = _build.load("mel_power").s2ag_mel_power
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    else:
        fn = _build.load("mel_power").s2ag_mel_power_dft
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mel_power(frames: torch.Tensor, sr: int = 16000,
              n_mels: int = N_MELS) -> torch.Tensor:
    """`mel_power_plain`'s contract; the CUDA kernel for CUDA tensors."""
    if frames.device.type == "cpu":
        return mel_power_plain(frames, sr, n_mels)
    if frames.device.type != "cuda":
        raise ValueError(f"mel_power: unsupported device {frames.device}")
    if frames.dtype != torch.float32:
        raise TypeError(f"mel_power: frames must be float32, got {frames.dtype}")
    if frames.dim() != 2 or frames.shape[0] < 1:
        raise ValueError(f"mel_power: frames must be (R, n_fft), got {tuple(frames.shape)}")
    R, n_fft = frames.shape
    plan = mel_plan(R, n_fft, n_mels)
    if not frames.is_contiguous() or (plan.tier == "fft" and frames.data_ptr() % 16):
        raise ValueError("mel_power: frames must be contiguous, and 16-byte aligned "
                         "for the FFT tier (it loads float4)")
    out = torch.empty((R, n_mels), device=frames.device, dtype=torch.float32)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        if plan.tier == "fft":
            fft_tw, split_tw, bands, weights = _on_device(kernel_tables, frames.device, sr,
                                                          n_fft, n_mels)
            rc = _kernel("fft")(frames.data_ptr(), fft_tw.data_ptr(), split_tw.data_ptr(),
                                bands.data_ptr(), weights.data_ptr(), out.data_ptr(), R,
                                n_fft, n_mels, stream)
        else:
            tw, bands, weights = _on_device(dft_tables, frames.device, sr, n_fft, n_mels)
            rc = _kernel("dft")(frames.data_ptr(), tw.data_ptr(), bands.data_ptr(),
                                weights.data_ptr(), out.data_ptr(), R, n_fft, n_mels,
                                plan.smem, int(plan.tw_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"mel_power kernel launch failed: CUDA error {rc}")
    launches[(f"mel_{plan.tier}", "float32")] += 1
    if plan.tier == "fft":
        fft_launches["mixed radix" if n_fft & (n_fft - 1) else "power of two"] += 1
    return out
