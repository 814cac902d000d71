"""The yardstick: the H100's data-sheet peaks and the least work of the
kernels whose roofline shares the benchmark reports, as frozen copies of
the arithmetic in chip_smoke.py (`bound`, `shape_timing`'s GRU bytes and
operations, `mel_other_timing`'s mel bytes and operations). A later change
to the program does not change what these count."""

from __future__ import annotations

import math
import re

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 on the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time of a function on the card: its bytes over the memory
    rate or its operations over the peak rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES, flops / peak_flops)


def gru_work(kernel: str, dtype: str, T: int, B: int, H: int, D: int = 2):
    """(bytes, operations, peak) of one GRU kernel call ("gru_fwd" the
    forward, "gru_bwd" the backward recurrence, "gru_dw" the weight
    gradient) at (T, B, H, D directions), float32 or bfloat16 storage:
    each input read once and each output written once."""
    xp, ys, w_hh, b = T * B * D * 3 * H, T * B * D * H, D * H * 3 * H, D * 3 * H
    n_prod = 2 * T * B * D * H * 3 * H
    dw_flops = 2 * T * B * D * (H + 1) * 3 * H
    if dtype == "bfloat16":
        work = {"gru_fwd": (2 * (xp + w_hh + 2 * b + ys + D * B * H), n_prod + T * B * D * 15 * H),
                "gru_bwd": (2 * (2 * xp + 3 * ys + w_hh + b) + 4 * xp, n_prod + 30 * T * B * D * H),
                "gru_dw": (2 * (ys + 2 * xp // 3 + ys) + 4 * (w_hh + b), dw_flops)}
        nbytes, flops = work[kernel]
        return nbytes, flops, PEAK_BF16_FLOPS
    work = {"gru_fwd": (4 * (xp + w_hh + 2 * b + ys + D * B * H),
                        T * D * B * (2 * H * 3 * H + 3 * H + 12 * H)),
            "gru_bwd": (4 * (3 * xp + 3 * ys + w_hh + b), n_prod + 30 * T * B * D * H),
            "gru_dw": (4 * (ys + 2 * xp // 3 + ys + w_hh + b), dw_flops)}
    nbytes, flops = work[kernel]
    return nbytes, flops, PEAK_F32_FLOPS


def mel_work(rows: int, n_fft: int, n_mels: int, nnz: int):
    """(bytes, operations) of the mel power of `rows` windowed frames: a
    real FFT of each row (5 (n/2) log2 n), the power of each bin, the
    filterbank's nonzeros; bytes the frames, the filterbank's nonzeros and
    the output, float32."""
    n_bins = n_fft // 2 + 1
    flops = rows * (5 * (n_fft // 2) * math.log2(n_fft) + 3 * n_bins + 2 * nnz)
    return 4 * (rows * n_fft + nnz + rows * n_mels), flops


_FAMILIES = (("gru_fwd", re.compile(r"\bgru_layer_fwd")),
             ("gru_bwd", re.compile(r"\bgru_layer_bwd")),
             ("gru_dw", re.compile(r"\bgru_dw")),
             ("mel", re.compile(r"\bmel_(fft|dft)")),
             ("nccl", re.compile(r"nccl", re.IGNORECASE)))


def kernel_family(name: str) -> str | None:
    """Which of the kernels the benchmark reads a profiler's (demangled)
    kernel name belongs to: "gru_fwd", "gru_bwd", "gru_dw", "mel", "nccl"
    or None."""
    for family, pattern in _FAMILIES:
        if pattern.search(name):
            return family
    return None
