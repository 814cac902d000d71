"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises instead of
    quietly running on the CPU: the CPU path is the kernels' plain PyTorch
    versions, which a caller must choose explicitly with `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on an NVIDIA GPU "
            "by default; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def set_f32_numerics() -> None:
    """Full-f32 products and convolutions on the card. cuDNN convolutions
    default to TF32, which keeps about three decimal digits; the JAX serve
    path pins 'highest' precision, and the port matches it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
