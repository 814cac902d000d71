"""One (bi)directional GRU layer's forward: CUDA kernel and plain version.

Replaces the TPU kernel `speech2affective_gestures_tpu/ops/gru_pallas.py
::_fwd_kernel_v2` (reached there through `run_layer_v2`). The kernel is
`csrc/gru_fwd.cu`: one block per (batch tile, direction) runs the whole
time loop with h in shared memory. On the H100 it is bound by one SM's L2
bandwidth, because W_hh (1.08 MB per direction at H=300) does not fit in
shared memory and is streamed from L2 every step; the design keeps 16 loads
of W in flight per thread to cover the latency. `csrc/gru_fwd.cu` says more.

`gru_layer` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def gru_layer_plain(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                    b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as a plain time loop.

    xp (T, B, D*3H) input projections without bias; w_hh (D, H, 3H);
    b_ih, b_hh (D, 3H). Returns ys (T, B, D*H), both directions in forward
    time order, and h_last (D, B, H): the final state of each direction's
    walk (the reverse direction ends at forward time 0).
    """
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    x = xp.view(T, B, D, 3 * H) + b_ih
    # direction-major, the reverse direction's inputs flipped in time
    x = torch.stack([x[:, :, 0]] + ([x[:, :, 1].flip(0)] if D == 2 else []),
                    dim=1)                                   # (T, D, B, 3H)
    h = xp.new_zeros(D, B, H)
    ys = []
    for t in range(T):
        hp = torch.bmm(h, w_hh) + b_hh[:, None, :]
        xt = x[t]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
        n = torch.tanh(xt[..., 2 * H:] + r * hp[..., 2 * H:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    ys = torch.stack(ys)                                     # (T, D, B, H)
    outs = [ys[:, 0]] + ([ys[:, 1].flip(0)] if D == 2 else [])
    return torch.cat(outs, dim=-1), h


def _check(xp, w_hh, b_ih, b_hh):
    tensors = {"xp": xp, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
    for name, t in tensors.items():
        if t.device != xp.device:
            raise ValueError(f"gru_layer: {name} is on {t.device}, xp on {xp.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gru_layer: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gru_layer: {name} must be contiguous")
    if xp.dim() != 3 or w_hh.dim() != 3:
        raise ValueError("gru_layer: xp must be (T, B, D*3H) and w_hh (D, H, 3H)")
    D, H, H3 = w_hh.shape
    if H3 != 3 * H or D not in (1, 2):
        raise ValueError(f"gru_layer: w_hh shape {tuple(w_hh.shape)} is not (D, H, 3H)")
    if xp.shape[2] != D * H3 or xp.shape[0] < 1 or xp.shape[1] < 1:
        raise ValueError(f"gru_layer: xp shape {tuple(xp.shape)} does not match "
                         f"D={D}, H={H}")
    for name, b in (("b_ih", b_ih), ("b_hh", b_hh)):
        if tuple(b.shape) != (D, H3):
            raise ValueError(f"gru_layer: {name} shape {tuple(b.shape)} != {(D, H3)}")


def gru_layer(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gru_layer_plain`'s contract; the CUDA kernel for CUDA tensors."""
    global launches
    if xp.device.type == "cpu":
        return gru_layer_plain(xp, w_hh, b_ih, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {xp.device}")
    _check(xp, w_hh, b_ih, b_hh)
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    lib = _build.load("gru_fwd")
    fn = lib.s2ag_gru_layer_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ys = torch.empty((T, B, D * H), device=xp.device, dtype=torch.float32)
    h_last = torch.empty((D, B, H), device=xp.device, dtype=torch.float32)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = fn(xp.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
                b_hh.data_ptr(), ys.data_ptr(), h_last.data_ptr(),
                T, B, H, D, stream)
    if rc != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return ys, h_last
