"""One (bi)directional GRU layer, forward and backward: CUDA kernels and
their plain versions.

Forward: replaces the TPU kernel `speech2affective_gestures_tpu/ops/
gru_pallas.py::_fwd_kernel_v2` (reached there through `run_layer_v2`). The
kernel is `csrc/gru_fwd.cu`: one block per (batch tile, direction) runs the
whole time loop with h in shared memory. On the H100 it is bound by one
SM's L2 bandwidth, because W_hh (1.08 MB per direction at H=300) does not
fit in shared memory and is streamed from L2 every step; the design keeps
16 loads of W in flight per thread to cover the latency.

Backward: replaces `gru_pallas.py::_bwd_kernel_v2` (the `jax.custom_vjp`
backward of `_gru_layer_v2`). `csrc/gru_bwd.cu` holds two kernels: the
reverse-time recurrence (`gru_bwd`, the same block layout as the forward,
also bound by streaming W_hh from L2 into one SM per step) and the
deterministic reduction of dW_hh and db_hh over the T*B rows (`gru_dw`:
partial sums over row splits, then a fixed-order pass that adds them;
bound by float32 FMA throughput). The sources say more.

`GRULayerFunction` ties them into autograd. Each wrapper takes the plain
version for a CPU tensor and launches its kernel for a CUDA tensor; there
is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets them):
# the forward, the backward recurrence, the dW_hh reduction
launches = 0
bwd_launches = 0
dw_launches = 0


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


def _check(xp, w_hh, b_ih, b_hh, **more):
    tensors = {"xp": xp, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh, **more}
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
    T, B, _ = xp.shape
    for name, t in more.items():
        if tuple(t.shape) != (T, B, D * H):
            raise ValueError(f"gru_layer: {name} shape {tuple(t.shape)} != "
                             f"{(T, B, D * H)}")


def _lib_fn(name: str, symbol: str, n_ptr: int, n_int: int = 4):
    """A C entry point taking n_ptr pointers, n_int ints and the stream."""
    fn = getattr(_build.load(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def gru_layer_forward(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                      b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gru_layer_plain`'s contract; the forward kernel for CUDA tensors.
    Not differentiable on the card: `gru_layer` is the autograd entry."""
    global launches
    if xp.device.type == "cpu":
        return gru_layer_plain(xp, w_hh, b_ih, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {xp.device}")
    _check(xp, w_hh, b_ih, b_hh)
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    fn = _lib_fn("gru_fwd", "s2ag_gru_layer_fwd", 6)
    ys = torch.empty((T, B, D * H), device=xp.device, dtype=torch.float32)
    h_last = torch.empty((D, B, H), device=xp.device, dtype=torch.float32)
    _launch(fn, "gru_fwd", xp.device, xp.data_ptr(), w_hh.data_ptr(),
            b_ih.data_ptr(), b_hh.data_ptr(), ys.data_ptr(), h_last.data_ptr(),
            T, B, H, D)
    launches += 1
    return ys, h_last


def _prev_states(ys: torch.Tensor, D: int) -> torch.Tensor:
    """(T, B, D*H) -> (T, B, D, H): the state each step started from in its
    direction's walk (frame t-1 for direction 0, t+1 for direction 1; zero
    at the walk's first frame)."""
    T, B, _ = ys.shape
    y = ys.view(T, B, D, -1)
    zero = y.new_zeros(1, B, y.shape[-1])
    prev = [torch.cat([zero, y[:-1, :, 0]])]
    if D == 2:
        prev.append(torch.cat([y[1:, :, 1], zero]))
    return torch.stack(prev, dim=2)


def gru_bwd_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                             b_ih: torch.Tensor, b_hh: torch.Tensor,
                             ys: torch.Tensor, dys: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's recurrence as a plain reverse-time loop.

    ys from the forward, dys (T, B, D*H) the gradient of ys (with the
    gradient of h_last already added at the frame of each final state).
    Returns dxp (T, B, D*3H) = [dpre_r, dpre_z, dpre_n] and gn (T, B, D*H)
    = dpre_n * r, both in forward time order."""
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    x = xp.view(T, B, D, 3 * H) + b_ih
    hprev = _prev_states(ys, D)
    dy = dys.view(T, B, D, H)

    def walk(a):  # (T, B, D, ...) -> (T, D, B, ...) in each direction's walk order
        out = [a[:, :, 0]] + ([a[:, :, 1].flip(0)] if D == 2 else [])
        return torch.stack(out, dim=1)

    x, hprev, dy = walk(x), walk(hprev), walk(dy)
    w_t = w_hh.transpose(1, 2)
    carry = xp.new_zeros(D, B, H)
    dxs, gns = [], []
    for s in range(T - 1, -1, -1):
        hp = torch.bmm(hprev[s], w_hh) + b_hh[:, None, :]
        xt = x[s]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
        n = torch.tanh(xt[..., 2 * H:] + r * hp[..., 2 * H:])
        dh = dy[s] + carry
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_z = dh * (hprev[s] - n) * z * (1.0 - z)
        dpre_r = dpre_n * hp[..., 2 * H:] * r * (1.0 - r)
        g = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
        carry = dh * z + torch.bmm(g, w_t)
        dxs.append(torch.cat([dpre_r, dpre_z, dpre_n], dim=-1))
        gns.append(dpre_n * r)

    def unwalk(seq):  # reversed walk-order list of (D, B, C) -> (T, B, D*C)
        a = torch.stack(seq[::-1])                           # (T, D, B, C)
        outs = [a[:, 0]] + ([a[:, 1].flip(0)] if D == 2 else [])
        return torch.cat(outs, dim=-1)

    return unwalk(dxs), unwalk(gns)


def gru_bwd_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                       b_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor,
                       want_gn: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`gru_bwd_recurrence_plain`'s contract; the backward kernel for CUDA
    tensors. With want_gn=False (no weight gradient wanted) gn is not
    written and None is returned in its place."""
    global bwd_launches
    if xp.device.type == "cpu":
        dxp, gn = gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys)
        return dxp, gn if want_gn else None
    if xp.device.type != "cuda":
        raise ValueError(f"gru_bwd: unsupported device {xp.device}")
    _check(xp, w_hh, b_ih, b_hh, ys=ys, dys=dys)
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    dxp = torch.empty_like(xp)
    gn = torch.empty_like(ys) if want_gn else None
    fn = _lib_fn("gru_bwd", "s2ag_gru_layer_bwd", 9)
    _launch(fn, "gru_bwd", xp.device, xp.data_ptr(), w_hh.data_ptr(),
            w_hh_t.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(), ys.data_ptr(),
            dys.data_ptr(), dxp.data_ptr(), 0 if gn is None else gn.data_ptr(),
            T, B, H, D)
    bwd_launches += 1
    return dxp, gn


def gru_dw_plain(ys: torch.Tensor, dxp: torch.Tensor, gn: torch.Tensor,
                 D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dW_hh (D, H, 3H) = the sum over (t, b) of h_prev^T g with
    g = [dpre_r, dpre_z, dpre_n r], and db_hh (D, 3H) = the sum of g."""
    T, B, _ = ys.shape
    H = ys.shape[2] // D
    d = dxp.view(T, B, D, 3 * H)
    g = torch.cat([d[..., :2 * H], gn.view(T, B, D, H)], dim=-1)
    hprev = _prev_states(ys, D)
    dw = torch.einsum("tbdk,tbdj->dkj", hprev, g)
    return dw, g.sum(dim=(0, 1))


def gru_dw(ys: torch.Tensor, dxp: torch.Tensor, gn: torch.Tensor,
           D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`gru_dw_plain`'s contract; the reduction kernel for CUDA tensors."""
    global dw_launches
    if ys.device.type == "cpu":
        return gru_dw_plain(ys, dxp, gn, D)
    if ys.device.type != "cuda":
        raise ValueError(f"gru_dw: unsupported device {ys.device}")
    T, B, DH = ys.shape
    H = DH // D
    for name, t, shape in (("ys", ys, (T, B, D * H)), ("gn", gn, (T, B, D * H)),
                           ("dxp", dxp, (T, B, D * 3 * H))):
        if (t.device != ys.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"gru_dw: {name} must be a contiguous float32 "
                             f"{shape} tensor on {ys.device}")
    lib = _build.load("gru_bwd")
    splits = lib.s2ag_gru_dw_splits
    splits.argtypes, splits.restype = [ctypes.c_int] * 5, ctypes.c_int
    S = splits(T, B, H, D,
               torch.cuda.get_device_properties(ys.device).multi_processor_count)
    part = torch.empty((S, D, H + 1, 3 * H), device=ys.device, dtype=torch.float32)
    dw = torch.empty((D, H, 3 * H), device=ys.device, dtype=torch.float32)
    db = torch.empty((D, 3 * H), device=ys.device, dtype=torch.float32)
    fn = _lib_fn("gru_bwd", "s2ag_gru_layer_dw", 6, n_int=5)
    _launch(fn, "gru_dw", ys.device, ys.data_ptr(), dxp.data_ptr(),
            gn.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(),
            T, B, H, D, S)
    dw_launches += 1
    return dw, db


def fold_h_last(dys: torch.Tensor, dh_last: torch.Tensor | None) -> torch.Tensor:
    """Add the gradient of h_last (D, B, H) to dys (T, B, D*H) at the frame
    that produced each final state: the last frame for direction 0, the
    first for direction 1 (its walk runs backwards)."""
    dys = dys.contiguous()
    if dh_last is None:
        return dys
    D, _, H = dh_last.shape
    dys = dys.clone()
    dys[-1, :, :H] += dh_last[0]
    if D == 2:
        dys[0, :, H:] += dh_last[1]
    return dys


def gru_layer_bwd(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                  b_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor,
                  weights: bool = True):
    """Gradients of one layer: (dxp, dw_hh, db_ih, db_hh). The kernels for
    CUDA tensors, the plain versions for CPU tensors. With weights=False
    only dxp is computed (the others are None)."""
    D, H, _ = w_hh.shape
    dxp, gn = gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, want_gn=weights)
    if not weights:
        return dxp, None, None, None
    dw, db_hh = gru_dw(ys, dxp, gn, D)
    T, B, _ = xp.shape
    db_ih = dxp.view(T, B, D, 3 * H).sum(dim=(0, 1))
    return dxp, dw, db_ih, db_hh


class GRULayerFunction(torch.autograd.Function):
    """One layer with the forward kernel and the backward kernels: saves
    xp, w_hh, b_ih, b_hh and ys, as the JAX package's `_vjp_fwd_v2` does.
    The weight gradients are skipped when no weight needs one (the
    discriminator's layers in the generator's step)."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_ih, b_hh):
        ys, h_last = gru_layer_forward(xp, w_hh, b_ih, b_hh)
        ctx.save_for_backward(xp, w_hh, b_ih, b_hh, ys)
        return ys, h_last

    @staticmethod
    def backward(ctx, dys, dh_last):
        xp, w_hh, b_ih, b_hh, ys = ctx.saved_tensors
        need_x, need_w, need_bi, need_bh = ctx.needs_input_grad
        dxp, dw, db_ih, db_hh = gru_layer_bwd(
            xp, w_hh, b_ih, b_hh, ys, fold_h_last(dys, dh_last),
            weights=need_w or need_bi or need_bh)
        return (dxp if need_x else None, dw if need_w else None,
                db_ih if need_bi else None, db_hh if need_bh else None)


def gru_layer(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer as models use it. A CPU tensor runs the plain time loop,
    which autograd differentiates; a CUDA tensor runs `GRULayerFunction`
    (the forward kernel, and the backward kernels under autograd)."""
    if xp.device.type == "cpu":
        return gru_layer_plain(xp, w_hh, b_ih, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {xp.device}")
    return GRULayerFunction.apply(xp, w_hh, b_ih, b_hh)
