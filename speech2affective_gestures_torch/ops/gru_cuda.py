"""One (bi)directional GRU layer, forward and backward: CUDA kernels and
their plain versions.

Forward: replaces the TPU kernel `speech2affective_gestures_tpu/ops/
gru_pallas.py::_fwd_kernel_v2` (reached there through `run_layer_v2`). The
kernel is `csrc/gru_fwd.cu`: one thread-block cluster per (batch tile,
direction) runs the whole time loop, each block holding its units' slice
of W_hh in its threads' registers for the whole launch (on the TPU, W_hh
stays in VMEM; on the H100 it is ~5x one SM's shared memory at H=300) and
exchanging h with its peers through distributed shared memory, one cluster
barrier per step. `fwd_plan` chooses the lanes per unit, the cluster size,
the batch tile and the shared memory of a launch.

Backward: replaces `gru_pallas.py::_bwd_kernel_v2` (the `jax.custom_vjp`
backward of `_gru_layer_v2`). `csrc/gru_bwd.cu` holds two kernels: the
reverse-time recurrence (`gru_bwd`: one block per batch tile and direction,
bound by streaming W_hh from L2 into one SM per step) and the
deterministic reduction of dW_hh and db_hh over the T*B rows (`gru_dw`:
partial sums over row splits, then a fixed-order pass that adds them;
bound by float32 FMA throughput). The sources say more.

`GRULayerFunction` ties them into autograd. Each wrapper takes the plain
version for a CPU tensor and launches its kernel for a CUDA tensor; there
is no fallback between the two.

`run_layer` is the JAX package's v1 layer (`gru_pallas.run_layer`, the
TPU kernels `_fwd_kernel` and `_bwd_kernel`): the same cell in the scan's
walk layout, xp (T, D, B, 3H) with b_ih added and direction 1 time-reversed
by the caller, ys (T, D, B, H) in each direction's walk order, h_last =
ys[-1]. Its kernels are the same sources instantiated for that layout
(`_v1` entry points), so the cell body and the block design are shared;
`GRULayerV1Function` ties them into autograd. No model routes to it: the
models use `gru_layer`, as the JAX models use the v2 kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets them):
# the forward, the backward recurrence, the dW_hh reduction; then the same
# three in the walk layout (`run_layer`)
launches = 0
bwd_launches = 0
dw_launches = 0
v1_launches = 0
v1_bwd_launches = 0
v1_dw_launches = 0


def _walk(a: torch.Tensor, D: int) -> torch.Tensor:
    """(T, B, D, ...) -> (T, D, B, ...), each direction in its walk order
    (direction 1 flipped in time)."""
    out = [a[:, :, 0]] + ([a[:, :, 1].flip(0)] if D == 2 else [])
    return torch.stack(out, dim=1)


def _unwalk(a: torch.Tensor) -> torch.Tensor:
    """(T, D, B, C) in walk order -> (T, B, D*C) in forward time order."""
    outs = [a[:, 0]] + ([a[:, 1].flip(0)] if a.shape[1] == 2 else [])
    return torch.cat(outs, dim=-1)


def _cell(xt, hp, H):
    r = torch.sigmoid(xt[..., :H] + hp[..., :H])
    z = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(xt[..., 2 * H:] + r * hp[..., 2 * H:])
    return r, z, n


def _walk_forward(x: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor) -> torch.Tensor:
    """The time loop in walk order: x (T, D, B, 3H) with b_ih included ->
    ys (T, D, B, H)."""
    T, D, B, H3 = x.shape
    H = H3 // 3
    h = x.new_zeros(D, B, H)
    ys = []
    for t in range(T):
        hp = torch.bmm(h, w_hh) + b_hh[:, None, :]
        r, z, n = _cell(x[t], hp, H)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys)


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
    ys = _walk_forward(_walk(xp.view(T, B, D, 3 * H) + b_ih, D), w_hh, b_hh)
    return _unwalk(ys), ys[-1]


def _check_tensors(fn: str, tensors: dict) -> None:
    """Every tensor contiguous float32 on xp's device."""
    device = tensors["xp"].device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, xp on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check(xp, w_hh, b_ih, b_hh, **more):
    _check_tensors("gru_layer", {"xp": xp, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh,
                                 **more})
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


@functools.lru_cache(maxsize=None)
def _lib_fn(name: str, symbol: str, n_ptr: int, n_int: int = 4, stream: bool = True):
    """A C entry point taking n_ptr pointers, n_int ints and (with `stream`)
    the stream, resolved once per library."""
    fn = getattr(_build.load(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# The forward kernel's launch plan is decided here and only here; the
# kernel uses it as given and refuses only a plan its indexing cannot take.
# Its limits on the H100: a block's shared memory (the most a block may opt
# into), the largest portable cluster, the largest chunk of k a thread holds
# in registers. W_hh must fit in the registers of one cluster: H <= 320.
SMEM_LIMIT = 232448
MAX_CLUSTER = 8
MAX_KC = 40


class FwdPlan(NamedTuple):
    """A launch of `csrc/gru_fwd.cu`: `tiles` batch tiles of BT rows per
    direction, one cluster of C blocks each; a block owns U hidden units,
    S threads share a unit, each holding a chunk of KC rows of W_hh."""
    C: int
    U: int
    S: int
    KC: int
    BT: int
    tiles: int
    threads: int
    smem: int


def _max_threads(KC: int) -> int:
    """The kernel's __launch_bounds__ for a chunk of KC (`max_threads` in
    `csrc/gru_fwd.cu`; a plan beyond it fails at launch, and the wrapper
    raises): 3 KC registers of W and ~40 others a thread within an SM's
    65,536."""
    return 320 if KC >= 40 else 384 if KC >= 32 else 512


def _fwd_smem(S: int, KC: int, BT: int) -> int:
    """The kernel's shared-memory bytes: two h buffers of BT rows of S
    chunks padded to KC + 4 floats."""
    return 4 * 2 * BT * S * (KC + 4)


def fwd_shape(H: int) -> tuple[int, int, int, int]:
    """(S, KC, C, U) for hidden size H: the fewest lanes S a unit that keep
    a thread's chunk of W within MAX_KC rows (KC rounded up to 8), then the
    fewest blocks C that hold the units within the thread limit, U units a
    block (rounded up to 4, for the kernel's float4 exchange). Raises
    when H is too large for a cluster's registers."""
    for S in (2, 4, 8):
        if -(-H // S) <= MAX_KC:
            KC = -(-H // (8 * S)) * 8
            C = -(-H // (_max_threads(KC) // S))
            if C > MAX_CLUSTER:
                break
            return S, KC, C, -(-H // (4 * C)) * 4
    raise ValueError(f"gru_fwd: W_hh of hidden size {H} does not fit in the registers "
                     f"of a cluster of {MAX_CLUSTER} blocks")


def fwd_plan(B: int, H: int, D: int, max_clusters: int) -> FwdPlan:
    """The forward kernel's launch for batch B, hidden size H and D
    directions, when the card runs `max_clusters` clusters of C blocks at
    once: the fewest waves of clusters that hold the batch (a tile at most
    what shared memory allows), then as many tiles as fill those waves,
    balanced in size."""
    S, KC, C, U = fwd_shape(H)
    rows_max = SMEM_LIMIT // _fwd_smem(S, KC, 1)
    tiles = -(-B // rows_max)
    waves = -(-D * tiles // max_clusters)
    tiles = max(tiles, min(B, waves * max_clusters // D))
    BT = -(-B // tiles)
    return FwdPlan(C, U, S, KC, BT, -(-B // BT), -(-U * S // 32) * 32,
                   _fwd_smem(S, KC, BT))


_max_clusters: dict = {}


def max_clusters(device: torch.device, H: int) -> int:
    """How many clusters of the forward kernel at hidden size H the card
    runs at once, each block with the smem of a one-row tile (so that
    registers, not shared memory, bound the count); asked once per device
    and H."""
    key = (torch.device(device).index, H)
    if key not in _max_clusters:
        p = fwd_plan(1, H, 1, 1)  # one row a tile
        fn = _lib_fn("gru_fwd", "s2ag_gru_fwd_max_clusters", 0, n_int=5, stream=False)
        with torch.cuda.device(device):
            n = fn(p.S, p.KC, p.C, p.threads, p.smem)
        if n < 1:
            raise RuntimeError(f"gru_fwd: no cluster of {p.C} blocks fits on {device}"
                               + (f" (CUDA error {-n})" if n < 0 else ""))
        _max_clusters[key] = n
    return _max_clusters[key]


def _device_plan(device: torch.device, B: int, H: int, D: int) -> FwdPlan:
    return fwd_plan(B, H, D, max_clusters(device, H))


def _plan_args(plan: FwdPlan) -> tuple[int, ...]:
    """The plan as the forward entry points take it, after (T, B, H, D)."""
    return plan.C, plan.BT, plan.S, plan.KC, plan.U, plan.threads, plan.smem


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
    plan = _device_plan(xp.device, B, H, D)
    ys = torch.empty((T, B, D * H), device=xp.device, dtype=torch.float32)
    h_last = torch.empty((D, B, H), device=xp.device, dtype=torch.float32)
    _launch(_lib_fn("gru_fwd", "s2ag_gru_layer_fwd", 6, n_int=11), "gru_fwd", xp.device,
            xp.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
            ys.data_ptr(), h_last.data_ptr(), T, B, H, D, *_plan_args(plan))
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
    x = _walk(xp.view(T, B, D, 3 * H) + b_ih, D)
    dx, gn = _walk_backward(x, _walk(_prev_states(ys, D), D),
                            _walk(dys.view(T, B, D, H), D), w_hh, b_hh)
    return _unwalk(dx), _unwalk(gn)


def _walk_backward(x: torch.Tensor, hprev: torch.Tensor, dy: torch.Tensor,
                   w_hh: torch.Tensor, b_hh: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse-time recurrence in walk order: x (T, D, B, 3H) with b_ih
    included, hprev and dy (T, D, B, H) -> dx (T, D, B, 3H) = [dpre_r,
    dpre_z, dpre_n] and gn (T, D, B, H) = dpre_n r."""
    T, D, B, H3 = x.shape
    H = H3 // 3
    w_t = w_hh.transpose(1, 2)
    carry = x.new_zeros(D, B, H)
    dxs, gns = [], []
    for s in range(T - 1, -1, -1):
        hp = torch.bmm(hprev[s], w_hh) + b_hh[:, None, :]
        r, z, n = _cell(x[s], hp, H)
        dh = dy[s] + carry
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_z = dh * (hprev[s] - n) * z * (1.0 - z)
        dpre_r = dpre_n * hp[..., 2 * H:] * r * (1.0 - r)
        g = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
        carry = dh * z + torch.bmm(g, w_t)
        dxs.append(torch.cat([dpre_r, dpre_z, dpre_n], dim=-1))
        gns.append(dpre_n * r)
    return torch.stack(dxs[::-1]), torch.stack(gns[::-1])


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
    dw, db = _dw_launch("s2ag_gru_layer_dw", ys, dxp, gn, T, B, H, D)
    dw_launches += 1
    return dw, db


def _dw_launch(symbol, ys, dxp, gn, T, B, H, D):
    """Launch a dW reduction entry point of `csrc/gru_bwd.cu` (either
    layout) into fresh (dW_hh, db_hh)."""
    splits = _lib_fn("gru_bwd", "s2ag_gru_dw_splits", 0, n_int=5, stream=False)
    S = splits(T, B, H, D,
               torch.cuda.get_device_properties(ys.device).multi_processor_count)
    part = torch.empty((S, D, H + 1, 3 * H), device=ys.device, dtype=torch.float32)
    dw = torch.empty((D, H, 3 * H), device=ys.device, dtype=torch.float32)
    db = torch.empty((D, 3 * H), device=ys.device, dtype=torch.float32)
    _launch(_lib_fn("gru_bwd", symbol, 6, n_int=5), symbol, ys.device,
            ys.data_ptr(), dxp.data_ptr(), gn.data_ptr(), part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), T, B, H, D, S)
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


# ---------------------------------------------------------------------------
# the v1 layer: `gru_pallas.run_layer`'s contract, walk layout
# ---------------------------------------------------------------------------

def run_layer_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                    b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The v1 layer as a plain time loop.

    xp (T, D, B, 3H): the input projections plus b_ih, gates (r, z, n),
    direction 1 already time-reversed by the caller; w_hh (D, H, 3H); b_hh
    (D, 3H). Returns ys (T, D, B, H) in each direction's walk order and
    h_last = ys[-1] (D, B, H)."""
    ys = _walk_forward(xp, w_hh, b_hh)
    return ys, ys[-1]


def run_layer_bwd_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                                   b_hh: torch.Tensor, ys: torch.Tensor,
                                   dys: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The v1 backward recurrence: dys (T, D, B, H), the gradient of ys
    (h_last's included, since h_last is ys[-1]) -> dxp (T, D, B, 3H) =
    [dpre_r, dpre_z, dpre_n] and gn (T, D, B, H) = dpre_n r."""
    return _walk_backward(xp, _walk_prev(ys), dys, w_hh, b_hh)


def _walk_prev(ys: torch.Tensor) -> torch.Tensor:
    """The state each walk step started from: the previous row of ys (T,
    D, B, H), zero at step 0."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])


def run_layer_dw_plain(ys: torch.Tensor, dxp: torch.Tensor,
                       gn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dW_hh (D, H, 3H) = the sum over (t, b) of h_prev^T g with g =
    [dpre_r, dpre_z, dpre_n r], and db_hh (D, 3H) = the sum of g: the r and
    z parts are dxp's sums (JAX folds b_hh_r and b_hh_z into xp), the n
    part the TPU kernel's db_hn."""
    H = ys.shape[-1]
    g = torch.cat([dxp[..., :2 * H], gn], dim=-1)
    return torch.einsum("tdbk,tdbj->dkj", _walk_prev(ys), g), g.sum(dim=(0, 2))


def _check_v1(xp, w_hh, b_hh, **more):
    _check_tensors("run_layer", {"xp": xp, "w_hh": w_hh, "b_hh": b_hh, **more})
    if xp.dim() != 4 or w_hh.dim() != 3:
        raise ValueError("run_layer: xp must be (T, D, B, 3H) and w_hh (D, H, 3H)")
    T, D, B, H3 = xp.shape
    if tuple(w_hh.shape) != (D, H3 // 3, H3) or H3 % 3 or D not in (1, 2):
        raise ValueError(f"run_layer: w_hh shape {tuple(w_hh.shape)} does not "
                         f"match xp {tuple(xp.shape)}")
    if tuple(b_hh.shape) != (D, H3) or T < 1 or B < 1:
        raise ValueError(f"run_layer: b_hh shape {tuple(b_hh.shape)} != {(D, H3)}")
    for name, t in more.items():
        if tuple(t.shape) != (T, D, B, H3 // 3):
            raise ValueError(f"run_layer: {name} shape {tuple(t.shape)} != "
                             f"{(T, D, B, H3 // 3)}")


def run_layer_forward(xp: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor) -> torch.Tensor:
    """ys of `run_layer_plain`; the forward kernel (walk layout) for CUDA
    tensors. Not differentiable on the card: `run_layer` is the autograd
    entry."""
    global v1_launches
    if xp.device.type == "cpu":
        return run_layer_plain(xp, w_hh, b_hh)[0]
    if xp.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {xp.device}")
    _check_v1(xp, w_hh, b_hh)
    T, D, B, H3 = xp.shape
    H = H3 // 3
    plan = _device_plan(xp.device, B, H, D)
    ys = torch.empty((T, D, B, H), device=xp.device, dtype=torch.float32)
    _launch(_lib_fn("gru_fwd", "s2ag_gru_layer_fwd_v1", 4, n_int=11), "gru_fwd_v1",
            xp.device, xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), ys.data_ptr(),
            T, B, H, D, *_plan_args(plan))
    v1_launches += 1
    return ys


def run_layer_bwd_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                             b_hh: torch.Tensor, ys: torch.Tensor,
                             dys: torch.Tensor, want_gn: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`run_layer_bwd_recurrence_plain`'s contract; the backward kernel
    (walk layout) for CUDA tensors. With want_gn=False gn is not written
    and None is returned in its place."""
    global v1_bwd_launches
    if xp.device.type == "cpu":
        dxp, gn = run_layer_bwd_recurrence_plain(xp, w_hh, b_hh, ys, dys)
        return dxp, gn if want_gn else None
    if xp.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {xp.device}")
    _check_v1(xp, w_hh, b_hh, ys=ys, dys=dys)
    T, D, B, H3 = xp.shape
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    dxp = torch.empty_like(xp)
    gn = torch.empty_like(ys) if want_gn else None
    _launch(_lib_fn("gru_bwd", "s2ag_gru_layer_bwd_v1", 8), "gru_bwd_v1", xp.device,
            xp.data_ptr(), w_hh.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
            ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(),
            0 if gn is None else gn.data_ptr(), T, B, H3 // 3, D)
    v1_bwd_launches += 1
    return dxp, gn


def run_layer_dw(ys: torch.Tensor, dxp: torch.Tensor,
                 gn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`run_layer_dw_plain`'s contract; the reduction kernel (walk layout)
    for CUDA tensors."""
    global v1_dw_launches
    if ys.device.type == "cpu":
        return run_layer_dw_plain(ys, dxp, gn)
    if ys.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {ys.device}")
    T, D, B, H = ys.shape
    for name, t, shape in (("ys", ys, (T, D, B, H)), ("gn", gn, (T, D, B, H)),
                           ("dxp", dxp, (T, D, B, 3 * H))):
        if (t.device != ys.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"run_layer_dw: {name} must be a contiguous float32 "
                             f"{shape} tensor on {ys.device}")
    dw, db = _dw_launch("s2ag_gru_layer_dw_v1", ys, dxp, gn, T, B, H, D)
    v1_dw_launches += 1
    return dw, db


class GRULayerV1Function(torch.autograd.Function):
    """The v1 layer with the forward kernel and the backward kernels, both
    in the walk layout: saves xp, w_hh, b_hh and ys, as the JAX package's
    `_vjp_fwd` does. The weight gradients are skipped when neither weight
    needs one."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh):
        ys = run_layer_forward(xp, w_hh, b_hh)
        ctx.save_for_backward(xp, w_hh, b_hh, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, w_hh, b_hh, ys = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dxp, gn = run_layer_bwd_recurrence(xp, w_hh, b_hh, ys, dys.contiguous(),
                                           want_gn=need_w or need_b)
        dw = db = None
        if need_w or need_b:
            dw, db = run_layer_dw(ys, dxp, gn)
        return (dxp if need_x else None, dw if need_w else None,
                db if need_b else None)


def run_layer(xp: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gru_pallas.run_layer`'s contract (see `run_layer_plain`),
    differentiable in xp, w_hh and b_hh. A CPU tensor runs the plain time
    loop, which autograd differentiates; a CUDA tensor runs
    `GRULayerV1Function`. Contiguous float32 only, on either device: bf16
    storage comes with bf16 serving (ROADMAP.md)."""
    _check_v1(xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return run_layer_plain(xp, w_hh, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {xp.device}")
    ys = GRULayerV1Function.apply(xp, w_hh, b_hh)
    return ys, ys[-1]
