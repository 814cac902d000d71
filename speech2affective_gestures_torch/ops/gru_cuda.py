"""One (bi)directional GRU layer, forward and backward: CUDA kernels and
their plain versions.

Forward: replaces the TPU kernel `speech2affective_gestures_tpu/ops/
gru_pallas.py::_fwd_kernel_v2` (reached there through `run_layer_v2`). The
kernel is `csrc/gru_fwd.cu`: one thread-block cluster per (batch tile,
direction) runs the whole time loop, each block holding its units' slice
of W_hh in its threads' registers for the whole launch (on the TPU, W_hh
stays in VMEM; on the H100 it is ~5x one SM's shared memory at H=300) and
exchanging h with its peers through distributed shared memory, one cluster
barrier per step. Past H 320 (W_hh beyond a cluster's registers) the same
kernel reads each block's slice from L2 once per group of rows instead.
The bf16 instance has a third tier up to H 320, "tensor", that the plan
takes where the batch's work is large enough (`fwd_tier`): the product h . W_hh on the tensor cores
(mma.sync, bf16 operands, float32 accumulation), W_hh as operand
fragments in each warp's registers, h bf16 in shared memory. `fwd_tier`
and `fwd_plan` choose the tier, the lanes per unit, the cluster size, the
batch tile and the shared memory of a launch. When a gradient will be
taken the forward also saves hp = h_prev . W_hh + b_hh.

Backward: replaces `gru_pallas.py::_bwd_kernel_v2` (the `jax.custom_vjp`
backward of `_gru_layer_v2`). `csrc/gru_bwd.cu` holds two kernels: the
reverse-time recurrence (`gru_bwd`: the forward's cluster design turned
round, the rows of W_hh in registers, g exchanged through distributed
shared memory, one product with W_hh a step thanks to the saved hp;
`bwd_plan`, the forward's tiers, and at bf16 a tensor tier, `bwd_tier`: the
product on the tensor cores from g split into bf16 hi + lo, its K split
over the cluster) and the deterministic reduction of dW_hh
and db_hh over the T*B rows (`gru_dw`: a register-tiled float32 product
fed by a cp.async ring, at bf16 the same product on the tensor cores;
partial sums over row splits, then a fixed-order pass that adds them;
`dw_plan`). The sources say more.

`GRULayerFunction` ties them into autograd. Each wrapper takes the plain
version for a CPU tensor and launches its kernel for a CUDA tensor; there
is no fallback between the two.

Storage: float32 or bfloat16, as the TPU kernels store at the input's
dtype. Every kernel has an instance of each; a bf16 tensor on the card
runs the bf16 instance, never the float32 one. At bf16 the kernels and
their plain versions round where the TPU kernels do (`kernel_biases` and
`csrc/gru_fwd.cu`, `csrc/gru_bwd.cu`): the r/z bias fold and xp + b in
bf16, the products and gates in float32, the forward's carry h rounded to
bf16 every step, ys, dxp and gn bf16, the backward's carry dh float32, dW_hh
and the bias gradients float32 sums rounded to the parameters' dtype when
`GRULayerFunction` returns them; hp, saved by the forward for the
backward, is float32. On the CPU a bf16 layer runs through
`GRULayerFunction` too (its forward and backward the plain versions at
those rounding points), since autograd through the bf16 loop would carry
dh in bf16; float32 and float64 run the plain loop under autograd.
float16 and mixed dtypes raise TypeError.

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

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# kernel launches since the last reset, by (kernel, dtype): the forward
# ("gru_fwd"), the backward recurrence ("gru_bwd"), the dW_hh reduction
# ("gru_dw"), the same three in the walk layout (`run_layer`: "gru_fwd_v1",
# ...), each at "float32" or "bfloat16" (chip_smoke.py reads and resets it)
launches: collections.Counter = collections.Counter()
# the same launches by (kernel, dtype, tier): the plan's tier for the
# forward and the recurrence ("registers", "l2", the bf16 instances'
# "tensor"), "fma" or "tensor" for dW
tier_launches: collections.Counter = collections.Counter()
# the same launches by (kernel, dtype, T, H): the sequence length and the
# hidden size they ran at (the discriminators' T 34 or, after the
# ConvDiscriminator's unpadded convs, T 28)
shape_launches: collections.Counter = collections.Counter()
# the same launches by (kernel, dtype, B, H, tier): the batch and hidden
# size they ran at (the fused GAN step runs its nets at twice the batch)
# and the plan's tier
batch_launches: collections.Counter = collections.Counter()
# all four; a launch recorded into a CUDA graph is counted at each replay
# (`train.step_program`), not at the capture
COUNTERS = (launches, tier_launches, shape_launches, batch_launches)

# the kernels' storage dtypes; the plain versions also take float64
STORAGE = (torch.float32, torch.bfloat16)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _count(kernel: str, dtype: torch.dtype, tier: str, T: int, B: int, H: int) -> None:
    launches[(kernel, _dtype_name(dtype))] += 1
    tier_launches[(kernel, _dtype_name(dtype), tier)] += 1
    shape_launches[(kernel, _dtype_name(dtype), T, H)] += 1
    batch_launches[(kernel, _dtype_name(dtype), B, H, tier)] += 1


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: float32 for bf16 storage (as the
    kernels widen it), the storage dtype otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _check_dtypes(fn: str, tensors: dict, device: torch.device) -> torch.dtype:
    """The one dtype of `tensors`: float32 or bfloat16, on the CPU also
    float64; TypeError for float16, other dtypes and mixed dtypes."""
    dtypes = {t.dtype for t in tensors.values() if t is not None}
    if len(dtypes) != 1:
        raise TypeError(f"{fn}: mixed dtypes " + ", ".join(
            f"{n} {t.dtype}" for n, t in tensors.items() if t is not None))
    dtype = dtypes.pop()
    if dtype not in STORAGE + ((torch.float64,) if device.type == "cpu" else ()):
        raise TypeError(f"{fn}: dtype {dtype} is not one the GRU kernels store "
                        f"({', '.join(map(_dtype_name, STORAGE))})")
    return dtype


def kernel_biases(b_ih: torch.Tensor | None, b_hh: torch.Tensor,
                  H: int) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(b_in, b_rec): b_in (or None for zero) is added to xp and rounded to
    the storage dtype before the gates, b_rec to h_prev . W_hh in float32.
    float32 and float64: b_ih and b_hh as given. bf16: the TPU kernels'
    fold, b_in = b_ih + [b_hh_r, b_hh_z, 0] added in bf16 (b_ih None in the
    walk layout, whose caller added it to xp) and b_rec = [0, 0, b_hh_n]
    (`gru_pallas.run_layer_v2` :583-588, `run_layer` :284-289)."""
    if b_hh.dtype != torch.bfloat16:
        return b_ih, b_hh
    zero = torch.zeros_like(b_hh[:, :2 * H])
    rz = torch.cat([b_hh[:, :2 * H], zero[:, :H]], dim=-1)
    n = torch.cat([zero, b_hh[:, 2 * H:]], dim=-1)
    return (rz if b_ih is None else b_ih + rz), n


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
                  b_rec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The time loop in walk order: x (T, D, B, 3H) with b_in included (at
    the storage dtype) -> ys (T, D, B, H) at x's dtype and hp (T, D, B, 3H)
    = h_prev . W_hh + b_rec at the compute dtype; h rounded to the storage
    dtype every step."""
    T, D, B, H3 = x.shape
    H = H3 // 3
    dt, cd = x.dtype, _compute_dtype(x.dtype)
    x, w_hh, b_rec = x.to(cd), w_hh.to(cd), b_rec.to(cd)
    h = x.new_zeros(D, B, H)
    ys, hps = [], []
    for t in range(T):
        hp = torch.bmm(h, w_hh) + b_rec[:, None, :]
        r, z, n = _cell(x[t], hp, H)
        h = ((1.0 - z) * n + z * h).to(dt).to(cd)
        ys.append(h)
        hps.append(hp)
    return torch.stack(ys).to(dt), torch.stack(hps)


def gru_layer_plain(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                    b_hh: torch.Tensor, save_hp: bool = False):
    """The kernel's function as a plain time loop.

    xp (T, B, D*3H) input projections without bias; w_hh (D, H, 3H);
    b_ih, b_hh (D, 3H). Returns ys (T, B, D*H), both directions in forward
    time order, and h_last (D, B, H): the final state of each direction's
    walk (the reverse direction ends at forward time 0); with save_hp=True
    also hp (T, B, D*3H) = h_prev . W_hh + b_rec of each step, at the
    step's frame (`kernel_biases`; float32 at bf16 storage).
    """
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    b_in, b_rec = kernel_biases(b_ih, b_hh, H)
    ys, hp = _walk_forward(_walk(xp.view(T, B, D, 3 * H) + b_in, D), w_hh, b_rec)
    out = (_unwalk(ys), ys[-1])
    return out + (_unwalk(hp),) if save_hp else out


def _check_tensors(fn: str, tensors: dict) -> torch.dtype:
    """Every tensor contiguous, on xp's device, of one storage dtype (which
    is returned)."""
    device = tensors["xp"].device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, xp on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    return _check_dtypes(fn, tensors, device)


def _check_hp(fn: str, hp: torch.Tensor, xp: torch.Tensor) -> None:
    """The forward's saved hp on the card: contiguous float32 of xp's shape."""
    if hp.device != xp.device or hp.dtype != torch.float32 or not hp.is_contiguous():
        raise TypeError(f"{fn}: hp must be a contiguous float32 tensor on {xp.device}")
    if hp.shape != xp.shape:
        raise ValueError(f"{fn}: hp shape {tuple(hp.shape)} != xp's {tuple(xp.shape)}")


def _check(xp, w_hh, b_ih, b_hh, **more) -> torch.dtype:
    dtype = _check_tensors("gru_layer", {"xp": xp, "w_hh": w_hh, "b_ih": b_ih,
                                         "b_hh": b_hh, **more})
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
    return dtype


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


# The GRU kernels' launch plans are decided here and only here; the
# kernels use them as given and refuse only a plan their indexing cannot
# take. Their limits on the H100: a block's shared memory (the most a block
# may opt into), the largest portable cluster, the largest chunk of k a
# thread holds in registers (the register tier: W_hh in one cluster's
# registers, H <= 320), the threads of an L2-tier block.
SMEM_LIMIT = 232448
MAX_CLUSTER = 8
MAX_KC = 40
L2_S = 8
L2_MAX_THREADS = 512


class ClusterPlan(NamedTuple):
    """A launch of `csrc/gru_fwd.cu` or of the recurrence of
    `csrc/gru_bwd.cu`: `tiles` batch tiles of BT rows per direction, one
    cluster of C blocks each; a block owns U hidden units, S threads share
    a unit (a pair of units in the recurrence), each with a chunk of KC
    rows of W_hh (of its columns in the recurrence): in its registers (tier
    "registers") or read from L2 once per group of S rows (tier "l2", the
    block's units walked in passes). In the bf16 forward's tier "tensor" a
    warp owns a group of 8 units (U a multiple of 8), S is the warps that
    share a group (1) and KC the k padded to whole k16 steps; in the bf16
    recurrence's a block owns U units (U even) and the 3U columns of g they
    produce, padded to KC, and S is the n8 tiles of outputs a warp holds."""
    C: int
    U: int
    S: int
    KC: int
    BT: int
    tiles: int
    threads: int
    smem: int
    tier: str


def _max_threads(KC: int) -> int:
    """The register tier's __launch_bounds__ for a chunk of KC
    (`max_threads` in `csrc/gru_fwd.cu`; a plan beyond it fails at
    launch, and the wrapper raises): 3 KC registers of W and ~40 others a
    thread within an SM's 65,536."""
    return 320 if KC >= 40 else 384 if KC >= 32 else 512


def _fwd_smem(S: int, KC: int, BT: int) -> int:
    """The forward kernel's shared-memory bytes: two h buffers of BT rows
    of S chunks padded to KC + 4 floats."""
    return 4 * 2 * BT * S * (KC + 4)


def _bwd_ks(KC: int) -> int:
    """A chunk's stride in the recurrence's rows of g: KS / 4 odd, so that
    a quarter warp's float4 reads hit distinct banks (`bwd_ks`)."""
    return KC if (KC // 4) % 2 else KC + 4


def _bwd_smem(S: int, KC: int, U: int, BT: int) -> int:
    """The recurrence's shared-memory bytes: two g buffers of BT rows of
    three gates of S chunks of `_bwd_ks(KC)` floats, and BT x U values of
    dh z."""
    return 4 * (2 * BT * 3 * S * _bwd_ks(KC) + BT * U)


def fwd_shape(H: int) -> tuple[int, int, int, int]:
    """(S, KC, C, U) for hidden size H. The register tier: the fewest lanes
    S a unit that keep a thread's chunk of W within MAX_KC rows (KC rounded
    up to 8), then the fewest blocks C that hold the units within the
    thread limit, U units a block (rounded up to 4, for the kernels' float4
    exchange). Past what a cluster's registers hold (H > 320), the L2 tier:
    S = L2_S lanes and the largest cluster; KC > MAX_KC names it."""
    for S in (2, 4, 8):
        if -(-H // S) <= MAX_KC:
            KC = -(-H // (8 * S)) * 8
            C = -(-H // (_max_threads(KC) // S))
            if C > MAX_CLUSTER:
                break
            return S, KC, C, -(-H // (4 * C)) * 4
    KC = -(-H // (8 * L2_S)) * 8
    return L2_S, KC, MAX_CLUSTER, -(-H // (4 * MAX_CLUSTER)) * 4


def _tier(KC: int) -> str:
    return "registers" if KC <= MAX_KC else "l2"


# The bf16 forward's tensor tier (`csrc/gru_fwd.cu`,
# `gru_layer_fwd_tc_kernel`): its instances' k16 steps (k padded with zeros
# to 16 KT >= H), a block's most unit groups of 8 (one warp each) and
# threads, and the least work that takes it: B H^2, which the register
# tier's FMA product grows with, while the tensor tier's step has a floor
# (its 34 steps take ~0.1 ms on the H100 however few rows: a chain of
# products, gates and a barrier on one warp per 8 units). By device time
# on the H100 (PERF.md §6): at H 300 the register tier is faster up to
# B 16 (0.074 ms at B 1 against 0.108), the tensor tier from about B 24
# (0.108 against 0.112 at B 24, 0.130 against 0.199 at B 64, 0.43 against
# 1.08 at B 512); at H 64 and 40 the register tier is faster at every
# batch up to 512 (H 64, B 512: 0.081 against 0.103), though B H^2 there
# (2.1e6) is near H 300's at B 24 (2.2e6): the threshold takes H 300 from
# B 34, between the main paths' batches (1, and 258-512).
TENSOR_KT = (2, 3, 4, 5, 8, 12, 16, 19, 20)
TENSOR_MAX_GROUPS = 5
TENSOR_MAX_THREADS = 256
TENSOR_MIN_WORK = 3_000_000


def tensor_shape(H: int) -> tuple[int, int, int]:
    """(KC, C, U) of the tensor tier at hidden size H <= 320: k padded to
    KC = 16 KT, the smallest instance's, then the fewest blocks C of at most
    TENSOR_MAX_GROUPS groups of 8 units that hold H, U units a block (a
    multiple of 8)."""
    KC = 16 * next(kt for kt in TENSOR_KT if 16 * kt >= H)
    C = -(-H // (8 * TENSOR_MAX_GROUPS))
    return KC, C, -(-H // (8 * C)) * 8


def _tensor_smem(KC: int, BT: int) -> int:
    """The tensor tier's shared-memory bytes: two bf16 h buffers of BT rows,
    rounded up to 16 (an m16 tile), of KC + 8 values (a row of 16-byte
    segments whose count is odd, for ldmatrix)."""
    return 2 * 2 * (-(-BT // 16) * 16) * (KC + 8)


def fwd_tier(B: int, H: int, dtype: torch.dtype) -> str:
    """The forward's tier at batch B and hidden size H for storage `dtype`:
    bf16 in the register range (H <= 320) with B H^2 >= TENSOR_MIN_WORK
    takes the tensor cores (H 300 from B 34: the training and scoring
    batches); otherwise the register tier (H <= 320) or the L2 tier."""
    tier = _tier(fwd_shape(H)[1])
    if dtype == torch.bfloat16 and tier == "registers" and B * H * H >= TENSOR_MIN_WORK:
        return "tensor"
    return tier


def _threads(S: int, KC: int, U: int) -> int:
    """A block's threads: S lanes for each of the U units in the register
    tier; in the L2 tier the fewest passes of at most L2_MAX_THREADS, each
    of a multiple of 4 units."""
    if _tier(KC) == "registers":
        return -(-U * S // 32) * 32
    passes = -(-U * S // L2_MAX_THREADS)
    return -(-U // (4 * passes)) * 4 * S


# The recurrence's thread shape: a thread owns a pair of units (each value
# of g it reads from shared memory feeds both), its chunk of j at most
# BWD_MAX_KC in the register tier; a block at most BWD_MAX_THREADS threads
# (the register tier) or BWD_L2_MAX_THREADS (the L2 tier): `csrc/gru_bwd.cu`.
BWD_MAX_KC = 20
BWD_MAX_THREADS = 320
BWD_L2_MAX_THREADS = 256


def bwd_shape(H: int) -> tuple[int, int, int, int]:
    """(S, KC, C, U) of the backward recurrence for hidden size H. The
    register tier: the fewest lanes S a pair of units that keep a thread's
    chunk within BWD_MAX_KC values of j (KC rounded up to 4), then the
    fewest blocks C that hold the units within the thread limit, U units a
    block (rounded up to 4: whole pairs, whole float4s of the exchange).
    Where the forward takes its L2 tier (H > 320), so does this: S = L2_S
    lanes and the largest cluster; KC > BWD_MAX_KC names it."""
    if _tier(fwd_shape(H)[1]) == "registers":
        for S in (2, 4, 8, 16):
            if -(-H // S) <= BWD_MAX_KC:
                KC = -(-H // (4 * S)) * 4
                C = -(-H // (2 * (BWD_MAX_THREADS // S)))
                return S, KC, C, -(-H // (4 * C)) * 4
    KC = -(-H // (4 * L2_S)) * 4
    return L2_S, KC, MAX_CLUSTER, -(-H // (4 * MAX_CLUSTER)) * 4


def _bwd_threads(S: int, KC: int, U: int) -> int:
    """The recurrence's threads: S lanes for each of the U / 2 pairs in the
    register tier; in the L2 tier the fewest passes of at most
    BWD_L2_MAX_THREADS, each of a multiple of 4 pairs."""
    if KC <= BWD_MAX_KC:
        return -(-U // 2 * S // 32) * 32
    passes = -(-U // 2 * S // BWD_L2_MAX_THREADS)
    return -(-U // (8 * passes)) * 4 * S


def _tiles(B: int, D: int, rows_max: int, max_clusters: int) -> tuple[int, int]:
    """(BT, tiles): the fewest waves of clusters that hold the batch (a tile
    at most `rows_max` rows), then as many tiles as fill those waves,
    balanced in size."""
    if rows_max < 1:
        raise ValueError(f"gru: one batch row needs more than {SMEM_LIMIT} bytes "
                         "of shared memory")
    tiles = -(-B // rows_max)
    waves = -(-D * tiles // max_clusters)
    tiles = max(tiles, min(B, waves * max_clusters // D))
    BT = -(-B // tiles)
    return BT, -(-B // BT)


def fwd_plan(B: int, H: int, D: int, max_clusters: int,
             tier: str | None = None) -> ClusterPlan:
    """The forward kernel's launch for batch B, hidden size H and D
    directions, when the card runs `max_clusters` clusters of C blocks at
    once; in `tier` (default: the register or L2 tier H names). The tensor
    tier ("tensor", bf16, H <= 320): KC = 16 KT the padded k, S = 1 warp a
    unit group, threads 32 U / 8, rows_max a multiple of 16 (the buffers
    hold whole m16 tiles)."""
    if tier == "tensor":
        if _tier(fwd_shape(H)[1]) != "registers":
            raise ValueError(f"gru_fwd: the tensor tier takes H <= {8 * MAX_KC}, not {H}")
        KC, C, U = tensor_shape(H)
        rows_max = SMEM_LIMIT // _tensor_smem(KC, 16) * 16
        BT, tiles = _tiles(B, D, rows_max, max_clusters)
        return ClusterPlan(C, U, 1, KC, BT, tiles, 4 * U, _tensor_smem(KC, BT), "tensor")
    S, KC, C, U = fwd_shape(H)
    BT, tiles = _tiles(B, D, SMEM_LIMIT // _fwd_smem(S, KC, 1), max_clusters)
    return ClusterPlan(C, U, S, KC, BT, tiles, _threads(S, KC, U), _fwd_smem(S, KC, BT),
                   _tier(KC))


# The bf16 recurrence's tensor tier (`csrc/gru_bwd.cu`,
# `gru_layer_bwd_tc_kernel`): the product g . W^T on the tensor cores from
# g split into bf16 hi + lo, its K split over the cluster (each block's
# own units' 3U columns of g, at most 3 x BWD_TENSOR_MAX_U), the outputs'
# partial sums exchanged. A warp holds NT n8 tiles of outputs (the plan's
# BWD_TENSOR_NT, the kernel's instances; at most BWD_TENSOR_MAX_WARPS[NT]
# warps a block, `tools/tc_probes.py` builds NT 5 and 8 too) and its
# slice's KT k16 steps. Where it runs: at H >= BWD_TENSOR_MIN_H with B H^2
# >= BWD_TENSOR_MIN_WORK. By device time on the H100 (PERF.md §6,
# `tc_probes.py`): at H 300 the tiers are level at B 1 and 5 (0.111 and
# 0.115 ms registers, 0.114 and 0.116 tensor: the tensor tier's 34 steps
# have a ~0.11 ms floor) and the tensor tier is faster from B 16 (0.116
# against 0.160; 0.69 against 2.05 at B 512); at H 64 and 40 the register
# tier is faster at every batch measured (H 64, B 512: 0.106 against
# 0.148), though B H^2 there (2.1e6) is above H 300's at B 16 (1.4e6).
# So the tier takes H 300 from B 14; H 65-299 are not measured.
BWD_TENSOR_MAX_U = 40
BWD_TENSOR_NT = 4
BWD_TENSOR_MAX_WARPS = {4: 10, 5: 8, 8: 8}
BWD_TENSOR_MIN_H = 128
BWD_TENSOR_MIN_WORK = 1_200_000


def bwd_tensor_shape(H: int) -> tuple[int, int, int]:
    """(C, U, KT) of the recurrence's tensor tier at H <= 320: the fewest
    blocks C of at most BWD_TENSOR_MAX_U units, U even (a float2 of
    partials has one owner) and as small as covers H, KT k16 steps that
    hold a block's 3U columns of g."""
    C = -(-H // BWD_TENSOR_MAX_U)
    U = 2 * -(-H // (2 * C))
    return C, U, -(-3 * U // 16)


def _bwd_tensor_warps(H: int, nt: int) -> tuple[int, int]:
    """(NW, WM): warps across the outputs (nt n8 tiles each over H rounded
    up to 8), and groups of them that walk the m16 tiles in turn, as many
    as the block's warp limit allows."""
    nw = -(-(-(-H // 8)) // nt)
    return nw, max(1, BWD_TENSOR_MAX_WARPS[nt] // nw)


def _bwd_tensor_smem(C: int, U: int, KT: int, BT: int) -> int:
    """The tensor tier's shared-memory bytes: for BT rows, g as bf16 hi and
    lo (rows of 32 KT + 8 values), both slots of the C blocks' float32
    partials of the block's U units, and dh z; at least g for the rows
    rounded up to whole m16 tiles (the last tile's ldmatrix reads them)."""
    krs = 32 * KT + 8
    return max(2 * BT * krs + 4 * BT * U * (2 * C + 1), 2 * (-(-BT // 16) * 16) * krs)


def bwd_tier(B: int, H: int, dtype: torch.dtype) -> str:
    """The recurrence's tier at batch B and hidden size H for storage
    `dtype`: bf16 in the register range (H <= 320) from H BWD_TENSOR_MIN_H
    with B H^2 >= BWD_TENSOR_MIN_WORK takes the tensor cores (H 300 from B
    14: the training batch); otherwise the register tier (H <= 320) or the
    L2 tier, as the forward's."""
    tier = _tier(fwd_shape(H)[1])
    if (dtype == torch.bfloat16 and tier == "registers" and H >= BWD_TENSOR_MIN_H
            and B * H * H >= BWD_TENSOR_MIN_WORK):
        return "tensor"
    return tier


def bwd_plan(B: int, H: int, D: int, max_clusters: int, tier: str | None = None,
             nt: int = BWD_TENSOR_NT) -> ClusterPlan:
    """The backward recurrence's launch: `bwd_shape`, the forward's tier
    (so it takes every H the forward takes), its own tiles (a row of g is
    three of h). The tensor tier ("tensor", bf16, H <= 320): C, U and KT
    of `bwd_tensor_shape`, S = nt n8 tiles a warp, KC = 16 KT the padded
    columns of a block's slice of g, the most rows a block's shared memory
    holds."""
    if tier == "tensor":
        if _tier(fwd_shape(H)[1]) != "registers":
            raise ValueError(f"gru_bwd: the tensor tier takes H <= {8 * MAX_KC}, not {H}")
        C, U, KT = bwd_tensor_shape(H)
        nw, wm = _bwd_tensor_warps(H, nt)
        rows_max = SMEM_LIMIT // (2 * (32 * KT + 8) + 4 * U * (2 * C + 1))
        while _bwd_tensor_smem(C, U, KT, rows_max) > SMEM_LIMIT:
            rows_max -= 1
        BT, tiles = _tiles(B, D, rows_max, max_clusters)
        return ClusterPlan(C, U, nt, 16 * KT, BT, tiles, 32 * nw * wm,
                           _bwd_tensor_smem(C, U, KT, BT), "tensor")
    S, KC, C, U = bwd_shape(H)
    BT, tiles = _tiles(B, D, SMEM_LIMIT // _bwd_smem(S, KC, U, 1), max_clusters)
    return ClusterPlan(C, U, S, KC, BT, tiles, _bwd_threads(S, KC, U),
                   _bwd_smem(S, KC, U, BT),
                   "registers" if KC <= BWD_MAX_KC else "l2")


_max_clusters: dict = {}


def max_clusters(device: torch.device, H: int, kernel: str = "fwd",
                 dtype: torch.dtype = torch.float32, tier: str | None = None) -> int:
    """How many clusters of the forward (`kernel` "fwd", in `tier`) or
    backward recurrence ("bwd") kernel's `dtype` instance at hidden size H
    the card runs at once, each block with the smem of a one-row tile (so
    that registers, not shared memory, bound the count); asked once per
    device, kernel, dtype, H and tier."""
    key = (torch.device(device).index, H, kernel, dtype, tier)
    if key not in _max_clusters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"gru_{kernel}: the plan at H {H} ({dtype}, {tier}) is first "
                               "asked for inside a CUDA graph capture: run the step eagerly "
                               "before capturing it")
        p = (fwd_plan if kernel == "fwd" else bwd_plan)(1, H, 1, 1, tier)  # one row a tile
        fn = _lib_fn(f"gru_{kernel}", f"s2ag_gru_{kernel}_max_clusters", 0, n_int=7,
                     stream=False)
        with torch.cuda.device(device):
            n = fn(p.S, p.KC, p.C, p.threads, p.smem, _TIERS[p.tier],
                   int(dtype == torch.bfloat16))
        if n < 1:
            raise RuntimeError(f"gru_{kernel}: no cluster of {p.C} blocks fits on {device}"
                               + (f" (CUDA error {-n})" if n < 0 else ""))
        _max_clusters[key] = n
    return _max_clusters[key]


_TIERS = {"registers": 0, "l2": 1, "tensor": 2}


def _device_plan(device: torch.device, B: int, H: int, D: int,
                 dtype: torch.dtype = torch.float32) -> ClusterPlan:
    tier = fwd_tier(B, H, dtype)
    return fwd_plan(B, H, D, max_clusters(device, H, "fwd", dtype, tier), tier)


def _device_bwd_plan(device: torch.device, B: int, H: int, D: int,
                     dtype: torch.dtype = torch.float32) -> ClusterPlan:
    tier = bwd_tier(B, H, dtype)
    return bwd_plan(B, H, D, max_clusters(device, H, "bwd", dtype, tier), tier)


def _plan_args(plan: ClusterPlan, dtype: torch.dtype = torch.float32) -> tuple[int, ...]:
    """The plan as the GRU entry points take it, after (T, B, H, D), and the
    instance (1: bf16)."""
    return (plan.C, plan.BT, plan.S, plan.KC, plan.U, plan.threads, plan.smem,
            _TIERS[plan.tier], int(dtype == torch.bfloat16))


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def gru_layer_forward(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                      b_hh: torch.Tensor, save_hp: bool = False):
    """`gru_layer_plain`'s contract; the forward kernel for CUDA tensors
    (the instance of their dtype). Not differentiable on the card:
    `gru_layer` is the autograd entry. With save_hp=True it also returns hp
    (T, B, D*3H) float32, h_prev . W_hh + b_rec of every step, which the
    backward kernel takes instead of recomputing it."""
    if xp.device.type == "cpu":
        _check_dtypes("gru_layer", {"xp": xp, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh},
                      xp.device)
        return gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=save_hp)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {xp.device}")
    dtype = _check(xp, w_hh, b_ih, b_hh)
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    return _forward_launch(xp, w_hh, b_ih, b_hh, _device_plan(xp.device, B, H, D, dtype),
                           save_hp)


def _forward_launch(xp, w_hh, b_ih, b_hh, plan: ClusterPlan, save_hp: bool):
    """`gru_layer_forward`'s launch on checked CUDA tensors with `plan`
    (the caller's: `_device_plan`, or another tier's plan where
    chip_smoke.py times the tiers against each other)."""
    dtype = xp.dtype
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    b_in, b_rec = kernel_biases(b_ih, b_hh, H)
    ys = torch.empty((T, B, D * H), device=xp.device, dtype=dtype)
    h_last = torch.empty((D, B, H), device=xp.device, dtype=dtype)
    hp = torch.empty(xp.shape, device=xp.device, dtype=torch.float32) if save_hp else None
    _launch(_lib_fn("gru_fwd", "s2ag_gru_layer_fwd", 7, n_int=13), "gru_fwd", xp.device,
            xp.data_ptr(), w_hh.data_ptr(), b_in.data_ptr(), b_rec.data_ptr(),
            ys.data_ptr(), h_last.data_ptr(), _ptr(hp), T, B, H, D,
            *_plan_args(plan, dtype))
    _count("gru_fwd", dtype, plan.tier, T, B, H)
    return (ys, h_last, hp) if save_hp else (ys, h_last)


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
                             ys: torch.Tensor, dys: torch.Tensor,
                             hp: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's recurrence as a plain reverse-time loop.

    ys from the forward, dys (T, B, D*H) the gradient of ys (with the
    gradient of h_last already added at the frame of each final state), hp
    the forward's saved h_prev . W_hh + b_rec (T, B, D*3H), or None to
    recompute it. Returns dxp (T, B, D*3H) = [dpre_r, dpre_z, dpre_n] and gn
    (T, B, D*H) = dpre_n * r, both in forward time order, at xp's dtype."""
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    b_in, b_rec = kernel_biases(b_ih, b_hh, H)
    x = _walk(xp.view(T, B, D, 3 * H) + b_in, D)
    dx, gn = _walk_backward(x, _walk(_prev_states(ys, D), D),
                            _walk(dys.view(T, B, D, H), D), w_hh, b_rec,
                            None if hp is None else _walk(hp.view(T, B, D, 3 * H), D))
    return _unwalk(dx), _unwalk(gn)


def _walk_backward(x: torch.Tensor, hprev: torch.Tensor, dy: torch.Tensor,
                   w_hh: torch.Tensor, b_rec: torch.Tensor,
                   hps: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse-time recurrence in walk order: x (T, D, B, 3H) with b_in
    included (at the storage dtype), hprev and dy (T, D, B, H), hps (T, D,
    B, 3H) the forward's h_prev . W_hh + b_rec or None -> dx (T, D, B, 3H)
    = [dpre_r, dpre_z, dpre_n] and gn (T, D, B, H) = dpre_n r, at x's dtype;
    the carry, the gate gradients and g . W^T at the compute dtype."""
    T, D, B, H3 = x.shape
    H = H3 // 3
    dt, cd = x.dtype, _compute_dtype(x.dtype)
    x, hprev, dy, w_hh, b_rec = (a.to(cd) for a in (x, hprev, dy, w_hh, b_rec))
    w_t = w_hh.transpose(1, 2)
    carry = x.new_zeros(D, B, H)
    dxs, gns = [], []
    for s in range(T - 1, -1, -1):
        hp = torch.bmm(hprev[s], w_hh) + b_rec[:, None, :] if hps is None else hps[s].to(cd)
        r, z, n = _cell(x[s], hp, H)
        dh = dy[s] + carry
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_z = dh * (hprev[s] - n) * z * (1.0 - z)
        dpre_r = dpre_n * hp[..., 2 * H:] * r * (1.0 - r)
        g = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
        carry = dh * z + torch.bmm(g, w_t)
        dxs.append(torch.cat([dpre_r, dpre_z, dpre_n], dim=-1).to(dt))
        gns.append((dpre_n * r).to(dt))
    return torch.stack(dxs[::-1]), torch.stack(gns[::-1])


def gru_bwd_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                       b_hh: torch.Tensor, ys: torch.Tensor, dys: torch.Tensor,
                       hp: torch.Tensor | None = None, want_gn: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`gru_bwd_recurrence_plain`'s contract; the backward kernel for CUDA
    tensors (the instance of their dtype), which takes the forward's saved
    float32 hp (`gru_layer_forward(..., save_hp=True)`) and raises without
    it. With want_gn=False (no weight gradient wanted) gn is not written and
    None is returned in its place."""
    if xp.device.type == "cpu":
        dxp, gn = gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys, hp)
        return dxp, gn if want_gn else None
    if xp.device.type != "cuda":
        raise ValueError(f"gru_bwd: unsupported device {xp.device}")
    if hp is None:
        raise ValueError("gru_bwd: the kernel takes the forward's saved hp "
                         "(gru_layer_forward(..., save_hp=True))")
    dtype = _check(xp, w_hh, b_ih, b_hh, ys=ys, dys=dys)
    _check_hp("gru_bwd", hp, xp)
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    b_in, _ = kernel_biases(b_ih, b_hh, H)
    return _recurrence_launch(False, xp, w_hh, b_in, hp, ys, dys,
                              _device_bwd_plan(xp.device, B, H, D, dtype), want_gn)


def _recurrence_launch(walk: bool, xp, w_hh, b_in, hp, ys, dys, plan: ClusterPlan,
                       want_gn: bool = True):
    """The recurrence's launch on checked CUDA tensors (model layout, or
    the walk layout's with `walk`) with `plan` (the caller's:
    `_device_bwd_plan`, or another tier's plan where chip_smoke.py holds
    and times the tiers against each other); b_in the `kernel_biases`
    part added to xp, or None. Returns (dxp, gn or None)."""
    dtype = xp.dtype
    D, H, _ = w_hh.shape
    T, B = xp.shape[0], xp.shape[2 if walk else 1]
    dxp = torch.empty_like(xp)
    gn = torch.empty_like(ys) if want_gn else None
    kernel = "gru_bwd_v1" if walk else "gru_bwd"
    symbol = "s2ag_gru_layer_bwd_v1" if walk else "s2ag_gru_layer_bwd"
    _launch(_lib_fn("gru_bwd", symbol, 8, n_int=13), kernel, xp.device,
            xp.data_ptr(), w_hh.data_ptr(), _ptr(b_in), hp.data_ptr(), ys.data_ptr(),
            dys.data_ptr(), dxp.data_ptr(), _ptr(gn), T, B, H, D, *_plan_args(plan, dtype))
    _count(kernel, dtype, plan.tier, T, B, H)
    return dxp, gn


def gru_dw_plain(ys: torch.Tensor, dxp: torch.Tensor, gn: torch.Tensor,
                 D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dW_hh (D, H, 3H) = the sum over (t, b) of h_prev^T g with
    g = [dpre_r, dpre_z, dpre_n r], and db_hh (D, 3H) = the sum of g, at the
    compute dtype (float32 for bf16 inputs)."""
    T, B, _ = ys.shape
    H = ys.shape[2] // D
    cd = _compute_dtype(ys.dtype)
    d = dxp.view(T, B, D, 3 * H).to(cd)
    g = torch.cat([d[..., :2 * H], gn.view(T, B, D, H).to(cd)], dim=-1)
    hprev = _prev_states(ys, D).to(cd)
    dw = torch.einsum("tbdk,tbdj->dkj", hprev, g)
    return dw, g.sum(dim=(0, 1))


def gru_dw(ys: torch.Tensor, dxp: torch.Tensor, gn: torch.Tensor,
           D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`gru_dw_plain`'s contract; the reduction kernel for CUDA tensors (the
    instance of their dtype), float32 out."""
    if ys.device.type == "cpu":
        return gru_dw_plain(ys, dxp, gn, D)
    if ys.device.type != "cuda":
        raise ValueError(f"gru_dw: unsupported device {ys.device}")
    T, B, DH = ys.shape
    H = DH // D
    dtype = _check_dw("gru_dw", ((ys, (T, B, D * H)), (gn, (T, B, D * H)),
                                 (dxp, (T, B, D * 3 * H))))
    dw, db = _dw_launch("s2ag_gru_layer_dw", ys, dxp, gn, T, B, H, D)
    _count("gru_dw", dtype, _dw_tier(dtype), T, B, H)
    return dw, db


def _check_dw(fn: str, tensors) -> torch.dtype:
    """ys, gn and dxp of the dW reduction: contiguous, of their shapes, on
    ys's device, of one storage dtype (returned)."""
    names = ("ys", "gn", "dxp")
    device = tensors[0][0].device
    for name, (t, shape) in zip(names, tensors):
        if t.device != device or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be a contiguous {shape} tensor on {device}")
    return _check_dtypes(fn, {n: t for n, (t, _) in zip(names, tensors)}, device)


# dW's block tile (rows of k by columns of j) and rows a pipeline stage:
# float32 TM, TN and TK of `csrc/gru_bwd.cu`, bf16 (the tensor cores) DK,
# DJ and DRK, with DW_TC_MIN_BLOCKS blocks an SM
DW_TM, DW_TN, DW_TK = 64, 128, 16
DW_TC_K, DW_TC_J, DW_TC_RK, DW_TC_BLOCKS_PER_SM = 128, 128, 32, 2


def _dw_tier(dtype: torch.dtype) -> str:
    return "tensor" if dtype == torch.bfloat16 else "fma"


class DwPlan(NamedTuple):
    """A launch of `csrc/gru_bwd.cu`'s dW product: tiles_k x tiles_j block
    tiles of the (H + 1, 3H) output a direction, each over `splits`
    consecutive row splits of `rows` rows (a multiple of the rows a stage)
    of the T*B; `vec` values a copy (float32: 4 is a 16-byte cp.async, 1 a
    4-byte one; bf16: 4 an 8-byte cp.async, 2 a 4-byte one, 1 a plain
    load)."""
    tiles_k: int
    tiles_j: int
    splits: int
    rows: int
    vec: int


def dw_plan(T: int, B: int, H: int, D: int, sms: int, align: int = 16,
            itemsize: int = 4) -> DwPlan:
    """The dW product's launch on a card of `sms` SMs for inputs of
    `itemsize` bytes a value whose pointers are all multiples of `align`
    bytes. float32 (4): the FMA product's 64 x 128 tiles, about four blocks
    an SM (splits of at least 256 rows), stages of 16 rows; bf16 (2): the
    tensor-core product's 128 x 128 tiles, two blocks an SM (its registers)
    in one wave (a second wave's tail cost 1.5x on the H100; splits of at
    least 512 rows), stages of 32 rows. No split
    empty after its rows are rounded up to whole stages; the widest copy of
    `vec` values with H % vec == 0 (then every row and direction of the
    layouts starts on a multiple of vec values) and vec * itemsize dividing
    `align`: float32 copies 4 values or 1, bf16 4, 2 or 1."""
    M = T * B
    if itemsize == 2:
        tiles_k, tiles_j, rk = -(-(H + 1) // DW_TC_K), -(-3 * H // DW_TC_J), DW_TC_RK
        S = max(1, min(DW_TC_BLOCKS_PER_SM * sms // (tiles_k * tiles_j * D), M // 512))
    else:
        tiles_k, tiles_j, rk = -(-(H + 1) // DW_TM), -(-3 * H // DW_TN), DW_TK
        S = max(1, min(-(-4 * sms // (tiles_k * tiles_j * D)), M // 256))
    rows = -(-(-(-M // S)) // rk) * rk
    vec = next(v for v in ((4, 1) if itemsize == 4 else (4, 2, 1))
               if H % v == 0 and align % (v * itemsize) == 0)
    return DwPlan(tiles_k, tiles_j, -(-M // rows), rows, vec)


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    return next(a for a in (16, 8, 4, 2, 1) if all(t.data_ptr() % a == 0 for t in tensors))


def _dw_launch(symbol, ys, dxp, gn, T, B, H, D):
    """Launch a dW reduction entry point of `csrc/gru_bwd.cu` (either
    layout) into fresh float32 (dW_hh, db_hh)."""
    plan = dw_plan(T, B, H, D,
                   torch.cuda.get_device_properties(ys.device).multi_processor_count,
                   align=_alignment(ys, dxp, gn), itemsize=ys.element_size())
    part = torch.empty((plan.splits, D, H + 1, 3 * H), device=ys.device,
                       dtype=torch.float32)
    dw = torch.empty((D, H, 3 * H), device=ys.device, dtype=torch.float32)
    db = torch.empty((D, 3 * H), device=ys.device, dtype=torch.float32)
    _launch(_lib_fn("gru_bwd", symbol, 6, n_int=8), symbol, ys.device,
            ys.data_ptr(), dxp.data_ptr(), gn.data_ptr(), part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), T, B, H, D, plan.splits, plan.rows, plan.vec,
            int(ys.dtype == torch.bfloat16))
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
                  weights: bool = True, hp: torch.Tensor | None = None):
    """Gradients of one layer: (dxp, dw_hh, db_ih, db_hh). The kernels for
    CUDA tensors (which take the forward's hp), the plain versions for CPU
    tensors. With weights=False only dxp is computed (the others are
    None)."""
    D, H, _ = w_hh.shape
    dxp, gn = gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp, want_gn=weights)
    if not weights:
        return dxp, None, None, None
    dw, db_hh = gru_dw(ys, dxp, gn, D)
    # db_ih = the sum of dxp: its r and z parts are db_hh's (g_r = dxp_r,
    # g_z = dxp_z, summed by the dW kernel), so only the n part is summed here
    T, B, _ = xp.shape
    db_n = dxp.view(T, B, D, 3, H)[:, :, :, 2].sum(dim=(0, 1), dtype=_compute_dtype(dxp.dtype))
    return dxp, dw, torch.cat([db_hh[:, :2 * H], db_n], dim=-1), db_hh


class GRULayerFunction(torch.autograd.Function):
    """One layer with the forward kernel and the backward kernels (their
    plain versions for CPU tensors): saves xp, w_hh, b_ih, b_hh and ys, as
    the JAX package's `_vjp_fwd_v2` does, and the forward's hp, so that the
    backward makes one product with W_hh a step, not two. The weight
    gradients are skipped when no weight needs one (the discriminator's
    layers in the generator's step); they are float32 sums returned in the
    parameters' dtype (`_vjp_bwd_v2`'s casts)."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_ih, b_hh):
        ys, h_last, hp = gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
        ctx.save_for_backward(xp, w_hh, b_ih, b_hh, ys, hp)
        return ys, h_last

    @staticmethod
    def backward(ctx, dys, dh_last):
        xp, w_hh, b_ih, b_hh, ys, hp = ctx.saved_tensors
        need_x, need_w, need_bi, need_bh = ctx.needs_input_grad
        dxp, dw, db_ih, db_hh = gru_layer_bwd(
            xp, w_hh, b_ih, b_hh, ys, fold_h_last(dys, dh_last),
            weights=need_w or need_bi or need_bh, hp=hp)
        return (dxp if need_x else None, dw.to(w_hh.dtype) if need_w else None,
                db_ih.to(b_ih.dtype) if need_bi else None,
                db_hh.to(b_hh.dtype) if need_bh else None)


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gru_layer(xp: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer as models use it. A float32 or float64 CPU tensor runs the
    plain time loop, which autograd differentiates; a CUDA tensor, or a
    bf16 one on the CPU, runs `GRULayerFunction` (the forward kernel, and
    the backward kernels under autograd, or their plain versions on the
    CPU) when a gradient will be taken, else the forward alone (no hp
    saved)."""
    dtype = _check_dtypes("gru_layer", {"xp": xp, "w_hh": w_hh, "b_ih": b_ih,
                                        "b_hh": b_hh}, xp.device)
    if xp.device.type == "cpu" and dtype != torch.bfloat16:
        return gru_layer_plain(xp, w_hh, b_ih, b_hh)
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_layer: unsupported device {xp.device}")
    if not _differentiated(xp, w_hh, b_ih, b_hh):
        return gru_layer_forward(xp, w_hh, b_ih, b_hh)
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
    ys = _walk_forward(*_walk_inputs(xp, w_hh, b_hh))[0]
    return ys, ys[-1]


def _walk_inputs(xp, w_hh, b_hh):
    """(x, w_hh, b_rec) of the walk layout's loops: xp with `kernel_biases`'
    b_in added (none in float32; b_hh_r and b_hh_z in bf16)."""
    b_in, b_rec = kernel_biases(None, b_hh, w_hh.shape[1])
    return (xp if b_in is None else xp + b_in[:, None, :]), w_hh, b_rec


def run_layer_bwd_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                                   b_hh: torch.Tensor, ys: torch.Tensor,
                                   dys: torch.Tensor, hp: torch.Tensor | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The v1 backward recurrence: dys (T, D, B, H), the gradient of ys
    (h_last's included, since h_last is ys[-1]), hp (T, D, B, 3H) the
    forward's saved h_prev . W_hh + b_rec or None to recompute it -> dxp
    (T, D, B, 3H) = [dpre_r, dpre_z, dpre_n] and gn (T, D, B, H) = dpre_n r."""
    x, w_hh, b_rec = _walk_inputs(xp, w_hh, b_hh)
    return _walk_backward(x, _walk_prev(ys), dys, w_hh, b_rec, hp)


def _walk_prev(ys: torch.Tensor) -> torch.Tensor:
    """The state each walk step started from: the previous row of ys (T,
    D, B, H), zero at step 0."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])


def run_layer_dw_plain(ys: torch.Tensor, dxp: torch.Tensor,
                       gn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dW_hh (D, H, 3H) = the sum over (t, b) of h_prev^T g with g =
    [dpre_r, dpre_z, dpre_n r], and db_hh (D, 3H) = the sum of g: the r and
    z parts are dxp's sums (JAX folds b_hh_r and b_hh_z into xp), the n
    part the TPU kernel's db_hn. At the compute dtype (float32 for bf16)."""
    H = ys.shape[-1]
    cd = _compute_dtype(ys.dtype)
    g = torch.cat([dxp[..., :2 * H], gn], dim=-1).to(cd)
    return torch.einsum("tdbk,tdbj->dkj", _walk_prev(ys).to(cd), g), g.sum(dim=(0, 2))


def _check_v1(xp, w_hh, b_hh, **more) -> torch.dtype:
    dtype = _check_tensors("run_layer", {"xp": xp, "w_hh": w_hh, "b_hh": b_hh, **more})
    if xp.dim() != 4 or w_hh.dim() != 3:
        raise ValueError("run_layer: xp must be (T, D, B, 3H) and w_hh (D, H, 3H)")
    T, D, B, H3 = xp.shape
    if tuple(w_hh.shape) != (D, H3 // 3, H3) or H3 % 3 or D not in (1, 2):
        raise ValueError(f"run_layer: w_hh shape {tuple(w_hh.shape)} does not "
                         f"match xp {tuple(xp.shape)}")
    if tuple(b_hh.shape) != (D, H3) or T < 1 or B < 1:
        raise ValueError(f"run_layer: b_hh shape {tuple(b_hh.shape)} != {(D, H3)}")
    for name, t in more.items():
        if t.shape != (T, D, B, H3 // 3):
            raise ValueError(f"run_layer: {name} shape {tuple(t.shape)} != "
                             f"{(T, D, B, H3 // 3)}")
    return dtype


def run_layer_forward(xp: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, save_hp: bool = False):
    """ys of `run_layer_plain`; the forward kernel (walk layout, the
    instance of their dtype) for CUDA tensors. Not differentiable on the
    card: `run_layer` is the autograd entry. With save_hp=True returns (ys,
    hp), hp (T, D, B, 3H) the h_prev . W_hh + b_rec of each walk step
    (float32 at bf16 storage)."""
    if xp.device.type == "cpu":
        ys, hp = _walk_forward(*_walk_inputs(xp, w_hh, b_hh))
        return (ys, hp) if save_hp else ys
    if xp.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {xp.device}")
    dtype = _check_v1(xp, w_hh, b_hh)
    T, D, B, H3 = xp.shape
    H = H3 // 3
    b_in, b_rec = kernel_biases(None, b_hh, H)
    plan = _device_plan(xp.device, B, H, D, dtype)
    ys = torch.empty((T, D, B, H), device=xp.device, dtype=dtype)
    hp = torch.empty(xp.shape, device=xp.device, dtype=torch.float32) if save_hp else None
    _launch(_lib_fn("gru_fwd", "s2ag_gru_layer_fwd_v1", 6, n_int=13), "gru_fwd_v1",
            xp.device, xp.data_ptr(), w_hh.data_ptr(), _ptr(b_in), b_rec.data_ptr(),
            ys.data_ptr(), _ptr(hp), T, B, H, D, *_plan_args(plan, dtype))
    _count("gru_fwd_v1", dtype, plan.tier, T, B, H)
    return (ys, hp) if save_hp else ys


def run_layer_bwd_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                             b_hh: torch.Tensor, ys: torch.Tensor,
                             dys: torch.Tensor, hp: torch.Tensor | None = None,
                             want_gn: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`run_layer_bwd_recurrence_plain`'s contract; the backward kernel
    (walk layout, the instance of their dtype) for CUDA tensors, which takes
    the forward's saved float32 hp (`run_layer_forward(..., save_hp=True)`)
    and raises without it. With want_gn=False gn is not written and None is
    returned in its place."""
    if xp.device.type == "cpu":
        dxp, gn = run_layer_bwd_recurrence_plain(xp, w_hh, b_hh, ys, dys, hp)
        return dxp, gn if want_gn else None
    if xp.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {xp.device}")
    if hp is None:
        raise ValueError("run_layer: the backward kernel takes the forward's saved hp "
                         "(run_layer_forward(..., save_hp=True))")
    dtype = _check_v1(xp, w_hh, b_hh, ys=ys, dys=dys)
    _check_hp("run_layer", hp, xp)
    T, D, B, H3 = xp.shape
    b_in, _ = kernel_biases(None, b_hh, H3 // 3)
    return _recurrence_launch(True, xp, w_hh, b_in, hp, ys, dys,
                              _device_bwd_plan(xp.device, B, H3 // 3, D, dtype), want_gn)


def run_layer_dw(ys: torch.Tensor, dxp: torch.Tensor,
                 gn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`run_layer_dw_plain`'s contract; the reduction kernel (walk layout,
    the instance of their dtype) for CUDA tensors, float32 out."""
    if ys.device.type == "cpu":
        return run_layer_dw_plain(ys, dxp, gn)
    if ys.device.type != "cuda":
        raise ValueError(f"run_layer: unsupported device {ys.device}")
    T, D, B, H = ys.shape
    dtype = _check_dw("run_layer_dw", ((ys, (T, D, B, H)), (gn, (T, D, B, H)),
                                       (dxp, (T, D, B, 3 * H))))
    dw, db = _dw_launch("s2ag_gru_layer_dw_v1", ys, dxp, gn, T, B, H, D)
    _count("gru_dw_v1", dtype, _dw_tier(dtype), T, B, H)
    return dw, db


class GRULayerV1Function(torch.autograd.Function):
    """The v1 layer with the forward kernel and the backward kernels, both
    in the walk layout (their plain versions for CPU tensors): saves xp,
    w_hh, b_hh and ys, as the JAX package's `_vjp_fwd` does, and the
    forward's hp. The weight gradients are skipped when neither weight
    needs one, and returned in the parameters' dtype."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh):
        ys, hp = run_layer_forward(xp, w_hh, b_hh, save_hp=True)
        ctx.save_for_backward(xp, w_hh, b_hh, ys, hp)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, w_hh, b_hh, ys, hp = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dxp, gn = run_layer_bwd_recurrence(xp, w_hh, b_hh, ys, dys.contiguous(), hp,
                                           want_gn=need_w or need_b)
        dw = db = None
        if need_w or need_b:
            dw, db = run_layer_dw(ys, dxp, gn)
        return (dxp if need_x else None, dw.to(w_hh.dtype) if need_w else None,
                db.to(b_hh.dtype) if need_b else None)


def run_layer(xp: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gru_pallas.run_layer`'s contract (see `run_layer_plain`),
    differentiable in xp, w_hh and b_hh. Contiguous float32 or bf16 (on the
    CPU also float64). A float32 or float64 CPU tensor runs the plain time
    loop, which autograd differentiates; a CUDA tensor, or a bf16 one on
    the CPU, runs `GRULayerV1Function` when a gradient will be taken, else
    the forward alone."""
    dtype = _check_v1(xp, w_hh, b_hh)
    if xp.device.type == "cpu" and dtype != torch.bfloat16:
        return run_layer_plain(xp, w_hh, b_hh)
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"run_layer: unsupported device {xp.device}")
    if _differentiated(xp, w_hh, b_hh):
        ys = GRULayerV1Function.apply(xp, w_hh, b_hh)
    else:
        ys = run_layer_forward(xp, w_hh, b_hh)
    return ys, ys[-1]
