"""Neural building blocks, in PyTorch's channels-first layout.

The JAX package (`speech2affective_gestures_tpu/models/layers.py`) rebuilt
torch's layers to torch semantics in a channel-last layout. Here torch's own
layers are those semantics, and the models use them directly:

- its `Linear`, `Embed`, `Conv1d`, `Conv2d` are `nn.Linear`,
  `nn.Embedding`, `nn.Conv1d`, `nn.Conv2d` (torch default init: kaiming
  uniform a=sqrt(5), i.e. U(+-1/sqrt(fan_in)); N(0, 1) for the embedding);
- its `BatchNorm` is `BatchNorm1d`/`BatchNorm2d` below: torch's own over
  the channel axis (eval normalizes with the running stats, eps 1e-5;
  train with the biased batch variance, updating the running stats with
  momentum 0.1 and the unbiased variance), which at bf16 activations keeps
  the JAX layer's float32 statistics.

What torch lacks is below: the bf16 behaviour of `BatchNorm`, `WNConv1d`
(weight norm under torch `weight_norm`'s parameter names, so reference
checkpoints load), `GRU` (nn.GRU's parameter names, its recurrence in
`ops/gru_cuda.py`), `LSTM` (nn.LSTM's parameter names, its recurrence a
plain time loop: the JAX package's is a `lax.scan`, not a TPU kernel),
`MaxPool2d` at the JAX layer's stride, the activation helpers, and
`Dropout`, whose masks come from an explicit `torch.Generator` set with
`dropout_rng` (the JAX package draws them from flax's 'dropout' stream),
and `DrawTape`, which records a block's draws from a generator and hands
them back in a rerun of the block.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gru_cuda
from ..parallel import mesh as P


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU with an explicit slope. The reference often writes
    `nn.LeakyReLU(True)`, which passes True as *negative_slope* (1.0, the
    identity); each call site keeps its effective slope."""
    if slope == 1.0:
        return x
    return F.leaky_relu(x, slope)


_dropout_generator: torch.Generator | None = None


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator | None):
    """Draw every dropout mask inside the block from `generator` (on the
    tensors' device). Outside such a block, masks come from torch's global
    generator."""
    global _dropout_generator
    prev, _dropout_generator = _dropout_generator, generator
    try:
        yield
    finally:
        _dropout_generator = prev


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Inverted dropout: zero each value with probability p, scale the rest
    by 1/(1-p); the identity in eval mode or at p = 0, zeros at p = 1 (as
    flax's Dropout: the SER nets' reference default). x is batch first: a
    data-parallel step draws the mask over the global batch (`draw`)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if _dropout_generator is None:
        return F.dropout(x, p, training=True)
    gen = _dropout_generator
    keep = draw(gen, lambda shape: torch.rand(shape, generator=gen, device=gen.device) >= p,
                x.shape)
    return x * keep.to(x.device) / (1.0 - p)


class DrawTape:
    """The draws from one generator inside a block: recorded in order
    while `recording`, handed back in that order while `replaying`
    instead of drawing again (`draw`). A rematerialized forward records
    its dropout masks and noise and its recompute replays them
    (`gan_step.rematerialize`), with no host access to the generator's
    state, so that the pair also runs inside a CUDA graph capture."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: list = []
        self.position: int | None = None   # None while recording

    @contextlib.contextmanager
    def recording(self):
        with self._active(None):
            yield

    @contextlib.contextmanager
    def replaying(self):
        with self._active(0):
            yield

    @contextlib.contextmanager
    def _active(self, position):
        global _tape
        prev, _tape, self.position = _tape, self, position
        try:
            yield
        finally:
            _tape = prev


_tape: DrawTape | None = None


def draw(generator: torch.Generator | None, fn, shape):
    """fn(shape), a tensor drawn from `generator` whose first axis runs
    over the batch; in a data-parallel step this rank's rows of the global
    draw (`parallel.mesh.draw_local`); inside a `DrawTape` block of that
    generator, recorded or replayed."""
    tape = _tape
    if tape is None or generator is not tape.generator:
        return P.draw_local(fn, shape)
    if tape.position is None:
        tape.draws.append(P.draw_local(fn, shape))
        return tape.draws[-1]
    tape.position += 1
    return tape.draws[tape.position - 1]


class Dropout(nn.Module):
    """`dropout` as a module (no parameters, like nn.Dropout)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training)


def sum_bidirectional(out: torch.Tensor, hidden_size: int) -> torch.Tensor:
    """Sum the forward and backward halves of a bi-GRU output."""
    return out[..., :hidden_size] + out[..., hidden_size:]


def _batch_norm_global(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                       mesh: P.DataMesh) -> torch.Tensor:
    """Train-mode BatchNorm over the global batch of a data-parallel step,
    by JAX `layers.BatchNorm`'s two-pass formula (its :186-209): the mean
    of x over the batch and the other non-channel axes of every rank, then
    the mean of (x - mean)^2, each sum all-reduced (`AllReduceSum`, whose
    backward sums the gradients of every rank's loss), in float32 at a bf16
    input; the running stats updated alike on every rank, the variance
    unbiased with the global count."""
    dims = [0, *range(2, x.dim())]
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    count = xf.numel() // xf.shape[1] * mesh.world
    mean = P.AllReduceSum.apply(xf.sum(dims), mesh) / count
    centred = xf - mean.view(shape)
    var = P.AllReduceSum.apply((centred * centred).sum(dims), mesh) / count
    with torch.no_grad():
        bn.num_batches_tracked.add_(1)
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach().to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1 - m).add_(
            (var.detach() * (count / (count - 1))).to(bn.running_var.dtype), alpha=m)
    out = centred * torch.rsqrt(var + bn.eps).view(shape)
    if bn.weight is not None:
        out = out * bn.weight.to(out.dtype).view(shape) + bn.bias.to(out.dtype).view(shape)
    return out.to(x.dtype)


def _batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, forward):
    """`forward(x)`, torch's BatchNorm, but at a bf16 input
    (`_batch_norm_f32`) and in train mode inside a data-parallel step
    (`_batch_norm_global`)."""
    stepping = P.current()
    if bn.training and stepping is not None:
        bn._check_input_dim(x)
        return _batch_norm_global(bn, x, stepping[0])
    if x.dtype != torch.bfloat16:
        return forward(x)
    bn._check_input_dim(x)
    return _batch_norm_f32(bn, x)


def _batch_norm_f32(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """JAX `layers.BatchNorm` at a bf16 activation (its :186-209): the
    statistics from x in float32, the running stats (float32 buffers)
    updated in float32, the scale and bias at the parameters' dtype (bf16
    under mixed precision) applied in float32, the output in x's dtype."""
    if bn.training:
        bn.num_batches_tracked.add_(1)
    weight = None if bn.weight is None else bn.weight.float()
    bias = None if bn.bias is None else bn.bias.float()
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, weight, bias,
                        bn.training, bn.momentum, bn.eps).to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d (its state-dict names), with float32 statistics at a
    bf16 input and global ones in a data-parallel step (`_batch_norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x, super().forward)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (its state-dict names), with float32 statistics at a
    bf16 input and global ones in a data-parallel step (`_batch_norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x, super().forward)


class WNConv1d(nn.Module):
    """Weight-normalized Conv1d: weight = v * g / ||v||, the norm taken over
    (Cin, K) for each output channel. `padding` is symmetric (an int) or
    (left, right)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int | tuple[int, int] = 0, dilation: int = 1):
        super().__init__()
        v = torch.empty(out_channels, in_channels, kernel_size)
        nn.init.kaiming_uniform_(v, a=math.sqrt(5))
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            v.flatten(1).norm(dim=1).view(out_channels, 1, 1).clone())
        bound = 1.0 / math.sqrt(in_channels * kernel_size)
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound))
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
        self.dilation = dilation

    def weight(self) -> torch.Tensor:
        norm = self.weight_v.flatten(1).norm(dim=1).clamp_min(1e-12)
        return self.weight_v * (self.weight_g / norm.view(-1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(F.pad(x, self.padding), self.weight(), self.bias,
                        dilation=self.dilation)


class _Recurrent(nn.Module):
    """The parameters of a multi-layer, optionally bidirectional recurrent
    net under torch's names (`weight_ih_l{n}[_reverse]`, `weight_hh_...`,
    `bias_ih_...`, `bias_hh_...`), GATES * H rows each, with torch's
    U(-1/sqrt(H), 1/sqrt(H)) init."""

    GATES: int

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_dir = 2 if bidirectional else 1
        self.dropout = dropout
        self.suffixes = ["", "_reverse"][: self.num_dir]
        bound = 1.0 / math.sqrt(hidden_size)
        rows = self.GATES * hidden_size
        for layer in range(num_layers):
            cin = input_size if layer == 0 else self.num_dir * hidden_size
            for sfx in self.suffixes:
                for name, shape in ((f"weight_ih_l{layer}{sfx}", (rows, cin)),
                                    (f"weight_hh_l{layer}{sfx}", (rows, hidden_size)),
                                    (f"bias_ih_l{layer}{sfx}", (rows,)),
                                    (f"bias_hh_l{layer}{sfx}", (rows,))):
                    self.register_parameter(name, nn.Parameter(
                        torch.empty(shape).uniform_(-bound, bound)))

    def _layer(self, name: str, layer: int) -> list[torch.Tensor]:
        return [getattr(self, f"{name}_l{layer}{sfx}") for sfx in self.suffixes]


class GRU(_Recurrent):
    """Multi-layer, optionally bidirectional GRU, torch cell semantics.

    Gates ordered (r, z, n); n = tanh(x_n + r * (W_hn h + b_hn)). Each
    layer's input projection for the whole sequence and both directions is
    one `torch.matmul`; the recurrence runs in `gru_cuda.gru_layer`, which
    launches the CUDA kernels for CUDA tensors (forward, and backward under
    autograd) and runs the plain time loop for CPU tensors, which autograd
    differentiates. Dropout between layers, in train mode only.

    forward(x (B, T, C)) -> (out (T, B, D*H), time-major;
    h_last (num_layers*D, B, H)).
    """

    GATES = 3

    def forward(self, x: torch.Tensor):
        out = x.transpose(0, 1)                              # (T, B, C)
        finals = []
        for layer in range(self.num_layers):
            w_ih = torch.cat(self._layer("weight_ih", layer), dim=0)
            xp = torch.matmul(out, w_ih.t())                 # (T, B, D*3H)
            w_hh = torch.stack([w.t() for w in self._layer("weight_hh", layer)])
            out, h_last = gru_cuda.gru_layer(
                xp.contiguous(), w_hh.contiguous(),
                torch.stack(self._layer("bias_ih", layer)),
                torch.stack(self._layer("bias_hh", layer)))
            finals.extend(h_last.unbind(0))
            if layer < self.num_layers - 1:
                # the mask drawn batch first
                out = dropout(out.transpose(0, 1), self.dropout, self.training).transpose(0, 1)
        return out, torch.stack(finals)


class LSTM(_Recurrent):
    """Multi-layer, optionally bidirectional LSTM, torch cell semantics
    (JAX `layers.LSTM`): gates ordered (i, f, g, o), c' = f c + i g,
    h' = o tanh(c'), under nn.LSTM's parameter names. Each layer's input
    projection for the whole sequence and both directions is one
    `torch.matmul`; then one loop over time steps both directions at once
    (the reverse one on the time-flipped projection), as autograd
    differentiates it on any device. Dropout between layers, in train mode
    only.

    forward(x (B, T, C)) -> (out (B, T, D*H); (h_last, c_last), each
    (num_layers*D, B, H)).
    """

    GATES = 4

    def _recurrence(self, xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor):
        """xp (T, D, B, 4H) in each direction's own time order, w_hh (D, H,
        4H), b_hh (D, 1, 4H) -> (ys (T, D, B, H), h_last, c_last)."""
        hsz = self.hidden_size
        h = xp.new_zeros(xp.shape[1], xp.shape[2], hsz)
        c = torch.zeros_like(h)
        ys = []
        for xp_t in xp.unbind(0):
            gates = xp_t + torch.baddbmm(b_hh, h, w_hh)
            act = torch.sigmoid(gates)     # its g quarter unused
            c = (act[..., hsz:2 * hsz] * c
                 + act[..., :hsz] * torch.tanh(gates[..., 2 * hsz:3 * hsz]))
            h = act[..., 3 * hsz:] * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys), h, c

    def forward(self, x: torch.Tensor):
        out = x.transpose(0, 1)                              # (T, B, C)
        t, b = out.shape[:2]
        h_finals, c_finals = [], []
        for layer in range(self.num_layers):
            w_ih = torch.cat(self._layer("weight_ih", layer), dim=0)
            b_ih = torch.cat(self._layer("bias_ih", layer), dim=0)
            xp = (torch.matmul(out, w_ih.t()) + b_ih).view(t, b, self.num_dir, -1)
            xp = xp.permute(0, 2, 1, 3)                      # (T, D, B, 4H)
            if self.num_dir == 2:
                xp = torch.stack([xp[:, 0], xp[:, 1].flip(0)], dim=1)
            w_hh = torch.stack([w.t() for w in self._layer("weight_hh", layer)])
            b_hh = torch.stack(self._layer("bias_hh", layer))[:, None, :]
            ys, h_last, c_last = self._recurrence(xp, w_hh, b_hh)
            outs = [ys[:, 0]] + ([ys[:, 1].flip(0)] if self.num_dir == 2 else [])
            out = torch.cat(outs, dim=-1)                    # (T, B, D*H)
            h_finals.extend(h_last.unbind(0))
            c_finals.extend(c_last.unbind(0))
            if layer < self.num_layers - 1:
                out = dropout(out.transpose(0, 1), self.dropout, self.training).transpose(0, 1)
        return out.transpose(0, 1), (torch.stack(h_finals), torch.stack(c_finals))


class MaxPool2d(nn.MaxPool2d):
    """Max pool over (H, W) of a (B, C, H, W) input with the stride equal
    to the kernel, floor mode (the JAX `layers.MaxPool2d`, channel-last
    there)."""

    def __init__(self, kernel: tuple[int, int]):
        super().__init__(kernel, stride=kernel)
