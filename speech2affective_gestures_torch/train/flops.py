"""Analytic FLOP count of the port's programs, the MFU numerator.

One train step's FLOP count must not depend on the engine that runs it
(per step, K steps a CUDA graph, float32 or mixed, the kernels or their
plain versions), nor on the device. This module counts the aten ops that a
program dispatches (`FlopCounter`, a `TorchDispatchMode`), under fake
tensors (`torch._subclasses.fake_tensor`): no kernel runs and no memory of
the activations' size is taken. Its convention is the JAX package's
`train/flops.py` (a walk of the traced jaxpr) written for aten ops, so
that the two packages count the same work for the same step:

- `mm`, `bmm`: 2 * out * K (a multiply-add is 2 flops); `addmm`,
  `baddbmm`: the same plus 1 per output for the bias (JAX's
  `dot_general` + `add`); `mv`, `dot` alike;
- `convolution`: 2 * out * (Cin / groups * kernel size), plus 1 per output
  for a bias (JAX's `conv_general_dilated` + `add`); a transposed
  convolution as the dilated convolution that JAX runs for it;
- `convolution_backward`: each gradient in its `output_mask` costed as the
  convolution that JAX's transpose rule emits: the input's as 2 * input *
  (Cout / groups * kernel size), the kernel's as 2 * kernel * (batch *
  output positions), the bias's as a sum over the output (1 per element);
- elementwise ops, in place or not, and `_foreach_*` lists: 1 per element
  written (JAX's one flop per element of each elementwise primitive);
- reductions (`sum`, `amax`, `cumsum`, ...): 1 per input element; `mean`
  1 more per output (JAX's `reduce_sum` + `div`); `linalg_vector_norm`
  2 per input and 1 per output (`mul`, `reduce_sum`, `sqrt`);
- layout, creation, comparison, selection, gathers and scatters (JAX's
  `reshape`, `pad`, `select_n`, `gather`, `scatter-add`), integer draws
  (`randperm`, `randint`): 0.

The fused aten ops are costed as the JAX primitives they stand for, per
element written (n), per statistic (c) or per normalized row (r):

- `sigmoid_backward` 3 n (`logistic`'s jvp: `sub`, `mul`, `mul`),
  `tanh_backward` 4 n, `threshold_backward` 0 (`relu`'s jvp is a
  `select_n`), `leaky_relu_backward` 2 n (the `mul` by the slope and the
  `add_any` of `where`'s two branches); `addcmul`, `addcdiv`, `lerp` 3 n;
  `clamp` 2 n;
- `native_batch_norm` in training 8 n + 11 c (JAX's `layers.BatchNorm`:
  the mean, the two-pass variance, `(x - mean) * inv * scale + bias`, the
  running statistics), in evaluation 4 n + 2 c; its backward 13 n - c for
  the input's gradient and 3 n + 2 c for the scale's and bias's;
- `_softmax` 5 n + r, its backward 7 n + 4 r; `_log_softmax` 5 n + 2 r,
  its backward 4 n + 2 r; `native_layer_norm` 7 n + 7 r, its backward
  10 n for the input, 3 n for the scale and bias, 13 r (`jax.nn` and
  flax's `LayerNorm`);
- the random draws: `rand`, `uniform`, `bernoulli` 4 n
  (`jax.random.uniform`'s arithmetic on the bits), `randn`, `normal` 5 n.

An op that no rule names counts 0 and is recorded in
`FlopCounter.uncounted`, so that a test can show that a program holds none.

`canonical_train_step_flops` counts one `GanStep.train_step(gan_on=True)`,
the D update and the G update, on the GRU's plain time loop (the CPU
path, which autograd differentiates), as JAX counts its `lax.scan` engine:
the work of the step, whichever engine and precision run it. Where the
two differ is named in tests/test_torch_flops.py: JAX's transposed scan
forms each GRU's zero-state cotangent and adds to zero-start
accumulators, and optax's Adam costs 16 flops a parameter element where
torch's costs 13 (its bias corrections and rate folded into scalars).
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
                   "vdot"})

# ops costed per element written: elementwise ops at 1, and the fused ones
# at the count of the JAX primitives they stand for (module docstring)
_PER_OUT = dict.fromkeys((
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg", "abs", "sgn",
    "sign", "exp", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "erf",
    "rsqrt", "sqrt", "pow", "atan2", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "floor", "ceil", "round", "trunc", "square", "reciprocal",
    "relu", "leaky_relu", "maximum", "minimum", "clamp_min", "clamp_max", "elu",
    "gelu", "silu", "softplus", "hardtanh", "xlogy",
), 1) | {
    "sigmoid_backward": 3, "tanh_backward": 4, "threshold_backward": 0,
    "hardtanh_backward": 0, "leaky_relu_backward": 2, "addcmul": 3, "addcdiv": 3,
    "lerp": 3, "clamp": 2,
    # random draws: `jax.random.uniform`'s `sub`, `mul`, `add`, `max` on the
    # bits made floats, and `normal`'s one `mul` more (its `erf_inv` counts 0)
    "rand": 4, "rand_like": 4, "uniform": 4, "bernoulli": 4, "randn": 5,
    "randn_like": 5, "normal": 5,
}

# (per element, per row) of the softmaxes and LayerNorm: JAX's
# `jax.nn.softmax`, `log_softmax` and flax's `LayerNorm` and their
# transposes (LayerNorm's backward: 10 per element for the input's
# gradient, 3 for the scale's and bias's, 13 per row)
_ROWWISE = {
    "_softmax": (5, 1), "_softmax_backward_data": (7, 4), "_log_softmax": (5, 2),
    "_log_softmax_backward_data": (4, 2), "native_layer_norm": (7, 7),
    "native_layer_norm_backward": (13, 13),
}

# reductions: one flop per input element
_REDUCTIONS = frozenset({
    "sum", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "cumsum",
    "cumprod", "cummax", "cummin", "logsumexp", "aminmax", "nansum",
})

# ops that do no arithmetic in JAX's convention: layout, creation,
# comparison, selection, gathers and scatters, the integer draws
_FREE = frozenset({
    "_to_copy", "_unsafe_view", "alias", "arange", "as_strided", "cat", "clone",
    "constant_pad_nd", "copy", "detach", "diagonal", "embedding", "empty",
    "empty_like", "empty_strided", "eq", "expand", "fill", "flip", "full",
    "full_like", "gather", "ge", "gt", "index", "index_select", "le", "lift_fresh",
    "lift_fresh_copy", "logical_and", "logical_not", "logical_or", "lt",
    "masked_fill", "ne", "new_empty", "new_empty_strided", "new_full", "new_ones",
    "new_zeros", "ones", "ones_like", "permute", "randint", "randperm", "repeat",
    "roll", "scalar_tensor", "select", "select_backward", "slice", "slice_backward",
    "slice_scatter", "select_scatter", "split", "split_with_sizes", "squeeze",
    "stack", "t", "transpose", "unbind", "unfold", "unsqueeze", "view", "where",
    "zero", "zeros", "zeros_like", "_local_scalar_dense", "item", "sort", "topk",
    "argsort", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "isnan",
    "isinf", "isfinite", "_unsafe_index", "index_put", "embedding_dense_backward",
    "index_add", "scatter", "scatter_add", "masked_scatter", "tril", "triu",
    "resize", "equal", "any", "all", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "dim", "device", "is_nonzero", "reshape", "contiguous",
    "repeat_interleave", "narrow", "chunk", "nonzero", "count_nonzero",
    "_record_function_enter_new", "_record_function_exit",
})

_KNOWN = _DOTS | set(_PER_OUT) | set(_ROWWISE) | _REDUCTIONS | _FREE


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _out_numel(args, out) -> int:
    """Elements written: the outputs', or an in-place op's first argument's
    (a `_foreach_*` op in place returns nothing)."""
    ts = _tensors(out)
    if not ts:
        ts = _tensors(args[0]) if args else []
    return sum(t.numel() for t in ts)


def _conv_macs(weight: torch.Tensor, transposed: bool, groups: int) -> int:
    """Multiply-adds per output element of a convolution: the input
    channels of a group times the kernel size."""
    ksize = math.prod(weight.shape[2:])
    cin = weight.shape[0] if transposed else weight.shape[1] * groups
    return (cin // groups) * ksize


def _arg(args, kwargs, i: int, name: str, default=None):
    """Argument `i` of an aten call, passed by position or by name."""
    return args[i] if len(args) > i else kwargs.get(name, default)


def _batch_norm_training(name: str, overload: str, args, kwargs) -> bool:
    if name == "_native_batch_norm_legit_no_training":
        return False
    if overload == "no_stats":
        return bool(_arg(args, kwargs, 3, "training"))
    return bool(_arg(args, kwargs, 5, "training"))


def _cost(name: str, overload: str, args, kwargs, out):
    """(total flops, the dot + convolution part) of one aten call, or None
    for an op that no rule names."""
    if name in _DOTS:
        a = args[1] if name.startswith("add") or name == "baddbmm" else args[0]
        res = _tensors(out)[0] if _tensors(out) else args[0]
        dot = 2.0 * res.numel() * a.shape[-1] * (a.shape[0] if name == "addbmm" else 1)
        bias = float(res.numel()) if name.startswith("add") or name == "baddbmm" else 0.0
        return dot + bias, dot
    if name == "convolution":
        w, b = args[1], _arg(args, kwargs, 2, "bias")
        transposed = bool(_arg(args, kwargs, 6, "transposed"))
        groups = int(_arg(args, kwargs, 8, "groups", 1))
        res = _tensors(out)[0]
        conv = 2.0 * res.numel() * _conv_macs(w, transposed, groups)
        return conv + (res.numel() if b is not None else 0.0), conv
    if name == "convolution_backward":
        grad, x, w = args[0], args[1], args[2]
        transposed = bool(_arg(args, kwargs, 7, "transposed"))
        groups = int(_arg(args, kwargs, 9, "groups", 1))
        mask = _arg(args, kwargs, 10, "output_mask")
        conv = 0.0
        if mask[0]:
            # the input's gradient: a convolution of the output's gradient
            # with the kernel, one output element per input element
            cout = w.shape[1] * groups if transposed else w.shape[0]
            conv += 2.0 * x.numel() * (cout // groups) * math.prod(w.shape[2:])
        if mask[1]:
            # the kernel's: a product over the batch and the output's
            # positions (a transposed convolution's too: JAX runs it as a
            # convolution of the dilated input)
            conv += 2.0 * w.numel() * (grad.numel() // grad.shape[1])
        return conv + (grad.numel() if mask[2] else 0.0), conv
    if name in ("native_batch_norm", "_native_batch_norm_legit",
                "_native_batch_norm_legit_no_training"):
        x = args[0]
        n, c = x.numel(), x.shape[1]
        if _batch_norm_training(name, overload, args, kwargs):
            return 8.0 * n + 11.0 * c, 0.0
        return 4.0 * n + 2.0 * c, 0.0
    if name == "native_batch_norm_backward":
        x, mask = args[1], _arg(args, kwargs, 9, "output_mask")
        n, c = x.numel(), x.shape[1]
        return ((13.0 * n - c if mask[0] else 0.0)
                + (3.0 * n + 2.0 * c if mask[1] or mask[2] else 0.0)), 0.0
    if name in _ROWWISE:
        per_n, per_row = _ROWWISE[name]
        if name.startswith("native_layer_norm"):
            # (input, normalized_shape, ...); the backward's (grad, input,
            # normalized_shape, ..., output_mask)
            x, normalized = (args[0], args[1]) if name == "native_layer_norm" else args[1:3]
            rows = x.numel() // math.prod(normalized)
            if name == "native_layer_norm_backward":
                mask = _arg(args, kwargs, 7, "output_mask")
                per_n = 10 * bool(mask[0]) + 3 * bool(mask[1] or mask[2])
        else:
            # (input, dim, ...); the backward's (grad, output, dim, ...)
            x = args[0]
            rows = x.numel() // x.shape[args[1] if name in ("_softmax", "_log_softmax")
                                        else args[2]]
        return float(per_n * x.numel() + per_row * rows), 0.0
    if name == "linalg_vector_norm":
        return 2.0 * args[0].numel() + _out_numel(args, out), 0.0
    if name in ("max", "min") and overload == "other":
        return float(_out_numel(args, out)), 0.0
    if name == "mean":
        return float(args[0].numel() + _out_numel(args, out)), 0.0
    if name in _REDUCTIONS:
        return float(args[0].numel()), 0.0
    if name in _PER_OUT:
        return float(_PER_OUT[name] * _out_numel(args, out)), 0.0
    if name in _FREE:
        return 0.0, 0.0
    return None


def _op_name(func) -> tuple[str, str]:
    """(the rule's name, the overload) of an aten op: without the
    "_foreach_" prefix, and without the in-place form's trailing "_"."""
    name = func.overloadpacket.__name__
    if name.startswith("_foreach_"):
        name = name[len("_foreach_"):]
    if name.endswith("_") and name[:-1] in _KNOWN:
        name = name[:-1]
    return name, func._overloadname


class FlopCounter(TorchDispatchMode):
    """Counts the flops of the aten ops dispatched inside it (module
    docstring): `total`, `dot_conv` (the `mm`/`bmm`/`addmm`/convolution
    part, the JAX package's `dot_conv_flops_only`) and `uncounted` (calls
    of ops that no rule names, by name)."""

    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.dot_conv = 0.0
        self.uncounted: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, overload = _op_name(func)
        cost = _cost(name, overload, args, kwargs, out)
        if cost is None:
            self.uncounted[name] += 1
        else:
            self.total += cost[0]
            self.dot_conv += cost[1]
        return out


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def fn_flops(fn, *args, **kwargs) -> float:
    """Flops of `fn(*args, **kwargs)` run under fake tensors: each tensor
    argument is replaced by a fake one of its shape, dtype, device and
    `requires_grad`, so that no kernel runs. A backward that `fn` runs is
    counted with it."""
    mode = _fake_mode()
    args, kwargs = tree_map_only(torch.Tensor, mode.from_tensor, (args, kwargs))
    with mode, FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total


def count_train_step(step, batch: dict, gan_on: bool = True) -> FlopCounter:
    """The `FlopCounter` of one `step.train_step(batch, gan_on=gan_on)`
    (a `gan_step.GanStep` whose nets are on the CPU, a batch of CPU
    tensors) run under fake tensors. The step is left as it was: its
    parameters, buffers and gradients, both Adams' states and learning
    rates, its update count (an op whose inputs are all real, such as
    BatchNorm's `num_batches_tracked.add_(1)`, runs for real under fake
    tensors, so their values are put back too). The Adams count from a
    fresh state (a first update does the work of any other)."""
    nets = [m for m in (step.gen, step.dis, step.tri) if m is not None]
    grads = [(p, p.grad) for m in nets for p in m.parameters()]
    buffers = [(mod, dict(mod._buffers)) for m in nets for mod in m.modules()]
    values = [(t, t.detach().clone()) for m in nets
              for t in (*m.parameters(), *m.buffers())]
    opts = [(opt, opt.state, [dict(g) for g in opt.param_groups])
            for opt in (step.gen_opt, step.dis_opt)]
    counts = step.step, dict(step.grad_norms)
    try:
        for opt, _, _ in opts:
            opt.state = collections.defaultdict(dict)
        mode = _fake_mode()
        fake = {k: mode.from_tensor(v) for k, v in batch.items()}
        with mode, FlopCounter() as counter:
            step.train_step(fake, torch.Generator().manual_seed(0), gan_on=gan_on)
    finally:
        for p, g in grads:
            p.grad = g
        for mod, bufs in buffers:
            mod._buffers.clear()
            mod._buffers.update(bufs)
        with torch.no_grad():
            for t, value in values:
                t.copy_(value)
        for opt, state, groups in opts:
            opt.state = state
            for group, saved in zip(opt.param_groups, groups):
                group.clear()
                group.update(saved)
        step.step, step.grad_norms = counts
    return counter


def canonical_train_step_count(cfg, batch_size: int, n_words: int = 1000,
                               n_speakers: int = 100, variant: str = "s2ag") -> FlopCounter:
    """The `FlopCounter` of `canonical_train_step_flops`'s step."""
    from .builder import init_training, synthetic_batch, to_device

    setup = init_training(cfg, 0, n_words=n_words, n_speakers=n_speakers, device="cpu",
                          variant=variant)
    batch = to_device(synthetic_batch(np.random.default_rng(0), batch_size, cfg, n_words,
                                      n_speakers), "cpu")
    return count_train_step(setup["step"], batch)


def canonical_train_step_flops(cfg, batch_size: int, n_words: int = 1000,
                               n_speakers: int = 100, variant: str = "s2ag") -> float:
    """Flops of ONE GAN train step (the D update and the G update,
    gan_on=True) of `variant` at `cfg`'s widths and `batch_size`: the
    numerator of the step's MFU (JAX `canonical_train_step_flops`).

    The nets are built on the CPU from seed 0 and the step counted under
    fake tensors (`count_train_step`): the GRU's plain time loop, as JAX
    counts its scan engine, in float32. No kernel runs and no device is
    touched, so the number is the same for every engine and precision
    that runs the step, and costs seconds of host time."""
    return canonical_train_step_count(cfg, batch_size, n_words, n_speakers, variant).total
