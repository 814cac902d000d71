"""The port's analytic FLOP count (`train/flops.py`) against the JAX
package's (`train/flops.py`, a walk of the traced jaxpr).

Control programs: each is written in both packages and counted by both
(`fn_flops`); the counts are equal: products, batched products,
convolutions (grouped, with a bias, transposed) and their gradients, a time
loop against `lax.scan`, elementwise ops, reductions, the fused aten ops
(sigmoid's and tanh's backward, leaky ReLU's, BatchNorm in training and
its backward, softmax, log-softmax, LayerNorm) and the random draws. The
Adam update is the one program whose counts differ by rule: torch's Adam
folds the bias corrections and the learning rate into scalars, so its ops
(`lerp_`, `mul_`, `addcmul_`, `sqrt`, `div`, `add_`, `addcdiv_`, with
`lerp`, `addcmul` and `addcdiv` at 3) cost 13 a parameter element against
optax's `adam` + `apply_updates` at 16.

The train step (`canonical_train_step_count`) at hidden 32, 2 layers,
batch 8, against JAX's `canonical_train_step_flops` count of the same
config (its scan engine):
- dot + convolution: JAX's count less one named term is the port's within
  1e-3 (the two agree to the flop here). JAX's transposed scan forms the
  cotangent of each GRU's zero initial state at its last iteration, one
  (B, 3H) x (3H, H) product a direction, layer and differentiated pass
  (the generator's layers once, in the G update; the discriminator's three
  times: real and fake in the D update, the G update's pass): 2 * B *
  numel(weight_hh) flops each. The port's autograd forms none, since the
  zero state takes no gradient. At this config that is 4,915,200 flops,
  1.36e-3 of JAX's dot + convolution count.
- total: within 2% of JAX's count, and within 5e-4 of it once that term
  and the Adam rule's 3 flops a trainable parameter are taken off. What
  stays (1.5e-4 here) is spread over the elementwise ops whose layouts
  differ between the packages: BatchNorm's per-channel terms over the
  ST-GCN's (B, C, T, V) against JAX's per-node (B, T, V, C), the
  convolutions' bias gradients, the GRU's per-direction bias sums, and
  the scan's zero-start accumulators (`test_loop_gradients_against_scan`).
abl_audio at the same config is held to the same bounds. The count is
linear in the batch within 1%, the same under fake tensors as under a
real step on the CPU, and names every op it meets (`uncounted` empty).

At full width (config/multimodal_context_v2.yml's widths, 1000 words, 100
speakers), batch 128: within 2% of the JAX package's 427,243,749,959
(bench.py's pinned figure), the count leaving a trained step's weights,
buffers, gradients, Adam states and update count as they were. The `slow`
case recomputes JAX's full-width count live.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.train import builder as tbuilder
from speech2affective_gestures_torch.train import flops as tflops
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.models import layers as JL
from speech2affective_gestures_tpu.train import flops as jflops

JAX_FULL_WIDTH_B128 = 427_243_749_959
H32 = dict(n_layers=2, hidden_size=32, hidden_size_s2eg=32)
H32_BATCH = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while these tests run: their ops are tiny, and
    beside the other test files' worker processes, torch's threads wait on
    each other at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _s(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _t(shape, grad=False):
    return torch.zeros(shape, requires_grad=grad)


def _jax_vjp(fn):
    """fn's value and its vjp with a ones cotangent, as one JAX program."""
    def both(*args):
        y, pullback = jax.vjp(fn, *args)
        return pullback(jnp.ones_like(y))
    return both


def _torch_backward(fn):
    """fn's value and its backward with a ones cotangent."""
    def both(*args):
        y = fn(*args)
        y.backward(torch.ones_like(y))
    return both


def _conv1d_jax(groups=1, padding="VALID"):
    def conv(x, w):
        return lax.conv_general_dilated(x, w, (1,), padding,
                                        dimension_numbers=("NCH", "OIH", "NCH"),
                                        feature_group_count=groups)
    return conv


def _scan(xs, w):
    return lax.scan(lambda c, x: (c, x @ w), 0.0, xs)[1]


def _loop(xs, w):
    return torch.stack([x @ w for x in xs.unbind(0)])


CONTROL = {
    "matmul": (lambda a, b: a @ b, ((64, 128), (128, 32)),
               lambda a, b: a @ b, None),
    "batched dot": (lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), ((4, 8, 16), (4, 16, 32)),
                    lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b), None),
    "linear with bias": (lambda x, w, b: F.linear(x, w, b), ((12, 16), (8, 16), (8,)),
                         lambda x, w, b: x @ w.T + b, None),
    "conv1d": (lambda x, w: F.conv1d(x, w), ((2, 3, 20), (5, 3, 4)),
               _conv1d_jax(), None),
    "grouped conv": (lambda x, w: F.conv1d(x, w, groups=2), ((2, 8, 10), (8, 4, 3)),
                     _conv1d_jax(groups=2), None),
    "conv2d with bias": (lambda x, w, b: F.conv2d(x, w, b, padding=(4, 0)),
                         ((2, 3, 34, 9), (16, 3, 9, 1), (16,)),
                         lambda x, w, b: lax.conv_general_dilated(
                             x, w, (1, 1), ((4, 4), (0, 0)),
                             dimension_numbers=("NCHW", "OIHW", "NCHW")) + b[None, :, None, None],
                         None),
    "time loop": (_loop, ((7, 4, 8), (8, 16)), _scan, None),
    "elementwise": (lambda a, b: a + b, ((10, 10), (10, 10)), lambda a, b: a + b, None),
    "reductions": (lambda x: x.sum(0) + x.mean(1).sum() + x.amax(), ((6, 9),),
                   lambda x: x.sum(0) + x.mean(1).sum() + x.max(), None),
    # gradients: the backward of the same function with a ones cotangent
    "matmul grad": (lambda x, w: x @ w, ((4, 16), (16, 8)), lambda x, w: x @ w, (0, 1)),
    "conv1d grad": (lambda x, w: F.conv1d(x, w, padding=1), ((2, 6, 12), (4, 6, 3)),
                    _conv1d_jax(padding=((1, 1),)), (0, 1)),
    "grouped conv grad": (lambda x, w: F.conv1d(x, w, groups=2), ((2, 8, 10), (8, 4, 3)),
                          _conv1d_jax(groups=2), (0, 1)),
    "conv weight grad": (lambda x, w: F.conv1d(x, w), ((2, 3, 20), (5, 3, 4)),
                         _conv1d_jax(), (1,)),
    "time loop grad": (_loop, ((7, 4, 8), (8, 16)), _scan, (0,)),
    "sigmoid grad": (torch.sigmoid, ((10, 100),), jax.nn.sigmoid, (0,)),
    "tanh grad": (torch.tanh, ((10, 100),), jnp.tanh, (0,)),
    "relu grad": (torch.relu, ((10, 100),), jax.nn.relu, (0,)),
    "leaky relu grad": (lambda x: F.leaky_relu(x, 0.2), ((10, 100),),
                        lambda x: jax.nn.leaky_relu(x, 0.2), (0,)),
    "softmax grad": (lambda x: torch.softmax(x, -1), ((10, 100),),
                     lambda x: jax.nn.softmax(x, -1), (0,)),
    "log-softmax grad": (lambda x: torch.log_softmax(x, -1), ((6, 50),),
                         lambda x: jax.nn.log_softmax(x, -1), (0,)),
    "square and exp grad": (lambda x: torch.exp(x) * x ** 2, ((5, 7),),
                            lambda x: jnp.exp(x) * x ** 2, (0,)),
}


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_control_program_against_jax(name):
    tfn, shapes, jfn, grad = CONTROL[name]
    if grad is None:
        got = tflops.fn_flops(tfn, *(_t(s) for s in shapes))
        want = jflops.fn_flops(jfn, *(_s(s) for s in shapes))
    else:
        args = [_t(s, grad=i in grad) for i, s in enumerate(shapes)]
        got = tflops.fn_flops(_torch_backward(tfn), *args)
        # JAX differentiates the arguments in `grad`, the others closed over
        fixed = {i: _s(s) for i, s in enumerate(shapes) if i not in grad}

        def jfn_grad(*diff):
            it = iter(diff)
            return jfn(*(fixed[i] if i in fixed else next(it) for i in range(len(shapes))))
        if fixed:
            consts = {i: jnp.zeros(s) for i, s in enumerate(shapes) if i not in grad}

            def jfn_grad(*diff):  # noqa: F811 (the constants bound as arrays)
                it = iter(diff)
                return jfn(*(consts[i] if i in consts else next(it)
                             for i in range(len(shapes))))
        want = jflops.fn_flops(_jax_vjp(jfn_grad), *(_s(s) for i, s in enumerate(shapes)
                                                     if i in grad))
    assert got == want, (name, got, want)


def test_loop_gradients_against_scan():
    """The named differences between a differentiated time loop and JAX's
    transposed `lax.scan`: the scan adds each step's gradient of a weight,
    and a recurrence's carry cotangent, to an accumulator that starts at
    zero (one add of the weight's size, and one of the state's, more than
    autograd's T - 1), and its transpose forms the cotangent of the zero
    initial state (a product of the step's size: 2 * B * H * H here)."""
    t, b, k, n = 7, 4, 8, 16
    got = tflops.fn_flops(_torch_backward(_loop), _t((t, b, k), True), _t((k, n), True))
    want = jflops.fn_flops(_jax_vjp(_scan), _s((t, b, k)), _s((k, n)))
    assert want - got == k * n

    h = 6

    def trec(xs, w):
        hs, state = [], torch.zeros(b, h)
        for x in xs.unbind(0):
            state = torch.tanh(state @ w + x)
            hs.append(state)
        return torch.stack(hs)

    def jrec(xs, w):
        return lax.scan(lambda c, x: (jnp.tanh(c @ w + x),) * 2, jnp.zeros((b, h)), xs)[1]

    got = tflops.fn_flops(_torch_backward(trec), _t((t, b, h), True), _t((h, h), True))
    want = jflops.fn_flops(_jax_vjp(jrec), _s((t, b, h)), _s((h, h)))
    assert want - got == h * h + b * h + 2 * b * h * h


def test_counts_on_named_shapes():
    """The convention's own numbers (JAX tests/test_flops.py's)."""
    assert tflops.fn_flops(lambda a, b: a @ b, _t((64, 128)), _t((128, 32))) == 2 * 64 * 32 * 128
    b, ci, wi, co, k = 2, 8, 10, 8, 3
    assert tflops.fn_flops(lambda x, w: F.conv1d(x, w, groups=2), _t((b, ci, wi)),
                           _t((co, ci // 2, k))) == 2 * b * co * (wi - k + 1) * k * (ci // 2)
    assert tflops.fn_flops(lambda a, b: a + b, _t((10, 10)), _t((10, 10))) == 100


def test_transposed_conv_against_jax():
    """ConvTranspose1d (the embedding net's) as JAX's `conv_transpose`
    (a convolution of the dilated input), forward and both gradients."""
    def jfn(x, w):
        return lax.conv_transpose(x, w, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
                                  transpose_kernel=True)
    x, w = _t((2, 4, 9), grad=True), _t((4, 6, 3), grad=True)
    got = tflops.fn_flops(_torch_backward(lambda x, w: F.conv_transpose1d(x, w)), x, w)
    want = jflops.fn_flops(_jax_vjp(jfn), _s((2, 4, 9)), _s((4, 6, 3)))
    assert got == want


def test_batch_norm_against_jax():
    """BatchNorm in training over (B, C) and its backward (input, scale
    and bias) against JAX's `layers.BatchNorm`: torch counts one flop more
    a call, the increment of its `num_batches_tracked`."""
    bn = JL.BatchNorm(100)
    v = bn.init(jax.random.key(0), jnp.zeros((10, 100)), use_running_average=False)

    def jfn(x, p):
        return bn.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                        use_running_average=False, mutable=["batch_stats"])[0]
    tbn = torch.nn.BatchNorm1d(100).train()
    x = _t((10, 100), grad=True)
    p = jax.tree.map(lambda a: _s(a.shape), v["params"])
    assert tflops.fn_flops(tbn, x) == jflops.fn_flops(jfn, _s((10, 100)), p) + 1
    got = tflops.fn_flops(_torch_backward(tbn), x)
    want = jflops.fn_flops(_jax_vjp(jfn), _s((10, 100)), p)
    assert got == want + 1
    # the input's gradient alone (a frozen BatchNorm in a differentiated pass)
    tbn.requires_grad_(False)
    got = tflops.fn_flops(_torch_backward(tbn), x)
    want = jflops.fn_flops(_jax_vjp(lambda x: jfn(x, v["params"])), _s((10, 100)))
    assert got == want + 1


def test_layer_norm_against_jax():
    import flax.linen as nn

    ln = nn.LayerNorm(epsilon=1e-6)
    v = ln.init(jax.random.key(0), jnp.zeros((10, 100)))
    tln = torch.nn.LayerNorm(100, eps=1e-6)
    x = _t((10, 100), grad=True)
    p = jax.tree.map(lambda a: _s(a.shape), v["params"])
    got = tflops.fn_flops(_torch_backward(tln), x)
    want = jflops.fn_flops(_jax_vjp(lambda x, p: ln.apply({"params": p}, x)), _s((10, 100)), p)
    assert got == want


def test_random_draws_against_jax():
    """`rand` as `jax.random.uniform`, `randn` as `normal`, per element;
    JAX's draw also makes one scalar op (its range's width)."""
    key = jax.random.key(0)
    assert tflops.fn_flops(lambda: torch.rand(10, 100)) + 1 == jflops.fn_flops(
        lambda: jax.random.uniform(key, (10, 100)))
    assert tflops.fn_flops(lambda: torch.randn(10, 100)) + 1 == jflops.fn_flops(
        lambda: jax.random.normal(key, (10, 100)))


def test_adam_update_rule():
    """One Adam update: torch's 13 flops a parameter element against
    optax's 16 (module docstring), so the difference is 3 a parameter."""
    w = torch.zeros(10, 100, requires_grad=True)
    w.grad = torch.ones(10, 100)
    opt = torch.optim.Adam([w], lr=1e-3, betas=(0.5, 0.999))
    got = tflops.fn_flops(opt.step)
    tx = optax.adam(1e-3, b1=0.5, b2=0.999)
    state = jax.tree.map(lambda a: _s(a.shape, a.dtype), tx.init(jnp.zeros((10, 100))))

    def upd(g, p, s):
        u, s2 = tx.update(g, s, p)
        return optax.apply_updates(p, u), s2
    want = jflops.fn_flops(upd, _s((10, 100)), _s((10, 100)), state)
    assert got == 13 * 1000 + 1  # 1 for the update count's increment
    assert abs(want - 16 * 1000) < 10 and want - got == pytest.approx(3 * 1000, abs=10)


def _jax_step_counts(variant: str) -> tuple[float, float]:
    """JAX's (total, dot + convolution) count of one GAN step at H32,
    H32_BATCH (its `canonical_train_step_flops`, both totals of one
    jaxpr)."""
    from functools import partial

    from speech2affective_gestures_tpu.train import builder as jbuilder

    prev = os.environ.get("S2AG_GRU_ENGINE")
    os.environ["S2AG_GRU_ENGINE"] = "scan"
    try:
        cfg = JConfig(**H32)
        setup = jbuilder.init_training(cfg, jax.random.key(0), n_words=1000, n_speakers=100,
                                       variant=variant, abstract=True)
        batch = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                             jbuilder.synthetic_batch(np.random.default_rng(0), H32_BATCH,
                                                      cfg, 1000, 100))
        jaxpr = jax.make_jaxpr(partial(setup["train_step"], gan_on=True))(
            setup["state"], batch, jax.random.key(0))
    finally:
        if prev is None:
            os.environ.pop("S2AG_GRU_ENGINE", None)
        else:
            os.environ["S2AG_GRU_ENGINE"] = prev
    return jflops.count_jaxpr_flops(jaxpr), jflops.dot_conv_flops_only(jaxpr)


def _h0_products(setup, batch: int) -> float:
    """JAX's cotangents of the GRUs' zero initial states (module
    docstring): 2 * B * numel(weight_hh) a direction and layer, once for
    the generator's GRU and three times for the discriminator's."""
    def whh(net):
        return sum(p.numel() for n, p in net.named_parameters() if "weight_hh" in n)
    return 2.0 * batch * (whh(setup["gen"]) + 3 * whh(setup["dis"]))


def _trainable(setup) -> int:
    return sum(p.numel() for net in (setup["gen"], setup["dis"])
               for p in net.parameters() if p.requires_grad)


def _real_count(variant: str, batch: int):
    """A real step on the CPU under the counter (no fake tensors)."""
    cfg = TConfig(**H32)
    setup = tbuilder.init_training(cfg, 0, n_words=1000, n_speakers=100, device="cpu",
                                   variant=variant)
    data = tbuilder.to_device(tbuilder.synthetic_batch(np.random.default_rng(0), batch, cfg),
                              "cpu")
    with tflops.FlopCounter() as counter:
        setup["step"].train_step(data, torch.Generator().manual_seed(0), gan_on=True)
    return counter, setup


def _check_against_jax(counter, setup, jax_total, jax_dc):
    assert not counter.uncounted, counter.uncounted
    h0 = _h0_products(setup, H32_BATCH)
    assert abs(counter.dot_conv - (jax_dc - h0)) <= 1e-3 * jax_dc, (counter.dot_conv, jax_dc, h0)
    assert abs(counter.total / jax_total - 1) <= 0.02
    named = jax_total - h0 - 3 * _trainable(setup)
    assert abs(counter.total / named - 1) <= 5e-4, (counter.total, named)


@pytest.fixture(scope="module")
def s2ag_h32():
    """(JAX's total, JAX's dot + conv, the port's canonical count)."""
    jax_total, jax_dc = _jax_step_counts("s2ag")
    port = tflops.canonical_train_step_count(TConfig(**H32), H32_BATCH)
    return jax_total, jax_dc, port


def test_h32_step_against_jax(s2ag_h32):
    jax_total, jax_dc, port = s2ag_h32
    setup = tbuilder.init_training(TConfig(**H32), 0, device="cpu")
    _check_against_jax(port, setup, jax_total, jax_dc)
    # the named JAX-only term is exactly the dot + convolution difference here
    assert jax_dc - port.dot_conv == _h0_products(setup, H32_BATCH) == 4_915_200


def test_fake_count_equals_a_real_step(s2ag_h32):
    """The count under fake tensors is the count of a real CPU step."""
    real, _ = _real_count("s2ag", H32_BATCH)
    assert real.total == s2ag_h32[2].total and real.dot_conv == s2ag_h32[2].dot_conv


def test_abl_audio_h32_step_against_jax():
    jax_total, jax_dc = _jax_step_counts("abl_audio")
    counter, setup = _real_count("abl_audio", H32_BATCH)
    _check_against_jax(counter, setup, jax_total, jax_dc)


def test_count_linear_in_batch(s2ag_h32):
    double, _ = _real_count("s2ag", 2 * H32_BATCH)
    assert abs(double.total / s2ag_h32[2].total - 2.0) < 0.02


def _snapshot(setup) -> dict:
    step = setup["step"]
    nets = (setup["gen"], setup["dis"], setup["tri"])
    return dict(
        params=[p.detach().clone() for n in nets for p in n.parameters()],
        buffers=[b.clone() for n in nets for b in n.buffers()],
        grads=[None if p.grad is None else p.grad.clone() for n in nets for p in n.parameters()],
        adam=[{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
              for opt in (step.gen_opt, step.dis_opt) for s in opt.state.values()],
        lrs=[g["lr"] for opt in (step.gen_opt, step.dis_opt) for g in opt.param_groups],
        step=step.step)


def _same(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return type(b) is torch.Tensor and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_full_width_count_against_jax_and_state_untouched():
    """Batch 128 at full width within 2% of JAX's pinned count; a trained
    step's state is as it was after the count, and it trains on."""
    cfg = TConfig()
    setup = tbuilder.init_training(cfg, 0, n_words=1000, n_speakers=100, device="cpu")
    small = tbuilder.to_device(tbuilder.synthetic_batch(np.random.default_rng(1), 2, cfg),
                               "cpu")
    setup["step"].train_step(small, torch.Generator().manual_seed(1), gan_on=True)
    before = _snapshot(setup)
    batch = tbuilder.to_device(tbuilder.synthetic_batch(np.random.default_rng(0), 128, cfg),
                               "cpu")
    counter = tflops.count_train_step(setup["step"], batch)
    assert _same(_snapshot(setup), before)
    assert not counter.uncounted
    assert abs(counter.total / JAX_FULL_WIDTH_B128 - 1) <= 0.02, counter.total
    # the dot + convolution work is nearly all of it, as in the JAX package
    assert counter.dot_conv / counter.total > 0.99
    metrics = setup["step"].train_step(small, torch.Generator().manual_seed(2), gan_on=True)
    assert all(math.isfinite(float(v)) for v in metrics.values())


@pytest.mark.slow
def test_full_width_against_live_jax_count():
    """JAX's full-width count recomputed (11 s of tracing), and the port's
    canonical count within 2% of it."""
    want = jflops.canonical_train_step_flops(JConfig(), 128)
    assert want == JAX_FULL_WIDTH_B128
    got = tflops.canonical_train_step_flops(TConfig(), 128)
    assert abs(got / want - 1) <= 0.02
