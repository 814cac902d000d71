"""The port's layers against the JAX package's `models/layers.py`.

Inputs are numpy arrays from a seeded generator; the JAX layer's variables
go through the port's weight bridge (`convert/from_jax.py`) into the torch
layer. Layouts differ (JAX is channel-last), so the test transposes at the
boundary. Tolerances: float32 on both sides with sums taken in another
order, so 1e-5 relative for single layers and 2e-5 absolute for the GRU's
34-step recurrences (gates in [0, 1], h in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.models import layers as TL
from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_tpu.models import layers as JL
from speech2affective_gestures_tpu.ops import gru_pallas


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _init(module, *args, **kwargs):
    return jax.device_get(module.init(jax.random.key(3), *args, **kwargs))


def _load(module, arrays):
    module.load_state_dict(from_jax.to_state_dict(arrays), strict=True)
    return module


def test_linear(rng):
    x = _rand(rng, 4, 7, 12)
    jl = JL.Linear(5)
    v = _init(jl, jnp.asarray(x))
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    tl = _load(nn.Linear(12, 5), {k.removeprefix("m."): a for k, a in
                                  from_jax.linear(v["params"], "m").items()})
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel,padding,dilation", [(5, 2, 1), (3, 1, 1), (2, 0, 2)])
def test_conv1d(rng, kernel, padding, dilation):
    x = _rand(rng, 3, 20, 6)  # (B, T, C) channel-last
    jl = JL.Conv1d(8, kernel, padding=padding, dilation=dilation)
    v = _init(jl, jnp.asarray(x))
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    tl = _load(nn.Conv1d(6, 8, kernel, padding=padding, dilation=dilation),
               {k.removeprefix("m."): a for k, a in
                from_jax.conv1d(v["params"], "m").items()})
    got = tl(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_wn_conv1d_causal(rng, dilation):
    """The TCN's use: left pad (k-1)*dilation, no right pad."""
    x = _rand(rng, 2, 17, 6)
    pad = (2 - 1) * dilation
    jl = JL.WNConv1d(9, 2, dilation=dilation)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (pad, 0), (0, 0)))
    v = _init(jl, xp)
    # make g differ from ||v|| so the normalization is exercised
    v["params"]["g"] = v["params"]["g"] * np.linspace(0.5, 2.0, 9, dtype=np.float32)
    want = np.asarray(jl.apply(v, xp))
    tl = _load(TL.WNConv1d(6, 9, 2, padding=(pad, 0), dilation=dilation),
               {k.removeprefix("m."): a for k, a in
                from_jax.wn_conv1d(v["params"], "m").items()})
    got = tl(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,padding", [((9, 5), (4, 2)), ((1, 1), (0, 0)), ((9, 1), (4, 0))])
def test_conv2d(rng, kernel, padding):
    x = _rand(rng, 2, 12, 9, 3)  # (B, T, V, C)
    jl = JL.Conv2d(10, kernel, padding=padding)
    v = _init(jl, jnp.asarray(x))
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    tl = _load(nn.Conv2d(3, 10, kernel, padding=padding),
               {k.removeprefix("m."): a for k, a in
                from_jax.conv2d(v["params"], "m").items()})
    got = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm(rng, train):
    x = (_rand(rng, 6, 11, 5) * 3.0 + 2.0)  # (B, T, C)
    jl = JL.BatchNorm(5)
    v = _init(jl, jnp.asarray(x), use_running_average=True)
    v["params"]["scale"] = _rand(rng, 5)
    v["params"]["bias"] = _rand(rng, 5)
    v["batch_stats"]["mean"] = _rand(rng, 5)
    v["batch_stats"]["var"] = np.abs(_rand(rng, 5)) + 0.5
    tl = _load(nn.BatchNorm1d(5), {k.removeprefix("m."): a for k, a in
                                   from_jax.batch_norm(v["params"], v["batch_stats"],
                                                       "m").items()})
    tl.train(train)
    got = tl(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    if train:
        want, upd = jl.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
        np.testing.assert_allclose(tl.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tl.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
    else:
        want = jl.apply(v, jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_leaky_relu_slopes():
    x = torch.linspace(-2, 2, 9)
    assert torch.equal(TL.leaky_relu(x, 1.0), x)
    np.testing.assert_allclose(TL.leaky_relu(x, 0.3).numpy(),
                               np.asarray(JL.leaky_relu(jnp.asarray(x.numpy()), 0.3)))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("batch", [1, 5])
def test_gru_against_scan_engine(rng, bidirectional, batch):
    """Two stacked layers: the time-major output and h_last."""
    T, C, H = 9, 7, 16
    x = _rand(rng, batch, T, C)
    jl = JL.GRU(H, num_layers=2, bidirectional=bidirectional)
    v = jax.device_get(jax.jit(jl.init)(jax.random.key(3), jnp.asarray(x)))
    want, want_h = jax.jit(jl.apply)(v, jnp.asarray(x))
    tl = _load(TL.GRU(C, H, num_layers=2, bidirectional=bidirectional),
               from_jax.gru(v["params"], ""))
    with torch.no_grad():
        got, got_h = tl(torch.from_numpy(x))
    assert got.shape == (T, batch, tl.num_dir * H)
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)


@pytest.mark.parametrize("num_dir", [1, 2])
@pytest.mark.parametrize("batch", [1, 5])
def test_gru_layer_plain_against_pallas_v2(rng, num_dir, batch):
    """The plain version of the GRU kernel against the TPU kernel it
    replaces, `gru_pallas.run_layer_v2`, run in interpret mode; the TPU
    layout pads each gate to P = 128 lanes, which the test lays out and
    slices off."""
    T, H = 6, 20
    P = gru_pallas._round_up(H, gru_pallas.LANE)
    xp = _rand(rng, T, batch, num_dir, 3 * H)
    w_hh = (_rand(rng, num_dir, H, 3 * H) / np.sqrt(H)).astype(np.float32)
    b_ih = (_rand(rng, num_dir, 3 * H) * 0.1).astype(np.float32)
    b_hh = (_rand(rng, num_dir, 3 * H) * 0.1).astype(np.float32)
    xp_pad = np.zeros((T, batch, num_dir, 3 * P), np.float32)
    for g in range(3):
        xp_pad[..., g * P:g * P + H] = xp[..., g * H:(g + 1) * H]
    ys, h_last = gru_pallas.run_layer_v2(jnp.asarray(xp_pad), jnp.asarray(w_hh),
                                         jnp.asarray(b_ih), jnp.asarray(b_hh),
                                         interpret=True)
    ys = np.asarray(ys)
    want = np.concatenate([ys[..., d * P:d * P + H] for d in range(num_dir)], -1)
    got, got_h = gru_cuda.gru_layer(
        torch.from_numpy(xp.reshape(T, batch, -1)), torch.from_numpy(w_hh),
        torch.from_numpy(b_ih), torch.from_numpy(b_hh))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h_last), atol=2e-5)
    assert sum(gru_cuda.launches.values()) == 0  # CPU tensors take the plain version
