"""The port's GRU layer gradients on the CPU: its autograd Function
(`gru_cuda.GRULayerFunction`, the forward and backward plain versions on
CPU tensors) and the plain loop under autograd, against the JAX package's
fused layer (`gru_pallas.run_layer_v2`, Pallas in interpret mode) under
`jax.grad`; and the plain backward against autograd through the plain
forward. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda_kernels.py.

Shapes: T 6, H 20 (a multiple of neither 16 nor 128), input width 10,
B in {1, 3}, one or two directions. Tolerance against JAX: 2e-5 absolute
and relative, float32 on both sides through a 6-step recurrence with sums
in another order (the tolerance of the GRU forward's tests). The plain
backward against autograd runs in float64, where both compute the same
products: 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_tpu.ops import gru_pallas

T, H, CIN = 6, 20, 10
TOL = dict(rtol=2e-5, atol=2e-5)


def _params(B, D, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((T, B, CIN)).astype(np.float32),
        w_ih=(rng.standard_normal((D, CIN, 3 * H)) * 0.3).astype(np.float32),
        w_hh=(rng.standard_normal((D, H, 3 * H)) / 4).astype(np.float32),
        b_ih=(rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32),
        b_hh=(rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32),
        gh=rng.standard_normal((D, B, H)).astype(np.float32),
    )


def _jax_grads(p, D):
    P = gru_pallas._round_up(H, gru_pallas.LANE)

    def loss(x, w_ih, w_hh, b_ih, b_hh):
        w_stack = gru_pallas.stack_input_weights(
            [w_ih[d] for d in range(D)], H, padded_input=False, num_dir_in=D)
        xp = jnp.einsum("tbc,cdk->tbdk", x, w_stack)
        ys, h_last = gru_pallas.run_layer_v2(xp, w_hh, b_ih, b_hh, interpret=True)
        y = jnp.concatenate([ys[:, :, d * P:d * P + H] for d in range(D)], -1)
        return jnp.sum(jnp.sin(y) * y) + jnp.sum(h_last * p["gh"])

    args = [jnp.asarray(p[k]) for k in ("x", "w_ih", "w_hh", "b_ih", "b_hh")]
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return [np.asarray(g) for g in grads]


def _torch_grads(p, layer):
    x, w_ih, w_hh, b_ih, b_hh = (torch.from_numpy(p[k]).requires_grad_()
                                 for k in ("x", "w_ih", "w_hh", "b_ih", "b_hh"))
    xp = torch.einsum("tbc,dck->tbdk", x, w_ih).flatten(2)
    ys, h_last = layer(xp.contiguous(), w_hh, b_ih, b_hh)
    loss = (torch.sin(ys) * ys).sum() + (h_last * torch.from_numpy(p["gh"])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (x, w_ih, w_hh, b_ih, b_hh))]


NAMES = ("dx", "dW_ih", "dW_hh", "db_ih", "db_hh")


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("B", [1, 3])
def test_function_gradients_match_jax(B, D):
    p = _params(B, D, seed=10 * B + D)
    want = _jax_grads(p, D)
    got = _torch_grads(p, gru_cuda.GRULayerFunction.apply)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    assert sum(gru_cuda.launches.values()) == 0


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_loop_gradients_match_jax(B, D):
    """The path `models/layers.GRU` takes for CPU tensors: the plain loop,
    differentiated by autograd."""
    p = _params(B, D, seed=20 * B + D)
    want = _jax_grads(p, D)
    got = _torch_grads(p, gru_cuda.gru_layer)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _f64_layer(B, D, seed):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(T, B, D * 3 * H, generator=g, dtype=torch.float64)
    w = torch.randn(D, H, 3 * H, generator=g, dtype=torch.float64) * 0.3
    bi = torch.randn(D, 3 * H, generator=g, dtype=torch.float64) * 0.3
    bh = torch.randn(D, 3 * H, generator=g, dtype=torch.float64) * 0.3
    return [t.requires_grad_() for t in (xp, w, bi, bh)], g


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_backward_matches_autograd(B, D):
    leaves, g = _f64_layer(B, D, seed=B + 5 * D)
    ys, h_last = gru_cuda.gru_layer_plain(*leaves)
    dys = torch.randn(ys.shape, generator=g, dtype=torch.float64)
    dh = torch.randn(h_last.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad((ys * dys).sum() + (h_last * dh).sum(), leaves)
    got = gru_cuda.gru_layer_bwd(*(t.detach() for t in leaves), ys.detach(),
                                 gru_cuda.fold_h_last(dys, dh))
    for name, a, b in zip(("dxp", "dW_hh", "db_ih", "db_hh"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)


def test_input_gradient_only_skips_weights():
    """With weights=False (what the Function asks for when no weight needs
    a gradient) only dxp comes back, the same as with weights."""
    leaves, g = _f64_layer(3, 2, seed=1)
    ys, _ = gru_cuda.gru_layer_plain(*leaves)
    dys = torch.randn(ys.shape, generator=g, dtype=torch.float64)
    args = [t.detach() for t in leaves] + [ys.detach(), dys]
    dxp, dw, db_ih, db_hh = gru_cuda.gru_layer_bwd(*args, weights=False)
    assert dw is None and db_ih is None and db_hh is None
    torch.testing.assert_close(dxp, gru_cuda.gru_layer_bwd(*args)[0], rtol=0, atol=0)
    # through the Function: frozen weights get no gradient
    xp = leaves[0].detach().requires_grad_()
    frozen = [t.detach() for t in leaves[1:]]
    ys2, _ = gru_cuda.GRULayerFunction.apply(xp, *frozen)
    (ys2 * dys).sum().backward()
    torch.testing.assert_close(xp.grad, dxp, rtol=1e-12, atol=1e-12)


def test_fold_h_last_adds_at_each_final_frame():
    dys = torch.zeros(4, 2, 2 * 3)
    dh = torch.arange(12, dtype=torch.float32).view(2, 2, 3) + 1
    out = gru_cuda.fold_h_last(dys, dh)
    assert torch.equal(out[-1, :, :3], dh[0]) and torch.equal(out[0, :, 3:], dh[1])
    assert out.abs().sum() == dh.abs().sum()
    assert dys.abs().sum() == 0  # the input is not modified


def test_backward_wrappers_reject_other_devices():
    meta = dict(device="meta")
    xp = torch.empty((2, 1, 6), **meta)
    w, b = torch.empty((1, 2, 6), **meta), torch.empty((1, 6), **meta)
    y = torch.empty((2, 1, 2), **meta)
    with pytest.raises(ValueError):
        gru_cuda.gru_bwd_recurrence(xp, w, b, b, y, y)
    with pytest.raises(ValueError):
        gru_cuda.gru_dw(y, xp, y, 1)
