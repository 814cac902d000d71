"""The port's v1 GRU layer (`gru_cuda.run_layer`) on the CPU against the JAX
package's `gru_pallas.run_layer`, the Pallas v1 kernels run in interpret
mode: values, and gradients in xp, w_hh and b_hh under `jax.grad`. The
cases are those `tests/test_gru_pallas.py` pins for the v1 kernels: T 7,
D 2, B 4, H 12; one direction; a batch that is no tile multiple; and B
256, where the TPU kernel runs several batch blocks and accumulates its
weight gradients across them.

Tolerances, float32 with sums in another order (the JAX side pads H to 128
lanes and folds b_hh_r and b_hh_z into xp): ys and h_last 2e-6 absolute
(h in [-1, 1] after a few steps); the gradients within 2e-5 of each one's
largest value, as `tests/test_torch_gru_bwd.py` holds the v2 layer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_tpu.ops import gru_pallas

FWD_TOL = 2e-6
GRAD_TOL = 2e-5


def _inputs(T, D, B, H, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((T, D, B, 3 * H)) * scale).astype(np.float32)
    w = (rng.standard_normal((D, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32)
    return xp, w, b


def _loss_weights(T, D, B, H, seed):
    return np.random.default_rng(seed + 100).standard_normal((T, D, B, H)).astype(np.float32)


def _jax_grads(xp, w, b, dys):
    def loss(xp, w, b):
        ys, h_last = gru_pallas.run_layer(xp, w, b, interpret=True)
        return jnp.sum(ys * dys) + jnp.sum(jnp.sin(h_last))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xp), jnp.asarray(w),
                                              jnp.asarray(b))]


def _port_grads(xp, w, b, dys):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xp, w, b)]
    ys, h_last = gru_cuda.run_layer(*leaves)
    (ys * torch.from_numpy(dys)).sum().add(torch.sin(h_last).sum()).backward()
    return [t.grad.numpy() for t in leaves]


def _assert_rel(got, want, tol, name):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (name, err)


CASES = {
    "T7_D2_B4_H12": (7, 2, 4, 12, 1.0),
    "unidirectional": (7, 1, 4, 12, 1.0),
    "batch_no_tile_multiple": (5, 2, 3, 12, 1.0),
    "batch_256": (4, 2, 256, 8, 0.3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    T, D, B, H, scale = CASES[case]
    xp, w, b = _inputs(T, D, B, H, seed=len(case), scale=scale)
    want_ys, want_h = gru_pallas.run_layer(jnp.asarray(xp), jnp.asarray(w),
                                           jnp.asarray(b), interpret=True)
    got_ys, got_h = gru_cuda.run_layer(*(torch.from_numpy(a) for a in (xp, w, b)))
    assert got_ys.shape == (T, D, B, H) and got_h.shape == (D, B, H)
    np.testing.assert_allclose(got_ys.numpy(), np.asarray(want_ys), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    """d/dxp, d/dw_hh, d/db_hh of a loss on ys and on h_last (which is
    ys[-1], so its gradient reaches the walk's last step): b_hh's r and z
    parts flow through JAX's fold into xp, its n part out of the kernel."""
    T, D, B, H, scale = CASES[case]
    xp, w, b = _inputs(T, D, B, H, seed=len(case) + 7, scale=scale)
    dys = _loss_weights(T, D, B, H, seed=len(case))
    for name, got, want in zip(("dxp", "dw_hh", "db_hh"), _port_grads(xp, w, b, dys),
                               _jax_grads(xp, w, b, dys)):
        _assert_rel(got, want, GRAD_TOL, name)


def test_plain_backward_pieces_match_autograd():
    """The kernels' oracles: the plain recurrence and the plain dW/db
    reduction give autograd's gradients of the plain forward, in float64
    (to rounding)."""
    T, D, B, H = 6, 2, 3, 5
    g = torch.Generator().manual_seed(4)
    xp = torch.randn(T, D, B, 3 * H, generator=g, dtype=torch.float64)
    w = torch.randn(D, H, 3 * H, generator=g, dtype=torch.float64) / 3
    b = torch.randn(D, 3 * H, generator=g, dtype=torch.float64) * 0.1
    dys = torch.randn(T, D, B, H, generator=g, dtype=torch.float64)
    ys, _ = gru_cuda.run_layer_plain(xp, w, b)
    dxp, gn = gru_cuda.run_layer_bwd_recurrence(xp, w, b, ys, dys)
    dw, db = gru_cuda.run_layer_dw(ys, dxp, gn)
    leaves = [t.clone().requires_grad_() for t in (xp, w, b)]
    want = torch.autograd.grad((gru_cuda.run_layer_plain(*leaves)[0] * dys).sum(), leaves)
    for got, w_ in zip((dxp, dw, db), want):
        assert (got - w_).abs().max().item() <= 1e-12
    assert gru_cuda.run_layer_bwd_recurrence(xp, w, b, ys, dys, want_gn=False)[1] is None


def test_v1_and_v2_layers_compute_the_same_function():
    """`run_layer` on the walk layout of the same inputs gives the model
    layer's (`gru_layer`) outputs: the same function in two layouts."""
    T, B, H, D = 6, 3, 10, 2
    g = torch.Generator().manual_seed(2)
    xp = torch.randn(T, B, D * 3 * H, generator=g)
    w = torch.randn(D, H, 3 * H, generator=g) / 4
    b_ih, b_hh = (torch.randn(D, 3 * H, generator=g) * 0.1 for _ in range(2))
    ys2, h2 = gru_cuda.gru_layer(xp, w, b_ih, b_hh)
    walk = gru_cuda._walk((xp.view(T, B, D, 3 * H) + b_ih), D).contiguous()
    ys1, h1 = gru_cuda.run_layer(walk, w, b_hh)
    torch.testing.assert_close(gru_cuda._unwalk(ys1), ys2, atol=1e-6, rtol=0)
    torch.testing.assert_close(h1, h2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "shape"])
def test_run_layer_rejects_what_the_kernels_do_not_take(bad):
    xp, w, b = (torch.from_numpy(a) for a in _inputs(3, 2, 2, 4, seed=0))
    if bad == "float64":
        xp, err = xp.double(), TypeError
    elif bad == "non_contiguous":
        xp, err = torch.cat([xp, xp], dim=-1)[..., ::2], ValueError
    else:
        w, err = w[:, :, :-3].contiguous(), ValueError
    with pytest.raises(err):
        gru_cuda.run_layer(xp, w, b)
    assert sum(gru_cuda.launches.values()) == 0   # CPU tensors: the plain version only
