"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, at the serving and training paths' shapes. Marked `gpu`: they skip
without a CUDA GPU. This file imports no JAX, so it runs on a machine that
has none: `python -m pytest --noconftest tests/test_torch_cuda_kernels.py`.

Tolerances: the kernels use plain float32 FMA in another order than
cuBLAS. The mel power is a sum of ~2000 products per bin, which in float32
differ by ~1e-5 relative even in the quiet bands, so each value is held
within 1e-4 of its own magnitude, plus 1e-7 of the largest value for values
near zero; the GRU forward within 1e-4 absolute after 34 steps (h in
[-1, 1]); the backward's dxp within 1e-4 absolute (a 34-step chain of
sums of 3H products), and dW_hh and the bias gradients within 1e-4 of
each one's largest value (sums of T*B products in another order).
"""

import copy

import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.models.layers import GRU
from speech2affective_gestures_torch.ops import dsp, gru_cuda, mel_cuda


def _frames(rows, n_fft=2048, seed=0):
    """Hann-windowed frames of a chirp with noise, the kernel's real input."""
    rng = np.random.default_rng(seed)
    n = (rows + 8) * 512
    t = np.arange(n) / 16000
    y = (0.4 * np.sin(2 * np.pi * (200 + 40 * np.sin(t)) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return dsp.windowed_frames(torch.from_numpy(y), n_fft).reshape(-1, n_fft)[:rows]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n_fft", [(7, 2048), (568, 2048), (2272, 2048), (1876, 1024)])
def test_mel_kernel_against_plain(cuda, rows, n_fft):
    """The service's MFCC shapes (n_fft 2048), and the corpus build's
    log-mel of one 60 s video (`ted_db.extract_mel_spectrogram`: n_fft
    1024, 513 bins in 17 chunks, 1876 frames)."""
    frames = _frames(rows, n_fft).contiguous().to(cuda)
    before = mel_cuda.launches
    got = mel_cuda.mel_power(frames)
    torch.cuda.synchronize()
    want = mel_cuda.mel_power_plain(frames)
    assert mel_cuda.launches == before + 1
    diff = (got - want).abs()
    allowed = 1e-4 * want.abs() + 1e-7 * want.abs().max()
    assert bool((diff <= allowed).all()), (diff / want.abs()).amax(dim=0)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2, 3, 16])
@pytest.mark.parametrize("cin", [88, 600])
def test_gru_kernel_against_plain(cuda, batch, cin):
    """The serving shapes: T=34, H=300, both directions; layer 0 takes 88
    input features (8 + 32 + 32 + 16), later layers 600."""
    g = torch.Generator().manual_seed(batch * 1000 + cin)
    T, H, D = 34, 300, 2
    x = torch.randn(T, batch, cin, generator=g)
    w_ih = torch.empty(D * 3 * H, cin).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    w_hh = torch.empty(D, H, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    b_ih = torch.empty(D, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    b_hh = torch.empty(D, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    args = [t.to(cuda) for t in (x @ w_ih.t(), w_hh, b_ih, b_hh)]
    before = gru_cuda.launches
    ys, h_last = gru_cuda.gru_layer(*args)
    torch.cuda.synchronize()
    want_ys, want_h = gru_cuda.gru_layer_plain(*args)
    assert gru_cuda.launches == before + 1
    assert (ys - want_ys).abs().max().item() <= 1e-4
    assert (h_last - want_h).abs().max().item() <= 1e-4


def _layer_inputs(T, B, cin, H, D, seed, device):
    g = torch.Generator().manual_seed(seed)
    bound = H ** -0.5
    x = torch.randn(T, B, cin, generator=g)
    w_ih = torch.empty(D * 3 * H, cin).uniform_(-bound, bound, generator=g)
    w_hh = torch.empty(D, H, 3 * H).uniform_(-bound, bound, generator=g)
    b_ih = torch.empty(D, 3 * H).uniform_(-bound, bound, generator=g)
    b_hh = torch.empty(D, 3 * H).uniform_(-bound, bound, generator=g)
    dys = torch.randn(T, B, D * H, generator=g)
    return [t.to(device).contiguous() for t in (x @ w_ih.t(), w_hh, b_ih, b_hh, dys)]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 5, 512])
@pytest.mark.parametrize("H,cin", [(300, 88), (300, 600), (64, 8), (64, 128)])
def test_gru_bwd_kernels_against_plain(cuda, batch, H, cin):
    """The training shapes: T=34, both directions; the generator's GRU
    (H=300, layer 0 takes 88 features, later layers 600) and the
    discriminator's (H=64, 8 and 128)."""
    T, D = 34, 2
    xp, w_hh, b_ih, b_hh, dys = _layer_inputs(T, batch, cin, H, D,
                                              batch * 7 + H + cin, cuda)
    ys, _ = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)
    before = (gru_cuda.bwd_launches, gru_cuda.dw_launches)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys)
    dw, db = gru_cuda.gru_dw(ys, dxp, gn, D)
    torch.cuda.synchronize()
    assert (gru_cuda.bwd_launches, gru_cuda.dw_launches) == (before[0] + 1, before[1] + 1)
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys)
    assert (dxp - want_dxp).abs().max().item() <= 1e-4
    assert (gn - want_gn).abs().max().item() <= 1e-4
    # the reduction kernel on the plain recurrence's output, alone
    dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
    assert _rel(dw, want_dw) <= 1e-4
    assert _rel(db, want_db) <= 1e-4
    # deterministic: a second run gives the same bits
    dw2, db2 = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.gpu
@pytest.mark.parametrize("H,cin,batch", [(300, 600, 16), (64, 8, 5)])
def test_gru_function_against_autograd_of_plain(cuda, H, cin, batch):
    T, D = 34, 2
    xp, w_hh, b_ih, b_hh, dys = _layer_inputs(T, batch, cin, H, D, 11, cuda)
    dh = dys[0].view(batch, D, H).transpose(0, 1).contiguous()
    leaves = [t.clone().requires_grad_() for t in (xp, w_hh, b_ih, b_hh)]
    ys, h_last = gru_cuda.GRULayerFunction.apply(*leaves)
    got = torch.autograd.grad((ys * dys).sum() + (h_last * dh).sum(), leaves)
    ys, h_last = gru_cuda.gru_layer_plain(*leaves)
    want = torch.autograd.grad((ys * dys).sum() + (h_last * dh).sum(), leaves)
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) <= 1e-4


@pytest.mark.gpu
def test_gru_module_gradients_on_card_match_cpu(cuda):
    """The gradient of a GRU on the card reaches its input and every
    parameter, equal to the CPU plain path's within 1e-4 of each largest
    value."""
    torch.manual_seed(3)
    gru = GRU(24, 40, num_layers=2, bidirectional=True)
    x = torch.randn(6, 34, 24)
    grads = {}
    for dev in ("cpu", cuda):
        m = copy.deepcopy(gru).to(dev)
        xi = x.to(dev).detach().requires_grad_()
        out, h_last = m(xi)
        (out.sum() + 0.5 * h_last.sum()).backward()
        grads[str(dev)] = {"x": xi.grad.cpu(),
                           **{n: p.grad.cpu() for n, p in m.named_parameters()}}
    cpu, card = grads["cpu"], grads[str(cuda)]
    assert set(card) == set(cpu) and all(v is not None for v in card.values())
    for name in cpu:
        assert _rel(card[name], cpu[name]) <= 1e-4, name
