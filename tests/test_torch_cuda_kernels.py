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
each one's largest value (sums of T*B products in another order). The
same for the walk-layout (`run_layer`) entry points; their forward against
the model layout's kernel within 1e-6, since it is the same arithmetic.
The mel kernel is also held to a float64 oracle (`torch.fft.rfft` of the
frames in float64, its power, the float32 filterbank's values in a float64
product): its worst relative error over the bands must not exceed the
plain dense products'. Kernels without atomics give the same bits twice.
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


def _band_errors(got, oracle):
    """Each band's worst relative error over the rows."""
    return ((got.double() - oracle).abs() / oracle.abs()).amax(dim=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n_fft", [(568, 2048), (2272, 2048), (601, 2048), (1876, 1024)])
def test_mel_kernel_against_float64_oracle(cuda, rows, n_fft):
    """chip_smoke.py's MEL_SHAPES: the kernel's worst band lies no farther
    from the float64 rfft than the plain version's; a second run gives the
    same bits."""
    frames = _frames(rows, n_fft).contiguous().to(cuda)
    got = mel_cuda.mel_power(frames)
    again = mel_cuda.mel_power(frames)
    plain = mel_cuda.mel_power_plain(frames)
    spec = torch.fft.rfft(frames.double(), dim=-1)
    mel = torch.from_numpy(mel_cuda.dft_constants(16000, n_fft, 128)[2]).to(cuda).double()
    oracle = (spec.real ** 2 + spec.imag ** 2) @ mel
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    kernel_err, plain_err = _band_errors(got, oracle), _band_errors(plain, oracle)
    assert kernel_err.max().item() <= plain_err.max().item(), (kernel_err, plain_err)


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft", [512, 4096])
def test_mel_kernel_other_sizes(cuda, n_fft):
    """The smallest and largest n_fft the kernel takes (1 and 8 rows a block)."""
    frames = _frames(37, n_fft).contiguous().to(cuda)
    got = mel_cuda.mel_power(frames)
    want = mel_cuda.mel_power_plain(frames)
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-7 * want.abs().max()).all())


@pytest.mark.gpu
def test_mel_kernel_refuses_other_n_fft(cuda):
    with pytest.raises(ValueError):
        mel_cuda.mel_power(torch.zeros(4, 1536, device=cuda))


def _gru_args(T, B, cin, H, D, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, cin, generator=g)
    w_ih = torch.empty(D * 3 * H, cin).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    w_hh = torch.empty(D, H, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    b_ih = torch.empty(D, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    b_hh = torch.empty(D, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=g)
    return [t.to(device).contiguous() for t in (x @ w_ih.t(), w_hh, b_ih, b_hh)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2, 3, 16])
@pytest.mark.parametrize("cin", [88, 600])
def test_gru_kernel_against_plain(cuda, batch, cin):
    """The serving shapes: T=34, H=300, both directions; layer 0 takes 88
    input features (8 + 32 + 32 + 16), later layers 600."""
    args = _gru_args(34, batch, cin, 300, 2, batch * 1000 + cin, cuda)
    before = gru_cuda.launches
    ys, h_last = gru_cuda.gru_layer(*args)
    torch.cuda.synchronize()
    want_ys, want_h = gru_cuda.gru_layer_plain(*args)
    assert gru_cuda.launches == before + 1
    assert (ys - want_ys).abs().max().item() <= 1e-4
    assert (h_last - want_h).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("H,cin,batch", [(300, 600, 1), (300, 600, 3), (300, 88, 16),
                                         (300, 600, 258), (300, 600, 512),
                                         (64, 8, 1), (64, 8, 258), (64, 128, 512),
                                         (64, 128, 3), (40, 24, 6)])
def test_gru_kernel_plans_against_plain(cuda, H, cin, batch):
    """Each launch plan at the main paths' shapes (the generator's H 300,
    the discriminator's H 64; batch 1 serving, 258 scoring, 512 training)
    and a ragged one: within 1e-4 of the plain loop, the same bits twice,
    and one direction alone."""
    for D in (2, 1):
        args = _gru_args(34, batch, cin, H, D, batch + H + cin + D, cuda)
        ys, h_last = gru_cuda.gru_layer_forward(*args)
        ys2, h_last2 = gru_cuda.gru_layer_forward(*args)
        torch.cuda.synchronize()
        want_ys, want_h = gru_cuda.gru_layer_plain(*args)
        assert torch.equal(ys, ys2) and torch.equal(h_last, h_last2)
        assert (ys - want_ys).abs().max().item() <= 1e-4
        assert (h_last - want_h).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_gru_kernel_refuses_an_unschedulable_shape(cuda):
    """H 600: W_hh does not fit in the registers of a cluster of 8 blocks
    (the kernel holds H <= 320); the wrapper raises rather than run anything
    else."""
    args = _gru_args(4, 2, 8, 600, 2, 0, cuda)
    before = gru_cuda.launches
    with pytest.raises(ValueError):
        gru_cuda.gru_layer_forward(*args)
    assert gru_cuda.launches == before


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


def _walk_inputs(T, B, cin, H, D, seed, device):
    """`run_layer`'s inputs from the model layout's: xp with b_ih added,
    direction 1 time-reversed (the walk layout), and dys in that layout."""
    xp, w_hh, b_ih, b_hh, _ = _layer_inputs(T, B, cin, H, D, seed, device)
    xw = gru_cuda._walk(xp.view(T, B, D, 3 * H) + b_ih, D).contiguous()
    dys = torch.randn(T, D, B, H, generator=torch.Generator().manual_seed(seed)).to(device)
    return xw, w_hh, b_hh, dys, (xp, b_ih)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 512])
@pytest.mark.parametrize("H,cin", [(300, 600), (64, 128)])
def test_gru_v1_kernels_against_plain(cuda, batch, H, cin):
    """The three walk-layout entry points (`run_layer`'s forward, backward
    recurrence and dW reduction) against their plain versions, at the
    training batch and at a batch that is no tile multiple; the forward
    also against the model-layout kernel on the same function."""
    T, D = 34, 2
    xp, w_hh, b_hh, dys, (xp2, b_ih) = _walk_inputs(T, batch, cin, H, D, batch + H, cuda)
    before = (gru_cuda.v1_launches, gru_cuda.v1_bwd_launches, gru_cuda.v1_dw_launches)
    ys = gru_cuda.run_layer_forward(xp, w_hh, b_hh)
    want_ys = gru_cuda.run_layer_plain(xp, w_hh, b_hh)[0]
    dxp, gn = gru_cuda.run_layer_bwd_recurrence(xp, w_hh, b_hh, want_ys, dys)
    want_dxp, want_gn = gru_cuda.run_layer_bwd_recurrence_plain(xp, w_hh, b_hh, want_ys, dys)
    dw, db = gru_cuda.run_layer_dw(want_ys, want_dxp, want_gn)
    want_dw, want_db = gru_cuda.run_layer_dw_plain(want_ys, want_dxp, want_gn)
    torch.cuda.synchronize()
    assert (gru_cuda.v1_launches, gru_cuda.v1_bwd_launches, gru_cuda.v1_dw_launches) == \
        tuple(b + 1 for b in before)
    assert (ys - want_ys).abs().max().item() <= 1e-4
    model_ys, _ = gru_cuda.gru_layer_forward(xp2, w_hh, b_ih, b_hh)
    assert (gru_cuda._unwalk(ys) - model_ys).abs().max().item() <= 1e-6
    assert (dxp - want_dxp).abs().max().item() <= 1e-4
    assert (gn - want_gn).abs().max().item() <= 1e-4
    assert _rel(dw, want_dw) <= 1e-4 and _rel(db, want_db) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 512])
def test_gru_v1_forward_against_model_layout(cuda, batch):
    """The walk layout's forward at the serving and training batch: within
    1e-4 of its plain loop and 1e-6 of the model layout's kernel."""
    T, H, D = 34, 300, 2
    xp, w_hh, b_hh, _, (xp2, b_ih) = _walk_inputs(T, batch, 600, H, D, 3 + batch, cuda)
    ys = gru_cuda.run_layer_forward(xp, w_hh, b_hh)
    torch.cuda.synchronize()
    assert (ys - gru_cuda.run_layer_plain(xp, w_hh, b_hh)[0]).abs().max().item() <= 1e-4
    model_ys, _ = gru_cuda.gru_layer_forward(xp2, w_hh, b_ih, b_hh)
    assert (gru_cuda._unwalk(ys) - model_ys).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("H,cin,batch", [(300, 600, 16), (64, 8, 5)])
def test_gru_v1_function_against_autograd_of_plain(cuda, H, cin, batch):
    """`run_layer` on the card (`GRULayerV1Function`) against autograd
    through the plain loop, with a loss on ys and on h_last (= ys[-1])."""
    T, D = 34, 2
    xp, w_hh, b_hh, dys, _ = _walk_inputs(T, batch, cin, H, D, 13, cuda)
    grads = []
    for layer in (gru_cuda.run_layer, gru_cuda.run_layer_plain):
        leaves = [t.clone().requires_grad_() for t in (xp, w_hh, b_hh)]
        ys, h_last = layer(*leaves)
        grads.append(torch.autograd.grad((ys * dys).sum() + h_last.sin().sum(), leaves))
    (got_x, *got_w), (want_x, *want_w) = grads
    assert (got_x - want_x).abs().max().item() <= 1e-4
    for g, w in zip(got_w, want_w):
        assert _rel(g, w) <= 1e-4
