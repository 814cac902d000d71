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
hidden sizes past 320 run the kernels' L2 tier; at bf16 the forward's and
the recurrence's tensor tiers (where their plans take them, and by their
own plans elsewhere) and dW's tensor-core product are held to the same
bf16 tolerances. The
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
    before = mel_cuda.launches[("mel_fft", "float32")]
    got = mel_cuda.mel_power(frames)
    torch.cuda.synchronize()
    want = mel_cuda.mel_power_plain(frames)
    assert mel_cuda.launches[("mel_fft", "float32")] == before + 1
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
@pytest.mark.parametrize("n_fft,n_mels", [(1000, 128), (1536, 128), (256, 128), (8192, 128),
                                          (2048, 64), (1000, 40), (400, 80), (480, 40),
                                          (998, 128), (882, 80)])
def test_mel_kernel_every_shape(cuda, n_fft, n_mels):
    """Every n_fft and band count: the FFT tier's mixed-radix kernel (n_fft
    400, 480, 1000, 1536), its power-of-two kernel at 256 and at other band
    counts, the DFT tier for the n_fft the FFT tier does not take (8192,
    998 and 882, prime factors above 5); each value within
    1e-4 of its own magnitude (plus 1e-7 of the largest) of the plain
    dense products; against the float64 oracle the FFT tier's worst band no
    farther than theirs, the DFT tier's values within the same tolerance;
    the same bits twice."""
    frames = _frames(37, n_fft).contiguous().to(cuda)
    tier = mel_cuda.mel_plan(37, n_fft, n_mels).tier
    key = (f"mel_{tier}", "float32")
    before = mel_cuda.launches[key]
    got = mel_cuda.mel_power(frames, n_mels=n_mels)
    again = mel_cuda.mel_power(frames, n_mels=n_mels)
    torch.cuda.synchronize()
    assert mel_cuda.launches[key] == before + 2 and torch.equal(got, again)
    want = mel_cuda.mel_power_plain(frames, n_mels=n_mels)
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-7 * want.abs().max()).all())
    spec = torch.fft.rfft(frames.double(), dim=-1)
    mel = torch.from_numpy(mel_cuda.dft_constants(16000, n_fft, n_mels)[2]).to(cuda).double()
    oracle = (spec.real ** 2 + spec.imag ** 2) @ mel
    keep = oracle.abs().amax(dim=0) > 0   # bands with no bin are zero in all three
    kernel_err = _band_errors(got, oracle)[keep].max().item()
    plain_err = _band_errors(want, oracle)[keep].max().item()
    if tier == "fft":
        assert kernel_err <= plain_err, (kernel_err, plain_err)
    else:   # a dense sum of n_fft products, as the plain version's
        off = (got.double() - oracle).abs()
        assert bool((off <= 1e-4 * oracle.abs() + 1e-7 * oracle.abs().max()).all()), \
            (kernel_err, plain_err)


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
    before = gru_cuda.launches[("gru_fwd", "float32")]
    ys, h_last = gru_cuda.gru_layer(*args)
    torch.cuda.synchronize()
    want_ys, want_h = gru_cuda.gru_layer_plain(*args)
    assert gru_cuda.launches[("gru_fwd", "float32")] == before + 1
    assert (ys - want_ys).abs().max().item() <= 1e-4
    assert (h_last - want_h).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("H,cin,batch", [(300, 600, 1), (300, 600, 3), (300, 88, 16),
                                         (300, 600, 258), (300, 600, 512),
                                         (64, 8, 1), (64, 8, 258), (64, 128, 512),
                                         (64, 128, 3), (40, 24, 6),
                                         (256, 64, 64), (256, 256, 64)])
def test_gru_kernel_plans_against_plain(cuda, H, cin, batch):
    """Each launch plan at the main paths' shapes (the generator's H 300,
    the discriminator's H 64; batch 1 serving, 258 scoring, 512 training;
    the embedding net's context encoder, H 256 at batch 64, one direction)
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
@pytest.mark.parametrize("H", [321, 600, 1024])
def test_gru_kernel_refuses_an_unschedulable_shape(cuda, H):
    """Past H 320 W_hh no longer fits in a cluster's registers; the plan
    takes the L2 tier and the kernel runs (no shape it refuses remains
    below what a block's shared memory holds): within 1e-4 of the plain
    loop, the same bits twice, and with hp saved the same ys."""
    for batch in (5, 512):
        args = _gru_args(34, batch, 64, H, 2, H + batch, cuda)
        before = gru_cuda.launches[("gru_fwd", "float32")]
        ys, h_last = gru_cuda.gru_layer_forward(*args)
        ys2, h_last2, hp = gru_cuda.gru_layer_forward(*args, save_hp=True)
        torch.cuda.synchronize()
        assert gru_cuda.launches[("gru_fwd", "float32")] == before + 2
        assert gru_cuda._device_plan(cuda, batch, H, 2).tier == "l2"
        want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(*args, save_hp=True)
        assert torch.equal(ys, ys2) and torch.equal(h_last, h_last2)
        assert (ys - want_ys).abs().max().item() <= 1e-4
        assert (h_last - want_h).abs().max().item() <= 1e-4
        assert (hp - want_hp).abs().max().item() <= 1e-4


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
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _counts(*kernels, dtype="float32"):
    return tuple(gru_cuda.launches[(k, dtype)] for k in kernels)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 5, 512])
@pytest.mark.parametrize("H,cin", [(300, 88), (300, 600), (64, 8), (64, 128),
                                   (321, 64), (600, 64), (1024, 64)])
def test_gru_bwd_kernels_against_plain(cuda, batch, H, cin):
    """The training shapes: T=34, both directions; the generator's GRU
    (H=300, layer 0 takes 88 features, later layers 600), the
    discriminator's (H=64, 8 and 128), and the L2 tier's H 321, 600 and
    1024. The recurrence takes the forward's saved hp; both kernels give
    the same bits twice; the forward writes the same ys with hp as
    without."""
    T, D = 34, 2
    xp, w_hh, b_ih, b_hh, dys = _layer_inputs(T, batch, cin, H, D,
                                              batch * 7 + H + cin, cuda)
    ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    assert torch.equal(ys, gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0])
    before = _counts("gru_bwd", "gru_dw")
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    dw, db = gru_cuda.gru_dw(ys, dxp, gn, D)
    torch.cuda.synchronize()
    assert _counts("gru_bwd", "gru_dw") == tuple(b + 1 for b in before)
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys)
    assert (dxp - want_dxp).abs().max().item() <= 1e-4
    assert (gn - want_gn).abs().max().item() <= 1e-4
    dxp2, gn2 = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    assert torch.equal(dxp, dxp2) and torch.equal(gn, gn2)
    # the reduction kernel on the plain recurrence's output, alone
    dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
    assert _rel(dw, want_dw) <= 1e-4
    assert _rel(db, want_db) <= 1e-4
    # deterministic: a second run gives the same bits
    dw2, db2 = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.gpu
def test_gru_bwd_kernel_needs_the_saved_hp(cuda):
    """The recurrence kernel takes the forward's hp; without it the wrapper
    raises rather than recompute anything."""
    xp, w_hh, b_ih, b_hh, dys = _layer_inputs(4, 2, 8, 64, 2, 0, cuda)
    ys, _ = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)
    before = _counts("gru_bwd")
    with pytest.raises(ValueError):
        gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys)
    assert _counts("gru_bwd") == before


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
@pytest.mark.parametrize("cin", [64, 256])
def test_gru_backward_at_h256_one_direction(cuda, cin):
    """The context encoder's layers (T 34, B 64, H 256, D 1; 64 inputs,
    then 256): `GRULayerFunction`'s backward, the recurrence and dW kernels
    one launch each, against autograd through `gru_layer_plain`: dxp within
    1e-4 absolute, dW_hh and the bias gradients within 1e-4 of each largest
    value."""
    T, B, H, D = 34, 64, 256, 1
    xp, w_hh, b_ih, b_hh, dys = _layer_inputs(T, B, cin, H, D, cin, cuda)
    dh = torch.randn(D, B, H, generator=torch.Generator().manual_seed(cin)).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (xp, w_hh, b_ih, b_hh)]
    ys, h_last = gru_cuda.GRULayerFunction.apply(*leaves)
    before = _counts("gru_bwd", "gru_dw")
    got = torch.autograd.grad((ys, h_last), leaves, (dys, dh))
    torch.cuda.synchronize()
    assert _counts("gru_bwd", "gru_dw") == tuple(b + 1 for b in before)
    want_ys, want_h = gru_cuda.gru_layer_plain(*leaves)
    want = torch.autograd.grad((want_ys, want_h), leaves, (dys, dh))
    assert (ys - want_ys).abs().max().item() <= 1e-4
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


@pytest.mark.gpu
def test_column_split_gru_layer_on_two_ranks(cuda, tmp_path):
    """Two gloo ranks on the card as a 1 x 2 grid (the model axis alone,
    `parallel.mesh.make_mesh_2d(1, 2)`): the generator's first bi-GRU
    layer (input 88, H 300, B 64) with its gate weights split by column at
    tp_min_cols 900 (`shard_params_2d`) and gathered whole before the
    kernels run. The output and h_last (in [-1, 1]) within 1e-5 absolute
    of the unsharded layer's on the same card, the input's gradient and
    the slices' gradients, gathered, within 1e-5 of each one's largest
    value; each rank launched the forward, the recurrence and dW."""
    import _mesh_2d_worker as W
    from speech2affective_gestures_torch.parallel import mesh as P

    card = torch.device("cuda", torch.cuda.current_device())
    P.launch(W.split_gru_rank, 2, "gloo", devices=[card, card], args=(tmp_path,), timeout=600)
    got = [torch.load(tmp_path / f"split_gru_rank{r}.pt") for r in range(2)]
    want = W.split_gru(None, card)
    for r in got:
        assert all(r["launches"].get(k, 0) > 0 for k in ("gru_fwd", "gru_bwd", "gru_dw"))
        for key in ("out", "h_last"):
            assert (r[key] - want[key]).abs().max().item() <= 1e-5, key
        assert _rel(r["dx"], want["dx"]) <= 1e-5
    for name, grad in want["grads"].items():
        split = name.startswith("weight_")
        whole = torch.cat([r["grads"][name] for r in got]) if split else got[0]["grads"][name]
        assert whole.shape == grad.shape, name
        assert _rel(whole, grad) <= 1e-5, name


def _walk_inputs(T, B, cin, H, D, seed, device):
    """`run_layer`'s inputs from the model layout's: xp with b_ih added,
    direction 1 time-reversed (the walk layout), and dys in that layout."""
    xp, w_hh, b_ih, b_hh, _ = _layer_inputs(T, B, cin, H, D, seed, device)
    xw = gru_cuda._walk(xp.view(T, B, D, 3 * H) + b_ih, D).contiguous()
    dys = torch.randn(T, D, B, H, generator=torch.Generator().manual_seed(seed)).to(device)
    return xw, w_hh, b_hh, dys, (xp, b_ih)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 512])
@pytest.mark.parametrize("H,cin", [(300, 600), (64, 128), (600, 64)])
def test_gru_v1_kernels_against_plain(cuda, batch, H, cin):
    """The three walk-layout entry points (`run_layer`'s forward, backward
    recurrence and dW reduction) against their plain versions, at the
    training batch and at a batch that is no tile multiple; the forward
    also against the model-layout kernel on the same function."""
    T, D = 34, 2
    xp, w_hh, b_hh, dys, (xp2, b_ih) = _walk_inputs(T, batch, cin, H, D, batch + H, cuda)
    before = _counts("gru_fwd_v1", "gru_bwd_v1", "gru_dw_v1")
    ys, hp = gru_cuda.run_layer_forward(xp, w_hh, b_hh, save_hp=True)
    want_ys = gru_cuda.run_layer_plain(xp, w_hh, b_hh)[0]
    dxp, gn = gru_cuda.run_layer_bwd_recurrence(xp, w_hh, b_hh, ys, dys, hp)
    want_dxp, want_gn = gru_cuda.run_layer_bwd_recurrence_plain(xp, w_hh, b_hh, ys, dys)
    dw, db = gru_cuda.run_layer_dw(want_ys, want_dxp, want_gn)
    want_dw, want_db = gru_cuda.run_layer_dw_plain(want_ys, want_dxp, want_gn)
    torch.cuda.synchronize()
    assert _counts("gru_fwd_v1", "gru_bwd_v1", "gru_dw_v1") == tuple(b + 1 for b in before)
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


# ------------------------------------------------------------------ bf16
# The bf16 instances against their plain bf16 twins (`gru_cuda`'s plain
# versions at the same rounding points, fed the same inputs): ys and h_last
# within BF16_TOL absolute (the twin's float32 sums run in another order, so
# a rounding to bf16 may land one ulp (2^-8 at |h| < 1) apart and carry
# through the later steps); dxp and gn within BF16_TOL of each one's
# largest value; dW_hh and db_hh from the same bf16 inputs within 1e-4 of
# each one's largest value (exact products, float32 sums in another
# order). bf16 against float32 on the same function within 0.05.
BF16_TOL = 2e-2


def _bf16(*tensors):
    return [t.to(torch.bfloat16).contiguous() for t in tensors]


def _tiers(*keys):
    return tuple(gru_cuda.tier_launches[k] for k in keys)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 5, 258, 512])
@pytest.mark.parametrize("H,cin", [(300, 600), (64, 128), (40, 128), (301, 600), (600, 64)])
def test_gru_bf16_kernels_against_plain(cuda, batch, H, cin):
    """The bf16 forward and recurrence (each in the tier its plan names:
    the tensor tiers at H <= 320 where the batch is large enough,
    `gru_cuda.fwd_tier` and `bwd_tier`, the register tier below; the L2
    tier at 600) and dW (the tensor cores) in the model layout at the
    serving, scoring and training batches and a tile of 5 rows (a partial
    m16 tile), H 40 and the odd H 301: each launch counted under bfloat16
    (the forward and the recurrence under their plans' tiers) and none
    under float32, against the bf16 twins, against float32, and the same
    bits twice; where the forward's plan takes the register tier, its
    tensor tier by its own plan as well."""
    T, D = 34, 2
    f32 = _layer_inputs(T, batch, cin, H, D, batch + 3 * H, cuda)
    xp, w_hh, b_ih, b_hh, dys = _bf16(*f32)
    tier = gru_cuda._device_plan(cuda, batch, H, D, torch.bfloat16).tier
    assert tier == gru_cuda.fwd_tier(batch, H, torch.bfloat16)
    rec_tier = gru_cuda._device_bwd_plan(cuda, batch, H, D, torch.bfloat16).tier
    assert rec_tier == gru_cuda.bwd_tier(batch, H, torch.bfloat16)
    keys = (("gru_fwd", "bfloat16", tier), ("gru_bwd", "bfloat16", rec_tier),
            ("gru_dw", "bfloat16", "tensor"))
    before = (_counts("gru_fwd", "gru_bwd", "gru_dw", dtype="bfloat16"),
              _counts("gru_fwd", "gru_bwd", "gru_dw"), _tiers(*keys))
    ys, h_last, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    dw, db = gru_cuda.gru_dw(ys, dxp, gn, D)
    torch.cuda.synchronize()
    assert _counts("gru_fwd", "gru_bwd", "gru_dw", dtype="bfloat16") == \
        tuple(b + 1 for b in before[0])
    assert _counts("gru_fwd", "gru_bwd", "gru_dw") == before[1]
    assert _tiers(*keys) == tuple(b + 1 for b in before[2])
    assert ys.dtype == h_last.dtype == dxp.dtype == gn.dtype == torch.bfloat16
    assert hp.dtype == dw.dtype == db.dtype == torch.float32
    want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=True)
    assert (ys.float() - want_ys.float()).abs().max().item() <= BF16_TOL
    assert (h_last.float() - want_h.float()).abs().max().item() <= BF16_TOL
    assert _rel(hp, want_hp) <= BF16_TOL
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    assert _rel(dxp, want_dxp) <= BF16_TOL and _rel(gn, want_gn) <= BF16_TOL
    dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
    assert _rel(dw, want_dw) <= 1e-4 and _rel(db, want_db) <= 1e-4
    dw2, db2 = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    ys2 = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0]
    dxp2, gn2 = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    assert torch.equal(ys, ys2) and torch.equal(dxp, dxp2) and torch.equal(gn, gn2)
    ys32 = gru_cuda.gru_layer_forward(*f32[:4])[0]
    assert (ys.float() - ys32).abs().max().item() <= 0.05
    if tier == "registers":
        # the tensor tier at this shape too, by its own plan (partial m16
        # tiles at B 1 and 5, H 64 and 40)
        plan = gru_cuda.fwd_plan(batch, H, D, gru_cuda.max_clusters(
            cuda, H, "fwd", torch.bfloat16, "tensor"), "tensor")
        tys, th, thp = gru_cuda._forward_launch(xp, w_hh, b_ih, b_hh, plan, True)
        assert (tys.float() - want_ys.float()).abs().max().item() <= BF16_TOL
        assert (th.float() - want_h.float()).abs().max().item() <= BF16_TOL
        assert _rel(thp, want_hp) <= BF16_TOL
        assert torch.equal(tys, gru_cuda._forward_launch(xp, w_hh, b_ih, b_hh, plan, False)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("batch", [5, 258, 512])
@pytest.mark.parametrize("H,cin", [(300, 600), (64, 128), (40, 128), (301, 600)])
def test_gru_bwd_bf16_tensor_tier_against_plain(cuda, walk, batch, H, cin):
    """The bf16 recurrence's tensor tier (g split into bf16 hi + lo, the
    product's K split over the cluster), launched by its own plan whatever
    tier the default plan names, in the model and the walk layout, against
    the plain bf16 recurrence on the forward's hp within BF16_TOL of the
    largest value, counted under its tier, the same bits twice; B 5 a
    ragged m16 tile, H 64 and 40 one or two blocks, the odd H 301."""
    T, D = 34, 2
    bf16 = torch.bfloat16
    if walk:
        xp, w_hh, b_hh, dys, _ = _walk_inputs(T, batch, cin, H, D, batch + H + 2, cuda)
        xp, w_hh, b_hh, dys = _bf16(xp, w_hh, b_hh, dys)
        ys, hp = gru_cuda.run_layer_forward(xp, w_hh, b_hh, save_hp=True)
        b_in = gru_cuda.kernel_biases(None, b_hh, H)[0]
        want = gru_cuda.run_layer_bwd_recurrence_plain(xp, w_hh, b_hh, ys, dys, hp)
    else:
        xp, w_hh, b_ih, b_hh, dys = _bf16(*_layer_inputs(T, batch, cin, H, D, batch + 5, cuda))
        ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
        b_in = gru_cuda.kernel_biases(b_ih, b_hh, H)[0]
        want = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    plan = gru_cuda.bwd_plan(batch, H, D, gru_cuda.max_clusters(cuda, H, "bwd", bf16, "tensor"),
                             "tensor")
    key = ("gru_bwd_v1" if walk else "gru_bwd", "bfloat16", "tensor")
    before = _tiers(key)
    dxp, gn = gru_cuda._recurrence_launch(walk, xp, w_hh, b_in, hp, ys, dys, plan)
    dxp2, gn2 = gru_cuda._recurrence_launch(walk, xp, w_hh, b_in, hp, ys, dys, plan)
    torch.cuda.synchronize()
    assert _tiers(key) == (before[0] + 2,)
    assert dxp.dtype == gn.dtype == bf16
    assert _rel(dxp, want[0]) <= BF16_TOL and _rel(gn, want[1]) <= BF16_TOL
    assert torch.equal(dxp, dxp2) and torch.equal(gn, gn2)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 512])
@pytest.mark.parametrize("H,cin", [(300, 600), (64, 128), (40, 128), (301, 600), (600, 64)])
def test_gru_v1_bf16_kernels_against_plain(cuda, batch, H, cin):
    """The walk layout's bf16 instances (`run_layer`; the forward's tensor
    tier at H <= 320, B 5 a partial m16 tile, the odd H 301) against their
    bf16 twins, counted under bfloat16."""
    T, D = 34, 2
    xp, w_hh, b_hh, dys, _ = _walk_inputs(T, batch, cin, H, D, batch + H + 1, cuda)
    xp, w_hh, b_hh, dys = _bf16(xp, w_hh, b_hh, dys)
    before = _counts("gru_fwd_v1", "gru_bwd_v1", "gru_dw_v1", dtype="bfloat16")
    ys, hp = gru_cuda.run_layer_forward(xp, w_hh, b_hh, save_hp=True)
    dxp, gn = gru_cuda.run_layer_bwd_recurrence(xp, w_hh, b_hh, ys, dys, hp)
    want_ys = gru_cuda.run_layer_plain(xp, w_hh, b_hh)[0]
    want_dxp, want_gn = gru_cuda.run_layer_bwd_recurrence_plain(xp, w_hh, b_hh, ys, dys, hp)
    dw, db = gru_cuda.run_layer_dw(ys, want_dxp, want_gn)
    want_dw, want_db = gru_cuda.run_layer_dw_plain(ys, want_dxp, want_gn)
    torch.cuda.synchronize()
    assert _counts("gru_fwd_v1", "gru_bwd_v1", "gru_dw_v1", dtype="bfloat16") == \
        tuple(b + 1 for b in before)
    assert ys.dtype == dxp.dtype == torch.bfloat16
    assert (ys.float() - want_ys.float()).abs().max().item() <= BF16_TOL
    assert _rel(dxp, want_dxp) <= BF16_TOL and _rel(gn, want_gn) <= BF16_TOL
    assert _rel(dw, want_dw) <= 1e-4 and _rel(db, want_db) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("H,cin,batch", [(300, 600, 16), (64, 8, 5)])
def test_gru_bf16_function_against_cpu(cuda, H, cin, batch):
    """`GRULayerFunction` at bf16 on the card against the same Function on
    the CPU (the plain bf16 twins): values and gradients in bf16, within
    BF16_TOL of each one's largest value."""
    T, D = 34, 2
    inputs = _bf16(*_layer_inputs(T, batch, cin, H, D, 17, cuda))
    grads = []
    for dev in (cuda, "cpu"):
        leaves = [t.to(dev).clone().requires_grad_() for t in inputs[:4]]
        ys, h_last = gru_cuda.gru_layer(*leaves)
        loss = (ys.float() * inputs[4].to(dev).float()).sum() + h_last.float().sin().sum()
        grads.append([ys.cpu()] + [g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == torch.bfloat16
        assert _rel(got, want) <= BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("B", [64, 5])
@pytest.mark.parametrize("H", [300, 64, 40, 301, 302])
def test_gru_dw_bf16_copy_widths(cuda, H, B):
    """The bf16 dW product (the tensor cores) at each copy width of its
    plan: 8-byte copies (H % 4 == 0, the tensors 8-byte aligned), 4-byte
    (H % 2 == 0), plain loads (odd H), and plain loads again for views that
    start 2 bytes into an allocation; B 5 leaves a ragged last stage."""
    T, D = 34, 2
    g = torch.Generator().manual_seed(H)
    ys, gn = (torch.randn(T, B, D * H, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    dxp = torch.randn(T, B, D * 3 * H, generator=g).to(cuda, torch.bfloat16)
    want = gru_cuda.gru_dw_plain(ys, dxp, gn, D)
    got = gru_cuda.gru_dw(ys, dxp, gn, D)
    assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4
    shifted = [torch.empty(t.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(t.shape)
               for t in (ys, dxp, gn)]
    for s, t in zip(shifted, (ys, dxp, gn)):
        s.copy_(t)
    assert gru_cuda._alignment(*shifted) == 2
    got = gru_cuda.gru_dw(shifted[0], shifted[1], shifted[2], D)
    assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("H,B,tier", [(300, 512, "tensor"), (300, 258, "tensor"),
                                      (64, 512, "registers")])
def test_gru_bf16_main_shapes_take_the_tensor_cores(cuda, H, B, tier):
    """At the training and scoring shapes the bf16 forward and recurrence
    run the tiers their plans name (the tensor tiers at the generator's H
    300; the register tiers, faster there, at the discriminator's H 64) and
    dW its tensor-core kernel, in both layouts; the launches succeed and
    are counted under those tiers. float32 keeps its register tier and FMA
    dW."""
    T, D = 34, 2
    cin = 600 if H == 300 else 128
    f32 = _layer_inputs(T, B, cin, H, D, 3, cuda)
    xp, w_hh, b_ih, b_hh, dys = _bf16(*f32)
    assert gru_cuda._device_plan(cuda, B, H, D, torch.bfloat16).tier == tier
    assert gru_cuda._device_bwd_plan(cuda, B, H, D, torch.bfloat16).tier == tier
    assert gru_cuda._device_plan(cuda, B, H, D).tier == "registers"
    assert gru_cuda._device_bwd_plan(cuda, B, H, D).tier == "registers"
    keys = [("gru_fwd", "bfloat16", tier), ("gru_dw", "bfloat16", "tensor"),
            ("gru_bwd", "bfloat16", tier), ("gru_bwd_v1", "bfloat16", tier),
            ("gru_fwd_v1", "bfloat16", tier), ("gru_dw_v1", "bfloat16", "tensor"),
            ("gru_fwd", "float32", "registers"), ("gru_dw", "float32", "fma")]
    before = _tiers(*keys)
    ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    gru_cuda.gru_dw(ys, dxp, gn, D)
    xw = gru_cuda._walk(xp.view(T, B, D, 3 * H), D).contiguous()
    yw, hpw = gru_cuda.run_layer_forward(xw, w_hh, b_hh, save_hp=True)
    dyw = gru_cuda._walk(dys.view(T, B, D, H), D).contiguous()
    dxw, gnw = gru_cuda.run_layer_bwd_recurrence(xw, w_hh, b_hh, yw, dyw, hpw)
    gru_cuda.run_layer_dw(yw, dxw, gnw)
    ys32 = gru_cuda.gru_layer_forward(*f32[:4])[0]
    dxp32, gn32 = gru_cuda.gru_bwd_recurrence_plain(*f32[:4], ys32, f32[4])
    gru_cuda.gru_dw(ys32, dxp32, gn32, D)
    torch.cuda.synchronize()
    assert _tiers(*keys) == tuple(b + 1 for b in before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [256, 128])
@pytest.mark.parametrize("H,cin", [(300, 88), (300, 600), (64, 8), (64, 128)])
def test_gru_kernels_at_the_data_parallel_batches(cuda, dtype, batch, H, cin):
    """The GRU forward, recurrence and dW at a rank's batch of a
    data-parallel step at global batch 512 (256 rows on each of 2 ranks,
    128 on each of 4), the generator's and the discriminator's layers, in
    the tiers their plans name: each launch counted once, against the
    plain twins at the float32 and bf16 tolerances, the same bits twice."""
    T, D = 34, 2
    name = str(dtype)[6:]
    xp, w_hh, b_ih, b_hh, dys = (t.to(dtype).contiguous() for t in
                                 _layer_inputs(T, batch, cin, H, D, batch + H + cin, cuda))
    before = _counts("gru_fwd", "gru_bwd", "gru_dw", dtype=name)
    ys, h_last, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    dw, db = gru_cuda.gru_dw(ys, dxp, gn, D)
    torch.cuda.synchronize()
    assert _counts("gru_fwd", "gru_bwd", "gru_dw", dtype=name) == tuple(b + 1 for b in before)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
    want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=True)
    assert (ys.float() - want_ys.float()).abs().max().item() <= tol
    assert (h_last.float() - want_h.float()).abs().max().item() <= tol
    assert _rel(hp, want_hp) <= tol
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    if dtype == torch.bfloat16:
        assert _rel(dxp, want_dxp) <= tol and _rel(gn, want_gn) <= tol
    else:
        assert (dxp - want_dxp).abs().max().item() <= 1e-4
        assert (gn - want_gn).abs().max().item() <= 1e-4
    dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
    assert _rel(dw, want_dw) <= 1e-4 and _rel(db, want_db) <= 1e-4
    again = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    assert torch.equal(ys, gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0])
    assert torch.equal(dxp, gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)[0])


@pytest.mark.gpu
def test_gru_kernels_refuse_float16_and_mixed(cuda):
    xp, w_hh, b_ih, b_hh, _ = _layer_inputs(4, 2, 8, 64, 2, 0, cuda)
    with pytest.raises(TypeError):
        gru_cuda.gru_layer_forward(*(t.half() for t in (xp, w_hh, b_ih, b_hh)))
    with pytest.raises(TypeError):
        gru_cuda.gru_layer_forward(xp.to(torch.bfloat16), w_hh, b_ih, b_hh)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", [8, 128])
def test_gru_kernels_at_the_conv_discriminator_shape(cuda, dtype, cin):
    """The ConvDiscriminator's GRU (abl_aff's discriminator): its unpadded
    convs leave T 28 of the 34 frames; B 512, H 64, both directions, layer
    0 takes 8 features, later layers 128. The forward, the recurrence and
    dW against their plain versions (float32 1e-4, bf16 the bf16
    tolerances; dW 1e-4 of its largest from the same inputs), each launch
    counted once under its dtype and under T 28, the same bits twice."""
    T, B, H, D = 28, 512, 64, 2
    tensors = _layer_inputs(T, B, cin, H, D, 28 + cin, cuda)
    xp, w_hh, b_ih, b_hh, dys = _bf16(*tensors) if dtype == torch.bfloat16 else tensors
    name = gru_cuda._dtype_name(dtype)
    keys = [(k, name, T, H) for k in ("gru_fwd", "gru_bwd", "gru_dw")]
    before = tuple(gru_cuda.shape_launches[k] for k in keys)
    ys, h_last, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    dw, db = gru_cuda.gru_dw(ys, dxp, gn, D)
    torch.cuda.synchronize()
    assert tuple(gru_cuda.shape_launches[k] for k in keys) == tuple(b + 1 for b in before)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
    want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=True)
    assert (ys.float() - want_ys.float()).abs().max().item() <= tol
    assert (h_last.float() - want_h.float()).abs().max().item() <= tol
    assert _rel(hp, want_hp) <= tol
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    if dtype == torch.bfloat16:
        assert _rel(dxp, want_dxp) <= tol and _rel(gn, want_gn) <= tol
    else:
        assert (dxp - want_dxp).abs().max().item() <= tol
        assert (gn - want_gn).abs().max().item() <= tol
    dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
    assert _rel(dw, want_dw) <= 1e-4 and _rel(db, want_db) <= 1e-4
    again = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    dxp2, gn2 = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    assert torch.equal(ys, gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0])
    assert torch.equal(dxp, dxp2) and torch.equal(gn, gn2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,cin", [(300, 600), (64, 128)])
def test_gru_kernels_at_the_fused_batch(cuda, dtype, H, cin):
    """The fused GAN step (`--fused-pass`) runs the generator's GRU (H 300)
    and the discriminator's (H 64) at twice the train batch, B 1024: the
    forward, the recurrence and dW in the tiers their plans name (at bf16,
    `fwd_tier` and `bwd_tier`), each launch counted once under B 1024, H
    and that tier (`gru_cuda.batch_launches`), against their plain versions
    (float32 1e-4, bf16 the bf16 tolerances; dW 1e-4 of its largest from
    the same inputs), the same bits twice."""
    T, B, D = 34, 1024, 2
    tensors = _layer_inputs(T, B, cin, H, D, 1024 + H, cuda)
    xp, w_hh, b_ih, b_hh, dys = _bf16(*tensors) if dtype == torch.bfloat16 else tensors
    name = gru_cuda._dtype_name(dtype)
    tiers = (gru_cuda.fwd_tier(B, H, dtype), gru_cuda.bwd_tier(B, H, dtype),
             "tensor" if dtype == torch.bfloat16 else "fma")
    assert gru_cuda._device_plan(cuda, B, H, D, dtype).tier == tiers[0]
    assert gru_cuda._device_bwd_plan(cuda, B, H, D, dtype).tier == tiers[1]
    keys = [(k, name, B, H, tier) for k, tier in zip(("gru_fwd", "gru_bwd", "gru_dw"), tiers)]
    before = tuple(gru_cuda.batch_launches[k] for k in keys)
    ys, h_last, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    dw, db = gru_cuda.gru_dw(ys, dxp, gn, D)
    torch.cuda.synchronize()
    assert tuple(gru_cuda.batch_launches[k] for k in keys) == tuple(b + 1 for b in before)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
    want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=True)
    assert (ys.float() - want_ys.float()).abs().max().item() <= tol
    assert (h_last.float() - want_h.float()).abs().max().item() <= tol
    assert _rel(hp, want_hp) <= tol
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    if dtype == torch.bfloat16:
        assert _rel(dxp, want_dxp) <= tol and _rel(gn, want_gn) <= tol
    else:
        assert (dxp - want_dxp).abs().max().item() <= tol
        assert (gn - want_gn).abs().max().item() <= tol
    dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
    assert _rel(dw, want_dw) <= 1e-4 and _rel(db, want_db) <= 1e-4
    again = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
    dxp2, gn2 = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    assert torch.equal(ys, gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0])
    assert torch.equal(dxp, dxp2) and torch.equal(gn, gn2)


def _program_run(cuda, options: dict, capture: bool):
    """Three train steps at a small width (hidden 32, one GRU layer, batch
    8, dropout 0.3 and the speaker noise drawn from the step's generator)
    as a program of two and one of one (`StepProgram`), captured into CUDA
    graphs or run eagerly on the card, from the same weights, rows and
    generator seed: (metrics of each program, the step, the generator's
    state, the program)."""
    import dataclasses

    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.ted_db import DeviceDataset
    from speech2affective_gestures_torch.train import builder
    from speech2affective_gestures_torch.train.step_program import StepProgram

    cfg = ModelConfig.from_yaml("config/multimodal_context_v2.yml", hidden_size=32,
                                hidden_size_s2eg=32, n_layers=1, wordembed_dim=16,
                                batch_size=8, loss_warmup=-1)
    mixed = options.pop("mixed", False)
    setup = builder.init_training(cfg, 0, 50, 6, device=cuda, mixed_precision=mixed)
    step = setup["step"]
    step.cfg = dataclasses.replace(step.cfg, **options)
    rng = np.random.default_rng(3)
    data = DeviceDataset(builder.synthetic_packed(rng, 40, cfg, 50, 6), cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    program = StepProgram(step, data, g, capture=capture)
    out = []
    for k in (2, 1):
        keys, values = program.run(rng.integers(0, 40, (k, 8)), rng.integers(0, 6, (k, 8)),
                                   gan_on=True)
        out.append(dict(zip(keys, values.T)))
    torch.cuda.synchronize()
    return out, step, g.get_state(), program


@pytest.mark.gpu
@pytest.mark.parametrize("options", [
    {"lr_decay": 0.5, "decay_steps_per_epoch": 1}, {"mixed": True}, {"fused_pass": True},
    {"remat": "full"}, {"remat": "dots", "gradient_clip": 0.1}],
    ids=["decay", "mixed", "fused", "remat_full", "remat_dots_clipped"])
def test_step_program_graph_equals_eager_steps(cuda, options):
    """The K-step program captured into CUDA graphs (K 2, then the partial
    program of 1) against the same body run eagerly on the card, under
    `cudnn.deterministic`: the metrics, both nets' parameters and buffers
    (BatchNorm statistics), both Adam states (moments, device counts and,
    with decay, the learning rates, which halve at every update here, so
    inside the program), the generator's state and the step count, bit for
    bit. The GRU kernels' launches: the warm-up's plus each graph's per
    replay."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gru_cuda.launches.clear()
        graph = _program_run(cuda, dict(options), capture=True)
        counted = gru_cuda.launches.copy()
        eager = _program_run(cuda, dict(options), capture=False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (got, step, state, program), (want, ref, ref_state, _) = graph, eager
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), (k, g[k], w[k])
    for who in ("gen", "dis"):
        for (name, v), w in zip(getattr(step, who).state_dict().items(),
                                getattr(ref, who).state_dict().values()):
            assert torch.equal(v, w), (who, name)
        opt, ref_opt = getattr(step, f"{who}_opt"), getattr(ref, f"{who}_opt")
        for p, q in zip(getattr(step, who).parameters(), getattr(ref, who).parameters()):
            for k in ref_opt.state[q]:
                assert torch.equal(opt.state[p][k], ref_opt.state[q][k]), (who, k)
        for a, b in zip(opt.param_groups, ref_opt.param_groups):
            assert torch.equal(torch.as_tensor(a["lr"]), torch.as_tensor(b["lr"])), who
    assert torch.equal(state, ref_state) and step.step == ref.step == 3
    record = program.launch_record()
    assert sorted(record) == [(1, True), (2, True)]
    dtype = "bfloat16" if options.get("mixed") else "float32"
    for kernel in ("gru_fwd", "gru_bwd", "gru_dw"):
        per_replay = {key: n[(kernel, dtype)] for key, (n, _) in record.items()}
        assert per_replay[(2, True)] == 2 * per_replay[(1, True)] > 0, (kernel, per_replay)
        assert counted[(kernel, dtype)] == program.warmup_launches[(kernel, dtype)] + sum(
            n[(kernel, dtype)] * replays for n, replays in record.values()), kernel


def _small_config(**kw):
    from speech2affective_gestures_torch.config import ModelConfig

    return ModelConfig.from_yaml("config/multimodal_context_v2.yml", hidden_size=32,
                                 hidden_size_s2eg=32, n_layers=1, wordembed_dim=16,
                                 batch_size=8, loss_warmup=-1, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("lr_decay,steps_per_epoch", [(0.5, 3), (0.97, 7), (0.999, 1)])
def test_scheduled_lr_tensor_on_the_card(cuda, lr_decay, steps_per_epoch):
    """A capturable trainer's learning rates on the card (`sync_lr` from
    the device counts, `scheduled_lr_tensor`) against the host schedule
    (`scheduled_lr`) at every count across the decay's epoch boundaries:
    the float64 rate within one double rounding (the device's `pow`), the
    float32 rate the optimizer holds the same bits as the host rate's."""
    import dataclasses

    from speech2affective_gestures_torch.train import builder, gan_step

    step = builder.init_training(_small_config(), 0, 50, 6, device=cuda)["step"]
    step.cfg = dataclasses.replace(step.cfg, lr_decay=lr_decay,
                                   decay_steps_per_epoch=steps_per_epoch)
    step.make_capturable()
    for count in range(4 * steps_per_epoch + 3):
        for w, base in (("gen", step.cfg.learning_rate), ("dis", step.cfg.lr_dis)):
            opt = getattr(step, f"{w}_opt")
            for state in opt.state.values():
                state["step"].fill_(count)
            step.sync_lr(w)
            want = gan_step.scheduled_lr(base, step.cfg, count)
            got = gan_step.scheduled_lr_tensor(
                base, step.cfg, torch.tensor(float(count), device=cuda))
            assert abs(got.item() - want) <= 2.0 ** -52 * want, (w, count, got.item(), want)
            assert all(g["lr"].item() == np.float32(want) for g in opt.param_groups), (w, count)


@pytest.mark.gpu
@pytest.mark.parametrize("options", [
    {}, {"lr_decay": 0.5, "decay_steps_per_epoch": 2},
    {"lr_decay": 0.9, "decay_steps_per_epoch": 3, "gradient_clip": 0.1}],
    ids=["constant", "decay", "decay_clipped"])
def test_capturable_adam_update_equals_host_adam(cuda, options):
    """Both nets' Adam updates (`GanStep._update`: clipping, the update,
    the next rate) of a capturable trainer, captured into one CUDA graph
    and replayed, against the host Adam of the same trainer (PyTorch's
    non-capturable Adam, its rate `scheduled_lr` on the host), over 7
    updates from the same weights with the same random gradients (the
    first update run eagerly, the capture's warm-up): after every update
    the moments the same bits (the same ops on the same gradients), the
    counts equal, the float32 rate the host rate's, and every parameter
    within n updates x (2^-22 of its tensor's largest value + 2e-5 of the
    base rate): the two compute the bias corrections and the step in
    another order (float32 on the device against float64 scalars), a
    few roundings of an update, and each update's result may round to
    the next float32. A wrong bias correction or a rate off by one
    decay step moves a parameter by about a rate."""
    import dataclasses

    from speech2affective_gestures_torch.train import builder, gan_step

    steps = []
    for _ in range(2):
        step = builder.init_training(_small_config(), 0, 50, 6, device=cuda)["step"]
        step.cfg = dataclasses.replace(step.cfg, **options)
        steps.append(step)
    cap, host = steps
    cap.make_capturable()
    params = {w: [[p for p in getattr(s, w).parameters() if p.requires_grad] for s in steps]
              for w in ("gen", "dis")}
    for w in params:
        for p, q in zip(*params[w]):
            assert torch.equal(p, q)
            p.grad, q.grad = torch.empty_like(p), torch.empty_like(q)
    rng = torch.Generator(device=cuda).manual_seed(5)

    def fill():
        for w in params:
            for p, q in zip(*params[w]):
                p.grad.normal_(generator=rng)
                q.grad.copy_(p.grad)

    def update(s):
        s._update("gen")
        s._update("dis")

    graph = None
    for n in range(1, 8):
        fill()
        if graph is None:
            update(cap)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                update(cap)
        else:
            graph.replay()
        update(host)
        torch.cuda.synchronize()
        for w, base in (("gen", cap.cfg.learning_rate), ("dis", cap.cfg.lr_dis)):
            opt, ref = getattr(cap, f"{w}_opt"), getattr(host, f"{w}_opt")
            for p, q in zip(*params[w]):
                for k in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(opt.state[p][k], ref.state[q][k]), (n, w, k)
                assert opt.state[p]["step"].item() == ref.state[q]["step"].item() == n
                tol = n * (2.0 ** -22 * q.abs().max().item() + 2e-5 * base)
                assert (p - q).abs().max().item() <= tol, (n, w, (p - q).abs().max().item(), tol)
            want = gan_step.scheduled_lr(base, cap.cfg, n)
            for g, h in zip(opt.param_groups, ref.param_groups):
                assert h["lr"] == want
                assert float(g["lr"]) == np.float32(want), (n, w)


@pytest.mark.gpu
def test_checkpoint_from_a_capturable_trainer_on_the_card(cuda, tmp_path):
    """A trainer that ran a scanned epoch on the card (K 2 over 3 steps:
    CUDA graphs, capturable Adams, the rate halving every update) saves a
    checkpoint in the reference's host Adam form (counts float32 on the
    host, rates floats, `capturable` off); it loads into a per-step
    trainer on the card, into one on the CPU and into a scanned trainer
    on the card with the same weights, statistics, moments and counts
    (the same bits) and the host schedule's rate (the graph's float32 rate
    rounded from it); the loaded scanned trainer's next epoch, its step
    generator and count restored from the data-state file, equals the
    writer's next epoch, bit for bit, under `cudnn.deterministic`."""
    import dataclasses

    from speech2affective_gestures_torch.data import ted_db
    from speech2affective_gestures_torch.train import gan_step
    from speech2affective_gestures_torch.train.trainer import Trainer

    cfg = _small_config()
    ds = ted_db.build_dataset_from_videos(ted_db.make_synthetic_videos(2, 12.0), cfg)

    def trainer(device, spp):
        t = Trainer(cfg, str(tmp_path), train_data=ds, device=device, seed=3,
                    steps_per_program=spp, lr_decay=0.5, log_interval=1)
        t.step.cfg = t.gan_cfg = dataclasses.replace(t.gan_cfg, decay_steps_per_epoch=1)
        return t

    def nets(t):
        return {f"{w} {k}": v.cpu() for w in ("gen", "dis", "tri")
                for k, v in getattr(t, w).state_dict().items()}

    def adam(t):
        return {f"{w} {i} {k}": v.cpu() for w in ("gen", "dis")
                for i, s in enumerate(getattr(t.step, f"{w}_opt").state.values())
                for k, v in s.items()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = trainer(cuda, 2)
        a.per_train_epoch(max_iters=3)
        assert a.epoch_engine == "scanned" and sorted(a._program.graphs) == [(1, True),
                                                                             (2, True)]
        blob = torch.load(a.save_checkpoint(0.5), weights_only=True)
        for key in ("gen_optimizer_dict", "dis_optimizer_dict"):
            assert all(g["capturable"] is False and isinstance(g["lr"], float)
                       for g in blob[key]["param_groups"])
            assert all(s["step"].device.type == "cpu" and s["step"].dtype == torch.float32
                       for s in blob[key]["state"].values())
        loaded = {}
        for name, device, spp in (("per step", cuda, 1), ("CPU", "cpu", 1),
                                  ("scanned", cuda, 2)):
            b = loaded[name] = trainer(device, spp)
            assert b.load_checkpoint(0)
            for got, want in ((nets(b), nets(a)), (adam(b), adam(a))):
                assert got.keys() == want.keys()
                diff = [k for k in want if not torch.equal(got[k], want[k])]
                assert not diff, (name, diff[:8])
            for w, base in (("gen", a.gan_cfg.learning_rate), ("dis", a.gan_cfg.lr_dis)):
                want = gan_step.scheduled_lr(base, a.gan_cfg, 3)
                for g, ga in zip(getattr(b.step, f"{w}_opt").param_groups,
                                 getattr(a.step, f"{w}_opt").param_groups):
                    assert g["lr"] == want and float(ga["lr"]) == np.float32(want), (name, w)
        b = loaded["scanned"]
        for t in (a, b):
            t.epoch = 1
            t.per_train_epoch(max_iters=3)
        torch.cuda.synchronize()
        for got, want in ((nets(b), nets(a)), (adam(b), adam(a))):
            diff = [k for k in want if not torch.equal(got[k], want[k])]
            assert not diff, diff[:8]
        assert torch.equal(b.generator.get_state(), a.generator.get_state())
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.gpu
def test_grain_loader_batches_on_the_card_equal_decode_rows(cuda):
    """The streaming loader on the card (rows gathered into pinned memory,
    copied without blocking, decoded there in float64) against
    `decode_rows` on the host on the same rows, at batch 64 of a split of
    150 (batches across epoch boundaries): every array the same bits; a
    loader set to the state after batch 1 gives batch 2 again."""
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.grain_loader import GrainLoader, batch_rows
    from speech2affective_gestures_torch.data.ted_db import decode_rows
    from speech2affective_gestures_torch.train import builder

    ds = builder.synthetic_packed(np.random.default_rng(3), 150, ModelConfig(batch_size=64))
    loader = GrainLoader(ds, 64, 7, cuda)
    got = [next(loader) for _ in range(5)]
    for t, batch in enumerate(got):
        want = decode_rows(ds, batch_rows(150, 64, 7, t))
        want["vid_indices"] = loader.packed_batch(t, 7)["vid_indices"].numpy()
        assert batch.keys() == want.keys()
        for k, v in want.items():
            assert batch[k].device.type == "cuda"
            assert batch[k].cpu().numpy().tobytes() == v.tobytes(), (t, k)
    again = GrainLoader(ds, 64, 0, cuda)
    again.set_state({"next_batch": 2, "seed": 7})
    assert all(torch.equal(v, got[2][k]) for k, v in next(again).items())
