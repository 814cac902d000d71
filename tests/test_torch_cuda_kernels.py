"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, at the serving path's shapes. Marked `gpu`: they skip without a CUDA
GPU. This file imports no JAX, so it runs on a machine that has none:
`python -m pytest tests/test_torch_cuda_kernels.py`.

Tolerances: the kernels use plain float32 FMA in another order than
cuBLAS. The mel power is a sum of ~2000 products per bin, which in float32
differ by ~1e-5 relative even in the quiet bands, so each value is held
within 1e-4 of its own magnitude, plus 1e-7 of the largest value for values
near zero; the GRU within 1e-4 absolute after 34 steps (h in [-1, 1]).
"""

import numpy as np
import pytest
import torch

from speech2affective_gestures_torch import constants as C
from speech2affective_gestures_torch.ops import dsp, gru_cuda, mel_cuda


def _frames(rows, seed=0):
    """Hann-windowed frames of a chirp with noise, the kernel's real input."""
    rng = np.random.default_rng(seed)
    n = C.EXPECTED_AUDIO_LENGTH * 2
    t = np.arange(n) / 16000
    y = (0.4 * np.sin(2 * np.pi * (200 + 40 * t) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return dsp.windowed_frames(torch.from_numpy(y)).reshape(-1, 2048)[:rows]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [7, 568, 2272])
def test_mel_kernel_against_plain(cuda, rows):
    frames = _frames(142).repeat((rows + 141) // 142, 1)[:rows]
    frames = frames.contiguous().to(cuda)
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
