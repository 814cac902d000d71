"""The host side of the redesigned kernels, on the CPU: the mel kernel's
tables and a numpy model of its data flow, and the GRU forward's launch
plan. The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py).

Tolerances: the numpy model runs the kernel's float32 arithmetic in
another order than the plain dense products and Pallas, so it is held as
tests/test_torch_kernels.py holds the plain version: within 1e-5 of the
largest output, and each value within 1e-4 of its own magnitude plus 1e-8
of the largest. The twiddle tables are float64 values rounded once to
float32: within half a float32 ulp of 1 (2**-24) of numpy's float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.ops import dsp as tdsp
from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.ops import dsp_pallas


def _frames(rows, n_fft=2048, seed=0):
    rng = np.random.default_rng(seed)
    n = C.EXPECTED_AUDIO_LENGTH * 2
    t = np.arange(n) / 16000
    y = (0.4 * np.sin(2 * np.pi * (200 + 40 * t) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return tdsp.windowed_frames(torch.from_numpy(y), n_fft).reshape(-1, n_fft)[:rows].contiguous()


def _mel_model(frames: np.ndarray, sr: int = 16000, n_mels: int = 128) -> np.ndarray:
    """The kernel's data flow in float32 numpy: the packed M-point complex
    sequence, the Stockham passes (radix 2 first when log2 M is odd, then
    radix 4) with the kernel's twiddle table, the real-FFT split, the power
    and the band sums over each band's run of bins."""
    R, n_fft = frames.shape
    m = n_fft // 2
    fft_tw, split_tw, bands, weights = mel_cuda.kernel_tables(sr, n_fft, n_mels)
    tw = (fft_tw[:, 0] + 1j * fft_tw[:, 1]).astype(np.complex64)
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    ns = 1
    for p in ([2] if int(np.log2(m)) % 2 else []) + [4] * (int(np.log2(m)) // 2):
        j = np.arange(m // p)
        jm = j % ns
        v = [z[:, j + r * (m // p)] * tw[r * jm * (m // (ns * p))] for r in range(p)]
        if p == 2:
            y = [v[0] + v[1], v[0] - v[1]]
        else:
            a, s, c, d = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
            y = [a + c, s - 1j * d, a - c, s + 1j * d]
        out = np.empty_like(z)
        for r in range(p):
            out[:, (j - jm) * p + jm + r * ns] = y[r]
        z, ns = out, ns * p
    # the split for bins 0..M; the table holds k <= M/2, and bin M - k
    # takes (-cos, sin) of bin k
    c = np.concatenate([split_tw[:, 0], -split_tw[::-1][1:, 0]])
    s = np.concatenate([split_tw[:, 1], split_tw[::-1][1:, 1]])
    k = np.arange(m + 1)
    a, b = z[:, k % m], np.conj(z[:, (m - k) % m])
    e, d = np.float32(0.5) * (a + b), np.float32(0.5) * (a - b)
    x = e + (-s - 1j * c).astype(np.complex64) * d
    x[:, 0] = z[:, 0].real + z[:, 0].imag
    x[:, m] = z[:, 0].real - z[:, 0].imag
    power = (x.real * x.real + x.imag * x.imag).astype(np.float32)
    mel = np.zeros((R, n_mels), np.float32)
    for band, (lo, n, off) in enumerate(bands):
        for i in range(n):
            mel[:, band] += weights[off + i] * power[:, lo + i]
    return mel


@pytest.mark.parametrize("n_fft", [1024, 2048])
def test_band_table_rebuilds_the_filterbank(n_fft):
    _, _, bands, weights = mel_cuda.kernel_tables(16000, n_fft, 128)
    dense = mel_cuda.dft_constants(16000, n_fft, 128)[2]
    rebuilt = np.zeros_like(dense)
    for band, (lo, n, off) in enumerate(bands):
        rebuilt[lo:lo + n, band] = weights[off:off + n]
    np.testing.assert_array_equal(rebuilt, dense)
    # each band one run of bins, a bin in at most two bands
    assert (np.count_nonzero(dense, axis=0) == bands[:, 1]).all()
    assert np.count_nonzero(dense, axis=1).max() <= 2


@pytest.mark.parametrize("n_fft", [1024, 2048])
def test_twiddle_tables_are_float32_roundings(n_fft):
    fft_tw, split_tw, _, _ = mel_cuda.kernel_tables(16000, n_fft, 128)
    m = n_fft // 2
    want = np.exp(-2j * np.pi * np.arange(m) / m)
    assert fft_tw.dtype == split_tw.dtype == np.float32
    np.testing.assert_allclose(fft_tw[:, 0], want.real, rtol=0, atol=2.0 ** -24)
    np.testing.assert_allclose(fft_tw[:, 1], want.imag, rtol=0, atol=2.0 ** -24)
    ang = 2 * np.pi * np.arange(m // 2 + 1) / n_fft
    np.testing.assert_allclose(split_tw[:, 0], np.cos(ang), rtol=0, atol=2.0 ** -24)
    np.testing.assert_allclose(split_tw[:, 1], np.sin(ang), rtol=0, atol=2.0 ** -24)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("rows", [3, 71, 142])
def test_mel_kernel_model_against_plain_and_pallas(rows):
    frames = _frames(rows)
    got = _mel_model(frames.numpy())
    _close(got, mel_cuda.mel_power_plain(frames).numpy())
    _close(got, np.asarray(dsp_pallas.fused_mel_power_frames(
        jnp.asarray(frames.numpy()), interpret=True)))


@pytest.mark.parametrize("n_fft", [512, 1024, 4096])
def test_mel_kernel_model_other_sizes(n_fft):
    """The radix-2 pass (n_fft 1024: M = 512 = 2 x 4^4; 4096: 2 x 4^5) and
    the smallest size, against the plain version."""
    frames = _frames(9, n_fft)
    _close(_mel_model(frames.numpy()), mel_cuda.mel_power_plain(frames).numpy())


@pytest.mark.parametrize("n_fft,n_mels", [(1000, 128), (1536, 128), (256, 128),
                                          (8192, 128), (2048, 64)])
def test_mel_kernel_refuses_other_shapes(n_fft, n_mels):
    with pytest.raises(ValueError):
        mel_cuda.check_kernel_shape(n_fft, n_mels)


def test_mel_kernel_takes_the_main_paths_shapes():
    for n_fft in (1024, 2048):
        mel_cuda.check_kernel_shape(n_fft, 128)


def _fwd_rows_max(plan):
    return gru_cuda.SMEM_LIMIT // gru_cuda._fwd_smem(plan.S, plan.KC, 1)


@pytest.mark.parametrize("H", [300, 64])
@pytest.mark.parametrize("B", [1, 258, 512])
@pytest.mark.parametrize("max_clusters", [15, 7, 132])
def test_gru_fwd_plan(B, H, max_clusters):
    """The launch fits a block's shared memory and threads, covers every
    hidden unit and every batch row exactly once, and takes no more waves
    of `max_clusters` clusters than the batch needs."""
    D = 2
    plan = gru_cuda.fwd_plan(B, H, D, max_clusters)
    assert plan.smem == gru_cuda._fwd_smem(plan.S, plan.KC, plan.BT)
    assert plan.smem <= gru_cuda.SMEM_LIMIT
    assert plan.threads == -(-plan.U * plan.S // 32) * 32
    assert plan.threads <= gru_cuda._max_threads(plan.KC)
    assert plan.C <= gru_cuda.MAX_CLUSTER and plan.KC <= gru_cuda.MAX_KC
    assert plan.KC % 8 == 0
    assert plan.S * plan.KC >= H > plan.S * (plan.KC - 8)
    assert plan.U % 4 == 0
    units = np.concatenate([np.arange(c * plan.U, min((c + 1) * plan.U, H))
                            for c in range(plan.C)])
    np.testing.assert_array_equal(units, np.arange(H))
    assert (plan.C - 1) * plan.U < H
    rows = np.concatenate([np.arange(t * plan.BT, min((t + 1) * plan.BT, B))
                           for t in range(plan.tiles)])
    np.testing.assert_array_equal(rows, np.arange(B))
    assert (plan.tiles - 1) * plan.BT < B
    fewest = -(-D * -(-B // _fwd_rows_max(plan)) // max_clusters)
    assert -(-D * plan.tiles // max_clusters) == fewest


def test_gru_fwd_plan_main_shapes():
    """H 300: clusters of 8 blocks, 40 units and 8 chunks of 40 rows of
    W_hh each; B 512 in one wave of the H100's 15 clusters; H 64 one block
    a tile."""
    assert gru_cuda.fwd_plan(512, 300, 2, 15)[:6] == (8, 40, 8, 40, 74, 7)
    assert gru_cuda.fwd_plan(1, 300, 2, 15)[:6] == (8, 40, 8, 40, 1, 1)
    assert gru_cuda.fwd_plan(512, 64, 2, 132)[:6] == (1, 64, 2, 32, 8, 64)


@pytest.mark.parametrize("H", [321, 1024])
def test_gru_fwd_refuses_a_hidden_size_too_large(H):
    with pytest.raises(ValueError):
        gru_cuda.fwd_shape(H)


def _gru_fwd_model(xp, w_hh, b_ih, b_hh, BT):
    """The forward kernel's arithmetic in float32 numpy: each of the S
    chunks of KC rows of W_hh summed in ascending k, then the chunk sums of
    a row added across the warp in the order its place in the group of S
    rows of a tile of BT gives: the reduce-scatter, in which the lane of
    place i adds its partner's sum to its own at distances S/2, ..., 2, 1;
    or, for a group of one row, the butterfly at distances 1, 2, ..., S/2."""
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    S, KC, _, _ = gru_cuda.fwd_shape(H)
    f32 = np.float32
    b = np.arange(B)
    place = b % BT % S
    tile_rows = np.minimum(BT, B - b // BT * BT)
    alone = (b % BT == tile_rows - 1) & (b % BT % S == 0)

    def butterfly(part, halves):
        for half in halves:
            part = part + part[np.arange(S) ^ half]
        return part

    halves = [S >> i for i in range(1, S.bit_length())]
    ys = np.zeros((T, B, D * H), f32)
    h_last = np.zeros((D, B, H), f32)
    for d in range(D):
        h = np.zeros((B, H), f32)
        for step in range(T):
            t = step if d == 0 else T - 1 - step
            part = np.zeros((S, B, 3 * H), f32)
            for s in range(S):
                for k in range(s * KC, min((s + 1) * KC, H)):
                    part[s] = part[s] + h[:, k:k + 1] * w_hh[d, k]
            hp = np.where(alone[:, None], butterfly(part, halves[::-1])[0],
                          butterfly(part, halves)[place, b])
            x = xp[t, :, d * 3 * H:(d + 1) * 3 * H] + b_ih[d]
            r = 1 / (1 + np.exp(-(x[:, :H] + (hp[:, :H] + b_hh[d, :H]))))
            z = 1 / (1 + np.exp(-(x[:, H:2 * H] + (hp[:, H:2 * H] + b_hh[d, H:2 * H]))))
            n = np.tanh(x[:, 2 * H:] + r * (hp[:, 2 * H:] + b_hh[d, 2 * H:]))
            h = ((1 - z) * n + z * h).astype(f32)
            ys[t, :, d * H:(d + 1) * H] = h
        h_last[d] = h
    return ys, h_last


@pytest.mark.parametrize("H,B,BT", [(300, 10, 10), (300, 9, 9), (64, 5, 5), (40, 3, 2),
                                    (100, 6, 6)])
def test_gru_fwd_model_against_plain_and_pallas(H, B, BT):
    """The chunked sums and the reduce-scatter agree with the plain time
    loop and with the JAX package's layer (Pallas in interpret mode) within
    1e-5 after 8 steps: float32 sums of H products in another order.
    (H, S, KC): (300, 8, 40), (64, 2, 32), (40, 2, 24), (100, 4, 32); the
    tiles put rows at every place of a group, and groups of one row."""
    from speech2affective_gestures_tpu.ops import gru_pallas

    T, D = 8, 2
    rng = np.random.default_rng(H + B)
    bound = H ** -0.5
    xp = rng.standard_normal((T, B, D * 3 * H)).astype(np.float32)
    w_hh, b_ih, b_hh = (rng.uniform(-bound, bound, shape).astype(np.float32)
                        for shape in ((D, H, 3 * H), (D, 3 * H), (D, 3 * H)))
    ys, h_last = _gru_fwd_model(xp, w_hh, b_ih, b_hh, BT)
    want_ys, want_h = gru_cuda.gru_layer_plain(*map(torch.from_numpy, (xp, w_hh, b_ih, b_hh)))
    np.testing.assert_allclose(ys, want_ys.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h_last, want_h.numpy(), rtol=0, atol=1e-5)
    # the TPU layout pads each gate to P = 128 lanes
    P = gru_pallas._round_up(H, gru_pallas.LANE)
    xp_pad = np.zeros((T, B, D, 3 * P), np.float32)
    for g in range(3):
        xp_pad[..., g * P:g * P + H] = xp.reshape(T, B, D, 3 * H)[..., g * H:(g + 1) * H]
    jys, jh = gru_pallas.run_layer_v2(jnp.asarray(xp_pad), jnp.asarray(w_hh),
                                      jnp.asarray(b_ih), jnp.asarray(b_hh), interpret=True)
    jys = np.concatenate([np.asarray(jys)[..., d * P:d * P + H] for d in range(D)], -1)
    np.testing.assert_allclose(ys, jys, rtol=0, atol=1e-5)
    np.testing.assert_allclose(h_last, np.asarray(jh), rtol=0, atol=1e-5)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (3.0, 4.0)], 3.0),               # a gap between two launches
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),               # two streams at once
    ([(1.0, 3.0), (0.0, 5.0), (4.0, 6.0)], 6.0),   # one inside another
    ([(2.0, 3.0), (0.0, 1.0), (0.5, 1.5)], 2.5),   # unsorted
])
def test_device_busy_time_counts_overlap_once(spans, want):
    """chip_smoke's device time per call is the union of the kernels'
    spans: a library call that runs kernels on two streams at once (cuDNN's
    bidirectional GRU) is not charged its overlap twice."""
    assert _chip_smoke().busy_us(spans) == want
