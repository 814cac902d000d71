"""The host side of the redesigned kernels, on the CPU: the mel kernel's
tables, its tier choice and numpy models of both tiers' data flow, and the
GRU kernels' launch plans (the bf16 dW copy widths among them). The
kernels themselves run only on the card (tests/test_torch_cuda_kernels.py).

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


def _butterfly(p: int, v: list) -> list:
    """The kernel's radix-p butterfly on complex64 columns (its float32
    constants for radix 3 and 5)."""
    if p == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if p == 4:
        a, s, c, d = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        return [a + c, s - 1j * d, a - c, s + 1j * d]
    if p == 3:
        t = v[1] + v[2]
        m = v[0] - np.float32(0.5) * t
        s = np.float32(np.sin(2 * np.pi / 3)) * (v[1] - v[2])
        return [v[0] + t, m - 1j * s, m + 1j * s]
    c1, c2 = np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5))
    s1, s2 = np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5))
    t1, t2, t3, t4 = v[1] + v[4], v[2] + v[3], v[1] - v[4], v[2] - v[3]
    a1, a2 = v[0] + c1 * t1 + c2 * t2, v[0] + c2 * t1 + c1 * t2
    b1, b2 = s1 * t3 + s2 * t4, s2 * t3 - s1 * t4
    return [v[0] + t1 + t2, a1 - 1j * b1, a2 - 1j * b2, a2 + 1j * b2, a1 + 1j * b1]


def _mel_model(frames: np.ndarray, sr: int = 16000, n_mels: int = 128) -> np.ndarray:
    """The kernel's data flow in float32 numpy: the packed M-point complex
    sequence, the Stockham passes in the kernel's order (`mel_cuda.
    fft_radices`: radix 2 first when M holds an odd power of two, then
    radix 4, 3, 5) with its twiddle table, the real-FFT split, the power and
    the band sums over each band's run of bins."""
    R, n_fft = frames.shape
    m = n_fft // 2
    fft_tw, split_tw, bands, weights = mel_cuda.kernel_tables(sr, n_fft, n_mels)
    tw = (fft_tw[:, 0] + 1j * fft_tw[:, 1]).astype(np.complex64)
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    ns = 1
    for p in mel_cuda.fft_radices(n_fft):
        j = np.arange(m // p)
        jm = j % ns
        v = [z[:, j + r * (m // p)] * tw[r * jm * (m // (ns * p))] for r in range(p)]
        y = [a.astype(np.complex64) for a in _butterfly(p, v)]
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


@pytest.mark.parametrize("n_fft,n_mels,tier", [(1000, 128, "fft"), (1536, 128, "fft"),
                                               (256, 128, "fft"), (8192, 128, "dft"),
                                               (2048, 64, "fft"), (512, 40, "fft"),
                                               (4096, 256, "fft"), (400, 80, "fft"),
                                               (30000, 128, "dft"), (998, 128, "dft"),
                                               (401, 80, "dft"), (480, 40, "fft"),
                                               (882, 80, "dft"), (62, 40, "dft")])
def test_mel_plan_picks_the_tier(n_fft, n_mels, tier):
    """Every shape has a launch: the FFT tier for even n_fft whose half is
    2^a 3^b 5^c within [MIN_N_FFT, MAX_N_FFT] at any band count (FFT_POINTS
    // (n_fft/2) whole rows a block), the DFT tier otherwise (a prime factor
    above 5: 998 = 2 x 499, 882 = 2 x 3^2 x 7^2; odd; past 4096; below 64),
    its twiddle table in shared memory while it fits (a 30000-point table
    does not)."""
    plan = mel_cuda.mel_plan(601, n_fft, n_mels)
    assert plan.tier == tier
    assert plan.blocks * plan.rows >= 601 > (plan.blocks - 1) * plan.rows
    if tier == "fft":
        assert plan.rows == mel_cuda.FFT_POINTS // (n_fft // 2) and plan.smem == 0
        assert np.prod(mel_cuda.fft_radices(n_fft)) == n_fft // 2
    if tier == "dft":
        assert plan.rows == mel_cuda.DFT_ROWS and plan.smem <= mel_cuda.SMEM_LIMIT
        assert plan.tw_in_smem == (n_fft <= 16384)
        assert plan.smem >= 4 * (mel_cuda.DFT_KT * plan.rows + plan.rows * mel_cuda.DFT_THREADS
                                 + plan.rows * n_mels) + 8 * n_fft * plan.tw_in_smem


def test_mel_kernel_takes_the_main_paths_shapes():
    """Serving (n_fft 2048) and the corpus build (1024) at 128 bands keep
    the FFT tier's plan: 2 and 4 rows a block, no dynamic shared memory."""
    assert mel_cuda.mel_plan(568, 2048, 128) == mel_cuda.MelPlan("fft", 2, 284, 0, False)
    assert mel_cuda.mel_plan(1876, 1024, 128) == mel_cuda.MelPlan("fft", 4, 469, 0, False)
    with pytest.raises(ValueError):
        mel_cuda.mel_plan(4, 2048, 0)


def _mel_dft_model(frames: np.ndarray, sr: int = 16000, n_mels: int = 128) -> np.ndarray:
    """The DFT tier's data flow in float32 numpy: the dense cos and sin
    matrices gathered from its N-entry twiddle table at (n k) mod N, the
    products summed in chunks of DFT_KC, the chunks into stages of DFT_KT
    and the stages into the total; the power; each band's bins in
    ascending order."""
    R, n_fft = frames.shape
    tw, bands, weights = mel_cuda.dft_tables(sr, n_fft, n_mels)
    k = np.arange(n_fft // 2 + 1)
    idx = (np.arange(n_fft)[:, None] * k[None, :]) % n_fft
    kt, kc = mel_cuda.DFT_KT, 32
    pad = -n_fft % kt
    x = np.pad(frames, ((0, 0), (0, pad))).reshape(R, -1, kt // kc, kc)
    spec = []
    for col in (0, 1):
        mat = np.pad(tw[idx, col], ((0, pad), (0, 0))).reshape(-1, kt // kc, kc, len(k))
        chunks = np.einsum("rsci,scik->rsck", x, mat).astype(np.float32)
        spec.append(chunks.sum(axis=2, dtype=np.float32).sum(axis=1, dtype=np.float32))
    power = (spec[0] * spec[0] + spec[1] * spec[1]).astype(np.float32)
    mel = np.zeros((R, n_mels), np.float32)
    for band, (lo, n, off) in enumerate(bands):
        for i in range(n):
            mel[:, band] += weights[off + i] * power[:, lo + i]
    return mel


@pytest.mark.parametrize("n_fft", [400, 1000, 1536, 480, 256])
@pytest.mark.parametrize("n_mels", [80, 128, 40])
def test_mel_mixed_radix_model_against_plain_and_pallas(n_fft, n_mels):
    """The FFT tier at mixed-radix sizes (n_fft/2 = 200 = 2 x 4 x 5^2, 500 =
    4 x 5^3, 768 = 4^4 x 3, 240 = 4^2 x 3 x 5; 128 = 2 x 4^3, a power of two
    that took the DFT tier before): the passes in the kernel's order, its
    radix-3 and radix-5 butterflies, the split and the band sums against
    the plain dense products and the TPU kernel
    (`fused_mel_power_frames(interpret=True)`), as the power-of-two model is
    held (`_close`)."""
    assert mel_cuda.mel_plan(9, n_fft, n_mels).tier == "fft"
    frames = _frames(9, n_fft)
    got = _mel_model(frames.numpy(), n_mels=n_mels)
    _close(got, mel_cuda.mel_power_plain(frames, n_mels=n_mels).numpy())
    _close(got, np.asarray(dsp_pallas.fused_mel_power_frames(
        jnp.asarray(frames.numpy()), n_fft=n_fft, n_mels=n_mels, interpret=True)))


@pytest.mark.parametrize("n_fft,n_mels", [(1000, 128), (1536, 64), (256, 40), (400, 80)])
def test_mel_dft_model_against_plain_and_pallas(n_fft, n_mels):
    """The DFT tier's arithmetic against the plain dense products and the
    TPU kernel (`fused_mel_power_frames(interpret=True)`), which take any
    n_fft and band count."""
    frames = _frames(9, n_fft)
    got = _mel_dft_model(frames.numpy(), n_mels=n_mels)
    _close(got, mel_cuda.mel_power_plain(frames, n_mels=n_mels).numpy())
    _close(got, np.asarray(dsp_pallas.fused_mel_power_frames(
        jnp.asarray(frames.numpy()), n_fft=n_fft, n_mels=n_mels, interpret=True)))


@pytest.mark.parametrize("n_fft,n_mels", [(1000, 128), (256, 128), (2048, 64)])
def test_band_tables_at_other_shapes(n_fft, n_mels):
    """The band table rebuilds the dense filterbank at any shape (bands
    without a bin hold none); the DFT tier's twiddle table is the float32
    rounding of (cos, sin) of 2 pi m / N."""
    tw, bands, weights = mel_cuda.dft_tables(16000, n_fft, n_mels)
    dense = mel_cuda.dft_constants(16000, n_fft, n_mels)[2]
    rebuilt = np.zeros_like(dense)
    for band, (lo, n, off) in enumerate(bands):
        rebuilt[lo:lo + n, band] = weights[off:off + n]
    np.testing.assert_array_equal(rebuilt, dense)
    ang = 2 * np.pi * np.arange(n_fft) / n_fft
    np.testing.assert_allclose(tw[:, 0], np.cos(ang), rtol=0, atol=2.0 ** -24)
    np.testing.assert_allclose(tw[:, 1], np.sin(ang), rtol=0, atol=2.0 ** -24)


def _fwd_rows_max(plan):
    return gru_cuda.SMEM_LIMIT // gru_cuda._fwd_smem(plan.S, plan.KC, 1)


@pytest.mark.parametrize("H", [300, 64])
@pytest.mark.parametrize("B", [1, 258, 512, 1024])
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


@pytest.mark.parametrize("H", [321, 512, 600, 1024])
@pytest.mark.parametrize("B", [1, 512])
def test_gru_fwd_plan_past_the_registers(B, H):
    """Past H 320 W_hh does not fit in a cluster's registers: the plan names
    the L2 tier, keeps the largest portable cluster, walks each block's
    units in passes of whole float4 groups within the thread limit, and
    covers every unit, chunk of k and batch row exactly once within the
    shared memory."""
    D, max_clusters = 2, 15
    plan = gru_cuda.fwd_plan(B, H, D, max_clusters)
    assert plan.tier == "l2" and plan.KC > gru_cuda.MAX_KC
    assert plan.S == gru_cuda.L2_S and plan.C == gru_cuda.MAX_CLUSTER
    assert plan.KC % 8 == 0 and plan.S * plan.KC >= H > plan.S * (plan.KC - 8)
    assert plan.smem == gru_cuda._fwd_smem(plan.S, plan.KC, plan.BT) <= gru_cuda.SMEM_LIMIT
    assert plan.threads <= gru_cuda.L2_MAX_THREADS and plan.threads % (4 * plan.S) == 0
    per_pass = plan.threads // plan.S
    passes = -(-plan.U // per_pass)
    assert passes == -(-plan.U * plan.S // gru_cuda.L2_MAX_THREADS)
    units = np.concatenate([np.arange(c * plan.U + p * per_pass,
                                      min(c * plan.U + min((p + 1) * per_pass, plan.U), H))
                            for c in range(plan.C) for p in range(passes)])
    np.testing.assert_array_equal(units, np.arange(H))
    rows = np.concatenate([np.arange(t * plan.BT, min((t + 1) * plan.BT, B))
                           for t in range(plan.tiles)])
    np.testing.assert_array_equal(rows, np.arange(B))
    fewest = -(-D * -(-B // _fwd_rows_max(plan)) // max_clusters)
    assert -(-D * plan.tiles // max_clusters) == fewest


@pytest.mark.parametrize("H", [300, 64, 40, 5, 100, 161, 321, 600, 1024])
@pytest.mark.parametrize("B", [1, 5, 258, 512, 1024])
@pytest.mark.parametrize("max_clusters", [15, 7, 132])
def test_gru_bwd_plan(B, H, max_clusters):
    """The recurrence's launch takes the forward's tier (so it takes every H
    the forward takes) with two units a thread: every unit, every chunk of
    j and every batch row covered exactly once, within a block's shared
    memory (two g buffers of three gates and the dh z values), threads and
    cluster, in no more waves than the batch needs."""
    D = 2
    plan = gru_cuda.bwd_plan(B, H, D, max_clusters)
    assert plan.tier == gru_cuda.fwd_plan(B, H, D, max_clusters).tier
    assert (plan.tier == "registers") == (plan.KC <= gru_cuda.BWD_MAX_KC)
    assert plan.KC % 4 == 0 and plan.S * plan.KC >= H > plan.S * (plan.KC - 4)
    assert plan.C <= gru_cuda.MAX_CLUSTER and plan.U % 4 == 0
    assert plan.smem == gru_cuda._bwd_smem(plan.S, plan.KC, plan.U, plan.BT)
    assert plan.smem <= gru_cuda.SMEM_LIMIT and (gru_cuda._bwd_ks(plan.KC) // 4) % 2 == 1
    if plan.tier == "registers":
        assert plan.threads == -(-plan.U // 2 * plan.S // 32) * 32
        assert plan.threads <= gru_cuda.BWD_MAX_THREADS
        pairs, passes = plan.U // 2, 1
    else:
        assert plan.threads <= gru_cuda.BWD_L2_MAX_THREADS
        assert plan.threads % (4 * plan.S) == 0
        pairs = plan.threads // plan.S
        passes = -(-plan.U // (2 * pairs))
    units = np.concatenate([np.arange(c * plan.U + 2 * p * pairs,
                                      min(c * plan.U + min(2 * (p + 1) * pairs, plan.U), H))
                            for c in range(plan.C) for p in range(passes)])
    np.testing.assert_array_equal(units, np.arange(H))
    assert (plan.C - 1) * plan.U < H
    rows = np.concatenate([np.arange(t * plan.BT, min((t + 1) * plan.BT, B))
                           for t in range(plan.tiles)])
    np.testing.assert_array_equal(rows, np.arange(B))
    rows_max = gru_cuda.SMEM_LIMIT // gru_cuda._bwd_smem(plan.S, plan.KC, plan.U, 1)
    assert plan.BT <= rows_max
    assert -(-D * plan.tiles // max_clusters) == -(-D * -(-B // rows_max) // max_clusters)


def test_gru_bwd_plan_main_shapes():
    """H 300: the forward's clusters of 8 blocks of 40 units, 16 lanes a
    pair of units with 20 values of j each; a row of g (three gates) takes
    three rows of h, so B 512 runs in 22 tiles of 24 rows, three waves of
    the H100's 15 clusters; H 64 one block a tile, 4 lanes a pair."""
    assert gru_cuda.bwd_plan(512, 300, 2, 15)[:7] == (8, 40, 16, 20, 24, 22, 320)
    assert gru_cuda.bwd_plan(1, 300, 2, 15)[:7] == (8, 40, 16, 20, 1, 1, 320)
    assert gru_cuda.bwd_plan(512, 64, 2, 132)[:7] == (1, 64, 4, 16, 8, 64, 128)


@pytest.mark.parametrize("H", [300, 64, 321, 20, 1024])
@pytest.mark.parametrize("T,B", [(34, 512), (34, 5), (6, 1), (34, 258), (34, 1024)])
@pytest.mark.parametrize("sms", [132, 16])
def test_gru_dw_plan(T, B, H, sms):
    """The dW product's launch: every (t, b) row in exactly one split of
    whole pipeline stages, no split empty, every output of (H + 1, 3H) in
    one block tile, 16-byte copies only where H % 4 == 0."""
    plan = gru_cuda.dw_plan(T, B, H, 2, sms)
    M = T * B
    assert plan.rows % gru_cuda.DW_TK == 0 and plan.rows >= gru_cuda.DW_TK
    splits = [np.arange(s * plan.rows, min((s + 1) * plan.rows, M))
              for s in range(plan.splits)]
    assert all(len(s) for s in splits)
    np.testing.assert_array_equal(np.concatenate(splits), np.arange(M))
    assert plan.splits == 1 or plan.rows >= 256
    assert (plan.tiles_k - 1) * gru_cuda.DW_TM < H + 1 <= plan.tiles_k * gru_cuda.DW_TM
    assert (plan.tiles_j - 1) * gru_cuda.DW_TN < 3 * H <= plan.tiles_j * gru_cuda.DW_TN
    assert plan.vec == (4 if H % 4 == 0 else 1)
    assert gru_cuda.dw_plan(T, B, H, 2, sms, align=4).vec == 1


@pytest.mark.parametrize("H", [300, 64, 302, 301])
@pytest.mark.parametrize("align", [16, 8, 4, 2])
def test_gru_dw_plan_bf16_copy_width(H, align):
    """bf16 copies of 4 values (8 bytes) where H % 4 == 0 and every pointer
    is 8-byte aligned: at H 300 the second direction starts 600 bytes into
    a row of ys (900 values, 1800 bytes, into dxp), a multiple of 8 and not
    of 16, as is every row and tile offset; of 2 values (4 bytes) where
    H % 2 == 0 and the pointers are 4-byte aligned; else plain loads. The
    tiles and splits are the tensor-core product's (128 x 128 tiles, two
    blocks an SM in one wave, stages of 32 rows), whatever the copy
    width."""
    plan = gru_cuda.dw_plan(34, 512, H, 2, 132, align=align, itemsize=2)
    want = 4 if H % 4 == 0 and align % 8 == 0 else 2 if H % 2 == 0 and align % 4 == 0 else 1
    assert plan.vec == want
    assert plan[:4] == gru_cuda.dw_plan(34, 512, H, 2, 132, itemsize=2)[:4]
    assert plan.tiles_k == -(-(H + 1) // gru_cuda.DW_TC_K)
    assert plan.tiles_j == -(-3 * H // gru_cuda.DW_TC_J)
    blocks = plan.tiles_k * plan.tiles_j * 2 * plan.splits
    assert blocks <= gru_cuda.DW_TC_BLOCKS_PER_SM * 132 and plan.rows % gru_cuda.DW_TC_RK == 0
    for v in (H, 3 * H, 2 * H, 2 * 3 * H):   # direction and row offsets, in values
        assert (v * 2) % (2 * plan.vec) == 0 and v % plan.vec == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_biases_fold(dtype):
    """float32 passes b_ih and b_hh through; bf16 folds as the TPU kernels
    do: b_in = b_ih + [b_hh_r, b_hh_z, 0] added in bf16, b_rec = [0, 0,
    b_hh_n]; the walk layout's b_in (no b_ih) is [b_hh_r, b_hh_z, 0]."""
    H = 5
    g = torch.Generator().manual_seed(0)
    b_ih, b_hh = (torch.randn(2, 3 * H, generator=g).to(dtype) for _ in range(2))
    b_in, b_rec = gru_cuda.kernel_biases(b_ih, b_hh, H)
    walk_in, walk_rec = gru_cuda.kernel_biases(None, b_hh, H)
    if dtype == torch.float32:
        assert b_in is b_ih and b_rec is b_hh and walk_in is None and walk_rec is b_hh
        return
    assert b_in.dtype == b_rec.dtype == dtype
    assert torch.equal(b_in[:, :2 * H], b_ih[:, :2 * H] + b_hh[:, :2 * H])
    assert torch.equal(b_in[:, 2 * H:], b_ih[:, 2 * H:])
    assert torch.equal(b_rec, torch.cat([torch.zeros_like(b_hh[:, :2 * H]), b_hh[:, 2 * H:]], -1))
    assert torch.equal(walk_in[:, :2 * H], b_hh[:, :2 * H]) and not walk_in[:, 2 * H:].any()
    assert torch.equal(walk_rec, b_rec)


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
                                    (100, 6, 6), (330, 6, 5)])
def test_gru_fwd_model_against_plain_and_pallas(H, B, BT):
    """The chunked sums and the reduce-scatter agree with the plain time
    loop and with the JAX package's layer (Pallas in interpret mode) within
    1e-5 after 8 steps: float32 sums of H products in another order.
    (H, S, KC): (300, 8, 40), (64, 2, 32), (40, 2, 24), (100, 4, 32), and
    the L2 tier's (330, 8, 48), whose sums keep the register tier's order;
    the tiles put rows at every place of a group, and groups of one row."""
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


def _reduce(part, S, B, BT):
    """The kernels' reduce-scatter of the S lanes' chunk sums part (S, B,
    ...): each row's lanes added in the order its place in the group of S
    rows of a tile of BT gives (see `_gru_fwd_model`)."""
    b = np.arange(B)
    place = b % BT % S
    tile_rows = np.minimum(BT, B - b // BT * BT)
    alone = (b % BT == tile_rows - 1) & (b % BT % S == 0)

    def butterfly(part, halves):
        for half in halves:
            part = part + part[np.arange(S) ^ half]
        return part

    halves = [S >> i for i in range(1, S.bit_length())]
    return np.where(alone[:, None], butterfly(part, halves[::-1])[0],
                    butterfly(part, halves)[place, b])


def _gru_bwd_model(xp, w_hh, b_ih, hp, ys, dys, BT):
    """The backward recurrence kernel's arithmetic in float32 numpy: the
    cell's gates from xp + b_ih and the forward's hp, then for each unit k
    the S lanes' chunk sums of g . W^T (each gate's sum over the lane's KC
    values of j in ascending j, then r + z, + n), added across the lanes by
    the reduce-scatter, and carry = dh z of the step before + that total;
    zero g before the first step."""
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    S, KC, _, _ = gru_cuda.bwd_shape(H)
    f32 = np.float32
    dxp = np.zeros((T, B, D * 3 * H), f32)
    gn = np.zeros((T, B, D * H), f32)
    for d in range(D):
        dhz = np.zeros((B, H), f32)
        g = None
        for step in range(T):
            p = T - 1 - step if d == 0 else step
            q = p - 1 if d == 0 else p + 1
            h_prev = ys[q, :, d * H:(d + 1) * H] if 0 <= q < T else np.zeros((B, H), f32)
            tot = np.zeros((B, H), f32)
            if g is not None:
                part = np.zeros((S, B, H), f32)
                for s in range(S):
                    acc = np.zeros((3, B, H), f32)
                    for gate in range(3):
                        for j in range(s * KC, min((s + 1) * KC, H)):
                            col = gate * H + j
                            acc[gate] = acc[gate] + g[:, col:col + 1] * w_hh[d, :, col]
                    part[s] = (acc[0] + acc[1]) + acc[2]
                tot = _reduce(part, S, B, BT)
            dh = dys[p, :, d * H:(d + 1) * H] + (dhz + tot)
            x = xp[p, :, d * 3 * H:(d + 1) * 3 * H] + b_ih[d]
            hh = hp[p, :, d * 3 * H:(d + 1) * 3 * H]
            r = (1 / (1 + np.exp(-(x[:, :H] + hh[:, :H])))).astype(f32)
            z = (1 / (1 + np.exp(-(x[:, H:2 * H] + hh[:, H:2 * H])))).astype(f32)
            n = np.tanh(x[:, 2 * H:] + r * hh[:, 2 * H:]).astype(f32)
            dpre_n = dh * (1 - z) * (1 - n * n)
            dpre_z = dh * (h_prev - n) * z * (1 - z)
            dpre_r = dpre_n * hh[:, 2 * H:] * r * (1 - r)
            dxp[p, :, d * 3 * H:(d + 1) * 3 * H] = np.concatenate([dpre_r, dpre_z, dpre_n], 1)
            gn[p, :, d * H:(d + 1) * H] = dpre_n * r
            g = np.concatenate([dpre_r, dpre_z, dpre_n * r], 1).astype(f32)
            dhz = (dh * z).astype(f32)
    return dxp, gn


def _jax_bwd_v2(xp, w_hh, b_ih, b_hh, ys, dys):
    """dxp of the JAX package's backward kernel (`_bwd_call_v2`, Pallas in
    interpret mode) on the inputs padded as `run_layer_v2` pads them (each
    gate to P = 128 lanes, b_hh's r and z folded into the input bias), in
    the port's (T, B, D*3H) layout."""
    from speech2affective_gestures_tpu.ops import gru_pallas

    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    P = gru_pallas._round_up(H, gru_pallas.LANE)

    def pad_lanes(a, groups):  # (..., groups * H) -> (..., groups * P)
        out = np.zeros(a.shape[:-1] + (groups * P,), np.float32)
        for i in range(groups):
            out[..., i * P:i * P + H] = a[..., i * H:(i + 1) * H]
        return out

    w_cat = np.zeros((D, P, 3 * P), np.float32)
    w_cat[:, :H] = pad_lanes(w_hh, 3)
    bi, bh = b_ih.reshape(D, 3, H), b_hh.reshape(D, 3, H)
    b_all = pad_lanes(np.concatenate([bi[:, 0] + bh[:, 0], bi[:, 1] + bh[:, 1], bi[:, 2]], 1),
                      3)[:, None]
    b_hn = pad_lanes(bh[:, 2], 1)[:, None]
    dxp, _, _ = gru_pallas._bwd_call_v2(
        jnp.asarray(pad_lanes(xp.reshape(T, B, D, 3 * H), 3).reshape(T, B, D * 3 * P)),
        jnp.asarray(w_cat), jnp.asarray(b_all), jnp.asarray(b_hn),
        jnp.asarray(pad_lanes(ys.reshape(T, B, D, H), 1).reshape(T, B, D * P)),
        jnp.asarray(pad_lanes(dys.reshape(T, B, D, H), 1).reshape(T, B, D * P)),
        interpret=True)
    dxp = np.asarray(dxp).reshape(T, B, D, 3 * P)
    return np.concatenate([dxp[..., g * P:g * P + H] for g in range(3)], -1).reshape(T, B, -1)


def _bwd_inputs(H, B, T=8, D=2):
    rng = np.random.default_rng(7 * H + B)
    bound = H ** -0.5
    xp = rng.standard_normal((T, B, D * 3 * H)).astype(np.float32)
    w_hh, b_ih, b_hh = (rng.uniform(-bound, bound, shape).astype(np.float32)
                        for shape in ((D, H, 3 * H), (D, 3 * H), (D, 3 * H)))
    dys = rng.standard_normal((T, B, D * H)).astype(np.float32)
    return xp, w_hh, b_ih, b_hh, dys


@pytest.mark.parametrize("H,B,BT", [(300, 18, 18), (300, 9, 9), (64, 5, 5), (40, 3, 2),
                                    (100, 6, 6), (330, 6, 5)])
def test_gru_bwd_model_against_plain_and_pallas(H, B, BT):
    """The recurrence's chunked sums of g . W^T and the reduce-scatter
    agree with the plain reverse-time loop and with the JAX package's
    backward kernel (Pallas in interpret mode) within 1e-5 after 8 steps:
    float32 sums of 3H products in another order. (H, S, KC): (300, 16,
    20), (64, 4, 16), (40, 2, 20), (100, 8, 16) and the L2 tier's (330, 8,
    44); the tiles put rows at every place of a group, and groups of one
    row."""
    xp, w_hh, b_ih, b_hh, dys = _bwd_inputs(H, B)
    ys, _, hp = gru_cuda.gru_layer_plain(*map(torch.from_numpy, (xp, w_hh, b_ih, b_hh)),
                                         save_hp=True)
    ys, hp = ys.numpy(), hp.numpy()
    dxp, gn = _gru_bwd_model(xp, w_hh, b_ih, hp, ys, dys, BT)
    want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(
        *map(torch.from_numpy, (xp, w_hh, b_ih, b_hh, ys, dys, hp)))
    np.testing.assert_allclose(dxp, want_dxp.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gn, want_gn.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dxp, _jax_bwd_v2(xp, w_hh, b_ih, b_hh, ys, dys),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["model", "walk"])
@pytest.mark.parametrize("H,B", [(20, 3), (64, 5)])
def test_plain_recurrence_with_saved_hp_equals_the_recompute(layout, H, B):
    """The plain backward given the forward's hp gives the same bits as the
    plain backward that recomputes hp from ys: the same products on the
    same states."""
    xp, w_hh, b_ih, b_hh, dys = map(torch.from_numpy, _bwd_inputs(H, B, T=6))
    if layout == "model":
        ys, _, hp = gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=True)
        got = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
        want = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys)
    else:
        T, D = xp.shape[0], w_hh.shape[0]
        xw = gru_cuda._walk(xp.view(T, B, D, 3 * H) + b_ih, D).contiguous()
        ys, hp = gru_cuda.run_layer_forward(xw, w_hh, b_hh, save_hp=True)
        dyw = gru_cuda._walk(dys.view(T, B, D, H), D).contiguous()
        got = gru_cuda.run_layer_bwd_recurrence(xw, w_hh, b_hh, ys, dyw, hp)
        want = gru_cuda.run_layer_bwd_recurrence(xw, w_hh, b_hh, ys, dyw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


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


# ------------------------------------------------------------------------
# The bf16 kernels on the tensor cores: the forward's tensor tier and the
# dW product (`csrc/gru_fwd.cu` gru_layer_fwd_tc_kernel, `csrc/gru_bwd.cu`
# gru_dw_tc_kernel). The models below rebuild each warp's operands the way
# the kernels fetch them (the ldmatrix lane addresses, the W_hh fragments
# read in the forward's prologue), reassemble the mma.sync m16n8k16
# operands from the fragment layouts, check that they are the intended
# tiles, and then take the sums in the kernels' order of k16 steps and
# splits (float32 sums of exact bf16 products).

BF16 = torch.bfloat16


def _bf16(a) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _ldmatrix(smem, row, col, trans=False):
    """The four 8 x 8 matrices an ldmatrix.x4 gives each lane: lanes 8i ..
    8i + 7 address matrix i's rows at (row[l], col[l]); lane t receives
    regs[t, i, e] = matrix i's (row t // 4, column 2 (t % 4) + e), or with
    `trans` its (row 2 (t % 4) + e, column t // 4)."""
    t = np.arange(32)[:, None, None]
    i = np.arange(4)[None, :, None]
    e = np.arange(2)[None, None, :]
    if trans:
        src = 8 * i + 2 * (t % 4) + e
        return smem[row[src], col[src] + t // 4]
    src = 8 * i + t // 4
    return smem[row[src], col[src] + 2 * (t % 4) + e]


def _mma_a(regs):
    """The m16n8k16 A operand (16 x 16) from the lanes' a0..a3."""
    t, i, e = np.meshgrid(np.arange(32), np.arange(4), np.arange(2), indexing="ij")
    a = np.full((16, 16), np.nan, regs.dtype)
    a[t // 4 + 8 * (i % 2), 2 * (t % 4) + 8 * (i // 2) + e] = regs
    return a


def _mma_b(regs):
    """The m16n8k16 B operand (16 x 8) from the lanes' b0, b1."""
    t, i, e = np.meshgrid(np.arange(32), np.arange(2), np.arange(2), indexing="ij")
    b = np.full((16, 8), np.nan, regs.dtype)
    b[2 * (t % 4) + 8 * i + e, t // 4] = regs
    return b


def _mma_c_positions():
    """(row, column) of each lane's accumulator c0..c3 in the 16 x 8 tile."""
    t, e = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
    return t // 4 + 8 * (e // 2), 2 * (t % 4) + e % 2


def _check_tc_fwd_fragments(H, KC, C, U):
    """The forward's operands as the kernel fetches them, for every block,
    warp and k16 step, are the tiles the product needs: the h tile (rows
    of an m16 tile, k of the step) through ldmatrix from the lane address
    `a_off`, and for each gate the W_hh tile of the warp's 8 units (B
    fragments read in the prologue: lane (g, c) holds W[16 ks + 8 i + 2c +
    e][gate H + ju + g]). The lanes own the same (row, unit) positions in
    the three gates' accumulators, and the quad of lanes 4g .. 4g + 3 holds
    units 0-7 of rows g and g + 8 in order (the 16-byte exchange)."""
    KS = KC + 8
    lane = np.arange(32)
    h = np.arange(32 * KS, dtype=np.float64).reshape(32, KS)   # two m16 tiles, labelled
    a_row = (lane % 8) + 8 * ((lane // 8) % 2)
    a_col = 8 * (lane // 16)
    for mt in range(2):
        for ks in range(KC // 16):
            got = _mma_a(_ldmatrix(h, 16 * mt + a_row, 16 * ks + a_col))
            np.testing.assert_array_equal(got, h[16 * mt:16 * mt + 16, 16 * ks:16 * ks + 16])
    w = np.arange(KC * 3 * H, dtype=np.float64).reshape(KC, 3 * H)  # W_hh, k padded
    g, c = lane // 4, lane % 4
    for blk in range(C):
        for grp in range(U // 8):
            ju = blk * U + 8 * grp
            col = ju + g
            for gate in range(3):
                for ks in range(KC // 16):
                    regs = np.stack([np.stack([
                        np.where(col < H, w[16 * ks + 8 * i + 2 * c + e, gate * H + np.minimum(col, H - 1)], 0)
                        for e in range(2)], -1) for i in range(2)], 1)
                    want = np.zeros((16, 8))
                    units = ju + np.arange(8)
                    want[:, units < H] = w[16 * ks:16 * ks + 16, gate * H + units[units < H]]
                    np.testing.assert_array_equal(_mma_b(regs), want)
    rows, cols = _mma_c_positions()
    np.testing.assert_array_equal(rows, (lane // 4)[:, None] + 8 * (np.arange(4) // 2))
    np.testing.assert_array_equal(cols, 2 * (lane % 4)[:, None] + np.arange(4) % 2)
    quad_units = cols[(lane & ~3)[:, None] + np.arange(4)][..., :2].reshape(32, 8)
    np.testing.assert_array_equal(quad_units, np.tile(np.arange(8), (32, 1)))


def _tc_fwd_model(xp, w_hh, b_in, b_rec, plan):
    """The tensor tier's forward in numpy, bf16 storage as float32 values:
    per direction and batch tile (BT rows of `plan`), h in a zero-padded
    (rows rounded up to 16, k to KC) buffer; each step, per m16 tile and
    warp's 8 units, the three gates' products summed over the k16 steps in
    order (exact products, float32 sums: each step's 16 products, then the
    accumulator), two tiles of a warp at once, a tile alone summing its
    even and odd steps apart and adding the two at the end; then the gate
    update at the kernel's rounding points, units past H kept zero."""
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    KC, BT, C, U = plan.KC, plan.BT, plan.C, plan.U
    f32 = np.float32
    wpad = np.zeros((D, KC, 3, C * U), f32)           # columns in the warps' order
    wpad[:, :H, :, :H] = w_hh.reshape(D, H, 3, H)
    ys = np.zeros((T, B, D * H), f32)
    h_last = np.zeros((D, B, H), f32)
    for d in range(D):
        for b0 in range(0, B, BT):
            rows = min(BT, B - b0)
            n_mt = -(-rows // 16)
            h = np.zeros((16 * n_mt, KC), f32)
            for step in range(T):
                t = step if d == 0 else T - 1 - step
                hp = np.zeros((16 * n_mt, 3, C * U), f32)
                for mt0 in range(0, n_mt, 2):
                    pair = mt0 + 1 < n_mt
                    tiles = [mt0, mt0 + 1] if pair else [mt0]
                    for mt in tiles:
                        acc = np.zeros((2, 16, 3, C * U), f32)
                        for ks in range(KC // 16):
                            prod = np.einsum("rk,kgu->rgu", h[16 * mt:16 * mt + 16, 16 * ks:16 * ks + 16],
                                             wpad[d, 16 * ks:16 * ks + 16]).astype(f32)
                            acc[0 if pair else ks % 2] += prod
                        hp[16 * mt:16 * mt + 16] = acc[0] + acc[1]
                hp = hp[:rows, :, :H] + b_rec[d].reshape(3, H)
                x = xp[t, b0:b0 + rows, d * 3 * H:(d + 1) * 3 * H].reshape(rows, 3, H)
                xb = _bf16(x + b_in[d].reshape(3, H))
                r = (1 / (1 + np.exp(-(xb[:, 0] + hp[:, 0])))).astype(f32)
                z = (1 / (1 + np.exp(-(xb[:, 1] + hp[:, 1])))).astype(f32)
                n = np.tanh(xb[:, 2] + r * hp[:, 2]).astype(f32)
                hn = _bf16((1 - z) * n + z * h[:rows, :H])
                h[:rows, :H] = hn
                ys[t, b0:b0 + rows, d * H:(d + 1) * H] = hn
            h_last[d, b0:b0 + rows] = h[:rows, :H]
    return ys, h_last


@pytest.fixture()
def pallas_engine(monkeypatch):
    """JAX's GRU through its Pallas kernels in interpret mode, as
    tests/test_torch_bf16.py sets it (JAX's CPU scan engine computes its
    gates in bf16, which the TPU kernels do not)."""
    monkeypatch.setenv("S2AG_GRU_ENGINE", "pallas")
    monkeypatch.setenv("S2AG_GRU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("H", [300, 64, 40, 20])
@pytest.mark.parametrize("B,max_clusters", [(5, 2), (9, 2), (18, 2), (18, 4)])
def test_gru_fwd_tensor_model_against_plain_and_pallas(pallas_engine, H, B, max_clusters):
    """The tensor tier's data flow (fragments, padded k and rows, the
    interleaved r/z/n tiles of each warp's units, the lanes' positions)
    against `gru_layer_plain` at bf16 storage and the JAX package's layer
    (`run_layer_v2`, Pallas in interpret mode) on the same bf16 inputs,
    within 2e-2 absolute after 8 steps (`chip_smoke.BF16_TOL`: float32 sums
    in another order can flip one bf16 rounding, which carries into the
    later steps). `max_clusters` 2 puts B 18 in one tile of two m16 tiles,
    the second ragged (the pair path), and B 5 and 9 in one tile (a tile
    alone); 4 cuts B 18 into two ragged batch tiles of 9."""
    from speech2affective_gestures_tpu.ops import gru_pallas

    T, D = 8, 2
    plan = gru_cuda.fwd_plan(B, H, D, max_clusters, "tensor")
    assert plan.tier == "tensor"
    _check_tc_fwd_fragments(H, plan.KC, plan.C, plan.U)
    rng = np.random.default_rng(H + 10 * B)
    bound = H ** -0.5
    xp = _bf16(rng.standard_normal((T, B, D * 3 * H)))
    w_hh, b_ih, b_hh = (_bf16(rng.uniform(-bound, bound, shape))
                        for shape in ((D, H, 3 * H), (D, 3 * H), (D, 3 * H)))
    tx, tw, tbi, tbh = (torch.from_numpy(a).to(BF16) for a in (xp, w_hh, b_ih, b_hh))
    b_in, b_rec = (b.float().numpy() for b in gru_cuda.kernel_biases(tbi, tbh, H))
    ys, h_last = _tc_fwd_model(xp, w_hh, b_in, b_rec, plan)
    want_ys, want_h = gru_cuda.gru_layer_plain(tx, tw, tbi, tbh)
    np.testing.assert_allclose(ys, want_ys.float().numpy(), rtol=0, atol=2e-2)
    np.testing.assert_allclose(h_last, want_h.float().numpy(), rtol=0, atol=2e-2)
    P = gru_pallas._round_up(H, gru_pallas.LANE)
    padded = jnp.pad(jnp.asarray(xp).astype(jnp.bfloat16).reshape(T, B, D, 3, H),
                     [(0, 0)] * 4 + [(0, P - H)]).reshape(T, B, D * 3 * P)
    jys, jh = gru_pallas.run_layer_v2(padded, *(jnp.asarray(a).astype(jnp.bfloat16)
                                                for a in (w_hh, b_ih, b_hh)), interpret=True)
    jys = np.concatenate([np.asarray(jys.astype(jnp.float32))[..., d * P:d * P + H]
                          for d in range(D)], -1)
    np.testing.assert_allclose(ys, jys, rtol=0, atol=2e-2)
    np.testing.assert_allclose(h_last, np.asarray(jh.astype(jnp.float32)), rtol=0, atol=2e-2)


@pytest.mark.parametrize("H", [300, 64, 40, 20, 301, 1])
@pytest.mark.parametrize("B,max_clusters", [(258, 15), (512, 15), (512, 32), (5, 15),
                                            (1024, 15)])
def test_gru_fwd_tensor_plan(B, H, max_clusters):
    """bf16 in the register range (H <= 320) takes the tensor tier where
    B H^2 reaches TENSOR_MIN_WORK (at H 300 and 301 at B 258 and 512),
    float32 never, and the L2 tier is untouched. The plan: k padded to an
    instance's 16 KT >= H, U a multiple of 8 with the C blocks covering H
    once, one warp a unit group (at most 8 warps), every batch row in
    exactly one tile, its buffers whole m16 tiles within a block's shared
    memory, in no more waves than the batch needs; a lane's W_hh fragments
    (6 KT registers, at most 120) and two m16 tiles' accumulators (24)
    leave registers within 255."""
    D = 2
    tier = gru_cuda.fwd_tier(B, H, BF16)
    assert tier == ("tensor" if B * H * H >= gru_cuda.TENSOR_MIN_WORK else "registers")
    assert gru_cuda.fwd_tier(B, H, torch.float32) == "registers"
    assert gru_cuda.fwd_tier(B, 600, BF16) == gru_cuda.fwd_tier(B, 321, BF16) == "l2"
    if B >= 258 and H >= 300:
        assert tier == "tensor"
    plan = gru_cuda.fwd_plan(B, H, D, max_clusters, "tensor")
    KT = plan.KC // 16
    assert plan.KC % 16 == 0 and KT in gru_cuda.TENSOR_KT and plan.KC >= H
    assert plan.KC - 16 < H or KT == min(gru_cuda.TENSOR_KT)
    assert plan.U % 8 == 0 and (plan.C - 1) * plan.U < H <= plan.C * plan.U
    assert plan.C <= gru_cuda.MAX_CLUSTER and plan.U // 8 <= gru_cuda.TENSOR_MAX_GROUPS
    assert plan.S == 1 and plan.threads == 32 * plan.U // 8 <= gru_cuda.TENSOR_MAX_THREADS
    assert 6 * KT <= 120 and 6 * KT + 2 * 3 * 4 <= 255 - 64
    assert plan.smem == gru_cuda._tensor_smem(plan.KC, plan.BT) <= gru_cuda.SMEM_LIMIT
    assert plan.smem == 2 * 2 * (-(-plan.BT // 16) * 16) * (plan.KC + 8)
    rows = np.concatenate([np.arange(t * plan.BT, min((t + 1) * plan.BT, B))
                           for t in range(plan.tiles)])
    np.testing.assert_array_equal(rows, np.arange(B))
    rows_max = gru_cuda.SMEM_LIMIT // gru_cuda._tensor_smem(plan.KC, 16) * 16
    assert -(-D * plan.tiles // max_clusters) == -(-D * -(-B // rows_max) // max_clusters)


def test_gru_fwd_tensor_plan_main_shapes():
    """H 300: clusters of 8 blocks of 40 units (5 warps), k padded to 304;
    B 512 in 7 tiles of 74 rows (5 m16 tiles) on the H100's 15 clusters;
    H 64 two blocks of 32 units. The tiers PERF.md records: the bf16
    forward takes the tensor tier at H 300 from B 64 (the training and
    scoring batches), the register tier at B 1 (the service) and up to B 32,
    and at H 64 (the discriminator) at every batch."""
    assert gru_cuda.fwd_plan(512, 300, 2, 15, "tensor")[:8] == (8, 40, 1, 304, 74, 7, 160,
                                                               2 * 2 * 80 * 312)
    assert gru_cuda.fwd_plan(512, 64, 2, 15, "tensor")[:4] == (2, 32, 1, 64)
    for B, H, tier in ((1, 300, "registers"), (32, 300, "registers"), (64, 300, "tensor"),
                       (258, 300, "tensor"), (512, 300, "tensor"), (512, 64, "registers")):
        assert gru_cuda.fwd_tier(B, H, BF16) == tier, (B, H)
    with pytest.raises(ValueError):
        gru_cuda.fwd_plan(512, 321, 2, 15, "tensor")


def _check_tc_dw_fragments():
    """The dW product's operands as its warps fetch them with ldmatrix.trans
    from the M-major stage tiles (As[m][k], Bs[m][j]) are the m16n8k16
    operands of out[k][j] = sum_m As[m][k] Bs[m][j]: for warp (wk, wj) of
    the 2 x 4 (64 x 32 outputs each), k16 half kk, m16 tile mt and n8 tile
    nt, A = As[16 kk + .., 64 wk + 16 mt + ..]^T and B = Bs[16 kk + .., 32
    wj + 8 nt + ..]."""
    K, J, RK = gru_cuda.DW_TC_K, gru_cuda.DW_TC_J, gru_cuda.DW_TC_RK
    WK, WJ = 2, 4
    MT, NT = K // WK // 16, J // WJ // 8
    As = np.arange(RK * (K + 8), dtype=np.float64).reshape(RK, K + 8)
    Bs = np.arange(RK * (J + 8), dtype=np.float64).reshape(RK, J + 8)
    lane = np.arange(32)
    for warp in range(WK * WJ):
        wk, wj = warp // WJ, warp % WJ
        a_row = (lane % 8) + 8 * (lane // 16)
        a_col = 16 * MT * wk + 8 * ((lane // 8) % 2)
        b_row = (lane % 8) + 8 * ((lane // 8) % 2)
        b_col = 8 * NT * wj + 8 * (lane // 16)
        for kk in range(RK // 16):
            for mt in range(MT):
                got = _mma_a(_ldmatrix(As, 16 * kk + a_row, a_col + 16 * mt, trans=True))
                k0 = 16 * MT * wk + 16 * mt
                np.testing.assert_array_equal(got, As[16 * kk:16 * kk + 16, k0:k0 + 16].T)
            for np_ in range(NT // 2):
                regs = _ldmatrix(Bs, 16 * kk + b_row, b_col + 16 * np_, trans=True)
                for half in range(2):
                    j0 = 8 * NT * wj + 16 * np_ + 8 * half
                    np.testing.assert_array_equal(_mma_b(regs[:, 2 * half:2 * half + 2]),
                                                  Bs[16 * kk:16 * kk + 16, j0:j0 + 8])


def _tc_dw_model(ys, dxp, gn, D, plan):
    """The bf16 dW product in numpy (bf16 values as float32): per direction,
    split and block tile, the stages of DW_TC_RK rows staged as the kernel
    stages them (A = [h_prev | 1 | 0...] over DW_TC_K columns of k, G = [dxp_r,
    dxp_z, gn] over DW_TC_J columns of j, rows past the split zero), each k16
    half's exact products summed in float32 into the accumulators of the
    m16 x n8 tiles that reach the output (the others skipped), then the
    splits' partials added in split order."""
    T, B, _ = ys.shape
    H = ys.shape[2] // D
    K, J, RK = gru_cuda.DW_TC_K, gru_cuda.DW_TC_J, gru_cuda.DW_TC_RK
    f32 = np.float32
    M = T * B
    y = ys.reshape(T, B, D, H)
    prev = np.zeros_like(y)
    prev[1:, :, 0] = y[:-1, :, 0]
    if D == 2:
        prev[:-1, :, 1] = y[1:, :, 1]
    a_all = np.concatenate([prev.reshape(M, D, H), np.ones((M, D, 1), f32)], -1)
    g_all = np.concatenate([dxp.reshape(M, D, 3 * H)[..., :2 * H], gn.reshape(M, D, H)], -1)
    part = np.zeros((plan.splits, D, H + 1, 3 * H), f32)
    for s in range(plan.splits):
        lo, hi = s * plan.rows, min(M, (s + 1) * plan.rows)
        for d in range(D):
            for tk in range(plan.tiles_k):
                for tj in range(plan.tiles_j):
                    k0, j0 = tk * K, tj * J
                    acc = np.zeros((K, J), f32)
                    for m0 in range(lo, hi, RK):
                        At = np.zeros((RK, K), f32)
                        Gt = np.zeros((RK, J), f32)
                        m1 = min(hi, m0 + RK)
                        ka = a_all[m0:m1, d, k0:k0 + K]
                        At[:m1 - m0, :ka.shape[1]] = ka
                        gj = g_all[m0:m1, d, j0:j0 + J]
                        Gt[:m1 - m0, :gj.shape[1]] = gj
                        for kk in range(RK // 16):
                            acc += (At[16 * kk:16 * kk + 16].T.astype(np.float64)
                                    @ Gt[16 * kk:16 * kk + 16]).astype(f32)
                    live_k = (k0 + 16 * np.arange(K // 16) <= H).repeat(16)
                    live_j = (j0 + 8 * np.arange(J // 8) < 3 * H).repeat(8)
                    acc *= live_k[:, None] & live_j[None, :]
                    kn, jn = min(K, H + 1 - k0), min(J, 3 * H - j0)
                    part[s, d, k0:k0 + kn, j0:j0 + jn] = acc[:kn, :jn]
    total = part[0].copy()
    for s in range(1, plan.splits):
        total += part[s]
    return total[:, :H], total[:, H]


@pytest.mark.parametrize("H", [300, 301, 64])
@pytest.mark.parametrize("T,B", [(6, 215), (8, 160)])
def test_gru_dw_tensor_model_against_plain(H, T, B):
    """The bf16 dW product's tiling (the splits of whole stages, the 128 x
    128 tiles that cover the (H + 1, 3H) output once, the ones row giving
    db_hh, zeros past the data and the ragged last stage and tile, the
    fragments from ldmatrix.trans) against `gru_dw_plain` on the same bf16
    inputs, within 1e-5 of each output's largest value: exact products,
    float32 sums in another order. H 301 is odd (plain loads)."""
    _check_tc_dw_fragments()
    D = 2
    rng = np.random.default_rng(H + B)
    ys, gn = (_bf16(rng.standard_normal((T, B, D * H))) for _ in range(2))
    dxp = _bf16(rng.standard_normal((T, B, D * 3 * H)))
    plan = gru_cuda.dw_plan(T, B, H, D, 132, align=16, itemsize=2)
    assert plan.splits == 2 and plan.rows % gru_cuda.DW_TC_RK == 0
    assert plan.vec == (4 if H % 4 == 0 else 1)
    dw, db = _tc_dw_model(ys, dxp, gn, D, plan)
    want_dw, want_db = gru_cuda.gru_dw_plain(*(torch.from_numpy(a).to(BF16) for a in (ys, dxp, gn)), D)
    for got, want in ((dw, want_dw.numpy()), (db, want_db.numpy())):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the bf16 recurrence's tensor tier: g split into bf16 hi + lo, its K split
# over the cluster (csrc/gru_bwd.cu, gru_layer_bwd_tc_kernel)
# ---------------------------------------------------------------------------

def _g_split(g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's split of float32 g: hi = rn_bf16(g), lo = rn_bf16(g - hi)
    (g - hi is exact in float32)."""
    hi = _bf16(g)
    return hi, _bf16((g - hi).astype(np.float32))


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20, 3e-3])
def test_g_split_keeps_float32_g(scale):
    """hi + lo lies within 2^-16 of float32 g relative to |g| (2^-17 by
    construction: lo rounds the rest of g to bf16's 8 bits) over random
    magnitudes, tiny and large (e^+-8 around 1e-20 .. 1e20; only below
    ~1e-35, where lo turns subnormal, does the split lose bits, at absolute
    errors under 1e-38); hi alone, the single bf16 product's operand, lies
    up to 2^-9 away, which the split avoids."""
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    g = (rng.standard_normal(4096) * np.exp(rng.uniform(-8, 8, 4096)) * scale).astype(np.float32)
    hi, lo = _g_split(g)
    rel = np.abs((hi.astype(np.float64) + lo) - g) / np.abs(g)
    assert rel.max() <= 2.0 ** -16
    assert np.abs(hi.astype(np.float64) - g).max(initial=0) > 0
    assert (np.abs(hi.astype(np.float64) - g) / np.abs(g)).max() > 2.0 ** -12


def _tc_bwd_slices(H: int, C: int, U: int, KT: int) -> np.ndarray:
    """j(kk) of each block's slice of g: block c's column kk < 3U is gate kk
    // U of unit cU + kk % U, -1 where the slice holds a zero (past 3U or past
    H)."""
    kk = np.arange(16 * KT)
    gate, u = kk // U, kk % U
    j = np.full((C, 16 * KT), -1)
    for c in range(C):
        ok = (kk < 3 * U) & (c * U + u < H)
        j[c, ok] = gate[ok] * H + c * U + u[ok]
    return j


def _check_tc_bwd_fragments(H: int, plan):
    """The tensor tier's operands as the kernel fetches them are the tiles
    the K-split product needs. A: ldmatrix from a row of g laid out [hi (KL)
    | lo (KL) | 8 pad] at the lane address `a_off`, for hi and lo. B:
    lane (g, c) of n8 tile nt of warp nw holds W[n][j(kk)] for n = 8 (NT nw
    + nt) + g and kk = 16 ks + 8 i + 2c + e (zero past H and past the
    slice), the (16 x 8) tile W_slice[16 ks.., 8 tile..] of W_slice[kk][n]
    = W[n][j(kk)]. C: every output n < H is sent once per row, as the pair
    (n, n + 1) of one owner block n // U, at unit n % U."""
    C, U, NT, KT = plan.C, plan.U, plan.S, plan.KC // 16
    KL, KRS = 16 * KT, 32 * KT + 8
    lane = np.arange(32)
    g_rows = np.arange(32 * KRS, dtype=np.float64).reshape(32, KRS)  # two m16 tiles
    a_row = (lane % 8) + 8 * ((lane // 8) % 2)
    a_col = 8 * (lane // 16)
    for mt in range(2):
        for ks in range(KT):
            for half in (0, KL):
                got = _mma_a(_ldmatrix(g_rows, 16 * mt + a_row, half + 16 * ks + a_col))
                np.testing.assert_array_equal(
                    got, g_rows[16 * mt:16 * mt + 16, half + 16 * ks:half + 16 * ks + 16])
    nw_count, wm = gru_cuda._bwd_tensor_warps(H, NT)
    assert plan.threads == 32 * nw_count * wm
    w = np.arange(H * 3 * H, dtype=np.float64).reshape(H, 3 * H) + 1  # W[n][j], nonzero
    slices = _tc_bwd_slices(H, C, U, KT)
    g, c4 = lane // 4, lane % 4
    sent = np.zeros(H, int)
    rows, cols = _mma_c_positions()
    for c in range(C):
        w_slice = np.zeros((KL, 8 * NT * nw_count))
        ok = slices[c] >= 0
        w_slice[ok, :H] = w[:, slices[c][ok]].T
        for nw in range(nw_count):
            for nt in range(NT):
                tile = nw * NT + nt
                n = 8 * tile + g
                for ks in range(KT):
                    regs = np.zeros((32, 2, 2))
                    for i in range(2):
                        for e in range(2):
                            kk = 16 * ks + 8 * i + 2 * c4 + e
                            jj = slices[c][kk]
                            valid = (n < H) & (jj >= 0)
                            regs[:, i, e] = np.where(valid, w[np.minimum(n, H - 1),
                                                              np.maximum(jj, 0)], 0)
                    np.testing.assert_array_equal(
                        _mma_b(regs), w_slice[16 * ks:16 * ks + 16, 8 * tile:8 * tile + 8])
                if c == 0:
                    for t in range(32):
                        n0 = 8 * tile + cols[t, 0]
                        assert cols[t, 1] == cols[t, 0] + 1 and rows[t, 2] == rows[t, 0] + 8
                        if n0 < H:
                            assert n0 // U == (n0 + 1) // U and (n0 + 1) < C * U
                            if rows[t, 0] == 0:
                                sent[n0] += 1
                                if n0 + 1 < H:
                                    sent[n0 + 1] += 1
    np.testing.assert_array_equal(sent, np.ones(H, int))


def _tc_bwd_walk_model(x, hprev, dy, hps, w_hh, plan):
    """The tensor tier's recurrence in numpy, in walk order (bf16 storage as
    float32 values): x (T, D, B, 3H) with b_in added and rounded to bf16,
    hprev and dy (T, D, B, H), hps (T, D, B, 3H) float32, w_hh (D, H, 3H).
    Per direction and batch tile (BT rows), walking s = T - 1 .. 0: block
    c's partial of g . W^T over its slice of g, each k16 step's exact hi
    products and then its lo products added in float32 to the accumulator,
    the C partials added in cluster order onto 0, dh = dy + (dh z + that),
    the gate update at the kernel's rounding points, g split into hi and lo
    into each block's slice. Returns dx (T, D, B, 3H) and gn (T, D, B, H)
    (bf16 values)."""
    T, D, B, H3 = x.shape
    H = H3 // 3
    C, U, KT, BT = plan.C, plan.U, plan.KC // 16, plan.BT
    f32 = np.float32
    slices = _tc_bwd_slices(H, C, U, KT)
    dx = np.zeros(x.shape, f32)
    gn = np.zeros(dy.shape, f32)
    for d in range(D):
        w_slices = np.zeros((C, 16 * KT, H))
        for c in range(C):
            ok = slices[c] >= 0
            w_slices[c, ok] = w_hh[d][:, slices[c][ok]].T
        for b0 in range(0, B, BT):
            rb = slice(b0, min(B, b0 + BT))
            rows = rb.stop - b0
            g_hi = np.zeros((C, rows, 16 * KT), f32)
            g_lo = np.zeros((C, rows, 16 * KT), f32)
            dhz = np.zeros((rows, H), f32)
            for step in range(T):
                s = T - 1 - step
                tot = np.zeros((rows, H), f32)
                if step > 0:
                    for c in range(C):
                        acc = np.zeros((rows, H), f32)
                        for ks in range(KT):
                            k = slice(16 * ks, 16 * ks + 16)
                            for part in (g_hi, g_lo):
                                acc = (acc + (part[c][:, k].astype(np.float64)
                                              @ w_slices[c, k]).astype(f32)).astype(f32)
                        tot = (tot + acc).astype(f32)
                xs, hh = x[s, d, rb], hps[s, d, rb]
                dh = (dy[s, d, rb] + (dhz + tot)).astype(f32)
                r = (1 / (1 + np.exp(-(xs[:, :H] + hh[:, :H])))).astype(f32)
                z = (1 / (1 + np.exp(-(xs[:, H:2 * H] + hh[:, H:2 * H])))).astype(f32)
                n = np.tanh(xs[:, 2 * H:] + r * hh[:, 2 * H:]).astype(f32)
                dpre_n = (dh * (1 - z) * (1 - n * n)).astype(f32)
                dpre_z = (dh * (hprev[s, d, rb] - n) * z * (1 - z)).astype(f32)
                dpre_r = (dpre_n * hh[:, 2 * H:] * r * (1 - r)).astype(f32)
                dx[s, d, rb] = _bf16(np.concatenate([dpre_r, dpre_z, dpre_n], 1))
                gn[s, d, rb] = _bf16(dpre_n * r)
                hi, lo = _g_split(np.concatenate([dpre_r, dpre_z, dpre_n * r], 1).astype(f32))
                for c in range(C):
                    ok = slices[c] >= 0
                    g_hi[c][:, ok] = hi[:, slices[c][ok]]
                    g_lo[c][:, ok] = lo[:, slices[c][ok]]
                dhz = (dh * z).astype(f32)
    return dx, gn


def _tc_bwd_inputs(H, B, T, D, walk):
    """bf16 inputs (as float32 values) of the recurrence, the layer's
    forward run by the plain bf16 loop: model layout (xp, w_hh, b_ih, b_hh,
    ys, dys, hp) or walk layout (xp, w_hh, b_hh, ys, dys, hp)."""
    rng = np.random.default_rng(H + 10 * B + walk)
    bound = H ** -0.5
    w_hh, b_ih, b_hh = (_bf16(rng.uniform(-bound, bound, shape))
                        for shape in ((D, H, 3 * H), (D, 3 * H), (D, 3 * H)))
    t = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    if walk:
        xp = _bf16(rng.standard_normal((T, D, B, 3 * H)))
        dys = _bf16(rng.standard_normal((T, D, B, H)))
        ys, hp = gru_cuda.run_layer_forward(t(xp), t(w_hh), t(b_hh), save_hp=True)
        return xp, w_hh, None, b_hh, ys.float().numpy(), dys, hp.numpy()
    xp = _bf16(rng.standard_normal((T, B, D * 3 * H)))
    dys = _bf16(rng.standard_normal((T, B, D * H)))
    ys, _, hp = gru_cuda.gru_layer_plain(t(xp), t(w_hh), t(b_ih), t(b_hh), save_hp=True)
    return xp, w_hh, b_ih, b_hh, ys.float().numpy(), dys, hp.numpy()


def _jax_bwd_bf16(walk, xp, w_hh, b_ih, b_hh, dys):
    """dxp of the JAX package's backward kernel at bf16 (Pallas in interpret
    mode, the pallas_engine fixture's route): the vjp of `run_layer_v2`
    (`_bwd_call_v2`) in the model layout, of `run_layer` (`_bwd_call`) in
    the walk layout, on the same bf16 inputs with cotangent dys, as
    float32."""
    import jax

    from speech2affective_gestures_tpu.ops import gru_pallas

    j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    if walk:
        _, vjp = jax.vjp(lambda x: gru_pallas.run_layer(x, j(w_hh), j(b_hh),
                                                        interpret=True)[0], j(xp))
        return np.asarray(vjp(j(dys))[0].astype(jnp.float32))
    T, B, _ = xp.shape
    D, H, _ = w_hh.shape
    P = gru_pallas._round_up(H, gru_pallas.LANE)

    def layer(x):
        padded = jnp.pad(x.reshape(T, B, D, 3, H),
                         [(0, 0)] * 4 + [(0, P - H)]).reshape(T, B, D * 3 * P)
        ys, _ = gru_pallas.run_layer_v2(padded, j(w_hh), j(b_ih), j(b_hh), interpret=True)
        return jnp.concatenate([ys[:, :, d * P:d * P + H] for d in range(D)], -1)

    _, vjp = jax.vjp(layer, j(xp))
    return np.asarray(vjp(j(dys))[0].astype(jnp.float32))


@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("H", [300, 64, 40, 20])
@pytest.mark.parametrize("B,max_clusters", [(5, 2), (18, 2), (18, 4)])
def test_gru_bwd_tensor_model_against_plain_and_pallas(pallas_engine, walk, H, B, max_clusters):
    """The recurrence's tensor tier (the W^T fragments, the hi/lo split of
    g, g kept in the block that produced it and the outputs' partial sums
    exchanged, the sums in the kernel's order) against the plain bf16
    recurrence (`gru_bwd_recurrence_plain`, `run_layer_bwd_recurrence_plain`
    with the forward's hp) and the JAX package's backward kernel (the vjp of
    `run_layer_v2` or `run_layer` through Pallas in interpret mode) on the
    same bf16 inputs, within 2e-2 of the largest value after 8 steps
    (`chip_smoke.BF16_TOL`: float32 sums in another order can flip a bf16
    rounding of dxp). `max_clusters` 2 puts B 18 in one tile of two m16
    tiles, the second ragged, and B 5 in one ragged tile; 4 cuts B 18 into
    two tiles of 9."""
    T, D = 8, 2
    plan = gru_cuda.bwd_plan(B, H, D, max_clusters, "tensor")
    assert plan.tier == "tensor"
    _check_tc_bwd_fragments(H, plan)
    xp, w_hh, b_ih, b_hh, ys, dys, hp = _tc_bwd_inputs(H, B, T, D, walk)
    t = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    if walk:
        b_in, _ = gru_cuda.kernel_biases(None, t(b_hh), H)
        x = _bf16(xp + b_in.float().numpy()[:, None])
        hprev = np.concatenate([np.zeros_like(ys[:1]), ys[:-1]])
        dx, gn = _tc_bwd_walk_model(x, hprev, dys, hp, w_hh, plan)
        want = gru_cuda.run_layer_bwd_recurrence_plain(t(xp), t(w_hh), t(b_hh), t(ys), t(dys),
                                                       torch.from_numpy(hp))
    else:
        b_in, _ = gru_cuda.kernel_biases(t(b_ih), t(b_hh), H)
        def walked(a, n):
            return gru_cuda._walk(torch.from_numpy(a).view(T, B, D, n), D).numpy()
        x = _bf16(walked(xp, 3 * H) + b_in.float().numpy()[None, :, None])
        hprev = gru_cuda._walk(gru_cuda._prev_states(torch.from_numpy(ys), D), D).numpy()
        dxw, gnw = _tc_bwd_walk_model(x, hprev, walked(dys, H), walked(hp, 3 * H), w_hh, plan)
        dx = gru_cuda._unwalk(torch.from_numpy(dxw)).numpy()
        gn = gru_cuda._unwalk(torch.from_numpy(gnw)).numpy()
        want = gru_cuda.gru_bwd_recurrence_plain(t(xp), t(w_hh), t(b_ih), t(b_hh), t(ys), t(dys),
                                                 torch.from_numpy(hp))
    for got, ref in ((dx, want[0]), (gn, want[1])):
        ref = ref.float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    jdx = _jax_bwd_bf16(walk, xp, w_hh, b_ih, b_hh, dys)
    np.testing.assert_allclose(dx, jdx, rtol=0, atol=2e-2 * np.abs(jdx).max())


@pytest.mark.parametrize("H", [300, 301, 64, 40, 20, 1, 320])
@pytest.mark.parametrize("B,max_clusters", [(258, 15), (512, 15), (512, 16), (512, 32),
                                            (5, 15), (1024, 15)])
def test_gru_bwd_tensor_plan(B, H, max_clusters):
    """bf16 in the register range takes the recurrence's tensor tier from H
    BWD_TENSOR_MIN_H where B H^2 reaches BWD_TENSOR_MIN_WORK (H 300 and 301
    at B 258 and 512), float32 never, and past H 320 the L2 tier is untouched. The plan: C
    blocks of U units (U even, at most BWD_TENSOR_MAX_U) covering H once,
    the slice's 3U columns within 16 KT (an instance, KT <= 8), S = NT n8
    tiles a warp and warps in whole rows across the outputs within the
    block's limit, every batch row in exactly one tile, its shared memory
    (`_bwd_tensor_smem`: g hi and lo, both recv slots, dh z, whole m16
    tiles of g) within a block's, in no more waves than the batch needs; a
    lane's W^T fragments (2 KT NT registers) and accumulators (4 NT) leave
    room within the launch bound's registers."""
    D = 2
    tier = gru_cuda.bwd_tier(B, H, BF16)
    assert tier == ("tensor" if B * H * H >= gru_cuda.BWD_TENSOR_MIN_WORK
                    and H >= gru_cuda.BWD_TENSOR_MIN_H else "registers")
    assert gru_cuda.bwd_tier(B, H, torch.float32) == "registers"
    assert gru_cuda.bwd_tier(B, 321, BF16) == gru_cuda.bwd_tier(B, 600, BF16) == "l2"
    if B >= 258 and H >= 300:
        assert tier == "tensor"
    plan = gru_cuda.bwd_plan(B, H, D, max_clusters, "tensor")
    C, U, KT = gru_cuda.bwd_tensor_shape(H)
    assert (plan.C, plan.U, plan.KC, plan.S) == (C, U, 16 * KT, gru_cuda.BWD_TENSOR_NT)
    assert U % 2 == 0 and U <= gru_cuda.BWD_TENSOR_MAX_U and C <= gru_cuda.MAX_CLUSTER
    assert (C - 1) * U < H <= C * U and 3 * U <= 16 * KT < 3 * U + 16 and 1 <= KT <= 8
    nw, wm = gru_cuda._bwd_tensor_warps(H, plan.S)
    assert nw * plan.S * 8 >= H > (nw - 1) * plan.S * 8
    assert plan.threads == 32 * nw * wm <= 32 * gru_cuda.BWD_TENSOR_MAX_WARPS[plan.S]
    assert 2 * KT * plan.S + 4 * plan.S <= 128
    assert plan.smem == gru_cuda._bwd_tensor_smem(C, U, KT, plan.BT) <= gru_cuda.SMEM_LIMIT
    krs = 32 * KT + 8
    assert plan.smem >= 2 * plan.BT * krs + 4 * plan.BT * U * (2 * C + 1)
    assert plan.smem >= 2 * (-(-plan.BT // 16) * 16) * krs
    rows = np.concatenate([np.arange(t * plan.BT, min((t + 1) * plan.BT, B))
                           for t in range(plan.tiles)])
    np.testing.assert_array_equal(rows, np.arange(B))
    rows_max = max(r for r in range(1, 1024)
                   if gru_cuda._bwd_tensor_smem(C, U, KT, r) <= gru_cuda.SMEM_LIMIT)
    assert -(-D * plan.tiles // max_clusters) == -(-D * -(-B // rows_max) // max_clusters)
    with pytest.raises(ValueError):
        gru_cuda.bwd_plan(B, 321, D, max_clusters, "tensor")


def test_gru_bwd_tensor_plan_main_shapes():
    """H 300: clusters of 8 blocks of 38 units, a slice of 114 columns of g
    in 8 k16 steps, 10 warps of 4 n8 tiles; B 512 in 7 tiles of 74 rows on
    the H100's 14-15 clusters of 8 (one wave), 8 tiles of 64 on 16; H 64
    two blocks of 32 units. The tiers: the mixed-precision generator's
    recurrence (H 300, B 512, D 2) on the tensor cores, the service's
    batch-1 forward never backward, the discriminator's H 64 on the register
    tier, H 300 at B 1 and 5 (where the two tiers ran level) on the register
    tier and from B 16 on the tensor tier."""
    assert gru_cuda.bwd_plan(512, 300, 2, 15, "tensor")[:8] == (8, 38, 4, 128, 74, 7, 320,
                                                               74 * 528 + 4 * 74 * 38 * 17)
    assert gru_cuda.bwd_plan(512, 300, 2, 16, "tensor")[:6] == (8, 38, 4, 128, 64, 8)
    assert gru_cuda.bwd_plan(512, 64, 2, 15, "tensor")[:4] == (2, 32, 4, 96)
    for B, H, tier in ((512, 300, "tensor"), (258, 300, "tensor"), (16, 300, "tensor"),
                       (5, 300, "registers"), (1, 300, "registers"), (512, 64, "registers"),
                       (512, 40, "registers")):
        assert gru_cuda.bwd_tier(B, H, BF16) == tier, (B, H)
