"""The port's two kernel modules on the CPU: their plain versions against
the TPU kernels they replace (Pallas in interpret mode) and the JAX
front-end. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda_kernels.py.

Tolerances: the mel power is a sum of ~2000 products per bin with values up
to ~1e3, so it is compared relative to the largest output (1e-5), and each
value also against its own magnitude (1e-4, plus 1e-8 of the largest value
for values near zero), so that the quiet bands, which feed the MFCC
through an 80 dB range, are held too; the MFCC
features pass through log10 and a DCT, compared at 2e-4 absolute as the
JAX package's own test does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.ops import dsp as tdsp
from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.ops import dsp as jdsp
from speech2affective_gestures_tpu.ops import dsp_pallas


def _chirp(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.4 * np.sin(2 * np.pi * (200 + 40 * t) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _frames(rows, seed=0):
    """Hann-windowed frames of a chirp, the kernel's real input."""
    y = torch.from_numpy(_chirp(C.EXPECTED_AUDIO_LENGTH * 2, seed))
    return tdsp.windowed_frames(y).reshape(-1, 2048)[:rows].contiguous()


@pytest.mark.parametrize("rows", [3, 71, 142])
def test_mel_power_plain_against_pallas(rows):
    """3 rows is the ragged-edge case of tests/test_dsp_pallas.py; 71 is
    one window, 142 two."""
    frames = _frames(rows)
    want = np.asarray(dsp_pallas.fused_mel_power_frames(
        jnp.asarray(frames.numpy()), interpret=True))
    got = mel_cuda.mel_power(frames).numpy()
    assert got.shape == (rows, 128)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8 * np.abs(want).max())
    assert sum(mel_cuda.launches.values()) == 0  # CPU tensors take the plain version


def test_mel_spectrogram_against_jax():
    y = _chirp(C.EXPECTED_AUDIO_LENGTH)
    want = np.asarray(jdsp.mel_power_spectrogram(jnp.asarray(y)))
    got = tdsp.mel_power_spectrogram(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8 * np.abs(want).max())


def test_frame_signal_against_jax():
    y = _chirp(5000)
    want = np.asarray(jdsp.frame_signal(jnp.asarray(y), 2048, 512))
    got = tdsp.frame_signal(torch.from_numpy(y), 2048, 512).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fast", [False, True])
def test_mfcc_features_against_jax(fast):
    ys = np.stack([_chirp(C.EXPECTED_AUDIO_LENGTH, s) for s in range(3)])
    want = np.asarray(jdsp.get_mfcc_features(jnp.asarray(ys)))
    fn = tdsp.get_mfcc_features_fast if fast else tdsp.get_mfcc_features
    got = fn(torch.from_numpy(ys)).numpy()
    assert got.shape == (3, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_power_to_db_per_window_clamp():
    s = torch.tensor([[[1e-12, 1.0], [1e3, 1e-9]], [[1.0, 1.0], [1e-12, 2.0]]])
    want = np.asarray(jdsp.power_to_db(jnp.asarray(s.numpy()), max_axes=(-2, -1)))
    np.testing.assert_allclose(tdsp.power_to_db(s, max_axes=(-2, -1)).numpy(),
                               want, rtol=1e-6)


def test_wrappers_reject_other_devices():
    meta = torch.empty((4, 2048), device="meta")
    with pytest.raises(ValueError):
        mel_cuda.mel_power(meta)
    with pytest.raises(ValueError):
        gru_cuda.gru_layer(torch.empty((2, 1, 6), device="meta"),
                           torch.empty((1, 2, 6), device="meta"),
                           torch.empty((1, 6), device="meta"),
                           torch.empty((1, 6), device="meta"))
