"""The port's PoseGenerator against the JAX package's, at a small width
(hidden 32, 2 GRU layers, 30 words, 5 speakers), eval mode.

The weights go JAX init -> the port's bridge -> load_state_dict(strict).
JAX draws the speaker noise from its flax 'noise' stream, which torch
cannot reproduce, so the test recovers JAX's eps as (z - mu) /
exp(0.5 log_var) and hands it to the torch forward. Tolerance 5e-5
absolute: float32 on both sides through ~12 stacked layers and a 34-step
recurrence, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.models.generator import PoseGenerator as TGen
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.convert import jax_to_torch
from speech2affective_gestures_tpu.models.generator import PoseGenerator as JGen

KW = dict(n_words=30, n_speakers=5, hidden_size=32, n_layers=2)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    pre = np.zeros((batch, C.N_POSES, C.POSE_DIM + 1), np.float32)
    pre[:, :4, :-1] = rng.standard_normal((batch, 4, C.POSE_DIM)) * 0.3
    pre[:, :4, -1] = 1.0
    text = rng.integers(0, KW["n_words"], (batch, C.N_POSES))
    mfcc = rng.standard_normal((batch, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)) * 0.05
    vid = rng.integers(0, KW["n_speakers"], (batch,))
    return pre, text, mfcc.astype(np.float32), vid


@pytest.fixture(scope="module")
def pair():
    jgen = JGen(**KW)
    pre, text, mfcc, vid = _inputs(1)
    variables = jax.device_get(jax.jit(jgen.init)(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.asarray(pre), jnp.asarray(text), jnp.asarray(mfcc), jnp.asarray(vid)))
    # non-trivial BN running stats, so eval-mode normalization is exercised
    rng = np.random.default_rng(7)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                 + (1.0 if k == "var" else 0.0)) for k, v in tree.items()}

    variables = dict(variables, batch_stats=perturb(variables["batch_stats"]))
    tgen = TGen(**KW).eval()
    from_jax.load_jax(tgen, from_jax.pose_generator, variables)
    return jgen, variables, tgen


def test_bridged_keys_match_reference_converter(pair):
    _, variables, tgen = pair
    ours = set(from_jax.pose_generator(variables))
    assert ours == set(jax_to_torch.pose_generator_inv(variables))
    assert ours == set(tgen.state_dict())


@pytest.mark.parametrize("batch", [1, 3])
def test_forward_matches_jax(pair, batch):
    jgen, variables, tgen = pair
    pre, text, mfcc, vid = _inputs(batch, seed=batch)
    out, z, mu, log_var = jax.device_get(jax.jit(jgen.apply)(
        variables, jnp.asarray(pre), jnp.asarray(text), jnp.asarray(mfcc),
        jnp.asarray(vid), rngs={"noise": jax.random.key(5)}))
    eps = (z - mu) / np.exp(0.5 * log_var)
    with torch.no_grad():
        got, tz, tmu, tlv = tgen(torch.from_numpy(pre), torch.from_numpy(text),
                                 torch.from_numpy(mfcc), torch.from_numpy(vid),
                                 eps=torch.from_numpy(eps))
    assert got.shape == (batch, C.N_POSES, C.POSE_DIM)
    np.testing.assert_allclose(tmu.numpy(), mu, atol=1e-6)
    np.testing.assert_allclose(tlv.numpy(), log_var, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), z, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), out, atol=5e-5)


def test_noise_from_generator_is_reproducible(pair):
    _, _, tgen = pair
    pre, text, mfcc, vid = (torch.from_numpy(a) for a in _inputs(2))
    with torch.no_grad():
        a = tgen(pre, text, mfcc, vid, generator=torch.Generator().manual_seed(3))
        b = tgen(pre, text, mfcc, vid, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_config_from_yaml_matches_jax():
    from speech2affective_gestures_torch.config import ModelConfig as TConfig
    from speech2affective_gestures_tpu.config import ModelConfig as JConfig

    path = "config/multimodal_context_v2.yml"
    t, j = TConfig.from_yaml(path), JConfig.from_yaml(path)
    for name in ("num_mfcc", "wordembed_dim", "dropout_prob", "n_layers",
                 "hidden_size_s2eg", "z_type", "input_context", "n_poses",
                 "n_pre_poses", "motion_resampling_framerate",
                 "expected_audio_length", "num_mfcc_combined", "mfcc_length"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.mean_dir_vec_array, j.mean_dir_vec_array)
    np.testing.assert_array_equal(t.mean_pose_array, j.mean_pose_array)


@pytest.mark.parametrize("field,value", [("input_context", "audio"), ("z_type", "random")])
def test_build_generator_rejects_unported_variants(field, value):
    """Every input context and z type of the JAX package is ported (the
    grid against JAX is tests/test_torch_ablations.py): the setting builds,
    and a name outside the JAX package's choices, or an unknown variant,
    raises a ValueError."""
    from speech2affective_gestures_torch.config import ModelConfig as TConfig
    from speech2affective_gestures_torch.models.generator import build_generator

    cfg = TConfig(hidden_size_s2eg=32, n_layers=2, **{field: value})
    gen = build_generator(cfg, 30, 5, device="cpu")
    assert getattr(gen, field) == value
    with pytest.raises(ValueError, match=field):
        build_generator(TConfig(hidden_size_s2eg=32, n_layers=2, **{field: "other"}),
                        30, 5, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        build_generator(cfg, 30, 5, device="cpu", variant="abl_other")
