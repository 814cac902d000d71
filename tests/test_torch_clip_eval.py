"""The port's long-clip rendering (`train/clip_eval.py`) and seeded
synthesis against the JAX package's, on the CPU, at hidden 32 with 2 GRU
layers, on the synthetic corpus's vocabularies (20 words, 3 speakers).

Both packages build their test split from the same synthetic videos and
their generators carry the same weights (`convert/from_jax.py`). JAX draws
a clip's noise from its key, split into two (s2ag, TriModal) and then
once per window; the speaker noise depends only on that key, so the tests
replay the splits, run each JAX generator on each key and recover eps =
(z - mu) / exp(0.5 log_var), and the port's `clip_noise` is replaced by
that replay (the port's renderer draws all its noise there).

Tolerances: the stitched clips exactly; rendered poses, direction vectors
and the smoothed target 1e-4 absolute against JAX (float32, sums in
another order, fed back autoregressively through 5 windows, seeded with
the clip's first poses); the port's batched render against its per-clip
render 1e-4 (one batch-B forward against B batch-1 forwards); the seeded
stream against the seeded offline clip 1e-6.
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch import streaming as tstreaming
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.render import bvh as tbvh
from speech2affective_gestures_torch.train import clip_eval as tce
from speech2affective_gestures_torch.train import synthesis as tsyn
from speech2affective_gestures_torch.train.trainer import Trainer as TTrainer
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu import streaming as jstreaming
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data import ted_db as jdb
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import clip_eval as jce

JCFG = JConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2, batch_size=8)
TCFG = TConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2, batch_size=8)
N_JOINTS, N_FRAMES = 31, 240          # the GENEA clip: 8 s at 30 fps
AUDIO_LEN = int(C.N_POSES / 15 * C.AUDIO_SR)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both test splits, the JAX nets and a stand-in for JAX's trainer
    (what its `ClipRenderer` reads), the port's `Trainer` with the same
    weights, and `noise(seed, n)`: JAX's (s2ag, TriModal) eps of a clip
    whose key is key(seed)."""
    videos = jdb.make_synthetic_videos(n_videos=2, clip_seconds=10.0)
    jds = jdb.build_dataset_from_videos(videos, JCFG, keep_sidecars=True)
    tds = tdb.build_dataset_from_videos(videos, TCFG, keep_sidecars=True)
    assert tds.lang_model.word2index == jds.lang_model.word2index
    n_words, n_spk = jds.lang_model.n_words, jds.speaker_model.n_words
    gen, _, tri = jbuilder.build_models(JCFG, n_words, n_spk)
    pre = jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1))
    text, vid = jnp.zeros((1, C.N_POSES), jnp.int32), jnp.zeros((1,), jnp.int32)
    mfcc = jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH))
    wav = jnp.zeros((1, AUDIO_LEN))
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    gv = jax.device_get(jax.jit(gen.init)(rngs, pre, text, mfcc, vid))
    rngs["params"] = jax.random.key(2)
    tv = jax.device_get(jax.jit(tri.init)(rngs, pre, text, wav, vid))
    jtrainer = types.SimpleNamespace(
        cfg=JCFG, gen=gen, tri=tri, test_data=jds, variant="s2ag",
        logger=types.SimpleNamespace(print_log=lambda msg: None),
        state=types.SimpleNamespace(gen_params=gv["params"], gen_stats=gv["batch_stats"],
                                    tri_params=tv["params"], tri_stats=tv["batch_stats"]))
    ttrainer = TTrainer(TCFG, str(tmp_path_factory.mktemp("work")), test_data=tds,
                        device="cpu", seed=0)
    from_jax.load_jax(ttrainer.gen, from_jax.pose_generator, gv)
    from_jax.load_jax(ttrainer.tri, from_jax.pose_generator_trimodal, tv)

    applies = (jax.jit(gen.apply), jax.jit(tri.apply))

    def eps_of(which, key, n_windows):
        out = []
        for _ in range(n_windows):
            key, sub = jax.random.split(key)
            args = (pre, text, mfcc if which == 0 else wav, vid)
            _, z, mu, lv = jax.device_get(applies[which](
                (gv, tv)[which], *args, rngs={"noise": sub}))
            out.append((z - mu) / np.exp(0.5 * lv))
        return torch.from_numpy(np.stack(out))          # (S, 1, z)

    def noise(seed, n_windows, z_size=16):
        r1, r2 = jax.random.split(jax.random.key(seed))
        return eps_of(0, r1, n_windows), eps_of(1, r2, n_windows)

    return types.SimpleNamespace(jds=jds, tds=tds, jtrainer=jtrainer, ttrainer=ttrainer,
                                 gen=gen, gv=gv, apply=applies[0], noise=noise,
                                 eps_of=eps_of)


@pytest.fixture
def jax_noise(world, monkeypatch):
    monkeypatch.setattr(tce, "clip_noise", world.noise)


def test_stitch_test_clips_match_jax(world):
    got = list(tce.stitch_test_clips(world.tds))
    want = list(jce.stitch_test_clips(world.jds))
    assert [c["vid"] for c in got] == [c["vid"] for c in want] == [
        "synthetic_vid_0", "synthetic_vid_1"]
    for g, w in zip(got, want):
        assert g["frames"] == w["frames"] and g["time"] == w["time"]
        assert g["words"] == w["words"]
        assert g["poses"].dtype == w["poses"].dtype and g["audio"].dtype == w["audio"].dtype
        np.testing.assert_array_equal(g["poses"], w["poses"])
        np.testing.assert_array_equal(g["audio"], w["audio"])
    assert 6.0 < got[0]["time"][1] - got[0]["time"][0] < 10.0


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_render_clip_matches_jax(world, jax_noise, tmp_path):
    """The first clip, speaker 1, seeded with its own first poses, faded
    out, with pickles: both generators' poses and dir vecs and the
    smoothed target against JAX's `render_clip` with key(7)."""
    clip = next(tce.stitch_test_clips(world.tds))
    args = (clip["vid"], clip["poses"], clip["audio"], C.AUDIO_SR, clip["words"],
            clip["time"])
    kw = dict(speaker_vid_idx=1, clip_duration_range=(1, 30), fade_out=True, save_pkl=True)
    want = jce.ClipRenderer(world.jtrainer).render_clip(
        *args, save_path=str(tmp_path / "jax"), rng=jax.random.key(7), **kw)
    got = tce.ClipRenderer(world.ttrainer).render_clip(
        *args, save_path=str(tmp_path / "port"), seed=7, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        g, w = _load(tmp_path / "port" / name), _load(tmp_path / "jax" / name)
        assert sorted(g) == sorted(w)
        assert g["sentence"] == w["sentence"] and g["aux_info"] == w["aux_info"]
        for key in ("audio", "out_dir_vec", "out_poses", "human_dir_vec"):
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)
    # the seed poses are the clip's own, not zeros
    first = _load(tmp_path / "port" / names[0])["human_dir_vec"][:4] - TCFG.mean_dir_vec_array
    assert np.abs(first).max() > 1e-2


def test_batched_matches_per_clip(world, tmp_path):
    """`batched=True` gives the per-clip loop's clips, in its order, with
    the same speakers and noise, and the same pickles."""
    kwargs = dict(data_params={"clip_duration_range": [1, 30]}, randomized=True,
                  fade_out=True, seed=123)
    want = tce.generate_gestures_by_dataset(world.ttrainer, "ted_db", save_pkl=True,
                                            save_path=str(tmp_path / "one"), **kwargs)
    got = tce.generate_gestures_by_dataset(world.ttrainer, "ted_db", batched=True,
                                           save_pkl=True, save_path=str(tmp_path / "all"),
                                           **kwargs)
    assert [v for v, _ in got] == [v for v, _ in want] == ["synthetic_vid_0",
                                                           "synthetic_vid_1"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], atol=1e-4)
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "all")) and len(names) == 4
    for name in names:
        np.testing.assert_allclose(_load(tmp_path / "all" / name)["out_dir_vec"],
                                   _load(tmp_path / "one" / name)["out_dir_vec"], atol=1e-4)


def test_generate_matches_jax_draws(world, jax_noise):
    """With JAX's noise per clip key, the port's dataset loop (speakers and
    keys drawn from default_rng(5)) gives JAX's clips."""
    kwargs = dict(data_params={"clip_duration_range": [1, 30]}, randomized=True, seed=5)
    want = jce.generate_gestures_by_dataset(world.jtrainer, "ted_db", **kwargs)
    got = tce.generate_gestures_by_dataset(world.ttrainer, "ted_db", batched=True, **kwargs)
    assert [v for v, _ in got] == [v for v, _ in want]
    for (_, g), (_, w) in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_duration_filter_and_video_refusal(world):
    renderer = tce.ClipRenderer(world.ttrainer)
    res = renderer.render_clip("v", np.zeros((30, 10, 3), np.float32),
                               np.zeros(32000, np.float32), C.AUDIO_SR,
                               [["a", 0.1, 0.3], ["b", 0.5, 0.9]], [0.0, 2.0],
                               check_duration=True, clip_duration_range=(5, 30))
    assert res == (None, None, None)
    assert tce.generate_gestures_by_dataset(
        world.ttrainer, "ted_db", data_params={"clip_duration_range": [10, 12]}) == []
    with pytest.raises(ValueError, match="video"):
        tce.generate_gestures_by_dataset(world.ttrainer, "ted_db", batched=True,
                                         make_video=True)
    with pytest.raises(ValueError, match="unknown dataset"):
        tce.generate_gestures_by_dataset(world.ttrainer, "iemocap")


def test_make_video_without_matplotlib_raises(world, monkeypatch, tmp_path):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    clip = next(tce.stitch_test_clips(world.tds))
    with pytest.raises(ImportError, match="matplotlib"):
        tce.ClipRenderer(world.ttrainer).render_clip(
            clip["vid"], clip["poses"], clip["audio"], C.AUDIO_SR, clip["words"],
            clip["time"], clip_duration_range=(1, 30), make_video=True,
            save_path=str(tmp_path))


@pytest.fixture(scope="module")
def genea_dir(tmp_path_factory):
    """A GENEA-layout directory as the JAX package's GENEA test writes one,
    its BVH by the port's `save_as_bvh`: a 31-joint chain of unit offsets
    rotating about z, 8 s at 30 fps; a 16 kHz wav; a transcript."""
    from scipy.io import wavfile
    import json

    root = tmp_path_factory.mktemp("genea")
    for sub in ("audio", "bvh_raw", "transcripts"):
        os.makedirs(root / sub)
    offsets = np.zeros((N_JOINTS, 3), np.float32)
    offsets[1:, 1] = 1.0
    angles = 0.15 * np.sin(np.linspace(0, 6 * np.pi, N_FRAMES)[:, None]
                           + np.linspace(0, 2, N_JOINTS)[None, :])
    quats = np.zeros((N_FRAMES, N_JOINTS, 4), np.float32)
    quats[..., 0] = np.cos(angles / 2)
    quats[..., 3] = np.sin(angles / 2)
    positions = np.zeros((N_FRAMES, N_JOINTS, 3), np.float32)
    positions[:, 0, 1] = 10.0
    out = tbvh.save_as_bvh({"joint_names": [f"j{k}" for k in range(N_JOINTS)],
                            "joint_offsets": offsets,
                            "joint_parents": [-1] + list(range(N_JOINTS - 1)),
                            "positions": positions, "rotations": quats},
                           str(root / "tmp_bvh"), frame_time=1.0 / 30)
    os.replace(out, root / "bvh_raw" / "clip0.bvh")
    audio = 0.2 * np.sin(2 * np.pi * 220 * np.arange(8 * C.AUDIO_SR) / C.AUDIO_SR)
    wavfile.write(root / "audio" / "clip0.wav", C.AUDIO_SR, (audio * 32767).astype(np.int16))
    words = [{"word": w, "start_time": f"{s}s", "end_time": f"{e}s"}
             for w, s, e in (("hello", 0.5, 0.9), ("world", 3.0, 3.4))]
    with open(root / "transcripts" / "clip0.json", "w") as f:
        json.dump([{"alternatives": [{"words": words}]}], f)
    return str(root)


def test_genea_matches_jax(world, genea_dir, jax_noise, tmp_path):
    """The GENEA route (wav, BVH parse and FK, decade scaling, transcript)
    per clip and batched, against JAX's per-clip route with key(0)."""
    kwargs = dict(data_params={"data_path": genea_dir}, randomized=False, fade_out=True)
    want = jce.generate_gestures_by_dataset(world.jtrainer, "genea_challenge_2020", **kwargs)
    per_clip = tce.generate_gestures_by_dataset(world.ttrainer, "genea_challenge_2020",
                                                **kwargs)
    batched = tce.generate_gestures_by_dataset(world.ttrainer, "genea_challenge_2020",
                                               batched=True, save_pkl=True,
                                               save_path=str(tmp_path), **kwargs)
    assert [n for n, _ in want] == [n for n, _ in per_clip] == [n for n, _ in batched] == [
        "clip0"]
    w = want[0][1]
    for got in (per_clip[0][1], batched[0][1]):
        assert got[0].shape == w[0].shape == (121, 10, 3)  # 241 frames with the rest pose
        np.testing.assert_allclose(got[0], w[0], atol=1e-4)
        for g, ww in zip(got[1:], w[1:]):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, ww, atol=1e-4)
    assert sorted(os.listdir(tmp_path)) == ["clip0_s0_0.00_8.03_s2ag.pkl",
                                            "clip0_s0_0.00_8.03_trimodal.pkl"]


def test_genea_speaker_out_of_range_raises_before_synthesis(world, genea_dir, monkeypatch):
    """default_rng(1)'s first draw from [0, 100) is 47: past the 3
    speakers. The error names both numbers, and nothing is synthesized."""
    assert int(np.random.default_rng(1).integers(0, 100)) == 47

    def refuse(*args, **kwargs):
        raise AssertionError("synthesis ran")

    monkeypatch.setattr(tsyn, "synthesize_clips_batched", refuse)
    for batched in (False, True):
        with pytest.raises(ValueError, match=r"speaker id 47 .* 3 speakers"):
            tce.generate_gestures_by_dataset(world.ttrainer, "genea_challenge_2020",
                                             data_params={"data_path": genea_dir},
                                             randomized=True, seed=1, batched=batched)


def test_jax_renders_nan_for_an_out_of_range_speaker(world):
    """The JAX package's embedding lookup (`jnp.take`) fills an index past
    the table with NaN, so its GENEA route renders NaN poses for a drawn
    id at or above the speaker count (ROADMAP.md §3)."""
    pre = jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1))
    out, *_ = world.apply(world.gv, pre, jnp.zeros((1, C.N_POSES), jnp.int32),
                              jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)),
                              jnp.asarray([47]), rngs={"noise": jax.random.key(0)})
    assert np.isnan(np.asarray(out)).all()


def test_seeded_stream_matches_offline_and_jax(world):
    """`StreamingSynthesizer(seed_dir_vec=...)` in 0.5 s chunks equals
    `synthesize_clip_fused(seed_dir_vec=...)` with the same noise, and
    JAX's seeded stream with key(3)."""
    clip = next(tce.stitch_test_clips(world.tds))
    audio = clip["audio"][:8 * C.AUDIO_SR].astype(np.float32)
    words = [[w, s - clip["time"][0], e - clip["time"][0]] for w, s, e in clip["words"]]
    seed = np.random.default_rng(8).standard_normal((C.N_PRE_POSES, C.POSE_DIM))
    n = len(tsyn.plan_subdivisions(8.0, TCFG)[0])
    eps = world.eps_of(0, jax.random.key(3), n)
    gen, lang = world.ttrainer.gen.eval(), world.tds.lang_model
    stream = tstreaming.StreamingSynthesizer(gen, lang, TCFG, vid_idx=2, eps=eps,
                                             seed_dir_vec=seed)
    half = C.AUDIO_SR // 2
    frames = [stream.feed(audio[i:i + half], words if i == 0 else ())
              for i in range(0, len(audio), half)]
    got = np.concatenate(frames + [stream.flush()])
    offline, _ = tsyn.synthesize_clip_fused(gen, audio, words, lang, TCFG, vid_idx=2,
                                            eps=eps, seed_dir_vec=seed)
    zero_seed, _ = tsyn.synthesize_clip_fused(gen, audio, words, lang, TCFG, vid_idx=2,
                                              eps=eps)
    jstream = jstreaming.StreamingSynthesizer(world.gen.apply, world.gv,
                                              world.jds.lang_model, JCFG, vid_idx=2,
                                              seed_dir_vec=seed, rng=jax.random.key(3))
    want = np.concatenate([jstream.feed(audio, words), jstream.flush()])
    assert got.shape == offline.shape == want.shape
    np.testing.assert_allclose(got, offline, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the seed moves the clip by more than the tolerance against JAX
    assert np.abs(zero_seed - offline).max() > 1e-3
