"""The port's serving path against the JAX package's, at a small width
(hidden 32, 2 GRU layers, 30 words, 5 speakers), on the CPU.

Same weights (bridged), same audio and words, and the same per-window
noise: the JAX programs split their key once per window
(`train/synthesis.py:353`), and the speaker noise depends only on that
key, so the test replays the splits, runs the JAX generator on each key
and recovers eps = (z - mu) / exp(0.5 log_var). Tolerance 1e-4 absolute on
direction vectors and joint positions: float32 with sums in another order,
fed back autoregressively through up to 5 windows.
"""

import http.client
import json
import pathlib
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch import serve as tserve
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data.vocab import Vocab as TVocab
from speech2affective_gestures_torch.models.generator import PoseGenerator as TGen
from speech2affective_gestures_torch.train import synthesis as tsyn
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data.vocab import Vocab as JVocab
from speech2affective_gestures_tpu.models.generator import PoseGenerator as JGen
from speech2affective_gestures_tpu.train import synthesis as jsyn

KW = dict(n_words=30, n_speakers=5, hidden_size=32, n_layers=2)
JCFG = JConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2)
TCFG = TConfig(hidden_size_s2eg=32, n_layers=2)
WORDS = [["hello", 0.2, 0.6], ["world", 1.5, 2.0], ["again", 3.1, 3.5]]
REPO = pathlib.Path(__file__).resolve().parent.parent


def _vocabs():
    jv, tv = JVocab("w"), TVocab("w")
    for w in ("hello", "world", "again"):
        jv.index_word(w)
        tv.index_word(w)
    return jv, tv


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * C.AUDIO_SR)
    t = np.arange(n) / C.AUDIO_SR
    return (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jgen = JGen(**KW)
    zeros = (jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1)),
             jnp.zeros((1, C.N_POSES), jnp.int32),
             jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)))
    variables = jax.device_get(jax.jit(jgen.init)(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        *zeros, jnp.zeros((1,), jnp.int32)))
    tgen = TGen(**KW).eval()
    from_jax.load_jax(tgen, from_jax.pose_generator, variables)
    apply = jax.jit(jgen.apply)

    def eps_of(key, vid, n_windows):
        """JAX's per-window noise for one clip whose program starts at key."""
        out = []
        for _ in range(n_windows):
            key, sub = jax.random.split(key)
            _, z, mu, lv = jax.device_get(apply(
                variables, *zeros, jnp.asarray([vid]), rngs={"noise": sub}))
            out.append((z - mu) / np.exp(0.5 * lv))
        return np.concatenate(out)                      # (S, z_size)

    return jgen, variables, tgen, eps_of


def test_synthesize_clip_fused_matches_jax(models):
    jgen, variables, tgen, eps_of = models
    jv, tv = _vocabs()
    audio = _audio(10.0, 0)   # 5 windows, bucket 8
    fn = jsyn.make_fused_clip_fn(jgen.apply, JCFG)
    want_dv, want_ps = jsyn.synthesize_clip_fused(
        fn, variables, audio, WORDS, jv, JCFG, vid_idx=2, rng=jax.random.key(4))
    eps = eps_of(jax.random.key(4), 2, 5)[:, None]
    got_dv, got_ps = tsyn.synthesize_clip_fused(
        tgen, audio, WORDS, tv, TCFG, vid_idx=2, eps=torch.from_numpy(eps))
    assert got_dv.shape == want_dv.shape == (4 * 30 + 34, C.POSE_DIM)
    np.testing.assert_allclose(got_dv, want_dv, atol=1e-4)
    np.testing.assert_allclose(got_ps, want_ps, atol=1e-4)


def test_synthesize_clips_batched_matches_jax(models):
    """Three clips of different lengths (2, 4 and 5 windows) padded to
    bucket 8; the shorter clips' padded windows must not leak."""
    jgen, variables, tgen, eps_of = models
    jv, tv = _vocabs()
    clips = [(_audio(3.0, 1), WORDS[:1], 0), (_audio(7.5, 2), WORDS, 1),
             (_audio(10.0, 3), WORDS[1:], 4)]
    keys = jnp.stack([jax.random.key(10 + i) for i in range(3)])
    fn = jsyn.make_batched_clip_fn(jgen.apply, JCFG)
    want = jsyn.synthesize_clips_batched(fn, variables, clips, jv, JCFG, keys=keys,
                                         fade_out=[False, True, False])
    n_max = 5
    eps = np.stack([eps_of(jax.random.key(10 + i), vid, n_max)
                    for i, (_, _, vid) in enumerate(clips)], axis=1)
    got = tsyn.synthesize_clips_batched(tgen, clips, tv, TCFG,
                                        eps=torch.from_numpy(eps),
                                        fade_out=[False, True, False])
    assert [g[0].shape[0] for g in got] == [w[0].shape[0] for w in want]
    for (gdv, gps), (wdv, wps) in zip(got, want):
        np.testing.assert_allclose(gdv, wdv, atol=1e-4)
        np.testing.assert_allclose(gps, wps, atol=1e-4)


@pytest.fixture(scope="module")
def server(models):
    _, _, tgen, _ = models
    _, tv = _vocabs()
    service = tserve.SynthesisService(TCFG, tgen, tv)
    srv = tserve.serve(service, port=0)
    yield srv
    srv.shutdown()
    srv.server_close()


def _request(server, method, path, payload=None):
    conn = http.client.HTTPConnection(*server.server_address, timeout=120)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_http_synthesize_roundtrip(server):
    status, data = _request(server, "GET", "/healthz")
    assert status == 200 and data["device"] == "cpu"
    audio = _audio(4.0, 5)
    status, data = _request(server, "POST", "/synthesize", {
        "audio_b64": tserve.encode_f32_b64(audio), "words": WORDS[:2],
        "vid_idx": 1, "binary": True})
    assert status == 200
    dv = np.frombuffer(__import__("base64").b64decode(data["dir_vec_b64"]), "<f4")
    dv = dv.reshape(data["dir_vec_shape"])
    assert dv.shape == (64, C.POSE_DIM) and data["frames"] == 64
    assert np.isfinite(dv).all()
    assert data["poses_shape"] == [64, C.NUM_JOINTS, 3]


def test_http_synthesize_batch_roundtrip(server):
    status, data = _request(server, "POST", "/synthesize_batch", {"requests": [
        {"audio": _audio(2.0, 6).tolist(), "words": WORDS[:1]},
        {"audio": None, "words": WORDS, "vid_idx": 3, "fade_out": True},
    ]})
    assert status == 200
    frames = [r["frames"] for r in data["results"]]
    assert frames[0] == 34
    for r in data["results"]:
        assert np.asarray(r["dir_vec"]).shape == (r["frames"], C.POSE_DIM)
        assert np.isfinite(np.asarray(r["poses"])).all()
    status, data = _request(server, "GET", "/metrics")
    assert data["synthesize_batch"]["clips"] == 2


def test_http_errors(server):
    assert _request(server, "POST", "/synthesize", {"words": []})[0] == 400
    assert _request(server, "POST", "/stream/start", {})[0] == 404
    assert _request(server, "GET", "/bogus")[0] == 404


def test_auto_batching_coalesces_concurrent_requests(models):
    """Six threads (more than this host's share of cores) call /synthesize's
    entry at once; with a 200 ms window they coalesce into fewer batches,
    and every caller gets its own clip's frames."""
    _, _, tgen, _ = models
    _, tv = _vocabs()
    service = tserve.SynthesisService(TCFG, tgen, tv, auto_batch_ms=200.0)
    seconds = [2.0, 3.0, 4.5, 6.0, 2.5, 5.0]
    results, errors = [None] * len(seconds), []

    def call(i):
        try:
            results[i] = service.synthesize_auto(_audio(seconds[i], i), WORDS[:1])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(seconds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    for s, r in zip(seconds, results):
        n = len(tsyn.plan_subdivisions(s, TCFG)[0])
        assert r["frames"] == (n - 1) * 30 + 34
    m = service.metrics()["synthesize_batch"]
    assert m["clips"] == len(seconds) and m["requests"] < len(seconds)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tv = _vocabs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.SynthesisService.from_config(TCFG, tv, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--port", "0"])


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|speech2affective_gestures_tpu)\b",
                     re.M)
    files = sorted(f for f in (REPO / "speech2affective_gestures_torch").rglob("*.py")
                   if "_build" not in f.parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
