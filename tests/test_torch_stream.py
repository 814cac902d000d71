"""The port's live streaming (`streaming.StreamingSynthesizer` and the
server's /stream/* endpoints) on the CPU, against the port's offline path
and the JAX package's stream, at the serving tests' widths (hidden 32, 2
GRU layers, 30 words, 5 speakers).

The JAX stream splits its key once per window; the speaker noise depends
only on that key, so the test replays the splits, runs the JAX generator
on each key and recovers eps = (z - mu) / exp(0.5 log_var) for the port,
as `tests/test_torch_serve.py` does for the offline path. Tolerance 1e-4
absolute on direction vectors, as there: float32 with sums in another
order (each window's MFCCs alone here, in one batch offline), fed back
autoregressively through up to 5 windows.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch import serve as tserve
from speech2affective_gestures_torch import streaming as tstreaming
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data.vocab import Vocab as TVocab
from speech2affective_gestures_torch.models.generator import PoseGenerator as TGen
from speech2affective_gestures_torch.train import synthesis as tsyn
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu import streaming as jstreaming
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data.vocab import Vocab as JVocab
from speech2affective_gestures_tpu.models.generator import PoseGenerator as JGen

KW = dict(n_words=30, n_speakers=5, hidden_size=32, n_layers=2)
JCFG = JConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2)
TCFG = TConfig(hidden_size_s2eg=32, n_layers=2)
WORDS = [["hello", 0.5, 1.0], ["world", 3.0, 3.5]]


def _vocabs():
    jv, tv = JVocab("w"), TVocab("w")
    for w in ("hello", "world"):
        jv.index_word(w)
        tv.index_word(w)
    return jv, tv


def _clip(seconds, seed=0):
    n = int(seconds * C.AUDIO_SR)
    t = np.arange(n) / C.AUDIO_SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)
            ).astype(np.float32)


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
        """JAX's per-window noise, (S, 1, z_size), for a stream from `key`."""
        out = []
        for _ in range(n_windows):
            key, sub = jax.random.split(key)
            _, z, mu, lv = jax.device_get(apply(
                variables, *zeros, jnp.asarray([vid]), rngs={"noise": sub}))
            out.append((z - mu) / np.exp(0.5 * lv))
        return torch.from_numpy(np.stack(out))

    return jgen, variables, tgen, eps_of


def _stream(stream, audio, chunk, words=WORDS):
    """Feed `audio` in `chunk`-sample pieces (the words with the first),
    then flush; returns every call's frames."""
    outs = [stream.feed(audio[i:i + chunk], words if i == 0 else ())
            for i in range(0, len(audio), chunk)]
    return outs + [stream.flush()]


@pytest.fixture(scope="module")
def jax_streams(models):
    """JAX's stream of an 8 s clip (a partial final window) and of a 2 s
    clip (shorter than one window: all in flush), one chunk each."""
    jgen, variables, _, _ = models
    jv, _ = _vocabs()
    out = {}
    for seconds in (8.0, 2.0):
        stream = jstreaming.StreamingSynthesizer(jgen.apply, variables, jv, JCFG, vid_idx=1,
                                                 rng=jax.random.key(3))
        out[seconds] = np.concatenate(_stream(stream, _clip(seconds), 10 ** 7))
    return out


@pytest.mark.parametrize("seconds,chunk", [(8.0, 4096), (8.0, 100000), (2.0, 1024)])
def test_stream_matches_offline_and_jax(models, jax_streams, seconds, chunk):
    _, _, tgen, eps_of = models
    _, tv = _vocabs()
    audio = _clip(seconds)
    n = len(tsyn.plan_subdivisions(seconds, TCFG)[0])
    eps = eps_of(jax.random.key(3), 1, n)
    stream = tstreaming.StreamingSynthesizer(tgen, tv, TCFG, vid_idx=1, eps=eps)
    got = np.concatenate(_stream(stream, audio, chunk))
    offline, _ = tsyn.synthesize_clip_fused(tgen, audio, WORDS, tv, TCFG, vid_idx=1, eps=eps)
    assert got.shape == offline.shape == jax_streams[seconds].shape
    np.testing.assert_allclose(got, offline, atol=1e-4)
    np.testing.assert_allclose(got, jax_streams[seconds], atol=1e-4)


def test_stream_emits_incrementally(models):
    """After the audio of window i, (i + 1) * stride frames are out (each
    window but the last withholds its n_pre-frame seam)."""
    _, _, tgen, _ = models
    _, tv = _vocabs()
    stream = tstreaming.StreamingSynthesizer(tgen, tv, TCFG, generator=torch.Generator())
    stride = TCFG.n_poses - TCFG.n_pre_poses
    audio = _clip(8.0)
    unit, step = stream.audio_len, int(stream.stride_time * C.AUDIO_SR)
    assert len(stream.feed(audio[:unit - 1], WORDS)) == 0
    assert len(stream.feed(audio[unit - 1:unit])) == stride
    assert len(stream.feed(audio[unit:unit + step])) == stride
    rest = stream.feed(audio[unit + step:])
    tail = stream.flush()
    n = len(tsyn.plan_subdivisions(8.0, TCFG)[0])
    assert 2 * stride + len(rest) + len(tail) == (n - 1) * stride + TCFG.n_poses


def test_stream_takes_a_late_word(models):
    """A word that arrives after its audio, before the window that covers
    it runs (here at flush), counts as one given up front."""
    _, _, tgen, _ = models
    _, tv = _vocabs()
    audio, late = _clip(4.0), [["world", 3.0, 3.5]]
    s1 = tstreaming.StreamingSynthesizer(tgen, tv, TCFG, generator=torch.Generator().manual_seed(5))
    a = np.concatenate([s1.feed(audio, late), s1.flush()])
    s2 = tstreaming.StreamingSynthesizer(tgen, tv, TCFG, generator=torch.Generator().manual_seed(5))
    b = np.concatenate([s2.feed(audio), s2.flush(late)])
    np.testing.assert_array_equal(a, b)
    s3 = tstreaming.StreamingSynthesizer(tgen, tv, TCFG, generator=torch.Generator().manual_seed(5))
    c = np.concatenate([s3.feed(audio), s3.flush()])
    assert np.abs(c - a).max() > 1e-6   # the word changes the last window


def test_stream_flush_twice_raises(models):
    _, _, tgen, _ = models
    _, tv = _vocabs()
    stream = tstreaming.StreamingSynthesizer(tgen, tv, TCFG)
    stream.feed(_clip(1.0))
    stream.flush()
    with pytest.raises(RuntimeError):
        stream.flush()
    with pytest.raises(RuntimeError):
        stream.feed(_clip(0.5))


def _post(server, path, payload):
    conn = http.client.HTTPConnection(*server.server_address, timeout=120)
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_http_stream_equals_synthesize(models):
    """/stream/start, /stream/feed in 0.5 s chunks (binary payloads) and
    /stream/flush give the service's clip for the same audio, words,
    speaker and noise (one draw from the stream's seed); /metrics counts
    the open streams; a flushed stream is gone."""
    _, _, tgen, _ = models
    _, tv = _vocabs()
    service = tserve.SynthesisService(TCFG, tgen, tv)
    server = tserve.serve(service, port=0)
    try:
        audio = _clip(5.0, 1)
        n_win = len(tsyn.plan_subdivisions(len(audio) / C.AUDIO_SR, TCFG)[0])
        eps = torch.randn(n_win, tgen.z_size, generator=torch.Generator().manual_seed(11))
        want = service.synthesize(audio, WORDS, vid_idx=2, eps=eps[:, None])
        status, started = _post(server, "/stream/start", {"vid_idx": 2, "seed": 11})
        assert status == 200
        sid = started["stream_id"]
        assert service.metrics()["active_streams"] == 1
        frames, half = [], C.AUDIO_SR // 2
        for i in range(0, len(audio), half):
            status, out = _post(server, "/stream/feed", {
                "stream_id": sid, "audio_b64": tserve.encode_f32_b64(audio[i:i + half]),
                "words": WORDS if i == 0 else [], "binary": True})
            assert status == 200
            frames.append(np.frombuffer(__import__("base64").b64decode(out["dir_vec_b64"]),
                                        "<f4").reshape(out["dir_vec_shape"]))
        status, out = _post(server, "/stream/flush", {"stream_id": sid})
        assert status == 200 and out["frames"] == len(out["dir_vec"])
        frames.append(np.asarray(out["dir_vec"], np.float32).reshape(-1, C.POSE_DIM))
        got = np.concatenate(frames)
        np.testing.assert_allclose(got, want["dir_vec"], atol=1e-5)
        assert service.metrics()["active_streams"] == 0
        assert _post(server, "/stream/feed", {"stream_id": sid, "audio": []})[0] == 400
    finally:
        server.shutdown()
        server.server_close()
