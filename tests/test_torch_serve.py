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
    assert _request(server, "POST", "/stream/feed", {"stream_id": "nope", "audio": []})[0] == 400
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


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tv = _vocabs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.SynthesisService.from_config(TCFG, tv, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["-b", str(tmp_path), "-c", str(REPO / "config/multimodal_context_v2.yml"),
                     "--synthetic-data", "true", "--port", "0"])


def test_port_imports_no_jax():
    """Neither the port, chip_smoke.py nor the port's test workers (which
    the card's tests import) import jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|speech2affective_gestures_tpu)\b",
                     re.M)
    files = sorted(f for f in (REPO / "speech2affective_gestures_torch").rglob("*.py")
                   if "_build" not in f.parts)
    files += [REPO / "chip_smoke.py", REPO / "tests/_data_parallel_worker.py",
              REPO / "tests/_mesh_2d_worker.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


# ------------------------------------------- serving a trained checkpoint

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`main_v2` on the CPU, one epoch at hidden 32 and word embedding 32
    with the paper's 4 layers (the JAX package's reader of a torch
    checkpoint takes 4 TCN levels), from a raw-level export archive of
    four synthetic videos split 2 / 1 / 1: the train split has 2 speakers
    (speaker vocabulary of 3), the test split 1 (of 2)."""
    import gzip
    import pickle

    import yaml
    from speech2affective_gestures_torch import main_v2 as tmain
    from speech2affective_gestures_torch.data import ted_db as tdb

    tmp = tmp_path_factory.mktemp("trained")
    raw = yaml.safe_load(open(REPO / "config/multimodal_context_v2.yml"))
    raw.update(hidden_size=32, hidden_size_s2eg=32, n_layers=4, wordembed_dim=32,
               random_seed=3, loss_warmup=-1)
    cfg_path = tmp / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    arch = tmp / "arch"
    arch.mkdir()
    videos = tdb.make_synthetic_videos(4, 6.0)
    manifest = {"level": "raw", "num_mfcc": 14, "splits": {}}
    for split, vids in {"train": videos[:2], "val": videos[2:3], "test": videos[3:]}.items():
        with gzip.open(arch / f"{split}_0000.pkl.gz", "wb") as f:
            pickle.dump(vids, f, protocol=4)
        manifest["splits"][split] = {"shards": 1, "records": len(vids)}
    (arch / "manifest.json").write_text(json.dumps(manifest))
    base = tmp / "base"
    trainer = tmain.main(["-b", str(base), "-c", str(cfg_path), "--packed-data", str(arch),
                          "--device", "cpu", "--batch-size", "8", "--s2ag-num-epoch", "1"])
    ckpt = next((base / "models/s2ag_v2_mfcc_torch/ted_db").glob("epoch_*.pth.tar"))
    argv = ["-b", str(base), "-c", str(cfg_path), "--packed-data", str(arch),
            "--device", "cpu"]
    return argv, trainer, ckpt, cfg_path, arch


def _corpus_words(lang, seconds):
    """Words of the corpus's vocabulary, one every 0.6 s."""
    words = [w for w in lang.word2index if not w.startswith("<")]
    return [[words[i % len(words)], 0.2 + 0.6 * i, 0.5 + 0.6 * i]
            for i in range(int((seconds - 0.5) / 0.6))]


def test_build_service_serves_best_with_the_corpus_vocabulary(trained):
    """`build_service` loads the best checkpoint of `main_v2`'s work dir
    into a generator sized from it (3 speakers, where the test split alone
    has 2) and serves with the corpus's vocabulary: a request's words get
    their dataset ids, none <UNK>."""
    argv, trainer, ckpt, _, _ = trained
    service = tserve.build_service(argv)
    want = from_jax.strip_module_prefix(torch.load(ckpt, weights_only=True)["gen_model_dict"])
    got = service.gen.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert service.gen.speaker_embedding[0].weight.shape[0] == 3
    assert service.lang.word2index == trainer.train_data.lang_model.word2index
    words = _corpus_words(service.lang, 10.0)
    _, text, _ = tsyn.prepare_window_inputs(_audio(10.0, 7), words, service.lang, service.cfg)
    ids = set(text[text != 0].tolist())   # a word in two windows counts once
    assert TVocab.UNK_token not in ids
    assert ids == {service.lang.word2index[w] for w, _, _ in words}
    out = service.synthesize(_audio(10.0, 7), words, vid_idx=2)
    assert out["dir_vec"].shape == (4 * 30 + 34, C.POSE_DIM) and np.isfinite(out["poses"]).all()


def test_build_service_refuses_random_weights(trained, tmp_path):
    """No checkpoint in the work dir: SystemExit, unless
    `--s2ag-load-last-best false` asks for random weights."""
    argv, _, _, cfg_path, arch = trained
    empty = ["-b", str(tmp_path / "empty"), "-c", str(cfg_path), "--packed-data", str(arch),
             "--device", "cpu"]
    with pytest.raises(SystemExit, match="no checkpoint found"):
        tserve.build_service(empty)
    service = tserve.build_service(empty + ["--s2ag-load-last-best", "false"])
    assert service.gen.speaker_embedding[0].weight.shape[0] == 2   # the test split's
    assert np.isfinite(service.synthesize(_audio(3.0, 8), WORDS)["dir_vec"]).all()


def test_trained_checkpoint_served_like_jax(trained):
    """The port's checkpoint served by the port (`build_service`) and by the
    JAX package (`Trainer.load_torch_checkpoint`, then
    `SynthesisService.from_trainer`), with the same noise: the same clip
    within 1e-4, as `test_synthesize_clip_fused_matches_jax`. The JAX
    trainer is sized from the train split; sized from the test split alone
    (as the JAX package's serve.main sizes it) it cannot run the weights
    (ROADMAP.md, faults: flax's ScopeParamShapeError)."""
    import flax
    from speech2affective_gestures_tpu.data import ted_db as jdb
    from speech2affective_gestures_tpu.serve import SynthesisService as JService
    from speech2affective_gestures_tpu.train.trainer import Trainer as JTrainer

    argv, _, ckpt, cfg_path, arch = trained
    jcfg = JConfig.from_yaml(str(cfg_path))
    jsplits = jdb.load_exported_data(str(arch), jcfg)
    work = str(ckpt.parent.parent / "jax")
    # the JAX reader (convert/torch_ckpt.py:420-428) takes every dict of the
    # blob for a flat state dict, which the Adam states that the port's
    # checkpoint also carries are not: it gets the weights alone
    weights = ckpt.parent.parent / "weights.pth.tar"
    blob = torch.load(ckpt, weights_only=True)
    torch.save({k: blob[k] for k in ("gen_model_dict", "dis_model_dict")}, weights)
    jtrainer = JTrainer(jcfg, work, train_data=jsplits["train"], test_data=jsplits["test"])
    jtrainer.load_torch_checkpoint(str(weights))
    jsvc = JService.from_trainer(jtrainer)
    audio = _audio(10.0, 9)
    words = _corpus_words(jsvc.lang, 10.0)
    want_dv, want_ps = jsyn.synthesize_clip_fused(jsvc.clip_fn, jsvc.variables, audio, words,
                                                  jsvc.lang, jcfg, vid_idx=1,
                                                  rng=jax.random.key(4))
    apply = jax.jit(jtrainer.gen.apply)
    zeros = (jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1)), jnp.zeros((1, C.N_POSES), jnp.int32),
             jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)))
    key, eps = jax.random.key(4), []
    for _ in range(5):
        key, sub = jax.random.split(key)
        _, z, mu, lv = jax.device_get(apply(jsvc.variables, *zeros, jnp.asarray([1]),
                                            rngs={"noise": sub}))
        eps.append((z - mu) / np.exp(0.5 * lv))
    service = tserve.build_service(argv)
    got = service.synthesize(audio, words, vid_idx=1,
                             eps=torch.from_numpy(np.stack(eps)))
    assert got["dir_vec"].shape == want_dv.shape
    np.testing.assert_allclose(got["dir_vec"], want_dv, atol=1e-4)
    np.testing.assert_allclose(got["poses"], want_ps, atol=1e-4)

    alone = JTrainer(jcfg, work, test_data=jsplits["test"])
    alone.load_torch_checkpoint(str(weights))
    with pytest.raises(flax.errors.ScopeParamShapeError):
        JService.from_trainer(alone).synthesize(audio, words, vid_idx=1)
