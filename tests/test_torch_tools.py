"""The port's embedding-space plots and offline tools against the JAX
package's: `train/evaluator.py`'s `get_features_for_viz` and
`draw_embedding_space`, `tools/stats.py`, `tools/speech_to_text.py`.

- `get_features_for_viz`: the port projects with its own PCA (`pca_2d`,
  float64) where umap is missing, the JAX package with sklearn's `PCA`
  (umap is not installed here). On float64 features the two agree within
  1e-6; on the embedding net's float32 features within 1e-5 of the
  projection's spread, sklearn's float32 solve rounding at ~1e-6 of the
  values. A subprocess with sklearn and umap blocked runs the port's.
- `draw_embedding_space` writes a PNG, and names matplotlib where it is
  missing.
- `fleiss_kappa`, `fit_sinusoid`, `estimate_word_timings` and
  `transcribe_corpus` (with an injected transcriber and chunker, as JAX's
  tests do) give JAX's results; without pydub or speech_recognition the
  tools raise JAX's errors.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.tools import speech_to_text as tstt
from speech2affective_gestures_torch.tools import stats as tstats
from speech2affective_gestures_torch.train import evaluator as tev
from speech2affective_gestures_tpu.tools import speech_to_text as jstt
from speech2affective_gestures_tpu.tools import stats as jstats
from speech2affective_gestures_tpu.train import evaluator as jev


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(dtype, seed=0):
    rng = np.random.default_rng(seed)
    gen = [(rng.standard_normal((40, 32)) * 2 + 1).astype(dtype) for _ in range(2)]
    real = [(rng.standard_normal((40, 32)) * 3).astype(dtype) for _ in range(2)]
    return gen, real


def _evaluators(gen, real):
    port = object.__new__(tev.EmbeddingSpaceEvaluator)
    jax_ev = object.__new__(jev.EmbeddingSpaceEvaluator)
    for ev in (port, jax_ev):
        ev.reset()
        ev.generated_feat_list, ev.real_feat_list = list(gen), list(real)
    return port, jax_ev


def test_pca_against_sklearn_float64():
    from sklearn.decomposition import PCA

    for shape in ((20, 32), (600, 32), (300, 5)):
        x = np.random.default_rng(shape[0]).standard_normal(shape) * 3 + 1
        got = tev.pca_2d(x)
        assert got.dtype == np.float64 and got.shape == (shape[0], 2)
        np.testing.assert_allclose(got, PCA(n_components=2).fit_transform(x), rtol=0, atol=1e-6)


def test_features_for_viz_against_jax_float64():
    port, jax_ev = _evaluators(*_features(np.float64))
    for got, want in zip(port.get_features_for_viz(), jax_ev.get_features_for_viz()):
        assert got.shape == want.shape == (80, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_features_for_viz_against_jax_on_embedded_poses():
    """The embedding net's float32 features: real and generated poses
    through a seeded net on the CPU."""
    rng = np.random.default_rng(5)
    ev = tev.EmbeddingSpaceEvaluator.random_init(seed=0, device="cpu")
    for _ in range(2):
        ev.push_samples(rng.standard_normal((24, 34, 27)).astype(np.float32) * 0.1,
                        rng.standard_normal((24, 34, 27)).astype(np.float32) * 0.1)
    port, jax_ev = _evaluators(ev.generated_feat_list, ev.real_feat_list)
    assert port.generated_feat_list[0].dtype == np.float32
    for got, want in zip(ev.get_features_for_viz(), jax_ev.get_features_for_viz()):
        assert got.dtype == want.dtype == np.float32
        spread = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * spread)


def test_features_for_viz_without_sklearn_and_umap():
    """The port's projection needs neither sklearn nor umap."""
    code = textwrap.dedent("""
        import sys
        sys.modules["sklearn"] = None
        sys.modules["umap"] = None
        import numpy as np
        from speech2affective_gestures_torch.train import evaluator as ev
        e = object.__new__(ev.EmbeddingSpaceEvaluator)
        e.reset()
        rng = np.random.default_rng(0)
        e.generated_feat_list = [rng.standard_normal((10, 32))]
        e.real_feat_list = [rng.standard_normal((10, 32))]
        real, gen = e.get_features_for_viz()
        assert real.shape == gen.shape == (10, 2)
        assert "sklearn" not in [m for m in sys.modules if sys.modules[m] is not None]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_draw_embedding_space_writes_a_png(tmp_path, monkeypatch):
    port, _ = _evaluators(*_features(np.float32))
    path = port.draw_embedding_space(str(tmp_path / "space.png"))
    assert path == str(tmp_path / "space.png")
    assert (tmp_path / "space.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        port.draw_embedding_space(str(tmp_path / "none.png"))


def test_fleiss_kappa_against_jax():
    m = np.zeros((5, 3))
    m[:3, 0] = 4
    m[3:, 2] = 4
    assert tstats.fleiss_kappa(m) == jstats.fleiss_kappa(m) == pytest.approx(1.0)
    ratings = np.random.default_rng(0).multinomial(6, [0.5, 0.3, 0.2], size=12)
    assert tstats.fleiss_kappa(ratings) == jstats.fleiss_kappa(ratings)


def test_fit_sinusoid_against_jax():
    t = np.linspace(0, 4, 400)
    y = 2.0 * np.sin(2 * np.pi * 1.5 * t + 0.3) + 0.7
    y = y + np.random.default_rng(1).normal(0, 0.05, t.shape)
    got, want = tstats.fit_sinusoid(t, y), jstats.fit_sinusoid(t, y)
    for key in ("amp", "omega", "phase", "offset", "freq", "period", "maxcov"):
        assert got[key] == want[key], key
    assert got["fitfunc"](1.25) == want["fitfunc"](1.25)
    assert abs(got["freq"] - 1.5) < 1e-2


def test_estimate_word_timings_against_jax():
    for sentence, duration, tts in (("hello wonderful world", 3.0, None),
                                    ("a bb ccc", 1.5, lambda w: 0.1 * len(w) ** 2),
                                    ("", 2.0, None)):
        assert tstt.estimate_word_timings(sentence, duration, tts) == \
            jstt.estimate_word_timings(sentence, duration, tts)
    words = tstt.estimate_word_timings("hello wonderful world", 3.0)
    assert words[0][1] == 0.0 and abs(words[-1][2] - 3.0) < 1e-9


def test_transcribe_corpus_against_jax(tmp_path):
    from scipy.io import wavfile

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in ("b", "a"):
        wavfile.write(str(wav_dir / f"{name}.wav"), 16000,
                      (rng.standard_normal(8000) * 1000).astype(np.int16))
    (wav_dir / "notes.txt").write_text("not audio")

    class FakeChunk:
        def export(self, path, format):
            wavfile.write(path, 16000, np.zeros(100, np.int16))

    out = {}
    for name, mod in (("port", tstt), ("jax", jstt)):
        heard = []

        def transcriber(path, heard=heard):
            heard.append(path.rsplit("/", 1)[-1])
            return "" if len(heard) % 3 == 0 else f"word{len(heard)}"

        results = mod.transcribe_corpus(str(wav_dir), str(tmp_path / name),
                                        transcriber=transcriber,
                                        chunker=lambda p, **kw: [FakeChunk()] * 2)
        out[name] = (results, heard, sorted(p.name for p in (tmp_path / name).iterdir()),
                     (tmp_path / name / "a.txt").read_text())
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"a": "word1 word2", "b": "word4"}


def test_missing_backends_raise_as_jax(monkeypatch, tmp_path):
    for name in ("pydub", "pydub.silence", "speech_recognition"):
        monkeypatch.setitem(sys.modules, name, None)
    for mod in (tstt, jstt):
        with pytest.raises(RuntimeError, match="pydub"):
            mod.split_on_silence_chunks(str(tmp_path / "x.wav"))
        with pytest.raises(RuntimeError, match="speech_recognition"):
            mod.google_transcriber()
