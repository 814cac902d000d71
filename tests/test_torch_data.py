"""The port's data layer on the CPU against the JAX package's: the LMDB file
format, the pyarrow-0.14 blob reader, the preprocessor on real-schema
records, and the packed splits of the TED LMDB layout and of the export
archive at both of its levels.

The corpus is the JAX package's synthetic videos in the raw TED schema
(`make_synthetic_videos`), stored as the reference stores it: one LMDB
per split whose values are pyarrow-0.14 `serialize` blobs, or the gzip'd
pickle shards of `tools/export_ted_cache.py`. The same files go through
both packages. Tolerances: word ids, speaker ids, int16 audio and the
sidecars exactly; dir-vec sequences and the audio maxima within 1e-6; the
MFCCs within float16 rounding plus 2e-4 (atol 2e-4, rtol 2^-10: the port
computes them in float32 torch, the JAX package's data layer in numpy),
as `test_synthetic_corpus_matches_jax`.
"""

import gzip
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.data import legacy_arrow as tla
from speech2affective_gestures_torch.data import lmdb_lite as tlmdb
from speech2affective_gestures_torch.data import preprocessor as tprep
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data import legacy_arrow as jla
from speech2affective_gestures_tpu.data import lmdb_lite as jlmdb
from speech2affective_gestures_tpu.data import preprocessor as jprep
from speech2affective_gestures_tpu.data import ted_db as jdb

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "config" / "multimodal_context_v2.yml")
GOLDEN = REPO / "tests" / "fixtures" / "legacy_arrow_golden.bin"
TCFG = TConfig.from_yaml(CONFIG)
JCFG = JConfig.from_yaml(CONFIG)
PACKED = ("extended_word_seq", "vec_seq", "audio", "audio_max", "mfcc_features",
          "vid_indices")
SIDECARS = ("word_seqs", "aux_info", "pose_seqs", "raw_audio", "raw_audio_max")


def _same(a, b, where="") -> None:
    """Deep equality of decoded objects: types, dtypes, shapes, values."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple, set)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(sorted(a) if isinstance(b, set) else a,
                                       sorted(b) if isinstance(b, set) else b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _assert_split_matches(got, want, name) -> None:
    """A packed split of the port against the JAX package's."""
    assert got.n_samples == want.n_samples > 0, name
    for k in ("extended_word_seq", "vid_indices", "audio"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=f"{name} {k}")
    for k in ("vec_seq", "audio_max"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} {k}")
    np.testing.assert_allclose(got.mfcc_features.astype(np.float32),
                               want.mfcc_features.astype(np.float32),
                               atol=2e-4, rtol=2 ** -10, err_msg=f"{name} mfcc")
    assert got.lang_model.word2index == want.lang_model.word2index, name
    np.testing.assert_array_equal(got.lang_model.word_embedding_weights,
                                  want.lang_model.word_embedding_weights)
    assert got.speaker_model.word2index == want.speaker_model.word2index, name
    for k in SIDECARS:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), f"{name} {k}"
        if w is not None:
            _same(list(g) if isinstance(w, list) else g, w, f"{name} {k}")


def _assert_splits_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        _assert_split_matches(got[name], want[name], name)


# ------------------------------------------------------------------ corpus

@pytest.fixture(scope="module")
def videos():
    """Five raw-schema videos (8 s, 30 windows pass the filters), plus
    clips the preprocessor filters out: a static one (the motion filter),
    one shorter than a window, one with a single word."""
    vids = jdb.make_synthetic_videos(n_videos=5, clip_seconds=8.0)
    clip = vids[1]["clips"][0]
    static = dict(clip, skeletons_3d=np.repeat(clip["skeletons_3d"][:1], 120, axis=0))
    short = dict(clip, skeletons_3d=clip["skeletons_3d"][:20], end_frame_no=20,
                 end_time=20 / 15, audio_raw=clip["audio_raw"][:int(20 / 15 * 16000)])
    lonely = dict(clip, words=clip["words"][:1])
    vids[1]["clips"] += [static, short, lonely]
    return vids


SPLIT_VIDEOS = {"train": slice(0, 3), "val": slice(3, 4), "test": slice(4, 5)}


def _write_lmdb_layout(base: str, videos) -> None:
    """The reference's three-split TED layout: one LMDB per split whose
    values are pyarrow-0.14 blobs of raw videos under '{:010}' keys
    (tests/test_real_lmdb_gate.py's layout)."""
    for split, sel in SPLIT_VIDEOS.items():
        items = [("{:010}".format(i).encode("ascii"), jla.serialize_legacy(v))
                 for i, v in enumerate(videos[sel])]
        jlmdb.write_env(os.path.join(base, getattr(JCFG, f"{split}_data_path")), items)


def _write_archive(path: str, level: str, split_records: dict) -> None:
    """An export archive as `tools/export_ted_cache.py` writes it."""
    os.makedirs(path, exist_ok=True)
    manifest = {"level": level, "num_mfcc": 14, "splits": {}}
    for split, records in split_records.items():
        with gzip.open(os.path.join(path, f"{split}_0000.pkl.gz"), "wb") as f:
            pickle.dump(records, f, protocol=4)
        manifest["splits"][split] = {"shards": 1, "records": len(records)}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _preprocessor(mod, **kw):
    return mod.DataPreprocessor(
        n_poses=int(round(JCFG.n_poses * 1.25)), subdivision_stride=JCFG.subdivision_stride,
        pose_resampling_fps=JCFG.motion_resampling_framerate,
        mean_pose=JCFG.mean_pose_array.reshape(-1, 3), mean_dir_vec=JCFG.mean_dir_vec_array,
        num_mfcc=JCFG.num_mfcc, **kw)


# --------------------------------------------------------------- lmdb_lite

def _items(n, seed):
    rng = np.random.default_rng(seed)
    return [(f"{i:010}".encode(), rng.bytes(int(rng.integers(1, 6000))))
            for i in range(n)]


@pytest.mark.parametrize("n", [3, 300], ids=["one_leaf", "branches"])
def test_lmdb_lite_matches_jax(tmp_path, n):
    """Inline and overflow values, one leaf or branch levels above many,
    in an environment the JAX package's writer made: the port reads the
    same items, values and statistics as the JAX reader."""
    items = _items(n, n)
    jlmdb.write_env(str(tmp_path / "j"), items)
    want = jlmdb.open(str(tmp_path / "j"), readonly=True, lock=False)
    env = tlmdb.open(str(tmp_path / "j"), readonly=True, lock=False)
    with env.begin(write=False) as txn, want.begin(write=False) as jtxn:
        assert list(txn.cursor()) == list(jtxn.cursor()) == sorted(items)
        assert txn.get(items[-1][0]) == items[-1][1]
        assert txn.get(b"absent") is None
    assert env.stat() == want.stat()
    with pytest.raises(NotImplementedError):
        tlmdb.open(str(tmp_path / "j"), readonly=False)


# ------------------------------------------------------------ legacy_arrow

def test_legacy_arrow_golden_blob_matches_jax():
    """The golden blob, hand-framed by a code path neither writer shares,
    with tensor and buffer components: both readers give the same objects."""
    blob = GOLDEN.read_bytes()
    _same(tla.deserialize(blob), jla.deserialize(blob))


@pytest.mark.parametrize("header_counts,legacy_framing", [(3, True), (4, True), (4, False)],
                         ids=["counts3", "counts4", "modern_framing"])
def test_legacy_arrow_reads_jax_blobs_like_jax(videos, header_counts, legacy_framing):
    """A raw TED video dict (arrays, nested lists, dicts, floats and str)
    written by the JAX package's writer with either header and either IPC
    framing: the port reads it as the JAX reader does."""
    video = videos[0]
    blob = jla.serialize_legacy(video, header_counts=header_counts,
                                legacy_framing=legacy_framing)
    got = tla.deserialize(blob)
    _same(got, jla.deserialize(blob))
    np.testing.assert_array_equal(got["clips"][0]["skeletons_3d"],
                                  video["clips"][0]["skeletons_3d"])


def test_legacy_arrow_refuses_garbage():
    garbage = b"\x01\x00\x00\x00garbage-not-a-stream" * 4
    with pytest.raises(tla.LegacyFormatError):
        tla.deserialize(garbage)
    with pytest.raises(jla.LegacyFormatError):
        jla.deserialize(garbage)


def test_without_pyarrow_the_lmdb_route_names_the_export_tool(tmp_path, monkeypatch, videos):
    """No pyarrow (the card's machine): `iter_lmdb_videos` and `main_v2`'s
    LMDB route raise an ImportError that names the archive route."""
    base = tmp_path / "data" / "ted_db"
    _write_lmdb_layout(str(base), videos[:5])
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="tools/export_ted_cache.py.*--packed-data"):
        next(tdb.iter_lmdb_videos(str(base / TCFG.test_data_path)))
    with pytest.raises(ImportError, match="export_ted_cache"):
        tla.deserialize(GOLDEN.read_bytes())
    with pytest.raises(ImportError, match="export_ted_cache"):
        tmain.main(["-b", str(tmp_path / "models"), "-c", CONFIG, "--device", "cpu"])


# ------------------------------------------------------------ preprocessor

def test_preprocessor_matches_jax_on_filtered_clips(videos):
    """Real-schema clips with windows the filters reject (a static clip,
    a clip shorter than a window, windows with fewer than two words): the
    same records, the same rejections."""
    tpre, jpre = _preprocessor(tprep), _preprocessor(jprep)
    got, want = list(tpre.run(videos[:2])), list(jpre.run(videos[:2]))
    assert len(got) == len(want) > 0
    assert dict(tpre.n_filtered_out) == dict(jpre.n_filtered_out)
    assert tpre.n_filtered_out["motion"] > 0 or tpre.n_filtered_out["pose"] > 0
    for g, w in zip(got, want):
        _same(g[0], w[0], "words")
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[2], w[2], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_array_equal(g[4], w[4])
        np.testing.assert_allclose(g[5], w[5], atol=2e-4, rtol=2 ** -10)
        _same(g[6], w[6], "aux")


# ------------------------------------------------------------ packed splits

@pytest.fixture(scope="module")
def lmdb_splits(tmp_path_factory, videos):
    """The LMDB layout loaded by the JAX package, then by the port (the JAX
    package's caches sit beside the port's in the same directory)."""
    base = str(tmp_path_factory.mktemp("ted_base"))
    _write_lmdb_layout(base, videos)
    want = jdb.load_ted_db_data(base, JCFG)
    got = tdb.load_ted_db_data(base, TCFG)
    return base, got, want


def test_load_ted_db_data_matches_jax(lmdb_splits):
    base, got, want = lmdb_splits
    _assert_splits_match(got, want)
    cache_dir = os.path.dirname(os.path.join(base, TCFG.train_data_path))
    names = sorted(os.listdir(cache_dir))
    assert "train_s2ag_torch_packed_mfcc_14.npz" in names
    assert "train_s2ag_tpu_packed_mfcc_14.npz" in names  # left alone


def test_second_load_reads_the_caches(lmdb_splits, monkeypatch):
    base, got, _ = lmdb_splits

    def refuse(*args, **kwargs):
        raise AssertionError("a split was rebuilt")

    monkeypatch.setattr(tdb, "build_dataset_from_videos", refuse)
    monkeypatch.setattr(tdb, "iter_lmdb_videos", refuse)
    again = tdb.load_ted_db_data(base, TCFG)
    _assert_splits_match(again, got)
    test_only = tdb.load_ted_db_data(base, TCFG, load_train_val=False)
    assert set(test_only) == {"test"}
    assert test_only["test"].lang_model.word2index == got["train"].lang_model.word2index


@pytest.mark.parametrize("level", ["raw", "cache"])
def test_load_exported_data_matches_jax(tmp_path, videos, level):
    if level == "raw":
        records = {s: videos[sel] for s, sel in SPLIT_VIDEOS.items()}
    else:
        pre = _preprocessor(jprep)
        records = {s: list(pre.run(videos[sel])) for s, sel in SPLIT_VIDEOS.items()}
    _write_archive(str(tmp_path / "j"), level, records)
    _write_archive(str(tmp_path / "t"), level, records)
    want = jdb.load_exported_data(str(tmp_path / "j"), JCFG)
    got = tdb.load_exported_data(str(tmp_path / "t"), TCFG)
    _assert_splits_match(got, want)
    assert got["test"].aux_info is not None and got["train"].aux_info is None


def test_cache_of_another_vocabulary_is_rebuilt(tmp_path, videos):
    """A split cache whose vocabulary is not the shared one is packed
    again, with the shared one."""
    arch = str(tmp_path / "arch")
    _write_archive(arch, "raw", {s: videos[sel] for s, sel in SPLIT_VIDEOS.items()})
    first = tdb.load_exported_data(arch, TCFG)
    vocab_pkl = os.path.join(arch, "val_s2ag_torch_packed_mfcc_14_vocab.pkl")
    with open(vocab_pkl, "rb") as f:
        lang, speakers = pickle.load(f)
    lang.index_word("an_unknown_word")
    with open(vocab_pkl, "wb") as f:
        pickle.dump((lang, speakers), f)
    again = tdb.load_exported_data(arch, TCFG)
    with open(vocab_pkl, "rb") as f:
        rebuilt_lang, _ = pickle.load(f)
    assert rebuilt_lang.word2index == first["train"].lang_model.word2index
    _assert_splits_match(again, first)


def test_port_caches_load_without_the_jax_package(tmp_path, videos):
    """The port's cache files (npz and vocabulary pickles) load in a
    process where the JAX package cannot be imported."""
    arch = str(tmp_path / "arch")
    _write_archive(arch, "raw", {s: videos[sel] for s, sel in SPLIT_VIDEOS.items()})
    first = tdb.load_exported_data(arch, TCFG)
    code = f"""
import sys, glob, pickle
sys.modules["speech2affective_gestures_tpu"] = None
from speech2affective_gestures_torch.config import ModelConfig
from speech2affective_gestures_torch.data import ted_db
ted_db.build_dataset_from_videos = None   # a rebuild would fail
for path in glob.glob({arch!r} + "/*torch*.pkl"):
    pickle.load(open(path, "rb"))
splits = ted_db.load_exported_data({arch!r}, ModelConfig.from_yaml({CONFIG!r}))
print(sorted((k, v.n_samples) for k, v in splits.items()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted((k, v.n_samples) for k, v in first.items()))
