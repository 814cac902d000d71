"""TED Gesture DB pipeline, the part training reads (reference `loader_v2.py`
and `processor_v2.py`'s npz cache and batch sampler): packed fixed-shape
datasets, the batch sampler with adversarial speakers, the split resident
on the device with its batch gather (the trainer's loader), the TED LMDB
ingestion, the exported-archive reader and the synthetic corpus.

The packed arrays keep the reference cache's schema (processor_v2.py
:278-283): int64 word ids, float32 dir-vec sequences, int16 audio with a
per-sample max, float16 MFCC, int64 speaker ids. The test split also keeps
the full preprocessor windows' words, aux info, poses and audio
(sidecars) for the long-clip rendering.

Two readers build the packed splits, both computing the MFCCs of raw
videos on `device` (the mel kernel on the card) and caching the result as
`<split>_s2ag_torch_packed_mfcc_<N>.npz` with a `_vocab.pkl` beside it,
under one word vocabulary over all of the corpus's splits
(`s2ag_torch_shared_vocab_mfcc_<N>_e<tag>.pkl`, keyed on the embedding
config; a split cache packed with another vocabulary is rebuilt):
- `load_ted_db_data`: the reference's three LMDB splits, whose values are
  pyarrow-0.14 blobs (`legacy_arrow`, which needs pyarrow);
- `load_exported_data`: the archive that the JAX package's
  `tools/export_ted_cache.py` writes (gzip'd pickle shards and a JSON
  manifest, at level `raw` or `cache`), which needs neither lmdb nor
  pyarrow.
The cache files carry the port's own names and classes, so a directory
where the JAX package left its caches (`_s2ag_tpu_packed_`) is not read.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import json
import logging
import os
import pickle
from typing import Callable, Iterator

import numpy as np
import torch

from .. import constants as C
from ..config import ModelConfig
from ..ops import dsp
from ..train import profiling
from . import preprocessor as prep
from .vocab import Vocab, build_vocab, make_speaker_vocab


# --------------------------------------------------------------------------
# word-sequence tensorization (ref processor_v2.py:409-441)
# --------------------------------------------------------------------------

def extend_word_seq(n_frames: int, lang: Vocab, words, aux_info: dict,
                    end_time: float | None = None,
                    remove_word_timing: bool = False) -> np.ndarray:
    """Frame-aligned word-id sequence (PAD=0 elsewhere)."""
    if end_time is None:
        end_time = aux_info["end_time"]
    frame_duration = (end_time - aux_info["start_time"]) / n_frames
    indices = np.zeros(n_frames, dtype=np.int64)
    if remove_word_timing:
        n_words = 0
        for word in words:
            idx = max(0, int(np.floor((word[1] - aux_info["start_time"]) / frame_duration)))
            if idx < n_frames:
                n_words += 1
        space = int(n_frames / (n_words + 1))
        for word_idx in range(n_words):
            idx = (word_idx + 1) * space
            indices[idx] = lang.get_word_index(words[word_idx][0])
    else:
        for word in words:
            idx = max(0, int(np.floor((word[1] - aux_info["start_time"]) / frame_duration)))
            if idx < n_frames:
                indices[idx] = lang.get_word_index(word[0])
    return indices


def words_to_tensor(lang: Vocab, words, end_time: float | None = None) -> np.ndarray:
    indexes = [lang.SOS_token]
    for word in words:
        if end_time is not None and word[1] > end_time:
            break
        indexes.append(lang.get_word_index(word[0]))
    indexes.append(lang.EOS_token)
    return np.asarray(indexes, dtype=np.int64)


def make_audio_fixed_length(audio: np.ndarray, expected_len: int) -> np.ndarray:
    n_pad = expected_len - len(audio)
    if n_pad > 0:
        return np.pad(audio, (0, n_pad), mode="symmetric")
    return audio[:expected_len]


# --------------------------------------------------------------------------
# packed dataset (the npz cache schema, processor_v2.py:278-283)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedDataset:
    extended_word_seq: np.ndarray   # (N, T) int64
    vec_seq: np.ndarray             # (N, T, 27) f32
    audio: np.ndarray               # (N, L) int16 (normalized)
    audio_max: np.ndarray           # (N,) f64
    mfcc_features: np.ndarray       # (N, 37, mfcc_len) f16
    vid_indices: np.ndarray         # (N,) int64
    speaker_model: Vocab | None = None
    lang_model: Vocab | None = None
    # sidecars for the rendering paths: the full preprocessor window
    # (n_poses * 1.25 frames and its audio, the range aux_info's frame and
    # time fields describe), where the packed arrays stop at n_poses
    word_seqs: list | None = None
    aux_info: list | None = None
    pose_seqs: np.ndarray | None = None        # (N, T_ext, 10, 3)
    raw_audio: np.ndarray | None = None        # (N, L_ext) int16
    raw_audio_max: np.ndarray | None = None    # (N,)

    @property
    def n_samples(self) -> int:
        return len(self.vec_seq)

    def subset(self, sel, sidecars: bool = False) -> "PackedDataset":
        """The rows `sel`, sharing the vocabularies; the sidecars too when
        `sidecars` (the JAX package keeps them on the test split only)."""
        keep = sidecars and self.aux_info is not None
        return PackedDataset(
            extended_word_seq=self.extended_word_seq[sel], vec_seq=self.vec_seq[sel],
            audio=self.audio[sel], audio_max=self.audio_max[sel],
            mfcc_features=self.mfcc_features[sel], vid_indices=self.vid_indices[sel],
            speaker_model=self.speaker_model, lang_model=self.lang_model,
            word_seqs=[self.word_seqs[i] for i in sel] if keep else None,
            aux_info=[self.aux_info[i] for i in sel] if keep else None,
            pose_seqs=self.pose_seqs[sel] if keep else None,
            raw_audio=self.raw_audio[sel] if keep else None,
            raw_audio_max=self.raw_audio_max[sel] if keep else None)

    def save_npz(self, path: str):
        extras = {}
        if self.aux_info is not None:
            extras = {"word_seqs": _object_array(self.word_seqs),
                      "aux_info": _object_array(self.aux_info),
                      "pose_seqs": self.pose_seqs, "raw_audio": self.raw_audio,
                      "raw_audio_max": self.raw_audio_max}
        np.savez_compressed(
            path, extended_word_seq=self.extended_word_seq, vec_seq=self.vec_seq,
            audio=self.audio, audio_max=self.audio_max,
            mfcc_features=self.mfcc_features, vid_indices=self.vid_indices, **extras)

    @classmethod
    def load_npz(cls, path: str, speaker_model: Vocab | None = None,
                 lang_model: Vocab | None = None) -> "PackedDataset":
        npz = np.load(path, allow_pickle=True)
        side = "aux_info" in npz.files
        return cls(
            extended_word_seq=npz["extended_word_seq"],
            vec_seq=npz["vec_seq"].astype(np.float32), audio=npz["audio"],
            audio_max=npz["audio_max"], mfcc_features=npz["mfcc_features"],
            vid_indices=npz["vid_indices"], speaker_model=speaker_model,
            lang_model=lang_model,
            word_seqs=list(npz["word_seqs"]) if side else None,
            aux_info=list(npz["aux_info"]) if side else None,
            pose_seqs=npz["pose_seqs"] if side else None,
            raw_audio=npz["raw_audio"] if side else None,
            raw_audio_max=npz["raw_audio_max"] if side else None)


def _object_array(items: list) -> np.ndarray:
    """A 1-D object array of `items` (np.asarray would stack word lists of
    equal length into a 3-D array)."""
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def speaker_id_pool(dataset: PackedDataset) -> np.ndarray | None:
    """All speaker ids of a split's speaker model."""
    sp = dataset.speaker_model
    return np.asarray(sorted(sp.word2index.values())) if sp is not None else None


def decode_rows(ds: PackedDataset, idx) -> dict:
    """Packed rows -> training dtypes (int16 audio rescaled by its
    per-sample max, float16 MFCC promoted)."""
    return {
        "extended_word_seq": ds.extended_word_seq[idx].astype(np.int64),
        "vec_seq": ds.vec_seq[idx].astype(np.float32),
        "audio": (ds.audio[idx] * np.expand_dims(ds.audio_max[idx], -1) / 32767.0
                  ).astype(np.float32),
        "mfcc_features": ds.mfcc_features[idx].astype(np.float32),
    }


def sample_adversarial_speakers(all_speaker_ids: np.ndarray, own: np.ndarray,
                                rng: np.random.Generator, size: int) -> np.ndarray:
    """Random speakers excluding every id in `own` (the reference excludes
    the whole batch's ids via setdiff1d, processor_v2.py:627-630)."""
    pool = np.setdiff1d(all_speaker_ids, own)
    if len(pool) == 0:
        pool = all_speaker_ids
    return rng.choice(pool, size=size)


class BatchSampler:
    """Random-with-replacement batches and adversarial speaker ids (ref
    yield_batch, processor_v2.py:589-638: the ids fed to the generator are
    random speakers other than the batch's own)."""

    def __init__(self, dataset: PackedDataset, batch_size: int, seed: int = 1234):
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.all_speaker_ids = speaker_id_pool(dataset)

    def pseudo_passes(self) -> int:
        return (self.ds.n_samples + self.batch_size - 1) // self.batch_size

    def sample_indices(self) -> np.ndarray:
        return self.rng.integers(0, self.ds.n_samples, self.batch_size)

    def adversarial_speakers(self, own: np.ndarray) -> np.ndarray:
        return sample_adversarial_speakers(self.all_speaker_ids, own, self.rng,
                                           self.batch_size)

    def draw(self) -> tuple[np.ndarray, np.ndarray | None]:
        """One batch's draws, in the reference's order: the rows, then the
        adversarial speakers (None for a split without a speaker model)."""
        idx = self.sample_indices()
        if self.all_speaker_ids is None:
            return idx, None
        return idx, self.adversarial_speakers(self.ds.vid_indices[idx]).astype(np.int64)

    def __iter__(self) -> Iterator[dict]:
        for _ in range(self.pseudo_passes()):
            idx, adv = self.draw()
            batch = decode_rows(self.ds, idx)
            if adv is not None:
                batch["vid_indices"] = adv
            yield batch


def gather(arrays: dict, idx: torch.Tensor, adv_vids: torch.Tensor) -> dict:
    """A batch of the rows `idx` of a `DeviceDataset`'s arrays, assembled
    where they live, in the JAX package's operations and order
    (data/ted_db.py:276-282): MFCC float16 -> float32, the int16 audio
    rescaled in float32 as audio * audio_max / 32767 (`decode_rows` does
    it in float64); the words as int64, the speakers `adv_vids`."""
    return {
        "extended_word_seq": arrays["extended_word_seq"][idx].long(),
        "vec_seq": arrays["vec_seq"][idx],
        "mfcc_features": arrays["mfcc_features"][idx].float(),
        "vid_indices": adv_vids,
        "audio": arrays["audio"][idx].float() * arrays["audio_max"][idx, None] / 32767.0,
    }


def host_indices(idx: np.ndarray, adv_vids: np.ndarray) -> torch.Tensor:
    """The row indices and speakers stacked, (2, ...) int64 on the host:
    what crosses to the device for a batch (or a program's batches)."""
    return torch.from_numpy(np.stack([idx, adv_vids]).astype(np.int64))


class DeviceDataset:
    """A packed split resident on `device` in its compact dtypes (int32
    words, float32 poses, float16 MFCC, int16 audio with its float32 max),
    uploaded once; `batch` gathers a batch there from the (B,) row indices
    and adversarial speakers, the only data that crosses per step (JAX
    data/ted_db.py:227-294; the reference re-uploads every batch,
    processor_v2.py:602-621). A split larger than the card's free memory
    raises MemoryError, which names the streaming loader
    (`data.grain_loader`); there is no silent fallback."""

    def __init__(self, dataset: PackedDataset, device: torch.device):
        self.device = torch.device(device)
        arrays = {"extended_word_seq": dataset.extended_word_seq.astype(np.int32),
                  "vec_seq": dataset.vec_seq.astype(np.float32),
                  "mfcc_features": dataset.mfcc_features, "audio": dataset.audio,
                  "audio_max": dataset.audio_max.astype(np.float32)}
        nbytes = sum(a.nbytes for a in arrays.values())
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes > free:
                raise MemoryError(
                    f"the device loader keeps the whole train split on {self.device}: "
                    f"{nbytes / 2**30:.2f} GiB of packed arrays, {free / 2**30:.2f} GiB "
                    "free; --loader grain streams the split from the host")
        self.arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                       for k, v in arrays.items()}

    def indices(self, idx: np.ndarray, adv_vids: np.ndarray) -> torch.Tensor:
        """(2, ...) int64 on the device: the row indices and the speakers,
        in one host->device copy."""
        return host_indices(idx, adv_vids).to(self.device, non_blocking=True)

    def batch(self, idx: np.ndarray, adv_vids: np.ndarray) -> dict:
        """The batch of the (B,) rows `idx`, speakers `adv_vids`: the
        indices' upload and the gather, in the span `data.batch`
        (`train.profiling.annotate`)."""
        with profiling.annotate("data.batch"):
            rows, vids = self.indices(idx, adv_vids)
            return gather(self.arrays, rows, vids)


class DeviceBatchSampler(BatchSampler):
    """`BatchSampler`'s draws, in its order (the rows, then the adversarial
    speakers), with each batch gathered on the device (`DeviceDataset`):
    the rows `part` of each draw (a data-parallel rank's; all of them by
    default)."""

    def __init__(self, dataset: PackedDataset, batch_size: int, seed: int,
                 device_dataset: DeviceDataset, part: slice = slice(None)):
        super().__init__(dataset, batch_size, seed)
        self.device_ds = device_dataset
        self.part = part

    def __iter__(self) -> Iterator[dict]:
        for _ in range(self.pseudo_passes()):
            idx, adv = self.draw()
            yield self.device_ds.batch(idx[self.part], adv[self.part])


# --------------------------------------------------------------------------
# sample records -> packed arrays (ref save_cache, processor_v2.py:273-341)
# --------------------------------------------------------------------------

def pack_samples(samples: list, cfg: ModelConfig, lang_model: Vocab,
                 speaker_model: Vocab, keep_sidecars: bool = False,
                 remove_word_timing: bool = False) -> PackedDataset:
    n = len(samples)
    t = cfg.n_poses
    audio_len = cfg.expected_audio_length
    mfcc_len = cfg.mfcc_length
    # the sidecars keep the full preprocessor window
    t_ext = int(round(t * 1.25)) if keep_sidecars else 0
    audio_ext = int(t_ext / cfg.motion_resampling_framerate * C.AUDIO_SR)
    out = PackedDataset(
        extended_word_seq=np.zeros((n, t), np.int64),
        vec_seq=np.zeros((n, t, C.POSE_DIM), np.float32),
        audio=np.zeros((n, audio_len), np.int16),
        audio_max=np.zeros(n),
        mfcc_features=np.zeros((n, cfg.num_mfcc_combined, mfcc_len), np.float16),
        vid_indices=np.zeros(n, np.int64),
        speaker_model=speaker_model,
        lang_model=lang_model,
    )
    if keep_sidecars:
        out.word_seqs, out.aux_info = [], []
        out.pose_seqs = np.zeros((n, t_ext, C.NUM_JOINTS, 3), np.float32)
        out.raw_audio = np.zeros((n, audio_ext), np.int16)
        out.raw_audio_max = np.zeros(n)
    for k, rec in enumerate(samples):
        word_seq, pose_seq, vec_seq, audio, _spec, mfcc, aux = rec
        duration = aux["end_time"] - aux["start_time"]
        amax = np.max(np.abs(audio))
        out.audio_max[k] = amax
        sample_end_time = aux["start_time"] + duration * t / len(vec_seq)
        out.extended_word_seq[k] = extend_word_seq(
            t, lang_model, word_seq, aux, sample_end_time,
            remove_word_timing=remove_word_timing)
        out.vec_seq[k] = vec_seq[:t].reshape(t, -1)
        out.audio[k] = np.int16(make_audio_fixed_length(audio, audio_len)
                                / max(amax, 1e-12) * 32767)
        out.mfcc_features[k] = mfcc[:, :mfcc_len]
        out.vid_indices[k] = speaker_model.word2index[aux["vid"]]
        if keep_sidecars:
            out.word_seqs.append(word_seq)
            out.aux_info.append(aux)
            full = pose_seq.reshape(len(pose_seq), C.NUM_JOINTS, 3)
            out.pose_seqs[k, :min(len(full), t_ext)] = full[:t_ext]
            full_audio = make_audio_fixed_length(np.asarray(audio), audio_ext)
            out.raw_audio_max[k] = amax
            out.raw_audio[k] = np.int16(full_audio / max(amax, 1e-12) * 32767)
    return out


def build_dataset_from_samples(samples, cfg: ModelConfig,
                               lang_model: Vocab | None = None,
                               keep_sidecars: bool = False) -> PackedDataset:
    """Preprocessed sample records (the reference cache-lmdb schema
    [words, poses, dir_vec, audio, spectrogram, mfcc, aux],
    utils/data_preprocessor.py:175-178) -> packed arrays."""
    samples = list(samples)
    if lang_model is None:
        lang_model = build_vocab(
            "words", ([w[0] for w in rec[0]] for rec in samples),
            feat_dim=cfg.wordembed_dim, word_vec_path=cfg.wordembed_path)
    speaker_model = make_speaker_vocab(sorted({rec[6]["vid"] for rec in samples}))
    # reference: remove_word_timing = (input_context == 'text'),
    # loader_v2.py:596-606
    return pack_samples(samples, cfg, lang_model, speaker_model, keep_sidecars,
                        remove_word_timing=(cfg.input_context == "text"))


def build_dataset_from_videos(videos, cfg: ModelConfig,
                              lang_model: Vocab | None = None,
                              keep_sidecars: bool = False,
                              device: str | torch.device = "cpu") -> PackedDataset:
    """Videos (the raw schema) -> windows -> filter -> packed arrays; the
    MFCCs are computed on `device`."""
    pre = prep.DataPreprocessor(
        n_poses=int(round(cfg.n_poses * 1.25)),  # margin, ref loader_v2.py:496
        subdivision_stride=cfg.subdivision_stride,
        pose_resampling_fps=cfg.motion_resampling_framerate,
        mean_pose=cfg.mean_pose_array.reshape(-1, 3),
        mean_dir_vec=cfg.mean_dir_vec_array,
        num_mfcc=cfg.num_mfcc,
        device=device,
    )
    return build_dataset_from_samples(pre.run(videos), cfg, lang_model, keep_sidecars)


# --------------------------------------------------------------------------
# the corpus's readers: the TED LMDB and the exported archive
# --------------------------------------------------------------------------

SPLITS = ("train", "val", "test")


def _split_words(records, level: str) -> Iterator[list[str]]:
    """The words of each clip (`raw` video dicts) or sample (`cache`)."""
    if level == "raw":
        for video in records:
            for clip in video["clips"]:
                yield [w[0] for w in clip["words"]]
    else:
        for rec in records:
            yield [w[0] for w in rec[0]]


def _packed_splits(read_split: Callable[[str], Iterator], all_splits, wanted,
                   level: str, out_dir: str, cfg: ModelConfig,
                   device: str | torch.device) -> dict[str, PackedDataset]:
    """The `wanted` splits packed, from their caches in `out_dir` where
    those were packed with the shared vocabulary, else from `read_split`'s
    records (`raw` video dicts, windowed here with the MFCCs on `device`,
    or `cache` sample records); the test split keeps its sidecars.

    The word vocabulary is one over all of `all_splits`, so word ids never
    depend on which splits a run asked for (the reference's build_vocab
    over the three splits, vocab_utils.py:11-35); it is cached beside the
    splits under a key of the embedding config, since its pickle carries
    the word vectors. The speaker vocabulary is each split's own."""
    os.makedirs(out_dir, exist_ok=True)
    embed_tag = hashlib.sha1(
        f"{cfg.wordembed_dim}|{cfg.wordembed_path or ''}".encode()).hexdigest()[:8]
    lang_model = build_vocab(
        "words", (ws for s in all_splits for ws in _split_words(read_split(s), level)),
        cache_path=os.path.join(
            out_dir, f"s2ag_torch_shared_vocab_mfcc_{cfg.num_mfcc}_e{embed_tag}.pkl"),
        feat_dim=cfg.wordembed_dim, word_vec_path=cfg.wordembed_path)
    splits = {}
    for split in wanted:
        cache = os.path.join(out_dir, f"{split}_s2ag_torch_packed_mfcc_{cfg.num_mfcc}.npz")
        vocab_cache = cache.replace(".npz", "_vocab.pkl")
        if os.path.exists(cache) and os.path.exists(vocab_cache):
            with open(vocab_cache, "rb") as f:
                cached_lang, speaker_model = pickle.load(f)
            if cached_lang.word2index == lang_model.word2index:
                splits[split] = PackedDataset.load_npz(
                    cache, speaker_model=speaker_model, lang_model=cached_lang)
                continue
            logging.warning("packed cache %s was built with another word vocabulary "
                            "(%d words, the shared one has %d): rebuilding split %r",
                            cache, cached_lang.n_words, lang_model.n_words, split)
        keep = split == "test"
        if level == "raw":
            ds = build_dataset_from_videos(read_split(split), cfg, lang_model, keep,
                                           device=device)
        else:
            ds = build_dataset_from_samples(read_split(split), cfg, lang_model, keep)
        ds.save_npz(cache)
        with open(vocab_cache, "wb") as f:
            pickle.dump((ds.lang_model, ds.speaker_model), f)
        splits[split] = ds
    return splits


def legacy_deserialize(value: bytes):
    """One pyarrow-0.14 `serialize` blob: `pyarrow.deserialize` where the
    installed pyarrow still has it (< 2), else the `legacy_arrow` reader.
    Both need pyarrow; without it this raises an ImportError that names
    the export archive."""
    from . import legacy_arrow

    pa = legacy_arrow.load_pyarrow()
    if hasattr(pa, "deserialize"):
        return pa.deserialize(value)
    return legacy_arrow.deserialize(value)


def iter_lmdb_videos(lmdb_dir: str) -> Iterator[dict]:
    """Raw-schema videos from one split of the TED LMDB, through the
    `lmdb` binding where it is installed, else the pure-Python
    `lmdb_lite`. Its values need pyarrow (`legacy_deserialize`): without
    it the first step raises, before the environment is opened."""
    from . import legacy_arrow

    legacy_arrow.load_pyarrow()
    try:
        import lmdb
    except ImportError:
        from . import lmdb_lite as lmdb
    env = lmdb.open(lmdb_dir, readonly=True, lock=False)
    try:
        with env.begin(write=False) as txn:
            for _key, value in txn.cursor():
                yield legacy_deserialize(value)
    finally:
        env.close()


def load_ted_db_data(base_path: str, cfg: ModelConfig, load_train_val: bool = True,
                     cache_dir: str | None = None,
                     device: str | torch.device = "cpu") -> dict[str, PackedDataset]:
    """The packed splits of the TED LMDB under `base_path` (the config's
    `<split>_data_path`s; reference loader_v2.load_ted_db_data, :585-639):
    all three, or the test split alone. The caches go to `cache_dir`, by
    default the directory that holds the train split's LMDB."""
    lmdb_dir = {s: os.path.join(base_path, getattr(cfg, f"{s}_data_path")) for s in SPLITS}
    out_dir = cache_dir or os.path.dirname(lmdb_dir["train"])
    wanted = list(SPLITS) if load_train_val else ["test"]
    return _packed_splits(lambda s: iter_lmdb_videos(lmdb_dir[s]), SPLITS, wanted,
                          "raw", out_dir, cfg, device)


EXPORT_MANIFEST = "manifest.json"


def read_export_manifest(exported_dir: str) -> dict:
    with open(os.path.join(exported_dir, EXPORT_MANIFEST)) as f:
        return json.load(f)


def iter_exported_records(exported_dir: str, split: str) -> Iterator:
    """The records (raw video dicts or preprocessed sample lists) of one
    split of an export archive: gzip'd pickle shards `<split>_<k>.pkl.gz`."""
    info = read_export_manifest(exported_dir)["splits"][split]
    for shard in range(info["shards"]):
        with gzip.open(os.path.join(exported_dir, f"{split}_{shard:04d}.pkl.gz"), "rb") as f:
            yield from pickle.load(f)


def load_exported_data(exported_dir: str, cfg: ModelConfig, load_train_val: bool = True,
                       cache_dir: str | None = None,
                       device: str | torch.device = "cpu") -> dict[str, PackedDataset]:
    """The packed splits of an export archive (the JAX package's
    `tools/export_ted_cache.py` writes it where lmdb and pyarrow are
    installed), at either of its levels: `raw` (video dicts, windowed here
    with the MFCCs on `device`) or `cache` (the reference's windowed sample
    records, packed only). The vocabulary spans every split of the
    manifest; the caches go to `cache_dir`, by default the archive."""
    manifest = read_export_manifest(exported_dir)
    all_splits = sorted(manifest["splits"])
    wanted = [s for s in (SPLITS if load_train_val else ("test",)) if s in manifest["splits"]]
    return _packed_splits(lambda s: iter_exported_records(exported_dir, s), all_splits,
                          wanted, manifest.get("level", "raw"),
                          cache_dir or exported_dir, cfg, device)


# --------------------------------------------------------------------------
# synthetic corpus (tests and smoke runs; no TED download required)
# --------------------------------------------------------------------------

_WORDS = ("the quick brown fox jumps over lazy dog while speaking about "
          "gesture motion hands arms speech emotion data model train").split()


def extract_mel_spectrogram(y: np.ndarray, device: str | torch.device = "cpu"
                            ) -> np.ndarray:
    """(128, S) float16 log-mel, n_fft 1024, hop 512, dB relative to the
    maximum (ref utils/ted_db_utils.py:38-42), computed on `device`."""
    mel = dsp.mel_power_spectrogram(torch.from_numpy(y).to(device), n_fft=1024)
    db = dsp.power_to_db(mel, ref=float(mel.max()))
    return db.t().cpu().numpy().astype(np.float16)


def make_synthetic_videos(n_videos: int = 3, clip_seconds: float = 12.0,
                          fps: int = 15, seed: int = 0,
                          device: str | torch.device = "cpu") -> list[dict]:
    """Raw-schema videos with plausible skeleton geometry (upright spine,
    moving wrists) that passes the motion filter, plus sine-mix audio."""
    rng = np.random.default_rng(seed)
    videos = []
    for v in range(n_videos):
        n_frames = int(clip_seconds * fps)
        t = np.linspace(0, clip_seconds, n_frames)[:, None]
        base = C.MEAN_POSE.reshape(-1, 3)[None].repeat(n_frames, 0)
        wobble = 0.12 * np.sin(2 * np.pi * (0.3 + 0.1 * v) * t + rng.uniform(0, 6))
        skel = base.copy()
        for j in (5, 6, 8, 9):  # elbows and wrists move
            skel[:, j, 0] += wobble[:, 0] * (1 + 0.2 * j)
            skel[:, j, 1] += 0.08 * np.cos(2 * np.pi * 0.5 * t[:, 0] + j)
        skel += rng.normal(0, 0.004, skel.shape)

        n_audio = int(clip_seconds * C.AUDIO_SR)
        ta = np.arange(n_audio) / C.AUDIO_SR
        audio = (0.4 * np.sin(2 * np.pi * (160 + 15 * v) * ta)
                 + 0.1 * rng.standard_normal(n_audio)).astype(np.float32)
        spec = extract_mel_spectrogram(audio, device)

        words, tw = [], 0.05
        while tw < clip_seconds - 0.4:
            dur = rng.uniform(0.2, 0.5)
            words.append([str(rng.choice(_WORDS)), tw, tw + dur])
            tw += dur + rng.uniform(0.02, 0.2)

        videos.append({
            "vid": f"synthetic_vid_{v}",
            "clips": [{
                "skeletons_3d": skel,
                "audio_feat": spec,
                "audio_raw": audio,
                "words": words,
                "start_frame_no": 0,
                "end_frame_no": n_frames,
                "start_time": 0.0,
                "end_time": clip_seconds,
            }],
        })
    return videos
