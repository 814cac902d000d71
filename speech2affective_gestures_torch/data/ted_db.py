"""TED Gesture DB pipeline, the part training reads (reference `loader_v2.py`
and `processor_v2.py`'s npz cache and batch sampler): packed fixed-shape
datasets, the batch sampler with adversarial speakers, and the synthetic
corpus.

The packed arrays keep the reference cache's schema (processor_v2.py
:278-283): int64 word ids, float32 dir-vec sequences, int16 audio with a
per-sample max, float16 MFCC, int64 speaker ids. The LMDB ingestion of the
real corpus and the exported-archive reader are not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .. import constants as C
from ..config import ModelConfig
from ..ops import dsp
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

    @property
    def n_samples(self) -> int:
        return len(self.vec_seq)

    def subset(self, sel) -> "PackedDataset":
        """The rows `sel`, sharing the vocabularies."""
        return PackedDataset(
            extended_word_seq=self.extended_word_seq[sel], vec_seq=self.vec_seq[sel],
            audio=self.audio[sel], audio_max=self.audio_max[sel],
            mfcc_features=self.mfcc_features[sel], vid_indices=self.vid_indices[sel],
            speaker_model=self.speaker_model, lang_model=self.lang_model)


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

    def __iter__(self) -> Iterator[dict]:
        for _ in range(self.pseudo_passes()):
            idx = self.sample_indices()
            batch = decode_rows(self.ds, idx)
            if self.all_speaker_ids is not None:
                batch["vid_indices"] = self.adversarial_speakers(
                    self.ds.vid_indices[idx]).astype(np.int64)
            yield batch


# --------------------------------------------------------------------------
# sample records -> packed arrays (ref save_cache, processor_v2.py:273-341)
# --------------------------------------------------------------------------

def pack_samples(samples: list, cfg: ModelConfig, lang_model: Vocab,
                 speaker_model: Vocab, remove_word_timing: bool = False
                 ) -> PackedDataset:
    n = len(samples)
    t = cfg.n_poses
    audio_len = cfg.expected_audio_length
    mfcc_len = cfg.mfcc_length
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
    for k, rec in enumerate(samples):
        word_seq, _pose_seq, vec_seq, audio, _spec, mfcc, aux = rec
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
    return out


def build_dataset_from_samples(samples, cfg: ModelConfig,
                               lang_model: Vocab | None = None) -> PackedDataset:
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
    return pack_samples(samples, cfg, lang_model, speaker_model,
                        remove_word_timing=(cfg.input_context == "text"))


def build_dataset_from_videos(videos, cfg: ModelConfig,
                              lang_model: Vocab | None = None,
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
    return build_dataset_from_samples(pre.run(videos), cfg, lang_model)


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
