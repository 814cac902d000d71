"""IEMOCAP speech-emotion data (the v1 SER path), numpy host code: the
port's own copy of the JAX package's `data/iemocap.py` (reference
`loader_v2.py:128-432`, `load_iemocap_data`).

Log mel filterbank (40 filters) + delta + delta-delta in 300-frame
blocks, 7-category emotion labels (exc/sur -> hap, fru -> ang, xxx ->
oth), the session split (sessions 1-4 train; session 5 male -> test,
female -> val), min-max normalization by the train split's statistics.
The front end has python_speech_features' semantics (HTK mel scale,
preemphasis 0.97, 25 ms / 10 ms rectangular-window frames, NFFT 512) in
numpy. The cache (`<dataset>/processed_07_cats_tpu/splits.npz`) keeps
the JAX package's directory name and schema, so that either package reads
a corpus the other cached.
"""

from __future__ import annotations

import functools
import glob
import os
import re
import wave
from os.path import join as jn

import numpy as np

EMOTIONS_10 = ["neu", "hap", "exc", "sur", "fea", "sad", "dis", "ang", "fru", "oth"]
EMOTIONS_07 = ["neu", "hap", "fea", "sad", "dis", "ang", "oth"]


# --------------------------------------------------------------------------
# python_speech_features-parity DSP
# --------------------------------------------------------------------------

def _hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asanyarray(hz) / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asanyarray(mel) / 2595.0) - 1.0)


def _round_half_up(x: float) -> int:
    import decimal

    return int(
        decimal.Decimal(x).quantize(decimal.Decimal("1"),
                                    rounding=decimal.ROUND_HALF_UP)
    )


@functools.lru_cache(maxsize=None)
def _filterbank_htk(nfilt: int, nfft: int, samplerate: int,
                    lowfreq: float = 0.0, highfreq: float | None = None):
    highfreq = highfreq or samplerate / 2
    melpoints = np.linspace(_hz_to_mel_htk(lowfreq), _hz_to_mel_htk(highfreq),
                            nfilt + 2)
    bins = np.floor((nfft + 1) * _mel_to_hz_htk(melpoints) / samplerate)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def logfbank(signal: np.ndarray, samplerate: int = 16000, winlen: float = 0.025,
             winstep: float = 0.01, nfilt: int = 40, nfft: int = 512,
             preemph: float = 0.97) -> np.ndarray:
    """(T, nfilt) log mel-filterbank energies (python_speech_features
    semantics: preemphasis, rectangular window, zero-padded final frame)."""
    signal = np.asarray(signal, np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    frame_len = _round_half_up(winlen * samplerate)
    frame_step = _round_half_up(winstep * samplerate)
    slen = len(signal)
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(np.ceil((slen - frame_len) / frame_step))
    padded = np.concatenate(
        [signal, np.zeros((numframes - 1) * frame_step + frame_len - slen)]
    )
    idx = (np.arange(frame_len)[None, :]
           + frame_step * np.arange(numframes)[:, None])
    frames = padded[idx]
    pspec = (np.abs(np.fft.rfft(frames, nfft, axis=1)) ** 2) / nfft
    feat = pspec @ _filterbank_htk(nfilt, nfft, samplerate).T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return np.log(feat)


def delta(feat: np.ndarray, n: int = 2) -> np.ndarray:
    """Delta features with edge padding (python_speech_features.delta)."""
    denominator = 2 * sum(i**2 for i in range(1, n + 1))
    padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
    out = np.zeros_like(feat)
    for t in range(len(feat)):
        window = padded[t : t + 2 * n + 1]
        out[t] = np.arange(-n, n + 1) @ window / denominator
    return out


# --------------------------------------------------------------------------
# labels + blocking
# --------------------------------------------------------------------------

def extract_07_categorical_emotions(label: str) -> np.ndarray:
    """7-way one-hot with category merging (ref loader_v2.py:146-155)."""
    if label in ("exc", "sur"):
        label = "hap"
    if label == "fru":
        label = "ang"
    if label == "xxx":
        label = "oth"
    onehot = np.zeros(len(EMOTIONS_07), dtype=int)
    onehot[EMOTIONS_07.index(label)] = 1
    return onehot


def blocks_from_features(mel: np.ndarray, d1: np.ndarray, d2: np.ndarray,
                         block_size: int = 300, stride: int = 100):
    """Split (T, F) features into fixed 300-frame blocks
    (ref loader_v2.py:258-305): zero-pad short clips, stride-100 windows
    otherwise."""
    t = mel.shape[0]
    if t <= block_size:
        pad = ((0, block_size - t), (0, 0))
        yield (np.pad(mel, pad), np.pad(d1, pad), np.pad(d2, pad))
    else:
        for begin in np.arange(0, t, stride):
            end = begin + block_size
            if end > t:
                break
            yield (mel[begin:end], d1[begin:end], d2[begin:end])


def wav_to_blocks(signal: np.ndarray, samplerate: int = 16000,
                  block_size: int = 300, nfilt: int = 40):
    mel = logfbank(signal, samplerate, nfilt=nfilt)
    d1 = delta(mel, 2)
    d2 = delta(d1, 2)
    return list(blocks_from_features(mel, d1, d2, block_size))


def read_wav_file(file_name: str):
    """ref loader_v2.py:128-137."""
    with wave.open(file_name, "r") as f:
        num_channels, sample_width, framerate, wav_length = f.getparams()[:4]
        data = np.frombuffer(f.readframes(wav_length), dtype=np.short)
    t = np.arange(0, wav_length) * (1.0 / framerate)
    return data, t, framerate


# --------------------------------------------------------------------------
# full-corpus loader (gated on the IEMOCAP directory being present)
# --------------------------------------------------------------------------

def load_iemocap_data(data_dir: str, dataset: str = "iemocap",
                      dimensional_min: float = 0.0, dimensional_max: float = 6.0,
                      block_size: int = 300, filter_num: int = 40,
                      sessions_train=(1, 2, 3, 4), session_test: int = 5):
    """Build (or load cached) IEMOCAP splits as channel-last blocks
    (N, 300, 40, 3) + one-hot categorical and min-max dimensional labels
    (ref loader_v2.py:186-432; cache schema compatible in content)."""
    dataset_dir = jn(data_dir, dataset)
    processed = jn(dataset_dir, "processed_07_cats_tpu")
    cache = jn(processed, "splits.npz")
    if os.path.exists(cache):
        npz = np.load(cache, allow_pickle=True)
        return {k: npz[k] for k in npz.files}

    if not os.path.isdir(dataset_dir):
        raise FileNotFoundError(f"IEMOCAP not found at {dataset_dir}")

    data1, data2, data3, cats, dims = [], [], [], [], []
    split_of = []  # 'train' | 'val' | 'test'
    for session in sorted(glob.glob(jn(dataset_dir, "Session*"))):
        s_num = int(session[-1])
        wav_dir = jn(session, "sentences/wav")
        emo_dir = jn(session, "dialog/EmoEvaluation")
        for sess in sorted(os.listdir(wav_dir)):
            if "impro" not in sess:
                continue
            # parse annotations keyed by utterance NAME — the reference pairs
            # glob order with annotation-line order (loader_v2.py:247-255),
            # which misaligns when the filesystem order differs from the
            # EmoEvaluation chronological order; keying by name is exact.
            emotions_by_name: dict[str, tuple] = {}
            with open(jn(emo_dir, sess + ".txt")) as ef:
                for line in ef:
                    if line and line[0] == "[":
                        parts = line.split()
                        utt_name, label = parts[3], parts[4]
                        dims_vals = [
                            float(x) for x in re.findall(r"\d+\.\d+", line)[-3:]
                        ]
                        emotions_by_name[utt_name] = (
                            extract_07_categorical_emotions(label), dims_vals
                        )
            wav_files = sorted(glob.glob(jn(wav_dir, sess, "*.wav")))
            assert len(wav_files) == len(emotions_by_name)
            for wav_name in wav_files:
                utt = os.path.splitext(os.path.basename(wav_name))[0]
                cat, dim = emotions_by_name[utt]
                data, _, rate = read_wav_file(wav_name)
                if s_num in sessions_train:
                    split = "train"
                elif s_num == session_test:
                    is_male = os.path.basename(wav_name)[-8] == "M"
                    split = "test" if is_male else "val"
                else:
                    split = "ignore"
                for mel, d1, d2 in wav_to_blocks(data, rate, block_size,
                                                 filter_num):
                    data1.append(mel)
                    data2.append(d1)
                    data3.append(d2)
                    cats.append(cat)
                    dims.append(dim)
                    split_of.append(split)

    data1, data2, data3 = map(np.asarray, (data1, data2, data3))
    cats = np.asarray(cats)
    dims = (np.asarray(dims) - dimensional_min) / (dimensional_max - dimensional_min)
    split_of = np.asarray(split_of)

    train_mask = split_of == "train"
    stats = [(data1[train_mask].max(), data1[train_mask].min()),
             (data2[train_mask].max(), data2[train_mask].min()),
             (data3[train_mask].max(), data3[train_mask].min())]

    def normalize(sel):
        chans = [
            (d[sel] - mn) / (mx - mn)
            for d, (mx, mn) in zip((data1, data2, data3), stats)
        ]
        return np.stack(chans, axis=-1).astype(np.float32)  # (N, T, F, 3)

    out = {}
    for name in ("train", "val", "test"):
        sel = split_of == name
        out[f"{name}_data_wav"] = normalize(sel)
        out[f"{name}_labels_cat"] = cats[sel]
        out[f"{name}_labels_dim"] = dims[sel]
    out["stats_max"] = np.array([s[0] for s in stats])
    out["stats_min"] = np.array([s[1] for s in stats])
    os.makedirs(processed, exist_ok=True)
    np.savez_compressed(cache, **out)
    return out
