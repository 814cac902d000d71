"""Clip subdivision: raw TED videos -> fixed-shape training windows
(reference `utils/data_preprocessor.py`).

Resample skeletons to 15 fps, slide a window of n_poses frames with
subdivision_stride, slice the matching raw audio and spectrogram, filter
bad motion, convert poses to mean-normalized unit direction vectors, and
compute the MFCC features of all of a clip's windows in one batched call of
`ops/dsp.get_mfcc_features` on `device` (the mel kernel on the card).

Video dict schema (the raw TED lmdb schema, utils/data_preprocessor.py:75-81):
  {'vid': str, 'clips': [{'skeletons_3d': (F,10,3), 'audio_feat': (128,S),
    'audio_raw': (L,), 'words': [[word, start, end], ...],
    'start_frame_no': int, 'end_frame_no': int,
    'start_time': float, 'end_time': float}]}
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Iterable, Iterator

import numpy as np
import torch
from scipy.interpolate import interp1d

from .. import constants as C
from ..ops import dsp
from ..ops import pose as pose_ops
from . import motion_filter


def resample_pose_seq(poses: np.ndarray, duration_in_sec: float, fps: float) -> np.ndarray:
    """Linear resampling to `fps` (ref utils/ted_db_utils.py:50-60)."""
    n = len(poses)
    f = interp1d(np.arange(n), poses, axis=0, kind="linear",
                 fill_value="extrapolate")
    out = f(np.arange(0, n, n / (duration_in_sec * fps)))
    return out.astype(poses.dtype)


def get_words_in_time_range(word_list, start_time, end_time):
    """ref utils/data_preprocessor.py:187-202."""
    words = []
    for word in word_list:
        if word[1] >= end_time:
            break
        if word[2] <= start_time:
            continue
        words.append(word)
    return words


def spectrogram_length(n_frames: int, fps: float) -> int:
    """ref utils/ted_db_utils.py:45-47."""
    return int(round((n_frames / fps * 16000 - 1024) / 512 + 1))


class DataPreprocessor:
    """Subdivide clips into training samples [words, poses,
    normalized_dir_vec, audio, spectrogram, mfcc_features, aux_info], the
    reference's lmdb record schema (utils/data_preprocessor.py:175-178)."""

    def __init__(self, n_poses: int, subdivision_stride: int,
                 pose_resampling_fps: float, mean_pose, mean_dir_vec,
                 num_mfcc: int = C.NUM_MFCC, disable_filtering: bool = False,
                 device: str | torch.device = "cpu"):
        self.n_poses = n_poses
        self.subdivision_stride = subdivision_stride
        self.fps = pose_resampling_fps
        self.mean_pose = np.asarray(mean_pose)
        mean_dir_vec = np.asarray(mean_dir_vec)
        if mean_dir_vec.shape[-1] != 3:
            mean_dir_vec = mean_dir_vec.reshape(mean_dir_vec.shape[:-1] + (-1, 3))
        self.mean_dir_vec = mean_dir_vec
        self.num_mfcc = num_mfcc
        self.spectrogram_sample_length = spectrogram_length(n_poses, self.fps)
        self.audio_sample_length = int(n_poses / self.fps * C.AUDIO_SR)
        self.disable_filtering = disable_filtering
        self.device = torch.device(device)
        self.n_filtered_out: dict[str, int] = defaultdict(int)

    def run(self, videos: Iterable[dict]) -> Iterator[list]:
        """Yield sample records for every clip of every video."""
        for video in videos:
            for clip in video["clips"]:
                yield from self._sample_from_clip(video["vid"], clip)

    def _sample_from_clip(self, vid: str, clip: dict) -> Iterator[list]:
        clip_skeleton = resample_pose_seq(
            np.asarray(clip["skeletons_3d"]),
            clip["end_time"] - clip["start_time"], self.fps)
        clip_audio = np.asarray(clip["audio_feat"])
        clip_audio_raw = np.asarray(clip["audio_raw"])
        clip_word_list = clip["words"]
        clip_s_f = clip["start_frame_no"]
        clip_s_t = clip["start_time"]

        num_subdivision = math.floor(
            (len(clip_skeleton) - self.n_poses) / self.subdivision_stride) + 1
        pending = []  # windows awaiting the batched MFCC
        for i in range(num_subdivision):
            start_idx = i * self.subdivision_stride
            fin_idx = start_idx + self.n_poses
            sample_skeletons = clip_skeleton[start_idx:fin_idx]
            sub_start_t = clip_s_t + start_idx / self.fps
            sub_end_t = clip_s_t + fin_idx / self.fps
            sample_words = get_words_in_time_range(clip_word_list, sub_start_t,
                                                   sub_end_t)
            if len(sample_words) < 2:
                continue

            # spectrogram slice (symmetric-pad overruns)
            a_start = math.floor(start_idx / len(clip_skeleton) * clip_audio.shape[1])
            a_end = a_start + self.spectrogram_sample_length
            if a_end > clip_audio.shape[1]:
                padded = np.pad(clip_audio, ((0, 0), (0, a_end - clip_audio.shape[1])),
                                mode="symmetric")
                sample_spectrogram = padded[:, a_start:a_end]
            else:
                sample_spectrogram = clip_audio[:, a_start:a_end]

            # raw audio slice
            a_start = math.floor(start_idx / len(clip_skeleton) * len(clip_audio_raw))
            a_end = a_start + self.audio_sample_length
            if a_end > len(clip_audio_raw):
                padded = np.pad(clip_audio_raw, (0, a_end - len(clip_audio_raw)),
                                mode="symmetric")
                sample_audio = padded[a_start:a_end]
            else:
                sample_audio = clip_audio_raw[a_start:a_end]

            skeletons, message = motion_filter.filter_motion(sample_skeletons,
                                                             self.mean_pose)
            is_correct = skeletons is not None
            aux_info = {
                "vid": vid,
                "start_frame_no": clip_s_f + start_idx,
                "end_frame_no": clip_s_f + fin_idx,
                "start_time": sub_start_t,
                "end_time": sub_end_t,
                "is_correct_motion": is_correct,
                "filtering_message": message,
            }
            if not is_correct and not self.disable_filtering:
                self.n_filtered_out[message] += 1
                continue
            poses = np.asarray(skeletons if is_correct else sample_skeletons)
            normalized = (pose_ops.convert_pose_seq_to_dir_vec(torch.from_numpy(poses))
                          .numpy() - self.mean_dir_vec)
            pending.append([sample_words, poses, normalized, sample_audio,
                            sample_spectrogram, None, aux_info])

        if pending:
            batch_audio = torch.from_numpy(np.stack(
                [np.asarray(rec[3], np.float32) for rec in pending]))
            mfccs = dsp.get_mfcc_features(batch_audio.to(self.device), sr=C.AUDIO_SR,
                                          num_mfcc=self.num_mfcc).cpu().numpy()
            for rec, m in zip(pending, mfccs):
                rec[5] = m
                yield rec
