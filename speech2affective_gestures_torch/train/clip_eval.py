"""Long-clip rendering of the test split and of the GENEA 2020 clips (the
port of the JAX package's `train/clip_eval.py`; reference
`generate_gestures_by_dataset` and `render_clip`, processor_v2.py
:1144-1567).

- `ted_db`: the test split's windows, in storage order, are stitched into
  whole clips: contiguous windows of one video (frame ranges touching)
  merge (`stitch_test_clips`).
- `genea_challenge_2020`: wav + BVH (`render.bvh.load_bvh`) + JSON
  transcript triples.
- Each clip is synthesized twice, seeded with its own first poses: by the
  s2ag generator on MFCC windows (the mel kernel and the GRU forward on
  the card) and by the frozen TriModal baseline on raw-audio windows (the
  GRU forward), then faded out, with the target smoothed over the fade,
  and written as `*_s2ag.pkl` / `*_trimodal.pkl` and a three-panel video.
  `render_clip` runs one clip at generator batch 1;
  `render_clips_batched` runs all clips as one generator batch.

Each clip's two noise sources come from one integer (`clip_noise`), so a
clip draws the same noise alone and in a batch, on the card and on the
CPU. A speaker id outside the generator's embedding raises before any
clip is synthesized.
"""

from __future__ import annotations

import json
import os
import time
from os.path import join as jn

import numpy as np
import torch

from .. import constants as C
from ..data.preprocessor import resample_pose_seq
from ..data.ted_db import PackedDataset
from ..ops import pose as pose_ops
from ..render import bvh as bvh_mod
from ..render import video as video_mod
from . import synthesis

GENEA_JOINTS_TO_KEEP = [0, 4, 6, 7, 9, 10, 11, 28, 29, 30]


def _keep_first(pieces: list, n: int) -> None:
    """Cut a list of arrays, in place, to the pieces of the first n rows of
    their concatenation (numpy's `[:n]`; a negative n counts from the
    end), copying no more than the one piece it cuts."""
    if n < 0:
        pieces[:] = [np.concatenate(pieces)[:n]]
        return
    end = sum(len(p) for p in pieces)
    while pieces and end - len(pieces[-1]) >= n:
        end -= len(pieces.pop())
    if pieces and end > n:
        pieces[-1] = pieces[-1][:n - (end - len(pieces[-1]))]


def stitch_test_clips(ds: PackedDataset):
    """Merge contiguous windows of one video into whole clips (ref
    processor_v2.py:1495-1522); needs the split's sidecars. Yields dicts
    {vid, poses (F, J, 3), audio (L,), words, frames, time (t0, t1)}.

    A window that joins a clip cuts the clip's poses and audio at its own
    start and appends its own; the pieces are concatenated once, when the
    clip is complete, which gives the reference's bits in linear time."""
    if ds.aux_info is None or ds.pose_seqs is None:
        raise ValueError("stitching needs a split that kept its sidecars")

    def complete(clip):
        clip["poses"] = np.concatenate(clip["poses"], axis=0)
        clip["audio"] = np.concatenate(clip["audio"])
        return clip

    current = None
    for k in range(ds.n_samples):
        aux = ds.aux_info[k]
        # the sidecars hold the full extended window that aux's frame and
        # time ranges describe (the packed arrays stop at n_poses)
        poses = ds.pose_seqs[k]
        audio = ds.raw_audio[k].astype(np.float32) * ds.raw_audio_max[k] / 32767.0
        words = [list(w) for w in ds.word_seqs[k]]
        frames = [aux["start_frame_no"], aux["end_frame_no"]]
        times = [aux["start_time"], aux["end_time"]]

        if (current is None or aux["vid"] != current["vid"]
                or frames[0] - 1 > current["frames"][1]):
            if current is not None:
                yield complete(current)
            current = {"vid": aux["vid"], "poses": [poses], "audio": [audio],
                       "words": words, "frames": frames, "time": times}
        else:
            _keep_first(current["poses"], frames[0] - current["frames"][0])
            current["poses"].append(poses)
            _keep_first(current["audio"], int((times[0] - current["time"][0]) * C.AUDIO_SR))
            current["audio"].append(audio)
            for word in words:
                if word not in current["words"]:
                    current["words"].append(word)
            current["frames"][1] = frames[1]
            current["time"][1] = times[1]
    if current is not None:
        yield complete(current)


def clip_noise(seed: int, n_windows: int, z_size: int):
    """A clip's per-window speaker noise for the s2ag generator and for the
    TriModal baseline, (n_windows, 1, z_size) each, from the clip's integer
    (the JAX package splits the clip's key into two, clip_eval.py:134): two
    CPU generators seeded from the words of `np.random.SeedSequence(seed)`."""
    words = np.random.SeedSequence(seed).generate_state(2)
    return tuple(torch.randn(n_windows, 1, z_size,
                             generator=torch.Generator().manual_seed(int(w)))
                 for w in words)


def _batch_eps(per_clip: list) -> torch.Tensor:
    """Per-clip noise (S_b, 1, z) -> (max S_b, B, z), column b clip b's."""
    out = torch.zeros(max(len(e) for e in per_clip), len(per_clip), per_clip[0].shape[-1])
    for b, e in enumerate(per_clip):
        out[:len(e), b] = e[:, 0]
    return out


def _in_range(clip_time, duration_range) -> bool:
    return duration_range[0] <= clip_time[1] - clip_time[0] <= duration_range[1]


class ClipRenderer:
    """Renders clips with a trainer's generator (`trainer.gen`) and, when
    the trainer has one, its TriModal baseline (`trainer.tri`), in eval
    mode on their device, with the test split's vocabulary."""

    def __init__(self, trainer):
        self.cfg = trainer.cfg
        self.gen = trainer.gen.eval()
        tri = getattr(trainer, "tri", None)
        self.tri = tri.eval() if tri is not None else None
        self.lang = (trainer.test_data.lang_model
                     if trainer.test_data is not None else None)

    def check_speakers(self, ids) -> None:
        """Raise ValueError for a speaker id outside the generator's
        embedding (the JAX package renders NaN poses there)."""
        n = self.gen.speaker_embedding[0].num_embeddings
        bad = sorted({int(i) for i in ids if not 0 <= int(i) < n})
        if bad:
            raise ValueError(f"speaker id {bad[0]} is out of range: the generator has "
                             f"{n} speakers (ids {bad})")

    def _prepare(self, spec: dict, sample_rate: int) -> dict:
        """A clip's target direction vectors, its seed poses (the target's
        first n_pre), clip-relative words and its noise."""
        cfg = self.cfg
        t0, t1 = spec["clip_time"]
        resampled = resample_pose_seq(spec["clip_poses"], t1 - t0,
                                      cfg.motion_resampling_framerate)
        target = pose_ops.convert_pose_seq_to_dir_vec(
            torch.as_tensor(resampled, dtype=torch.float32)).reshape(len(resampled), -1)
        target = target.numpy() - cfg.mean_dir_vec_array
        words = [[w[0], w[1] - t0, w[2] - t0] for w in spec["clip_words"]]
        n_windows = len(synthesis.plan_subdivisions(len(spec["clip_audio"]) / sample_rate,
                                                    cfg)[0])
        eps_s2ag, eps_tri = clip_noise(spec["seed"], n_windows, self.gen.z_size)
        return {"resampled": resampled, "target": target, "words": words,
                "seed_dir_vec": target[:cfg.n_pre_poses], "eps_s2ag": eps_s2ag,
                "eps_tri": eps_tri}

    def _finish(self, spec: dict, prep: dict, s2ag, tri, sample_rate: int,
                fade_out: bool, make_video: bool, save_pkl: bool, save_path: str):
        """Smooth the target over the fade, write the video and the
        pickles; returns (resampled poses, TriModal poses or None, s2ag
        poses)."""
        cfg = self.cfg
        mean_dir_vec = cfg.mean_dir_vec_array
        out_dir_vec, out_poses = s2ag
        target = prep["target"]
        if fade_out:
            # the reference also polyfit-smooths the target over the fade
            # (processor_v2.py:1359-1389)
            _, _, end_padding = synthesis.prepare_window_inputs(
                spec["clip_audio"], prep["words"], self.lang, cfg, sample_rate)
            start_f, end_f = synthesis.fade_frame_range(len(out_dir_vec), end_padding, cfg,
                                                        sample_rate)
            if 0 <= start_f and end_f <= len(target):
                target = synthesis.polyfit_smooth(target.copy(), start_f, end_f)

        vid, speaker = spec["vid_name"], spec["speaker_vid_idx"]
        t0, t1 = spec["clip_time"]
        prefix = f"{vid}_s{speaker}_{t0:.2f}_{t1:.2f}"
        sentence = " ".join(w[0] for w in spec["clip_words"])
        aux = f"{vid}_{speaker}_0"
        if make_video:
            video_mod.create_video_and_save(
                save_path, 0, prefix, 0, target,
                tri[0] if tri is not None else np.zeros_like(out_dir_vec),
                out_dir_vec, mean_dir_vec, sentence, audio=spec["clip_audio"],
                clipping_to_shortest_stream=True, delete_audio_file=False)
        if save_pkl:
            if tri is not None:
                video_mod.save_generation_pkl(
                    save_path, prefix, "trimodal", sentence, spec["clip_audio"],
                    tri[0] + mean_dir_vec, tri[1], target + mean_dir_vec, aux)
            video_mod.save_generation_pkl(
                save_path, prefix, "s2ag", sentence, spec["clip_audio"],
                out_dir_vec + mean_dir_vec, out_poses, target + mean_dir_vec, aux)
        return prep["resampled"], None if tri is None else tri[1], out_poses

    def render_clip(self, vid_name: str, clip_poses: np.ndarray, clip_audio: np.ndarray,
                    sample_rate: int, clip_words, clip_time, speaker_vid_idx: int = 0,
                    clip_duration_range=(5, 30), check_duration: bool = True,
                    fade_out: bool = False, make_video: bool = False,
                    save_pkl: bool = False, save_path: str = "render", seed: int = 0):
        """One clip at generator batch 1 (ref render_clip,
        processor_v2.py:1144-1439), its noise from `seed` (`clip_noise`).
        Returns (resampled poses, TriModal poses or None, s2ag poses), or
        (None, None, None) for a clip outside `clip_duration_range`."""
        if check_duration and not _in_range(clip_time, clip_duration_range):
            return None, None, None
        self.check_speakers([speaker_vid_idx])
        spec = {"vid_name": vid_name, "clip_poses": clip_poses, "clip_audio": clip_audio,
                "clip_words": clip_words, "clip_time": clip_time,
                "speaker_vid_idx": speaker_vid_idx, "seed": seed}
        prep = self._prepare(spec, sample_rate)
        common = dict(vid_idx=speaker_vid_idx, sample_rate=sample_rate, fade_out=fade_out,
                      seed_dir_vec=prep["seed_dir_vec"])
        s2ag = synthesis.synthesize_clip_fused(self.gen, clip_audio, prep["words"], self.lang,
                                               self.cfg, eps=prep["eps_s2ag"], **common)
        tri = None
        if self.tri is not None:
            tri = synthesis.synthesize_clip_fused(self.tri, clip_audio, prep["words"],
                                                  self.lang, self.cfg, eps=prep["eps_tri"],
                                                  use_mfcc=False, **common)
        return self._finish(spec, prep, s2ag, tri, sample_rate, fade_out, make_video,
                            save_pkl, save_path)

    def render_clips_batched(self, clip_specs, fade_out: bool = False,
                             save_pkl: bool = False, save_path: str = "render"):
        """All clips as one generator batch per generator: each window step
        is one forward at batch len(clip_specs) instead of one per clip.

        clip_specs: dicts with vid_name, clip_poses, clip_audio (at 16 kHz),
        clip_words, clip_time, speaker_vid_idx and seed. Returns, in input
        order, what `render_clip` returns for each clip with the same seed
        (videos are made on the per-clip path only)."""
        clip_specs = list(clip_specs)
        if not clip_specs:
            return []
        self.check_speakers(spec["speaker_vid_idx"] for spec in clip_specs)
        preps = [self._prepare(spec, C.AUDIO_SR) for spec in clip_specs]
        triples = [(spec["clip_audio"], p["words"], spec["speaker_vid_idx"])
                   for spec, p in zip(clip_specs, preps)]
        seeds = [p["seed_dir_vec"] for p in preps]
        s2ag_out = synthesis.synthesize_clips_batched(
            self.gen, triples, self.lang, self.cfg, fade_out=fade_out, seeds=seeds,
            eps=_batch_eps([p["eps_s2ag"] for p in preps]))
        tri_out = [None] * len(clip_specs)
        if self.tri is not None:
            tri_out = synthesis.synthesize_clips_batched(
                self.tri, triples, self.lang, self.cfg, fade_out=fade_out, seeds=seeds,
                eps=_batch_eps([p["eps_tri"] for p in preps]), use_mfcc=False)
        return [self._finish(spec, p, s2ag, tri, C.AUDIO_SR, fade_out, False, save_pkl,
                             save_path)
                for spec, p, s2ag, tri in zip(clip_specs, preps, s2ag_out, tri_out)]


def _ted_db_specs(trainer, data_params: dict, check_duration: bool, samples,
                  randomized: bool, rng: np.random.Generator):
    """The test split's stitched clips as clip specs, with the JAX
    package's draws: per clip the speaker (if `randomized`), then the
    noise integer, then the duration filter."""
    duration_range = data_params.get("clip_duration_range", [5, 12])
    ds = trainer.test_data
    n_speakers = ds.speaker_model.n_words if ds.speaker_model else 1
    for clip in stitch_test_clips(ds):
        # keep clips whose vid is a substring of a requested sample prefix
        # (processor_v2.py:1486)
        if samples is not None and not any(clip["vid"] in s for s in samples):
            continue
        vid_idx = int(rng.integers(0, n_speakers)) if randomized else 0
        seed = int(rng.integers(1 << 31))
        if check_duration and not _in_range(clip["time"], duration_range):
            continue
        yield {"vid_name": clip["vid"], "clip_poses": clip["poses"],
               "clip_audio": clip["audio"], "clip_words": clip["words"],
               "clip_time": clip["time"], "speaker_vid_idx": vid_idx, "seed": seed}


def _genea_specs(data_params: dict, check_duration: bool, randomized: bool,
                 rng: np.random.Generator):
    """The GENEA 2020 clips under data_params["data_path"] (audio/*.wav,
    bvh_raw/*.bvh, transcripts/*.json; ref processor_v2.py:1524-1564) as
    clip specs: the 10 kept joints of the BVH's positions scaled to
    [-1, 1] by decade bounds, a speaker drawn from [0, 100) if
    `randomized`, noise from 0."""
    data_path = data_params["data_path"]
    duration_range = data_params.get("clip_duration_range", (5, 30))
    file_names = sorted(".wav".join(f.split(".wav")[:-1])
                        for f in os.listdir(jn(data_path, "audio")))
    for f in file_names:
        audio = _load_wav_16k(jn(data_path, "audio", f + ".wav"))
        _, _, _, joint_positions, _, frame_rate = bvh_mod.load_bvh(
            jn(data_path, "bvh_raw", f + ".bvh"))
        jmax = np.power(10.0, np.ceil(np.log10(np.max(joint_positions))))
        jmin = np.min(joint_positions)
        jmin = 0.0 if jmin >= 0 else -np.power(10.0, np.ceil(np.log10(np.abs(jmin))))
        scaled = 2.0 * (joint_positions - jmin) / (jmax - jmin) - 1.0
        with open(jn(data_path, "transcripts", f + ".json")) as jf:
            transcript = [[w["word"], float(w["start_time"][:-1]), float(w["end_time"][:-1])]
                          for jd in json.load(jf) for w in jd["alternatives"][0]["words"]]
        clip_time = [0.0, len(joint_positions) / np.round(frame_rate)]
        vid_idx = int(rng.integers(0, 100)) if randomized else 0
        if check_duration and not _in_range(clip_time, duration_range):
            continue
        yield {"vid_name": f, "clip_poses": scaled[:, GENEA_JOINTS_TO_KEEP],
               "clip_audio": audio, "clip_words": transcript, "clip_time": clip_time,
               "speaker_vid_idx": vid_idx, "seed": 0}


def generate_gestures_by_dataset(trainer, dataset: str = "ted_db",
                                 data_params: dict | None = None,
                                 check_duration: bool = True, samples=None,
                                 randomized: bool = True, fade_out: bool = False,
                                 make_video: bool = False, save_pkl: bool = False,
                                 save_path: str = "render", seed: int = 0,
                                 batched: bool = False):
    """Render every clip of a dataset (ref processor_v2.py:1441-1567):
    "ted_db" (the trainer's test split, clips of 5-12 s unless
    data_params["clip_duration_range"] says otherwise) or
    "genea_challenge_2020" (data_params["data_path"], 5-30 s). The draws
    come from `np.random.default_rng(seed)` in the JAX package's order.
    `batched` renders all clips as one generator batch (no video), with
    the same clips, speakers and noise as the per-clip loop. Returns a list
    of (clip name, (resampled poses, TriModal poses, s2ag poses))."""
    kind = dataset.lower()
    if kind not in ("ted_db", "genea_challenge_2020"):
        raise ValueError(f"unknown dataset {dataset!r}")
    if batched and make_video:
        raise ValueError("batched dataset generation does not render videos; use "
                         "batched=False for the video path")
    data_params = dict(data_params or {})
    rng = np.random.default_rng(seed)
    start = time.time()
    if kind == "ted_db":
        specs = list(_ted_db_specs(trainer, data_params, check_duration, samples,
                                   randomized, rng))
    else:
        specs = list(_genea_specs(data_params, check_duration, randomized, rng))
    renderer = ClipRenderer(trainer)
    renderer.check_speakers(spec["speaker_vid_idx"] for spec in specs)
    if batched:
        outs = renderer.render_clips_batched(specs, fade_out=fade_out, save_pkl=save_pkl,
                                             save_path=save_path)
    else:
        outs = [renderer.render_clip(
            spec["vid_name"], spec["clip_poses"], spec["clip_audio"], C.AUDIO_SR,
            spec["clip_words"], spec["clip_time"], speaker_vid_idx=spec["speaker_vid_idx"],
            check_duration=False, fade_out=fade_out, make_video=make_video,
            save_pkl=save_pkl, save_path=save_path, seed=spec["seed"]) for spec in specs]
    results = [(spec["vid_name"], out) for spec, out in zip(specs, outs)]
    trainer.logger.print_log(f"generate_gestures_by_dataset: {len(results)} clips in "
                             f"{time.time() - start:.2f}s")
    return results


def _load_wav_16k(path: str) -> np.ndarray:
    """A wav file as float32 mono at 16 kHz."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    data = data.mean(axis=1) if data.ndim > 1 else data.astype(np.float32)
    if sr != C.AUDIO_SR:
        data = resample_poly(data, C.AUDIO_SR, sr).astype(np.float32)
    return data
