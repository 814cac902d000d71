"""Stick-figure videos and the pickles of generated clips (the port of the
JAX package's `render/video.py`; reference `utils/gen_utils.py` and
processor_v2.py:1418-1437).

`create_video_and_save` draws three panels (human, TriModal, s2ag) with
matplotlib at 15 fps and writes the clip's audio as a wav with scipy. With
ffmpeg it writes an mp4 and muxes the audio in; without it, a GIF by
matplotlib's pillow writer and no audio. matplotlib is imported when a
video is made, so the rest of the port runs where it is not installed.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import time
from textwrap import wrap

import numpy as np
import torch
from scipy.io import wavfile

from .. import constants as C
from ..ops import pose as pose_ops


def _to_poses(dir_vec: np.ndarray | None, mean_data: np.ndarray):
    if dir_vec is None:
        return None
    return pose_ops.convert_dir_vec_to_pose(
        torch.as_tensor(np.asarray(dir_vec + mean_data, np.float32))).numpy()


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("create_video_and_save needs matplotlib, which is not "
                          "installed; render without make_video") from e
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    return animation, plt


def create_video_and_save(save_path: str, epoch: int, prefix: str, iter_idx: int,
                          target: np.ndarray | None, output_trimodal: np.ndarray,
                          output: np.ndarray, mean_data: np.ndarray, title: str,
                          audio: np.ndarray | None = None, aux_str: str | None = None,
                          clipping_to_shortest_stream: bool = False,
                          delete_audio_file: bool = True, fps: int = C.FPS):
    """A 3-panel (human | trimodal | ours) stick-figure animation of
    mean-normalized direction vectors; returns its paths and poses."""
    animation, plt = _pyplot()
    start = time.time()
    fig = plt.figure(figsize=(12, 4))
    axes = [fig.add_subplot(1, 3, k + 1, projection="3d") for k in range(3)]
    for ax in axes:
        ax.view_init(elev=20, azim=-60)
    fig_title = title + (("\n" + aux_str) if aux_str else "")
    fig.suptitle("\n".join(wrap(fig_title, 75)), fontsize="medium")

    mean_data = np.asarray(mean_data).flatten()
    trimodal_poses = _to_poses(output_trimodal, mean_data)
    output_poses = _to_poses(output, mean_data)
    target_poses = _to_poses(target, mean_data)

    def animate(i):
        panels = [("human", target_poses), ("trimodal", trimodal_poses),
                  ("ours", output_poses)]
        for k, (name, poses) in enumerate(panels):
            if poses is None or i >= len(poses):
                continue
            pose = poses[i]
            axes[k].clear()
            for pair in C.DIR_VEC_PAIRS:
                axes[k].plot([pose[pair[0], 0], pose[pair[1], 0]],
                             [pose[pair[0], 2], pose[pair[1], 2]],
                             [pose[pair[0], 1], pose[pair[1], 1]],
                             zdir="z", linewidth=5)
            axes[k].set_xlim3d(-0.5, 0.5)
            axes[k].set_ylim3d(0.5, -0.5)
            axes[k].set_zlim3d(0.5, -0.5)
            axes[k].set_xlabel("x")
            axes[k].set_ylabel("z")
            axes[k].set_zlabel("y")
            axes[k].set_title(f"{name} ({i + 1}/{len(output_poses)})")

    num_frames = len(output_poses) if target is None else max(
        len(target_poses), len(output_poses))
    ani = animation.FuncAnimation(fig, animate, interval=30, frames=num_frames,
                                  repeat=False)

    os.makedirs(save_path, exist_ok=True)
    audio_path = None
    if audio is not None:
        audio = np.asarray(audio, np.float32)
        audio_path = f"{save_path}/{prefix}_{epoch:03d}_{iter_idx}.wav"
        wavfile.write(audio_path, C.AUDIO_SR, np.int16(np.clip(audio, -1, 1) * 32767))

    have_ffmpeg = shutil.which("ffmpeg") is not None
    if have_ffmpeg:
        video_path = f"{save_path}/temp_{prefix}_{epoch:03d}_{iter_idx}.mp4"
        ani.save(video_path, fps=fps, dpi=80)
    else:
        video_path = f"{save_path}/{prefix}_{epoch:03d}_{iter_idx}.gif"
        ani.save(video_path, fps=fps, dpi=60, writer="pillow")
    plt.close(fig)

    final_path = video_path
    if audio is not None and have_ffmpeg:
        final_path = f"{save_path}/{prefix}_{epoch:03d}_{iter_idx}.mp4"
        cmd = ["ffmpeg", "-loglevel", "panic", "-y", "-i", video_path,
               "-i", audio_path, "-strict", "-2"]
        if clipping_to_shortest_stream:
            cmd.append("-shortest")
        cmd.append(final_path)
        subprocess.call(cmd)
        if delete_audio_file and audio_path:
            os.remove(audio_path)
        os.remove(video_path)

    return {
        "video_path": final_path,
        "audio_path": audio_path,
        "trimodal_poses": trimodal_poses,
        "output_poses": output_poses,
        "target_poses": target_poses,
        "render_seconds": time.time() - start,
        "audio_muxed": have_ffmpeg and audio is not None,
    }


def save_generation_pkl(save_path: str, filename_prefix: str, suffix: str,
                        sentence: str, audio: np.ndarray, out_dir_vec: np.ndarray,
                        out_poses: np.ndarray, human_dir_vec: np.ndarray,
                        aux_info: str) -> str:
    """Pickle a generated clip as a plain dict of numpy arrays and strings
    (ref processor_v2.py:1418-1437); returns its path."""
    save_dict = {
        "sentence": sentence,
        "audio": np.asarray(audio, np.float32),
        "out_dir_vec": out_dir_vec,
        "out_poses": out_poses,
        "aux_info": aux_info,
        "human_dir_vec": human_dir_vec,
    }
    os.makedirs(save_path, exist_ok=True)
    path = os.path.join(save_path, f"{filename_prefix}_{suffix}.pkl")
    with open(path, "wb") as f:
        pickle.dump(save_dict, f)
    return path
