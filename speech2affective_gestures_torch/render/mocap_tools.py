"""Mocap processing toolkit — the used subset of the vendored PyMO package.

Capability parity with the reference's `utils/pymo/` (vendored BVH toolkit,
imported by utils/common.py:13-16; not in the v2 train loop): a MocapData
container, BVH parse/write built on `render.bvh`, and the common
transformations of `pymo.preprocessing` — parameterization to
euler/quaternion/expmap/world-position, joint selection, mirroring,
root-relative transforms, temporal downsampling and array conversion
(Numpyfier). Implemented functionally on numpy, with the port's
`ops/quaternions.py` (float32, as the JAX package's `render/mocap_tools.py`
computes) and `render/bvh.py`, rather than as sklearn transformers; each
function maps 1:1 onto a PyMO class. The plots import matplotlib when they
run, and raise an ImportError that names it where it is not installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import quaternions as Q
from . import bvh as bvh_mod


@dataclasses.dataclass
class MocapData:
    """Skeleton + per-frame channel data (pymo.data.MocapData)."""

    joint_names: list[str]
    parents: np.ndarray          # (J,)
    offsets: np.ndarray          # (J, 3)
    rotations: np.ndarray        # (L, J, 4) quaternions (w, x, y, z)
    root_positions: np.ndarray   # (L, 3)
    framerate: float

    @property
    def n_frames(self) -> int:
        return len(self.rotations)

    def clone(self) -> "MocapData":
        return MocapData(
            list(self.joint_names), self.parents.copy(), self.offsets.copy(),
            self.rotations.copy(), self.root_positions.copy(), self.framerate,
        )


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the mocap plots need matplotlib, which is not installed") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def parse_bvh(path: str) -> MocapData:
    """pymo.parsers.BVHParser equivalent."""
    names, parents, offsets, world_pos, quats, fps = bvh_mod.load_bvh(path)
    return MocapData(
        joint_names=names, parents=np.asarray(parents),
        offsets=np.asarray(offsets), rotations=np.asarray(quats),
        root_positions=np.asarray(world_pos[:, 0]), framerate=fps,
    )


def write_bvh(data: MocapData, out_dir: str, frame_time: float | None = None):
    """pymo.writers.BVHWriter equivalent."""
    positions = np.zeros((data.n_frames, len(data.joint_names), 3))
    positions[:, 0] = data.root_positions
    return bvh_mod.save_as_bvh(
        {
            "joint_names": data.joint_names,
            "joint_parents": list(data.parents),
            "joint_offsets": data.offsets,
            "positions": positions,
            "rotations": data.rotations,
        },
        out_dir,
        frame_time=frame_time or 1.0 / data.framerate,
        include_default_pose=False,
    )


# --- parameterizations (pymo.preprocessing.MocapParameterizer) -------------

def to_euler(data: MocapData, order: str = "zyx") -> np.ndarray:
    """(L, J, 3) Euler angles in radians."""
    return Q.qeuler(_f32(data.rotations), order=order).numpy()


def to_expmap(data: MocapData) -> np.ndarray:
    """(L, J, 3) exponential-map rotations."""
    q = data.rotations
    w = np.clip(q[..., 0], -1.0, 1.0)
    angle = 2.0 * np.arccos(w)
    sin_half = np.sqrt(np.maximum(1.0 - w * w, 1e-12))
    axis = q[..., 1:] / sin_half[..., None]
    return axis * angle[..., None]


def from_expmap(expmap: np.ndarray) -> np.ndarray:
    return Q.expmap_to_quaternion(_f32(expmap)).numpy()


def to_positions(data: MocapData) -> np.ndarray:
    """(L, J, 3) world joint positions via batched FK."""
    return bvh_mod.forward_kinematics(
        data.rotations[None].astype(np.float32),
        data.root_positions[None].astype(np.float32),
        list(data.parents), data.offsets.astype(np.float32),
    )[0]


# --- structural transforms -------------------------------------------------

def select_joints(data: MocapData, keep: list[str]) -> MocapData:
    """pymo JointSelector: keep the named joints (plus any ancestors needed
    to keep the hierarchy connected)."""
    keep_idx = set()
    name_to_idx = {n: i for i, n in enumerate(data.joint_names)}
    for name in keep:
        j = name_to_idx[name]
        while j != -1 and j not in keep_idx:
            keep_idx.add(j)
            j = data.parents[j]
    old_order = sorted(keep_idx)
    remap = {old: new for new, old in enumerate(old_order)}
    new_parents = np.array([
        remap[data.parents[j]] if data.parents[j] in remap else -1
        for j in old_order
    ])
    return MocapData(
        joint_names=[data.joint_names[j] for j in old_order],
        parents=new_parents,
        offsets=data.offsets[old_order],
        rotations=data.rotations[:, old_order],
        root_positions=data.root_positions,
        framerate=data.framerate,
    )


def mirror(data: MocapData, axis: str = "X",
           left_prefix: str = "Left", right_prefix: str = "Right") -> MocapData:
    """pymo Mirror: flip across an axis and swap left/right joints."""
    ai = {"X": 0, "Y": 1, "Z": 2}[axis]
    out = data.clone()
    swap = list(range(len(data.joint_names)))
    for i, name in enumerate(data.joint_names):
        if name.startswith(left_prefix):
            twin = right_prefix + name[len(left_prefix):]
        elif name.startswith(right_prefix):
            twin = left_prefix + name[len(right_prefix):]
        else:
            continue
        if twin in data.joint_names:
            swap[i] = data.joint_names.index(twin)
    out.rotations = out.rotations[:, swap].copy()
    out.offsets = out.offsets[swap].copy()
    out.offsets[:, ai] *= -1
    # negate the mirrored rotation components: w and the mirror axis stay
    comp = [1 + k for k in range(3) if k != ai]
    out.rotations[..., comp] *= -1
    out.root_positions = out.root_positions.copy()
    out.root_positions[:, ai] *= -1
    return out


def root_relative(data: MocapData) -> MocapData:
    """pymo RootTransformer('pos_rot_deltas' light variant): zero the root
    trajectory, keeping motion root-relative."""
    out = data.clone()
    out.root_positions = out.root_positions - out.root_positions[0:1]
    return out


def downsample(data: MocapData, factor: int) -> MocapData:
    """pymo DownSampler: keep every `factor`-th frame."""
    out = data.clone()
    out.rotations = out.rotations[::factor]
    out.root_positions = out.root_positions[::factor]
    out.framerate = data.framerate / factor
    return out


def numpyfy(data: MocapData) -> np.ndarray:
    """pymo Numpyfier: flat (L, 3 + J*4) array [root_pos | quats]."""
    l, j, _ = data.rotations.shape
    return np.concatenate(
        [data.root_positions, data.rotations.reshape(l, j * 4)], axis=1
    )


# --------------------------------------------------------------------------
# foot-contact features (pymo.features, utils/pymo/features.py:12-33)
# --------------------------------------------------------------------------

def peak_indexes(y: np.ndarray, thres: float = 0.3,
                 min_dist: int = 1) -> np.ndarray:
    """Local-maxima indices with a normalized threshold and minimum
    separation — the peakutils.indexes semantics the reference's
    features.py relies on (peakutils is not vendored; reimplemented):
    peaks are strict local maxima above thres*(max-min)+min, and when two
    peaks fall within min_dist of each other only the higher survives."""
    y = np.asarray(y, float)
    if len(y) < 3:
        return np.array([], int)
    floor = thres * (y.max() - y.min()) + y.min()
    rising = y[1:-1] > y[:-2]
    falling = y[1:-1] > y[2:]
    candidates = np.where(rising & falling & (y[1:-1] > floor))[0] + 1
    if min_dist > 1 and len(candidates) > 1:
        keep = np.ones(len(candidates), bool)
        order = np.argsort(-y[candidates])  # highest first
        for rank in order:
            if not keep[rank]:
                continue
            too_close = np.abs(candidates - candidates[rank]) < min_dist
            too_close[rank] = False
            keep &= ~too_close
        candidates = np.sort(candidates[keep])
    return candidates


def foot_contact_idxs(signal: np.ndarray, t: float = 0.02,
                      min_dist: int = 120):
    """[up_idxs, down_idxs] of a foot-height signal
    (features.get_foot_contact_idxs, :12-16)."""
    signal = np.asarray(signal, float)
    up = peak_indexes(signal, thres=t / signal.max(), min_dist=min_dist)
    down = peak_indexes(-signal, thres=t / signal.min(), min_dist=min_dist)
    return [up, down]


def foot_contact_signal(signal: np.ndarray, start: int = 1, t: float = 0.02,
                        min_dist: int = 120) -> list:
    """Binary contact track: 0 after a down-peak, 1 after an up-peak
    (features.create_foot_contact_signal, :19-33). Accepts a plain 1-D
    height signal (the reference pulls it from a pandas track)."""
    signal = np.asarray(signal, float)
    up, down = foot_contact_idxs(signal, t, min_dist)
    up_set, down_set = set(up.tolist()), set(down.tolist())
    out, c = [], start
    for f in range(len(signal)):
        if f in down_set:
            c = 0
        elif f in up_set:
            c = 1
        out.append(c)
    return out


def plot_foot_up_down(signal: np.ndarray, t: float = 0.02,
                      min_dist: int = 120, ax=None):
    """features.plot_foot_up_down (:35-42) on a matplotlib axis."""
    plt = _pyplot()

    signal = np.asarray(signal, float)
    up, down = foot_contact_idxs(signal, t, min_dist)
    ax = ax or plt.gca()
    frames = np.arange(len(signal))
    ax.plot(frames, signal)
    ax.plot(frames[up], signal[up], "ro")
    ax.plot(frames[down], signal[down], "go")
    return ax


# --------------------------------------------------------------------------
# stick-figure drawing (pymo viz_tools)
# --------------------------------------------------------------------------
# Ports of the reference's notebook drawing helpers
# (utils/pymo/viz_tools.py:7-165) onto the array-backed MocapData: the
# skeleton dict/DataFrame lookups become parents-array walks over world
# positions from `to_positions`. The notebook mocap player
# (viz_tools.py:167-235, nb_play_mocap*) is NOT ported: it only serves a
# bundled JavaScript player asset (utils/pymo/mocapplayer/) absent here,
# like the Blender .blend asset.

def _children(data: MocapData) -> list[list[int]]:
    out: list[list[int]] = [[] for _ in data.joint_names]
    for j, p in enumerate(data.parents):
        if p >= 0:
            out[int(p)].append(j)
    return out


def _viz_positions(data: MocapData, positions) -> np.ndarray:
    if positions is None:
        positions = to_positions(data)
    return np.asarray(positions)


def save_fig(fig_id: str, tight_layout: bool = True):
    """viz_tools.save_fig (:7-10): write the current figure as <id>.png."""
    plt = _pyplot()

    if tight_layout:
        plt.tight_layout()
    plt.savefig(fig_id + ".png", format="png", dpi=300)


def draw_stickfigure(data: MocapData, frame: int, positions=None,
                     joints=None, draw_names: bool = False, ax=None,
                     figsize=(8, 8)):
    """2-D (X, Y) stick figure of one frame (viz_tools.draw_stickfigure,
    :13-48). `positions` lets callers pass precomputed (L, J, 3) world
    positions (the reference's `data=` DataFrame argument)."""
    plt = _pyplot()

    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
    pos = _viz_positions(data, positions)[frame]
    keep = (set(joints) if joints is not None else set(data.joint_names))
    children = _children(data)
    for j, name in enumerate(data.joint_names):
        if name not in keep:
            continue
        ax.scatter(x=pos[j, 0], y=pos[j, 1], alpha=0.6, c="b", marker="o")
        for c in children[j]:
            if data.joint_names[c] in keep:
                ax.plot([pos[j, 0], pos[c, 0]], [pos[j, 1], pos[c, 1]],
                        "k-", lw=2)
        if draw_names:
            ax.annotate(name, (pos[j, 0] + 0.1, pos[j, 1] + 0.1))
    return ax


def draw_stickfigure3d(data: MocapData, frame: int, positions=None,
                       joints=None, draw_names: bool = False, ax=None,
                       figsize=(8, 8)):
    """3-D stick figure of one frame (viz_tools.draw_stickfigure3d, :50-97).
    Mocap Y is up, so axes are plotted as (X, Z, Y) like the reference."""
    plt = _pyplot()

    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111, projection="3d")
    pos = _viz_positions(data, positions)[frame]
    keep = (set(joints) if joints is not None else set(data.joint_names))
    children = _children(data)
    for j, name in enumerate(data.joint_names):
        if name not in keep:
            continue
        x, y, z = pos[j, 0], pos[j, 2], pos[j, 1]
        ax.scatter(xs=x, ys=y, zs=z, alpha=0.6, c="b", marker="o")
        for c in children[j]:
            if data.joint_names[c] in keep:
                ax.plot([x, pos[c, 0]], [y, pos[c, 2]], [z, pos[c, 1]],
                        "k-", lw=2, c="black")
        if draw_names:
            ax.text(x=x + 0.1, y=y + 0.1, z=z + 0.1, s=name, color="black")
    return ax


def sketch_move(data: MocapData, positions=None, ax=None, figsize=(16, 8),
                stride: int = 4):
    """Ghosted every-`stride`-frames motion sketch (viz_tools.sketch_move,
    :99-123): bone segments drawn in gray with alpha ramping over time."""
    plt = _pyplot()

    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
    pos = _viz_positions(data, positions)
    children = _children(data)
    n = pos.shape[0]
    for frame in range(0, n, stride):
        alpha = frame / n
        for j in range(len(data.joint_names)):
            for c in children[j]:
                ax.plot([pos[frame, j, 0], pos[frame, c, 0]],
                        [pos[frame, j, 1], pos[frame, c, 1]],
                        "-", lw=1, color="gray", alpha=alpha)
    return ax


def viz_cnn_filter(feature_to_viz: np.ndarray, data: MocapData,
                   positions=None, gap: int = 25):
    """Per-frame per-joint activation strip next to the unrolled skeleton
    (viz_tools.viz_cnn_filter, :126-153): marker color/size scale with the
    feature value; frames offset horizontally by `gap`."""
    plt = _pyplot()

    feature_to_viz = np.asarray(feature_to_viz)
    pos = _viz_positions(data, positions)
    children = _children(data)
    fig = plt.figure(figsize=(16, 4))
    ax = plt.subplot2grid((1, 8), (0, 0))
    ax.imshow(feature_to_viz.T, aspect="auto", interpolation="nearest")
    ax = plt.subplot2grid((1, 8), (0, 1), colspan=7)
    for frame in range(feature_to_viz.shape[0]):
        for j in range(len(data.joint_names)):
            px = pos[frame, j, 0] + frame * gap
            py = pos[frame, j, 1]
            v = feature_to_viz[frame][j] * 10000
            ax.scatter(x=px, y=py, alpha=0.6, cmap="RdBu", c=v, marker="o",
                       s=abs(v))
            plt.axis("off")
            for c in children[j]:
                ax.plot([px, pos[frame, c, 0] + frame * gap],
                        [py, pos[frame, c, 1]],
                        "-", lw=1, color="gray", alpha=0.2)
    return fig


def print_skel(data: MocapData) -> str:
    """Indented skeleton tree (viz_tools.print_skel, :156-164); returns the
    text it prints so tests/tools can capture it."""
    children = _children(data)
    root = int(np.flatnonzero(data.parents < 0)[0])
    lines = []
    stack = [root]
    while stack:
        j = stack.pop()
        tab = len(stack)
        parent = data.parents[j]
        pname = data.joint_names[int(parent)] if parent >= 0 else None
        lines.append("%s- %s (%s)" % ("| " * tab, data.joint_names[j], pname))
        stack.extend(children[j])
    text = "\n".join(lines)
    print(text)
    return text
