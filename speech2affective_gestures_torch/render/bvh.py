"""BVH motion-capture files and forward kinematics, on the CPU (the port of
the JAX package's `render/bvh.py`; reference `utils/mocap_dataset.py`):

- `load_bvh` parses a BVH file into joint names, parents, offsets, world
  positions, sign-continuous quaternions and its frame rate; the GENEA
  route of `train/clip_eval.py` reads its poses with it;
- `forward_kinematics` is the batched quaternion FK;
- `save_as_bvh` writes a hierarchy with a 6-channel root.

Quaternions are (w, x, y, z), their Euler formulas `ops.quaternions`'.
The rotations and FK run in float32, as the JAX package runs them.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..ops import quaternions as Q


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def from_euler(es: np.ndarray, order: str) -> np.ndarray:
    """Euler angles in radians, the columns in `order`'s axis order ->
    local-frame quaternions (ref utils/Quaternions.py:499-511), float32."""
    axes = {"x": 0, "y": 1, "z": 2}

    def axis_quat(angle, axis_name):
        q = np.zeros(angle.shape + (4,))
        q[..., 0] = np.cos(angle / 2)
        q[..., 1 + axes[axis_name]] = np.sin(angle / 2)
        return _f32(q)

    q0, q1, q2 = (axis_quat(es[..., k], order[k]) for k in range(3))
    return Q.qmul(q0, Q.qmul(q1, q2)).numpy()


def forward_kinematics(rotations, root_positions, parents, offsets) -> np.ndarray:
    """Batched FK: rotations (N, L, J, 4), root_positions (N, L, 3), offsets
    (J, 3) -> world joint positions (N, L, J, 3), float32."""
    rotations = _f32(rotations)
    root_positions = _f32(root_positions)
    offsets = _f32(offsets)
    n, length, j, _ = rotations.shape
    positions: list = [None] * j
    world_rots: list = [None] * j
    for i in range(j):
        if parents[i] == -1:
            positions[i] = root_positions
            world_rots[i] = rotations[:, :, 0]
        else:
            off = offsets[i].expand(n, length, 3)
            positions[i] = Q.qrot(world_rots[parents[i]], off) + positions[parents[i]]
            world_rots[i] = Q.qmul(world_rots[parents[i]], rotations[:, :, i])
    return torch.stack(positions, dim=2).numpy()


def load_bvh(file_name: str):
    """Parse a BVH file (ref utils/mocap_dataset.py:70-227): every frame,
    the rotation order from the file's CHANNELS lines. Returns (names,
    parents, offsets, world positions (F, J, 3), quaternions (F, J, 4),
    frames per second)."""
    channel_map = {"Xrotation": "x", "Yrotation": "y", "Zrotation": "z"}
    names: list[str] = []
    offsets = np.zeros((0, 3))
    parents = np.array([], dtype=int)
    active = -1
    end_site = False
    i = 0
    positions = rotations = order = None
    frame_time = 1.0 / 30
    channels = 3

    with open(file_name) as f:
        for line in f:
            if "HIERARCHY" in line or "MOTION" in line or "{" in line:
                continue
            if "}" in line:
                if end_site:
                    end_site = False
                else:
                    active = parents[active]
                continue
            m = re.match(r"ROOT (\w+)", line) or re.match(r"\s*JOINT\s+(\w+)", line)
            if m:
                names.append(m.group(1))
                offsets = np.append(offsets, np.zeros((1, 3)), axis=0)
                parents = np.append(parents, active)
                active = len(parents) - 1
                continue
            m = re.match(r"\s*OFFSET\s+([\-\d\.e]+)\s+([\-\d\.e]+)\s+([\-\d\.e]+)", line)
            if m:
                if not end_site:
                    offsets[active] = np.array(list(map(float, m.groups())))
                continue
            m = re.match(r"\s*CHANNELS\s+(\d+)", line)
            if m:
                channels = int(m.group(1))
                if order is None:
                    ci = 0 if channels == 3 else 3
                    parts = line.split()[2 + ci:2 + ci + 3]
                    if all(p in channel_map for p in parts):
                        order = "".join(channel_map[p] for p in parts)
                continue
            if "end site" in line.lower():
                end_site = True
                continue
            m = re.match(r"\s*Frames:\s+(\d+)", line)
            if m:
                frame_num = int(m.group(1))
                positions = offsets[None].repeat(frame_num, axis=0)
                rotations = np.zeros((frame_num, len(parents), 3))
                continue
            m = re.match(r"\s*Frame Time:\s+([\d\.]+)", line)
            if m:
                frame_time = float(m.group(1))
                continue
            data = line.strip().split(" ")
            if data and data[0]:
                block = np.array(list(map(float, data)))
                if i >= len(rotations):
                    break
                n_joints = len(parents)
                if channels == 3:
                    positions[i, 0:1] = block[0:3]
                    rotations[i, :] = block[3:].reshape(n_joints, 3)
                elif channels == 6:
                    block = block.reshape(n_joints, 6)
                    positions[i, :] = block[:, 0:3]
                    rotations[i, :] = block[:, 3:6]
                else:
                    raise ValueError(f"unsupported channel count {channels}")
                i += 1

    quats = Q.qfix(_f32(from_euler(np.radians(rotations), order))).numpy()
    world_pos = forward_kinematics(quats[None], positions[None, :, 0], parents, offsets)[0]
    return names, parents, offsets, world_pos, quats, 1.0 / frame_time


def _write_hierarchy(f, names, offsets, children, joint, tabs, rot_string):
    for child in children[joint]:
        f.write(f"{tabs}JOINT {names[child]}\n{tabs}{{\n")
        f.write(f"{tabs}\tOFFSET {offsets[child][0]:.6f} "
                f"{offsets[child][1]:.6f} {offsets[child][2]:.6f}\n")
        f.write(f"{tabs}\tCHANNELS 3 {rot_string}\n")
        if children[child]:
            _write_hierarchy(f, names, offsets, children, child, tabs + "\t", rot_string)
        else:
            f.write(f"{tabs}\tEnd Site\n{tabs}\t{{\n"
                    f"{tabs}\t\tOFFSET 0.000000 0.000000 0.000000\n"
                    f"{tabs}\t}}\n")
        f.write(f"{tabs}}}\n")


def save_as_bvh(animation: dict, save_path: str, frame_time: float = 0.032) -> str:
    """Write one animation {'joint_names', 'joint_offsets' (J-1, 3) or (J, 3),
    'joint_parents', 'positions' (L, J, 3), 'rotations' (L, J, 4)} to
    save_path/root.bvh (ref utils/mocap_dataset.py:257-357), after a first
    frame of the default pose (the root at its first position, every angle
    0); returns its path."""
    names = animation["joint_names"]
    parents = list(animation["joint_parents"])
    offsets = np.asarray(animation["joint_offsets"])
    if len(offsets) == len(parents) - 1:  # the reference prepends a zero root
        offsets = np.concatenate([np.zeros((1, 3)), offsets], axis=0)
    rotations = np.asarray(animation["rotations"])                # (L, J, 4)
    trajectory = np.asarray(animation["positions"])[:, 0]         # (L, 3)
    num_frames, num_joints = rotations.shape[:2]

    children: list[list[int]] = [[] for _ in parents]
    for j, p in enumerate(parents):
        if p != -1:
            children[p].append(j)

    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, "root.bvh")
    rot_string = "Xrotation Yrotation Zrotation"
    eulers = np.degrees(Q.qeuler(_f32(rotations), "xyz").numpy())  # (L, J, 3)
    with open(out, "w") as f:
        f.write("HIERARCHY\n")
        f.write(f"ROOT {names[0]}\n{{\n")
        f.write(f"\tOFFSET {offsets[0][0]:.6f} {offsets[0][1]:.6f} {offsets[0][2]:.6f}\n")
        f.write(f"\tCHANNELS 6 Xposition Yposition Zposition {rot_string}\n")
        _write_hierarchy(f, names, offsets, children, 0, "\t", rot_string)
        f.write("}\n")
        f.write(f"MOTION\nFrames: {num_frames + 1}\nFrame Time: {frame_time}\n")
        f.write(" ".join(map(str, trajectory[0])) + " 0.000000" * (num_joints * 3) + "\n")
        for t in range(num_frames):
            vals = [str(trajectory[t, 0]), str(trajectory[t, 1]), str(trajectory[t, 2])]
            vals += [f"{e:.6f}" for e in eulers[t].reshape(-1)]
            f.write(" ".join(vals) + "\n")
    return out
