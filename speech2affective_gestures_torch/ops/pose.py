"""Direction vectors <-> joint positions (reference
`utils/ted_db_utils.py:81-124`): forward kinematics as one product with a
precomputed (joints x bones) matrix instead of the reference's per-bone
loop, and the unit bone directions of a pose sequence."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C


@functools.lru_cache(maxsize=None)
def fk_matrix() -> np.ndarray:
    """(NUM_JOINTS, NUM_BONES) matrix M with M[j, b] = bone_length[b] if bone
    b lies on the kinematic path from the root to joint j, else 0. Exact
    because the pairs are topologically ordered (parents precede children)."""
    m = np.zeros((C.NUM_JOINTS, C.NUM_BONES), dtype=np.float32)
    for b, (parent, child, length) in enumerate(C.DIR_VEC_PAIRS):
        m[child] = m[parent]
        m[child, b] = length
    return m


def convert_dir_vec_to_pose(vec: torch.Tensor) -> torch.Tensor:
    """vec (..., 9, 3) or (..., 27) -> joint positions (..., 10, 3)."""
    if vec.shape[-1] != C.COORDS:
        vec = vec.reshape(vec.shape[:-1] + (C.NUM_BONES, C.COORDS))
    m = torch.from_numpy(fk_matrix()).to(device=vec.device, dtype=vec.dtype)
    return torch.einsum("...bc,jb->...jc", vec, m)


def convert_pose_seq_to_dir_vec(pose: torch.Tensor) -> torch.Tensor:
    """Joint positions (..., 10, 3) or (..., 30) -> unit bone directions
    (..., 9, 3), in the input's dtype; a zero-length bone gives a zero
    vector (sklearn's `normalize`, ref utils/ted_db_utils.py:105-124)."""
    if pose.shape[-1] != C.COORDS:
        pose = pose.reshape(pose.shape[:-1] + (C.NUM_JOINTS, C.COORDS))
    parents = [p for p, _, _ in C.DIR_VEC_PAIRS]
    children = [c for _, c, _ in C.DIR_VEC_PAIRS]
    diff = pose[..., children, :] - pose[..., parents, :]
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    return diff / torch.where(norm > 0, norm, torch.ones_like(norm))
