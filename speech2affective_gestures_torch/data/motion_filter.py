"""Motion-quality filtering of pose windows.

Capability parity with reference `utils/motion_preprocessor.py`: reject
windows that are (a) too close to the mean pose, (b) have a bent spine
(max > 30 deg or mean > 20 deg from vertical), or (c) have near-static
wrists (sum-of-variance < 0.0014 on both sides). Vectorized numpy — no
per-frame Python loop.
"""

from __future__ import annotations

import numpy as np

POSE_DIFF_THRESHOLD = 0.02
SPINE_MAX_DEG = 30.0
SPINE_MEAN_DEG = 20.0
STATIC_VAR_THRESHOLD = 0.0014
LEFT_WRIST, RIGHT_WRIST = 6, 9


def check_pose_diff(skeletons: np.ndarray, mean_pose: np.ndarray) -> bool:
    """True = reject (mean |pose - mean_pose| below threshold)."""
    mean_pose = np.asarray(mean_pose).reshape(-1, 3)
    return float(np.mean(np.abs(skeletons - mean_pose))) < POSE_DIFF_THRESHOLD


def check_spine_angle(skeletons: np.ndarray) -> bool:
    """True = reject (spine too far from the -y axis)."""
    spine = skeletons[:, 1] - skeletons[:, 0]
    spine = spine / np.linalg.norm(spine, axis=-1, keepdims=True)
    cos = np.clip(spine @ np.array([0.0, -1.0, 0.0]), -1.0, 1.0)
    angles = np.degrees(np.arccos(cos))
    return bool(angles.max() > SPINE_MAX_DEG or angles.mean() > SPINE_MEAN_DEG)


def check_static_motion(skeletons: np.ndarray) -> bool:
    """True = reject (both wrists nearly static)."""
    lvar = float(np.sum(np.var(skeletons[:, LEFT_WRIST], axis=0)))
    rvar = float(np.sum(np.var(skeletons[:, RIGHT_WRIST], axis=0)))
    return lvar < STATIC_VAR_THRESHOLD and rvar < STATIC_VAR_THRESHOLD


def filter_motion(skeletons, mean_pose) -> tuple[np.ndarray | None, str]:
    """Apply the three checks in reference order; returns (skeletons|None,
    filtering_message) — message in {'PASS','pose','spine angle','motion'}."""
    skeletons = np.asarray(skeletons, dtype=np.float64)
    if skeletons.size == 0:
        return None, "PASS"
    if check_pose_diff(skeletons, mean_pose):
        return None, "pose"
    if check_spine_angle(skeletons):
        return None, "spine angle"
    if check_static_motion(skeletons):
        return None, "motion"
    assert not np.isnan(skeletons).any(), "missing joints"
    return skeletons, "PASS"
