"""The port's quaternion ops, BVH reader and writer, video writer and pose
helpers (`ops/quaternions.py`, `render/bvh.py`, `render/video.py`,
`ops/pose.convert_pose_seq_to_dir_vec`, `data/preprocessor.resample_pose_seq`)
against the JAX package's, on the CPU.

Tolerances: the quaternion ops 1e-6 absolute in float32 (a few rounded
products and sums, angles in radians, at gimbal lock too); the BVH readers 1e-5 relative to
each value plus 1e-5 absolute (float32 FK down a 31-joint chain whose
positions reach ~40, each joint's rotation a product of the chain's);
the direction vectors 1e-6 in float32, 1e-12 in float64 against numpy;
the resampled poses exactly (the same scipy call).
"""

import builtins
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.data import preprocessor as tprep
from speech2affective_gestures_torch.ops import pose as tpose
from speech2affective_gestures_torch.ops import quaternions as TQ
from speech2affective_gestures_torch.render import bvh as tbvh
from speech2affective_gestures_torch.render import video as tvideo
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.data import preprocessor as jprep
from speech2affective_gestures_tpu.ops import pose as jpose
from speech2affective_gestures_tpu.ops import quaternions as JQ
from speech2affective_gestures_tpu.render import bvh as jbvh

ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")


def _quats(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _case(name, rng):
    """(port function, JAX function, float32 inputs) of one op."""
    if name == "qmul":
        return TQ.qmul, JQ.qmul, (_quats(rng, (5, 7)), _quats(rng, (5, 7)))
    if name == "qrot":
        return TQ.qrot, JQ.qrot, (_quats(rng, (5, 7)),
                                  rng.standard_normal((5, 7, 3)).astype(np.float32))
    if name == "qfix":
        q = _quats(rng, (12, 3))
        q[1::3] *= -1.0
        return TQ.qfix, JQ.qfix, (q,)
    q = _quats(rng, (5, 7))
    order = name.split(":")[0].removeprefix("qeuler_")
    if name.endswith(":gimbal"):
        # 90 degrees either way about the order's middle axis: the arcsin's
        # input, 2 (q1 q3 + q0 q2) in xyz, rounds to +-1 and past it
        half = np.float32(np.sqrt(0.5))
        axis = 1 + "xyz".index(order[1])
        q[:] = 0.0
        q[..., 0] = half
        q[:, :3, axis], q[:, 3:, axis] = half, -half
    return (lambda x: TQ.qeuler(x, order)), (lambda x: JQ.qeuler(x, order)), (q,)


@pytest.mark.parametrize("name", ["qmul", "qrot", "qfix",
                                  *(f"qeuler_{o}" for o in ORDERS), "qeuler_xyz:gimbal"])
def test_quaternion_op_matches_jax(name):
    port, ref, args = _case(name, np.random.default_rng(0))
    got = port(*(torch.from_numpy(a) for a in args))
    want = np.asarray(ref(*(jnp.asarray(a) for a in args)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_qfix_keeps_the_sign_continuous():
    q = _quats(np.random.default_rng(1), (20, 4))
    q[5:] *= -1.0
    fixed = TQ.qfix(torch.from_numpy(q)).numpy()
    assert ((fixed[1:] * fixed[:-1]).sum(-1) >= 0).all()
    np.testing.assert_array_equal(np.abs(fixed), np.abs(q))


def _chain_animation(n_joints=31, n_frames=40):
    """A chain of unit offsets rotating gently about z and x (the GENEA
    tests' skeleton), its root at height 10."""
    parents = [-1] + list(range(n_joints - 1))
    offsets = np.zeros((n_joints, 3), np.float32)
    offsets[1:, 1] = 1.0
    t = np.linspace(0, 4 * np.pi, n_frames)[:, None]
    ang = 0.15 * np.sin(t + np.linspace(0, 2, n_joints)[None])
    half = ang / 2
    quats = np.zeros((n_frames, n_joints, 4), np.float32)
    quats[..., 0] = np.cos(half) * np.cos(half / 2)
    quats[..., 1] = np.cos(half) * np.sin(half / 2)
    quats[..., 3] = np.sin(half) * np.cos(half / 2)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    positions = np.zeros((n_frames, n_joints, 3), np.float32)
    positions[:, 0, 1] = 10.0
    positions[:, 0, 0] = np.linspace(0, 0.5, n_frames)
    return {"joint_names": [f"j{k}" for k in range(n_joints)], "joint_offsets": offsets,
            "joint_parents": parents, "positions": positions, "rotations": quats}


def _assert_bvh_equal(got, want):
    names, parents, offsets, pos, quats, fps = got
    w_names, w_parents, w_offsets, w_pos, w_quats, w_fps = want
    assert names == w_names and fps == w_fps
    np.testing.assert_array_equal(parents, w_parents)
    np.testing.assert_array_equal(offsets, w_offsets)
    assert pos.dtype == w_pos.dtype == np.float32 and quats.dtype == w_quats.dtype
    np.testing.assert_allclose(pos, w_pos, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(quats, w_quats, rtol=1e-5, atol=1e-5)


def test_load_bvh_of_jax_file_matches_jax(tmp_path):
    path = jbvh.save_as_bvh(_chain_animation(), str(tmp_path), frame_time=1.0 / 30)
    got = tbvh.load_bvh(path)
    _assert_bvh_equal(got, jbvh.load_bvh(path))
    assert got[3].shape == (41, 31, 3) and got[5] == pytest.approx(30.0)


def test_save_as_bvh_read_back_by_jax(tmp_path):
    anim = _chain_animation()
    port_file = tbvh.save_as_bvh(anim, str(tmp_path / "port"), frame_time=1.0 / 30)
    jax_file = jbvh.save_as_bvh(anim, str(tmp_path / "jax"), frame_time=1.0 / 30)
    _assert_bvh_equal(jbvh.load_bvh(port_file), jbvh.load_bvh(jax_file))


@pytest.mark.parametrize("order", ORDERS)
def test_fk_and_from_euler_match_jax(order):
    rng = np.random.default_rng(2)
    angles = rng.uniform(-0.5, 0.5, (6, 4, 3))
    np.testing.assert_allclose(tbvh.from_euler(angles, order),
                               jbvh.from_euler(angles, order), atol=1e-6)
    quats = tbvh.from_euler(angles, order)[None]
    roots = rng.standard_normal((1, 6, 3)).astype(np.float32)
    parents, offsets = [-1, 0, 1, 1], rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_allclose(tbvh.forward_kinematics(quats, roots, parents, offsets),
                               jbvh.forward_kinematics(quats, roots, parents, offsets),
                               atol=1e-6)


def _write_bvh(path, rot_order: str, six_everywhere: bool, n_frames=25):
    """A BVH file as motion-capture tools write it, unlike `save_as_bvh`:
    the rotation channels in `rot_order`, a branching skeleton with End
    Sites, and either a 6-channel root over 3-channel joints or 6 channels
    on every joint."""
    rng = np.random.default_rng(8)
    parents = [-1, 0, 1, 2, 1, 4, 0]
    n = len(parents)
    rot = " ".join(f"{a.upper()}rotation" for a in rot_order)
    lines = ["HIERARCHY"]

    def joint(j, tabs):
        kind = "ROOT" if j == 0 else "JOINT"
        lines.append(f"{tabs}{kind} j{j}")
        lines.append(f"{tabs}{{")
        off = rng.uniform(-3, 3, 3) if j else np.zeros(3)
        lines.append(f"{tabs}\tOFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        six = j == 0 or six_everywhere
        pos = "Xposition Yposition Zposition " if six else ""
        lines.append(f"{tabs}\tCHANNELS {6 if six else 3} {pos}{rot}")
        kids = [c for c, p in enumerate(parents) if p == j]
        for c in kids:
            joint(c, tabs + "\t")
        if not kids:
            lines.extend([f"{tabs}\tEnd Site", f"{tabs}\t{{", f"{tabs}\t\tOFFSET 0.0 1.5 0.0",
                          f"{tabs}\t}}"])
        lines.append(f"{tabs}}}")

    joint(0, "")
    lines += ["MOTION", f"Frames: {n_frames}", "Frame Time: 0.033333"]
    for t in range(n_frames):
        angles = 40.0 * np.sin(0.2 * t + np.arange(3 * n).reshape(n, 3))
        root = [1.0 + 0.1 * t, 90.0, -2.0]
        if six_everywhere:
            vals = np.concatenate([np.tile(root, (n, 1)), angles], axis=1).reshape(-1)
        else:
            vals = np.concatenate([root, angles.reshape(-1)])
        lines.append(" ".join(f"{v:.6f}" for v in vals))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("layout", [*(f"{o}:root6" for o in ORDERS), "zxy:all6"])
def test_load_bvh_reads_channel_order_like_jax(tmp_path, layout):
    """The rotation order, the channel layout and the End Sites come from
    the file; the same tolerance as the files that `save_as_bvh` writes."""
    order, channels = layout.split(":")
    path = _write_bvh(tmp_path / "take.bvh", order, channels == "all6")
    got = tbvh.load_bvh(path)
    _assert_bvh_equal(got, jbvh.load_bvh(path))
    assert got[3].shape == (25, 7, 3) and got[5] == pytest.approx(30.0, rel=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resample_pose_seq_matches_jax(dtype):
    """The clips of the rendering tests: ~142 frames stitched at 15 fps
    over 9.47 s, and 240 GENEA frames at 30 fps over 8 s."""
    rng = np.random.default_rng(3)
    for n, duration in ((142, 9.466666666666667), (240, 8.0)):
        poses = rng.standard_normal((n, 10, 3)).astype(dtype)
        got = tprep.resample_pose_seq(poses, duration, 15)
        want = jprep.resample_pose_seq(poses, duration, 15)
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_pose_seq_to_dir_vec_matches_jax():
    """The port's one direction-vector function, for the rendering (float32
    tensors) and the corpus build (float64 arrays), against JAX's and the
    JAX preprocessor's numpy twin; a zero-length bone gives zeros."""
    rng = np.random.default_rng(4)
    poses = rng.standard_normal((3, 34, 10, 3))
    poses[0, 0, 1] = poses[0, 0, 0]
    got32 = tpose.convert_pose_seq_to_dir_vec(torch.from_numpy(poses.astype(np.float32)))
    want32 = np.asarray(jpose.convert_pose_seq_to_dir_vec(jnp.asarray(poses, jnp.float32)))
    np.testing.assert_allclose(got32.numpy(), want32, atol=1e-6)
    assert not got32[0, 0, 0].any()
    got64 = tpose.convert_pose_seq_to_dir_vec(torch.from_numpy(poses.reshape(3, 34, 30)))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), jprep._pose_seq_to_dir_vec_np(poses),
                               atol=1e-12)


def test_create_video_and_save_writes_a_gif(tmp_path):
    """matplotlib is here and ffmpeg is not: a GIF and the wav, no mux."""
    rng = np.random.default_rng(5)
    frames = 4
    vecs = [rng.standard_normal((frames, C.POSE_DIM)).astype(np.float32) * 0.05
            for _ in range(3)]
    audio = (0.2 * np.sin(np.arange(8000) / 20)).astype(np.float32)
    result = tvideo.create_video_and_save(str(tmp_path), 0, "clip", 0, *vecs,
                                          C.MEAN_DIR_VEC, "hello world", audio=audio,
                                          delete_audio_file=False)
    assert os.path.exists(result["video_path"]) and os.path.exists(result["audio_path"])
    if shutil.which("ffmpeg") is None:
        assert result["video_path"].endswith(".gif") and not result["audio_muxed"]
    want = np.asarray(jpose.convert_dir_vec_to_pose(jnp.asarray(vecs[2] + C.MEAN_DIR_VEC)))
    np.testing.assert_allclose(result["output_poses"], want, atol=1e-6)


def test_create_video_and_save_without_matplotlib_raises(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", blocked)
    vec = np.zeros((2, C.POSE_DIM), np.float32)
    with pytest.raises(ImportError, match="matplotlib"):
        tvideo.create_video_and_save(str(tmp_path), 0, "clip", 0, vec, vec, vec,
                                     C.MEAN_DIR_VEC, "t")
    assert not os.listdir(tmp_path)


def test_save_generation_pkl_plain_dict(tmp_path):
    import pickle

    vec = np.random.default_rng(6).standard_normal((10, C.POSE_DIM)).astype(np.float32)
    path = tvideo.save_generation_pkl(str(tmp_path), "clip", "s2ag", "hi",
                                      np.zeros(100, np.float64), vec, vec[:, :3], vec, "aux")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert sorted(blob) == ["audio", "aux_info", "human_dir_vec", "out_dir_vec",
                            "out_poses", "sentence"]
    assert blob["audio"].dtype == np.float32 and blob["aux_info"] == "aux"
    np.testing.assert_array_equal(blob["out_dir_vec"], vec)
