"""The port's quaternion ops, its numpy `Quaternions` class and its mocap
toolkit (`ops/quaternions.py`, `ops/quaternions_np.py`,
`render/mocap_tools.py`) against the JAX package's.

- `qinv`, `expmap_to_quaternion` (a zero angle among the inputs) and
  `euler_to_quaternion` in the six orders: within 1e-6 of JAX's at
  float32 (both compute in float32; the JAX package's float32 sinc and
  trigonometry round differently from torch's).
- `Quaternions`: JAX's tests/test_quaternions_np.py cases run through both
  classes on seeded inputs; the port's is a copy, so the results are the
  same bits.
- `mocap_tools`: JAX's tests/test_mocap_tools.py cases through both
  modules on a seeded 4-joint skeleton: the arrays within 1e-6 (the
  quaternion ops' float32), the BVH files that each package writes read
  back by both packages, the plots' artists equal, `print_skel`'s text
  equal; the plots without matplotlib raise an ImportError naming it.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.ops import quaternions as TQ
from speech2affective_gestures_torch.ops.quaternions_np import Quaternions as TQuat
from speech2affective_gestures_torch.render import bvh as tbvh
from speech2affective_gestures_torch.render import mocap_tools as tmt
from speech2affective_gestures_tpu.ops import quaternions as JQ
from speech2affective_gestures_tpu.ops.quaternions_np import Quaternions as JQuat
from speech2affective_gestures_tpu.render import mocap_tools as jmt

ORDERS = ["xyz", "yzx", "zxy", "xzy", "yxz", "zyx"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _unit(rng, shape):
    q = rng.standard_normal(shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ------------------------------------------------------------ tensor ops

def test_qinv_against_jax():
    q = _unit(np.random.default_rng(0), (5, 7)).astype(np.float32)
    got = TQ.qinv(torch.from_numpy(q))
    assert got.dtype == torch.float32
    _close(got, JQ.qinv(jnp.asarray(q)), atol=0)
    _close(TQ.qmul(torch.from_numpy(q), got)[..., 0], np.ones((5, 7)))


def test_expmap_to_quaternion_against_jax():
    e = (np.random.default_rng(1).standard_normal((6, 5, 3)) * 1.5).astype(np.float32)
    e[0, 0] = 0.0          # a zero angle: the normalized sinc is exact there
    e[0, 1] = 1e-8
    got = TQ.expmap_to_quaternion(torch.from_numpy(e))
    _close(got, JQ.expmap_to_quaternion(jnp.asarray(e)))
    _close(got[0, 0], [1.0, 0.0, 0.0, 0.0], atol=0)
    _close(np.linalg.norm(got.numpy(), axis=-1), np.ones((6, 5)))


@pytest.mark.parametrize("order", ORDERS)
def test_euler_to_quaternion_against_jax(order):
    e = np.random.default_rng(2).uniform(-np.pi, np.pi, (4, 9, 3)).astype(np.float32)
    got = TQ.euler_to_quaternion(torch.from_numpy(e), order)
    _close(got, JQ.euler_to_quaternion(jnp.asarray(e), order))
    # and back through qeuler (away from gimbal lock, up to the sign)
    small = e * 0.3
    q = TQ.euler_to_quaternion(torch.from_numpy(small), order)
    _close(TQ.qeuler(q, order), small, atol=2e-6)


# ------------------------------------------------------- numpy Quaternions

def _pair(fn):
    """fn run with each package's class; the same array (or arrays) out."""
    got, want = fn(TQuat), fn(JQuat)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g = g.qs if hasattr(g, "qs") else g
        w = w.qs if hasattr(w, "qs") else w
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    return dict(a=_unit(rng, (16,)), b=_unit(rng, (16,)), v=rng.standard_normal((16, 3)),
                s=rng.uniform(0, 1, 16), w=rng.standard_normal((16, 3)) * 0.8,
                es=rng.uniform(-np.pi, np.pi, (16, 3)), v1=rng.standard_normal((16, 3)),
                ws=rng.uniform(0.1, 1.0, 16), jitter=rng.standard_normal((32, 3)) * 0.05)


QUAT_CASES = {
    "mul": lambda Q, d: Q(d["a"]) * Q(d["b"]),
    "div": lambda Q, d: Q(d["a"]) / Q(d["b"]),
    "neg abs": lambda Q, d: (-Q(d["a"]), abs(Q(d["a"]))),
    "rotate vectors": lambda Q, d: Q(d["a"]) * d["v"],
    "scalar slerp scaling": lambda Q, d: Q(d["a"]) * d["s"],
    "log exp": lambda Q, d: (Q(d["a"]).log(), Q.exp(d["w"])),
    "angle axis transforms": lambda Q, d: (*Q(d["a"]).angle_axis(), Q(d["a"]).transforms()),
    "from transforms": lambda Q, d: Q.from_transforms(Q(d["a"]).transforms()),
    "slerp": lambda Q, d: Q.slerp(Q(d["a"]), Q(d["b"]), d["s"]),
    "between": lambda Q, d: Q.between(d["v"], d["v1"]),
    "from euler": lambda Q, d: (Q.from_euler(d["es"], "zyx"),
                                Q.from_euler(d["es"], "zyx", world=True)),
    "from angle axis": lambda Q, d: Q.from_angle_axis(d["s"], d["v"]),
    "constrained": lambda Q, d: (Q(d["a"]).constrained_x(), Q(d["a"]).constrained_y(),
                                 Q(d["a"]).constrained_z()),
    "interpolate": lambda Q, d: Q(d["a"]).interpolate(d["ws"]),
    "average": lambda Q, d: (Q(np.tile(d["a"][0], (32, 1))) * Q.exp(d["jitter"])).average(),
    "normalized dot lengths": lambda Q, d: (Q(d["a"] * 2).normalized(),
                                            Q(d["a"]).dot(Q(d["b"])), Q(d["a"] * 3).lengths),
    "id helpers": lambda Q, d: (Q.id(5), Q.id((2, 3)), Q.id_like(Q.id(4))),
    "reshape ravel": lambda Q, d: (Q.id((2, 3)).reshape((6,)), Q(d["a"]).ravel()),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternions_np_against_jax(name):
    d = _draws()
    _pair(lambda Q: QUAT_CASES[name](Q, d))


@pytest.mark.parametrize("order", ORDERS)
def test_quaternions_np_euler_against_jax(order):
    a = _draws(3)["a"]
    _pair(lambda Q: Q(a).euler(order=order))


def test_quaternions_np_reshape_really_reshapes():
    q = TQuat.id((2, 3))
    q.reshape((6,))
    assert q.qs.shape == (6, 4)


# ------------------------------------------------------------ mocap tools

def _skeleton(mod, bvh_mod, seed=0):
    rng = np.random.default_rng(seed)
    names = ["Hips", "Spine", "LeftArm", "RightArm"]
    parents = np.array([-1, 0, 1, 1])
    offsets = np.array([[0, 0, 0], [0, 1, 0], [0.5, 0, 0], [-0.5, 0, 0]], float)
    angles = rng.uniform(-0.3, 0.3, (5, 4, 3))
    quats = np.asarray(bvh_mod.from_euler(angles, "xyz"))
    roots = np.cumsum(rng.normal(0, 0.01, (5, 3)), axis=0)
    return mod.MocapData(names, parents, offsets, quats, roots, 30.0)


@pytest.fixture()
def data():
    from speech2affective_gestures_tpu.render import bvh as jbvh

    port, jax_data = _skeleton(tmt, tbvh), _skeleton(jmt, jbvh)
    _close(port.rotations, jax_data.rotations)
    # the same skeleton on both sides: the JAX package's rotations
    port.rotations = jax_data.rotations.copy()
    return port, jax_data


def _same_data(a, b, atol=1e-6):
    assert a.joint_names == b.joint_names
    np.testing.assert_array_equal(a.parents, b.parents)
    for field in ("offsets", "rotations", "root_positions"):
        _close(getattr(a, field), getattr(b, field), atol=atol)
    assert a.framerate == b.framerate


def test_bvh_round_trip_against_jax(tmp_path, data):
    """Each package writes the skeleton; both read each file back."""
    port, jax_data = data
    t_path = tmt.write_bvh(port, str(tmp_path / "port"))
    j_path = jmt.write_bvh(jax_data, str(tmp_path / "jax"))
    assert open(t_path).read().splitlines()[:20] == open(j_path).read().splitlines()[:20]
    for path in (t_path, j_path):
        back, want = tmt.parse_bvh(path), jmt.parse_bvh(path)
        _same_data(back, want, atol=1e-5)
        dot = np.abs(np.sum(back.rotations * port.rotations, axis=-1))
        _close(dot, np.ones_like(dot), atol=1e-4)


@pytest.mark.parametrize("order", ["zyx", "xyz"])
def test_parameterizations_against_jax(data, order):
    port, jax_data = data
    _close(tmt.to_euler(port, order), jmt.to_euler(jax_data, order))
    _close(tmt.to_expmap(port), jmt.to_expmap(jax_data), atol=0)
    e = tmt.to_expmap(port)
    _close(tmt.from_expmap(e), jmt.from_expmap(e))
    dot = np.abs(np.sum(tmt.from_expmap(e) * port.rotations, axis=-1))
    _close(dot, np.ones_like(dot), atol=1e-5)
    _close(tmt.to_positions(port), jmt.to_positions(jax_data))


def test_positions_identity_rotations(data):
    port, _ = data
    port.rotations = np.zeros_like(port.rotations)
    port.rotations[..., 0] = 1.0
    pos = tmt.to_positions(port)
    _close(pos[:, 1] - pos[:, 0], np.tile([0, 1, 0], (5, 1)))


def test_structural_transforms_against_jax(data):
    port, jax_data = data
    _same_data(tmt.select_joints(port, ["LeftArm"]), jmt.select_joints(jax_data, ["LeftArm"]),
               atol=0)
    assert tmt.select_joints(port, ["LeftArm"]).joint_names == ["Hips", "Spine", "LeftArm"]
    for axis in ("X", "Y", "Z"):
        _same_data(tmt.mirror(port, axis), jmt.mirror(jax_data, axis), atol=0)
    _same_data(tmt.root_relative(port), jmt.root_relative(jax_data), atol=0)
    _same_data(tmt.downsample(port, 2), jmt.downsample(jax_data, 2), atol=0)
    assert tmt.downsample(port, 2).n_frames == 3
    np.testing.assert_array_equal(tmt.numpyfy(port), jmt.numpyfy(jax_data))
    assert tmt.numpyfy(port).shape == (5, 3 + 4 * 4)
    clone = port.clone()
    clone.rotations[0, 0, 0] = 9.0
    assert port.rotations[0, 0, 0] != 9.0


def test_foot_contacts_against_jax():
    rng = np.random.default_rng(4)
    t = np.arange(600)
    signal = np.abs(np.sin(t / 40.0)) * 0.1 + rng.normal(0, 0.002, t.shape) + 0.01
    for thres, min_dist in ((0.3, 1), (0.5, 30)):
        np.testing.assert_array_equal(tmt.peak_indexes(signal, thres, min_dist),
                                      jmt.peak_indexes(signal, thres, min_dist))
    for a, b in zip(tmt.foot_contact_idxs(signal, 0.02, 60),
                    jmt.foot_contact_idxs(signal, 0.02, 60)):
        np.testing.assert_array_equal(a, b)
    assert tmt.foot_contact_signal(signal, min_dist=60) == jmt.foot_contact_signal(
        signal, min_dist=60)
    assert len(tmt.peak_indexes(np.array([1.0, 2.0]))) == 0


def test_print_skel_against_jax(data, capsys):
    port, jax_data = data
    text = tmt.print_skel(port)
    assert text == jmt.print_skel(jax_data)
    assert text.splitlines()[0] == "- Hips (None)"
    assert text in capsys.readouterr().out


@pytest.fixture()
def agg():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


def _artists(ax):
    return len(ax.collections), len(ax.lines), len(ax.texts)


def test_plots_against_jax(tmp_path, data, agg, monkeypatch):
    port, jax_data = data
    for kw in (dict(frame=2, draw_names=True), dict(frame=0, joints=["Hips", "Spine"])):
        assert _artists(tmt.draw_stickfigure(port, **kw)) == _artists(
            jmt.draw_stickfigure(jax_data, **kw))
    assert _artists(tmt.draw_stickfigure(port, frame=2, draw_names=True)) == (4, 3, 4)
    pos = tmt.to_positions(port)
    ax = tmt.draw_stickfigure3d(port, frame=1, positions=pos)
    assert ax.name == "3d" and len(ax.collections) == 4
    xs, ys, zs = ax.collections[0]._offsets3d
    _close([float(np.asarray(v)[0]) for v in (xs, ys, zs)],
           [pos[1, 0, 0], pos[1, 0, 2], pos[1, 0, 1]])
    for mod, d in ((tmt, port), (jmt, jax_data)):
        fig = agg.figure()
        mod.sketch_move(d, ax=fig.add_subplot(111))
    a, b = (f.axes[0].lines for f in map(agg.figure, agg.get_fignums()[-2:]))
    assert [ln.get_alpha() for ln in a] == [ln.get_alpha() for ln in b]
    assert sorted({ln.get_alpha() for ln in a}) == [0.0, 0.8]
    feat = np.linspace(-1e-4, 1e-4, 3 * 4).reshape(3, 4)
    assert len(tmt.viz_cnn_filter(feat, port, gap=10).axes) == 2
    signal = np.abs(np.sin(np.arange(300) / 20.0)) + 0.1
    drawn = [mod.plot_foot_up_down(signal, min_dist=30, ax=agg.figure().add_subplot(111))
             for mod in (tmt, jmt)]
    assert [[ln.get_xydata().tolist() for ln in ax.lines] for ax in drawn][0] == \
        [[ln.get_xydata().tolist() for ln in ax.lines] for ax in drawn][1]
    assert len(drawn[0].lines) == 3
    monkeypatch.chdir(tmp_path)
    tmt.draw_stickfigure(port, frame=0)
    tmt.save_fig("stick")
    assert (tmp_path / "stick.png").stat().st_size > 0


def test_plots_name_matplotlib_where_it_is_missing(data, monkeypatch):
    port, _ = data
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tmt.draw_stickfigure(port, frame=0)
    with pytest.raises(ImportError, match="matplotlib"):
        tmt.plot_foot_up_down(np.ones(10))
