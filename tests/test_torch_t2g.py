"""The port's text-to-gesture path on the CPU against the JAX package:
`ops.quaternions.qeuler`, `train.losses.quat_angle_loss`,
`data.mpi_glove.load_data_with_glove`, `models.t2g.T2GNet` and
`train.t2g_trainer` (the arrays, the train step, the epochs' batch order,
the greedy decode), on the synthetic MPI corpus of `tests/test_mpi_glove.py`
(two clips of an 8-joint skeleton) at the small widths of
`tests/test_t2g_trainer.py`.

Tolerances, float32 with sums in another order:
- `qeuler` 1e-6 absolute in each order, at gimbal lock too (the arcsin's
  input rounds to +-1 and past it; both clamp it);
- `quat_angle_loss` and its gradient 1e-5 relative to the largest value;
- the loaded positions and rotations 1e-6 absolute (the same BVH text
  through two float32 forward kinematics); the rest of the corpus exact;
- the T2GNet forward 1e-5 absolute (unit quaternions through a few
  layers);
- three teacher-forced Adam steps at dropout 0: the losses 1e-4 relative,
  the weights 1e-4 absolute, but 2 lr a step where the first step's
  gradient is within float32 rounding of zero, as the attention's key
  biases' is (there each Adam step is about sign(g) lr, and the sign is
  rounding's: after three steps they lie up to 2.1 lr apart);
- the decode 1e-5 absolute over every frame.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import mpi_glove as tmpi
from speech2affective_gestures_torch.ops import quaternions as TQ
from speech2affective_gestures_torch.train import losses as tlosses
from speech2affective_gestures_torch.train import t2g_trainer as ttr
from speech2affective_gestures_tpu.data import mpi_glove as jmpi
from speech2affective_gestures_tpu.ops import quaternions as JQ
from speech2affective_gestures_tpu.train import losses as jlosses
from speech2affective_gestures_tpu.train import t2g_trainer as jtr

from test_mpi_glove import glove_file, mpi_dir  # noqa: F401  (fixtures)
from test_t2g_trainer import SMALL_NET, corpus  # noqa: F401  (fixtures)

ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")
NET = {**SMALL_NET, "num_layers": 2}     # two layers a side, dropout 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the ops are tiny, and beside other workers
    torch's threads wait on each other at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quats(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ------------------------------------------------------------ quaternions

@pytest.mark.parametrize("gimbal", [False, True], ids=["random", "gimbal"])
@pytest.mark.parametrize("order", ORDERS)
def test_qeuler_matches_jax(order, gimbal):
    """Each order at the loss's epsilon; the gimbal case turns 90 degrees
    either way about the order's middle axis, where the arcsin's input is
    +-1 up to rounding."""
    q = _quats(np.random.default_rng(ORDERS.index(order)), (6, 5))
    if gimbal:
        half = np.float32(np.sqrt(0.5))
        axis = 1 + "xyz".index(order[1])
        q[:] = 0.0
        q[..., 0] = half
        q[:3, :, axis], q[3:, :, axis] = half, -half
    got = TQ.qeuler(torch.from_numpy(q), order, epsilon=1e-6)
    want = np.asarray(JQ.qeuler(jnp.asarray(q), order, epsilon=1e-6))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_qeuler_refuses_an_unknown_order():
    with pytest.raises(ValueError, match="order"):
        TQ.qeuler(torch.ones(4), "xxy")


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("kw", [{}, {"lower_body_start": 2, "upper_body_weights": 0.5,
                                     "drift_len": 4}], ids=["defaults", "weighted"])
def test_quat_angle_loss_matches_jax(kw):
    """Both terms and the gradient of their sum with respect to the
    prediction; the defaults' drift_len 20 runs past the 12 frames."""
    rng = np.random.default_rng(7)
    pred = _quats(rng, (3, 12, 5)).reshape(3, 12, 20)
    target = _quats(rng, (3, 12, 5)).reshape(3, 12, 20)

    def jax_loss(p):
        a, d = jlosses.quat_angle_loss(p, jnp.asarray(target), num_joints=5, **kw)
        return a + d, (a, d)

    (_, (ja, jd)), jgrad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    ta, td = tlosses.quat_angle_loss(p, torch.from_numpy(target), num_joints=5, **kw)
    (ta + td).backward()
    for got, want in ((ta, ja), (td, jd), (p.grad, jgrad)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- corpus

def _copy(src, dst):
    shutil.copytree(src / "mpi", dst / "mpi")
    return dst


def _assert_same_corpus(got, want, atol=1e-6):
    g_dict, g_w2i, g_table, g_cats, g_t = got
    w_dict, w_w2i, w_table, w_cats, w_t = want
    assert g_w2i == w_w2i and g_t == w_t
    assert [list(c) for c in g_cats] == [list(c) for c in w_cats]
    np.testing.assert_array_equal(g_table, w_table)
    assert sorted(g_dict) == sorted(w_dict)
    for cid, entry in w_dict.items():
        mine = g_dict[cid]
        assert sorted(mine) == sorted(entry)
        for key in ("positions", "rotations"):
            np.testing.assert_allclose(mine[key], entry[key], atol=atol, rtol=0,
                                       err_msg=f"{cid} {key}")
        np.testing.assert_allclose(mine["affective_features"], entry["affective_features"],
                                   atol=1e-5, rtol=1e-5)
        for tag in jmpi.RELEVANT_TAGS:
            np.testing.assert_array_equal(mine[tag], entry[tag])
        for k, v in entry["joints_dict"].items():
            np.testing.assert_array_equal(mine["joints_dict"][k], v, err_msg=k)


@pytest.mark.parametrize("frame_drop", [1, 2])
def test_load_data_with_glove_matches_jax(mpi_dir, glove_file, tmp_path, frame_drop):  # noqa: F811
    """Each package's fresh load of the same files, then each reading the
    cache the other wrote (the port's cache through JAX's loader, JAX's
    through the port's)."""
    glove_path = glove_file[0]
    port_root = _copy(mpi_dir, tmp_path / "port")
    jax_root = _copy(mpi_dir, tmp_path / "jax")
    port = tmpi.load_data_with_glove(str(port_root), "mpi", glove_path, frame_drop=frame_drop)
    want = jmpi.load_data_with_glove(str(jax_root), "mpi", glove_path, frame_drop=frame_drop)
    _assert_same_corpus(port, want)
    assert want[4] == len(range(1, 13, frame_drop))
    cache = f"data_dict_glove_drop_{frame_drop}.npz"
    assert (port_root / "mpi" / cache).is_file() and (jax_root / "mpi" / cache).is_file()
    _assert_same_corpus(tmpi.load_data_with_glove(str(jax_root), "mpi", glove_path,
                                                  frame_drop=frame_drop), want, atol=0)
    _assert_same_corpus(jmpi.load_data_with_glove(str(port_root), "mpi", glove_path,
                                                  frame_drop=frame_drop), port, atol=0)


def test_load_data_with_glove_warns_on_add_mirrored(mpi_dir, glove_file):  # noqa: F811
    with pytest.warns(UserWarning, match="add_mirrored"):
        tmpi.load_data_with_glove(str(mpi_dir), "mpi", glove_file[0], add_mirrored=True)


def test_prepare_t2g_arrays_matches_jax(corpus):  # noqa: F811
    data_dict, word2idx, _, cats, max_t = corpus
    got = ttr.prepare_t2g_arrays(data_dict, word2idx, cats, max_t)
    want = jtr.prepare_t2g_arrays(data_dict, word2idx, cats, max_t)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "tags":
            assert len(got[key]) == len(value)
            for a, b in zip(got[key], value):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        elif isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value


# ------------------------------------------------------------------- net

def _nets(corpus, seed=0, **overrides):  # noqa: F811
    """(JAX net, its variables, the port's net on them, arrays)."""
    data_dict, word2idx, table, cats, max_t = corpus
    arrays = jtr.prepare_t2g_arrays(data_dict, word2idx, cats, max_t)
    kw = {**NET, **overrides}
    jnet = jtr.build_t2g_net(table, arrays, **kw)
    variables = jax.device_get(jnet.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        jnp.asarray(arrays["text"][:1]), [jnp.asarray(t[:1]) for t in arrays["tags"]],
        jnp.asarray(arrays["quat"][:1]), jnp.asarray(arrays["offset_lengths"][:1])))
    tnet = ttr.build_t2g_net(table, arrays, "cpu", **kw)
    from_jax.load_jax(tnet, from_jax.t2g_net, variables)
    return jnet, variables, tnet, arrays


def _inputs(arrays, frames):
    rng = np.random.default_rng(frames)
    quat = _quats(rng, arrays["quat"].shape[:2] + (arrays["n_joints"],))
    quat = quat.reshape(arrays["quat"].shape)[:, :frames]
    return arrays["text"], arrays["tags"], quat, arrays["offset_lengths"]


@pytest.mark.parametrize("short", [0, 3], ids=["max_time_steps", "shorter"])
def test_t2g_forward_matches_jax(corpus, short):  # noqa: F811
    """Eval mode on bridged weights: at T = max_time_steps the time-mixing
    convolutions run, below it they do not."""
    jnet, variables, tnet, arrays = _nets(corpus)
    args = _inputs(arrays, arrays["quat"].shape[1] - short)
    want = jax.jit(jnet.apply)(variables, jnp.asarray(args[0]),
                               [jnp.asarray(t) for t in args[1]],
                               *(jnp.asarray(a) for a in args[2:]))
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(args[0]), [torch.from_numpy(t) for t in args[1]],
                          *(torch.from_numpy(a) for a in args[2:]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    norms = np.linalg.norm(got[0].numpy().reshape(*got[0].shape[:2], -1, 4), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)


def test_t2g_net_keeps_the_glove_table_frozen(corpus):  # noqa: F811
    """The table is a buffer outside the state dict; no parameter holds it."""
    _, _, tnet, _ = _nets(corpus)
    assert "embedding_table" not in tnet.state_dict()
    assert all(p.shape != tnet.embedding_table.shape for p in tnet.parameters())
    np.testing.assert_array_equal(tnet.embedding_table.numpy(),
                                  np.asarray(corpus[2], np.float32))


def test_three_train_steps_match_jax(corpus):  # noqa: F811
    """Three teacher-forced Adam steps from the same weights on the same
    batches (the two clips in turn orders) against JAX's
    `make_t2g_train_step`, dropout 0."""
    lr = 1e-3
    jnet, variables, tnet, arrays = _nets(corpus, seed=3)
    tx = optax.adam(lr)
    state = jtr.T2GTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              opt=tx.init(variables["params"]))
    jstep = jtr.make_t2g_train_step(jnet, tx, arrays["n_joints"])
    topt = ttr.make_optimizer(tnet, lr)
    data = ttr.to_device(arrays, torch.device("cpu"))
    first_grads = None
    for rows in ([1, 0], [0, 1], [1, 0]):
        batch = {"text": arrays["text"][rows], "tags": [t[rows] for t in arrays["tags"]],
                 **{k: arrays[k][rows] for k in ("quat", "frame_mask", "offset_lengths")}}
        state, jm = jstep(state, jax.tree_util.tree_map(jnp.asarray, batch),
                          jax.random.key(0))
        tm = ttr.t2g_train_step(tnet, topt, ttr.select(data, torch.tensor(rows)),
                                arrays["n_joints"])
        if first_grads is None:
            first_grads = {k: p.grad.clone() for k, p in tnet.named_parameters()}
        for key in ("loss", "angle", "drift"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4)
    want = from_jax.t2g_net({"params": jax.device_get(state.params)})
    # the attention's key biases: softmax ignores a constant per query, so
    # their gradient is zero but for rounding (~1e-8 of the largest)
    top = max(g.abs().max() for g in first_grads.values())
    for name, p in tnet.named_parameters():
        near_zero = (first_grads[name].abs() <= 1e-6 * top).numpy()
        err = np.abs(p.detach().numpy() - want[name])
        assert (err[~near_zero] <= 1e-4).all(), (name, err[~near_zero].max())
        assert (err[near_zero] <= 3 * 2 * lr).all(), (name, err[near_zero].max())


def test_train_t2g_visits_jax_batches_in_jax_order(corpus, monkeypatch):  # noqa: F811
    """The batches `train_t2g` hands its step, epoch after epoch, are the
    JAX loop's (their text rows in order); each step recorded, not run."""
    data_dict, word2idx, table, cats, max_t = corpus
    seen = {"port": [], "jax": []}

    def port_step(net, opt, batch, n_joints, generator=None):
        seen["port"].append(batch["text"].numpy().copy())
        return {"loss": torch.zeros(())}

    def jax_make_step(net, tx, n_joints):
        def step(state, batch, rng):
            seen["jax"].append(np.asarray(batch["text"]))
            return state, {"loss": jnp.zeros(())}
        return step

    monkeypatch.setattr(ttr, "t2g_train_step", port_step)
    monkeypatch.setattr(jtr, "make_t2g_train_step", jax_make_step)
    kw = dict(epochs=4, batch_size=1, seed=11, net_overrides=NET)
    ttr.train_t2g(data_dict, word2idx, table, cats, max_t, device="cpu", **kw)
    jtr.train_t2g(data_dict, word2idx, table, cats, max_t, **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 8
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)


def test_train_t2g_loss_falls(corpus):  # noqa: F811
    """The JAX test's criterion (tests/test_t2g_trainer.py): after 25
    epochs the loss is below 0.7 of the first epoch's."""
    data_dict, word2idx, table, cats, max_t = corpus
    out = ttr.train_t2g(data_dict, word2idx, table, cats, max_t, epochs=25, batch_size=2,
                        learning_rate=3e-3, net_overrides=SMALL_NET, device="cpu")
    hist = out["history"]
    assert len(hist) == 25 and all(np.isfinite(hist))
    assert hist[-1] < 0.7 * hist[0], hist


def test_generate_quat_sequence_matches_jax(corpus):  # noqa: F811
    """The greedy decode on bridged weights against JAX's fori_loop: every
    frame, unit quaternions, the same bits twice; and a decode cut short is
    the full one's first frames."""
    jnet, variables, tnet, arrays = _nets(corpus, seed=5)
    args = (arrays["text"], arrays["tags"], arrays["offset_lengths"])
    want = jtr.generate_quat_sequence(jnet, variables["params"], *args)
    got = ttr.generate_quat_sequence(tnet, *args, device="cpu")
    assert got.shape == want.shape == arrays["quat"].shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    norms = np.linalg.norm(got.reshape(*got.shape[:2], -1, 4), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    np.testing.assert_array_equal(got, ttr.generate_quat_sequence(tnet, *args, device="cpu"))
    short = ttr.generate_quat_sequence(tnet, *args, n_frames=5, device="cpu")
    np.testing.assert_array_equal(short, got[:, :5])
