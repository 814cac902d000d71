"""The v1 pipeline (`main_v1`: speech emotion recognition on IEMOCAP
blocks, then the emotion-conditioned s2eg GAN): the port against the JAX
package on the CPU.

Sizes: the SER nets at l1-l4 8-16 channels, f1 16, f2 8, 8 LSTM units, on
blocks of 24 x 40 (batch 4); the v1 generator at hidden 32 with 2 GRU
layers and word embedding 16, the v1 discriminator at hidden 16 (its 4
layers fixed); 30 words, 5 speakers, batch 4. Every dropout at zero: the
JAX v1 discriminator fixes its GRU's at 0.3 and the generator's text
encoder its embedding dropout at 0.1, so the module fixture patches both
(the discriminator module's `L.GRU`, the generator module's
`TextEncoderTCN`). The JAX variables come from `jax.eval_shape` of the
init filled with numpy draws (`test_torch_ablations._fill`), except where
the init itself is under test. The speaker noise is handed to both sides:
JAX's `re_parametrize` is patched to return mu + eps exp(0.5 log_var)
with the handed eps, in the order its trace draws them.

Tolerances, float32 with sums in another order:
- single layers (max pool, attention) 1e-5 absolute; the LSTM, its
  gradients and the SER nets with it inside 2e-5; BN running stats within
  1e-4 of their magnitude plus 1e-4 of each tensor's largest;
- the v1 generator and discriminator 5e-5 absolute (the serving tests'
  tolerance for a whole generator);
- the SER and s2eg steps as `test_torch_train.test_two_gan_steps_match_jax`
  holds main_v2's: metrics within 1e-4 relative at step 1 and 1e-3 at
  step 2, the optimizers' states (SGD's momentum, Adam's moments) within
  MOMENT_TOL (5e-4) of each tensor's largest;
- the IEMOCAP front end, blocks, splits and caches exactly.
"""

import functools
import os
import shutil
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as tt
from test_torch_ablations import _fill
from speech2affective_gestures_torch import main_v1 as tmain
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import iemocap as tiemocap
from speech2affective_gestures_torch.models import layers as TL
from speech2affective_gestures_torch.models import ser as tser
from speech2affective_gestures_torch.models.discriminator import AffDiscriminatorV1 as TDisV1
from speech2affective_gestures_torch.models.generator import PoseGeneratorV1 as TGenV1
from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train import ser_trainer as tser_trainer
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu import main_v1 as jmain
from speech2affective_gestures_tpu.convert import jax_to_torch
from speech2affective_gestures_tpu.data import iemocap as jiemocap
from speech2affective_gestures_tpu.models import discriminator as jdis_mod
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.models import layers as JL
from speech2affective_gestures_tpu.models import ser as jser
from speech2affective_gestures_tpu.train import gan_step as jstep
from speech2affective_gestures_tpu.train import ser_trainer as jser_trainer

N_WORDS, N_SPK, B, EC = tt.N_WORDS, tt.N_SPK, tt.B, 7
SER_KW = dict(l1=8, l2=16, l3=8, l4=8, lstm_units=8, f1=16, f2=8, dropout_prob=0.0)
SER_V2_KW = dict(l1=8, l2=16, f1=16, f2=8, dropout_prob=0.0)
BLOCK = (24, 40, 3)
GEN_KW = dict(n_words=N_WORDS, word_embed_size=16, hidden_size=32, n_layers=2,
              dropout_prob=0.0, n_speakers=N_SPK)
DIS_HID = 16
MOMENT_TOL = tt.MOMENT_TOL


class _HandedEps:
    """JAX's `re_parametrize` for the generator module: the i-th call of a
    trace returns mu + draws[i] exp(0.5 log_var), whatever the key."""

    def __init__(self, draws):
        self.draws, self.calls = draws, 0

    def __call__(self, mu, log_var, rng):
        eps = self.draws[self.calls % len(self.draws)]
        self.calls += 1
        return mu + jnp.asarray(eps, mu.dtype) * jnp.exp(0.5 * log_var)


def _gru_without_dropout(*args, **kwargs):
    return JL.GRU(*args, **{**kwargs, "dropout": 0.0})


@pytest.fixture(scope="module", autouse=True)
def deterministic_jax():
    """The JAX v1 nets' fixed dropouts at zero: the generator's text
    embedding dropout (its module-level TextEncoderTCN name) and the
    discriminator's GRU dropout (its module's `L.GRU`)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    mp.setattr(jdis_mod, "L", types.SimpleNamespace(
        **{**vars(JL), "GRU": _gru_without_dropout}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()


def _shapes_filled(module, args, seed, rngs=("params", "noise", "dropout")):
    shapes = jax.eval_shape(module.init, {r: jax.random.key(i) for i, r in enumerate(rngs)},
                            *args)
    return _fill(shapes, seed)


def _emo(rng, n=B):
    return np.eye(EC, dtype=np.float32)[rng.integers(0, EC, n)]


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
def test_lstm_matches_jax(bidirectional):
    """A 2-layer LSTM's outputs, final h and c, and the gradients of a
    weighted sum of its outputs by its input and its parameters, against
    JAX's `layers.LSTM` (under `jax.grad`) within 2e-5; nn.LSTM with the
    same state dict as an extra oracle of the values."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, 12)).astype(np.float32)
    jm = JL.LSTM(16, num_layers=2, bidirectional=bidirectional)
    jv = _fill(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x)), 1)
    nd = 2 if bidirectional else 1
    cot = rng.standard_normal((3, 11, nd * 16)).astype(np.float32)

    def loss(params, xs):
        out, _ = jm.apply({"params": params}, xs)
        return jnp.sum(out * cot)

    want_out, (want_h, want_c) = jax.jit(jm.apply)(jv, jnp.asarray(x))
    want_gp, want_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jv["params"], jnp.asarray(x))

    tm = TL.LSTM(12, 16, num_layers=2, bidirectional=bidirectional)
    state = from_jax.to_state_dict(from_jax.gru(jv["params"], ""))
    tm.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, (h, c) = tm(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in ((out, want_out), (h, want_h), (c, want_c), (xt.grad, want_gx)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    want_grads = from_jax.gru(jax.device_get(want_gp), "")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name], atol=2e-5, err_msg=name)

    oracle = torch.nn.LSTM(12, 16, num_layers=2, batch_first=True,
                           bidirectional=bidirectional)
    oracle.load_state_dict(state, strict=True)
    o_out, (o_h, o_c) = oracle(torch.from_numpy(x))
    for got, want in ((out, o_out), (h, o_h), (c, o_c)):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=2e-5)


def test_max_pool_matches_jax():
    """Floor mode with the stride equal to the kernel, on sizes that are no
    multiple of it."""
    x = np.random.default_rng(1).standard_normal((2, 23, 41, 5)).astype(np.float32)
    want = JL.MaxPool2d((2, 4)).apply({}, jnp.asarray(x))
    got = TL.MaxPool2d((2, 4))(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


def test_attention_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 9, 6)).astype(np.float32)
    jm = jser.Attention(2)
    jv = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    want, want_alpha = jm.apply(jv, jnp.asarray(x))
    tm = tser.Attention(6, 2)
    tm.load_state_dict(from_jax.to_state_dict({
        **from_jax.linear(jv["params"]["Dense_0"], "linear1"),
        **from_jax.linear(jv["params"]["Dense_1"], "linear2")}), strict=True)
    got, alpha = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(want_alpha), atol=1e-5)


# -------------------------------------------------------------- SER nets

SER_NETS = {"v1": (jser.AttConvRNN, tser.AttConvRNN, SER_KW),
            "v2": (jser.AttConvRNNv2, tser.AttConvRNNv2, SER_V2_KW)}


def _ser_pair(which, seed=0):
    jcls, tcls, kw = SER_NETS[which]
    x = np.zeros((2, *BLOCK), np.float32)
    jm = jcls(num_emotions=EC, **kw)
    jv = _shapes_filled(jm, (jnp.asarray(x),), seed, rngs=("params", "dropout"))
    tm = tcls(EC, **kw)
    from_jax.load_jax(tm, from_jax.att_conv_rnn, jv)
    return jm, jv, tm


def _blocks(seed, n=B):
    return np.random.default_rng(seed).standard_normal((n, *BLOCK)).astype(np.float32)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("which", ["v1", "v2"])
def test_ser_nets_match_jax(which, mode):
    """AttConvRNN (LSTM inside: 2e-5) and AttConvRNNv2 (1e-5) on blocks of
    24 x 40 with the same variables: the logits and, in train mode, the
    running stats of the row-wise batch norm."""
    jm, jv, tm = _ser_pair(which)
    x = _blocks(3)
    train = mode == "train"
    if train:
        want, mut = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
            jv, jnp.asarray(x), rngs={"dropout": jax.random.key(0)})
    else:
        want = jax.jit(jm.apply)(jv, jnp.asarray(x))
    got = tm.train(train)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5 if which == "v1" else 1e-5)
    if train:
        tt._assert_stats(tm, from_jax.att_conv_rnn,
                         dict(jv, batch_stats=jax.device_get(mut["batch_stats"])), 1e-4)


def test_ser_rows_straddle_channels():
    """The rows fed to linear1 are the NCHW maps' bytes cut every C*W
    values (the reference's view), not each row's channels side by side."""
    y = torch.arange(2 * 3 * 4 * 5.0).view(2, 3, 4, 5)
    rows = tser._rows(y)
    assert rows.shape == (8, 15)
    assert torch.equal(rows[1], torch.arange(15.0, 30.0))


def test_apply_reference_init_pattern():
    """The reference init rewrites the tensors that JAX's
    `apply_reference_init` rewrites, and no other: every conv and linear
    weight but the attention's (truncated N(0, 0.01): all within 2 std, std
    near 0.01) with its bias at 0.01, and the LSTM's forget-gate slice
    [H:2H] of both biases at 1 (the rest of those biases untouched); the
    attention and the batch norm keep their init."""
    x = jnp.zeros((2, *BLOCK))
    jm = jser.AttConvRNN(num_emotions=EC, **SER_KW)
    jv = jax.jit(jm.init)({"params": jax.random.key(0), "dropout": jax.random.key(1)}, x)
    jv_init = jser.apply_reference_init(jv, jax.random.key(42))
    before, after = (from_jax.att_conv_rnn(jax.device_get(v)) for v in (jv, jv_init))
    jax_changed = {k for k in before if not np.array_equal(before[k], after[k])}

    tm = tser.AttConvRNN(EC, **SER_KW)
    old = {k: v.clone() for k, v in tm.state_dict().items()}
    tser.apply_reference_init(tm, torch.Generator().manual_seed(42))
    new = tm.state_dict()
    changed = {k for k in old if not torch.equal(old[k], new[k])}
    assert changed == jax_changed
    h = SER_KW["lstm_units"]
    weights = [k for k in changed if k.endswith(".weight")]
    assert len(weights) == 9                     # 6 convs, linear1, linear2, linear3
    for k in weights:
        w = new[k]
        assert w.abs().max() < 0.02 and abs(w.std().item() - 0.01) < 4e-3, k
        assert torch.equal(new[k.replace(".weight", ".bias")],
                           torch.full_like(new[k.replace(".weight", ".bias")], 0.01))
    for sfx in ("", "_reverse"):
        for b in ("bias_ih", "bias_hh"):
            k = f"gru.{b}_l0{sfx}"
            assert k in changed and torch.equal(new[k][h:2 * h], torch.ones(h))
            rest = torch.cat([new[k][:h], new[k][2 * h:]])
            assert torch.equal(rest, torch.cat([old[k][:h], old[k][2 * h:]]))
            assert np.array_equal(after[k][h:2 * h], np.ones(h))
    assert not any(k.startswith(("attention.", "batch_norm_linear1.")) for k in changed)


# ------------------------------------------------------------ v1 GAN nets

def _gan_inputs(seed):
    b = tt._batch(seed)
    b["emo_labels"] = _emo(np.random.default_rng(seed + 100))
    return b


def _pre(b):
    return tstep.build_pre_seq(torch.from_numpy(b["vec_seq"]), C.N_PRE_POSES).numpy()


def _gen_args(b):
    return (_pre(b), b["extended_word_seq"], b["audio"], b["emo_labels"], b["vid_indices"])


def _gen_pair(seed=0):
    jm = jgen_mod.PoseGeneratorV1(**GEN_KW)
    jv = _shapes_filled(jm, tuple(map(jnp.asarray, _gen_args(_gan_inputs(0)))), seed)
    tm = TGenV1(emb_dropout=0.0, **GEN_KW)
    from_jax.load_jax(tm, from_jax.pose_generator_v1, jv)
    return jm, jv, tm


def _dis_pair(seed=1):
    b = _gan_inputs(0)
    jm = jdis_mod.AffDiscriminatorV1(hidden_size=DIS_HID)
    jv = _shapes_filled(jm, (jnp.asarray(b["vec_seq"]), jnp.asarray(b["emo_labels"])), seed)
    tm = TDisV1(hidden_size=DIS_HID, dropout_prob=0.0)
    from_jax.load_jax(tm, from_jax.aff_discriminator_v1, jv)
    return jm, jv, tm


def _apply(jm, jv, args, train):
    kw = dict(train=train, rngs={"noise": jax.random.key(5), "dropout": jax.random.key(6)})
    if train:
        kw["mutable"] = ["batch_stats"]
    got = jax.jit(functools.partial(jm.apply, **kw))(jv, *map(jnp.asarray, args))
    return jax.device_get(got) if train else (jax.device_get(got), None)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_v1_generator_matches_jax(mode, monkeypatch):
    """PoseGeneratorV1 with the same variables and speaker noise: the poses,
    z (the speaker z with the one-hot after it, 16 + 7), mu, log_var and,
    in train mode, the WavEncoder's BN running stats."""
    eps = np.random.default_rng(7).standard_normal((B, 16)).astype(np.float32)
    monkeypatch.setattr(jgen_mod, "re_parametrize", _HandedEps([eps]))
    jm, jv, tm = _gen_pair()
    args = _gen_args(_gan_inputs(2))
    train = mode == "train"
    want, new = _apply(jm, jv, args, train)
    with torch.no_grad():
        got = tm.train(train)(*map(torch.from_numpy, args), eps=torch.from_numpy(eps))
    assert got[1].shape == (B, 16 + EC)
    np.testing.assert_array_equal(got[1][:, 16:].numpy(), args[3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)
    if train:
        tt._assert_stats(tm, from_jax.pose_generator_v1, dict(jv, **new), 1e-4)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_v1_discriminator_matches_jax(mode):
    """AffDiscriminatorV1 (ST-GCN without the per-node batch norms, the
    one-hot per frame, a 4-layer bi-GRU) with the same variables: the
    probabilities and, in train mode, every BN running stat."""
    jm, jv, tm = _dis_pair()
    b = _gan_inputs(3)
    args = (b["vec_seq"], b["emo_labels"])
    train = mode == "train"
    want, new = _apply(jm, jv, args, train)
    got = tm.train(train)(*map(torch.from_numpy, args))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5)
    if train:
        tt._assert_stats(tm, from_jax.aff_discriminator_v1, dict(jv, **new), 1e-4)


def test_v1_generator_takes_only_a_speaker_or_random_z():
    with pytest.raises(ValueError):
        TGenV1(z_type="none", **GEN_KW)
    gen = TGenV1(z_type="random", **GEN_KW).eval()
    b = _gan_inputs(4)
    out, z, mu, lv = gen(*map(torch.from_numpy, _gen_args(b)),
                         generator=torch.Generator().manual_seed(0))
    assert out.shape == (B, 34, 27) and z.shape == (B, 16 + EC) and mu is None


# --------------------------------------------------------------- bridges

@pytest.mark.parametrize("which", ["att_conv_rnn", "pose_generator_v1",
                                   "aff_discriminator_v1"])
def test_v1_bridges_match_jax_inverse_mappers(which):
    """Each bridge against JAX's inverse mapper on the same variables: the
    same names, shapes and values; the port's net loads them strictly."""
    jv, tm = {"att_conv_rnn": lambda: _ser_pair("v1")[1:],
              "pose_generator_v1": lambda: _gen_pair()[1:],
              "aff_discriminator_v1": lambda: _dis_pair()[1:]}[which]()
    got = getattr(from_jax, which)(jv)
    want = getattr(jax_to_torch, f"{which}_inv")(jv)
    assert set(got) == set(want) == set(tm.state_dict())
    for k in want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------- SER steps

def _find_state(opt_state, attr):
    """The first state of an optax chain with field `attr` (TraceState's
    `trace`, ScaleByAdamState's `mu`)."""
    if hasattr(opt_state, attr):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            if (found := _find_state(s, attr)) is not None:
                return found
    return None


def _jax_opt_moments(opt_state, kind, variables):
    """{state-dict name: (first, second)} of JAX's optimizer: SGD's trace
    twice, or Adam's mu and nu."""
    def mapped(tree):
        return from_jax.att_conv_rnn({"params": jax.device_get(tree),
                                      "batch_stats": variables["batch_stats"]})
    if kind == "sgd":
        m = mapped(_find_state(opt_state, "trace").trace)
        return {k: (m[k], m[k]) for k in m}
    adam = _find_state(opt_state, "mu")
    m, v = mapped(adam.mu), mapped(adam.nu)
    return {k: (m[k], v[k]) for k in m}


def _torch_opt_moments(opt, net, kind):
    keys = ("momentum_buffer",) * 2 if kind == "sgd" else ("exp_avg", "exp_avg_sq")
    return {n: tuple(opt.state[p][k].double().numpy() for k in keys)
            for n, p in net.named_parameters()}


def _assert_ser_moments(got, want, step):
    """The optimizer's states within MOMENT_TOL (`tt._moment_errors`), but
    linear1's bias, which feeds the row-wise batch norm in train mode: the
    batch mean removes it, so its loss gradient is zero up to float noise,
    and its state is the weight decay's 5e-4 p plus that noise. It is held
    within MOMENT_TOL of the net's largest state, as `_moment_errors`
    holds such biases without weight decay."""
    bias = "linear1.bias"
    errs = tt._moment_errors({k: v for k, v in got.items() if k != bias},
                             {k: v for k, v in want.items() if k != bias})
    assert all(e <= MOMENT_TOL for e, _ in errs), (step, errs)
    for i in range(2):
        top = max(np.abs(want[n][i]).max() for n in got)
        err = np.abs(got[bias][i] - np.asarray(want[bias][i], np.float64)).max() / top
        assert err <= MOMENT_TOL, (step, i, err)


@pytest.mark.parametrize("emo_as_cats", [True, False], ids=["cats", "dims"])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_two_ser_steps_match_jax(kind, emo_as_cats):
    """Two SER steps (SGD with momentum 0.9 and Nesterov, or Adam, both
    with weight decay 5e-4; cross-entropy or the L1 pair) against JAX's
    `make_ser_train_step` from the same variables: the metrics, the BN
    running stats and the optimizer's state after each step (linear1's
    bias as `_assert_ser_moments` says), the parameters after step 2
    within 1e-3 of their tensor's largest (linear1's bias, which Adam moves
    by about lr times the sign of its float-noise gradient, within 2 lr a
    step, as `test_torch_ablations._assert_params` holds such parameters);
    then `make_ser_eval_step`'s prediction, its
    one-hot and accuracy, exactly. The learning rate is 0.05, so that the
    steps move the net."""
    jm, jv, tm = _ser_pair("v1", seed=4)
    jopt = jser_trainer.make_ser_optimizer(kind, 0.05, 5e-4, True)
    jstep_fn = jser_trainer.make_ser_train_step(jm.apply, jopt, emo_as_cats=emo_as_cats)
    params, stats, opt_state = jv["params"], jv["batch_stats"], jopt.init(jv["params"])
    topt = tser_trainer.make_ser_optimizer(tm.parameters(), kind, 0.05, 5e-4, True)
    rng = np.random.default_rng(5)
    for i in range(2):
        x, y = _blocks(10 + i), _emo(rng)
        params, stats, opt_state, want = jstep_fn(params, stats, opt_state, jnp.asarray(x),
                                                  jnp.asarray(y), jax.random.key(i))
        got = tser_trainer.ser_train_step(tm, topt, torch.from_numpy(x), torch.from_numpy(y),
                                          torch.Generator().manual_seed(i), emo_as_cats)
        assert set(got) == set(want) == {"loss", "accuracy"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=(1e-4, 1e-3)[i],
                                       atol=1e-6, err_msg=k)
        variables = {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}
        tt._assert_stats(tm, from_jax.att_conv_rnn, variables, 1e-4 if i == 0 else 1e-3)
        _assert_ser_moments(_torch_opt_moments(topt, tm, kind),
                            _jax_opt_moments(opt_state, kind, variables), i)
    want_params = from_jax.att_conv_rnn(variables)
    for name, p in tm.named_parameters():
        if name == "linear1.bias":   # moved by float noise: at most lr a step each side
            assert np.abs(p.detach().numpy() - want_params[name]).max() <= 2 * 2 * 0.05
        else:
            tt._assert_close_scaled(p.detach().numpy(), want_params[name], 1e-3, name)

    x, y = _blocks(20), _emo(rng)
    want = jser_trainer.make_ser_eval_step(jm.apply)(params, stats, jnp.asarray(x),
                                                     jnp.asarray(y))
    got = tser_trainer.ser_eval_step(tm, torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ s2eg steps

@pytest.fixture()
def same_other_speakers(monkeypatch):
    """The diversity regularizer's speaker ids, on both sides."""
    monkeypatch.setattr(jstep, "draw_other_speaker_ids",
                        lambda key, vids, n: jnp.asarray(tt.DIV_IDS, vids.dtype))
    monkeypatch.setattr(tstep, "draw_other_speaker_ids",
                        lambda g, vids, n: torch.as_tensor(tt.DIV_IDS, device=vids.device))


def _s2eg_pair(monkeypatch, eps, eps_rand):
    """JAX's `make_s2eg_train_step` (its noise handed: the D update's
    generator forward and the G update's take eps, the diversity
    regularizer's eps_rand) and the port's `S2egStep`, from the same
    variables and `GanConfig`."""
    jg, gv, tg = _gen_pair(seed=6)
    jd, dv, td = _dis_pair(seed=7)
    monkeypatch.setattr(jgen_mod, "re_parametrize", _HandedEps([eps, eps, eps_rand]))
    jcfg = jstep.GanConfig(n_speakers=N_SPK)
    state = jstep.create_train_state(gv, dv, jcfg)
    train_step = jser_trainer.make_s2eg_train_step(jg.apply, jd.apply, jcfg)
    return train_step, state, tser_trainer.S2egStep(tg, td, tstep.GanConfig(n_speakers=N_SPK))


def test_two_s2eg_steps_match_jax(monkeypatch, same_other_speakers):
    """Two v1 GAN steps (the GAN terms on, the diversity regularizer and
    the KLD with the speaker z) against JAX's `make_s2eg_train_step`: the
    metrics of both; after step 1 the generator's BN stats within 1e-4,
    the discriminator's within 1e-3 (its last forward of the step runs on
    weights after its update), both Adam states within MOMENT_TOL."""
    rng = np.random.default_rng(8)
    eps, eps_rand = (rng.standard_normal((B, 16)).astype(np.float32) for _ in range(2))
    train_step, state, step = _s2eg_pair(monkeypatch, eps, eps_rand)
    g = torch.Generator().manual_seed(0)
    for i, seed in enumerate(tt.STEP_SEEDS):
        b = _gan_inputs(seed)
        state, want = train_step(state, jax.device_put(b), jax.random.key(i), gan_on=True)
        want = {k: float(v) for k, v in jax.device_get(want).items()}
        got = step.train_step(tt._torch_batch(b), g, gan_on=True, eps=torch.from_numpy(eps),
                              eps_rand=torch.from_numpy(eps_rand))
        got = {k: float(v) for k, v in got.items()}
        assert set(got) == set(want) == {"dis", "loss", "DIV_REG", "KLD", "gen", "s2eg_l1"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=(1e-4, 1e-3)[i], atol=1e-6,
                                       err_msg=k)
        if i == 0:
            st = jax.device_get(state)
            for who, mapper, tol in (("gen", from_jax.pose_generator_v1, 1e-4),
                                     ("dis", from_jax.aff_discriminator_v1, 1e-3)):
                tt._assert_stats(getattr(step, who), mapper, tt._vars(st, who), tol)
                errs = tt._moment_errors(
                    tt._torch_moments(getattr(step, f"{who}_opt"), getattr(step, who)),
                    tt._optax_moments(getattr(st, f"{who}_opt"), mapper, tt._vars(st, who)))
                assert all(e <= MOMENT_TOL for e, _ in errs), (who, errs)
    assert sum(gru_cuda.launches.values()) == 0  # CPU tensors: plain versions only


def test_s2eg_step_reuses_the_fake_pass_dropout_masks(monkeypatch):
    """At dropout 0.3 the discriminator's pass on G's output in the G update
    draws the masks of its pass on the fake poses in the D update (JAX
    hands both the same key), and its pass on the real poses others."""
    masks = []
    dropout = TL.dropout

    def recording(x, p, training):
        out = dropout(x, p, training)
        if training and p > 0.0 and x.shape[-1] == 2 * DIS_HID:
            masks.append(out != 0)
        return out

    monkeypatch.setattr(TL, "dropout", recording)
    _, _, tg = _gen_pair()
    _, _, td = _dis_pair()
    td.gru.dropout = 0.3
    step = tser_trainer.S2egStep(tg, td, tstep.GanConfig(n_speakers=N_SPK))
    step.train_step(tt._torch_batch(_gan_inputs(9)), torch.Generator().manual_seed(0))
    # 3 D passes (real, fake, on G's output), 3 masks each (between 4 layers)
    assert len(masks) == 9
    real, fake, adversarial = masks[0:3], masks[3:6], masks[6:9]
    assert all(torch.equal(f, a) for f, a in zip(fake, adversarial))
    assert not any(torch.equal(r, f) for r, f in zip(real, fake))


# --------------------------------------------------------------- IEMOCAP

def test_front_end_matches_jax():
    """logfbank, delta and the 300-frame blocks of a 5.2 s int16 signal
    (509 frames: 3 stride-100 blocks) and of a 1 s one (one zero-padded
    block), exactly."""
    rng = np.random.default_rng(11)
    for seconds in (5.2, 1.0):
        sig = (rng.standard_normal(int(16000 * seconds)) * 1000).astype(np.int16)
        feats = tiemocap.logfbank(sig, 16000, nfilt=40)
        np.testing.assert_array_equal(feats, jiemocap.logfbank(sig, 16000, nfilt=40))
        np.testing.assert_array_equal(tiemocap.delta(feats, 2), jiemocap.delta(feats, 2))
        got, want = tiemocap.wav_to_blocks(sig, 16000), jiemocap.wav_to_blocks(sig, 16000)
        assert len(got) == len(want) == (3 if seconds > 5 else 1)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.shape == (300, 40)
                np.testing.assert_array_equal(a, b)
    for label, want in (("exc", "hap"), ("fru", "ang"), ("xxx", "oth"), ("sad", "sad")):
        got = tiemocap.extract_07_categorical_emotions(label)
        np.testing.assert_array_equal(got, jiemocap.extract_07_categorical_emotions(label))
        assert got[tiemocap.EMOTIONS_07.index(want)] == 1


def _write_wav(path, signal, rate=16000):
    with wave.open(str(path), "w") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(signal.astype(np.int16).tobytes())


def write_iemocap_tree(root, seed=0):
    """A synthetic IEMOCAP directory under root/iemocap: five sessions, each
    with an improvised dialog of three utterances (a male and a female
    speaker; the female one past 4 s, so that it gives two blocks) and a
    scripted one that the reader skips, and their EmoEvaluation lines."""
    rng = np.random.default_rng(seed)
    labels = ["neu", "exc", "fru", "sad", "xxx", "ang", "fea", "dis", "sur"]
    for s in range(1, 6):
        session = root / "iemocap" / f"Session{s}"
        for dialog in (f"Ses0{s}F_impro0{s}", f"Ses0{s}M_script01_1"):
            wav_dir = session / "sentences" / "wav" / dialog
            wav_dir.mkdir(parents=True)
            emo_dir = session / "dialog" / "EmoEvaluation"
            emo_dir.mkdir(parents=True, exist_ok=True)
            lines = ["% header line\n"]
            for u, gender in enumerate("MFM"):
                utt = f"{dialog}_{gender}00{u}"
                seconds = (1.0, 4.2, 2.0)[u]
                _write_wav(wav_dir / f"{utt}.wav",
                           rng.standard_normal(int(16000 * seconds)) * 800)
                dims = rng.uniform(1, 5, 3)
                lines.append(f"[{u * 4.0:.4f} - {u * 4.0 + seconds:.4f}]\t{utt}\t"
                             f"{labels[(s + u) % len(labels)]}\t"
                             f"[{dims[0]:.4f}, {dims[1]:.4f}, {dims[2]:.4f}]\n")
            (emo_dir / f"{dialog}.txt").write_text("".join(lines))


def _assert_same_splits(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_iemocap_matches_jax_and_caches_cross(tmp_path):
    """`load_iemocap_data` on a synthetic tree against JAX's on a copy of
    it, every split and statistic exactly (impro dialogs only; sessions 1-4
    train, session 5's male speaker test and female val); then, with the
    wavs gone, each package reads the cache the other wrote."""
    write_iemocap_tree(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    got = tiemocap.load_iemocap_data(str(tmp_path / "port"))
    want = jiemocap.load_iemocap_data(str(tmp_path / "jax"))
    _assert_same_splits(got, want)
    # 4 sessions x (1 + 2 + 1) blocks; session 5: 2 male blocks, 2 female
    assert got["train_data_wav"].shape == (16, 300, 40, 3)
    assert len(got["test_data_wav"]) == 2 and len(got["val_data_wav"]) == 2
    assert got["train_data_wav"].min() == 0.0 and got["train_data_wav"].max() == 1.0
    for side in ("port", "jax"):
        for wav in (tmp_path / side).rglob("*.wav"):
            os.remove(wav)
        assert (tmp_path / side / "iemocap" / "processed_07_cats_tpu" / "splits.npz").exists()
    _assert_same_splits(tiemocap.load_iemocap_data(str(tmp_path / "jax")), want)
    _assert_same_splits(jiemocap.load_iemocap_data(str(tmp_path / "port")), got)


# ------------------------------------------------------------------- CLI

def _sample_argv(parser):
    """A command line that gives every flag of `parser` a value of its
    type."""
    argv = []
    for action in parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[-1]
        if action.nargs == 0:
            argv.append(flag)
        elif action.nargs == "*":
            argv += [flag, "1", "2"]
        elif action.type is float:
            argv += [flag, "0.25"]
        elif action.type is int:
            argv += [flag, "3"]
        elif getattr(action.type, "__name__", "") == "str2bool":
            argv += [flag, "false"]
        else:
            argv += [flag, "x"]
    return argv


def test_main_v1_takes_every_flag_of_jax():
    """Every flag of JAX's parser, with a value of its type, parses in the
    port's to the same values; the port adds `--device` alone."""
    jparser, tparser = jmain.build_parser(), tmain.build_parser()
    jflags = {s for a in jparser._actions for s in a.option_strings}
    tflags = {s for a in tparser._actions for s in a.option_strings}
    assert tflags - jflags == {"--device"} and jflags <= tflags
    argv = _sample_argv(jparser)
    want = vars(jparser.parse_args(argv))
    got = vars(tparser.parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_main_v1_runs_on_the_card_by_default(tmp_path):
    """Without `--device` the entry point asks for the card: on a host
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["-b", str(tmp_path), "-c", str(_small_config(tmp_path)),
                    "--synthetic-data", "true"])


def _small_config(tmp_path):
    """config/multimodal_context_v2.yml at hidden 32, 2 GRU layers, word
    embedding 32."""
    src = os.path.join(os.path.dirname(__file__), "..", "config", "multimodal_context_v2.yml")
    text = open(src).read()
    for a, b in (("hidden_size: 300", "hidden_size: 32"), ("n_layers: 4", "n_layers: 2"),
                 ("wordembed_dim: 300", "wordembed_dim: 32")):
        assert a in text
        text = text.replace(a, b)
    path = tmp_path / "v1.yml"
    path.write_text(text)
    return path


def test_main_v1_cli_on_the_cpu(tmp_path, monkeypatch):
    """`main_v1` on the CPU with the synthetic data at hidden 32 and batch
    8 (the SER net narrowed as in the tests above): one SER epoch over the
    64 random blocks with its val line, then one s2eg epoch; every logged
    number finite, the log in `models/v1_ser_s2eg/log.txt`, and the GAN's
    loss weights `GanConfig`'s defaults."""
    monkeypatch.setattr(tmain, "AttConvRNN",
                        functools.partial(tser.AttConvRNN, **{**SER_KW, "dropout_prob": 0.2}))
    run = tmain.main(["-b", str(tmp_path), "-c", str(_small_config(tmp_path)),
                      "--synthetic-data", "true", "--batch-size", "8", "--device", "cpu"])
    log = (tmp_path / "models" / "v1_ser_s2eg" / "log.txt").read_text().splitlines()
    assert len(log) == 2 and "SER epoch 0: loss" in log[0] and "s2eg epoch 0: dis:" in log[1]
    numbers = [float(t) for line in log for t in line.replace("|", " ").split()
               if t.replace(".", "", 1).replace("-", "", 1).isdigit() and "." in t]
    assert len(numbers) == 8 and all(np.isfinite(numbers))
    assert np.isfinite(run.val_accuracy) and run.ser.dropout_prob == 0.2
    assert run.s2eg.cfg == tstep.GanConfig(learning_rate=5e-4, n_speakers=run.s2eg.cfg.n_speakers)
    assert run.s2eg.step == -(-run.dataset.n_samples // 8)
    assert set(run.s2eg_metrics) == {"dis", "loss", "DIV_REG", "KLD", "gen", "s2eg_l1"}
