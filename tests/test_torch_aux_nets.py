"""The port's auxiliary nets on the CPU against the JAX package: the
embedding net's `PoseDecoderFC` (with and without seed poses),
`PoseDecoderGRU`, `ContextEncoder` and `EmbeddingNet` in speech and random
mode (and the speech net decoding the poses' latent), and
`DiscriminatorTriModal` with and without text features, each at its
reference widths (the GRUs at H 256 and 300) on a batch of 4 windows of 34
frames, 36267 audio samples and words from a vocabulary of 50.

Each net: bridged weights (`convert.from_jax`), the forward in eval mode
and in train mode (BatchNorm's batch statistics and its running stats),
and the gradient of a fixed random weighting of every output with respect
to every parameter against `jax.grad`, within 1e-4 (outputs absolute;
gradients and running stats relative to each tensor's largest value:
float32 sums in another order through up to 8 GRU layers; a bias ahead of
a train-mode batch norm, whose gradient is zero but for rounding, relative
to the net's largest gradient, as `tests/test_torch_eval.py` holds it). Every dropout
is 0 on both sides: the JAX nets' fixed rates (the GRU decoder's 0.3, the
text encoder's 0.3 and 0.1) are patched to 0 for this module, as
`tests/test_torch_v1.py` patches them. The reparametrization's noise is
JAX's, handed to the port: eps = (z - mu) / exp(log_var / 2) of JAX's
outputs. The random mode's pick is drawn by JAX; the port's output is held
to it with the pick handed in, over seeds until each pick has come.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.models import discriminator as tdis
from speech2affective_gestures_torch.models import embedding_net as temb
from speech2affective_gestures_torch.models import layers as TL
from speech2affective_gestures_tpu.models import discriminator as jdis
from speech2affective_gestures_tpu.models import embedding_net as jemb
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import layers as JL

B, T, POSE_DIM, N_WORDS, AUDIO = 4, 34, 27, 50, 36267


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: beside other workers torch's threads wait on each
    other at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gru_without_dropout(*args, **kwargs):
    return JL.GRU(*args, **{**kwargs, "dropout": 0.0})


@pytest.fixture(scope="module", autouse=True)
def jax_dropout_off():
    """The JAX embedding net's fixed dropouts at 0: its module's
    TextEncoderTCN and L.GRU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jemb, "TextEncoderTCN",
                   functools.partial(jenc.TextEncoderTCN, dropout=0.0, emb_dropout=0.0))
        mp.setattr(jemb, "L", types.SimpleNamespace(
            **{**vars(JL), "GRU": _gru_without_dropout}))
        yield


def _no_dropout(net):
    for m in net.modules():
        if isinstance(m, TL.Dropout):
            m.p = 0.0
        if isinstance(m, TL.GRU):
            m.dropout = 0.0
    return net


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    poses = (rng.standard_normal((B, T, POSE_DIM)) * 0.3).astype(np.float32)
    return {"in_text": rng.integers(0, N_WORDS, (B, T)).astype(np.int32),
            "in_audio": (rng.standard_normal((B, AUDIO)) * 0.1).astype(np.float32),
            "pre_poses": poses[:, :4].copy(), "poses": poses,
            "latent": rng.standard_normal((B, 32)).astype(np.float32),
            "text_feat": rng.standard_normal((B, T, 32)).astype(np.float32)}


def _init(module, *args, **kw):
    return jax.device_get(jax.jit(functools.partial(module.init, **kw))(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, *args))


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _weights(outs):
    rng = np.random.default_rng(99)
    return [None if o is None else rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]


def _jax_fns(module, args, **kw):
    """The JAX module's two programs on `args`, each compiled once:
    evaluate(variables, key) -> eval outputs, the noise from `key`;
    train(variables, key, weights) -> (train outputs, batch_stats, the
    gradients of the weighted outputs' sum)."""
    @jax.jit
    def evaluate(variables, key):
        return module.apply(variables, *args, train=False, rngs={"noise": key}, **kw)

    @jax.jit
    def train(variables, key, weights):
        def loss(params):
            outs, mut = module.apply({"params": params,
                                      "batch_stats": variables.get("batch_stats", {})},
                                     *args, train=True, mutable=["batch_stats"],
                                     rngs={"noise": key}, **kw)
            total = sum(jnp.sum(o * w) for o, w in zip(_outs(outs), weights) if o is not None)
            return total, (outs, mut)

        (_, (outs, mut)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        return outs, mut.get("batch_stats", {}), grads

    return evaluate, train


def _close_scaled(got, want, name, tol=1e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _check(port, call, fns, variables, mapper, noise=2):
    """The port's net on the JAX module's bridged variables: eval and train
    outputs within 1e-4, the train pass's running stats and gradients
    (`mapper` over JAX's) relative to each tensor's largest. `fns` are
    `_jax_fns`'s; `call(net, jax_eval_outputs)` runs the port's forward on
    the same inputs (JAX's outputs give it their noise)."""
    key = jax.random.key(noise)
    evaluated = jax.device_get(fns[0](variables, key))
    weights = _weights(_outs(evaluated))
    trained, new_stats, grads = jax.device_get(fns[1](variables, key, weights))
    from_jax.load_jax(port, mapper, variables)
    _no_dropout(port)
    with torch.no_grad():
        got = _outs(call(port.eval(), evaluated))
    for i, (g, w) in enumerate(zip(got, _outs(evaluated))):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                       err_msg=f"eval output {i}")
    got = _outs(call(port.train(), evaluated))
    for i, (g, w) in enumerate(zip(got, _outs(trained))):
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                       err_msg=f"train output {i}")
    sum((g * torch.from_numpy(w)).sum() for g, w in zip(got, weights)
        if g is not None).backward()
    want_grads = mapper({"params": grads, "batch_stats": new_stats})
    want_stats = mapper({"params": variables["params"], "batch_stats": new_stats})
    top = max(np.abs(want_grads[name]).max() for name, _ in port.named_parameters())
    for name, p in port.named_parameters():
        if p.requires_grad:
            want = want_grads[name]
            if np.abs(want).max() <= 1e-3 * top:
                # a bias ahead of a train-mode batch norm: its gradient is
                # zero but for rounding, held to the net's largest
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * top,
                                           err_msg=f"grad {name}")
            else:
                _close_scaled(p.grad, want, f"grad {name}")
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _close_scaled(buf, want_stats[name], name)


@pytest.mark.parametrize("use_pre_poses", [False, True], ids=["latent", "pre_poses"])
def test_pose_decoder_fc_matches_jax(use_pre_poses):
    x = _inputs()
    args = (jnp.asarray(x["latent"]),) + ((jnp.asarray(x["pre_poses"]),) if use_pre_poses
                                          else ())
    jm = jemb.PoseDecoderFC(T, POSE_DIM, use_pre_poses=use_pre_poses)
    tm = temb.PoseDecoderFC(T, POSE_DIM, use_pre_poses=use_pre_poses)
    pre = torch.from_numpy(x["pre_poses"]) if use_pre_poses else None
    _check(tm, lambda n, _: n(torch.from_numpy(x["latent"]), pre), _jax_fns(jm, args),
           _init(jm, *args), from_jax.pose_decoder_fc)


def test_pose_decoder_gru_matches_jax():
    """H 300, 4 bi-GRU layers, the seed poses' net in train mode."""
    x = _inputs(1)
    args = (jnp.asarray(x["latent"]), jnp.asarray(x["pre_poses"]))
    jm = jemb.PoseDecoderGRU(T, POSE_DIM)
    _check(temb.PoseDecoderGRU(T, POSE_DIM),
           lambda n, _: n(torch.from_numpy(x["latent"]), torch.from_numpy(x["pre_poses"])),
           _jax_fns(jm, args), _init(jm, *args), from_jax.pose_decoder_gru)


def _eps(z, mu, log_var):
    return torch.from_numpy((np.asarray(z) - np.asarray(mu)) / np.exp(0.5 * np.asarray(log_var)))


def test_context_encoder_matches_jax():
    """The text TCN and the WavEncoder, the 2-layer GRU of 256 (its last
    frame), the VAE heads; z with JAX's noise handed in."""
    x = _inputs(2)
    args = (jnp.asarray(x["in_text"]), jnp.asarray(x["in_audio"]))
    jm = jemb.ContextEncoder(n_words=N_WORDS)
    text, audio = torch.from_numpy(x["in_text"]).long(), torch.from_numpy(x["in_audio"])
    _check(temb.ContextEncoder(N_WORDS), lambda n, out: n(text, audio, _eps(*out)),
           _jax_fns(jm, args), _init(jm, *args), from_jax.context_encoder)


def _embedding_args(x):
    return tuple(jnp.asarray(x[k]) for k in ("in_text", "in_audio", "pre_poses", "poses"))


def _port_call(x, eps=None, **kw):
    """The port's EmbeddingNet on x, the context's noise `eps` or, without
    it, JAX's outputs' (the call's second argument)."""
    def call(net, out=None):
        return net(torch.from_numpy(x["poses"]), in_text=torch.from_numpy(x["in_text"]).long(),
                   in_audio=torch.from_numpy(x["in_audio"]),
                   pre_poses=torch.from_numpy(x["pre_poses"]),
                   context_eps=_eps(*out[:3]) if eps is None else eps, **kw)
    return call


@pytest.fixture(scope="module")
def speech_net():
    """(JAX EmbeddingNet(mode='speech'), its variables, the inputs)."""
    x = _inputs(3)
    jm = jemb.EmbeddingNet(mode="speech", n_words=N_WORDS)
    return jm, _init(jm, *_embedding_args(x)), x


@pytest.mark.parametrize("input_mode", [None, "pose"], ids=["speech", "pose_latent"])
def test_embedding_net_speech_mode_matches_jax(speech_net, input_mode):
    """All seven outputs; with input_mode 'pose' the speech net decodes the
    poses' latent through its GRU decoder."""
    jm, variables, x = speech_net
    _check(temb.EmbeddingNet(mode="speech", n_words=N_WORDS),
           _port_call(x, input_mode=input_mode),
           _jax_fns(jm, _embedding_args(x), input_mode=input_mode), variables,
           from_jax.embedding_net)


def test_embedding_net_random_mode_matches_jax(speech_net):
    """JAX's random mode picks the context's or the poses' latent by a coin
    from its noise stream; the port, handed the same pick, gives the same
    outputs (eval and train, gradients). Seeds run until both picks came."""
    _, variables, x = speech_net
    fns = _jax_fns(jemb.EmbeddingNet(mode="random", n_words=N_WORDS), _embedding_args(x))
    picks = set()
    for noise in range(2, 20):
        out = jax.device_get(fns[0](variables, jax.random.key(noise)))
        eps_k = _eps(*out[:3])
        tnet = temb.EmbeddingNet(mode="random", n_words=N_WORDS)
        from_jax.load_jax(tnet, from_jax.embedding_net, variables)
        with torch.no_grad():
            both = {pick: _port_call(x, eps_k, pick_speech=pick)(tnet.eval())[-1]
                    for pick in (True, False)}
        errs = {pick: np.abs(o.numpy() - np.asarray(out[-1])).max() for pick, o in both.items()}
        pick = min(errs, key=errs.get)
        assert errs[pick] <= 1e-4 < errs[not pick], errs
        if pick not in picks:
            picks.add(pick)
            _check(tnet, _port_call(x, pick_speech=pick), fns, variables,
                   from_jax.embedding_net, noise=noise)
        if len(picks) == 2:
            break
    assert picks == {True, False}


def test_embedding_net_random_pick_from_the_generator(speech_net):
    """Without a pick handed in, the port draws it from the generator: the
    same generator state, the same pick; over seeds both come."""
    _, variables, x = speech_net
    eps = torch.zeros(B, 32)
    tnet = temb.EmbeddingNet(mode="random", n_words=N_WORDS).eval()
    from_jax.load_jax(tnet, from_jax.embedding_net, variables)
    picks = set()
    with torch.no_grad():
        for seed in range(8):
            out = _port_call(x, eps, generator=torch.Generator().manual_seed(seed))(tnet)[-1]
            again = _port_call(x, eps, generator=torch.Generator().manual_seed(seed))(tnet)[-1]
            assert torch.equal(out, again)
            speech = _port_call(x, eps, pick_speech=True)(tnet)[-1]
            picks.add(bool(torch.equal(out, speech)))
    assert picks == {True, False}


def test_embedding_net_modes_build_with_the_reference_key_groups():
    """Speech and random build the context encoder, the pose encoder and
    the GRU decoder; pose the FGD net; another mode raises."""
    for mode in ("speech", "random"):
        keys = {k.split(".")[0] for k in temb.EmbeddingNet(mode=mode).state_dict()}
        assert keys == {"context_encoder", "pose_encoder", "decoder"}
    assert {k.split(".")[0] for k in temb.EmbeddingNet().state_dict()} == {
        "pose_encoder", "decoder"}
    with pytest.raises(ValueError, match="mode"):
        temb.EmbeddingNet(mode="text")


@pytest.mark.parametrize("with_text", [False, True], ids=["poses", "poses_text"])
def test_discriminator_trimodal_matches_jax(with_text):
    """4 bi-GRU layers of 300 with summed directions, at dropout 0."""
    x = _inputs(4)
    args = (jnp.asarray(x["poses"]),) + ((jnp.asarray(x["text_feat"]),) if with_text else ())
    jm = jdis.DiscriminatorTriModal(dropout_prob=0.0)
    tm = tdis.DiscriminatorTriModal(text_size=32 if with_text else 0, dropout_prob=0.0)
    text = torch.from_numpy(x["text_feat"]) if with_text else None
    _check(tm, lambda n, _: n(torch.from_numpy(x["poses"]), text), _jax_fns(jm, args),
           _init(jm, *args), from_jax.discriminator_trimodal)
    with pytest.raises(ValueError, match="text_feat"):
        tm(torch.from_numpy(x["poses"]), None if with_text else torch.from_numpy(x["text_feat"]))
