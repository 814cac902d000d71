"""The paper's two ablations (abl_audio: the generator on the raw audio
window through a WavEncoder; abl_aff: the generator without the AffEncoder,
and the ConvDiscriminator) and the generator's other input_context / z_type
settings: the port against the JAX package on the CPU.

Sizes of tests/test_torch_train.py: hidden 16, one generator GRU layer,
word embedding 16, 30 words, 5 speakers, batch 4, the discriminators at
hidden 16, every dropout at zero. The JAX models are not initialized (the
eager init of `init_training` takes tens of seconds on the CPU): the shapes
of their variables come from `jax.eval_shape` of the init, or from
`init_training(..., abstract=True)` for the GAN step, and are filled with
numpy draws from a seed (`_fill`); the port's models take them through
`convert/from_jax.py` with `strict=True`.

Noise: a JAX forward's z is handed to the port as eps (for the speaker z,
eps = (z - mu) / exp(0.5 log_var); for the random z, z itself). In the GAN
steps JAX's `re_parametrize` is patched to z = mu and the port given eps =
eps_rand = 0, as in tests/test_torch_train.py; under the random z the JAX
generator module's `jax.random.normal` is replaced by the noises the port
is handed (`_HandedNoise`). The serving and rendering paths replay the JAX
programs' per-window key splits.

Tolerances, float32 with sums in another order: single forwards 5e-5
absolute, BN running stats within 1e-4 of their magnitude plus 1e-4 of
each tensor's largest; the ConvDiscriminator's gradients within 1e-4 of
each tensor's largest (of the net's largest for the conv biases ahead of a
batch norm, whose gradient is zero up to float noise); the GAN steps as
`test_two_gan_steps_match_jax` (metrics 1e-4 then 1e-3 relative, Adam
moments within MOMENT_TOL of each tensor's largest, the parameters after
step 1 within 1e-4 relative (plus 1e-4 lr) where the gradient's sign is
fixed at that tolerance, else within 2 lr: `_assert_params`); the served,
streamed and rendered poses 1e-4 absolute (fed back autoregressively
through 5 windows).
"""

import dataclasses
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as tt
from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch import main_v2_abl_aff, main_v2_abl_audio
from speech2affective_gestures_torch import serve as tserve
from speech2affective_gestures_torch import streaming as tstreaming
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.data.vocab import Vocab as TVocab
from speech2affective_gestures_torch.models.discriminator import (
    AffDiscriminator as TAffDis, ConvDiscriminator as TConvDis)
from speech2affective_gestures_torch.models.generator import (
    PoseGenerator as TGen, PoseGeneratorTriModal as TTri)
from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_torch.train import builder as tbuilder
from speech2affective_gestures_torch.train import clip_eval as tce
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train import synthesis as tsyn
from speech2affective_gestures_torch.train.trainer import Trainer as TTrainer
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.convert import jax_to_torch, torch_ckpt
from speech2affective_gestures_tpu.data import ted_db as jdb
from speech2affective_gestures_tpu.data.vocab import Vocab as JVocab
from speech2affective_gestures_tpu.models import discriminator as jdis_mod
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import clip_eval as jce
from speech2affective_gestures_tpu.train import gan_step as jstep
from speech2affective_gestures_tpu.train import synthesis as jsyn
from speech2affective_gestures_tpu.train import trainer as jtrainer_mod

N_WORDS, N_SPK, B, HID, EMB = tt.N_WORDS, tt.N_SPK, tt.B, tt.HID, tt.EMB
WIDTHS = dict(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB,
              dropout_prob=0.0, loss_warmup=-1)
JCFG, TCFG = JConfig(**WIDTHS), TConfig(**WIDTHS)
GEN_KW = dict(n_words=N_WORDS, word_embed_size=EMB, hidden_size=HID, n_layers=1,
              dropout_prob=0.0, n_speakers=N_SPK, emb_dropout=0.0)
VARIANT_KW = {"abl_audio": dict(audio_encoder_type="wav"),
              "abl_aff": dict(use_aff_encoder=False)}
AUDIO_KEY = {"abl_audio": "audio", "abl_aff": "mfcc_features"}
WORDS = [["hello", 0.2, 0.6], ["world", 1.5, 2.0], ["again", 3.1, 3.5]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module: its small CPU ops gain nothing from
    more, and the parallel test run's other workers share the cores (the
    train tests pass with any thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def deterministic_jax():
    """Every dropout of the JAX models at zero (the TriModal's text
    embedding dropout, which it fixes at 0.1, through its module-level
    TextEncoderTCN name), the discriminators at hidden 16 where
    `init_training` builds them."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    mp.setattr(jbuilder, "PoseGenerator",
               functools.partial(jgen_mod.PoseGenerator, emb_dropout=0.0))
    for name in ("AffDiscriminator", "ConvDiscriminator"):
        mp.setattr(jbuilder, name, functools.partial(getattr(jdis_mod, name),
                                                     hidden_size=HID, dropout_prob=0.0))
    yield
    mp.undo()


def _fill(shapes, seed):
    """Numpy values from `seed` for a tree of shapes: BN running means
    0.1 N(0, 1), variances 1 + 0.1 |N(0, 1)|, scales 1 + 0.1 N(0, 1),
    embeddings N(0, 1), vectors 0.1 N(0, 1), kernels N(0, 1) / sqrt(fan in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = getattr(path[-1], "key", None), tuple(s.shape)
        n = rng.standard_normal(shape)
        if name == "var":
            v = 1.0 + 0.1 * np.abs(n)
        elif name == "scale":
            v = 1.0 + 0.1 * n
        elif name == "embedding":
            v = n
        elif len(shape) <= 1:
            v = 0.1 * n
        else:
            v = n / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_variables(module, args, seed):
    shapes = jax.eval_shape(module.init, {"params": jax.random.key(0),
                                          "noise": jax.random.key(1)}, *args)
    return _fill(shapes, seed)


def _inputs(batch_seed, audio_key):
    """(JAX batch, port batch, the generator's positional inputs as numpy)."""
    b = tt._batch(batch_seed)
    tb = tt._torch_batch(b)
    pre = tstep.build_pre_seq(tb["vec_seq"], C.N_PRE_POSES).numpy()
    return b, tb, (pre, b["extended_word_seq"], b[audio_key], b["vid_indices"])


def _eps(z, mu, log_var):
    """The port's eps for a JAX forward's (z, mu, log_var)."""
    if z is None:
        return None
    eps = z if mu is None else (z - mu) / np.exp(0.5 * log_var)
    return torch.from_numpy(np.array(eps, np.float32))


def _port_generator(variables, **kw):
    gen = TGen(**GEN_KW, **kw)
    from_jax.load_jax(gen, from_jax.pose_generator, variables)
    return gen


def _generator_pair(variant, seed=0):
    jgen = jgen_mod.PoseGenerator(**GEN_KW, **VARIANT_KW[variant])
    _, _, args = _inputs(1, AUDIO_KEY[variant])
    jv = _jax_variables(jgen, args, seed)
    return jgen, jv, _port_generator(jv, **VARIANT_KW[variant])


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("variant", ["abl_audio", "abl_aff"])
def test_ablation_generators_match_jax(variant, mode):
    """Each ablation's generator against JAX's with the same variables:
    the output, z and, in train mode, the BN running stats it updates;
    abl_audio's input is the raw audio window, abl_aff's GRU takes 108
    features (28 + 32 + 32 + 16)."""
    jgen, jv, tgen = _generator_pair(variant)
    b, tb, args = _inputs(2, AUDIO_KEY[variant])
    train = mode == "train"
    kw = dict(train=train, rngs={"noise": jax.random.key(5), "dropout": jax.random.key(6)})
    if train:
        kw["mutable"] = ["batch_stats"]
    got_j = jax.jit(functools.partial(jgen.apply, **kw))(jv, *map(jnp.asarray, args))
    (out, z, mu, lv), new = got_j if train else (got_j, None)
    want = jax.device_get((out, z, mu, lv))
    tgen.train(train)
    with torch.no_grad():
        got, tz, _, _ = tgen(*map(torch.from_numpy, args), eps=_eps(*want[1:]))
    assert tgen.gru.weight_ih_l0.shape[1] == {"abl_audio": 88, "abl_aff": 108}[variant]
    assert got.shape == (B, C.N_POSES, C.POSE_DIM)
    np.testing.assert_allclose(got.numpy(), want[0], atol=5e-5)
    np.testing.assert_allclose(tz.numpy(), want[1], atol=1e-5)
    if train:
        tt._assert_stats(tgen, from_jax.pose_generator,
                         dict(jv, batch_stats=jax.device_get(new["batch_stats"])), 1e-4)


def test_conv_discriminator_and_its_gradients_match_jax():
    """`ConvDiscriminator` (abl_aff's, the TriModal's conv discriminator) in
    train mode: its output, the BN running stats, and the gradients of a
    weighted sum of its output with respect to the poses and every
    parameter; then in eval mode with the updated stats."""
    jdis = jdis_mod.ConvDiscriminator(hidden_size=HID, dropout_prob=0.0)
    b = tt._batch(3)
    poses = b["vec_seq"]
    jv = _jax_variables(jdis, (poses,), 7)
    weight = np.random.default_rng(8).standard_normal((B, 1)).astype(np.float32)

    def loss(params, x):
        out, mut = jdis.apply({"params": params, "batch_stats": jv["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
        return (out * weight).sum(), (out, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.device_get(jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jv["params"], poses))
    tdis = TConvDis(hidden_size=HID, dropout_prob=0.0)
    from_jax.load_jax(tdis, from_jax.conv_discriminator_trimodal, jv)
    x = torch.from_numpy(poses).requires_grad_()
    got = tdis.train()(x)
    (got * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5)
    new_vars = dict(jv, batch_stats=stats)
    tt._assert_stats(tdis, from_jax.conv_discriminator_trimodal, new_vars, 1e-4)
    np.testing.assert_allclose(x.grad.numpy(), gx, atol=1e-4 * np.abs(gx).max())
    want_grads = from_jax.conv_discriminator_trimodal({"params": gp, "batch_stats": stats})
    # the conv biases ahead of a batch norm have a zero gradient up to float
    # noise (the batch mean removes them): a tensor whose gradient lies
    # below 1e-4 of the net's largest is held to that largest instead
    top = max(np.abs(want_grads[name]).max() for name, _ in tdis.named_parameters())
    for name, p in tdis.named_parameters():
        w = np.asarray(want_grads[name])
        scale = np.abs(w).max() if np.abs(w).max() >= 1e-4 * top else top
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * scale, err_msg=name)
    assert tdis.gru.weight_ih_l0.shape[1] == 8 and tdis.out2.in_features == C.N_POSES - 6
    want_eval = jax.device_get(jax.jit(jdis.apply)(new_vars, poses))
    with torch.no_grad():
        np.testing.assert_allclose(tdis.eval()(torch.from_numpy(poses)).numpy(), want_eval,
                                   atol=5e-5)


@pytest.mark.parametrize("input_context,z_type",
                         list(itertools.product(("both", "audio", "text", "none"),
                                                ("speaker", "random", "none"))))
def test_generator_settings_match_jax(input_context, z_type):
    """Every input context and z type of the s2ag generator, eval mode:
    the GRU's input width (8 seed features, 32 audio, 32 text, 16 z where
    present), the output and z; mu and log_var only for the speaker z."""
    kw = dict(input_context=input_context, z_type=z_type)
    jgen = jgen_mod.PoseGenerator(**GEN_KW, **kw)
    _, _, args = _inputs(4, "mfcc_features")
    jv = _jax_variables(jgen, args, 9)
    tgen = _port_generator(jv, **kw).eval()
    out, z, mu, lv = jax.device_get(jax.jit(jgen.apply)(
        jv, *map(jnp.asarray, args), rngs={"noise": jax.random.key(3)}))
    with torch.no_grad():
        got, tz, tmu, tlv = tgen(*map(torch.from_numpy, args), eps=_eps(z, mu, lv))
    width = (8 + 32 * (input_context in ("both", "audio"))
             + 32 * (input_context in ("both", "text")) + 16 * (z_type != "none"))
    assert tgen.gru.weight_ih_l0.shape[1] == jv["params"]["gru"]["w_ih_l0"].shape[0] == width
    np.testing.assert_allclose(got.numpy(), out, atol=5e-5)
    assert (tz is None) == (z is None) and (tmu is None) == (mu is None)
    if z is not None:
        np.testing.assert_allclose(tz.numpy(), z, atol=1e-5)
    if mu is not None:
        np.testing.assert_allclose(tmu.numpy(), mu, atol=1e-6)
        np.testing.assert_allclose(tlv.numpy(), lv, atol=1e-6)


@pytest.mark.parametrize("net", ["abl_audio", "abl_aff", "conv_discriminator",
                                 "trimodal_random_z"])
def test_bridges_load_strict_with_reference_keys(net):
    """Each bridge emits the reference's state-dict keys (the JAX
    package's inverse mappers' key sets), which the port's module loads
    with strict=True: abl_audio's WavEncoder under
    `audio_encoder.feat_extractor.*`, no `aff_encoder.*` for abl_aff, the
    ConvDiscriminator's `pre_conv.0/1/3/4/6`, no `speaker_*` for a random
    z. The ablations' port state dicts read back through the JAX
    package's checkpoint reader of that variant
    (`torch_ckpt.convert_s2ag_checkpoint`) give the same variables."""
    if net in VARIANT_KW:
        _, jv, tgen = _generator_pair(net)
        want = set(jax_to_torch.pose_generator_inv(jv, 1, variant=net))
        assert set(from_jax.pose_generator(jv)) == want == set(tgen.state_dict())
        prefix = {"abl_audio": "audio_encoder.feat_extractor.", "abl_aff": "aff_encoder."}
        assert any(k.startswith(prefix[net]) for k in want) == (net == "abl_audio")
        dis = (TConvDis if net == "abl_aff" else TAffDis)(hidden_size=HID)
        blob = {"gen_model_dict": {f"module.{k}": v.numpy()
                                   for k, v in tgen.state_dict().items()},
                "dis_model_dict": {f"module.{k}": v.numpy()
                                   for k, v in dis.state_dict().items()}}
        gen_vars, _ = torch_ckpt.convert_s2ag_checkpoint(blob, variant=net, n_layers=1)
        flat = jax.tree_util.tree_leaves_with_path
        got, ref = dict(flat(gen_vars)), dict(flat(jv))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=str(k))
    elif net == "conv_discriminator":
        jdis = jdis_mod.ConvDiscriminator(hidden_size=HID)
        jv = _jax_variables(jdis, (tt._batch(0)["vec_seq"],), 1)
        tdis = TConvDis(hidden_size=HID)
        from_jax.load_jax(tdis, from_jax.conv_discriminator_trimodal, jv)
        want = set(jax_to_torch.conv_discriminator_trimodal_inv(jv))
        assert set(from_jax.conv_discriminator_trimodal(jv)) == want == set(tdis.state_dict())
        assert {k.split(".")[1] for k in want if k.startswith("pre_conv.")} == {
            "0", "1", "3", "4", "6"}
    else:
        kw = dict(n_words=N_WORDS, word_embed_size=EMB, hidden_size=HID, n_layers=1,
                  n_speakers=N_SPK, z_type="random")
        jtri = jgen_mod.PoseGeneratorTriModal(**kw)
        _, _, args = _inputs(0, "audio")
        jv = _jax_variables(jtri, args, 2)
        ttri = TTri(**kw)
        from_jax.load_jax(ttri, from_jax.pose_generator_trimodal, jv)
        want = set(jax_to_torch.pose_generator_trimodal_inv(jv, 1))
        assert set(from_jax.pose_generator_trimodal(jv)) == want == set(ttri.state_dict())
        assert not any(k.startswith("speaker_") for k in want)


# -------------------------------------------------------------- GAN steps

@pytest.fixture()
def same_draws(monkeypatch):
    """The diversity regularizer's second-pass speaker ids on both sides
    (tests/test_torch_train.py's DIV_IDS), and JAX's speaker z = mu."""
    monkeypatch.setattr(jstep, "draw_other_speaker_ids",
                        lambda key, vids, n: jnp.asarray(tt.DIV_IDS, vids.dtype))
    monkeypatch.setattr(tstep, "draw_other_speaker_ids",
                        lambda g, vids, n: torch.as_tensor(tt.DIV_IDS, device=vids.device))
    monkeypatch.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)


def _step_pair(variant, z_type="speaker", seed=0):
    """JAX's `init_training(variant=...)` train step over filled variables
    and the port's `GanStep` from the same variables, with the port
    builder's `gan_config` of the variant."""
    jcfg = dataclasses.replace(JCFG, z_type=z_type)
    setup = jbuilder.init_training(jcfg, jax.random.key(0), N_WORDS, N_SPK, variant=variant,
                                   abstract=True)
    st = setup["state"]
    variables = {who: _fill({"params": getattr(st, f"{who}_params"),
                             "batch_stats": getattr(st, f"{who}_stats")}, seed + i)
                 for i, who in enumerate(("gen", "dis", "tri"))}
    state = jstep.create_train_state(variables["gen"], variables["dis"], setup["gan_cfg"],
                                     variables["tri"])
    assert setup["gan_cfg"].generator_input == AUDIO_KEY[variant]
    gen = _port_generator(variables["gen"], z_type=z_type, **VARIANT_KW[variant])
    dis = (TConvDis if variant == "abl_aff" else TAffDis)(hidden_size=HID, dropout_prob=0.0)
    mapper = (from_jax.conv_discriminator_trimodal if variant == "abl_aff"
              else from_jax.aff_discriminator)
    from_jax.load_jax(dis, mapper, variables["dis"])
    tri = TTri(**GEN_KW, z_type=z_type).requires_grad_(False)
    from_jax.load_jax(tri, from_jax.pose_generator_trimodal, variables["tri"])
    gan_cfg = tbuilder.gan_config(dataclasses.replace(TCFG, z_type=z_type), N_SPK,
                                  variant=variant)
    assert gan_cfg.generator_input == AUDIO_KEY[variant]
    return setup["train_step"], state, tstep.GanStep(gen, dis, gan_cfg, tri), mapper


def _assert_params(step, st, who, mapper):
    """The port's parameters after one Adam step against JAX's. The step
    moves each by lr g / (|g| + eps), about lr times the sign of its
    gradient g: where JAX's first moment lies at or above MOMENT_TOL of
    its tensor's largest (the moments' own tolerance; of the net's
    largest for a tensor all below 1e-4 of it, as `_moment_errors`
    measures them), within 1e-4 relative plus 1e-4 lr (a parameter near
    zero); below it, where the tolerance does not fix the sign (the biases
    ahead of a batch norm, a leaky ReLU's pre-activation at float noise),
    within 2 lr."""
    lr = step.cfg.learning_rate * (1.0 if who == "gen" else step.cfg.discriminator_lr_weight)
    want = mapper(tt._vars(st, who))
    moments = tt._optax_moments(getattr(st, f"{who}_opt"), mapper, tt._vars(st, who))
    params = dict(getattr(step, who).named_parameters())
    top = max(np.abs(moments[name][0]).max() for name in params)
    for name, p in params.items():
        got, w = p.detach().numpy(), np.asarray(want[name]).reshape(p.shape)
        m = np.abs(np.asarray(moments[name][0])).reshape(p.shape)
        scale = m.max() if m.max() >= 1e-4 * top else top
        sure = m >= tt.MOMENT_TOL * scale
        np.testing.assert_allclose(got[sure], w[sure], rtol=1e-4, atol=1e-4 * lr,
                                   err_msg=f"{who} {name}")
        assert np.abs(got - w).max() <= 2.0001 * lr, (who, name)


@pytest.mark.parametrize("variant", ["abl_audio", "abl_aff"])
def test_two_gan_steps_match_jax(variant, same_draws):
    """Two GAN steps of each ablation against JAX's `init_training` step,
    as tests/test_torch_train.py's `test_two_gan_steps_match_jax`, on its
    batch seeds: the metrics of both steps; after step 1 the parameters,
    the BN running stats and both nets' Adam states. abl_audio's generator
    (and its WavEncoder) trains on the batch's raw audio."""
    train_step, state, step, mapper = _step_pair(variant)
    g, zeros = torch.Generator().manual_seed(0), torch.zeros(B, 16)
    for i, seed in enumerate(tt.STEP_SEEDS):
        b = tt._batch(seed)
        state, want = train_step(state, jax.device_put(b), jax.random.key(i), gan_on=True)
        want = {k: float(v) for k, v in jax.device_get(want).items()}
        got = {k: float(v) for k, v in step.train_step(tt._torch_batch(b), g, gan_on=True,
                                                       eps=zeros, eps_rand=zeros).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=(1e-4, 1e-3)[i], atol=1e-6,
                                       err_msg=k)
        if i == 0:
            st = jax.device_get(state)
            for who, m in (("gen", from_jax.pose_generator), ("dis", mapper)):
                _assert_params(step, st, who, m)
                errs = tt._moment_errors(
                    tt._torch_moments(getattr(step, f"{who}_opt"), getattr(step, who)),
                    tt._optax_moments(getattr(st, f"{who}_opt"), m, tt._vars(st, who)))
                assert all(e <= tt.MOMENT_TOL for e, _ in errs), (who, errs)
            tt._assert_stats(step.gen, from_jax.pose_generator, tt._vars(st, "gen"), 1e-4)
            # the discriminator's last forward runs after its update: 1e-3
            tt._assert_stats(step.dis, mapper, tt._vars(st, "dis"), 1e-3)
    assert sum(gru_cuda.launches.values()) == 0  # CPU tensors: plain versions only


class _HandedNoise:
    """`jax.random.normal` for the JAX generator module (its random z): the
    i-th draw of the traced step is draws[i], whatever the key."""

    def __init__(self, draws):
        self.draws, self.calls = draws, 0

    def normal(self, key, shape, dtype=jnp.float32):
        out = self.draws[self.calls]
        self.calls += 1
        assert tuple(shape) == out.shape
        return jnp.asarray(out, dtype)


def test_random_z_gan_step_matches_jax(same_draws, monkeypatch):
    """One GAN step with `z_type="random"` (abl_aff's nets): z is the noise
    itself, so the KLD is off and the diversity regularizer compares the
    main forward's z with the second forward's. JAX draws them from two
    keys; the port is handed eps and eps_rand, and JAX's draws are set to
    them in its step's order (the D step's generator, the G step's, the
    regularizer's, the TriModal's). Metrics within 1e-4 relative, the
    Adam states within MOMENT_TOL. The same step with eps_rand = eps makes
    the two passes alike (z_rand = z) and the regularizer vanishes, within
    1e-3 of its value with two noises."""
    train_step, state, step, mapper = _step_pair("abl_aff", "random", seed=20)
    rng = np.random.default_rng(21)
    eps, eps_rand = (rng.standard_normal((B, 16)).astype(np.float32) for _ in range(2))
    noise = _HandedNoise([eps, eps, eps_rand, eps])
    monkeypatch.setattr(jgen_mod, "jax", types.SimpleNamespace(random=noise))
    b = tt._batch(tt.STEP_SEEDS[0])
    state, want = train_step(state, jax.device_put(b), jax.random.key(0), gan_on=True)
    assert noise.calls == 4
    want = {k: float(v) for k, v in jax.device_get(want).items()}
    got = {k: float(v) for k, v in step.train_step(
        tt._torch_batch(b), torch.Generator().manual_seed(0), gan_on=True,
        eps=torch.from_numpy(eps), eps_rand=torch.from_numpy(eps_rand)).items()}
    assert set(got) == set(want) and "KLD" not in got and got["DIV_REG"] < 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    st = jax.device_get(state)
    for who, m in (("gen", from_jax.pose_generator), ("dis", mapper)):
        errs = tt._moment_errors(
            tt._torch_moments(getattr(step, f"{who}_opt"), getattr(step, who)),
            tt._optax_moments(getattr(st, f"{who}_opt"), m, tt._vars(st, who)))
        assert all(e <= tt.MOMENT_TOL for e, _ in errs), (who, errs)
    same = step.train_step(tt._torch_batch(b), torch.Generator().manual_seed(0),
                           eps=torch.from_numpy(eps), eps_rand=torch.from_numpy(eps))
    assert abs(float(same["DIV_REG"])) <= 1e-3 * abs(got["DIV_REG"])


# ------------------------------------------------------------ entry points

def _yaml_config(tmp_path, **extra):
    import yaml

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB,
               random_seed=3, loss_warmup=-1, **extra)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    return path


@pytest.mark.parametrize("entry,variant", [(main_v2_abl_audio, "abl_audio"),
                                           (main_v2_abl_aff, "abl_aff")])
def test_ablation_entry_points_train_and_reload(tmp_path, entry, variant):
    """`main_v2_abl_*.main` on the CPU: one epoch with the GAN terms on
    writes a checkpoint into `models/s2ag_v2_mfcc_torch_<variant>/ted_db`,
    every logged loss finite and the test split scored; a second run
    without training loads it (strict, the variant's nets)."""
    argv = ["-b", str(tmp_path / "base"), "-c", str(_yaml_config(tmp_path)),
            "--synthetic-data", "true", "--device", "cpu", "--batch-size", "4",
            "--s2ag-num-epoch", "1", "--synthetic-videos", "2", "--synthetic-seconds",
            "4", "--log-interval", "1"]
    trainer = entry.main(argv)
    work = tmp_path / f"base/models/s2ag_v2_mfcc_torch_{variant}/ted_db"
    assert trainer.variant == variant and trainer.work_dir == str(work)
    assert trainer.gan_cfg.generator_input == AUDIO_KEY[variant]
    assert isinstance(trainer.dis, TConvDis if variant == "abl_aff" else TAffDis)
    assert (trainer.gen.aff_encoder is None) == (variant == "abl_aff")
    log = (work / "log.txt").read_text()
    iters = [line for line in log.splitlines() if "Done. |" in line]
    assert iters and all("dis:" in line for line in iters) and "eval: l1" in log
    values = [float(tok.split(": ")[1]) for line in iters
              for tok in line.split("Done. | ")[1].split(" | ")]
    assert np.isfinite(values).all()
    [ckpt] = work.glob("epoch_000000_loss_*_model.pth.tar")
    again = entry.main(argv + ["--train-s2ag", "false"])
    assert again.epoch == 0 and "restored " + ckpt.name in (work / "log.txt").read_text()
    for name in ("gen", "dis"):
        for k, v in getattr(trainer, name).state_dict().items():
            assert torch.equal(getattr(again, name).state_dict()[k], v), k
    assert not (tmp_path / "base/models/s2ag_v2_mfcc_torch").exists()


@pytest.mark.parametrize("variant", ["abl_audio", "abl_aff"])
def test_jax_trainer_cannot_load_an_ablation_checkpoint(tmp_path, variant):
    """A JAX-package fault the port does not share (ROADMAP.md §3): JAX's
    `Trainer.load_torch_checkpoint` converts every checkpoint as s2ag
    (`convert_s2ag_checkpoint(blob)` without the variant), so an ablation's
    reference checkpoint raises a KeyError on the keys it lacks (the MFCC
    encoder's for abl_audio, the AffEncoder's for abl_aff). The port's
    `--torch-checkpoint` loads it by name, strict."""
    # the reference's depth (4 TCN levels, 4 GRU layers), which JAX's
    # converter assumes whatever the config says
    cfg = dataclasses.replace(TCFG, n_layers=4)
    src = TTrainer(cfg, str(tmp_path / "src"), device="cpu", seed=1, variant=variant)
    path = tmp_path / "reference.pth.tar"
    torch.save({f"{name}_model_dict": {f"module.{k}": v for k, v in
                                       getattr(src, name).state_dict().items()}
                for name in ("gen", "dis")}, path)
    missing = {"abl_audio": r"'audio_encoder\.linear1", "abl_aff": r"'aff_encoder\."}[variant]
    with pytest.raises(KeyError, match=missing):
        jtrainer_mod.Trainer.load_torch_checkpoint(types.SimpleNamespace(), str(path))
    dst = TTrainer(cfg, str(tmp_path / "dst"), device="cpu", seed=2, variant=variant)
    dst.load_torch_checkpoint(str(path))
    for name in ("gen", "dis"):
        for k, v in getattr(src, name).state_dict().items():
            assert torch.equal(getattr(dst, name).state_dict()[k], v), k


@pytest.mark.parametrize("z_type", ["speaker", "random", "none"])
def test_checkpoint_speakers_reads_the_speaker_table(tmp_path, z_type):
    """`main_v2.checkpoint_speakers`: the speaker embedding's size, None for
    a generator without one."""
    cfg = dataclasses.replace(TCFG, z_type=z_type)
    trainer = TTrainer(cfg, str(tmp_path), device="cpu", n_speakers=7)
    path = trainer.save_checkpoint(0.5)
    assert tmain.checkpoint_speakers(path) == (7 if z_type == "speaker" else None)
    assert trainer.gen.n_speakers == (7 if z_type == "speaker" else None)


# --------------------------------------------------- serving and rendering

def _vocabs():
    jv, tv = JVocab("w"), TVocab("w")
    for w in ("hello", "world", "again"):
        jv.index_word(w)
        tv.index_word(w)
    return jv, tv


def _replay_eps(apply, variables, in_audio, key, vid, n_windows):
    """JAX's per-window eps (S, 1, 16) of a clip whose program starts at
    `key`: each window splits the key once and draws from the half."""
    pre = jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1))
    text = jnp.zeros((1, C.N_POSES), jnp.int32)
    out = []
    for _ in range(n_windows):
        key, sub = jax.random.split(key)
        _, z, mu, lv = jax.device_get(apply(variables, pre, text, in_audio,
                                            jnp.asarray([vid]), rngs={"noise": sub}))
        out.append(_eps(z, mu, lv)[:, None])
    return torch.cat(out)


def _no_mfcc(*args, **kwargs):
    raise AssertionError("the MFCC front-end ran for a generator that eats raw audio")


@pytest.mark.parametrize("variant", ["abl_audio", "abl_aff"])
def test_service_and_stream_match_jax(variant, monkeypatch):
    """A 10 s clip through `SynthesisService.from_trainer` over an
    ablation's trainer (abl_audio: raw audio windows, `use_mfcc=False`, no
    MFCC computed) and through a `StreamingSynthesizer` fed 0.5 s chunks,
    against JAX's `synthesize_clip_fused` with the same noise."""
    jgen, jv, tgen = _generator_pair(variant, seed=11)
    jvocab, tvocab = _vocabs()
    audio = _audio(10.0)
    use_mfcc = variant != "abl_audio"
    fn = jsyn.make_fused_clip_fn(jgen.apply, JCFG, use_mfcc=use_mfcc)
    want_dv, want_ps = jsyn.synthesize_clip_fused(fn, jv, audio, WORDS, jvocab, JCFG,
                                                  vid_idx=2, rng=jax.random.key(4))
    in_audio = (jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)) if use_mfcc
                else jnp.zeros((1, JCFG.expected_audio_length)))
    eps = _replay_eps(jax.jit(jgen.apply), jv, in_audio, jax.random.key(4), 2, 5)
    if not use_mfcc:
        monkeypatch.setattr(tsyn, "window_features", _no_mfcc)
    trainer = types.SimpleNamespace(cfg=TCFG, gen=tgen, variant=variant, train_data=None,
                                    test_data=types.SimpleNamespace(lang_model=tvocab))
    service = tserve.SynthesisService.from_trainer(trainer)
    assert service.use_mfcc == use_mfcc
    got = service.synthesize(audio, WORDS, vid_idx=2, eps=eps)
    assert got["dir_vec"].shape == want_dv.shape == (4 * 30 + 34, C.POSE_DIM)
    np.testing.assert_allclose(got["dir_vec"], want_dv, atol=1e-4)
    np.testing.assert_allclose(got["poses"], want_ps, atol=1e-4)
    stream = tstreaming.StreamingSynthesizer(tgen, tvocab, TCFG, vid_idx=2, eps=eps,
                                             use_mfcc=use_mfcc)
    half = C.AUDIO_SR // 2
    frames = [stream.feed(audio[i:i + half], WORDS if i == 0 else ())
              for i in range(0, len(audio), half)]
    np.testing.assert_allclose(np.concatenate(frames + [stream.flush()]), want_dv, atol=1e-4)
    fresh = tserve.SynthesisService.from_config(TCFG, tvocab, N_SPK, device="cpu",
                                                variant=variant)
    assert fresh.use_mfcc == use_mfcc
    assert type(fresh.gen.audio_encoder).__name__ == (
        "MFCCEncoder" if use_mfcc else "WavEncoder")


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * C.AUDIO_SR)
    t = np.arange(n) / C.AUDIO_SR
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)


@pytest.mark.parametrize("z_type", ["random", "none"])
def test_synthesis_with_a_random_or_no_z(z_type):
    """The serving paths build (S, B, 16) noise whatever the generator's z:
    `synthesize_clip_fused` of a random-z generator takes window i's noise
    as its z, as JAX's program draws it from the window's key, and a
    generator without a z ignores it; both against JAX's
    `synthesize_clip_fused` (1e-4), and `synthesize_clips_batched` of two
    clips against each clip alone."""
    kw = dict(z_type=z_type)
    jgen = jgen_mod.PoseGenerator(**GEN_KW, **kw)
    _, _, args = _inputs(5, "mfcc_features")
    jv = _jax_variables(jgen, args, 17)
    tgen = _port_generator(jv, **kw).eval()
    jvocab, tvocab = _vocabs()
    audio, other = _audio(10.0), _audio(4.0, seed=1)
    fn = jsyn.make_fused_clip_fn(jgen.apply, JCFG)
    want, _ = jsyn.synthesize_clip_fused(fn, jv, audio, WORDS, jvocab, JCFG, vid_idx=2,
                                         rng=jax.random.key(6))
    if z_type == "random":
        eps = _replay_eps(jax.jit(jgen.apply), jv,
                          jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)),
                          jax.random.key(6), 2, 5)
    else:
        eps = torch.from_numpy(np.random.default_rng(6).standard_normal((5, 1, 16))
                               .astype(np.float32))
    got, _ = tsyn.synthesize_clip_fused(tgen, audio, WORDS, tvocab, TCFG, vid_idx=2, eps=eps)
    np.testing.assert_allclose(got, want, atol=1e-4)
    eps2 = torch.cat([eps, torch.from_numpy(np.random.default_rng(7).standard_normal(
        (5, 1, 16)).astype(np.float32))], dim=1)
    both = tsyn.synthesize_clips_batched(tgen, [(audio, WORDS, 2), (other, WORDS[:1], 0)],
                                         tvocab, TCFG, eps=eps2)
    alone = tsyn.synthesize_clip_fused(tgen, other, WORDS[:1], tvocab, TCFG, vid_idx=0,
                                       eps=eps2[:2, 1:])[0]
    np.testing.assert_allclose(both[0][0], got, atol=1e-4)
    np.testing.assert_allclose(both[1][0], alone, atol=1e-4)


def test_abl_audio_render_matches_jax(tmp_path, monkeypatch):
    """`generate_gestures_by_dataset` on an abl_audio trainer, per clip and
    batched: its generator renders raw audio windows (no MFCC computed),
    as JAX's renderer does for that variant; both generators' poses
    against JAX's with its noise (1e-4), batched against per clip."""
    videos = jdb.make_synthetic_videos(n_videos=2, clip_seconds=10.0)
    cfgs = (dataclasses.replace(JCFG, batch_size=8), dataclasses.replace(TCFG, batch_size=8))
    jds = jdb.build_dataset_from_videos(videos, cfgs[0], keep_sidecars=True)
    tds = tdb.build_dataset_from_videos(videos, cfgs[1], keep_sidecars=True)
    n_words, n_spk = jds.lang_model.n_words, jds.speaker_model.n_words
    kw = dict(GEN_KW, n_words=n_words, n_speakers=n_spk)
    jgen = jgen_mod.PoseGenerator(**kw, audio_encoder_type="wav")
    jtri = jgen_mod.PoseGeneratorTriModal(**{k: v for k, v in kw.items()
                                             if k != "emb_dropout"})
    wav = jnp.zeros((1, JCFG.expected_audio_length))
    args = (jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1)), jnp.zeros((1, C.N_POSES), jnp.int32),
            wav, jnp.zeros((1,), jnp.int32))
    gv, tv = _jax_variables(jgen, args, 13), _jax_variables(jtri, args, 14)
    jtrainer = types.SimpleNamespace(
        cfg=cfgs[0], gen=jgen, tri=jtri, test_data=jds, variant="abl_audio",
        logger=types.SimpleNamespace(print_log=lambda msg: None),
        state=types.SimpleNamespace(gen_params=gv["params"], gen_stats=gv["batch_stats"],
                                    tri_params=tv["params"], tri_stats=tv["batch_stats"]))
    ttrainer = TTrainer(cfgs[1], str(tmp_path), test_data=tds, device="cpu",
                        variant="abl_audio")
    from_jax.load_jax(ttrainer.gen, from_jax.pose_generator, gv)
    from_jax.load_jax(ttrainer.tri, from_jax.pose_generator_trimodal, tv)
    applies = (jax.jit(jgen.apply), jax.jit(jtri.apply))

    def noise(seed, n_windows, z_size=16):
        keys = jax.random.split(jax.random.key(seed))
        return tuple(_replay_eps(applies[i], (gv, tv)[i], wav, keys[i], 0, n_windows)
                     for i in range(2))

    kwargs = dict(data_params={"clip_duration_range": [1, 30]}, randomized=True, seed=5)
    want = jce.generate_gestures_by_dataset(jtrainer, "ted_db", **kwargs)
    monkeypatch.setattr(tce, "clip_noise", noise)
    monkeypatch.setattr(tsyn, "window_features", _no_mfcc)
    per_clip = tce.generate_gestures_by_dataset(ttrainer, "ted_db", **kwargs)
    batched = tce.generate_gestures_by_dataset(ttrainer, "ted_db", batched=True, **kwargs)
    assert [v for v, _ in per_clip] == [v for v, _ in batched] == [v for v, _ in want] == [
        "synthetic_vid_0", "synthetic_vid_1"]
    for (_, p), (_, b), (_, w) in zip(per_clip, batched, want):
        np.testing.assert_array_equal(p[0], w[0])
        for got, batch, ref in zip(p[1:], b[1:], w[1:]):
            np.testing.assert_allclose(got, ref, atol=1e-4)
            np.testing.assert_allclose(batch, got, atol=1e-4)
