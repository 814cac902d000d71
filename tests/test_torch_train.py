"""The port's training slice on the CPU against the JAX package: the models
in train mode, the losses, two GAN steps, the synthetic corpus and the
`main_v2` CLI.

Small widths (hidden 16, one generator GRU layer, word embedding 16, 30
words, 5 speakers, batch 4), every dropout at zero and the speaker noise
at zero (JAX's `re_parametrize` patched to z = mu, the port given eps =
eps_rand = 0), so both sides are deterministic. The JAX side runs its CPU default GRU
engine (lax.scan), the reference the Pallas kernel is tested against, and
its models are initialized with a jitted init. JAX's TriModal generator
fixes its text encoder's embedding dropout at 0.1; the test builds it with
0.0 through its module-level TextEncoderTCN name.

Tolerances, all float32 with sums in another order:
- single forwards in train mode: 5e-5 absolute (outputs of order 1; the
  serving tests' tolerance for the whole generator: normalizing by the statistics of
  a batch of 4 amplifies float32 differences); BN running stats within
  1e-4 of their own magnitude plus 1e-4 of each tensor's largest value:
  the per-node batch norm after the first ST-GCN normalizes by small
  batch deviations, where JAX's float32 result lies 2e-5 (relative to the
  largest value) from a float64 run of the port and the port's 1e-6 with
  any number of torch threads (1, 2 or 8; before the AffEncoder's input
  was made contiguous, 1.6e-4 with one thread);
- GAN step 1: metrics within 1e-4 relative (plus 1e-6 absolute for the
  near-zero differential metric), the generator's BN stats as above; the
  discriminator's BN stats as step 2's metrics, because its last forward
  of the step runs after its update; both Adam states within 5e-4 of each
  tensor's largest value, for the AffEncoders' ST-GCN gradients, which
  batch norms over a batch of 4 make sensitive to rounding (see
  `test_two_gan_steps_match_jax`), with the port's float32 step held to
  its float64 step within 1e-4 (first moments) beside it;
- GAN step 2: metrics within 1e-3 relative. The first Adam step is about
  lr * sign(g), so a gradient at float-noise level can move a parameter by
  up to lr before step 2;
- the corpus: ids and poses exact, int16 audio within 1, MFCC within
  float16 rounding plus 2e-4 (log10 and DCT in float32).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.models.discriminator import AffDiscriminator as TDis
from speech2affective_gestures_torch.models.encoders import WavEncoder as TWav
from speech2affective_gestures_torch.models.generator import (
    PoseGenerator as TGen, PoseGeneratorTriModal as TTri)
from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train import losses as tlosses
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data import ted_db as jdb
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.models.discriminator import AffDiscriminator as JDis
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import gan_step as jstep
from speech2affective_gestures_tpu.train import losses as jlosses

N_WORDS, N_SPK, B, HID, EMB = 30, 5, 4, 16, 16
GEN_KW = dict(n_words=N_WORDS, word_embed_size=EMB, hidden_size=HID, n_layers=1,
              dropout_prob=0.0, n_speakers=N_SPK)
DIV_IDS = np.array([2, 0, 3, 1])


@pytest.fixture(scope="module", autouse=True)
def deterministic_jax():
    """z = mu, and the TriModal's embedding dropout at 0, on the JAX side."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    yield
    mp.undo()


def _batch(seed):
    cfg = JConfig()
    b = jbuilder.synthetic_batch(np.random.default_rng(seed), B, cfg, N_WORDS, N_SPK)
    b["vid_indices"] = np.array([0, 1, 2, 3], np.int32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in b.items()}


def _init_jax_models():
    """JAX modules and variables, initialized with a jitted init."""
    b = _batch(0)
    pre = np.asarray(jstep.build_pre_seq(jnp.asarray(b["vec_seq"]), C.N_PRE_POSES))
    text, vids = jnp.asarray(b["extended_word_seq"]), jnp.asarray(b["vid_indices"])
    gen = jgen_mod.PoseGenerator(emb_dropout=0.0, **GEN_KW)
    dis = JDis(hidden_size=HID, dropout_prob=0.0)
    tri = jgen_mod.PoseGeneratorTriModal(**GEN_KW)
    keys = jax.random.split(jax.random.key(0), 4)
    rngs = lambda k: {"params": k, "noise": keys[3]}  # noqa: E731
    gv = jax.jit(gen.init)(rngs(keys[0]), pre, text, jnp.asarray(b["mfcc_features"]), vids)
    dv = jax.jit(dis.init)(keys[1], jnp.asarray(b["vec_seq"]))
    tv = jax.jit(tri.init)(rngs(keys[2]), pre, text, jnp.asarray(b["audio"]), vids)
    return dict(gen=gen, dis=dis, tri=tri, gen_vars=jax.device_get(gv),
                dis_vars=jax.device_get(dv), tri_vars=jax.device_get(tv))


@pytest.fixture(scope="module")
def jax_models():
    return _init_jax_models()


def _port_models(jm):
    gen = TGen(emb_dropout=0.0, **GEN_KW)
    dis = TDis(hidden_size=HID, dropout_prob=0.0)
    tri = TTri(emb_dropout=0.0, **GEN_KW).requires_grad_(False)
    from_jax.load_jax(gen, from_jax.pose_generator, jm["gen_vars"])
    from_jax.load_jax(dis, from_jax.aff_discriminator, jm["dis_vars"])
    from_jax.load_jax(tri, from_jax.pose_generator_trimodal, jm["tri_vars"])
    return gen, dis, tri


def _assert_close_scaled(got, want, tol, name):
    """Each value within `tol` of its own magnitude plus `tol` of the
    tensor's largest."""
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol * np.abs(want).max(), err_msg=name)


def _assert_stats(model, mapper, jax_vars, tol):
    """The model's BN running stats against the JAX variables' batch_stats."""
    want = mapper(jax_vars)
    state = model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        _assert_close_scaled(state[k].numpy(), want[k], tol, k)


# --------------------------------------------------------------- modules

def _train_apply(model, variables, *args):
    out, mut = jax.jit(functools.partial(model.apply, train=True,
                                         mutable=["batch_stats"]))(
        variables, *args, rngs={"noise": jax.random.key(1), "dropout": jax.random.key(2)})
    return jax.device_get(out), dict(variables, batch_stats=jax.device_get(mut["batch_stats"]))


@pytest.mark.parametrize("which", ["gen", "tri", "dis"])
def test_models_in_train_mode_match_jax(jax_models, which):
    """Outputs with batch statistics, and the running stats they update
    (the AffEncoder's per-node batch norms among them)."""
    gen, dis, tri = _port_models(jax_models)
    b = _batch(1)
    tb = _torch_batch(b)
    pre = build = tstep.build_pre_seq(tb["vec_seq"], C.N_PRE_POSES)
    eps = torch.zeros(B, 16)
    if which == "dis":
        want, new_vars = _train_apply(jax_models["dis"], jax_models["dis_vars"],
                                      jnp.asarray(b["vec_seq"]))
        got = dis.train()(tb["vec_seq"])
        model, mapper = dis, from_jax.aff_discriminator
    else:
        audio_key = "mfcc_features" if which == "gen" else "audio"
        model = gen if which == "gen" else tri
        mapper = from_jax.pose_generator if which == "gen" else from_jax.pose_generator_trimodal
        (want, *_), new_vars = _train_apply(
            jax_models[which], jax_models[f"{which}_vars"], jnp.asarray(pre.numpy()),
            jnp.asarray(b["extended_word_seq"]), jnp.asarray(b[audio_key]),
            jnp.asarray(b["vid_indices"]))
        got = model.train()(build, tb["extended_word_seq"], tb[audio_key],
                            tb["vid_indices"], eps)[0]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5)
    _assert_stats(model, mapper, new_vars, 1e-4)


def test_aff_encoder_batch_stats_do_not_depend_on_threads(jax_models):
    """The generator's train-mode forward with 1 and with 4 torch threads:
    the AffEncoder's per-node BN running mean within 1e-5 of its largest
    value (1.6e-4 apart when the first ST-GCN block took a channels-last
    input, whose batch-norm sums follow the thread count)."""
    threads = torch.get_num_threads()
    b = _torch_batch(_batch(1))
    pre = tstep.build_pre_seq(b["vec_seq"], C.N_PRE_POSES)
    means = []
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            gen = _port_models(jax_models)[0].train()
            gen(pre, b["extended_word_seq"], b["mfcc_features"], b["vid_indices"],
                torch.zeros(B, 16))
            means.append(gen.aff_encoder.batch_norm1.running_mean.clone())
    finally:
        torch.set_num_threads(threads)
    assert ((means[0] - means[1]).abs().max() / means[1].abs().max()).item() <= 1e-5


def test_wav_encoder_in_train_mode_matches_jax():
    wav = (np.random.default_rng(3).standard_normal((3, C.EXPECTED_AUDIO_LENGTH))
           * 0.1).astype(np.float32)
    jw = jenc.WavEncoder()
    variables = jax.device_get(jax.jit(jw.init)(jax.random.key(0), jnp.asarray(wav)))
    want, mut = jax.jit(functools.partial(jw.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(wav))
    tw = TWav()
    tw.load_state_dict(from_jax.to_state_dict(
        from_jax.wav_encoder(variables["params"], variables["batch_stats"], "")), strict=True)
    got = tw.train()(torch.from_numpy(wav))
    assert got.shape == (3, C.N_POSES, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5)
    want_stats = from_jax.wav_encoder(variables["params"],
                                      jax.device_get(mut["batch_stats"]), "")
    for k, v in tw.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _assert_close_scaled(v.numpy(), want_stats[k], 1e-4, k)


def test_bridges_load_strict_with_reference_keys(jax_models):
    from speech2affective_gestures_tpu.convert import jax_to_torch

    gen, dis, tri = _port_models(jax_models)
    assert set(gen.state_dict()) == set(jax_to_torch.pose_generator_inv(jax_models["gen_vars"], 1))
    assert set(dis.state_dict()) == set(jax_to_torch.aff_discriminator_inv(jax_models["dis_vars"]))
    assert set(tri.state_dict()) == set(
        jax_to_torch.pose_generator_trimodal_inv(jax_models["tri_vars"], 1))


# ---------------------------------------------------------------- losses

def test_losses_match_jax():
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal((3, 34, 27)).astype(np.float32) * 0.2 for _ in range(2))
    z, zr = (rng.standard_normal((3, 16)).astype(np.float32) for _ in range(2))
    d = rng.uniform(0.05, 0.95, (3, 1)).astype(np.float32)
    mu, lv = (rng.standard_normal((3, 16)).astype(np.float32) * 0.3 for _ in range(2))
    t = torch.from_numpy
    pairs = [
        (tlosses.smooth_l1(t(x) * 9, t(y) * 9), jlosses.smooth_l1(x * 9, y * 9)),
        (tlosses.scaled_huber(t(x), t(y), 0.1), jlosses.scaled_huber(x, y, 0.1)),
        (tlosses.dis_ns_gan(t(d), t(d[::-1].copy())), jlosses.dis_ns_gan(d, d[::-1])),
        (tlosses.gen_ns_gan(t(d)), jlosses.gen_ns_gan(d)),
        (tlosses.kld_speaker(t(mu), t(lv)), jlosses.kld_speaker(mu, lv)),
        (tlosses.diversity_regularizer(t(x), t(y), t(z), t(zr)),
         jlosses.diversity_regularizer(x, y, z, zr)),
        (tlosses.l1(t(x), t(y)), jlosses.l1(x, y)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    meter = tlosses.AverageMeter("loss")
    for v in (1.0, 2.0, 6.0):
        meter.update(v)
    assert meter.avg == 3.0 and str(meter).startswith("loss 6.")


def test_diversity_regularizer_gradient_only_through_out():
    x = torch.randn(2, 34, 27, requires_grad=True)
    others = [torch.randn(2, 34, 27, requires_grad=True),
              torch.randn(2, 16, requires_grad=True), torch.randn(2, 16, requires_grad=True)]
    tlosses.diversity_regularizer(x, *others).backward()
    assert x.grad is not None and all(o.grad is None for o in others)


# -------------------------------------------------------------- GAN steps

def _moment_errors(got, want):
    """Adam's first and second moments, `got` against `want` (each
    {parameter name: (m, v)}): for each, the largest difference over the
    tensor's own largest value, and the tensor where it is. The biases that
    feed a BatchNorm in train mode have a zero gradient up to float noise
    (the batch mean removes them): a tensor whose moments are all below
    1e-4 of the model's largest is measured against that largest instead."""
    names = [n for n in want if n in got]   # the bridge's aliases left out
    assert len(names) == min(len(got), len(want))
    worst = []
    for i, key in enumerate(("exp_avg", "exp_avg_sq")):
        top = max(np.abs(want[n][i]).max() for n in names)
        errs = []
        for name in names:
            w = np.asarray(want[name][i], np.float64)
            g = np.asarray(got[name][i], np.float64).reshape(w.shape)
            scale = np.abs(w).max()
            errs.append((np.abs(g - w).max() / (scale if scale >= 1e-4 * top else top),
                         f"{name} {key}"))
        worst.append(max(errs))
    return worst


def _adam_state(opt_state):
    """The ScaleByAdamState of an optax state: the chain's first, or the
    first after the clipping's."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for s in opt_state:
        if isinstance(s, tuple) and (found := _adam_state(s)) is not None:
            return found
    return None


def _optax_moments(opt_state, mapper, variables):
    adam = _adam_state(opt_state)
    m, v = (mapper({"params": jax.device_get(s), "batch_stats": variables["batch_stats"]})
            for s in (adam.mu, adam.nu))
    return {k: (m[k], v[k]) for k in m}


def _torch_moments(opt, model):
    return {n: tuple(opt.state[p][k].double().numpy() for k in ("exp_avg", "exp_avg_sq"))
            for n, p in model.named_parameters()}


def _port_step(jm, b, dtype=torch.float32):
    """The port's `GanStep` from the JAX weights and one step on batch `b`
    in `dtype`: (metrics, step)."""
    gen, dis, tri = (m.to(dtype) for m in _port_models(jm))
    step = tstep.GanStep(gen, dis, tstep.GanConfig(loss_warmup=-1, n_speakers=N_SPK), tri)
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _torch_batch(b).items()}
    zeros = torch.zeros(B, 16, dtype=dtype)
    got = step.train_step(tb, torch.Generator().manual_seed(0), gan_on=True,
                          eps=zeros, eps_rand=zeros)
    return {k: float(v) for k, v in got.items()}, step


def _gan_steps(jm, seeds, **options):
    """Runs JAX's `make_train_step` (scan engine) and the port's `GanStep`
    side by side from the same weights and `GanConfig` options, on one
    batch per seed; yields, after each step, (step index, JAX metrics, port
    metrics, JAX state, port step)."""
    cfg = jstep.GanConfig(loss_warmup=-1, n_speakers=N_SPK, **options)
    train_step, _ = jstep.make_train_step(jm["gen"].apply, jm["dis"].apply, cfg,
                                          jm["tri"].apply)
    state = jstep.create_train_state(jm["gen_vars"], jm["dis_vars"], cfg, jm["tri_vars"])
    gen, dis, tri = _port_models(jm)
    step = tstep.GanStep(gen, dis, tstep.GanConfig(loss_warmup=-1, n_speakers=N_SPK,
                                                   **options), tri)
    g = torch.Generator().manual_seed(0)
    eps = torch.zeros(B, 16)
    for i, seed in enumerate(seeds):
        b = _batch(seed)
        state, want = train_step(state, jax.device_put(b), jax.random.key(i), gan_on=True)
        want = {k: float(v) for k, v in jax.device_get(want).items()}
        got = step.train_step(_torch_batch(b), g, gan_on=True, eps=eps, eps_rand=eps)
        yield i, want, {k: float(v) for k, v in got.items()}, jax.device_get(state), step


@pytest.fixture()
def same_other_speakers(monkeypatch):
    """The diversity regularizer's second-pass speaker ids, on both sides."""
    monkeypatch.setattr(jstep, "draw_other_speaker_ids",
                        lambda key, vids, n: jnp.asarray(DIV_IDS, vids.dtype))
    monkeypatch.setattr(tstep, "draw_other_speaker_ids",
                        lambda g, vids, n: torch.as_tensor(DIV_IDS, device=vids.device))


def _vars(st, who):
    return {"params": getattr(st, f"{who}_params"), "batch_stats": getattr(st, f"{who}_stats")}


# Batches of the two steps. At step 1's, both float32 steps' first moments
# lie within 1.5e-4 of the port's float64 step; at seed 10, JAX's compiled
# step lies 5.4e-2 away and the port's 5e-5 (see
# `test_two_gan_steps_match_jax`).
STEP_SEEDS = (11, 12)
MOMENT_TOL = 5e-4


def test_two_gan_steps_match_jax(jax_models, same_other_speakers):
    """Metrics of both steps; after step 1 the BN stats and both Adam
    states (the generator's and the discriminator's, first and second
    moments, the GAN terms on) against those of JAX's compiled
    `make_train_step`.

    The moments are held within MOMENT_TOL of each tensor's largest value,
    not 1e-4. The gradients of the AffEncoders' ST-GCN weights (in the
    generator and in the discriminator) flow back through batch norms over
    a batch of 4, which amplify float32 rounding: at this batch JAX's
    compiled first moments lie within 1.5e-4 of a float64 run of the port
    and the port's float32 ones within 4e-5
    (`test_gan_step_float32_matches_float64`); the port lies within 1.8e-4
    (first moments) and 2.3e-4 (second) of JAX's. Each ST-GCN block ends
    in a leaky ReLU (slope 1 or 0.01), and at other batches one of its
    pre-activations lies within float32 rounding of zero: two runs then
    take different slopes there, and that one element's gradient moves
    the ST-GCN weights' by up to 2e-1 of the largest (at batch seed 13 the
    port's float32 step does so against its float64 step, at a
    pre-activation of 9.9e-6). PERF.md, open questions, has the readings."""
    for i, want, got, st, step in _gan_steps(jax_models, STEP_SEEDS):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=(1e-4, 1e-3)[i], atol=1e-6,
                                       err_msg=k)
        if i == 0:
            _assert_stats(step.gen, from_jax.pose_generator, _vars(st, "gen"), 1e-4)
            # the discriminator's third forward of the step (on G's output)
            # runs on weights after its first Adam step: as step 2, 1e-3
            _assert_stats(step.dis, from_jax.aff_discriminator, _vars(st, "dis"), 1e-3)
            for who, mapper in (("gen", from_jax.pose_generator),
                                ("dis", from_jax.aff_discriminator)):
                errs = _moment_errors(
                    _torch_moments(getattr(step, f"{who}_opt"), getattr(step, who)),
                    _optax_moments(getattr(st, f"{who}_opt"), mapper, _vars(st, who)))
                assert all(e <= MOMENT_TOL for e, _ in errs), (who, errs)
    # the frozen comparator ran in train mode and kept its running stats
    loaded = from_jax.pose_generator_trimodal(jax_models["tri_vars"])
    for k, v in step.tri.state_dict().items():
        assert np.array_equal(v.numpy(), np.asarray(loaded[k]).reshape(v.shape)), k
    assert sum(gru_cuda.launches.values()) == 0  # CPU tensors: plain versions only


def test_gan_step_float32_matches_float64(jax_models, same_other_speakers):
    """The port's step 1 in float32 against the same step in float64, the
    witness for `test_two_gan_steps_match_jax`: metrics within 1e-4
    relative; both Adam states' first moments (0.5 g) within 1e-4 of each
    tensor's largest value, their second moments (0.001 g^2, whose
    relative error is twice g's) within 2e-4."""
    b = _batch(STEP_SEEDS[0])
    want, ref = _port_step(jax_models, b, torch.float64)
    got, step = _port_step(jax_models, b)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for who in ("gen", "dis"):
        errs = _moment_errors(_torch_moments(getattr(step, f"{who}_opt"), getattr(step, who)),
                              _torch_moments(getattr(ref, f"{who}_opt"), getattr(ref, who)))
        assert errs[0][0] <= 1e-4 and errs[1][0] <= 2e-4, (who, errs)


@pytest.mark.parametrize("clip", [0.1, 1e4], ids=["clipped", "unclipped"])
def test_clipped_gan_step_matches_jax(jax_models, same_other_speakers, clip):
    """One GAN step with global-norm gradient clipping against JAX's
    (optax's `clip_by_global_norm` before Adam, each net's gradients over
    its own tree): at 0.1 both nets' gradients are clipped (the port's
    norms are printed in the message), at 1e4 neither; the metrics within
    1e-4 relative and both Adam states within MOMENT_TOL, as step 1 of
    `test_two_gan_steps_match_jax`."""
    for _, want, got, st, step in _gan_steps(jax_models, STEP_SEEDS[:1], gradient_clip=clip):
        norms = {k: float(v) for k, v in step.grad_norms.items()}
        assert set(norms) == {"gen", "dis"}
        assert all((n > clip) == (clip < 1) for n in norms.values()), norms
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        for who, mapper in (("gen", from_jax.pose_generator),
                            ("dis", from_jax.aff_discriminator)):
            errs = _moment_errors(
                _torch_moments(getattr(step, f"{who}_opt"), getattr(step, who)),
                _optax_moments(getattr(st, f"{who}_opt"), mapper, _vars(st, who)))
            assert all(e <= MOMENT_TOL for e, _ in errs), (who, errs, norms)


def test_clip_by_global_norm_is_optax():
    """The clipping function on its own against optax's: a norm above the
    limit scales every gradient by limit / norm, one below leaves them."""
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for limit in (0.5, 100.0):
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = tstep.clip_by_global_norm_(params, limit)
        want, _ = optax.clip_by_global_norm(limit).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def _trainer_record(trainer) -> list:
    """Wrap both optimizers' step to record (net, update count, lr) of
    every update."""
    log = []
    for who in ("gen", "dis"):
        opt = getattr(trainer.step, f"{who}_opt")

        def step(*args, _opt=opt, _orig=opt.step, _who=who, **kwargs):
            log.append((_who, tstep.update_count(_opt), _opt.param_groups[0]["lr"]))
            return _orig(*args, **kwargs)

        opt.step = step
    return log


def test_lr_decay_matches_jax_schedule(tmp_path):
    """The learning rates of G and D over three epochs, the first two
    without the GAN terms (so D updates only in the third), against JAX's
    `_lr_schedule` at each optimizer's own update count, exactly; then
    again after a reload from the epoch-1 checkpoint (the counts come back
    from Adam's state) over epochs 1 and 2. Decay 0.5 per epoch of
    16 // 4 = 4 updates."""
    from speech2affective_gestures_torch.train.trainer import Trainer

    cfg = TConfig.from_yaml("config/multimodal_context_v2.yml", hidden_size=HID,
                            hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB,
                            batch_size=4, loss_warmup=1)
    data = tdb.build_dataset_from_videos(tdb.make_synthetic_videos(2, 8.0), cfg)
    assert data.n_samples == 16
    kw = dict(train_data=data, device="cpu", save_interval=1, lr_decay=0.5,
              trimodal_metric_interval=1000, log_interval=1000)
    trainer = Trainer(cfg, str(tmp_path), seed=5, **kw)
    jcfg = jstep.GanConfig(learning_rate=cfg.learning_rate, lr_decay=0.5,
                           decay_steps_per_epoch=4)
    assert trainer.gan_cfg.decay_steps_per_epoch == 4
    schedules = {"gen": jstep._lr_schedule(jcfg.learning_rate, jcfg),
                 "dis": jstep._lr_schedule(jcfg.lr_dis, jcfg)}
    log = _trainer_record(trainer)
    trainer.train(epochs=3)
    assert [n for who, n, _ in log if who == "gen"] == list(range(12))
    assert [n for who, n, _ in log if who == "dis"] == list(range(4))
    for who, n, lr in log:
        assert lr == schedules[who](n), (who, n, lr)

    again = Trainer(cfg, str(tmp_path), seed=5, **kw)
    assert again.load_checkpoint(1)
    assert [tstep.update_count(o) for o in (again.step.gen_opt, again.step.dis_opt)] == [8, 0]
    log = _trainer_record(again)
    again.train(epochs=3)
    # the trainer resumes at the checkpoint's epoch: epoch 1 again, then 2
    assert [n for who, n, _ in log if who == "gen"] == list(range(8, 16))
    assert [n for who, n, _ in log if who == "dis"] == list(range(4))
    for who, n, lr in log:
        assert lr == schedules[who](n), (who, n, lr)
    for who, opt in (("gen", again.step.gen_opt), ("dis", again.step.dis_opt)):
        assert opt.param_groups[0]["lr"] == schedules[who](tstep.update_count(opt))
        # update_count reads one parameter's state: every state holds the same step
        assert {int(s["step"]) for s in opt.state.values()} == {tstep.update_count(opt)}


def test_other_speaker_draws():
    g = torch.Generator().manual_seed(1)
    vids = torch.tensor([0, 1, 2, 3, 4, 4])
    fresh = tstep.draw_other_speaker_ids(g, vids, 5)
    assert bool((fresh != vids).all()) and bool(((fresh >= 0) & (fresh < 5)).all())
    perm = tstep.draw_other_speaker_ids(g, vids, 0)
    assert sorted(perm.tolist()) == sorted(vids.tolist())


# ----------------------------------------------------------------- corpus

def test_synthetic_corpus_matches_jax():
    tcfg = TConfig.from_yaml("config/multimodal_context_v2.yml")
    jcfg = JConfig.from_yaml("config/multimodal_context_v2.yml")
    got = tdb.build_dataset_from_videos(tdb.make_synthetic_videos(2, 4.0), tcfg)
    want = jdb.build_dataset_from_videos(jdb.make_synthetic_videos(2, 4.0), jcfg)
    assert got.n_samples == want.n_samples > 0
    for k in ("extended_word_seq", "vec_seq", "vid_indices"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert np.abs(got.audio.astype(np.int32) - want.audio.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(got.audio_max, want.audio_max, rtol=1e-6)
    w = want.mfcc_features.astype(np.float32)
    np.testing.assert_allclose(got.mfcc_features.astype(np.float32), w,
                               atol=2e-4, rtol=2 ** -10)
    assert got.speaker_model.word2index == want.speaker_model.word2index
    assert got.lang_model.word2index == want.lang_model.word2index
    np.testing.assert_array_equal(got.lang_model.word_embedding_weights,
                                  want.lang_model.word_embedding_weights)


def test_batch_sampler_matches_jax():
    """Same seed, same rows and adversarial speakers as the JAX sampler."""
    cfg = TConfig.from_yaml("config/multimodal_context_v2.yml")
    ds = tdb.build_dataset_from_videos(tdb.make_synthetic_videos(2, 4.0), cfg)
    jds = jdb.PackedDataset(**{k: getattr(ds, k) for k in (
        "extended_word_seq", "vec_seq", "audio", "audio_max", "mfcc_features",
        "vid_indices")}, speaker_model=ds.speaker_model)
    for got, want in zip(tdb.BatchSampler(ds, 3, seed=7), jdb.BatchSampler(jds, 3, seed=7)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------------- CLI

def test_main_v2_trains_on_cpu_and_writes_a_checkpoint(tmp_path):
    import yaml

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1,
               wordembed_dim=EMB, random_seed=3)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    argv = ["-b", str(tmp_path / "base"), "-c", str(cfg_path), "--synthetic-data",
            "true", "--device", "cpu", "--batch-size", "4", "--s2ag-num-epoch", "2",
            "--synthetic-videos", "2", "--synthetic-seconds", "4", "--log-interval", "1"]
    trainer = tmain.main(argv)
    log = (tmp_path / "base/models/s2ag_v2_mfcc_torch/ted_db/log.txt").read_text()
    # epoch 0 runs without the GAN terms (gan_on = epoch > loss_warmup = 0)
    iters = [line for line in log.splitlines() if "Iter 0 Done" in line]
    assert len(iters) == 2 and "dis:" not in iters[0] and "dis:" in iters[1]
    values = [float(tok.split(": ")[1]) for line in iters
              for tok in line.split("Done. | ")[1].split(" | ")]
    assert np.isfinite(values).all()
    ckpts = sorted((tmp_path / "base/models/s2ag_v2_mfcc_torch/ted_db").glob("*.pth.tar"))
    assert [c.name.startswith("epoch_000000_loss_") for c in ckpts] == [True]
    blob = torch.load(ckpts[0], weights_only=True)
    fresh = TGen(n_words=trainer.train_data.lang_model.n_words, word_embed_size=EMB,
                 hidden_size=HID, n_layers=1,
                 n_speakers=trainer.train_data.speaker_model.n_words)
    fresh.load_state_dict(from_jax.strip_module_prefix(blob["gen_model_dict"]), strict=True)
    assert {"gen_optimizer_dict", "dis_optimizer_dict"} <= set(blob)
    # a second run resumes from it
    again = tmain.main(argv + ["--train-s2ag", "false"])
    assert again.epoch == 0 and np.isfinite(again.best_loss)


@pytest.mark.parametrize("flag", [["--steps-per-program", "2"], ["--loader", "grain"]])
def test_main_v2_rejects_unported_options(tmp_path, flag):
    """The two options main_v2 once refused, both ported now, train
    (hidden 16, batch 4, the smallest corpus, every loss finite):
    `--steps-per-program 2` runs one step, a partial program, its log
    naming the scanned engine (tests/test_torch_scanned_epoch.py runs
    whole ones); `--loader grain` runs its epoch of max(1, n // B) steps one at
    a time, its log naming the loader and the per-step engine, and writes
    the checkpoint's data-state file with the stream's position
    (tests/test_torch_grain_loader.py resumes from it)."""
    import yaml

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB,
               random_seed=3, loss_warmup=-1)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    trainer = tmain.main(["-b", str(tmp_path / "base"), "-c", str(cfg_path),
                          "--synthetic-data", "true", "--device", "cpu", "--batch-size", "4",
                          "--s2ag-num-epoch", "1", "--synthetic-videos", "2",
                          "--synthetic-seconds", "4", "--log-interval", "1"] + flag)
    work = tmp_path / "base/models/s2ag_v2_mfcc_torch/ted_db"
    log = (work / "log.txt").read_text()
    iters = [line.split("Done. | ")[1] for line in log.splitlines() if "Done. | " in line]
    values = [float(tok.split(": ")[1]) for it in iters for tok in it.split(" | ")]
    assert np.isfinite(values).all()
    if flag[0] == "--loader":
        n_steps = max(1, trainer.train_data.n_samples // 4)
        assert trainer.epoch_engine == "per_step" and trainer.loader == "grain"
        assert "epoch engine: per_step (1 train steps a program, loader grain)" in log
        [epoch] = [line for line in log.splitlines() if "epoch 0 train:" in line]
        assert epoch.endswith(f"{n_steps} iters, engine per_step)") and len(iters) == n_steps
        [state] = work.glob("epoch_000000_loss_*_model_datastate.json")
        assert json.loads(state.read_text())["grain"] == {"next_batch": n_steps, "seed": 3}
        return
    assert trainer.epoch_engine == "scanned" and trainer.steps_per_program == 2
    assert "epoch engine: scanned (2 train steps a program" in log
    [epoch] = [line for line in log.splitlines() if "epoch 0 train:" in line]
    assert epoch.endswith("engine scanned)")
    assert len(iters) == 1


@pytest.mark.parametrize("route", ["archive", "lmdb"])
def test_main_v2_trains_on_the_ted_formats(tmp_path, route):
    """`main_v2` on the CPU from a raw-level export archive (`--packed-data`)
    and from the TED LMDB layout under `<base>/../data/ted_db`, with
    gradient clipping and LR decay on: the corpus is packed into the port's
    caches, every loss is finite, a checkpoint is written, the test split
    scored; a second run without training reads the caches."""
    import gzip
    import json
    import pickle

    import yaml
    from speech2affective_gestures_tpu.data import legacy_arrow as jla
    from speech2affective_gestures_tpu.data import lmdb_lite as jlmdb

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB,
               random_seed=3, loss_warmup=-1)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    videos = jdb.make_synthetic_videos(4, 6.0)
    splits = {"train": videos[:2], "val": videos[2:3], "test": videos[3:]}
    base = tmp_path / "run" / "base"
    argv = ["-b", str(base), "-c", str(cfg_path), "--device", "cpu", "--batch-size", "4",
            "--s2ag-num-epoch", "1", "--log-interval", "1", "--apply-gradient-clip",
            "true", "--apply-lr-decay", "true"]
    if route == "archive":
        cache_dir = tmp_path / "arch"
        cache_dir.mkdir()
        manifest = {"level": "raw", "num_mfcc": 14, "splits": {}}
        for split, vids in splits.items():
            with gzip.open(cache_dir / f"{split}_0000.pkl.gz", "wb") as f:
                pickle.dump(vids, f, protocol=4)
            manifest["splits"][split] = {"shards": 1, "records": len(vids)}
        (cache_dir / "manifest.json").write_text(json.dumps(manifest))
        argv += ["--packed-data", str(cache_dir)]
    else:
        data = tmp_path / "run" / "data" / "ted_db"
        for split, vids in splits.items():
            jlmdb.write_env(str(data / getattr(TConfig(), f"{split}_data_path")),
                            [(f"{i:010}".encode(), jla.serialize_legacy(v))
                             for i, v in enumerate(vids)])
        cache_dir = data / "data" / "ted_db"
    trainer = tmain.main(argv)
    assert sorted(p.name for p in cache_dir.glob("*_s2ag_torch_packed_mfcc_14.npz")) == [
        "test_s2ag_torch_packed_mfcc_14.npz", "train_s2ag_torch_packed_mfcc_14.npz",
        "val_s2ag_torch_packed_mfcc_14.npz"]
    assert trainer.gan_cfg.gradient_clip == 0.1 and trainer.gan_cfg.lr_decay == 0.999
    work = base / "models/s2ag_v2_mfcc_torch/ted_db"
    log = (work / "log.txt").read_text()
    iters = [line for line in log.splitlines() if "Done. |" in line]
    assert iters and all("dis:" in line for line in iters)
    values = [float(tok.split(": ")[1]) for line in iters
              for tok in line.split("Done. | ")[1].split(" | ")]
    assert np.isfinite(values).all()
    assert "UNUSED" not in log and "eval: l1" in log
    assert len(list(work.glob("epoch_000000_loss_*_model.pth.tar"))) == 1
    again = tmain.main(argv + ["--train-s2ag", "false"])
    assert again.train_data is None and again.test_data.n_samples == trainer.test_data.n_samples
    np.testing.assert_array_equal(again.test_data.vec_seq, trainer.test_data.vec_seq)


def _readings(seeds):
    """For each batch seed, step 1's Adam first moments of JAX's compiled
    step and of the port's float32 step against the port's float64 step:
    the readings behind MOMENT_TOL and STEP_SEEDS."""
    jm = _init_jax_models()
    for seed in seeds:
        b = _batch(seed)
        ref = _port_step(jm, b, torch.float64)[1]
        port = _port_step(jm, b)[1]
        [(_, _, _, st, _)] = list(_gan_steps(jm, (seed,)))
        for who, mapper in (("gen", from_jax.pose_generator),
                            ("dis", from_jax.aff_discriminator)):
            want = _torch_moments(getattr(ref, f"{who}_opt"), getattr(ref, who))
            for name, got in (
                    ("JAX compiled", _optax_moments(getattr(st, f"{who}_opt"), mapper,
                                                    _vars(st, who))),
                    ("port float32", _torch_moments(getattr(port, f"{who}_opt"),
                                                    getattr(port, who)))):
                err, where = _moment_errors(got, want)[0]
                print(f"seed {seed} {who} {name} against float64: {err:.2e} at {where}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_train.py [seed ...] prints the
    # readings: the float32 step's, then the mixed-precision step's against
    # JAX's run through its Pallas kernels (tests/test_torch_bf16.py)
    import sys

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
        mp.setattr(jgen_mod, "TextEncoderTCN",
                   functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
        mp.setattr(jstep, "draw_other_speaker_ids",
                   lambda key, vids, n: jnp.asarray(DIV_IDS, vids.dtype))
        mp.setattr(tstep, "draw_other_speaker_ids",
                   lambda g, vids, n: torch.as_tensor(DIV_IDS, device=vids.device))
        seeds = [int(a) for a in sys.argv[1:]] or range(10, 20)
        _readings(seeds)
        mp.setenv("S2AG_GRU_ENGINE", "pallas")
        mp.setenv("S2AG_GRU_PALLAS_INTERPRET", "1")
        from test_torch_bf16 import bf16_readings

        bf16_readings(seeds)
