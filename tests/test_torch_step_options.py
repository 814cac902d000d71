"""The GAN step's two options that change how it calls its nets, on the
CPU: the fused double-batch pass (`GanConfig.fused_pass`, `--fused-pass`)
against the JAX package's fused step, and rematerialization
(`GanConfig.remat`, `--remat full|dots`) against the port's own plain
step.

The fused pass: the JAX steps and their sizes are
`tests/test_torch_train.py`'s and `tests/test_torch_ablations.py`'s
(hidden 16, one generator GRU layer, word embedding 16, 30 words, 5
speakers, batch 4, every dropout at zero, JAX's speaker z = mu, the
port's eps = eps_rand = 0, the div-reg speaker ids fixed on both sides);
the random z's noise is handed to JAX as there (`_HandedNoise`), its
fused forward taking one 2B draw, eps and eps_rand concatenated. The
tolerances are those files' step tolerances: metrics within 1e-4 relative
(plus 1e-6 absolute) at step 1 and 1e-3 at step 2; the generator's BN
stats within 1e-4 of their magnitude plus 1e-4 of each tensor's largest,
the discriminator's within 1e-3 (its last forward runs after its update).
Both nets' Adam moments are held to the port's own step in float64: the
port's float32 step within 1e-4 (first moments) and 2e-4 (second) of each
tensor's largest, JAX's within JAX_MOMENT_TOL (5e-2), since JAX's compiled
float32 step lies up to 3.9e-2 from it (`test_fused_step_matches_jax`).
The mixed-precision fused step is held to `tests/test_torch_bf16.py`'s
step tolerances, with JAX's GRU run through its Pallas kernels in
interpret mode as there.

Remat: at hidden 32, two GRU layers (so that the generator's and the
discriminator's between-layer dropout runs) and the config's dropout 0.3,
two steps with the noise drawn from the step's generator: `full` and
`dots` against `none`, bit for bit, in float32, float64, mixed precision,
with gradient clipping and with the fused pass.
"""

import copy
import dataclasses
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_ablations as ta
import test_torch_bf16 as tb
import test_torch_train as tt
from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch import main_v2_abl_aff
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.models import layers as tlayers
from speech2affective_gestures_torch.models.discriminator import (
    AffDiscriminator as TAffDis, ConvDiscriminator as TConvDis)
from speech2affective_gestures_torch.models.generator import PoseGeneratorTriModal as TTri
from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_torch.train import builder as tbuilder
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.models import discriminator as jdis_mod
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import gan_step as jstep

N_WORDS, N_SPK, B = tt.N_WORDS, tt.N_SPK, tt.B
REMAT_CFG = TConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2, wordembed_dim=16,
                    loss_warmup=-1)


@pytest.fixture(scope="module", autouse=True)
def deterministic_jax():
    """One torch thread (as `tests/test_torch_ablations.py`); on the JAX
    side z = mu, every dropout at zero, the discriminators at hidden 16
    where `init_training` builds them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    mp.setattr(jbuilder, "PoseGenerator",
               functools.partial(jgen_mod.PoseGenerator, emb_dropout=0.0))
    for name in ("AffDiscriminator", "ConvDiscriminator"):
        mp.setattr(jbuilder, name, functools.partial(getattr(jdis_mod, name),
                                                     hidden_size=ta.HID, dropout_prob=0.0))
    yield
    mp.undo()
    torch.set_num_threads(threads)


@pytest.fixture()
def same_other_speakers(monkeypatch):
    monkeypatch.setattr(jstep, "draw_other_speaker_ids",
                        lambda key, vids, n: jnp.asarray(tt.DIV_IDS, vids.dtype))
    monkeypatch.setattr(tstep, "draw_other_speaker_ids",
                        lambda g, vids, n: torch.as_tensor(tt.DIV_IDS, device=vids.device))


@pytest.fixture(scope="module")
def remat_init():
    """Models at REMAT_CFG's widths from seed 0, and a batch."""
    init = tbuilder.init_training(REMAT_CFG, 0, N_WORDS, N_SPK, device="cpu")
    batch = tbuilder.synthetic_batch(np.random.default_rng(1), B, REMAT_CFG, N_WORDS, N_SPK)
    return init, tbuilder.to_device(batch, torch.device("cpu"))


# ------------------------------------------------------- concat forwards

def _eval_pair(fn, a: tuple, b: tuple):
    """fn on the concat of inputs a and b, and the concat of fn on each."""
    with torch.no_grad():
        fused = fn(*(torch.cat([x, y]) for x, y in zip(a, b)))
        single = torch.cat([fn(*a), fn(*b)])
    return fused, single


@pytest.mark.parametrize("net", ["gen", "aff_dis", "conv_dis"])
def test_concat_forward_equals_separate_eval(remat_init, net):
    """Eval mode is deterministic per sample: a net on a 2B concat equals
    the concat of two B forwards, exactly (the port's twin of
    `tests/test_fused_pass.py:37-70`): the s2ag generator with its speaker
    z and given noise, and both discriminators."""
    init, batch = remat_init
    other = tbuilder.to_device(tbuilder.synthetic_batch(np.random.default_rng(2), B, REMAT_CFG,
                                                        N_WORDS, N_SPK), torch.device("cpu"))
    rng = np.random.default_rng(3)
    if net == "gen":
        gen = init["gen"].eval()

        def inputs(bt):
            eps = torch.from_numpy(rng.standard_normal((B, 16)).astype(np.float32))
            return (tstep.build_pre_seq(bt["vec_seq"], C.N_PRE_POSES), bt["extended_word_seq"],
                    bt["mfcc_features"], bt["vid_indices"], eps)

        fused, single = _eval_pair(lambda *a: gen(*a)[0], inputs(batch), inputs(other))
    else:
        dis = (TAffDis() if net == "aff_dis" else TConvDis()).eval()
        fused, single = _eval_pair(dis, (batch["vec_seq"],), (other["vec_seq"],))
    assert fused.shape[0] == 2 * B
    assert torch.equal(fused, single)


# ---------------------------------------------------- fused step vs JAX

def _assert_step(i, want, got, st, step, dis_mapper):
    """One step of the port against JAX's: the metrics; after step 1 both
    nets' BN running stats (`tests/test_torch_train.py`'s step
    tolerances)."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=(1e-4, 1e-3)[i], atol=1e-6, err_msg=k)
    if i == 0:
        tt._assert_stats(step.gen, from_jax.pose_generator, tt._vars(st, "gen"), 1e-4)
        tt._assert_stats(step.dis, dis_mapper, tt._vars(st, "dis"), 1e-3)


def _fused_pair(variant, z_type="speaker", seed=0):
    """JAX's `init_training(variant=..., fused_pass=True)` step over filled
    variables (`tests/test_torch_ablations.py`'s `_step_pair` with the
    fused pass), its state, and `make_step(dtype)`: the port's fused
    `GanStep` from the same variables at `dtype`."""
    jcfg = dataclasses.replace(ta.JCFG, z_type=z_type)
    setup = jbuilder.init_training(jcfg, jax.random.key(0), N_WORDS, N_SPK, variant=variant,
                                   abstract=True, fused_pass=True)
    st = setup["state"]
    variables = {who: ta._fill({"params": getattr(st, f"{who}_params"),
                                "batch_stats": getattr(st, f"{who}_stats")}, seed + i)
                 for i, who in enumerate(("gen", "dis", "tri"))}
    state = jstep.create_train_state(variables["gen"], variables["dis"], setup["gan_cfg"],
                                     variables["tri"])
    mapper = (from_jax.conv_discriminator_trimodal if variant == "abl_aff"
              else from_jax.aff_discriminator)
    gan_cfg = tbuilder.gan_config(dataclasses.replace(ta.TCFG, z_type=z_type), N_SPK,
                                  variant=variant, fused_pass=True)

    def make_step(dtype):
        gen = ta._port_generator(variables["gen"], z_type=z_type,
                                 **ta.VARIANT_KW.get(variant, {}))
        dis = (TConvDis if variant == "abl_aff" else TAffDis)(hidden_size=ta.HID,
                                                              dropout_prob=0.0)
        from_jax.load_jax(dis, mapper, variables["dis"])
        tri = TTri(**ta.GEN_KW, z_type=z_type).requires_grad_(False)
        from_jax.load_jax(tri, from_jax.pose_generator_trimodal, variables["tri"])
        return tstep.GanStep(*(m.to(dtype) for m in (gen, dis)), gan_cfg, tri.to(dtype))

    return setup["train_step"], state, make_step, mapper


# How far JAX's compiled float32 fused step may lie from the port's float64
# step in Adam's moments, relative to each tensor's largest: the readings
# at step 1 reach 3.9e-2 (`test_fused_step_matches_jax`)
JAX_MOMENT_TOL = 5e-2


def _moments_held_to_float64(make_step, b, eps, eps_rand, gan_on, step, st, mapper):
    """Both nets' Adam moments after step 1 against the same step of the
    port in float64: the port's float32 step's first moments within 1e-4
    and second within 2e-4 of each tensor's largest
    (`tests/test_torch_train.py`'s `test_gan_step_float32_matches_float64`),
    JAX's within JAX_MOMENT_TOL."""
    ref = make_step(torch.float64)
    tb64 = {k: v.double() if v.is_floating_point() else v for k, v in tt._torch_batch(b).items()}
    ref.train_step(tb64, torch.Generator().manual_seed(0), gan_on=gan_on, eps=eps.double(),
                   eps_rand=eps_rand.double())
    for who, m in (("gen", from_jax.pose_generator), ("dis", mapper))[:1 + gan_on]:
        want = tt._torch_moments(getattr(ref, f"{who}_opt"), getattr(ref, who))
        errs = tt._moment_errors(tt._torch_moments(getattr(step, f"{who}_opt"),
                                                   getattr(step, who)), want)
        jax_errs = tt._moment_errors(tt._optax_moments(getattr(st, f"{who}_opt"), m,
                                                       tt._vars(st, who)), want)
        assert errs[0][0] <= 1e-4 and errs[1][0] <= 2e-4, (who, errs, jax_errs)
        assert all(e <= JAX_MOMENT_TOL for e, _ in jax_errs), (who, errs, jax_errs)


@pytest.mark.parametrize("variant,z_type,gan_on", [
    ("s2ag", "speaker", True), ("s2ag", "random", True), ("s2ag", "none", True),
    ("abl_audio", "speaker", True), ("abl_aff", "speaker", True),
    ("s2ag", "speaker", False)],
    ids=["speaker_z", "random_z", "no_z", "abl_audio", "abl_aff", "gan_off"])
def test_fused_step_matches_jax(same_other_speakers, monkeypatch, variant, z_type, gan_on):
    """Two fused steps against JAX's fused step: the paper model with the
    speaker z, the random z (the generator's forwards fused, its noise one
    2B draw: eps and eps_rand concatenated on both sides) and no z (no
    diversity regularizer: only the D step fuses); both ablations
    (abl_aff's ConvDiscriminator on the 2B concat); and without the GAN
    terms (no D step: only G fuses). Each BatchNorm of a fused net counted
    one update a step.

    The Adam moments are held to the port's float64 step
    (`_moments_held_to_float64`): JAX's compiled float32 step is not
    within MOMENT_TOL of exact arithmetic here. Its moments lie up to
    3.9e-2 of each tensor's largest from the port's float64 step (the D's
    ST-GCN weights at the speaker z, 2.2e-3 in the generator's AffEncoder;
    3e-5 to 1.5e-4 in the other settings; with the weights of seed 30 in
    place of 0, 1.2e-2 without a z), the port's float32 step's within
    3.6e-5: the AffEncoders' ST-GCN gradients, which
    `tests/test_torch_train.py:359-378` describes. At seed 30 JAX's
    unfused abl_audio step without a z lies 6.4e-3 from the port's float32
    one as well."""
    train_step, state, make_step, mapper = _fused_pair(variant, z_type)
    step = make_step(torch.float32)
    eps = eps_rand = torch.zeros(B, 16)
    if z_type == "random":
        rng = np.random.default_rng(31)
        e, er = (rng.standard_normal((B, 16)).astype(np.float32) for _ in range(2))
        noise = ta._HandedNoise([e, np.concatenate([e, er]), e])
        monkeypatch.setattr(jgen_mod, "jax", types.SimpleNamespace(random=noise))
        eps, eps_rand = torch.from_numpy(e), torch.from_numpy(er)
    g = torch.Generator().manual_seed(0)
    for i, seed in enumerate(tt.STEP_SEEDS):
        b = tt._batch(seed)
        state, want = train_step(state, jax.device_put(b), jax.random.key(i), gan_on=gan_on)
        want = {k: float(v) for k, v in jax.device_get(want).items()}
        got = {k: float(v) for k, v in step.train_step(tt._torch_batch(b), g, gan_on=gan_on,
                                                       eps=eps, eps_rand=eps_rand).items()}
        st = jax.device_get(state)
        _assert_step(i, want, got, st, step, mapper)
        if i == 0:
            _moments_held_to_float64(make_step, b, eps, eps_rand, gan_on, step, st, mapper)
    assert ("DIV_REG" in got) == (z_type != "none") and ("dis" in got) == gan_on
    # G: the D step's forward and the G step's one; D: its fused forward and
    # its pass on G's output
    for who, per_step in (("gen", 1 + gan_on), ("dis", 2 * gan_on)):
        counts = {int(m.num_batches_tracked) for m in getattr(step, who).modules()
                  if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
        assert counts == {per_step * len(tt.STEP_SEEDS)}, (who, counts)
    assert sum(gru_cuda.launches.values()) == 0  # CPU tensors: plain versions only


def test_fused_mixed_precision_step_matches_jax(same_other_speakers, monkeypatch):
    """One fused mixed-precision step against JAX's (`mixed_precision_apply`
    on both sides, JAX's GRU through its Pallas kernels in interpret mode):
    `tests/test_torch_bf16.py`'s step tolerances (metrics within 2e-2
    relative plus 5e-4, every parameter within MOVE_MAX lr, the median
    within 0.01 lr, the generator's GRU and head moments within 5e-2 and
    1e-1)."""
    monkeypatch.setenv("S2AG_GRU_ENGINE", "pallas")
    monkeypatch.setenv("S2AG_GRU_PALLAS_INTERPRET", "1")
    jm = tt._init_jax_models()
    cfg = jstep.GanConfig(loss_warmup=-1, n_speakers=N_SPK, fused_pass=True)
    wrap = jbuilder.mixed_precision_apply
    train_step, _ = jstep.make_train_step(wrap(jm["gen"].apply), wrap(jm["dis"].apply), cfg,
                                          wrap(jm["tri"].apply))
    state = jstep.create_train_state(jm["gen_vars"], jm["dis_vars"], cfg, jm["tri_vars"])
    gen, dis, tri = tt._port_models(jm)
    step = tstep.GanStep(gen, dis, tstep.GanConfig(loss_warmup=-1, n_speakers=N_SPK,
                                                   fused_pass=True), tri,
                         train_apply=tbuilder.mixed_precision_apply)
    b = tt._batch(tt.STEP_SEEDS[0])
    state, want = train_step(state, jax.device_put(b), jax.random.key(0), gan_on=True)
    want = {k: float(v) for k, v in jax.device_get(want).items()}
    zeros = torch.zeros(B, 16)
    got = {k: float(v) for k, v in step.train_step(
        tt._torch_batch(b), torch.Generator().manual_seed(0), eps=zeros, eps_rand=zeros).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=5e-4, err_msg=k)
    dist = tb.step_distances(jax.device_get(state), step)
    for who in ("gen", "dis"):
        assert dist[who]["move_max"] <= tb.MOVE_MAX[0], (who, dist[who])
        assert dist[who]["move_median"] <= 0.01, (who, dist[who])
    (first, _), (second, _) = dist["gen"]["moments"]
    assert first <= 5e-2 and second <= 1e-1, dist["gen"]["moments"]


# ---------------------------------------------------------------- remat

def _remat_steps(init, batch, mode: str, case: str):
    """Two train steps of copies of `init`'s models under remat `mode`,
    the noise and the dropout masks drawn from one generator: (metrics,
    step, the generator's state after them)."""
    dtype = torch.float64 if case == "float64" else torch.float32
    models = {k: copy.deepcopy(init[k]).to(dtype) for k in ("gen", "dis", "tri")}
    cfg = dataclasses.replace(init["gan_cfg"], remat=mode, fused_pass=case == "fused",
                              gradient_clip=0.1 if case == "clipped" else 0.0)
    step = tstep.GanStep(models["gen"], models["dis"], cfg, models["tri"],
                         train_apply=tbuilder.mixed_precision_apply if case == "mixed" else None)
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    g = torch.Generator().manual_seed(3)
    metrics = [step.train_step(b, g, gan_on=True) for _ in range(2)]
    return metrics, step, g.get_state()


@pytest.fixture(scope="module")
def plain_steps(remat_init):
    """`_remat_steps` under "none", by case."""
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = _remat_steps(*remat_init, "none", case)
        return runs[case]

    return get


@pytest.mark.parametrize("case", ["float32", "float64", "mixed", "clipped", "fused"])
@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_equals_the_plain_step(remat_init, plain_steps, mode, case):
    """Remat changes no value: two steps at dropout 0.3 with the speaker
    noise drawn inside the rematerialized forwards give, bit for bit, the
    plain step's metrics, parameters, their last gradients, BN running
    stats, Adam states, gradient norms (clipped) and generator state. Each BatchNorm of G and
    D counted one update a forward (three of each net a step, two when
    fused), none for a recompute."""
    want, ref, ref_state = plain_steps(case)
    got, step, state = _remat_steps(*remat_init, mode, case)
    assert step.cfg.remat == mode
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert torch.equal(w[k], g[k]), (k, w[k], g[k])
    for who in ("gen", "dis"):
        model, opt = getattr(step, who), getattr(step, f"{who}_opt")
        ref_model, ref_opt = getattr(ref, who), getattr(ref, f"{who}_opt")
        for (name, v), w in zip(model.state_dict().items(), ref_model.state_dict().values()):
            assert torch.equal(v, w), (who, name)
        for p, q in zip(model.parameters(), ref_model.parameters()):
            # D's gradients are its own step's: the G step's pass froze it
            assert (p.grad is None) == (q.grad is None) and (
                p.grad is None or torch.equal(p.grad, q.grad)), (who, "grad")
            assert opt.state[p].keys() == ref_opt.state[q].keys()
            for k in opt.state[p]:
                assert torch.equal(opt.state[p][k], ref_opt.state[q][k]), (who, k)
        per_step = 2 if case == "fused" else 3
        counts = {int(m.num_batches_tracked) for m in model.modules()
                  if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
        assert counts == {2 * per_step}, (who, counts)
    if case == "clipped":
        assert step.grad_norms.keys() == {"gen", "dis"}
        for k in step.grad_norms:
            assert torch.equal(step.grad_norms[k], ref.grad_norms[k])
    assert torch.equal(state, ref_state)
    assert all(p.requires_grad for p in step.dis.parameters())


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run inside it: all, and `mm`/`addmm`."""

    def __init__(self):
        super().__init__()
        self.ops = self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.products += func in tstep.DOTS_SAVED
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("net", ["gen", "dis"])
def test_dots_recomputes_no_products(remat_init, net):
    """The ops that the backward of one train-mode forward runs: under
    "dots" as many `mm`/`addmm` as without remat (their outputs were kept)
    but more ops in all (the rest is recomputed); under "full" more
    `mm`/`addmm` too (the products are recomputed)."""
    init, batch = remat_init
    counts = {}
    for mode in tstep.REMAT_MODES:
        module = copy.deepcopy(init[net]).train()
        g = torch.Generator().manual_seed(0)
        if net == "gen":
            args = (tstep.build_pre_seq(batch["vec_seq"], C.N_PRE_POSES),
                    batch["extended_word_seq"], batch["mfcc_features"], batch["vid_indices"],
                    None, g)
        else:
            args = (batch["vec_seq"], batch["extended_word_seq"])
        fn = module if mode == "none" else functools.partial(tstep.rematerialize, module,
                                                             mode, g, module)
        with tlayers.dropout_rng(g):
            out = fn(*args)
            out = out[0] if net == "gen" else out
            with _CountOps() as count:
                out.square().sum().backward()
        counts[mode] = (count.products, count.ops)
    assert counts["dots"][0] == counts["none"][0] < counts["full"][0], counts
    assert counts["none"][1] < counts["dots"][1] < counts["full"][1], counts


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        tstep.GanConfig(remat="bogus")
    with pytest.raises(ValueError, match="remat"):
        tbuilder.init_training(REMAT_CFG, 0, N_WORDS, N_SPK, device="cpu", remat="bogus")


# ------------------------------------------------------------------ CLI

def _cli_argv(tmp_path):
    import yaml

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=32, hidden_size_s2eg=32, n_layers=2, wordembed_dim=16,
               random_seed=3, loss_warmup=-1)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    return ["-b", str(tmp_path / "base"), "-c", str(cfg_path), "--synthetic-data", "true",
            "--device", "cpu", "--batch-size", "4", "--s2ag-num-epoch", "1",
            "--synthetic-videos", "2", "--synthetic-seconds", "4", "--log-interval", "1"]


@pytest.mark.parametrize("entry,flag", [
    (tmain, ["--fused-pass", "true"]), (tmain, ["--remat", "full"]),
    (tmain, ["--remat", "dots"]), (main_v2_abl_aff, ["--fused-pass", "true"])],
    ids=["fused", "remat_full", "remat_dots", "abl_aff_fused"])
def test_main_v2_trains_with_step_options(tmp_path, entry, flag):
    """`main_v2` (and `main_v2_abl_aff`) on the CPU at hidden 32 with a step
    option: the trainer's step has it, every logged loss is finite, with
    the GAN terms on, and the test split is scored."""
    trainer = entry.main(_cli_argv(tmp_path) + flag)
    cfg = trainer.gan_cfg
    assert (cfg.fused_pass, cfg.remat) == ((True, "none") if flag[0] == "--fused-pass"
                                           else (False, flag[1]))
    log = (pathlib.Path(trainer.work_dir) / "log.txt").read_text()
    iters = [line for line in log.splitlines() if "Done. |" in line]
    assert iters and all("dis:" in line and "DIV_REG:" in line for line in iters)
    values = [float(tok.split(": ")[1]) for line in iters
              for tok in line.split("Done. | ")[1].split(" | ")]
    assert np.isfinite(values).all() and "eval: l1" in log


def test_main_v2_refuses_an_unknown_remat_mode(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tmain.main(_cli_argv(tmp_path) + ["--remat", "bogus"])
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
