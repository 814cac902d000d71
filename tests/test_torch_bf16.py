"""The port's bf16 paths on the CPU against the JAX package run through its
Pallas GRU kernels in interpret mode (`S2AG_GRU_ENGINE=pallas`,
`S2AG_GRU_PALLAS_INTERPRET=1`, set before the JAX modules trace: JAX's CPU
default, the lax.scan engine, computes its gates in bf16, which is not what
the TPU kernels do nor what the port follows). The GRU layer (v2 and v1),
BatchNorm, the three nets' forwards under mixed precision, two
mixed-precision GAN steps, `main_v2 --mixed-precision true` and bf16
serving. Inputs from a seed with numpy, small widths (T 8, B 4-9, H 12-40,
the h16 nets of `tests/test_torch_train.py`).

Tolerances and the readings behind them (this file's cases):
- the GRU layer: ys and h_last within 1e-2 absolute (two bf16 ulps for
  |h| < 1; the rounding points are the TPU kernel's, only float32 sums run
  in another order; read: 0, the same bits); dxp, dW_hh and the bias
  gradients within 2e-2 of each one's largest value (read: dxp and db_ih
  0, dW_hh 5.3e-3, db_hh 3.0e-3: the port's dW_hh sums the stored bf16 g,
  the TPU kernel's the float32 g, and both round the sum to bf16);
- BatchNorm: outputs 1e-2 absolute, float32 running stats 1e-5 relative;
- the nets' forwards under mixed precision, weights scaled by 0.3 (at raw
  init the recurrence is expansive and bf16 rounding grows over the
  window; the JAX package's tests/test_serve.py:409-440): outputs within
  3e-2 of their largest value (read: 4.5e-3 to 4.9e-3; the discriminator
  0);
- the GAN step (raw weights, the f32 step test's batches): metrics within
  2e-2 relative plus 5e-4 absolute (a bf16 ulp of s2ag_l1 ~0.2, for the
  near-zero differential metric; read: up to 4.9e-3 relative, 7.8e-5
  absolute); after step 1 the generator's GRU and head Adam first moments
  within 5e-2 and second moments within 1e-1 of each tensor's largest
  (read: 2.0e-2 and 3.9e-2; the port's float32 step lies 1.8e-2 and
  3.2e-2 from JAX's bf16 one); every parameter within what Adam can move
  two runs apart when a gradient at bf16 noise level takes either sign
  (`MOVE_MAX`; read: 2.0 and 4.11 lr), the median parameter within 0.01 lr
  after step 1 (read: 7e-6 lr) and 0.2 lr after step 2 (read: 0.07 lr).
  The discriminator's moments and the AffEncoders' are not held: batch
  norms over a batch of 4 amplify bf16 rounding, and there the port's
  float32 step lies as far from JAX's bf16 one (0.2 to 6 of their largest)
  as the port's bf16 step does;
- bf16 serving, weights scaled by 0.3: direction vectors and joints within
  3e-2 of their largest value.
`PYTHONPATH=. python tests/test_torch_train.py [seed ...]` prints the
GAN-step readings for other batch seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as tt
from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch import serve as tserve
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data.vocab import Vocab as TVocab
from speech2affective_gestures_torch.models import layers as tlayers
from speech2affective_gestures_torch.models.generator import PoseGenerator as TGen
from speech2affective_gestures_torch.ops import gru_cuda
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train import synthesis as tsyn
from speech2affective_gestures_torch.train.builder import mixed_precision_apply
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data.vocab import Vocab as JVocab
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.models import layers as jlayers
from speech2affective_gestures_tpu.ops import gru_pallas
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import gan_step as jstep
from speech2affective_gestures_tpu.train import synthesis as jsyn

BF16 = torch.bfloat16
FWD_TOL, GRAD_TOL, NET_TOL = 1e-2, 2e-2, 3e-2


@pytest.fixture(scope="module", autouse=True)
def pallas_engine():
    """JAX's GRU through the Pallas kernels in interpret mode; z = mu and
    the TriModal's embedding dropout at 0, as `tests/test_torch_train.py`
    sets them."""
    mp = pytest.MonkeyPatch()
    mp.setenv("S2AG_GRU_ENGINE", "pallas")
    mp.setenv("S2AG_GRU_PALLAS_INTERPRET", "1")
    mp.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    yield
    mp.undo()


def _rel(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaves(*arrays):
    """bf16 torch leaves that require a gradient, from float32 numpy."""
    return [torch.from_numpy(a).to(BF16).requires_grad_() for a in arrays]


# ------------------------------------------------------------- GRU layers

def _layer_inputs(T, B, D, H, seed):
    rng = np.random.default_rng(seed)
    return dict(
        xp=rng.standard_normal((T, B, D * 3 * H)).astype(np.float32),
        w_hh=(rng.standard_normal((D, H, 3 * H)) / 4).astype(np.float32),
        b_ih=(rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32),
        b_hh=(rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32),
        gy=rng.standard_normal((T, B, D * H)).astype(np.float32),
        gh=rng.standard_normal((D, B, H)).astype(np.float32),
    )


def _jax_layer_v2(p, T, B, D, H):
    """ys, h_last and the gradients of run_layer_v2 on bf16 inputs (xp
    given per gate, padded to the kernel's lanes as its input product
    emits it)."""
    P = gru_pallas._round_up(H, gru_pallas.LANE)

    def layer(xp, w_hh, b_ih, b_hh):
        padded = jnp.pad(xp.reshape(T, B, D, 3, H),
                         [(0, 0)] * 4 + [(0, P - H)]).reshape(T, B, D * 3 * P)
        ys, h_last = gru_pallas.run_layer_v2(padded, w_hh, b_ih, b_hh, interpret=True)
        return jnp.concatenate([ys[:, :, d * P:d * P + H] for d in range(D)], -1), h_last

    def loss(*args):
        ys, h_last = layer(*args)
        return (jnp.sum(ys.astype(jnp.float32) * p["gy"])
                + jnp.sum(h_last.astype(jnp.float32) * p["gh"]))

    args = [jnp.asarray(p[k]).astype(jnp.bfloat16) for k in ("xp", "w_hh", "b_ih", "b_hh")]
    ys, h_last = layer(*args)
    return ys, h_last, jax.grad(loss, argnums=(0, 1, 2, 3))(*args)


@pytest.mark.parametrize("B,D,H", [(4, 2, 20), (9, 1, 12), (5, 2, 40)])
def test_gru_layer_bf16_matches_pallas(B, D, H):
    """`gru_cuda.gru_layer` on bf16 CPU tensors (GRULayerFunction over the
    plain versions) against `run_layer_v2(interpret=True)` on bf16 inputs:
    values, bf16 output dtypes (as `tests/test_gru_pallas.py:318-336`
    asserts JAX's), and gradients in the inputs' dtype."""
    T = 8
    p = _layer_inputs(T, B, D, H, seed=B + 10 * H)
    want_ys, want_h, want_g = _jax_layer_v2(p, T, B, D, H)
    assert want_ys.dtype == want_h.dtype == jnp.bfloat16
    leaves = _leaves(p["xp"], p["w_hh"], p["b_ih"], p["b_hh"])
    ys, h_last = gru_cuda.gru_layer(*leaves)
    assert ys.dtype == h_last.dtype == BF16
    np.testing.assert_allclose(_f32(ys), _f32(want_ys), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(_f32(h_last), _f32(want_h), atol=FWD_TOL, rtol=0)
    loss = ((ys.float() * torch.from_numpy(p["gy"])).sum()
            + (h_last.float() * torch.from_numpy(p["gh"])).sum())
    grads = torch.autograd.grad(loss, leaves)
    for name, got, want in zip(("dxp", "dW_hh", "db_ih", "db_hh"), grads, want_g):
        assert got.dtype == BF16, name
        assert _rel(_f32(got), _f32(want)) <= GRAD_TOL, (name, _rel(_f32(got), _f32(want)))
    assert sum(gru_cuda.launches.values()) == 0  # CPU tensors: plain versions only


@pytest.mark.parametrize("B,D,H", [(4, 2, 12), (9, 1, 20)])
def test_gru_v1_bf16_matches_pallas(B, D, H):
    """`gru_cuda.run_layer` (the walk layout) on bf16 CPU tensors against
    `gru_pallas.run_layer(interpret=True)` on bf16 inputs, values and
    gradients in xp, w_hh and b_hh."""
    T = 7
    rng = np.random.default_rng(B * H)
    xp = rng.standard_normal((T, D, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((D, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((T, D, B, H)).astype(np.float32)

    def loss(xp, w, b):
        ys, h_last = gru_pallas.run_layer(xp, w, b, interpret=True)
        return jnp.sum(ys.astype(jnp.float32) * gy) + jnp.sum(jnp.sin(h_last.astype(jnp.float32)))

    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xp, w, b)]
    want_ys, want_h = gru_pallas.run_layer(*args, interpret=True)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    leaves = _leaves(xp, w, b)
    ys, h_last = gru_cuda.run_layer(*leaves)
    assert want_ys.dtype == jnp.bfloat16 and ys.dtype == h_last.dtype == BF16
    np.testing.assert_allclose(_f32(ys), _f32(want_ys), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(_f32(h_last), _f32(want_h), atol=FWD_TOL, rtol=0)
    grads = torch.autograd.grad(
        (ys.float() * torch.from_numpy(gy)).sum() + torch.sin(h_last.float()).sum(), leaves)
    for name, got, want in zip(("dxp", "dW_hh", "db_hh"), grads, want_g):
        assert got.dtype == BF16, name
        assert _rel(_f32(got), _f32(want)) <= GRAD_TOL, (name, _rel(_f32(got), _f32(want)))


def test_bf16_cpu_layer_carries_dh_in_float32():
    """On the CPU a bf16 layer under autograd runs GRULayerFunction (dh
    carried in float32, the TPU kernel's rounding points), not autograd
    through the bf16 loop; its backward equals the plain recurrence run at
    those points."""
    T, B, D, H = 6, 3, 2, 12
    p = _layer_inputs(T, B, D, H, seed=3)
    leaves = _leaves(p["xp"], p["w_hh"], p["b_ih"], p["b_hh"])
    ys, h_last = gru_cuda.gru_layer(*leaves)
    assert ys.grad_fn.name() == "GRULayerFunctionBackward"
    dys = torch.from_numpy(p["gy"]).to(BF16)
    (dxp,) = torch.autograd.grad(ys, leaves[0], dys)
    xp, w_hh, b_ih, b_hh = (t.detach() for t in leaves)
    want, _ = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys.detach(), dys)
    assert torch.equal(dxp, want)


@pytest.mark.parametrize("bad", ["float16", "mixed"])
def test_gru_layer_refuses_float16_and_mixed_dtypes(bad):
    p = _layer_inputs(4, 2, 1, 8, seed=1)
    xp, w_hh, b_ih, b_hh = (torch.from_numpy(p[k]) for k in ("xp", "w_hh", "b_ih", "b_hh"))
    if bad == "float16":
        xp, w_hh, b_ih, b_hh = (t.half() for t in (xp, w_hh, b_ih, b_hh))
    else:
        xp = xp.to(BF16)
    with pytest.raises(TypeError):
        gru_cuda.gru_layer(xp, w_hh, b_ih, b_hh)
    with pytest.raises(TypeError):
        gru_cuda.run_layer(xp.view(4, 1, 2, 24), w_hh, b_hh)


# ------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dims", [1, 2])
def test_batch_norm_bf16_matches_jax(train, dims):
    """`layers.BatchNorm1d`/`2d` on a bf16 input with bf16 scale and bias
    against JAX `layers.BatchNorm` at bf16: float32 statistics and running
    stats, the output in bf16."""
    rng = np.random.default_rng(dims + 2 * train)
    C_, shape = 6, ((5, 6, 9) if dims == 1 else (4, 6, 7, 3))
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(C_)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(C_)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(C_)).astype(np.float32)
    var = (1 + 0.2 * rng.random(C_)).astype(np.float32)
    bn = (tlayers.BatchNorm1d if dims == 1 else tlayers.BatchNorm2d)(C_).train(train)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    params = {"weight": torch.from_numpy(scale).to(BF16), "bias": torch.from_numpy(bias).to(BF16)}
    got = torch.func.functional_call(bn, params, (torch.from_numpy(x).to(BF16),))
    assert got.dtype == BF16 and bn.running_mean.dtype == torch.float32

    variables = {"params": {"scale": jnp.asarray(scale).astype(jnp.bfloat16),
                            "bias": jnp.asarray(bias).astype(jnp.bfloat16)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    xl = jnp.asarray(np.moveaxis(x, 1, -1)).astype(jnp.bfloat16)   # channel-last
    want, mut = jlayers.BatchNorm(C_).apply(variables, xl, use_running_average=not train,
                                            mutable=["batch_stats"])
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), np.moveaxis(_f32(want), -1, 1), atol=1e-2, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5)


# ------------------------------------------------------ nets and GAN step

def _scaled(variables, factor):
    return dict(variables, params=jax.tree.map(
        lambda x: x * factor if x.dtype == jnp.float32 else x, variables["params"]))


@pytest.fixture(scope="module")
def jax_models(pallas_engine):
    """The h16 nets of `tests/test_torch_train.py`, initialized once. The
    init is traced with JAX's scan engine, which is quicker to compile and
    creates the same parameters under the same names."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("S2AG_GRU_ENGINE")
        return tt._init_jax_models()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("which", ["gen", "dis", "tri"])
def test_net_forwards_under_mixed_precision_match_jax(jax_models, which, train):
    """PoseGenerator, AffDiscriminator and the TriModal generator through
    `builder.mixed_precision_apply` against JAX's `mixed_precision_apply`,
    weights scaled by 0.3: float32 outputs, within NET_TOL of their
    largest value."""
    jm = {k: _scaled(v, 0.3) if k.endswith("_vars") else v for k, v in jax_models.items()}
    gen, dis, tri = tt._port_models(jm)
    b = tt._batch(1)
    tb = tt._torch_batch(b)
    pre = jstep.build_pre_seq(jnp.asarray(b["vec_seq"]), C.N_PRE_POSES)
    tpre = torch.from_numpy(np.array(pre))
    eps = torch.zeros(tt.B, 16)
    if which == "dis":
        module, jargs = dis, (b["vec_seq"], b["extended_word_seq"])
        targs = (tb["vec_seq"], tb["extended_word_seq"])
    else:
        feat = "mfcc_features" if which == "gen" else "audio"
        module = gen if which == "gen" else tri
        jargs = (pre, b["extended_word_seq"], b[feat], b["vid_indices"])
        targs = (tpre, tb["extended_word_seq"], tb[feat], tb["vid_indices"], eps, None)
    kw = dict(train=train, rngs={"noise": jax.random.key(1), "dropout": jax.random.key(2)})
    if train:
        kw["mutable"] = ["batch_stats"]
    want = jbuilder.mixed_precision_apply(jm[which].apply)(
        jm[f"{which}_vars"], *[jnp.asarray(a) for a in jargs], **kw)
    want = want[0] if train else want
    with torch.no_grad():
        got = mixed_precision_apply(module.train(train))(*targs)
    if which != "dis":
        got, want = got[0], want[0]
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got.numpy(), want) <= NET_TOL, _rel(got.numpy(), want)
    assert {p.dtype for p in module.parameters()} == {torch.float32}
    assert {b.dtype for b in module.buffers()} <= {torch.float32, torch.int64}


def mixed_precision_steps(jm, seeds):
    """JAX's mixed-precision train step (`make_train_step` over
    `mixed_precision_apply`-wrapped applies, as `init_training(...,
    mixed_precision=True)` builds it) and the port's `GanStep` with
    `train_apply=mixed_precision_apply`, side by side from the same
    weights on one batch per seed; yields (step index, JAX metrics, port
    metrics, JAX state, port step)."""
    cfg = jstep.GanConfig(loss_warmup=-1, n_speakers=tt.N_SPK)
    wrap = jbuilder.mixed_precision_apply
    train_step, _ = jstep.make_train_step(wrap(jm["gen"].apply), wrap(jm["dis"].apply), cfg,
                                          wrap(jm["tri"].apply))
    state = jstep.create_train_state(jm["gen_vars"], jm["dis_vars"], cfg, jm["tri_vars"])
    gen, dis, tri = tt._port_models(jm)
    step = tstep.GanStep(gen, dis, tstep.GanConfig(loss_warmup=-1, n_speakers=tt.N_SPK), tri,
                         train_apply=mixed_precision_apply)
    g = torch.Generator().manual_seed(0)
    eps = torch.zeros(tt.B, 16)
    for i, seed in enumerate(seeds):
        b = tt._batch(seed)
        state, want = train_step(state, jax.device_put(b), jax.random.key(i), gan_on=True)
        want = {k: float(v) for k, v in jax.device_get(want).items()}
        got = step.train_step(tt._torch_batch(b), g, gan_on=True, eps=eps)
        yield i, want, {k: float(v) for k, v in got.items()}, jax.device_get(state), step


def _gru_and_head(moments: dict) -> dict:
    return {k: v for k, v in moments.items() if k.startswith(("gru.", "out"))}


def step_distances(st, step) -> dict:
    """The port's mixed-precision step against JAX's after a step: the
    generator's GRU and head Adam moments (first, second: worst over each
    tensor's largest), and every parameter's move in units of its
    optimizer's lr (largest, median), for both nets."""
    out = {}
    for who, mapper, lr in (("gen", from_jax.pose_generator, step.cfg.learning_rate),
                            ("dis", from_jax.aff_discriminator, step.cfg.lr_dis)):
        variables = tt._vars(st, who)
        want = mapper(variables)
        params = dict(getattr(step, who).named_parameters())
        diff = np.concatenate([
            np.abs(params[k].detach().double().numpy()
                   - np.asarray(want[k], np.float64).reshape(params[k].shape)).ravel()
            for k in want if k in params]) / lr
        out[who] = {"move_max": float(diff.max()), "move_median": float(np.median(diff))}
        if who == "gen":
            out[who]["moments"] = tt._moment_errors(
                _gru_and_head(tt._torch_moments(step.gen_opt, step.gen)),
                _gru_and_head(tt._optax_moments(getattr(st, "gen_opt"), mapper, variables)))
    return out


# The most two runs of Adam (betas 0.5, 0.999) can move a parameter apart,
# in units of lr, when its gradients take opposite signs: 2 after one step
# (each moves lr sign(g)), 2 (1 + sqrt(10) / 3) after two (the second step's
# bias-corrected m / sqrt(v) reaches sqrt(10) / 3); with float32 rounding.
MOVE_MAX = (2.01, 4.12)


def test_two_mixed_precision_gan_steps_match_jax(jax_models, monkeypatch):
    """Two GAN steps under mixed precision on `tests/test_torch_train.py`'s
    batches: the metrics of both, then after each the parameters and after
    step 1 the generator's GRU and head moments (the module docstring has
    the tolerances and readings). The discriminator's leaky-ReLU slope
    flips (`tests/test_torch_train.py:370-378`) apply here as there."""
    monkeypatch.setattr(jstep, "draw_other_speaker_ids",
                        lambda key, vids, n: jnp.asarray(tt.DIV_IDS, vids.dtype))
    monkeypatch.setattr(tstep, "draw_other_speaker_ids",
                        lambda g, vids, n: torch.as_tensor(tt.DIV_IDS, device=vids.device))
    for i, want, got, st, step in mixed_precision_steps(jax_models, tt.STEP_SEEDS):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=5e-4, err_msg=k)
        dist = step_distances(st, step)
        for who in ("gen", "dis"):
            assert dist[who]["move_max"] <= MOVE_MAX[i], (i, who, dist[who])
            assert dist[who]["move_median"] <= (0.01, 0.2)[i], (i, who, dist[who])
        if i == 0:
            (first, _), (second, _) = dist["gen"]["moments"]
            assert first <= 5e-2 and second <= 1e-1, dist["gen"]["moments"]
    assert all(p.dtype == torch.float32 for p in step.gen.parameters())


def bf16_readings(seeds):
    """For each batch seed, two mixed-precision steps (batches seed and
    seed + 1) of JAX's Pallas-engine step and the port's: the metrics'
    largest relative distance, and `step_distances` after each step (the
    readings behind the GAN-step tolerances). Needs the Pallas engine's
    environment and `pallas_engine`'s patches."""
    jm = tt._init_jax_models()
    for seed in seeds:
        for i, want, got, st, step in mixed_precision_steps(jm, (seed, seed + 1)):
            worst = max((abs(got[k] - want[k]) / max(abs(want[k]), 1e-12), k) for k in want)
            print(f"seed {seed} bf16 step {i + 1}: metrics {worst[0]:.2e} at {worst[1]}; "
                  f"{step_distances(st, step)}")


def test_main_v2_mixed_precision_on_cpu(tmp_path):
    """`main_v2 --mixed-precision true` trains one epoch at h16 on the
    synthetic corpus: finite losses, float32 master weights and BN stats,
    and the test split scored (its `eval:` line) by the float32 nets."""
    import yaml

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=tt.HID, hidden_size_s2eg=tt.HID, n_layers=1,
               wordembed_dim=tt.EMB, random_seed=3, loss_warmup=-1)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    trainer = tmain.main(["-b", str(tmp_path / "base"), "-c", str(cfg_path),
                          "--synthetic-data", "true", "--device", "cpu",
                          "--batch-size", "4", "--s2ag-num-epoch", "1",
                          "--synthetic-videos", "2", "--synthetic-seconds", "4",
                          "--log-interval", "1", "--mixed-precision", "true"])
    assert trainer.step.train_apply is mixed_precision_apply
    log = (tmp_path / "base/models/s2ag_v2_mfcc_torch/ted_db/log.txt").read_text()
    iters = [line for line in log.splitlines() if "Iter 0 Done" in line]
    assert len(iters) == 1 and "dis:" in iters[0]
    values = [float(tok.split(": ")[1]) for tok in iters[0].split("Done. | ")[1].split(" | ")]
    assert np.isfinite(values).all()
    [line] = [x for x in log.splitlines() if "eval: l1: " in x]
    scores = dict(tok.split(": ") for tok in line.split("eval: ")[1].split(" | "))
    assert np.isfinite([float(v) for v in scores.values()]).all()
    for net in (trainer.gen, trainer.dis, trainer.tri):
        assert {p.dtype for p in net.parameters()} == {torch.float32}
        assert {b.dtype for b in net.buffers()} <= {torch.float32, torch.int64}


# ----------------------------------------------------------------- serving

def test_bf16_serving_matches_jax():
    """The port's synthesis at precision "bf16" against JAX's
    `make_fused_clip_fn(precision="bf16")`, the tiny generator of the JAX
    package's tests/test_serve.py:409-440 with weights scaled by 0.3, z =
    mu on both sides; and a service at bf16 reports it on /healthz and
    /metrics."""
    kw = dict(n_words=30, n_speakers=5, hidden_size=32, n_layers=2)
    jcfg = JConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2)
    tcfg = TConfig(hidden_size_s2eg=32, n_layers=2)
    jgen = jgen_mod.PoseGenerator(**kw)
    zeros = (jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1)), jnp.zeros((1, C.N_POSES), jnp.int32),
             jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)), jnp.zeros((1,), jnp.int32))
    variables = _scaled(jax.device_get(jax.jit(jgen.init)(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, *zeros)), 0.3)
    tgen = TGen(**kw).eval()
    from_jax.load_jax(tgen, from_jax.pose_generator, variables)
    jv, tv = JVocab("w"), TVocab("w")
    for w in ("hello", "world"):
        jv.index_word(w)
        tv.index_word(w)
    words = [["hello", 0.2, 0.7], ["world", 2.0, 2.6]]
    audio = (0.2 * np.sin(np.arange(int(6.0 * C.AUDIO_SR)) / 30)).astype(np.float32)
    fn = jsyn.make_fused_clip_fn(jgen.apply, jcfg, precision="bf16")
    want_dv, want_ps = jsyn.synthesize_clip_fused(fn, variables, audio, words, jv, jcfg,
                                                  vid_idx=2, rng=jax.random.key(4))
    n_windows = len(tsyn.plan_subdivisions(len(audio) / C.AUDIO_SR, tcfg)[0])
    eps = torch.zeros(n_windows, 1, 16)
    got_dv, got_ps = tsyn.synthesize_clip_fused(tgen, audio, words, tv, tcfg, vid_idx=2,
                                                eps=eps, precision="bf16")
    assert got_dv.dtype == np.float32 and got_dv.shape == want_dv.shape
    assert _rel(got_dv, want_dv) <= NET_TOL, _rel(got_dv, want_dv)
    assert _rel(got_ps, want_ps) <= NET_TOL, _rel(got_ps, want_ps)
    assert {p.dtype for p in tgen.parameters()} == {torch.float32}

    service = tserve.SynthesisService(tcfg, tgen, tv, precision="bf16")
    srv = tserve.serve(service, port=0)
    try:
        import http.client
        import json

        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["precision"] == "bf16"
        body = json.dumps({"audio": None, "words": words})
        conn.request("POST", "/synthesize", body, {"Content-Type": "application/json"})
        out = json.loads(conn.getresponse().read())
        assert np.isfinite(np.asarray(out["dir_vec"])).all()
        conn.request("GET", "/metrics")
        assert json.loads(conn.getresponse().read())["synthesize"]["precision"] == "bf16"
    finally:
        srv.shutdown()
        srv.server_close()
    with pytest.raises(ValueError):
        tserve.SynthesisService(tcfg, tgen, tv, precision="fp16")
