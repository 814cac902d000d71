"""The device-resident loader and the K-steps-per-program epoch on the CPU:
the port's `ted_db.DeviceDataset` and `Trainer(steps_per_program=K)`
against the JAX package's, and against the port's per-step loop.

The corpus is JAX's tests/test_steps_per_program.py's: two synthetic
videos of 12 s (28 windows) at hidden 32, one GRU layer, batch 4, the GAN
terms on from the first step. The port's split holds JAX's packed arrays
and vocabularies.

Tolerances:
- the batch: every field exact against JAX's gather run op by op
  (`jax.disable_jit`: the division by 32767 as written); the audio within
  1 ulp of JAX's compiled gather, where XLA turns the division into a
  product with the float32 reciprocal (1.1% of the samples here), which
  the test shows exactly;
- the port's scanned epoch against its per-step loop: bit for bit (the
  same body, draws and order on the CPU): the logged lines, the epoch
  mean, every parameter and buffer, both Adam states and learning rates,
  the generator's state;
- the port's scanned epoch against JAX's: JAX's own tolerances between
  its scanned and per-step epochs (iteration 0 every metric at rtol 1e-3,
  atol 1e-4; the other iterations' s2ag_l1 and the epoch mean at rtol
  5e-2), with every dropout at zero, z = mu and the diversity
  regularizer's other speakers a fixed roll on both sides, since the two
  packages draw from different generators.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.models import generator as tgen_mod
from speech2affective_gestures_torch.models.discriminator import AffDiscriminator as TDis
from speech2affective_gestures_torch.train import builder as tbuilder
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train.trainer import Trainer as TTrainer
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data import ted_db as jdb
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.models.discriminator import AffDiscriminator as JDis
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import gan_step as jstep
from speech2affective_gestures_tpu.train.trainer import Trainer as JTrainer

WIDTHS = dict(batch_size=4, loss_warmup=-1, n_layers=1, hidden_size=32, hidden_size_s2eg=32)
FIELDS = ("extended_word_seq", "vec_seq", "audio", "audio_max", "mfcc_features",
          "vid_indices")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while these tests run: their ops are tiny, and
    beside the other test files' worker processes, torch's threads wait on
    each other at every op and slow every process on the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus():
    """(JAX's packed split, the port's split over the same arrays)."""
    videos = jdb.make_synthetic_videos(n_videos=2, clip_seconds=12.0)
    jds = jdb.build_dataset_from_videos(videos, JConfig(**WIDTHS), keep_sidecars=False)
    tds = tdb.PackedDataset(**{k: getattr(jds, k) for k in FIELDS},
                            speaker_model=jds.speaker_model, lang_model=jds.lang_model)
    return jds, tds


def _trainer(tds, tmp_path, name: str, spp: int = 1, cfg=None, **kw) -> TTrainer:
    t = TTrainer(cfg or TConfig(**WIDTHS), str(tmp_path / name), train_data=tds,
                 device="cpu", seed=3, steps_per_program=spp, metrics_lag=3,
                 log_interval=1, **kw)
    t.epoch = 1
    t.lines = []
    t.logger.print_log = t.lines.append
    return t


def _iter_lines(lines) -> list[str]:
    return [ln for ln in lines if "Done. |" in ln]


def _parse_iter_metrics(lines) -> dict:
    """{iter: {name: value}} from the per-iteration log lines."""
    out = {}
    for line in _iter_lines(lines):
        m = re.match(r"\s*Iter (\d+) Done\. \| (.*)", line)
        out[int(m.group(1))] = {k: float(v) for k, v in
                                (part.split(": ") for part in m.group(2).split(" | "))}
    return out


# ------------------------------------------------------------------ batch

def test_device_batch_matches_jax_device_batch(corpus):
    """`DeviceDataset.batch` against JAX's on the same packed arrays, rows
    and speakers: every field exact against JAX's gather run op by op; the
    audio within 1 ulp of JAX's compiled gather, whose division XLA makes
    a product with 1/32767 in float32 (shown exactly)."""
    jds, tds = corpus
    rng = np.random.default_rng(0)
    idx, adv = rng.integers(0, jds.n_samples, 64), rng.integers(0, 3, 64)
    got = tdb.DeviceDataset(tds, torch.device("cpu")).batch(idx, adv)
    jdd = jdb.DeviceDataset(jds)
    with jax.disable_jit():
        eager = jdd.batch(idx, adv)
    compiled = jdd.batch(idx, adv)
    assert set(got) == set(eager)
    for k in eager:
        want = np.asarray(eager[k])
        assert got[k].dtype == (torch.int64 if want.dtype.kind == "i" else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    audio, xla = got["audio"].numpy(), np.asarray(compiled["audio"])
    assert np.all(np.abs(audio - xla) <= np.spacing(np.abs(xla))), "more than 1 ulp"
    assert 0 < np.mean(audio != xla) < 0.05
    rows = torch.from_numpy(jds.audio[idx]).float()
    scale = torch.from_numpy(jds.audio_max.astype(np.float32)[idx])[:, None]
    np.testing.assert_array_equal((rows * scale * torch.tensor(1 / 32767.0)).numpy(), xla)


def test_default_loader_batches_match_jax_default_loader(corpus, tmp_path):
    """The batches the port's default per-step loop feeds its train step
    (`Trainer(loader="device")`) equal those of JAX's default loop
    (`DeviceBatchSampler` with the epoch's seed, run op by op): the same
    rows, speakers and float32 audio decode. The host decode the loop used
    before (`decode_rows`, in float64) differs from them in some audio
    samples, by 1 ulp."""
    jds, tds = corpus
    t = _trainer(tds, tmp_path, "default")
    fed = []
    step = t.step.train_step

    def record(batch, *args, **kwargs):
        fed.append({k: v.clone() for k, v in batch.items()})
        return step(batch, *args, **kwargs)

    t.step.train_step = record
    t.per_train_epoch(max_iters=3)
    assert len(fed) == 3
    sampler = jdb.DeviceBatchSampler(jds, 4, seed=t.epoch * 7919 + 1)
    host = tdb.BatchSampler(tds, 4, seed=t.epoch * 7919 + 1)
    differs = 0
    with jax.disable_jit():
        for got, want in zip(fed, sampler):
            idx = host.sample_indices()
            host.adversarial_speakers(tds.vid_indices[idx])
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            old = tdb.decode_rows(tds, idx)["audio"]
            differs += int(np.sum(old != got["audio"].numpy()))
            assert np.all(np.abs(old - got["audio"].numpy()) <= np.spacing(np.abs(old)))
    assert differs > 0


def test_device_dataset_holds_the_compact_dtypes(corpus):
    _, tds = corpus
    dd = tdb.DeviceDataset(tds, torch.device("cpu"))
    assert {k: v.dtype for k, v in dd.arrays.items()} == {
        "extended_word_seq": torch.int32, "vec_seq": torch.float32,
        "mfcc_features": torch.float16, "audio": torch.int16, "audio_max": torch.float32}


# ------------------------------------------------- scanned against per step

def _state(t: TTrainer) -> dict:
    """Everything an epoch changes: parameters and buffers of the three
    nets, both Adam states and learning rates, the generator's state and
    the step count."""
    out = {f"{who} {k}": v for who in ("gen", "dis", "tri")
           for k, v in getattr(t, who).state_dict().items()}
    for who in ("gen", "dis"):
        opt, model = getattr(t.step, f"{who}_opt"), getattr(t, who)
        for name, p in model.named_parameters():
            for k, v in opt.state.get(p, {}).items():
                out[f"{who} Adam {k} {name}"] = v
        out[f"{who} lr"] = torch.tensor([g["lr"] for g in opt.param_groups])
    out["generator"] = t.generator.get_state()
    out["step"] = torch.tensor(t.step.step)
    return out


def _assert_same_state(a: TTrainer, b: TTrainer):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert not diff, diff[:10]


# (trainer options, K, steps): K 4 over 7 steps is a program of 4, then
# the partial one of 3; the options run K 2 over 3 steps (2, then 1)
OPTIONS = {
    "plain": ({}, 4, 7),
    "fused": ({"fused_pass": True}, 2, 3),
    "remat_full": ({"remat": "full"}, 2, 3),
    "mixed": ({"mixed_precision": True}, 2, 3),
    # the decay's epoch cut to 1 update: the rate halves at every update,
    # inside the programs too
    "decay": ({"lr_decay": 0.5}, 2, 3),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_scanned_epoch_equals_per_step_loop(corpus, tmp_path, case):
    """The scanned epoch against the per-step loop from the same weights,
    seed and draws, bit for bit: the logged lines of every step (the same
    metrics, the trimodal comparison among them), the epoch mean, every
    parameter, BatchNorm statistic, Adam moment, count and learning rate,
    the generator's final state. K 4 over 7 steps; K 2 over 3 steps with
    the fused pass, remat full, mixed precision, and an LR decay whose
    epoch boundaries fall inside the programs."""
    _, tds = corpus
    options, k, steps = OPTIONS[case]
    runs = []
    for spp in (1, k):
        t = _trainer(tds, tmp_path, f"{case}_{spp}", spp, **options)
        if case == "decay":
            t.step.cfg = t.gan_cfg = dataclasses.replace(t.gan_cfg, decay_steps_per_epoch=1)
        assert t.epoch_engine == ("scanned" if spp > 1 else "per_step")
        runs.append((t, t.per_train_epoch(max_iters=steps)))
    (t1, mean1), (tk, meank) = runs
    lines1, linesk = _iter_lines(t1.lines), _iter_lines(tk.lines)
    assert len(lines1) == steps and lines1 == linesk
    assert "s2ag_vs_trimodal_l1" in lines1[0] and mean1 == meank
    _assert_same_state(t1, tk)
    if case == "decay":
        lrs = [g["lr"] for g in tk.step.gen_opt.param_groups]
        assert lrs == [tk.gan_cfg.learning_rate * 0.5 ** steps]


@pytest.mark.parametrize("engine", ["per_step", "scanned"])
def test_metrics_lag_gives_the_same_log_lines(corpus, tmp_path, engine):
    """metrics_lag 0 (every program read at once) and 3 log the same
    lines, with either engine."""
    _, tds = corpus
    spp = 2 if engine == "scanned" else 1
    lines = []
    for lag in (0, 3):
        t = _trainer(tds, tmp_path, f"lag{lag}_{engine}", spp)
        t.metrics_lag = lag
        t.per_train_epoch(max_iters=5)
        lines.append(_iter_lines(t.lines))
        assert t.epoch_engine == engine
    assert len(lines[0]) == 5 and lines[0] == lines[1]


def test_checkpoint_after_scanned_epoch_resumes_per_step(corpus, tmp_path):
    """A checkpoint written after a scanned epoch loads into a per-step
    trainer with the same state (weights, BatchNorm statistics, Adam
    states, counts and learning rates), in the reference's Adam form; the
    next epoch from it, per step there and scanned in the trainer that
    wrote it, gives the same bits. The reverse, a per-step checkpoint into
    a scanned trainer, too."""
    _, tds = corpus
    cfg = TConfig(**WIDTHS)
    for first, then in ((4, 1), (1, 4)):
        work = tmp_path / f"ckpt_{first}"
        a = _trainer(tds, work, "run", first, cfg=cfg, lr_decay=0.5)
        a.epoch = 0
        a.per_train_epoch(max_iters=4)
        path = a.save_checkpoint(0.5)
        blob = torch.load(path, weights_only=True)
        for key in ("gen_optimizer_dict", "dis_optimizer_dict"):
            assert all(g["capturable"] is False and isinstance(g["lr"], float)
                       for g in blob[key]["param_groups"])
            assert all(s["step"].device.type == "cpu" and s["step"].dtype == torch.float32
                       for s in blob[key]["state"].values())
        b = _trainer(tds, work, "run", then, cfg=cfg, lr_decay=0.5)
        assert b.load_checkpoint(0)
        b.generator.set_state(a.generator.get_state())
        b.step.step = a.step.step
        _assert_same_state(a, b)
        for t in (a, b):
            t.epoch = 1
            t.lines.clear()
            t.per_train_epoch(max_iters=4)
        assert _iter_lines(a.lines) == _iter_lines(b.lines)
        _assert_same_state(a, b)


# ------------------------------------------- the capturable optimizers

@pytest.mark.parametrize("lr_decay,steps_per_epoch", [(0.5, 3), (0.97, 7), (0.999, 1)])
def test_scheduled_lr_tensor_equals_scheduled_lr(lr_decay, steps_per_epoch):
    """The learning rate computed from a count tensor (Adam's float32
    `step`, as a capturable optimizer keeps it) equals the host schedule's
    at every count, across the decay's epoch boundaries: the same float64,
    and so the same float32 rate."""
    cfg = tstep.GanConfig(lr_decay=lr_decay, decay_steps_per_epoch=steps_per_epoch)
    for count in range(4 * steps_per_epoch + 3):
        want = tstep.scheduled_lr(cfg.learning_rate, cfg, count)
        got = tstep.scheduled_lr_tensor(cfg.learning_rate, cfg,
                                        torch.tensor(float(count), dtype=torch.float32))
        assert got.dtype == torch.float64 and got.item() == want, (count, got.item(), want)
        assert got.float().item() == np.float32(want)


def test_capturable_optimizer_state_in_the_reference_form(corpus, tmp_path):
    """`GanStep.make_capturable` on a trainer with Adam state (3 host
    steps, the rate halving every 2 updates): the counts become float32
    tensors beside the parameters, the rates tensors that `sync_lr` sets
    from them to the host schedule's float32 rate; `reference_optimizer_state`
    writes the host optimizer's state dict back (the same moments and
    counts, `capturable` off, the rate a float within float32 rounding of
    the host's), and `load_optimizer_states` reads it into another
    trainer as the host optimizer's, rates the host schedule's exactly."""
    import copy

    _, tds = corpus
    a = _trainer(tds, tmp_path, "capturable", 1, lr_decay=0.5)
    a.step.cfg = a.gan_cfg = dataclasses.replace(a.gan_cfg, decay_steps_per_epoch=2)
    a.per_train_epoch(max_iters=3)
    host = {w: copy.deepcopy(getattr(a.step, f"{w}_opt").state_dict()) for w in ("gen", "dis")}
    a.step.make_capturable()
    for w in ("gen", "dis"):
        opt, want = getattr(a.step, f"{w}_opt"), host[w]
        base = a.gan_cfg.learning_rate if w == "gen" else a.gan_cfg.lr_dis
        host_lr = tstep.scheduled_lr(base, a.gan_cfg, 3)
        assert host_lr == want["param_groups"][0]["lr"] == base * 0.5
        for g in opt.param_groups:
            assert g["capturable"] and g["lr"].dtype == torch.float32
            assert g["lr"].item() == np.float32(host_lr)
        assert all(s["step"].dtype == torch.float32 and s["step"].item() == 3
                   for s in opt.state.values())
        ref = tstep.reference_optimizer_state(opt)
        assert ref["state"].keys() == want["state"].keys()
        for i, state in want["state"].items():
            assert ref["state"][i].keys() == state.keys()
            for k, v in state.items():
                assert torch.equal(ref["state"][i][k], v), (w, i, k)
                assert ref["state"][i][k].device == v.device and ref["state"][i][k].dtype == v.dtype
        for g, wg in zip(ref["param_groups"], want["param_groups"]):
            assert g["capturable"] is False and isinstance(g["lr"], float)
            assert g["lr"] == float(np.float32(wg["lr"]))
            assert {k: v for k, v in g.items() if k != "lr"} == \
                {k: v for k, v in wg.items() if k != "lr"}
    b = _trainer(tds, tmp_path, "loaded", 1, lr_decay=0.5)
    b.step.cfg = b.gan_cfg = a.gan_cfg
    b.step.load_optimizer_states(tstep.reference_optimizer_state(a.step.gen_opt),
                                 tstep.reference_optimizer_state(a.step.dis_opt))
    for w in ("gen", "dis"):
        got = getattr(b.step, f"{w}_opt").state_dict()
        for i, state in host[w]["state"].items():
            assert all(torch.equal(got["state"][i][k], v) for k, v in state.items())
        assert got["param_groups"] == host[w]["param_groups"]


# -------------------------------------------------------- engine record

def test_fallback_to_per_step_when_ineligible(corpus, tmp_path):
    """A trimodal interval > 1 cannot be fixed inside a program: K drops to
    1 and the per-step loop runs (JAX's own test of the same name)."""
    _, tds = corpus
    t = _trainer(tds, tmp_path, "fallback", 4, trimodal_metric_interval=2)
    assert t.steps_per_program == 1
    assert not t._use_scanned_epoch()


def test_epoch_engine_surfaced(corpus, tmp_path):
    _, tds = corpus
    ok = _trainer(tds, tmp_path, "ok", 2)
    assert ok.epoch_engine == "scanned" and ok.epoch_engine_fallback is None
    fb = _trainer(tds, tmp_path, "fb", 4, trimodal_metric_interval=2)
    assert fb.epoch_engine == "per_step"
    assert "fell back" in fb.epoch_engine_fallback


@pytest.mark.parametrize("spp,engine", [(4, "per_step"), (2, "scanned")])
def test_epoch_engine_in_log_line(corpus, tmp_path, spp, engine):
    _, tds = corpus
    t = _trainer(tds, tmp_path, f"log{spp}", spp,
                 trimodal_metric_interval=2 if engine == "per_step" else 1)
    t.log_interval = 10 ** 9
    t.per_train_epoch(max_iters=2)
    assert any(re.search(rf"train: .*engine {engine}\)$", ln) for ln in t.lines), t.lines


def test_loaders(corpus, tmp_path):
    """'grain' is not ported (it names ROADMAP.md); another name is an
    error, as in JAX."""
    _, tds = corpus
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _trainer(tds, tmp_path, "grain", loader="grain")
    with pytest.raises(ValueError, match="unknown loader"):
        _trainer(tds, tmp_path, "bogus", loader="bogus")


# ------------------------------------------------------ against JAX's

@pytest.fixture()
def no_draws(monkeypatch):
    """Both packages without random draws that differ between them: every
    dropout at zero (the configs' and the text encoders' embedding
    dropout, the discriminators'), z = mu, the diversity regularizer's
    other speakers the batch's ids rolled by one."""
    monkeypatch.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    monkeypatch.setattr(jgen_mod, "TextEncoderTCN",
                        functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    monkeypatch.setattr(jbuilder, "PoseGenerator",
                        functools.partial(jgen_mod.PoseGenerator, emb_dropout=0.0))
    monkeypatch.setattr(jbuilder, "AffDiscriminator", functools.partial(JDis, dropout_prob=0.0))
    monkeypatch.setattr(jstep, "draw_other_speaker_ids",
                        lambda key, vids, n: jnp.roll(vids, 1))
    monkeypatch.setattr(tgen_mod, "re_parametrize", lambda mu, log_var, eps: mu)
    monkeypatch.setattr(tgen_mod, "PoseGenerator",
                        functools.partial(tgen_mod.PoseGenerator, emb_dropout=0.0))
    monkeypatch.setattr(tbuilder, "PoseGeneratorTriModal",
                        functools.partial(tgen_mod.PoseGeneratorTriModal, emb_dropout=0.0))
    monkeypatch.setattr(tbuilder, "AffDiscriminator", functools.partial(TDis, dropout_prob=0.0))
    monkeypatch.setattr(tstep, "draw_other_speaker_ids",
                        lambda g, vids, n: torch.roll(vids, 1))


def test_scanned_epoch_matches_jax_scanned_epoch(corpus, tmp_path, no_draws):
    """The port's scanned epoch (K 4 over 7 steps) against JAX's
    (`Trainer(steps_per_program=4)`, its lax.scan program) from JAX's
    initial weights, at JAX's tolerances between its own two engines."""
    jds, tds = corpus
    jt = JTrainer(JConfig(**WIDTHS, dropout_prob=0.0), str(tmp_path / "jax"),
                  train_data=jds, seed=3, steps_per_program=4, metrics_lag=3)
    st = jax.device_get(jt.state)
    tt = _trainer(tds, tmp_path, "port", 4, cfg=TConfig(**WIDTHS, dropout_prob=0.0))
    for who, mapper in (("gen", from_jax.pose_generator), ("dis", from_jax.aff_discriminator),
                        ("tri", from_jax.pose_generator_trimodal)):
        from_jax.load_jax(getattr(tt, who), mapper,
                          {"params": getattr(st, f"{who}_params"),
                           "batch_stats": getattr(st, f"{who}_stats")})
    jt.epoch = 1
    jlines = []
    jt.logger.print_log = jlines.append
    assert jt._use_scanned_epoch() and tt.epoch_engine == "scanned"
    jmean = jt.per_train_epoch(log_interval=1, max_iters=7)
    tmean = tt.per_train_epoch(max_iters=7)
    want, got = _parse_iter_metrics(jlines), _parse_iter_metrics(tt.lines)
    assert sorted(want) == sorted(got) == list(range(7))
    assert set(want[0]) == set(got[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-3, atol=1e-4,
                                   err_msg=f"iter0 {k}")
    for i in range(1, 7):
        np.testing.assert_allclose(got[i]["s2ag_l1"], want[i]["s2ag_l1"], rtol=5e-2,
                                   err_msg=f"iter{i}")
    np.testing.assert_allclose(tmean, jmean, rtol=5e-2, atol=5e-3)
