"""The port's evaluation path on the CPU against the JAX package: the FGD
embedding net, the evaluator's scores, the test-split metrics, the
embedding trainer, `Trainer.generate_gestures` and `main_v2`'s evaluation.

Tolerances, all float32 with sums in another order:
- the embedding net in eval mode 2e-6 absolute (features and
  reconstructions of order 1 through seven layers); in train mode 1e-5
  absolute, and its BN running stats within 1e-5 of each value plus 1e-5
  of the tensor's largest: batch statistics over 6 windows amplify float32
  rounding;
- the Fréchet distance and feat_dist on the same features: the same numpy
  and scipy code on both sides, equal to 1e-12 relative;
- the L1, joint MAE and acceleration metrics 1e-6 relative (means of a
  few thousand float32 values);
- the embedding trainer: both steps' losses 1e-5 relative, step 1's Adam
  first moments within 1e-4 of each tensor's largest value (a bias ahead
  of a train-mode batch norm has a zero gradient up to float noise and is
  held to the model's largest moment instead), the BN running stats as in
  train mode, but the running means after step 2 within 2e-5 absolute
  (see `test_two_embedding_train_steps_match_jax`);
- `generate_gestures` at hidden 16: the generated poses 5e-5 absolute (the
  generator's serving tolerance), the metrics 1e-4 relative, FGD 1e-3
  relative (a distance between two Gaussian fits of 32-d features of a few
  windows, whose covariances are close to singular).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch import train_embedding as ttrain_embedding
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.models.embedding_net import EmbeddingNet as TNet
from speech2affective_gestures_torch.train import embedding_trainer as tet
from speech2affective_gestures_torch.train import evaluator as tev
from speech2affective_gestures_torch.train import losses as tlosses
from speech2affective_gestures_torch.train.trainer import Trainer as TTrainer
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data import ted_db as jdb
from speech2affective_gestures_tpu.models import embedding_net as jemb
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.train import embedding_trainer as jet
from speech2affective_gestures_tpu.train import evaluator as jev
from speech2affective_gestures_tpu.train import losses as jlosses
from speech2affective_gestures_tpu.train.trainer import Trainer as JTrainer


def _poses(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, 34, 27)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_net():
    net = jemb.EmbeddingNet(mode="pose")
    x = _poses(2, 0)
    variables = jax.jit(net.init)({"params": jax.random.key(0), "noise": jax.random.key(1)},
                                  None, None, x[:, :4], x)
    return net, jax.device_get(variables)


def _port_net(variables):
    net = TNet()
    from_jax.load_jax(net, from_jax.embedding_net_pose, variables)
    return net


def _close_scaled(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol * np.abs(want).max(), err_msg=name)


# ------------------------------------------------------------- the net

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_embedding_net_matches_jax(jax_net, train):
    """Features (z = mu) and reconstructions; in train mode also the BN
    running stats the forward updates."""
    net, variables = jax_net
    x = _poses(6, 1)
    if train:
        out, mut = net.apply(variables, None, None, x[:, :4], x, train=True,
                             mutable=["batch_stats"])
        new_stats = jax.device_get(mut["batch_stats"])
    else:
        out = net.apply(variables, None, None, x[:, :4], x, train=False)
    tnet = _port_net(variables).train(train)
    feat, mu, log_var, recon = tnet(torch.from_numpy(x))
    tol = 1e-5 if train else 2e-6
    for name, got, want in (("feat", feat, out[3]), ("mu", mu, out[4]),
                            ("log_var", log_var, out[5]), ("recon", recon, out[6])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                                   rtol=0, err_msg=name)
    if train:
        want = from_jax.embedding_net_pose({"params": variables["params"],
                                            "batch_stats": new_stats})
        state = tnet.state_dict()
        names = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(names) == 2 * 8
        for k in names:
            _close_scaled(state[k].numpy(), want[k], 1e-5, k)


def test_embedding_net_keys_are_the_reference_checkpoints():
    """The keys JAX's reader of the reference's embedding_net.pth.tar
    expects, and only those; speech mode adds the context encoder's."""
    from speech2affective_gestures_tpu.convert import torch_ckpt

    sd = {k: v.numpy() for k, v in TNet().state_dict().items()}
    params, stats = torch_ckpt.embedding_net_pose(sd)
    assert set(params) == {"pose_encoder", "decoder"}
    # speech mode builds, with the reference's key groups beside these
    speech = {k.split(".")[0] for k in TNet(mode="speech").state_dict()}
    assert speech == {"context_encoder", "pose_encoder", "decoder"}


def test_port_checkpoint_loads_in_jax_evaluator(tmp_path, jax_net):
    """A `.pth.tar` the port writes (`module.` prefixes as DataParallel
    leaves them) loads in JAX's `from_torch_checkpoint` and gives the
    port's features; the port's reader loads it strict."""
    tnet = _port_net(jax_net[1])
    path = tmp_path / "emb.pth.tar"
    torch.save({"embedding_dict": {f"module.{k}": v for k, v in tnet.state_dict().items()}},
               path)
    x = _poses(5, 2)
    want_feat, want_recon = jev.EmbeddingSpaceEvaluator.from_torch_checkpoint(str(path))._embed(
        jnp.asarray(x))
    port = tev.EmbeddingSpaceEvaluator.from_torch_checkpoint(str(path), device="cpu")
    _, feat, recon = port._embed(x)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=2e-6, rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon), atol=2e-6, rtol=0)


# ---------------------------------------------------------- the scores

def _feature_sets():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 32)).astype(np.float32)
    b = (rng.standard_normal((40, 32)) * 0.8 + 0.2).astype(np.float32)
    # rank-deficient: 8 samples of 32-d features, singular covariances
    c = rng.standard_normal((8, 32)).astype(np.float32)
    d = rng.standard_normal((8, 32)).astype(np.float32)
    return {"full_rank": (a, b), "rank_deficient": (c, d)}


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient"])
def test_frechet_distance_matches_jax(case):
    a, b = _feature_sets()[case]
    assert tev.EmbeddingSpaceEvaluator.frechet_distance(a, b) == pytest.approx(
        jev.EmbeddingSpaceEvaluator.frechet_distance(a, b), rel=1e-12)
    mu1, mu2 = a.mean(0), b.mean(0)
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    got = tev.EmbeddingSpaceEvaluator.calculate_frechet_distance(mu1, s1, mu2, s2)
    want = jev.EmbeddingSpaceEvaluator.calculate_frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["eps_branch", "imaginary"])
def test_frechet_distance_branches_match_jax(monkeypatch, case):
    """A rank-deficient (nilpotent) covariance has no square root: sqrtm
    comes back non-finite and both take the root again with eps on the
    diagonal. A root with a large imaginary diagonal raises in both, and
    `frechet_distance` maps that to the reference's 1e10."""
    from scipy import linalg

    calls = []
    real = linalg.sqrtm

    def counting(m, *args, **kw):
        calls.append(m.shape)
        return real(m, *args, **kw)

    monkeypatch.setattr(linalg, "sqrtm", counting)
    mu = np.zeros(2)
    s1 = np.array([[0.0, 1.0], [0.0, 0.0]]) if case == "eps_branch" else np.diag([-1.0, 1.0])
    results = []
    for cls in (tev.EmbeddingSpaceEvaluator, jev.EmbeddingSpaceEvaluator):
        if case == "eps_branch":
            with np.errstate(all="ignore"):
                results.append(cls.calculate_frechet_distance(mu, s1, mu, np.eye(2)))
        else:
            with pytest.raises(ValueError, match="Imaginary"):
                cls.calculate_frechet_distance(mu, s1, mu, np.eye(2))

            def raise_(*a):
                raise ValueError("Imaginary component")

            monkeypatch.setattr(cls, "calculate_frechet_distance", staticmethod(raise_))
            results.append(cls.frechet_distance(np.eye(3, 2), np.eye(3, 2)))
    if case == "eps_branch":
        assert len(calls) == 4 and np.isfinite(results[0])
        assert results[0] == pytest.approx(results[1], rel=1e-12)
    else:
        assert results == [1e10, 1e10]


def test_fgd_without_scipys_disp_flag(monkeypatch):
    """Newer scipy's sqrtm takes no `disp` flag and returns the root alone;
    the distance is the same."""
    from scipy import linalg

    a, b = _feature_sets()["full_rank"]
    want = tev.EmbeddingSpaceEvaluator.frechet_distance(a, b)
    real = linalg.sqrtm
    monkeypatch.setattr(linalg, "sqrtm", lambda m: real(m, disp=False)[0])
    assert tev.EmbeddingSpaceEvaluator.frechet_distance(a, b) == want


def test_get_scores_matches_jax(jax_net):
    """push_samples then get_scores on the same weights and poses: the
    features agree, and so do FGD and feat_dist."""
    net, variables = jax_net
    j = jev.EmbeddingSpaceEvaluator(variables)
    t = tev.EmbeddingSpaceEvaluator(_port_net(variables), device="cpu")
    for seed in (4, 5):
        gen, real = _poses(12, seed), _poses(12, seed + 10)
        j.push_samples(gen, real)
        t.push_samples(torch.from_numpy(gen), real)
    assert t.get_no_of_samples() == j.get_no_of_samples() == 24
    np.testing.assert_allclose(np.vstack(t.generated_feat_list),
                               np.vstack(j.generated_feat_list), atol=2e-6, rtol=0)
    np.testing.assert_allclose(t.recon_err_diff, j.recon_err_diff, atol=1e-6, rtol=0)
    (fgd, fd), (jfgd, jfd) = t.get_scores(), j.get_scores()
    assert fgd == pytest.approx(jfgd, rel=1e-4) and fd == pytest.approx(jfd, rel=1e-5)
    t.reset()
    assert t.get_no_of_samples() == 0


def test_push_sample_metrics_matches_jax():
    target, out = _poses(5, 6), _poses(5, 7)
    mean = JConfig().mean_dir_vec_array
    jm = [jlosses.AverageMeter(k) for k in ("l", "m", "a")]
    tm = [tlosses.AverageMeter(k) for k in ("l", "m", "a")]
    jev.push_sample_metrics(target, out, mean, *jm)
    tev.push_sample_metrics(target, torch.from_numpy(out), mean, *tm)
    for got, want in zip(tm, jm):
        assert got.avg == pytest.approx(want.avg, rel=1e-6) and got.count == want.count == 5


# ----------------------------------------------------- embedding trainer

def _moment_err(got_m, want_m):
    top = max(np.abs(v).max() for v in want_m.values())
    errs = []
    for k, w in want_m.items():
        scale = np.abs(w).max()
        errs.append((np.abs(got_m[k] - w).max() / (scale if scale >= 1e-4 * top else top), k))
    return max(errs)


STEP2_MEAN_ATOL = 2e-5


def test_two_embedding_train_steps_match_jax(jax_net):
    """Two Adam steps of `embedding_train_step` against JAX's
    `make_embedding_train_step` from the same weights and batches. After
    step 1 the BN running stats and Adam's first moments; after step 2 the
    loss, the running variances, and the running means within STEP2_MEAN_ATOL:
    a bias whose shift a later batch norm removes (the convolution's and
    linear layer's ahead of each, and the encoder's last convolution's) has
    a float-noise gradient, so its first Adam step (about lr sign(g))
    differs between the two, and the shift enters the next running means
    as 0.1 of it (at most 5.4e-6 measured here)."""
    import optax

    net, variables = jax_net
    tx = optax.adam(5e-4)
    state = jet.EmbedTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                stats=variables["batch_stats"],
                                opt=tx.init(variables["params"]))
    step = jet.make_embedding_train_step(net, tx)
    tnet = _port_net(variables)
    opt = torch.optim.Adam(tnet.parameters(), lr=5e-4)
    for i, seed in enumerate((20, 21)):
        x = _poses(8, seed)
        state, want = step(state, jnp.asarray(x), jax.random.key(i))
        got = tet.embedding_train_step(tnet, opt, torch.from_numpy(x))
        assert float(got) == pytest.approx(float(want), rel=1e-5)
        want_sd = from_jax.embedding_net_pose({"params": jax.device_get(state.params),
                                               "batch_stats": jax.device_get(state.stats)})
        got_sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
        for k in [k for k in got_sd if k.endswith(("running_mean", "running_var"))]:
            if i == 1 and k.endswith("running_mean"):
                np.testing.assert_allclose(got_sd[k], want_sd[k], rtol=0,
                                           atol=STEP2_MEAN_ATOL, err_msg=k)
            else:
                _close_scaled(got_sd[k], want_sd[k], 1e-5, k)
        if i == 0:
            mu = from_jax.embedding_net_pose({"params": jax.device_get(state.opt[0].mu),
                                              "batch_stats": variables["batch_stats"]})
            names = dict(tnet.named_parameters())
            want_m = {k: mu[k] for k in names}
            # fc_log_var has no gradient without variational encoding: torch
            # keeps no state for it, optax a zero moment
            got_m = {k: opt.state[p]["exp_avg"].numpy() if p in opt.state
                     else np.zeros(p.shape, np.float32) for k, p in names.items()}
            err, where = _moment_err(got_m, want_m)
            assert err <= 1e-4, (err, where)


def test_train_pose_embedding_and_cli(tmp_path):
    """The trainer's losses fall on the synthetic corpus's windows, and
    the CLI writes a `{"embedding_dict": ...}` file that the evaluator
    loads strict; with `--base-path` it trains on the train split of a
    TED LMDB layout there (pyarrow-0.14 blobs of raw videos)."""
    out = tmp_path / "emb.pth.tar"
    result = ttrain_embedding.main(["--synthetic-data", "--device", "cpu", "--epochs", "3",
                                    "--out", str(out)])
    assert len(result["losses"]) == 3 and np.isfinite(result["losses"]).all()
    assert result["losses"][-1] < result["losses"][0]
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {"embedding_dict"}
    ev = tev.EmbeddingSpaceEvaluator.from_torch_checkpoint(str(out), device="cpu")
    assert not ev.net.training
    from speech2affective_gestures_tpu.data import legacy_arrow as jla
    from speech2affective_gestures_tpu.data import lmdb_lite as jlmdb

    videos = jdb.make_synthetic_videos(3, 6.0)
    for split, vids in (("train", videos[:2]), ("val", videos[2:]), ("test", videos[2:])):
        jlmdb.write_env(str(tmp_path / "ted" / getattr(TConfig(), f"{split}_data_path")),
                        [(f"{i:010}".encode(), jla.serialize_legacy(v))
                         for i, v in enumerate(vids)])
    ted = ttrain_embedding.main(["--base-path", str(tmp_path / "ted"), "--device", "cpu",
                                 "--epochs", "1", "--out", str(tmp_path / "ted.pth.tar")])
    n_train = tdb.load_ted_db_data(str(tmp_path / "ted"), TConfig())["train"].n_samples
    assert n_train == 10 and np.isfinite(ted["losses"]).all()
    assert (tmp_path / "ted.pth.tar").is_file()
    again = tet.train_pose_embedding(_poses(10, 8), epochs=2, batch_size=4, device="cpu",
                                     variational=True)
    assert np.isfinite(again["losses"]).all()


# ------------------------------------------------------ generate_gestures

HID, EMB = 16, 16


@pytest.fixture(scope="module")
def test_split():
    tcfg = TConfig.from_yaml("config/multimodal_context_v2.yml", wordembed_dim=EMB)
    return tdb.build_dataset_from_videos(tdb.make_synthetic_videos(2, 5.0), tcfg)


def test_generate_gestures_matches_jax(tmp_path, test_split, jax_net, monkeypatch):
    """The same weights, test split and speakers, the speaker noise removed
    in both (JAX's z = mu, the port's eps = 0): generated poses, L1, joint
    MAE, accel, FGD and feat_dist."""
    monkeypatch.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    kw = dict(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB)
    ds = test_split
    jds = jdb.PackedDataset(**{k: getattr(ds, k) for k in (
        "extended_word_seq", "vec_seq", "audio", "audio_max", "mfcc_features",
        "vid_indices")}, speaker_model=ds.speaker_model, lang_model=ds.lang_model)
    jt = JTrainer(JConfig.from_yaml("config/multimodal_context_v2.yml", **kw),
                  str(tmp_path / "jax"), test_data=jds, seed=1,
                  evaluator=jev.EmbeddingSpaceEvaluator(jax_net[1]))
    tt = TTrainer(TConfig.from_yaml("config/multimodal_context_v2.yml", **kw),
                  str(tmp_path / "port"), test_data=ds, seed=1, device="cpu",
                  evaluator=tev.EmbeddingSpaceEvaluator(_port_net(jax_net[1]), device="cpu"))
    st = jax.device_get(jt.state)
    for model, mapper, who in ((tt.gen, from_jax.pose_generator, "gen"),
                               (tt.dis, from_jax.aff_discriminator, "dis")):
        from_jax.load_jax(model, mapper, {"params": getattr(st, f"{who}_params"),
                                          "batch_stats": getattr(st, f"{who}_stats")})
    pushed = {"jax": [], "port": []}
    for name, ev in (("jax", jt.evaluator), ("port", tt.evaluator)):
        real_push = ev.push_samples
        monkeypatch.setattr(ev, "push_samples", functools.partial(
            lambda real_push, store, g, r: (store.append(np.asarray(g)), real_push(g, r)),
            real_push, pushed[name]))
    n = ds.n_samples
    assert n >= 8
    want = jt.generate_gestures(batch_size=6, randomized=True, seed=3, full_test=True)
    got = tt.generate_gestures(batch_size=6, randomized=True, seed=3, full_test=True,
                               eps=np.zeros((n, 16)))
    assert len(pushed["port"]) == len(pushed["jax"]) == -(-n // 6)
    np.testing.assert_allclose(np.vstack(pushed["port"]), np.vstack(pushed["jax"]),
                               atol=5e-5, rtol=0)
    assert set(got) == set(want) == {"l1", "joint_mae", "accel", "FGD", "feat_dist"}
    for k in ("l1", "joint_mae", "accel", "feat_dist"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["FGD"] == pytest.approx(want["FGD"], rel=1e-3)
    log = (tmp_path / "port" / "log.txt").read_text()
    assert "eval: l1: " in log and "| FGD: " in log


def test_generate_gestures_raises_when_nothing_is_scored(tmp_path, test_split):
    cfg = TConfig.from_yaml("config/multimodal_context_v2.yml", hidden_size=HID,
                            hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB)
    tt = TTrainer(cfg, str(tmp_path), test_data=test_split.subset(np.arange(0)), device="cpu")
    with pytest.raises(RuntimeError, match="scored 0 samples"):
        tt.generate_gestures(batch_size=4)


# --------------------------------------------------------------- main_v2

@pytest.mark.parametrize("with_fgd", [True, False], ids=["fgd", "no_fgd"])
def test_main_v2_scores_the_test_split(tmp_path, with_fgd):
    import yaml

    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=HID, hidden_size_s2eg=HID, n_layers=1, wordembed_dim=EMB,
               random_seed=3)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    argv = ["-b", str(tmp_path / "base"), "-c", str(cfg_path), "--synthetic-data", "true",
            "--device", "cpu", "--batch-size", "4", "--s2ag-num-epoch", "1",
            "--synthetic-videos", "2", "--synthetic-seconds", "6"]
    if with_fgd:
        emb = tmp_path / "emb.pth.tar"
        net = tev.EmbeddingSpaceEvaluator.random_init(seed=2, device="cpu").net
        torch.save({"embedding_dict": net.state_dict()}, emb)
        argv += ["--embedding-net-checkpoint", str(emb)]
    trainer = tmain.main(argv)
    log = (tmp_path / "base/models/s2ag_v2_mfcc_torch/ted_db/log.txt").read_text()
    [line] = [x for x in log.splitlines() if "eval: " in x]
    values = dict(tok.split(": ") for tok in line.split("eval: ")[1].split(" | "))
    want = {"l1", "joint_mae", "accel"} | ({"FGD", "feat_dist"} if with_fgd else set())
    assert set(values) == want
    assert np.isfinite([float(v) for v in values.values()]).all()
    assert (trainer.evaluator is not None) == with_fgd
