"""The port's data-parallel training on the CPU over gloo: two ranks
against one process on the same global batch, and against the JAX
package's 2-device data mesh (the twin of `__graft_entry__.dryrun_multichip`'s
data-mesh part and of tests/test_multihost.py).

A module fixture spawns the two ranks once (`parallel.mesh.launch`, one
torch thread each, its own timeout); they run every scenario of
tests/_data_parallel_worker.py, which imports no JAX, and write the
results to a tmp dir, and the cases below read them. The one-process runs
and JAX's run in this process. Widths: hidden 16/32, 2 GRU layers, global
batch 8, dropout 0.3 with the step generator's own draws (the noise, the
masks and the diversity regularizer's permutation drawn over the global
batch).

Tolerances:
- float64, two ranks against one process: the metrics, both Adams'
  moments and the BatchNorm running stats after step 1 within 1e-9. The
  weights within 1e-9 plus what Adam makes of the moments' difference: a
  gradient far below Adam's eps (1e-8) moves its parameter by lr g / eps,
  and the bias of a convolution that a BatchNorm follows has the exact
  gradient 0, so rounding noise (4e-14 here, two ranks or one) moves it
  by up to 4e-9 at step 1. So each tensor may differ by 2 lr / eps times
  its first moments' largest difference, summed over the steps (m-hat is
  2 m at step 1, and below that after), and after step 2 the running
  means by 0.271 of the largest such allowance of step 1, which the
  biases pass on (`RUNNING_MEAN_SHARE`);
- float32: JAX's own bounds between its data mesh and one device
  (tests/test_mesh_2d.py:61-116): metrics rtol 1e-3, atol 1e-5; weights
  rtol 1e-4, atol 1.1e-3 after step 1 (2 lr: Adam's first step flips the
  sign of a near-zero gradient, as that of a bias a BatchNorm follows),
  2.1e-3 after step 2 (2 lr a step); BatchNorm stats rtol 5e-3, atol
  1e-4, the running means after step 2 plus 0.271 of step 1's 2 lr;
- against JAX's 2-device data mesh: tests/test_torch_train.py's batch seeds
  (11, 12) and tolerances (metrics rtol 1e-4 at step 1, 1e-3 at step 2,
  atol 1e-6; the generator's BN stats after step 1 within 1e-4 of their
  magnitude plus 1e-4 of each tensor's largest), every dropout at 0, the
  noise 0 and the diversity regularizer's speakers fixed on both sides;
- the ranks: the same bits (weights, buffers, Adam states, generator).
"""

import functools
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _data_parallel_worker as W
from speech2affective_gestures_torch import main_v2 as tmain
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.models.discriminator import AffDiscriminator as TDis
from speech2affective_gestures_torch.models.generator import (PoseGenerator as TGen,
                                                                 PoseGeneratorTriModal as TTri)
from speech2affective_gestures_torch.parallel import mesh as P
from speech2affective_gestures_torch.train.evaluator import EmbeddingSpaceEvaluator
from speech2affective_gestures_torch.train.trainer import Trainer as TTrainer
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.models.discriminator import AffDiscriminator as JDis
from speech2affective_gestures_tpu.parallel import mesh as jmesh
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import gan_step as jstep

RANKS = 2
LAUNCH_TIMEOUT = 300
LR, ADAM_EPS = 5e-4, 1e-8
# the share of a running mean that a step's three train-mode forwards of a
# net (BatchNorm momentum 0.1 each) take from its batches: a bias that a
# BatchNorm follows shifts the batch mean, and so the running mean, by
# its own difference times this
RUNNING_MEAN_SHARE = 1 - 0.9 ** 3
F64_TOL = 1e-9
STEP_SEEDS = (11, 12)
SCENARIOS = [f"steps_{m}_{d}" for d in ("float64", "float32") for m, _ in W.MODES]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def deterministic_jax():
    """z = mu, and the TriModal's embedding dropout at 0, on the JAX side
    (as tests/test_torch_train.py)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))
    yield
    mp.undo()


def _jax_batches():
    out = []
    for seed in STEP_SEEDS:
        b = jbuilder.synthetic_batch(np.random.default_rng(seed), len(W.DIV_IDS), JConfig(),
                                     30, 5)
        b["vid_indices"] = np.array([0, 1, 2, 3], np.int32)
        out.append(b)
    return out


def _jax_models():
    """JAX's modules and variables at tests/test_torch_train.py's widths,
    initialized with a jitted init."""
    b = _jax_batches()[0]
    pre = np.asarray(jstep.build_pre_seq(jnp.asarray(b["vec_seq"]), C.N_PRE_POSES))
    text, vids = jnp.asarray(b["extended_word_seq"]), jnp.asarray(b["vid_indices"])
    gen = jgen_mod.PoseGenerator(emb_dropout=0.0, **W.JAX_KW)
    dis = JDis(hidden_size=16, dropout_prob=0.0)
    tri = jgen_mod.PoseGeneratorTriModal(**W.JAX_KW)
    keys = jax.random.split(jax.random.key(0), 4)
    rngs = lambda k: {"params": k, "noise": keys[3]}  # noqa: E731
    gv = jax.jit(gen.init)(rngs(keys[0]), pre, text, jnp.asarray(b["mfcc_features"]), vids)
    dv = jax.jit(dis.init)(keys[1], jnp.asarray(b["vec_seq"]))
    tv = jax.jit(tri.init)(rngs(keys[2]), pre, text, jnp.asarray(b["audio"]), vids)
    return dict(gen=gen, dis=dis, tri=tri, gen_vars=jax.device_get(gv),
                dis_vars=jax.device_get(dv), tri_vars=jax.device_get(tv))


def _write_inputs(work, jm) -> dict:
    """What the ranks read: the corpus (a synthetic train split and a
    test split of 7 rows), the frozen TriModal's weights, the JAX models'
    weights bridged to the port and the JAX comparison's batches."""
    videos = tdb.make_synthetic_videos(n_videos=2, clip_seconds=12.0, device="cpu")
    full = tdb.build_dataset_from_videos(videos, TConfig(**W.WIDTHS), device="cpu")
    corpus = {"train": full.subset(np.arange(16)), "test": full.subset(np.arange(16, 23))}
    with open(work / "corpus.pkl", "wb") as f:
        pickle.dump(corpus, f)
    t = TTrainer(TConfig(**W.WIDTHS), str(work / "tri"), test_data=full, device="cpu", seed=5)
    torch.save(t.tri.state_dict(), work / "trimodal.pt")
    nets = {"gen": TGen(emb_dropout=0.0, **W.JAX_KW),
            "dis": TDis(hidden_size=16, dropout_prob=0.0),
            "tri": TTri(emb_dropout=0.0, **W.JAX_KW)}
    for (name, net), mapper in zip(nets.items(), (from_jax.pose_generator,
                                                  from_jax.aff_discriminator,
                                                  from_jax.pose_generator_trimodal)):
        from_jax.load_jax(net, mapper, jm[f"{name}_vars"])
    torch.save({k: v.state_dict() for k, v in nets.items()}, work / "jax_weights.pt")
    np.savez(work / "jax_batches.npz", **{f"{i}/{k}": v for i, b in enumerate(_jax_batches())
                                          for k, v in b.items()})
    return corpus


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


def _jax_mesh_steps(jm) -> list:
    """JAX's `make_train_step` under its 2-device data mesh
    (`make_mesh(jax.devices()[:2])`, `data_parallel_step`) on the two
    batches, from the weights the ranks start from, the diversity
    regularizer's speakers DIV_IDS: (metrics, host state) after each
    step."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "draw_other_speaker_ids",
                   lambda key, vids, n: jnp.asarray(W.DIV_IDS, vids.dtype))
        cfg = jstep.GanConfig(loss_warmup=-1, n_speakers=5)
        train_step, _ = jstep.make_train_step(jm["gen"].apply, jm["dis"].apply, cfg,
                                              jm["tri"].apply)
        mesh = jmesh.make_mesh(jax.devices()[:RANKS])
        state = jmesh.replicate_state(
            jstep.create_train_state(jm["gen_vars"], jm["dis_vars"], cfg, jm["tri_vars"]),
            mesh)
        step = jmesh.data_parallel_step(train_step, mesh)
        for i, b in enumerate(_jax_batches()):
            state, metrics = step(state, jmesh.shard_batch(b, mesh), jax.random.key(i),
                                  gan_on=True)
            out.append(({k: float(v) for k, v in jax.device_get(metrics).items()},
                        jax.device_get(state)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_models):
    """({scenario: [rank 0's results, rank 1's]}, the corpus, the work
    dir, {scenario: one process's results, "jax": JAX's mesh steps}). The
    one-process runs and JAX's run here while the ranks run."""
    work = tmp_path_factory.mktemp("data_parallel")
    corpus = _write_inputs(work, jax_models)
    failed = []

    def run():
        try:
            P.launch(W.run_rank, RANKS, "gloo", args=(work,), timeout=LAUNCH_TIMEOUT)
        except BaseException as e:  # raised again below, in the test's thread
            failed.append(e)

    launcher = threading.Thread(target=run)
    launcher.start()
    try:
        ref = {s: W.run_steps(None, getattr(torch, s.split("_")[2]),
                              dict(W.MODES)[s.split("_")[1]]) for s in SCENARIOS}
        ref["program"] = W.run_steps(None, torch.float32, {}, program=True)
        ref["jax"] = _jax_mesh_steps(jax_models)
        ref["epoch"] = W.epoch_run(None, work, corpus, "epoch_one")
    finally:
        launcher.join()
    if failed:
        raise failed[0]
    names = {p.name.split("_", 1)[1][:-3] for p in work.glob("rank0_*.pt")}
    out = {n: [torch.load(work / f"rank{r}_{n}.pt", weights_only=False) for r in range(RANKS)]
           for n in names}
    return out, corpus, work, ref


# ------------------------------------------------------------ checks

def _max_diff(a: dict, b: dict) -> dict:
    return {k: (a[k].double() - b[k].double()).abs().max().item() for k in a}


def _adam_moment_diffs(got: dict, ref: dict) -> dict:
    """{net.param: largest first-moment difference} and the largest of
    every moment."""
    out, worst = {}, 0.0
    for net in ("gen", "dis"):
        for name, st in ref[f"{net}_adam"].items():
            o = got[f"{net}_adam"][name]
            d = {k: (o[k].double() - st[k].double()).abs().max().item()
                 for k in ("exp_avg", "exp_avg_sq")}
            out[f"{net}.{name}"] = d["exp_avg"]
            worst = max(worst, *d.values())
    return out, worst


def _is_bn_stat(k: str) -> bool:
    return k.endswith(("running_mean", "running_var"))


def _assert_float64(got: list, ref: list):
    allowance: dict = {}
    shift = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose([g["metrics"][k] for k in r["metrics"]],
                                   list(r["metrics"].values()), rtol=F64_TOL, atol=F64_TOL)
        m1, worst = _adam_moment_diffs(g, r)
        assert worst <= F64_TOL, (i, worst)
        for k, d in m1.items():
            allowance[k] = allowance.get(k, 0.0) + 2 * LR * d / ADAM_EPS
        for net in ("gen", "dis"):
            for k, d in _max_diff(g[net], r[net]).items():
                if _is_bn_stat(k):
                    tol = F64_TOL + (RUNNING_MEAN_SHARE * shift
                                     if k.endswith("running_mean") else 0)
                elif k.endswith("num_batches_tracked"):
                    tol = 0
                else:
                    tol = F64_TOL + allowance.get(f"{net}.{k}", 0.0)
                assert d <= tol, (i, net, k, d, tol)
        shift = max(allowance.values())


def _assert_float32(got: list, ref: list, first: int = 0):
    """Snapshots after steps first + 1, first + 2, ... within JAX's bounds
    (module docstring)."""
    for i, (g, r) in enumerate(zip(got, ref), start=first):
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, rtol=1e-3, atol=1e-5, err_msg=k)
        for net in ("gen", "dis"):
            for k, v in r[net].items():
                if k.endswith("num_batches_tracked"):
                    assert torch.equal(g[net][k], v), k
                    continue
                if _is_bn_stat(k):
                    rtol, atol = 5e-3, 1e-4
                    if k.endswith("running_mean"):
                        atol += RUNNING_MEAN_SHARE * 2 * LR * i
                else:
                    rtol, atol = 1e-4, 2 * LR * (i + 1) + 1e-4
                np.testing.assert_allclose(g[net][k].numpy(), v.numpy(), rtol=rtol, atol=atol,
                                           err_msg=f"{net}.{k}")


def _same_bits(a: dict, b: dict, where: str = "") -> list:
    """The names of the tensors that differ between two snapshots."""
    out = []
    for k, v in a.items():
        if isinstance(v, dict):
            out += _same_bits(v, b[k], f"{where}{k}.")
        elif isinstance(v, torch.Tensor):
            if not torch.equal(v, b[k]):
                out.append(where + k)
        elif v != b[k]:
            out.append(where + k)
    return out


# ------------------------------------------------------------- cases

def test_the_mesh_of_one_process_and_of_each_rank(ranks):
    """As JAX's: `initialize_distributed` is a no-op for one process and
    `make_mesh` forms no mesh without a group of two or more; in each rank
    it forms the launched group's."""
    P.initialize_distributed("tcp://localhost:1", 1, 0, "gloo")
    assert not torch.distributed.is_initialized() and P.make_mesh() is None
    assert ranks[0]["mesh"] == [(r, RANKS, "gloo") for r in range(RANKS)]


def test_batch_norm_takes_the_global_two_pass_statistics(ranks):
    """Each rank's rows of a train-mode BatchNorm1d's output over the
    global batch, the input's gradient and the running stats equal torch's
    one-process BatchNorm on the whole batch (1e-12), and its output is
    JAX's two-pass formula on the global batch, not the per-rank
    statistics'."""
    got = ranks[0]["bn"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 6, 5)) * 3 + 1)
    ref = W.bn_check(None)
    for key in ("y", "grad"):
        np.testing.assert_allclose(torch.cat([g[key] for g in got]).numpy(), ref[key].numpy(),
                                   atol=1e-12, err_msg=key)
    for g in got:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(g[key].numpy(), ref[key].numpy(), atol=1e-12)
    mean = x.mean((0, 2), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2), keepdim=True)
    two_pass = (x - mean) / torch.sqrt(var + 1e-5)
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), two_pass.numpy(),
                               atol=1e-12)
    half = x[:4]
    per_rank = (half - half.mean((0, 2), keepdim=True)) / torch.sqrt(
        half.var((0, 2), unbiased=False, keepdim=True) + 1e-5)
    assert (got[0]["y"] - per_rank).abs().max().item() > 1e-2


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_ranks_step_as_one_process(ranks, scenario):
    """Two GAN steps of two ranks against one process's on the same global
    batches, weights and generator seed, per step, fused and remat full,
    in float64 and float32 (the tolerances in the module docstring); the
    generators' states the same bits."""
    dtype = scenario.split("_")[2]
    ref = ranks[3][scenario]
    got = ranks[0][scenario][0]
    (_assert_float64 if dtype == "float64" else _assert_float32)(got, ref)
    for g, r in zip(got, ref):
        assert torch.equal(g["generator"], r["generator"])


@pytest.mark.parametrize("scenario", SCENARIOS + ["program", "jax", "epoch"])
def test_the_ranks_hold_the_same_bits(ranks, scenario):
    """After every step both ranks hold the same weights, BatchNorm stats,
    Adam states, generator state and metrics."""
    a, b = ranks[0][scenario]
    for i, (sa, sb) in enumerate(zip(a, b)):
        assert not _same_bits(sa, sb), (i, _same_bits(sa, sb)[:8])


def test_step_program_on_the_mesh_as_one_process(ranks):
    """The K-step program's body (run eagerly: gloo is not captured) on
    each rank's columns of the (K, B) draws, against one process's program
    on all of them after its last step: float32, JAX's bounds."""
    _assert_float32(ranks[0]["program"][0], ranks[3]["program"], first=W.N_STEPS - 1)


def test_trainer_epoch_on_the_mesh_as_one_process(ranks):
    """The trainer's per-step epoch with the device loader, each rank
    gathering its rows of each draw from its replica of the split, against
    one process's trainer epoch on the same split and seeds after its 2
    steps: float32, JAX's bounds."""
    _assert_float32(ranks[0]["epoch"][0], ranks[3]["epoch"], first=1)


def test_two_ranks_step_as_jax_data_mesh(ranks):
    """The two ranks' two GAN steps against JAX's `make_train_step` under
    its 2-device data mesh from the same weights and batches
    (`_jax_mesh_steps`): the metrics, and the generator's BatchNorm stats
    after step 1."""
    got = ranks[0]["jax"][0]
    for i, (want, host) in enumerate(ranks[3]["jax"]):
        assert set(got[i]["metrics"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[i]["metrics"][k], v, rtol=(1e-4, 1e-3)[i],
                                       atol=1e-6, err_msg=k)
        if i == 0:
            stats = from_jax.pose_generator({"params": host.gen_params,
                                             "batch_stats": host.gen_stats})
            names = [k for k in stats if _is_bn_stat(k)]
            assert names
            for k in names:
                want_k = np.asarray(stats[k])
                np.testing.assert_allclose(got[0]["gen"][k].numpy().reshape(want_k.shape),
                                           want_k, rtol=1e-4,
                                           atol=1e-4 * np.abs(want_k).max(), err_msg=k)


def test_generate_gestures_rounds_each_chunk_to_the_ranks(ranks, tmp_path):
    """Two ranks score a test split of 7 rows in chunks of 4: the last
    chunk is cut to 2 rows, rank 0 logs JAX's warning (one of 7 dropped),
    rank 1 logs nothing, and the scores (L1, joint MAE, accel, FGD,
    feat_dist; the noise from the trainer's generator) are one process's
    on the 6 rows kept (1e-5 relative)."""
    got, corpus, work, _ = ranks
    (r0, r1) = got["eval"]
    assert any("eval dropped 1 of 7 samples" in ln and "2-rank" in ln for ln in r0["lines"])
    assert not r1["lines"]
    assert r0["scores"] == r1["scores"]
    one = W.trainer(None, work, "eval_one", {"test_data": corpus["test"].subset(np.arange(6))},
                    evaluator=EmbeddingSpaceEvaluator.random_init(0, device="cpu"))
    want = one.generate_gestures(batch_size=4, full_test=True)
    assert set(want) == set(r0["scores"]) >= {"l1", "joint_mae", "accel", "FGD", "feat_dist"}
    for k, v in want.items():
        np.testing.assert_allclose(r0["scores"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert not any("dropped" in ln for ln in one.lines)


@pytest.mark.parametrize("loader", ["device", "grain"])
def test_resumed_two_rank_run_equals_the_uncut_one(ranks, loader):
    """Two ranks resumed from a checkpoint and its data-state file (the
    device loader after epoch 0, grain in the middle of epoch 1) by
    trainers built with another seed hold the uncut run's bits: weights,
    BN stats, Adam states, generator, step count. Only rank 0 wrote the
    checkpoint."""
    for rank in range(RANKS):
        uncut, resumed = ranks[0]["resume"][rank][loader]
        assert not _same_bits(uncut, resumed), (rank, _same_bits(uncut, resumed)[:8])
    assert [r[f"{loader}_writes"] for r in ranks[0]["resume"]] == [1, 0]


@pytest.mark.parametrize("case", ["gloo", "odd batch"])
def test_scanned_epoch_falls_back_on_gloo_and_an_odd_batch(ranks, case):
    """`--steps-per-program 2` on the gloo mesh runs one step at a time and
    says why (a CUDA graph cannot capture gloo's collectives); so does a
    batch of 7 over 2 ranks (JAX's tests/test_steps_per_program.py:126-132)."""
    assert ranks[0]["fallback"][0] == ranks[0]["fallback"][1]
    engine, k, reason = ranks[0]["fallback"][0][case]
    assert (engine, k) == ("per_step", 1)
    assert "fell back" in reason and "the mesh runs gloo" in reason
    if case == "odd batch":
        assert "batch size 7 over 2 ranks" in reason


def test_main_v2_with_multiple_gpus_on_the_cpu_stays_one_process(tmp_path, monkeypatch):
    """`--use-multiple-gpus true` with `--device cpu` trains in this process:
    no rank is launched, and the trainer has no mesh."""
    import yaml

    def no_launch(*args, **kw):
        raise AssertionError("main_v2 launched ranks on the CPU")

    monkeypatch.setattr(P, "launch", no_launch)
    raw = yaml.safe_load(open("config/multimodal_context_v2.yml"))
    raw.update(hidden_size=16, hidden_size_s2eg=16, n_layers=1, wordembed_dim=16,
               random_seed=3, loss_warmup=-1)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    trainer = tmain.main(["-b", str(tmp_path / "base"), "-c", str(cfg_path),
                          "--synthetic-data", "true", "--device", "cpu", "--batch-size", "4",
                          "--s2ag-num-epoch", "1", "--synthetic-videos", "2",
                          "--synthetic-seconds", "4", "--use-multiple-gpus", "true"])
    assert isinstance(trainer, TTrainer) and trainer.mesh is None
