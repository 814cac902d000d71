"""The port's 2-D (data, model) grid on the CPU over gloo: the GAN step
and the batched synthesis of four ranks on a 2 x 2 grid, against one
process and against the JAX package's 2 x 2 mesh (`make_mesh_2d`,
`shard_params_2d`, `data_parallel_step`; the twin of
`__graft_entry__.dryrun_multichip` and of tests/test_mesh_2d.py).

A module fixture spawns the four ranks once (`parallel.mesh.launch`, one
torch thread each, its own timeout); they run every scenario of
tests/_mesh_2d_worker.py, which imports no JAX, and write rank 0's
results (and every rank's digests of its own bits) to a tmp dir. The
one-process runs and JAX's run in this process meanwhile. Widths: hidden
32, 2 GRU layers, a 2048-word vocabulary (the text tables split by row),
global batch 8, tp_min_cols 96 (3H: G's, the TriModal's and D's GRU gates
split by column) or none.

Tolerances:
- float64, the grid against one process: tests/test_torch_data_parallel.py's
  (1e-9; the weights plus what Adam's eps makes of the moments'
  difference, the running means after step 2 that much more);
- against JAX's 2 x 2 mesh step, float32, every dropout 0, the noise 0
  and the diversity regularizer's speakers fixed on both sides:
  tests/test_mesh_2d.py's bounds (metrics rtol 1e-3, atol 1e-5; weights
  rtol 1e-4, atol 1.1e-3; the generator's BatchNorm stats rtol 5e-3,
  atol 1e-4);
- the sharded synthesis: 1e-4 absolute against JAX's sharded synthesis
  (tests/test_torch_serve.py's bound for the port's one-process batched
  synthesis against JAX's), 1e-6 against the port's one process.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mesh_2d_worker as W
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.convert import from_jax
from speech2affective_gestures_torch.models.discriminator import AffDiscriminator as TDis
from speech2affective_gestures_torch.models.generator import (PoseGenerator as TGen,
                                                                 PoseGeneratorTriModal as TTri)
from speech2affective_gestures_torch.parallel import mesh as P
from speech2affective_gestures_torch.train import builder as tbuilder
from speech2affective_gestures_torch.train import synthesis as tsyn
from speech2affective_gestures_tpu import constants as C
from speech2affective_gestures_tpu.config import ModelConfig as JConfig
from speech2affective_gestures_tpu.data.vocab import Vocab as JVocab
from speech2affective_gestures_tpu.models import encoders as jenc
from speech2affective_gestures_tpu.models import generator as jgen_mod
from speech2affective_gestures_tpu.models.discriminator import AffDiscriminator as JDis
from speech2affective_gestures_tpu.parallel import mesh as jmesh
from speech2affective_gestures_tpu.train import builder as jbuilder
from speech2affective_gestures_tpu.train import gan_step as jstep
from speech2affective_gestures_tpu.train import synthesis as jsyn
from test_torch_ablations import _fill
from test_torch_data_parallel import _assert_float64

RANKS = 4
LAUNCH_TIMEOUT = 400
JCFG = JConfig(hidden_size=32, hidden_size_s2eg=32, n_layers=2)
TCFG = TConfig(hidden_size_s2eg=32, n_layers=2)
KINDS = {(): "rep", ("model", None): "row", (None, "model"): "col"}
CODES = {"rep": 0, "row": 1, "col": 2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _deterministic_jax(mp: pytest.MonkeyPatch) -> None:
    """z = mu, and the TriModal's embedding dropout at 0, on the JAX side
    (as tests/test_torch_data_parallel.py)."""
    mp.setattr(jgen_mod, "re_parametrize", lambda mu, log_var, rng: mu)
    mp.setattr(jgen_mod, "TextEncoderTCN",
               functools.partial(jenc.TextEncoderTCN, emb_dropout=0.0))


def _jax_batch() -> dict:
    b = jbuilder.synthetic_batch(np.random.default_rng(11), len(W.DIV_IDS), JConfig(),
                                 W.N_WORDS, 5)
    b["vid_indices"] = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int32)
    return b


def _jax_nets(mp) -> dict:
    """JAX's G, D and TriModal at the worker's JAX_KW widths, their
    variables' shapes from `jax.eval_shape` of the inits filled with numpy
    draws (`_fill`; a jitted init would compile for tens of seconds)."""
    _deterministic_jax(mp)
    b = _jax_batch()
    pre = np.asarray(jstep.build_pre_seq(jnp.asarray(b["vec_seq"]), C.N_PRE_POSES))
    text, vids = jnp.asarray(b["extended_word_seq"]), jnp.asarray(b["vid_indices"])
    gen = jgen_mod.PoseGenerator(emb_dropout=0.0, **W.JAX_KW)
    dis = JDis(dropout_prob=0.0)
    tri = jgen_mod.PoseGeneratorTriModal(**W.JAX_KW)
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    shapes = (jax.eval_shape(gen.init, rngs, pre, text, jnp.asarray(b["mfcc_features"]), vids),
              jax.eval_shape(dis.init, rngs, jnp.asarray(b["vec_seq"])),
              jax.eval_shape(tri.init, rngs, pre, text, jnp.asarray(b["audio"]), vids))
    return dict(gen=gen, dis=dis, tri=tri, **{f"{who}_vars": _fill(shape, 30 + i) for i, (who, shape)
                                              in enumerate(zip(("gen", "dis", "tri"), shapes))})


def _jax_mesh_step(jm: dict, tp: bool) -> tuple:
    """JAX's `make_train_step` on its 2 x 2 mesh (`make_mesh_2d(2, 2)`,
    `shard_params_2d` with tp_min_cols 96 or none, `data_parallel_step`)
    on the batch, from the weights the ranks start from: (metrics, host
    state)."""
    with pytest.MonkeyPatch.context() as mp:
        _deterministic_jax(mp)
        mp.setattr(jstep, "draw_other_speaker_ids",
                   lambda key, vids, n: jnp.asarray(W.DIV_IDS, vids.dtype))
        cfg = jstep.GanConfig(loss_warmup=-1, n_speakers=5)
        train_step, _ = jstep.make_train_step(jm["gen"].apply, jm["dis"].apply, cfg,
                                              jm["tri"].apply)
        mesh = jmesh.make_mesh_2d(*W.GRID, jax.devices()[:RANKS])
        state = jmesh.shard_params_2d(
            jstep.create_train_state(jm["gen_vars"], jm["dis_vars"], cfg, jm["tri_vars"]),
            mesh, tp_min_cols=W.TP_COLS if tp else None)
        step = jmesh.data_parallel_step(train_step, mesh)
        state, metrics = step(state, jmesh.shard_batch(_jax_batch(), mesh), jax.random.key(0),
                              gan_on=True)
        return ({k: float(v) for k, v in jax.device_get(metrics).items()},
                jax.device_get(state))


def _synthesis_inputs(work) -> tuple:
    """JAX's generator at JAX_KW widths (its noise live; `_fill`'s
    weights), bridged for the ranks with JAX's per-window noise of each
    clip (replayed from the clip's key, as tests/test_torch_serve.py
    does): (the generator, its variables, the clips' keys)."""
    jgen = jgen_mod.PoseGenerator(**W.JAX_KW)
    zeros = (jnp.zeros((1, C.N_POSES, C.POSE_DIM + 1)), jnp.zeros((1, C.N_POSES), jnp.int32),
             jnp.zeros((1, C.NUM_MFCC_COMBINED, C.MFCC_LENGTH)), jnp.zeros((1,), jnp.int32))
    variables = _fill(jax.eval_shape(jgen.init, {"params": jax.random.key(0),
                                                 "noise": jax.random.key(1)}, *zeros), 40)
    tgen = TGen(**W.JAX_KW)
    from_jax.load_jax(tgen, from_jax.pose_generator, variables)
    torch.save(tgen.state_dict(), work / "jax_gen.pt")
    apply = jax.jit(jgen.apply)
    keys = [jax.random.key(10 + i) for i in range(len(W.CLIPS))]
    eps = []
    for key, (_, _, vid) in zip(keys, W.CLIPS):
        rows = []
        for _ in range(W.SYNTH_WINDOWS):
            key, sub = jax.random.split(key)
            _, z, mu, lv = jax.device_get(apply(variables, *zeros[:3], jnp.asarray([vid]),
                                                rngs={"noise": sub}))
            rows.append((z - mu) / np.exp(0.5 * lv))
        eps.append(np.concatenate(rows))
    np.save(work / "jax_eps.npy", np.stack(eps, axis=1).astype(np.float32))
    return jgen, variables, keys


def _jax_synthesis(jgen, variables, keys) -> list:
    """JAX's `synthesize_clips_batched(make_batched_clip_fn(..., mesh=),
    pad_to=2)` of the clips on its 2 x 2 mesh."""
    jv = JVocab("w")
    for w in ("hello", "world", "again"):
        jv.index_word(w)
    mesh = jmesh.make_mesh_2d(*W.GRID, jax.devices()[:RANKS])
    fn = jsyn.make_batched_clip_fn(jgen.apply, JCFG, mesh=mesh)
    return jsyn.synthesize_clips_batched(fn, variables, W.clips(), jv, JCFG,
                                         keys=jnp.stack(keys), pad_to=2,
                                         fade_out=[False, True, False])


def _write_inputs(work, jm: dict) -> None:
    nets = {"gen": TGen(emb_dropout=0.0, **W.JAX_KW), "dis": TDis(dropout_prob=0.0),
            "tri": TTri(emb_dropout=0.0, **W.JAX_KW)}
    for (name, net), mapper in zip(nets.items(), (from_jax.pose_generator,
                                                  from_jax.aff_discriminator,
                                                  from_jax.pose_generator_trimodal)):
        from_jax.load_jax(net, mapper, jm[f"{name}_vars"])
    torch.save({k: v.state_dict() for k, v in nets.items()}, work / "jax_weights.pt")
    np.savez(work / "jax_batch.npz", **_jax_batch())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(rank 0's results by scenario, every rank's digests, the
    references: one process's runs, JAX's mesh steps and synthesis). The
    ranks start first; this process writes what their JAX comparisons
    read (`W.READY` last, which they wait for), then runs the references
    while the ranks run."""
    work = tmp_path_factory.mktemp("mesh_2d")
    failed = []

    def run():
        try:
            P.launch(W.run_rank, RANKS, "gloo", args=(work,), timeout=LAUNCH_TIMEOUT)
        except BaseException as e:  # raised again below, in the test's thread
            failed.append(e)

    launcher = threading.Thread(target=run)
    launcher.start()
    ready = "failed"
    ref = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            jm = _jax_nets(mp)
        _write_inputs(work, jm)
        synthesis = _synthesis_inputs(work)
        ready = "ok"
    finally:
        (work / W.READY).write_text(ready)
    try:
        ref["jax synthesis"] = _jax_synthesis(*synthesis)
        ref["float64"] = W.run_steps(None, torch.float64)["snaps"]
        ref["clipped"] = W.run_steps(None, torch.float64, n_steps=1,
                                     options={"gradient_clip": W.CLIP})["snaps"]
        gen = TGen(**W.JAX_KW).eval()
        gen.load_state_dict(torch.load(work / "jax_gen.pt", weights_only=True))
        ref["one synthesis"] = tsyn.synthesize_clips_batched(
            gen, W.clips(), W.vocab(), TCFG, eps=torch.from_numpy(np.load(work / "jax_eps.npy")),
            pad_to=2, fade_out=[False, True, False])
        for tp in (True, False):
            ref[f"jax_{'tp' if tp else 'rows'}"] = _jax_mesh_step(jm, tp)
    finally:
        launcher.join()
    if failed:
        raise failed[0]
    got = {p.name[len("rank0_"):-3]: torch.load(p, weights_only=False)
           for p in work.glob("rank0_*.pt")}
    digests = [torch.load(work / f"rank{r}_digests.pt", weights_only=False)
               for r in range(RANKS)]
    return got, digests, ref


# ------------------------------------------------------------- cases

def test_grid_layout_and_the_grids_that_do_not_fit(ranks):
    """Rank r sits at (r // 2, r % 2); its data axis holds the ranks of
    its column, its model axis those of its row; a grid that does not
    cover the four ranks raises."""
    _, digests, _ = ranks
    for r, d in enumerate(digests):
        found = d["layout"]
        assert found["rank"] == found["flat"] == r
        assert found["data"] == (r // 2, 2) and found["model"] == (r % 2, 2)
        assert found["data ranks"] == [r % 2, r % 2 + 2]
        assert found["model ranks"] == [r // 2 * 2, r // 2 * 2 + 1]
        for shape in ((3, 2), (4, 2), (1, 2)):
            assert found[shape] == f"a {shape[0]} x {shape[1]} grid does not cover 4 ranks"


@pytest.mark.parametrize("tp", [None, W.TP_COLS])
def test_placement_is_jax_shard_params_2d(tp):
    """`placement` of G, D and the TriModal equals JAX `shard_params_2d`'s
    on its train state at the same widths, parameter by parameter through
    the bridges (each JAX leaf replaced by its placement's code), and
    JAX's Adam moments sit as their parameters do."""
    state = jbuilder.init_training(JCFG, jax.random.key(0), n_words=W.N_WORDS,
                                   n_speakers=W.N_SPK, abstract=True)["state"]
    placed = jmesh.shard_params_2d(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), state),
                                   jmesh.make_mesh_2d(*W.GRID, jax.devices()[:RANKS]),
                                   tp_min_cols=tp)
    spec = lambda x: tuple(x.sharding.spec)  # noqa: E731
    for net in ("gen", "dis"):
        params = getattr(placed, f"{net}_params")
        adam = getattr(placed, f"{net}_opt")[0]
        for moments in (adam.mu, adam.nu):
            assert jax.tree.leaves(jax.tree.map(lambda a, b: spec(a) == spec(b), moments,
                                                params)) == [True] * len(jax.tree.leaves(params))

    def codes(tree):
        return jax.tree.map(lambda x: np.full(x.shape, CODES[KINDS[spec(x)]], np.int8), tree)

    tgen, tdis, ttri = tbuilder.build_models(TConfig(**W.WIDTHS), W.N_WORDS, W.N_SPK)
    seen = set()
    for net, mapper, part in ((tgen, from_jax.pose_generator, "gen"),
                              (tdis, from_jax.aff_discriminator, "dis"),
                              (ttri, from_jax.pose_generator_trimodal, "tri")):
        bridged = mapper({"params": codes(getattr(placed, f"{part}_params")),
                          "batch_stats": codes(getattr(placed, f"{part}_stats"))})
        kinds = P.placement(net, W.GRID[1], tp_min_cols=tp)
        assert set(kinds) == {n for n, _ in net.named_parameters()}
        want = {n: [k for k, c in CODES.items() if c == int(bridged[n].flat[0])][0]
                for n in kinds}
        assert kinds == want, part
        seen |= {f"{part}.{k}" for k in kinds.values()}
    assert "gen.row" in seen and "tri.row" in seen
    assert ("gen.col" in seen and "dis.col" in seen) == (tp is not None)


@pytest.mark.parametrize("scenario", ["steps_tp", "steps_rows"])
def test_each_rank_keeps_its_slices(ranks, scenario):
    """Rank 0 holds half of each split parameter along its torch dim
    (the tables' rows; the GRU gates' output rows under tp) and Adam's
    moments of that half, and the whole of the rest."""
    got, _, _ = ranks
    cfg = TConfig(**W.WIDTHS)
    nets = dict(zip(("gen", "dis"), tbuilder.build_models(cfg, W.N_WORDS, W.N_SPK)))
    tp = W.TP_COLS if scenario == "steps_tp" else None
    n_split = 0
    for who, net in nets.items():
        kinds = P.placement(net, W.GRID[1], tp_min_cols=tp)
        for name, p in net.named_parameters():
            local, adam = got[scenario]["local"][f"{who}.{name}"]
            want = list(p.shape)
            if kinds[name] != "rep":
                embedding = name.endswith("embedding.weight")
                want[(kinds[name] == "row") != embedding] //= 2
                n_split += 1
            assert local == tuple(want), (who, name)
            assert {k: v for k, v in adam.items() if k != "step"} == {
                "exp_avg": tuple(want), "exp_avg_sq": tuple(want)}, (who, name)
    assert got[scenario]["local"]["gen.text_encoder.embedding.weight"][0] == (1024, 300)
    assert n_split == (1 + 8 + 16 if tp else 1)


@pytest.mark.parametrize("scenario", ["steps_tp", "steps_rows"])
def test_grid_steps_as_one_process(ranks, scenario):
    """Two float64 steps of the 2 x 2 grid against one process's on the
    same global batches, weights and generator seed (the module
    docstring's float64 tolerance); the generators' states the same
    bits."""
    got, _, ref = ranks
    _assert_float64(got[scenario]["snaps"], ref["float64"])
    for g, r in zip(got[scenario]["snaps"], ref["float64"]):
        assert torch.equal(g["generator"], r["generator"])


def test_clipped_grid_step_as_one_process(ranks):
    """A float64 step clipped at 0.1 on the grid (the norm over each
    slice once) against one process's clipped step."""
    got, _, ref = ranks
    _assert_float64(got["mutants"]["clipped"], ref["clipped"])


@pytest.mark.parametrize("name", W.MUTANTS)
def test_the_float64_check_fails_a_wrong_grid(ranks, name):
    """A grid step with a fault fails the float64 check: the split
    parameters' gradients summed over the model axis, BatchNorm's count
    over the world, or the clip counting each slice twice."""
    got, _, ref = ranks
    want = ref["clipped"] if name.startswith("clip") else ref["float64"][:1]
    with pytest.raises(AssertionError):
        _assert_float64(got["mutants"][name], want)


@pytest.mark.parametrize("scenario", ["steps_tp", "steps_rows"])
def test_the_data_ranks_hold_the_same_bits(ranks, scenario):
    """After each step the two ranks of each model slot (the data axis'
    ranks) hold the same bits: slices, replicated weights, buffers, Adam
    states and generator."""
    _, digests, _ = ranks
    for m in range(W.GRID[1]):
        assert digests[m][scenario] == digests[m + W.GRID[1]][scenario]
    assert digests[0][scenario] != digests[1][scenario]


@pytest.mark.parametrize("tp", ["tp", "rows"])
def test_grid_step_as_jax_mesh_step(ranks, tp):
    """One float32 step of the grid against JAX's step on its 2 x 2 mesh
    with the same placement, from the same weights and batch:
    tests/test_mesh_2d.py's bounds on the metrics, both nets' weights and
    the generator's BatchNorm stats."""
    got, _, ref = ranks
    mine = got[f"jax_{tp}"][0]
    metrics, host = ref[f"jax_{tp}"]
    assert set(mine["metrics"]) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(mine["metrics"][k], v, rtol=1e-3, atol=1e-5, err_msg=k)
    for who, mapper in (("gen", from_jax.pose_generator), ("dis", from_jax.aff_discriminator)):
        want = mapper({"params": getattr(host, f"{who}_params"),
                       "batch_stats": getattr(host, f"{who}_stats")})
        for k, v in mine[who].items():
            if k.endswith("num_batches_tracked"):
                continue
            stat = k.endswith(("running_mean", "running_var"))
            if stat and who == "dis":
                continue
            w = np.asarray(want[k])
            rtol, atol = (5e-3, 1e-4) if stat else (1e-4, 1.1e-3)
            np.testing.assert_allclose(v.numpy().reshape(w.shape), w, rtol=rtol, atol=atol,
                                       err_msg=f"{who}.{k}")


def test_mixed_precision_step_on_the_grid(ranks):
    """One mixed-precision step of the grid (tp on): finite metrics, and
    float32 master weights, the slices and the gathered whole alike."""
    got, _, _ = ranks
    mixed = got["mixed"]
    assert np.isfinite(list(mixed["metrics"].values())).all()
    assert set(mixed["metrics"]) >= {"dis", "loss", "gen", "g_total", "s2ag_l1"}
    assert mixed["local dtypes"] == mixed["whole dtypes"] == {"torch.float32"}


def test_the_split_table_moves_and_stays_split(ranks):
    """After a step the generator's word table has moved (the update
    reached the rows of both ranks' slices) and rank 0 still holds 1024 of
    its 2048 rows."""
    got, _, _ = ranks
    table = "text_encoder.embedding.weight"
    local = got["steps_tp"]["local"][f"gen.{table}"]
    assert local[0] == (1024, 300)
    cfg = TConfig(**W.WIDTHS)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen, _, _ = tbuilder.build_models(cfg, W.N_WORDS, W.N_SPK)
    before = getattr(gen, "text_encoder").embedding.weight.detach().double()
    after = got["steps_tp"]["snaps"][0]["gen"][table]
    moved = (after - before).abs().sum(dim=1) > 0
    assert moved[:1024].any() and moved[1024:].any()


def test_sharded_synthesis_as_jax_and_one_process(ranks):
    """The batched synthesis of three clips (2-4 windows) with pad_to 2
    over the grid's two data ranks, the generator split by row and column
    and gathered first, against JAX's on its 2 x 2 mesh (1e-4) and the
    port's one process (1e-6), with the same per-window noise."""
    got, _, ref = ranks
    mine = got["synthesis"]["results"]
    for label, want, tol in (("jax", ref["jax synthesis"], 1e-4),
                             ("one", ref["one synthesis"], 1e-6)):
        assert [m[0].shape for m in mine] == [w[0].shape for w in want], label
        for (gdv, gps), (wdv, wps) in zip(mine, want):
            np.testing.assert_allclose(gdv, wdv, atol=tol, err_msg=label)
            np.testing.assert_allclose(gps, wps, atol=tol, err_msg=label)


@pytest.mark.parametrize("case", ["no pad_to", "pad_to 3"])
def test_sharded_synthesis_refuses_lanes_that_do_not_split(ranks, case):
    """Synthesis over a mesh without pad_to, or with lanes (3 clips padded
    to 3) that do not divide the two data ranks, raises ValueError."""
    got, _, _ = ranks
    want = {"no pad_to": "synthesis over a mesh takes pad_to",
            "pad_to 3": "a global batch of 3 does not split over 2 ranks"}[case]
    assert got["synthesis"][case] == want
