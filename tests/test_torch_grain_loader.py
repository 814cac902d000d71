"""The streaming loader (`--loader grain`) and resumable training on the
CPU: the port's `data/grain_loader.py` against the JAX package's grain
pipeline (`data/grain_loader.make_data_loader`, through grain 0.2.15,
the oracle where it is installed), and the checkpoint's data-state file
against the run that was never cut.

The corpus, the one-thread fixture and the state comparison are
tests/test_torch_scanned_epoch.py's: two synthetic videos of 12 s (28
windows) at hidden 32, one GRU layer, the GAN terms on from the first
step; the port's split holds JAX's packed arrays and vocabularies. Batch
5 (the loader) and 6 (the trainer) leave a remainder, so that batches
run across epoch boundaries.

Tolerances: none. The permutation equals grain's C++ `index_shuffle`; the
batches equal JAX's bit for bit (the word ids and speakers by value: the
port keeps them int64, JAX int32); a resumed run equals the uncut one bit
for bit (every parameter, BatchNorm statistic, Adam moment, count and
rate, the generator's state, the logged lines).
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

import test_torch_scanned_epoch as tse
from speech2affective_gestures_torch.config import ModelConfig as TConfig
from speech2affective_gestures_torch.data import grain_loader as tgl
from speech2affective_gestures_torch.data import ted_db as tdb
from speech2affective_gestures_torch.train.trainer import Trainer as TTrainer
from test_torch_scanned_epoch import corpus, one_torch_thread  # noqa: F401  (fixtures)

REPO = pathlib.Path(__file__).resolve().parents[1]
WIDTHS = dict(tse.WIDTHS, batch_size=6)
SIZES = (1, 2, 3, 37, 1000, 65536, 65537, 262145, 200000)
SEEDS = (0, 1, 7919, 2 ** 31, 2 ** 32 - 1)


# ------------------------------------------------------------ the stream

@pytest.mark.parametrize("n", SIZES)
def test_index_shuffle_equals_grains(n):
    """`index_shuffle` against grain's C++ module at every seed of SEEDS,
    on the first 40 positions, 200 drawn ones and the last."""
    gis = pytest.importorskip(
        "grain._src.python.experimental.index_shuffle.python.index_shuffle_module")
    rng = np.random.default_rng(n)
    pos = np.unique(np.concatenate([np.arange(min(n, 40)), rng.integers(0, n, 200), [n - 1]]))
    for seed in SEEDS:
        want = [gis.index_shuffle(int(i), max_index=n - 1, seed=seed, rounds=4) for i in pos]
        np.testing.assert_array_equal(tgl.index_shuffle(pos, n - 1, seed), want,
                                      err_msg=f"n {n}, seed {seed}")


def test_seed_seq_words_are_the_standards():
    """`std::seed_seq{s}.generate` of 4 words (the cipher's round keys,
    which the grain oracle cases above check through the permutation): a
    function of the seed mod 2**32 alone, 32-bit, different for each seed
    of SEEDS."""
    assert tgl.seed_seq_words(2 ** 32 + 7, 4) == tgl.seed_seq_words(7, 4)
    words = {tuple(tgl.seed_seq_words(s, 4)) for s in SEEDS}
    assert len(words) == len(SEEDS)
    assert all(0 <= w < 2 ** 32 for ws in words for w in ws)


@pytest.mark.parametrize("n", [37, 1000, 65536, 200000])
def test_index_shuffle_is_a_permutation(n):
    perm = tgl.index_shuffle(np.arange(n), n - 1, 5)
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))


@pytest.mark.parametrize("n", [65537, 262145])
def test_grains_quirk_at_two_to_the_w_plus_one(n):
    """Where n - 1 is 2**W, the cipher's W-bit domain cannot reach n - 1:
    an epoch drops that row and repeats the one that position 0 maps to,
    as grain does (kept for parity)."""
    perm = tgl.index_shuffle(np.arange(n), n - 1, 3)
    assert n - 1 not in perm
    rows, counts = np.unique(perm, return_counts=True)
    assert len(rows) == n - 1 and counts.max() == 2
    assert rows[counts == 2][0] == perm[0] == perm[n - 1]


@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_jax_grain_loader(corpus, seed):
    """The port's batches against JAX's `make_data_loader(ds, 5, seed,
    num_epochs=None)` over 3 epochs of 28 rows (16 batches, 3 of them
    across an epoch boundary): every float array the same bits, the word
    ids and adversarial speakers the same values; and the rows decoded by
    `grain_loader.decode` the same bits as the port's `decode_rows` of
    them on the host."""
    pytest.importorskip("grain.python")
    from speech2affective_gestures_tpu.data import grain_loader as jgl

    jds, tds = corpus
    bs = 5
    n_batches = 3 * jds.n_samples // bs
    want = jgl.make_data_loader(jds, bs, seed=seed, num_epochs=None)
    port = tgl.GrainLoader(tds, bs, seed)
    for t, jb in zip(range(n_batches), want):
        got = next(port)
        assert set(got) == set(jb)
        host = tdb.decode_rows(tds, tgl.batch_rows(tds.n_samples, bs, seed, t))
        for k, v in host.items():
            assert got[k].numpy().tobytes() == v.tobytes(), (t, k)
        for k, v in jb.items():
            g = got[k].numpy()
            if v.dtype.kind == "f":
                assert g.dtype == v.dtype, k
                np.testing.assert_array_equal(g.view(np.uint32), v.view(np.uint32),
                                              err_msg=f"batch {t} {k}")
            else:
                assert g.dtype == np.int64, k
                np.testing.assert_array_equal(g, v, err_msg=f"batch {t} {k}")
    assert port.next_batch == n_batches


def test_resumed_loader_gives_the_same_stream(corpus):
    """A loader set to another loader's state (next batch and seed), built
    with another seed, hands out the same batches from there on, and one
    set back gives a batch again."""
    _, tds = corpus
    a, b = tgl.GrainLoader(tds, 5, 11), tgl.GrainLoader(tds, 5, 999)
    first = [next(a) for _ in range(4)]
    b.set_state(a.state())
    assert b.state() == {"next_batch": 4, "seed": 11}
    for _ in range(6):
        x, y = next(a), next(b)
        assert all(torch.equal(x[k], y[k]) for k in x)
    a.set_state({"next_batch": 1, "seed": 11})
    again = next(a)
    assert all(torch.equal(again[k], first[1][k]) for k in again)
    assert a.next_batch == 2


def test_port_imports_no_grain():
    """The port runs where grain is not installed: no module of it imports
    grain."""
    pat = re.compile(r"^\s*(import|from)\s+grain\b", re.M)
    files = sorted((REPO / "speech2affective_gestures_torch").rglob("*.py"))
    assert len(files) > 10
    assert not [str(f) for f in files if pat.search(f.read_text())]


# ------------------------------------------------------- resumed training

def _trainer(tds, work, spp: int = 1, seed: int = 3, **kw) -> TTrainer:
    """A trainer in `work` whose frozen TriModal comes from the work dir's
    `trimodal_gen.pth.tar` (the first trainer's random one), as main_v2's
    runs take it from `--trimodal-checkpoint`: a checkpoint holds G and D
    alone, as the reference's does."""
    t = TTrainer(TConfig(**WIDTHS), str(work), train_data=tds, device="cpu", seed=seed,
                 steps_per_program=spp, metrics_lag=3, log_interval=1, **kw)
    tri = work / "trimodal_gen.pth.tar"
    if not tri.exists():
        torch.save({"trimodal_gen_dict": t.tri.state_dict()}, tri)
    t.load_trimodal_torch_checkpoint(str(tri))
    t.lines = []
    t.logger.print_log = t.lines.append
    return t


def test_grain_resume_mid_epoch_equals_the_uncut_run(corpus, tmp_path):
    """JAX's tests/test_round2_trainer_features.py:100-127 on the port: a
    grain trainer runs epoch 0 (4 steps of 6 rows of 28) and 1 step of
    epoch 1, across the stream's first epoch boundary, and saves; it runs
    on to the end of epoch 1, and a new trainer built with another seed
    loads the checkpoint and does the same. Both end in the same bits and
    log the same steps; nothing is copied by hand."""
    _, tds = corpus
    a = _trainer(tds, tmp_path, seed=11, loader="grain")
    a.per_train_epoch()
    a.epoch = 1
    a.per_train_epoch(max_iters=1)
    assert a._iter_in_epoch == 1 and a._grain.next_batch == 5
    path = pathlib.Path(a.save_checkpoint(0.5))
    side = path.with_name("epoch_000001_loss_0.5000_model_datastate.json")
    state = json.loads(side.read_text())
    assert state["iter_in_epoch"] == 1 and state["step"] == 5
    assert state["grain"] == {"next_batch": 5, "seed": 11}
    a.lines.clear()
    a.per_train_epoch()
    assert a._iter_in_epoch == 0

    b = _trainer(tds, tmp_path, seed=999, loader="grain")
    assert b.load_checkpoint("best")
    assert b.epoch == 1 and b._iter_in_epoch == 1 and b._grain.state() == state["grain"]
    b.lines.clear()
    b.per_train_epoch()
    lines = tse._iter_lines(a.lines)
    assert len(lines) == 3 and lines == tse._iter_lines(b.lines)
    assert tse._iter_lines(b.lines)[0].lstrip().startswith("Iter 1 Done.")
    tse._assert_same_state(a, b)


@pytest.mark.parametrize("spp", [1, 2], ids=["per_step", "scanned"])
def test_device_loader_resume_equals_the_uncut_run(corpus, tmp_path, spp):
    """The default loader, one step at a time and as programs of 2: a
    trainer runs 3 steps of epoch 0, saves, and runs 3 steps of epoch 1; a
    trainer built with another seed loads the checkpoint and runs the same
    3 steps of epoch 1. The same bits and the same logged steps, with the
    step generator and the step count restored from the data-state file
    alone (without it, the second trainer draws its own seed's noise)."""
    _, tds = corpus
    a = _trainer(tds, tmp_path, spp)
    a.per_train_epoch(max_iters=3)
    a.save_checkpoint(0.5)
    a.epoch = 1
    a.lines.clear()
    a.per_train_epoch(max_iters=3)

    b = _trainer(tds, tmp_path, spp, seed=999)
    assert b.epoch_engine == ("scanned" if spp > 1 else "per_step")
    assert b.load_checkpoint(0)
    b.epoch = 1
    b.lines.clear()
    b.per_train_epoch(max_iters=3)
    lines = tse._iter_lines(a.lines)
    assert len(lines) == 3 and lines == tse._iter_lines(b.lines)
    tse._assert_same_state(a, b)


def test_checkpoint_without_data_state_still_loads(corpus, tmp_path):
    """A checkpoint with no data-state file beside it (the reference's, an
    older run's) loads its weights and Adam states, and the generator
    keeps its own state; a data-state file of a generator on another
    device type leaves it too, with a warning."""
    _, tds = corpus
    a = _trainer(tds, tmp_path)
    a.per_train_epoch(max_iters=1)
    path = pathlib.Path(a.save_checkpoint(0.5))
    side = path.with_name(path.name.replace(".pth.tar", "_datastate.json"))
    state = json.loads(side.read_text())
    side.unlink()
    b = _trainer(tds, tmp_path, seed=999)
    own = b.generator.get_state()
    assert b.load_checkpoint(0)
    assert torch.equal(b.generator.get_state(), own) and b.step.step == 0
    assert all(torch.equal(v, a.gen.state_dict()[k]) for k, v in b.gen.state_dict().items())
    side.write_text(json.dumps(dict(state, generator_device="cuda")))
    assert b.load_checkpoint(0)
    assert torch.equal(b.generator.get_state(), own) and b.step.step == 1
    assert any("holds a cuda generator's state" in ln for ln in b.lines)
