"""The ranks of tests/test_torch_data_parallel.py: data-parallel training
over gloo on the CPU, with the port alone (this module imports no JAX).

`run_rank(mesh, work)` runs every scenario on its rank and writes each
one's results to `work/rank{r}_{scenario}.pt`; the test cases read them.
`run_steps` and `trainer` are shared with the test module, which runs the
one-process runs that the ranks are held to.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from speech2affective_gestures_torch.config import ModelConfig
from speech2affective_gestures_torch.data.ted_db import DeviceDataset
from speech2affective_gestures_torch.models.discriminator import AffDiscriminator
from speech2affective_gestures_torch.models.generator import (PoseGenerator,
                                                                 PoseGeneratorTriModal)
from speech2affective_gestures_torch.models.layers import BatchNorm1d
from speech2affective_gestures_torch.parallel import mesh as P
from speech2affective_gestures_torch.train import builder
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train.evaluator import EmbeddingSpaceEvaluator
from speech2affective_gestures_torch.train.step_program import StepProgram
from speech2affective_gestures_torch.train.trainer import Trainer

# hidden 16, 2 GRU layers, global batch 8, the GAN terms from the first
# step, the config's dropout 0.3
WIDTHS = dict(batch_size=8, loss_warmup=-1, n_layers=2, hidden_size=16,
              hidden_size_s2eg=16, wordembed_dim=16)
N_WORDS, N_SPK = 30, 5
# (name, GanConfig options) of the step scenarios
MODES = (("plain", {}), ("fused", {"fused_pass": True}), ("remat", {"remat": "full"}))
N_STEPS = 2
# the JAX comparison's widths and draws (tests/test_torch_train.py's)
JAX_KW = dict(n_words=30, word_embed_size=16, hidden_size=16, n_layers=1, dropout_prob=0.0,
              n_speakers=5)
DIV_IDS = np.array([2, 0, 3, 1])


def _rows(mesh, n):
    return slice(None) if mesh is None else mesh.rows(n)


def _tensors(batch: dict, dtype, rows) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v[rows]))
        out[k] = t.to(dtype) if t.is_floating_point() else t.long()
    return out


def snapshot(step: tstep.GanStep, generator: torch.Generator, metrics: dict) -> dict:
    """What a step leaves: its metrics, both nets' parameters and buffers,
    both Adams' states and the generator's state."""
    def adam(opt, net):
        return {n: {k: v.clone() for k, v in opt.state[p].items()}
                for n, p in net.named_parameters() if p in opt.state}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "gen": {k: v.clone() for k, v in step.gen.state_dict().items()},
            "dis": {k: v.clone() for k, v in step.dis.state_dict().items()},
            "gen_adam": adam(step.gen_opt, step.gen), "dis_adam": adam(step.dis_opt, step.dis),
            "generator": generator.get_state()}


def run_steps(mesh, dtype, options: dict, program: bool = False) -> list[dict]:
    """N_STEPS GAN steps at WIDTHS from seed 0 in `dtype`, the step
    generator seeded 5, on global batches of seeds 20, 21, ...: this rank's
    rows of each (all of them without a mesh); with `program` (float32) as
    one K-step program's eager body (`StepProgram(capture=False)`) on a
    random packed split, a snapshot after its last step. A snapshot after
    each step."""
    cfg = ModelConfig(**WIDTHS)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen, dis, tri = builder.build_models(cfg, N_WORDS, N_SPK)
    gen, dis, tri = gen.to(dtype), dis.to(dtype), tri.to(dtype).requires_grad_(False)
    gcfg = dataclasses.replace(builder.gan_config(cfg, N_SPK), **options)
    step = tstep.GanStep(gen, dis, gcfg, tri, mesh=mesh)
    g = torch.Generator().manual_seed(5)
    out = []
    rows = _rows(mesh, cfg.batch_size)
    if program:
        rng = np.random.default_rng(20)
        data = DeviceDataset(builder.synthetic_packed(rng, 64, cfg, N_WORDS, N_SPK), "cpu")
        prog = StepProgram(step, data, g, capture=False)
        idx = rng.integers(0, 64, (N_STEPS, cfg.batch_size))
        adv = rng.integers(0, N_SPK, (N_STEPS, cfg.batch_size))
        keys, values = prog.run(idx[:, rows], adv[:, rows], gan_on=True)
        return [{"metrics": dict(zip(keys, values[-1].tolist())),
                 **{k: v for k, v in snapshot(step, g, {}).items() if k != "metrics"}}]
    for i in range(N_STEPS):
        batch = builder.synthetic_batch(np.random.default_rng(20 + i), cfg.batch_size, cfg,
                                        N_WORDS, N_SPK)
        metrics = step.train_step(_tensors(batch, dtype, rows), g, gan_on=True)
        out.append(snapshot(step, g, metrics))
    return out


def bn_check(mesh) -> dict:
    """A train-mode BatchNorm1d on this rank's rows of a global (8, 6, 5)
    float64 input: its output rows, the input's gradient under a
    rank-local loss, the running stats."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 6, 5)) * 3 + 1)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 6, 5)))
    bn = BatchNorm1d(6).double().train()
    rows = _rows(mesh, 8)
    xr = x[rows].clone().requires_grad_()
    with P.stepping(mesh, xr.shape[0]):
        y = bn(xr)
    (y * w[rows]).sum().backward()
    return {"y": y.detach(), "grad": xr.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def jax_steps(mesh, work) -> list[dict]:
    """The port's two steps of tests/test_torch_train.py on weights bridged
    from JAX's (written by the test), this rank's rows of each batch, every
    dropout at 0, the noise 0 and the diversity regularizer's speakers
    DIV_IDS (this rank's rows)."""
    sd = torch.load(work / "jax_weights.pt", weights_only=True)
    gen = PoseGenerator(emb_dropout=0.0, **JAX_KW)
    dis = AffDiscriminator(hidden_size=JAX_KW["hidden_size"], dropout_prob=0.0)
    tri = PoseGeneratorTriModal(emb_dropout=0.0, **JAX_KW).requires_grad_(False)
    for net, name in ((gen, "gen"), (dis, "dis"), (tri, "tri")):
        net.load_state_dict(sd[name], strict=True)
    step = tstep.GanStep(gen, dis, tstep.GanConfig(loss_warmup=-1, n_speakers=5), tri,
                         mesh=mesh)
    batches = np.load(work / "jax_batches.npz")
    n = len(DIV_IDS)
    rows = _rows(mesh, n)
    saved = tstep.draw_other_speaker_ids
    tstep.draw_other_speaker_ids = lambda g, vids, k: torch.as_tensor(DIV_IDS[rows])
    try:
        out = []
        g = torch.Generator().manual_seed(0)
        eps = torch.zeros(len(DIV_IDS[rows]), 16)
        for i in range(2):
            batch = {k.split("/", 1)[1]: batches[k] for k in batches if k.startswith(f"{i}/")}
            metrics = step.train_step(_tensors(batch, torch.float32, rows), g, gan_on=True,
                                      eps=eps, eps_rand=eps)
            out.append(snapshot(step, g, metrics))
        return out
    finally:
        tstep.draw_other_speaker_ids = saved


def load_corpus(work):
    with open(work / "corpus.pkl", "rb") as f:
        return pickle.load(f)


def trainer(mesh, work, name: str, data, seed: int = 5, **kw) -> Trainer:
    """A trainer at WIDTHS on the CPU (one rank of `mesh` when given): the
    lines it logs kept in `lines` (rank 0's alone on a mesh), the
    checkpoints it writes counted in `writes`, the frozen TriModal's
    weights the work dir's."""
    t = Trainer(ModelConfig(**WIDTHS), str(work / name), device="cpu", seed=seed,
                log_interval=10 ** 9, mesh=mesh, **data, **kw)
    t.lines, t.writes = [], []
    t.logger.print_log = lambda msg: t.lines.append(msg) if t.logger.enabled else None
    write = t._write_checkpoint
    t._write_checkpoint = lambda path: (t.writes.append(path), write(path))
    t.tri.load_state_dict(torch.load(work / "trimodal.pt", weights_only=True))
    return t


def epoch_run(mesh, work, corpus, name: str = "epoch") -> list[dict]:
    """One epoch of the trainer's per-step loop with the device loader (2
    steps of global batch 8, each batch gathered from the resident split,
    on a mesh this rank's rows of each draw): a snapshot after it, its
    mean loss as the metric."""
    t = trainer(mesh, work, name, {"train_data": corpus["train"]})
    loss = t.per_train_epoch()
    return [snapshot(t.step, t.generator, {"mean_loss": loss})]


def resume_runs(mesh, work, corpus) -> dict:
    """The uncut run and the resumed one, each its state after the same
    steps, on a train split of 2 batches: the device loader (1 step of
    epoch 0, a checkpoint, 1 step of epoch 1; the resumed trainer, built
    with another seed, loads it and runs the same step) and grain (epoch
    0 and 1 step of epoch 1, a checkpoint, the rest of epoch 1; the
    resumed one finishes epoch 1)."""
    out = {}
    data = {"train_data": corpus["train"]}
    for label, kw in (("device", {"loader": "device"}), ("grain", {"loader": "grain"})):
        where = f"resume_{label}"
        a = trainer(mesh, work, where, data, **kw)
        a.per_train_epoch(max_iters=None if label == "grain" else 1)
        if label == "grain":
            a.epoch = 1
            a.per_train_epoch(max_iters=1)
            a.save_checkpoint(0.5)
            a.per_train_epoch()
            b = trainer(mesh, work, where, data, seed=6, **kw)
            assert b.load_checkpoint("best") and b._iter_in_epoch == 1, b._iter_in_epoch
            b.per_train_epoch()
        else:
            a.save_checkpoint(0.5)
            a.epoch = 1
            a.per_train_epoch(max_iters=1)
            b = trainer(mesh, work, where, data, seed=6, **kw)
            assert b.load_checkpoint(0)
            b.epoch = 1
            b.per_train_epoch(max_iters=1)
        out[label] = [snapshot(t.step, t.generator, {}) | {"count": t.step.step}
                      for t in (a, b)]
        out[label + "_writes"] = len(a.writes) + len(b.writes)
    return out


def eval_run(mesh, work, corpus) -> dict:
    """`generate_gestures` over the whole test split in chunks of 4, with
    an FGD evaluator, from the trainer's own noise: the scores and the
    log."""
    t = trainer(mesh, work, "eval", {"test_data": corpus["test"]},
                evaluator=EmbeddingSpaceEvaluator.random_init(0, device="cpu"))
    scores = t.generate_gestures(batch_size=4, full_test=True)
    return {"scores": scores, "lines": t.lines}


def fallbacks(mesh, work, corpus) -> dict:
    """The engine and fallback reason of a K 2 trainer on the gloo mesh,
    and of one whose batch (7) does not divide the ranks."""
    out = {}
    for label, cfg_kw in (("gloo", {}), ("odd batch", {"batch_size": 7})):
        t = Trainer(ModelConfig(**{**WIDTHS, **cfg_kw}), str(work / f"fb_{label}"),
                    train_data=corpus["train"], device="cpu", seed=5, steps_per_program=2,
                    mesh=mesh)
        out[label] = (t.epoch_engine, t.steps_per_program, t.epoch_engine_fallback)
    return out


def run_rank(mesh, work) -> None:
    """Every scenario on this rank; each one's results in
    `work/rank{r}_{scenario}.pt`."""
    torch.set_num_threads(1)
    r = mesh.rank
    corpus = load_corpus(work)

    def save(name, value):
        torch.save(value, work / f"rank{r}_{name}.pt")

    formed = P.make_mesh("cpu")
    save("mesh", (formed.rank, formed.world, formed.backend))
    save("bn", bn_check(mesh))
    for dtype in (torch.float64, torch.float32):
        for mode, options in MODES:
            save(f"steps_{mode}_{str(dtype)[6:]}", run_steps(mesh, dtype, options))
    save("program", run_steps(mesh, torch.float32, {}, program=True))
    save("jax", jax_steps(mesh, work))
    save("epoch", epoch_run(mesh, work, corpus))
    save("eval", eval_run(mesh, work, corpus))
    save("resume", resume_runs(mesh, work, corpus))
    save("fallback", fallbacks(mesh, work, corpus))
