"""The ranks of tests/test_torch_mesh_2d.py: the GAN step and the batched
synthesis on a 2 x 2 (data, model) grid over gloo on the CPU, with the
port alone (this module imports no JAX).

`run_rank(mesh, work)` forms the grid on its rank, runs every scenario
and writes rank 0's results to `work/rank0_{scenario}.pt` (each rank's
digest of its own state beside them); the test cases read them.
`run_steps` and `snapshot` are shared with the test module, which runs
the one-process steps that the grid is held to.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

import chip_smoke
from speech2affective_gestures_torch.config import ModelConfig
from speech2affective_gestures_torch.data.vocab import Vocab
from speech2affective_gestures_torch.models import layers as L
from speech2affective_gestures_torch.models.discriminator import AffDiscriminator
from speech2affective_gestures_torch.models.generator import (PoseGenerator,
                                                                 PoseGeneratorTriModal)
from speech2affective_gestures_torch.parallel import mesh as P
from speech2affective_gestures_torch.train import builder
from speech2affective_gestures_torch.train import gan_step as tstep
from speech2affective_gestures_torch.train import synthesis as tsyn

# hidden 32, 2 GRU layers, a 2048-word vocabulary (the text tables split
# by row at min_rows 1024), global batch 8, the GAN terms from the first
# step, the config's dropout 0.3
WIDTHS = dict(batch_size=8, loss_warmup=-1, n_layers=2, hidden_size=32, hidden_size_s2eg=32)
N_WORDS, N_SPK = 2048, 10
GRID = (2, 2)
# tp_min_cols at 3H: G's and the TriModal's GRU gates (96 columns) and
# D's (192) split by column
TP_COLS = 3 * 32
N_STEPS = 2
CLIP = chip_smoke.GRID_CLIP
MUTANTS = chip_smoke.GRID_MUTANTS
# the JAX comparison's nets (every dropout 0), speakers and the diversity
# regularizer's speakers
JAX_KW = dict(n_words=N_WORDS, hidden_size=32, n_layers=2, dropout_prob=0.0, n_speakers=5)
DIV_IDS = np.array([2, 0, 3, 1, 4, 2, 0, 3])
# the synthesis' words and clips (seconds, audio seed, speaker)
WORDS = [["hello", 0.2, 0.6], ["world", 1.5, 2.0], ["again", 3.1, 3.5]]
CLIPS = ((3.0, 1, 0), (7.5, 2, 1), (5.0, 3, 4))
# the noise rows a clip's synthesis reads (its window count's bucket)
SYNTH_WINDOWS = 8
# the file the test writes once the JAX comparisons' inputs are in place
# ("ok", or "failed")
READY = "inputs.ready"


def vocab() -> Vocab:
    v = Vocab("w")
    for w in ("hello", "world", "again"):
        v.index_word(w)
    return v


def clip_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)


def clips() -> list:
    return [(clip_audio(s, seed), WORDS[: 1 + i], vid) for i, (s, seed, vid) in enumerate(CLIPS)]


def _rows(grid, n):
    return slice(None) if grid is None else grid.data.rows(n)


def _tensors(batch: dict, dtype, rows) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v[rows]))
        out[k] = t.to(dtype) if t.is_floating_point() else t.long()
    return out


def snapshot(step: tstep.GanStep, generator: torch.Generator, metrics: dict) -> dict:
    """What a step leaves, whole: its metrics, both nets' parameters and
    buffers, both Adams' states by parameter name and the generator's
    state; on a grid gathered (`gather_params_2d`, a collective)."""
    nets, opts = (step.gen, step.dis), (step.gen_opt, step.dis_opt)
    if step.grid is None:
        states = [{k: v.detach().clone() for k, v in n.state_dict().items()} for n in nets]
        opt_states = [o.state_dict() for o in opts]
    else:
        states, opt_states = P.gather_params_2d(nets, opts, step.grid)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "generator": generator.get_state()}
    for who, net, state, sd in zip(("gen", "dis"), nets, states, opt_states):
        names = [n for n, _ in net.named_parameters()]
        out[who] = state
        out[f"{who}_adam"] = {names[i]: {k: v.clone() for k, v in st.items()}
                              for i, st in sd["state"].items()}
    return out


def digest(step: tstep.GanStep, generator: torch.Generator) -> str:
    """A hash of this rank's own bits: both nets' parameters (its slices
    of the split ones) and buffers, both Adams' states, the generator."""
    h = hashlib.sha256()
    for net, opt in ((step.gen, step.gen_opt), (step.dis, step.dis_opt)):
        for t in net.state_dict().values():
            h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        for st in opt.state.values():
            for v in st.values():
                h.update(v.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    h.update(generator.get_state().numpy().tobytes())
    return h.hexdigest()


def make_step(grid, dtype, tp: bool, options: dict | None = None, mixed: bool = False,
              weights: dict | None = None) -> tstep.GanStep:
    """The GAN step at WIDTHS from seed 0 in `dtype` (with `weights`,
    JAX_KW's nets loaded from them), on `grid` where given: split by
    `shard_params_2d` (tp_min_cols TP_COLS with `tp`) after the step and
    its Adams are made."""
    cfg = ModelConfig(**WIDTHS)
    if weights is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            gen, dis, tri = builder.build_models(cfg, N_WORDS, N_SPK)
        gcfg = builder.gan_config(cfg, N_SPK)
    else:
        gen = PoseGenerator(emb_dropout=0.0, **JAX_KW)
        dis = AffDiscriminator(dropout_prob=0.0)
        tri = PoseGeneratorTriModal(emb_dropout=0.0, **JAX_KW)
        for net, name in ((gen, "gen"), (dis, "dis"), (tri, "tri")):
            net.load_state_dict(weights[name], strict=True)
        gcfg = tstep.GanConfig(loss_warmup=-1, n_speakers=5)
    gen, dis, tri = gen.to(dtype), dis.to(dtype), tri.to(dtype).requires_grad_(False)
    gcfg = dataclasses.replace(gcfg, **(options or {}))
    step = tstep.GanStep(gen, dis, gcfg, tri, mesh=grid,
                         train_apply=builder.mixed_precision_apply if mixed else None)
    if grid is not None:
        P.shard_params_2d((gen, dis, tri), (step.gen_opt, step.dis_opt), grid,
                          tp_min_cols=TP_COLS if tp else None)
    return step


def run_steps(grid, dtype, tp: bool = True, n_steps: int = N_STEPS,
              options: dict | None = None) -> dict:
    """n_steps GAN steps (`make_step`), the step generator seeded 5, on
    global batches of seeds 20, 21, ...: this rank's rows of each (all of
    them without a grid). A whole snapshot after each step, and on a grid
    this rank's digest after each."""
    step = make_step(grid, dtype, tp, options)
    g = torch.Generator().manual_seed(5)
    cfg = ModelConfig(**WIDTHS)
    snaps, digests = [], []
    for i in range(n_steps):
        batch = builder.synthetic_batch(np.random.default_rng(20 + i), cfg.batch_size, cfg,
                                        N_WORDS, N_SPK)
        metrics = step.train_step(_tensors(batch, dtype, _rows(grid, cfg.batch_size)), g,
                                  gan_on=True)
        snaps.append(snapshot(step, g, metrics))
        if grid is not None:
            digests.append(digest(step, g))
    return {"snaps": snaps, "digests": digests, "local": _local_shapes(step)}


def _local_shapes(step: tstep.GanStep) -> dict:
    """This rank's shapes: each parameter's, and each Adam state's."""
    out = {}
    for who in ("gen", "dis"):
        net, opt = getattr(step, who), getattr(step, f"{who}_opt")
        for n, p in net.named_parameters():
            out[f"{who}.{n}"] = (tuple(p.shape), {k: tuple(v.shape) for k, v in
                                                  opt.state.get(p, {}).items()})
    return out


def mutant_steps(grid) -> dict:
    """One float64 step of each of chip_smoke.py's wrong grids
    (`_grid_mutant`: the slices' gradients summed over the model axis,
    BatchNorm's count over the world, the clip counting each slice twice;
    the clip's at gradient clip CLIP) and one clipped step without a
    fault, tp on."""
    out = {"clipped": run_steps(grid, torch.float64, n_steps=1,
                                options={"gradient_clip": CLIP})["snaps"]}
    for name in MUTANTS:
        options = {"gradient_clip": CLIP} if name.startswith("clip") else {}
        with chip_smoke._grid_mutant(name, grid):
            out[name] = run_steps(grid, torch.float64, n_steps=1, options=options)["snaps"]
    return out


def jax_steps(grid, work, tp: bool) -> list[dict]:
    """One float32 step of JAX_KW's nets on weights bridged from JAX's
    (written by the test), this rank's rows of the batch of seed 11,
    every dropout at 0, the noise 0 and the diversity regularizer's
    speakers DIV_IDS (this rank's rows)."""
    weights = torch.load(work / "jax_weights.pt", weights_only=True)
    step = make_step(grid, torch.float32, tp, weights=weights)
    batch = dict(np.load(work / "jax_batch.npz"))
    rows = _rows(grid, len(DIV_IDS))
    saved = tstep.draw_other_speaker_ids
    tstep.draw_other_speaker_ids = lambda g, vids, k: torch.as_tensor(DIV_IDS[rows])
    try:
        g = torch.Generator().manual_seed(0)
        eps = torch.zeros(len(DIV_IDS[rows]), 16)
        metrics = step.train_step(_tensors(batch, torch.float32, rows), g, gan_on=True,
                                  eps=eps, eps_rand=eps)
        return [snapshot(step, g, metrics)]
    finally:
        tstep.draw_other_speaker_ids = saved


def mixed_step(grid) -> dict:
    """One mixed-precision step on the grid, tp on: its metrics, and the
    dtypes of this rank's parameters and of the gathered ones."""
    step = make_step(grid, torch.float32, True, mixed=True)
    cfg = ModelConfig(**WIDTHS)
    batch = builder.synthetic_batch(np.random.default_rng(20), cfg.batch_size, cfg, N_WORDS,
                                    N_SPK)
    g = torch.Generator().manual_seed(5)
    metrics = step.train_step(_tensors(batch, torch.float32, _rows(grid, cfg.batch_size)), g,
                              gan_on=True)
    whole = snapshot(step, g, metrics)
    return {"metrics": whole["metrics"],
            "local dtypes": {str(p.dtype) for n in (step.gen, step.dis) for p in n.parameters()},
            "whole dtypes": {str(v.dtype) for w in ("gen", "dis") for k, v in whole[w].items()
                             if not k.endswith("num_batches_tracked")}}


def synthesis_run(grid, work) -> dict:
    """The batched synthesis of CLIPS on the grid with pad_to 2, the
    generator bridged from JAX's (written by the test) and split with tp
    on, the noise the test's (JAX's per-window noise); and the errors
    that a missing pad_to and a pad_to of 3 (3 lanes over 2 data ranks)
    raise."""
    gen = PoseGenerator(**JAX_KW)
    gen.load_state_dict(torch.load(work / "jax_gen.pt", weights_only=True), strict=True)
    gen.eval()
    P.shard_params_2d((gen,), (), grid, tp_min_cols=TP_COLS)
    eps = torch.from_numpy(np.load(work / "jax_eps.npy"))
    cfg = ModelConfig(hidden_size_s2eg=32, n_layers=2)
    out = {"results": tsyn.synthesize_clips_batched(gen, clips(), vocab(), cfg, eps=eps,
                                                    mesh=grid, pad_to=2,
                                                    fade_out=[False, True, False])}
    for label, kw in (("no pad_to", {}), ("pad_to 3", {"pad_to": 3})):
        try:
            tsyn.synthesize_clips_batched(gen, clips(), vocab(), cfg, eps=eps, mesh=grid, **kw)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def layout(mesh) -> dict:
    """The grid this rank forms, and the errors of grids that do not
    cover the ranks."""
    grid = P.make_mesh_2d(*GRID)
    out = {"rank": grid.rank, "data": (grid.data.rank, grid.data.world),
           "model": (grid.model.rank, grid.model.world), "flat": mesh.rank}
    for shape in ((3, 2), (4, 2), (1, 2)):
        try:
            P.make_mesh_2d(*shape)
            out[shape] = None
        except ValueError as e:
            out[shape] = str(e)
    # the axes' ranks: each rank's flat rank gathered over each axis
    me = torch.tensor([float(mesh.rank)])
    out["data ranks"] = P.all_gather_rows(me, grid.data).tolist()
    out["model ranks"] = P.all_gather_rows(me, grid.model).tolist()
    return out, grid


def _wait_for_inputs(work, timeout: float = 300.0) -> None:
    """Until the test has written the JAX comparisons' inputs (READY)."""
    deadline = time.monotonic() + timeout
    while not (work / READY).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {READY} after {timeout} s")
        time.sleep(0.1)
    if (work / READY).read_text() != "ok":
        raise RuntimeError("the test failed to write the JAX comparisons' inputs")


def run_rank(mesh, work) -> None:
    """Every scenario on this rank, those that read the test's inputs
    last; rank 0's results in `work/rank0_{scenario}.pt`, every rank's
    digests in `work/rank{r}_digests.pt`."""
    torch.set_num_threads(1)
    r = mesh.rank
    found, grid = layout(mesh)
    results = {"layout": found}
    results["steps_tp"] = run_steps(grid, torch.float64, tp=True)
    results["steps_rows"] = run_steps(grid, torch.float64, tp=False)
    results["mutants"] = mutant_steps(grid)
    results["mixed"] = mixed_step(grid)
    _wait_for_inputs(work)
    results["jax_tp"] = jax_steps(grid, work, tp=True)
    results["jax_rows"] = jax_steps(grid, work, tp=False)
    results["synthesis"] = synthesis_run(grid, work)
    torch.save({k: v["digests"] for k, v in results.items() if isinstance(v, dict)
                and "digests" in v} | {"layout": found}, work / f"rank{r}_digests.pt")
    if r == 0:
        for name, value in results.items():
            torch.save(value, work / f"rank0_{name}.pt")


def split_gru(grid, device) -> dict:
    """The generator's first bi-GRU layer (input 88, H 300) from seed 0 on
    `device`, its gate weights split by column over `grid`'s model axis at
    tp_min_cols 900 (whole without a grid), forward and backward on a
    fixed input (B 64, T 34): the output, h_last, the input's gradient,
    each parameter's gradient (this rank's slice of a split one) and the
    GRU kernels' launches."""
    from speech2affective_gestures_torch.ops import gru_cuda

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gru = L.GRU(88, 300, num_layers=1, bidirectional=True)
    gru = gru.to(device)
    if grid is not None:
        P.shard_params_2d((gru,), (), grid, tp_min_cols=900)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 34, 88, generator=g).to(device).requires_grad_()
    w = torch.randn(34, 64, 600, generator=g).to(device)
    before = dict(gru_cuda.launches)
    out, h_last = gru(x)
    ((out * w).sum() + h_last.square().sum()).backward()
    torch.cuda.synchronize()
    return {"out": out.detach().cpu(), "h_last": h_last.detach().cpu(), "dx": x.grad.cpu(),
            "grads": {n: p.grad.cpu() for n, p in gru.named_parameters()},
            "launches": {k[0]: n - before.get(k, 0) for k, n in gru_cuda.launches.items()
                         if k[1] == "float32"}}


def split_gru_rank(mesh, out) -> None:
    """`split_gru` on one rank of a 1 x 2 grid (the model axis alone),
    TF32 off; its results in `out/split_gru_rank{r}.pt`."""
    from speech2affective_gestures_torch.device import set_f32_numerics

    set_f32_numerics()
    grid = P.make_mesh_2d(1, 2)
    torch.save(split_gru(grid, mesh.device), out / f"split_gru_rank{grid.rank}.pt")
