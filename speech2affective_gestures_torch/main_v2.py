"""Training entry point: the port's `main_v2.py`.

The reference's flag surface (main_v2.py:31-98, as the JAX package's
`main_v2.py` carries it) and flow: parse the run flags and the YAML model
config, make the work directory, load the dataset splits, build the
FGD evaluator and the trainer, load checkpoints, train, then score the
test split (`Trainer.generate_gestures`: L1, joint MAE, acceleration
difference, and FGD with `--embedding-net-checkpoint`).

    python -m speech2affective_gestures_torch.main_v2 -b BASE_PATH \\
        -c config/multimodal_context_v2.yml --synthetic-data true \\
        [--embedding-net-checkpoint emb.pth.tar]

Training runs on the card unless `--device cpu` is given (every kernel's
plain PyTorch version). The data come from one of three routes, as the
JAX package's `load_datasets`: the synthetic corpus (`--synthetic-data
true`), an export archive (`--packed-data DIR`, which the JAX package's
`tools/export_ted_cache.py` writes where lmdb and pyarrow are installed),
or the TED LMDB under `<base>/../data/<dataset_s2ag>` (needs pyarrow to
decode its values). Raw videos are windowed with their MFCCs computed on
the device, and the packed splits are cached beside the archive or the
LMDB. `--apply-gradient-clip true` clips each net's gradients by their
global norm (`--gradient-clip`), and `--apply-lr-decay true` decays the
learning rates by `--lr-s2ag-decay` per epoch; the reference parses both
and applies neither. `--fused-pass true` runs D on real and fake, and G's
main and diversity-regularizer forwards, each as one forward on the 2B
concat (BatchNorm statistics over the 2B batch, one 2B noise and dropout
draw: not the reference's step). `--remat full|dots` rematerializes the
differentiated forwards inside the backward (`torch.utils.checkpoint`;
"dots" keeps the `mm`/`addmm` outputs), with the same values, draws and
BatchNorm updates as `none`. The train split lives on the card and each
batch is gathered there (`--loader device`, the default); `--steps-per-program
K` runs each epoch as programs of K train steps, one CUDA graph each (the
JAX package's scanned epoch; the log names the engine that ran, and why
it fell back to one step at a time if it did). `--loader grain` keeps the
split on the host and streams shuffled batches from it, one step at a
time (the JAX package's grain pipeline, without grain), for a split
larger than the card's memory. Each checkpoint has a
`<checkpoint>_datastate.json` beside it (the step generator's state, the
step count, the position in the epoch and the stream's), so that a run
resumed from it draws what the uncut run draws, under grain from the
middle of an epoch.
`--mixed-precision true` runs the train steps at bf16 (the GRU kernels'
bf16 instances on the card); validation and the test-split scoring stay
float32.
The embedding net comes from the reference's `embedding_net.pth.tar` or
from `python -m speech2affective_gestures_torch.train_embedding`. The
long-clip rendering of the test split is
`train.clip_eval.generate_gestures_by_dataset(trainer, ...)` on the trainer
that `main` returns (no flag runs it, as in the JAX package).

The paper's two ablations have entry points of their own with the same
flags, `main_v2_abl_audio` (the generator on the raw audio window through
a WavEncoder) and `main_v2_abl_aff` (no AffEncoder; the
ConvDiscriminator), which call `main(argv, variant=...)`; each trains in a
work dir of its own, `models/s2ag_v2_mfcc_torch{_abl_audio,_abl_aff}/`.
"""

from __future__ import annotations

import argparse
import os
import time
from os.path import join as jn

import numpy as np
import torch

from .config import ModelConfig
from .convert.from_jax import reference_state_dict
from .data import ted_db
from .device import resolve_device, set_f32_numerics
from .train.evaluator import EmbeddingSpaceEvaluator
from .train.gan_step import REMAT_MODES
from .train.trainer import Trainer, find_checkpoint

# the work dir's suffix of each variant (JAX main_v2.py:232-234)
WORK_DIR_SUFFIX = {"s2ag": "", "abl_audio": "_abl_audio", "abl_aff": "_abl_aff"}


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Speech to Emotive Gestures (PyTorch/CUDA)")
    p.add_argument("-b", "--base-path", required=True, type=str)
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("--dataset-s2ag", type=str, default="ted_db")
    p.add_argument("--dataset-test", type=str, default="ted_db")
    p.add_argument("-dap", "--dataset-s2ag-already-processed",
                   type=str2bool, default=True)
    p.add_argument("--frame-drop", type=int, default=2)
    p.add_argument("--train-s2ag", type=str2bool, default=True)
    p.add_argument("--use-multiple-gpus", type=str2bool, default=True,
                   help="accepted; training runs on one card (cuda:0) until "
                        "multi-GPU is ported (ROADMAP.md, queue 1)")
    p.add_argument("--s2ag-load-last-best", type=str2bool, default=True)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--num-worker", type=int, default=4)
    p.add_argument("--s2ag-start-epoch", type=int, default=0)
    p.add_argument("--s2ag-num-epoch", type=int, default=500)
    # the reference parses these two and applies neither (its
    # adjust_lr_s2ag call is commented out, processor_v2.py:991, and
    # gradient-clip is dropped); the --apply-* flags turn them on
    p.add_argument("--lr-s2ag-decay", type=float, default=0.999)
    p.add_argument("--gradient-clip", type=float, default=0.1)
    p.add_argument("--apply-lr-decay", type=str2bool, default=False,
                   help="decay both learning rates by --lr-s2ag-decay per epoch "
                        "of each optimizer's own updates")
    p.add_argument("--apply-gradient-clip", type=str2bool, default=False,
                   help="clip each net's gradients by their global norm to "
                        "--gradient-clip")
    p.add_argument("--loader", type=str, default="device",
                   choices=("device", "grain"),
                   help="'device' keeps the train split on the card and gathers "
                        "each batch there from the host's row draws; 'grain' keeps "
                        "it on the host and streams shuffled batches from it, "
                        "resumable in the middle of an epoch")
    p.add_argument("--mixed-precision", type=str2bool, default=False,
                   help="bf16 train steps (parameters cast per call, float32 "
                        "master weights, losses and BatchNorm statistics)")
    p.add_argument("--fused-pass", type=str2bool, default=False,
                   help="double-batch forwards: D on real and fake, and G's main "
                        "and diversity-regularizer passes, each as one 2B forward "
                        "(BatchNorm statistics over the 2B concat, one 2B noise "
                        "and dropout draw)")
    p.add_argument("--divreg-draw", type=str, default="permutation",
                   choices=("permutation", "fresh"),
                   help="diversity-regularizer second-pass speaker draw: "
                        "'permutation' = the reference's torch.randperm over "
                        "the batch's ids (processor_v2.py:902-903, default); "
                        "'fresh' = uniform draw excluding each sample's own id")
    p.add_argument("--remat", type=str, default="none", choices=REMAT_MODES,
                   help="rematerialize the differentiated forwards in the "
                        "backward: 'full' keeps no activation, 'dots' keeps the "
                        "mm/addmm outputs and recomputes the rest; the same "
                        "values as 'none'")
    p.add_argument("--metrics-lag", type=int, default=8,
                   help="steps whose metrics may stay on the card unread, so "
                        "the host queues ahead (same logged numbers; 0 = read "
                        "every step)")
    p.add_argument("--steps-per-program", type=int, default=1,
                   help="train steps per program: K > 1 captures K steps (their "
                        "batch gathers included) in one CUDA graph and replays it; "
                        "needs --loader device and --trimodal-metric-interval 1, "
                        "else the per-step loop runs (logged)")
    p.add_argument("--trimodal-metric-interval", type=int, default=1,
                   help="compute the frozen-trimodal comparison metric "
                        "every K-th train step (1 = every step = reference "
                        "parity)")
    p.add_argument("--val-interval", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=200)
    p.add_argument("--save-interval", type=int, default=10)
    p.add_argument("--torch-checkpoint", type=str, default="",
                   help="optional reference .pth.tar to load")
    p.add_argument("--trimodal-checkpoint", type=str, default="",
                   help="frozen TriModal baseline trimodal_gen.pth.tar "
                        "(reference loads outputs/trimodal_gen.pth.tar, "
                        "processor_v2.py:1033); without it the comparator "
                        "metric uses a random-init baseline")
    p.add_argument("--embedding-net-checkpoint", type=str, default="",
                   help="frozen FGD embedding net ({'embedding_dict': ...}, the "
                        "reference's outputs/embedding_net.pth.tar layout, as "
                        "train_embedding writes it); without it the test split "
                        "is scored without FGD")
    p.add_argument("--synthetic-data", type=str2bool, default=False,
                   help="use the synthetic corpus instead of the TED lmdb")
    p.add_argument("--synthetic-videos", type=int, default=4,
                   help="synthetic corpus size: number of videos (~41 windows "
                        "per 30 s of video at the paper's stride)")
    p.add_argument("--synthetic-seconds", type=float, default=12.0,
                   help="synthetic corpus: seconds per video")
    p.add_argument("--packed-data", type=str, default="",
                   help="an exported TED archive (tools/export_ted_cache.py), "
                        "read instead of the lmdb; its packed splits are cached "
                        "in it")
    p.add_argument("--device", type=str, default=None,
                   help="torch device: the card unless 'cpu' is given, which "
                        "runs every kernel's plain PyTorch version")
    p.add_argument("--print-log", action="store_true", default=True)
    p.add_argument("--save-log", action="store_true", default=True)
    # reference-CLI compatibility no-ops (main_v2.py:58-98): the reference
    # parses these and uses none of them in the v2 path
    for flag, typ, default in (
        ("--base-tr", float, 1.0),
        ("--nesterov", str2bool, True),
        ("--momentum", float, 0.9),
        ("--weight-decay", float, 5e-4),
        ("--upper-body-weight", float, 1.0),
        ("--affs-reg", float, 0.8),
        ("--quat-norm-reg", float, 0.1),
        ("--quat-reg", float, 1.2),
        ("--recons-reg", float, 1.2),
    ):
        p.add_argument(flag, type=typ, default=default,
                       help="no-op (reference parses but never uses it)")
    p.add_argument("--step", nargs="*", default=None,
                   help="no-op (reference parses but never uses it)")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="no-op (the device is --device's)")
    p.add_argument("--pavi-log", action="store_true", default=False,
                   help="no-op (stubbed in the reference too)")
    return p


def load_datasets(args, cfg: ModelConfig, device: torch.device, log=print):
    """(train, val, test) packed splits, the MFCCs of raw videos computed on
    `device`: the synthetic corpus cut 70/15/15 (`--synthetic-data`), an
    export archive (`--packed-data`) or the TED LMDB under
    `<base>/../data/<dataset_s2ag>`; without `--train-s2ag` the archive and
    the LMDB give the test split alone. The test split keeps its sidecars."""
    t0 = time.perf_counter()
    if args.synthetic_data:
        videos = ted_db.make_synthetic_videos(n_videos=args.synthetic_videos,
                                              clip_seconds=args.synthetic_seconds,
                                              device=device)
        full = ted_db.build_dataset_from_videos(videos, cfg, keep_sidecars=True,
                                                device=device)
        n = full.n_samples
        cut1, cut2 = int(n * 0.7), int(n * 0.85)
        idx = np.arange(n)
        log(f"synthetic corpus: {args.synthetic_videos} videos of "
            f"{args.synthetic_seconds} s, {n} windows ({cut1} train, "
            f"{cut2 - cut1} val, {n - cut2} test) built in "
            f"{time.perf_counter() - t0:.3f} s")
        return (full.subset(idx[:cut1]), full.subset(idx[cut1:cut2]),
                full.subset(idx[cut2:], sidecars=True))
    if args.packed_data:
        source = f"export archive {args.packed_data}"
        splits = ted_db.load_exported_data(args.packed_data, cfg,
                                           load_train_val=args.train_s2ag, device=device)
    else:
        lmdb_base = jn(args.base_path, "..", "data", args.dataset_s2ag)
        source = f"TED lmdb {lmdb_base}"
        splits = ted_db.load_ted_db_data(lmdb_base, cfg, load_train_val=args.train_s2ag,
                                         device=device)
    counts = ", ".join(f"{ds.n_samples} {name}" for name, ds in splits.items())
    log(f"{source}: {sum(ds.n_samples for ds in splits.values())} windows "
        f"({counts}) in {time.perf_counter() - t0:.3f} s")
    return splits.get("train"), splits.get("val"), splits.get("test")


def checkpoint_to_load(args, work_dir: str) -> str | None:
    """The `.pth.tar` whose weights `main` loads: `--torch-checkpoint`, else
    with `--s2ag-load-last-best` the work dir's best checkpoint (or that of
    epoch `--s2ag-start-epoch`); None when there is none."""
    if args.torch_checkpoint:
        return args.torch_checkpoint
    if args.s2ag_load_last_best:
        found = find_checkpoint(work_dir, "best" if args.s2ag_start_epoch == 0
                                else args.s2ag_start_epoch)
        if found:
            return jn(work_dir, found[0])
    return None


def checkpoint_speakers(path: str | None) -> int | None:
    """The speaker count of a checkpoint's generator. The speaker
    vocabularies are per split, so a run that loads only the test split
    sizes the speaker embedding from the weights it loads. None without a
    checkpoint, or for a generator with no speaker embedding (a `random`
    or `none` z)."""
    if path is None:
        return None
    table = reference_state_dict(path).get("speaker_embedding.0.weight")
    return None if table is None else table.shape[0]


def main(argv=None, variant: str = "s2ag") -> Trainer:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()
    cfg = ModelConfig.from_yaml(args.config, batch_size=args.batch_size)

    work_dir = jn(args.base_path, "models",
                  f"s2ag_v2_mfcc_torch{WORK_DIR_SUFFIX[variant]}", args.dataset_s2ag)
    os.makedirs(work_dir, exist_ok=True)
    os.makedirs(jn(args.base_path, "outputs", args.dataset_test,
                   "videos_trimodal_style"), exist_ok=True)

    logs: list[str] = []
    train_data, val_data, test_data = load_datasets(args, cfg, device, logs.append)
    evaluator = None
    if args.embedding_net_checkpoint:
        evaluator = EmbeddingSpaceEvaluator.from_torch_checkpoint(
            args.embedding_net_checkpoint, device=device)
    trainer = Trainer(
        cfg, work_dir, train_data=train_data, val_data=val_data,
        test_data=test_data, device=device, val_interval=args.val_interval,
        save_interval=args.save_interval, seed=cfg.random_seed, variant=variant,
        trimodal_metric_interval=args.trimodal_metric_interval,
        divreg_draw=args.divreg_draw, metrics_lag=args.metrics_lag,
        log_interval=args.log_interval, evaluator=evaluator,
        mixed_precision=args.mixed_precision,
        gradient_clip=args.gradient_clip if args.apply_gradient_clip else 0.0,
        lr_decay=args.lr_s2ag_decay if args.apply_lr_decay else 1.0,
        n_speakers=checkpoint_speakers(checkpoint_to_load(args, work_dir)),
        fused_pass=args.fused_pass, remat=args.remat, loader=args.loader,
        steps_per_program=args.steps_per_program)
    trainer.logger.save_arg(vars(args))
    for line in logs:
        trainer.logger.print_log(line)
    trainer.logger.print_log(
        f"epoch engine: {trainer.epoch_engine} ({trainer.steps_per_program} train steps a "
        f"program, loader {args.loader})"
        + (f"; {trainer.epoch_engine_fallback}" if trainer.epoch_engine_fallback else ""))
    if not args.apply_lr_decay:
        trainer.logger.print_log(
            "--lr-s2ag-decay accepted for compatibility but UNUSED (the "
            "reference's adjust_lr_s2ag call is commented out, "
            "processor_v2.py:991); pass --apply-lr-decay true to enable.")
    if not args.apply_gradient_clip:
        trainer.logger.print_log(
            "--gradient-clip accepted for compatibility but UNUSED (the "
            "reference parses and drops it); pass --apply-gradient-clip "
            "true to enable.")
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        trainer.logger.print_log(
            f"{torch.cuda.device_count()} cards visible; training on cuda:0 "
            "(multi-GPU training: ROADMAP.md, queue 1, item 5)")

    if args.trimodal_checkpoint:
        trainer.load_trimodal_torch_checkpoint(args.trimodal_checkpoint)
    else:
        default_tri = jn(args.base_path, "outputs", "trimodal_gen.pth.tar")
        if os.path.exists(default_tri):
            trainer.load_trimodal_torch_checkpoint(default_tri)
        else:
            trainer.logger.print_log(
                "Warning: no trimodal_gen.pth.tar; the s2ag_vs_trimodal "
                "comparison uses a random-init baseline.")
    if args.torch_checkpoint:
        trainer.load_torch_checkpoint(args.torch_checkpoint)
    elif args.s2ag_load_last_best:
        trainer.load_checkpoint(
            "best" if args.s2ag_start_epoch == 0 else args.s2ag_start_epoch)

    if args.train_s2ag:
        trainer.train(epochs=args.s2ag_num_epoch)
    if test_data is not None and test_data.n_samples > 0:
        trainer.generate_gestures(batch_size=min(2048, test_data.n_samples),
                                  randomized=False)
    return trainer


if __name__ == "__main__":
    main()
