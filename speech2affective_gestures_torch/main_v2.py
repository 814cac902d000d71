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
plain PyTorch version). The data come from the synthetic corpus
(`--synthetic-data true`). A flag that selects something not ported yet
raises and names its ROADMAP.md item: the TED LMDB and exported-archive
readers, mixed precision, the fused pass, rematerialization, the grain
loader, several steps per program, gradient clipping, learning-rate decay.
The embedding net comes from the reference's `embedding_net.pth.tar` or
from `python -m speech2affective_gestures_torch.train_embedding`. The
long-clip rendering of the test split (`train/clip_eval.py`) is not ported
yet (ROADMAP.md, queue 1, item 2).
"""

from __future__ import annotations

import argparse
import os
import time
from os.path import join as jn

import numpy as np
import torch

from .config import ModelConfig
from .data import ted_db
from .device import resolve_device, set_f32_numerics
from .train.evaluator import EmbeddingSpaceEvaluator
from .train.trainer import Trainer

_ROADMAP = "not ported yet (ROADMAP.md, queue 1)"


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
    # parsed for reference-CLI compatibility; the reference applies neither
    # (its adjust_lr_s2ag call is commented out, processor_v2.py:991, and
    # gradient-clip is parsed and dropped)
    p.add_argument("--lr-s2ag-decay", type=float, default=0.999)
    p.add_argument("--gradient-clip", type=float, default=0.1)
    p.add_argument("--apply-lr-decay", type=str2bool, default=False,
                   help=f"per-epoch LR decay: {_ROADMAP}")
    p.add_argument("--apply-gradient-clip", type=str2bool, default=False,
                   help=f"global-norm gradient clipping: {_ROADMAP}")
    p.add_argument("--loader", type=str, default="device",
                   choices=("device", "grain"),
                   help=f"'device' samples batches on the host and copies them "
                        f"to the card; 'grain' is {_ROADMAP}")
    p.add_argument("--mixed-precision", type=str2bool, default=False,
                   help=f"bf16 training step: {_ROADMAP}")
    p.add_argument("--fused-pass", type=str2bool, default=False,
                   help=f"double-batch forwards: {_ROADMAP}")
    p.add_argument("--divreg-draw", type=str, default="permutation",
                   choices=("permutation", "fresh"),
                   help="diversity-regularizer second-pass speaker draw: "
                        "'permutation' = the reference's torch.randperm over "
                        "the batch's ids (processor_v2.py:902-903, default); "
                        "'fresh' = uniform draw excluding each sample's own id")
    p.add_argument("--remat", type=str, default="none",
                   choices=("none", "full", "dots"),
                   help=f"rematerialized forwards: {_ROADMAP}")
    p.add_argument("--metrics-lag", type=int, default=8,
                   help="steps whose metrics may stay on the card unread, so "
                        "the host queues ahead (same logged numbers; 0 = read "
                        "every step)")
    p.add_argument("--steps-per-program", type=int, default=1,
                   help=f"several steps per program: {_ROADMAP}")
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
                   help="use the synthetic corpus instead of TED lmdb")
    p.add_argument("--synthetic-videos", type=int, default=4,
                   help="synthetic corpus size: number of videos (~41 windows "
                        "per 30 s of video at the paper's stride)")
    p.add_argument("--synthetic-seconds", type=float, default=12.0,
                   help="synthetic corpus: seconds per video")
    p.add_argument("--packed-data", type=str, default="",
                   help=f"exported TED archive: {_ROADMAP}")
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


def check_ported(args) -> None:
    """Raise for a flag that selects something this port does not have."""
    unported = {
        "--mixed-precision true": args.mixed_precision,
        "--fused-pass true": args.fused_pass,
        f"--remat {args.remat}": args.remat != "none",
        "--loader grain": args.loader == "grain",
        f"--steps-per-program {args.steps_per_program}": args.steps_per_program > 1,
        "--apply-gradient-clip true": args.apply_gradient_clip,
        "--apply-lr-decay true": args.apply_lr_decay,
        "--packed-data": bool(args.packed_data),
        "the TED lmdb dataset (no --synthetic-data)": not args.synthetic_data,
    }
    chosen = [flag for flag, on in unported.items() if on]
    if chosen:
        raise NotImplementedError(f"{', '.join(chosen)}: {_ROADMAP}")


def load_datasets(args, cfg: ModelConfig, device: torch.device, log=print):
    """Train/val/test splits (70/15/15) of the synthetic corpus, its MFCCs
    computed on `device`."""
    t0 = time.perf_counter()
    videos = ted_db.make_synthetic_videos(n_videos=args.synthetic_videos,
                                          clip_seconds=args.synthetic_seconds,
                                          device=device)
    full = ted_db.build_dataset_from_videos(videos, cfg, device=device)
    n = full.n_samples
    cut1, cut2 = int(n * 0.7), int(n * 0.85)
    idx = np.arange(n)
    log(f"synthetic corpus: {args.synthetic_videos} videos of "
        f"{args.synthetic_seconds} s, {n} windows ({cut1} train, "
        f"{cut2 - cut1} val, {n - cut2} test) built in "
        f"{time.perf_counter() - t0:.3f} s")
    return (full.subset(idx[:cut1]), full.subset(idx[cut1:cut2]),
            full.subset(idx[cut2:]))


def main(argv=None, variant: str = "s2ag") -> Trainer:
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()
    cfg = ModelConfig.from_yaml(args.config, batch_size=args.batch_size)

    work_dir = jn(args.base_path, "models", "s2ag_v2_mfcc_torch", args.dataset_s2ag)
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
        log_interval=args.log_interval, evaluator=evaluator)
    trainer.logger.save_arg(vars(args))
    for line in logs:
        trainer.logger.print_log(line)
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
