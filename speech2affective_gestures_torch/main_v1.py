"""The v1 entry point: speech emotion recognition (SER) on IEMOCAP, then the
emotion-conditioned s2eg GAN; the port's counterpart of the JAX package's
`main_v1.py` (the reference's `main.py` + `processor.py`, whose own copy
does not run: its main.py:15 imports a `config.parse_args` that does not
exist, so this follows its intended flow as the JAX package does).

    python -m speech2affective_gestures_torch.main_v1 -b BASE_PATH \\
        -c config/multimodal_context_v2.yml --synthetic-data true

Trains AttConvRNN (dropout 0.2) on the IEMOCAP log-mel blocks of
`<base>/../data/<dataset_ser>` with cross-entropy, logging each epoch's
last loss and its val accuracy; then PoseGeneratorV1 and
AffDiscriminatorV1 on the TED corpus under `<base>/../data/ted_db`, each
batch conditioned on the SER net's predicted one-hot. `--synthetic-data
true` puts random SER blocks and the synthetic TED corpus (its MFCCs
computed on the device) in place of both datasets. The work dir is
`<base>/models/v1_ser_s2eg`, with its `log.txt`.

Runs on the card unless `--device cpu` is given (every kernel's plain
PyTorch version). Kept from the JAX package on purpose:
- the s2eg loop feeds the SER net all-zero blocks, one batch a step (no
  IEMOCAP-aligned audio exists for the TED clips), and conditions G and D
  on the argmax of those logits;
- the GAN's loss weights and the discriminator's learning-rate factor are
  `GanConfig`'s defaults, not the YAML's (only the learning rate, z type,
  seed length and speaker count come from the config and the corpus), and
  the GAN terms are on from the first step;
- the step's details in `train/ser_trainer.S2egStep`.
Every flag of the JAX parser is taken, the reference-compatibility no-ops
and aliases among them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from os.path import join as jn

import numpy as np
import torch

from .config import ModelConfig
from .data import iemocap, ted_db
from .device import resolve_device, set_f32_numerics
from .main_v2 import str2bool
from .models.discriminator import AffDiscriminatorV1
from .models.generator import PoseGeneratorV1
from .models.ser import AttConvRNN, apply_reference_init
from .train import ser_trainer
from .train.builder import to_device
from .train.gan_step import GanConfig
from .train.logger import TrainLogger

NUM_EMOTIONS = len(iemocap.EMOTIONS_07)
# the SER blocks: 300 frames of 40 mel filters, 3 channels
BLOCK_SHAPE = (300, 40, 3)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="v1: SER + s2eg joint training (PyTorch/CUDA)")
    p.add_argument("-b", "--base-path", required=True, type=str)
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("--dataset-ser", type=str, default="iemocap")
    p.add_argument("--train-ser", type=str2bool, default=True)
    p.add_argument("--train-s2eg", type=str2bool, default=True)
    p.add_argument("--emo-as-cats", type=str2bool, default=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--ser-num-epoch", type=int, default=1)
    p.add_argument("--s2eg-num-epoch", type=int, default=1)
    p.add_argument("--base-lr", type=float, default=1e-3)
    p.add_argument("--optimizer", type=str, default="sgd")
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--nesterov", type=str2bool, default=True)
    p.add_argument("--synthetic-data", type=str2bool, default=False)
    p.add_argument("--device", type=str, default=None,
                   help="torch device: the card unless 'cpu' is given, which "
                        "runs every kernel's plain PyTorch version")
    # reference-CLI compatibility (main.py:40-122): aliases of the flags
    # above, which override them only when passed
    p.add_argument("--base-lr-ser", type=float, dest="base_lr",
                   default=argparse.SUPPRESS,
                   help="alias of --base-lr (reference main.py:81)")
    p.add_argument("--ser-optimizer", type=str, dest="optimizer",
                   default=argparse.SUPPRESS,
                   help="alias of --optimizer (main.py:79)")
    # parsed and unused by the reference's v1 processor, or about its GPUs
    for flag, typ, default in (
        ("--dataset-s2eg", str, "ted_db"),
        ("--frame-drop", int, 2),
        ("--add-mirrored", str2bool, False),
        ("--use-multiple-gpus", str2bool, True),
        ("--ser-load-last-best", str2bool, True),
        ("--s2eg-load-last-best", str2bool, True),
        ("--num-worker", int, 4),
        ("--ser-start-epoch", int, 0),
        ("--s2eg-start-epoch", int, 0),
        ("--base-tr", float, 1.0),
        ("--lr-ser-decay", float, 0.999),
        ("--lr-s2eg-decay", float, 0.999),
        ("--gradient-clip", float, 0.1),
        ("--momentum", float, 0.9),
        ("--upper-body-weight", float, 1.0),
        ("--affs-reg", float, 0.8),
        ("--quat-norm-reg", float, 0.1),
        ("--quat-reg", float, 1.2),
        ("--recons-reg", float, 1.2),
        ("--eval-interval", int, 1),
        ("--log-interval", int, 100),
        ("--save-interval", int, 10),
    ):
        p.add_argument(flag, type=typ, default=default,
                       help="no-op (reference-CLI compatibility)")
    p.add_argument("-dap", "--dataset-s2eg-already-processed",
                   type=str2bool, default=True,
                   help="no-op (reference-CLI compatibility)")
    p.add_argument("--step", nargs="*", default=None,
                   help="no-op (reference-CLI compatibility)")
    for flag in ("--no-cuda", "--pavi-log", "--print-log", "--save-log"):
        p.add_argument(flag, action="store_true", default=False,
                       help="no-op (reference-CLI compatibility)")
    return p


def synthetic_ser_split(rng: np.random.Generator, n: int = 64):
    """Random blocks (n, 300, 40, 3) and one-hot labels, drawn as the JAX
    package's `_synthetic_ser_split`."""
    data = rng.standard_normal((n, *BLOCK_SHAPE)).astype(np.float32)
    labels = np.eye(NUM_EMOTIONS, dtype=np.float32)[rng.integers(0, NUM_EMOTIONS, n)]
    return data, labels


@dataclasses.dataclass
class V1Run:
    """What `main` trained, on `device`: the SER net and its optimizer, its
    last val accuracy, the s2eg step (None without `--train-s2eg`), its
    corpus and its last metrics."""

    ser: AttConvRNN
    ser_opt: torch.optim.Optimizer
    val_accuracy: float
    s2eg: ser_trainer.S2egStep | None
    dataset: ted_db.PackedDataset | None
    s2eg_metrics: dict
    device: torch.device


def evaluate_ser(ser, data: np.ndarray, labels: np.ndarray, batch_size: int,
                 device: torch.device) -> float:
    """The eval step's accuracy over all of `data`, `batch_size` blocks a
    call (the same accuracy as one call over all of them: eval mode treats
    each block alone)."""
    hits = 0.0
    for i in range(0, len(data), batch_size):
        x, y = (torch.from_numpy(a[i:i + batch_size]).to(device) for a in (data, labels))
        hits += float(ser_trainer.ser_eval_step(ser, x, y)[2]) * len(x)
    return hits / len(data)


def main(argv=None) -> V1Run:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()
    cfg = ModelConfig.from_yaml(args.config, batch_size=args.batch_size)
    work_dir = jn(args.base_path, "models", "v1_ser_s2eg")
    os.makedirs(work_dir, exist_ok=True)
    logger = TrainLogger(work_dir)
    rng_np = np.random.default_rng(0)

    # ------------------------------------------------------------- SER
    if args.synthetic_data:
        train_x, train_y = synthetic_ser_split(rng_np)
        val_x, val_y = synthetic_ser_split(rng_np, 16)
    else:
        data = iemocap.load_iemocap_data(jn(args.base_path, "..", "data"), args.dataset_ser)
        train_x, train_y = data["train_data_wav"], data["train_labels_cat"]
        val_x, val_y = data["val_data_wav"], data["val_labels_cat"]
    train_y, val_y = train_y.astype(np.float32), val_y.astype(np.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ser = AttConvRNN(num_emotions=NUM_EMOTIONS, dropout_prob=0.2)
    apply_reference_init(ser, torch.Generator().manual_seed(42))
    ser.to(device)
    ser_opt = ser_trainer.make_ser_optimizer(ser.parameters(), args.optimizer, args.base_lr,
                                             args.weight_decay, args.nesterov)
    generator = torch.Generator(device=device).manual_seed(2)
    ser_metrics, val_accuracy = {}, float("nan")
    bs = args.batch_size
    if args.train_ser:
        for epoch in range(args.ser_num_epoch):
            perm = rng_np.permutation(len(train_x))
            for i in range(0, len(perm) - bs + 1, bs):
                idx = perm[i:i + bs]
                x, y = (torch.from_numpy(a[idx]).to(device) for a in (train_x, train_y))
                ser_metrics = ser_trainer.ser_train_step(ser, ser_opt, x, y, generator,
                                                         args.emo_as_cats)
            val_accuracy = evaluate_ser(ser, val_x, val_y, bs, device)
            loss = float(ser_metrics["loss"]) if ser_metrics else float("nan")
            logger.print_log(f"SER epoch {epoch}: loss {loss:.4f} "
                             f"val_accuracy {val_accuracy:.4f}")

    # ------------------------------------------------------------- s2eg
    s2eg, ds, s2eg_metrics = None, None, {}
    if args.train_s2eg:
        if args.synthetic_data:
            videos = ted_db.make_synthetic_videos(n_videos=2, clip_seconds=8.0, device=device)
            ds = ted_db.build_dataset_from_videos(videos, cfg, device=device)
        else:
            ds = ted_db.load_ted_db_data(jn(args.base_path, "..", "data", "ted_db"), cfg,
                                         device=device)["train"]
        n_speakers = ds.speaker_model.n_words
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(3)
            gen = PoseGeneratorV1(
                num_emotions=NUM_EMOTIONS, n_words=ds.lang_model.n_words,
                n_speakers=n_speakers, hidden_size=cfg.hidden_size, n_layers=cfg.n_layers,
                dropout_prob=cfg.dropout_prob, z_type=cfg.z_type)
            dis = AffDiscriminatorV1(num_emotions=NUM_EMOTIONS, n_poses=cfg.n_poses)
        gan_cfg = GanConfig(learning_rate=cfg.learning_rate, z_type=cfg.z_type,
                            n_pre_poses=cfg.n_pre_poses, n_speakers=n_speakers)
        s2eg = ser_trainer.S2egStep(gen.to(device), dis.to(device), gan_cfg)
        blocks = torch.zeros((cfg.batch_size, *BLOCK_SHAPE), device=device)
        no_labels = torch.zeros((cfg.batch_size, NUM_EMOTIONS), device=device)
        for epoch in range(args.s2eg_num_epoch):
            for batch in ted_db.BatchSampler(ds, cfg.batch_size, seed=epoch):
                # the SER's prediction on all-zero blocks: no IEMOCAP-aligned
                # audio exists for the TED clips
                _, emo_one_hot, _ = ser_trainer.ser_eval_step(ser, blocks, no_labels)
                batch = to_device(batch, device)
                batch["emo_labels"] = emo_one_hot
                s2eg_metrics = s2eg.train_step(batch, generator, gan_on=True)
            logger.print_log(f"s2eg epoch {epoch}: " + " | ".join(
                f"{k}: {float(v):.4f}" for k, v in s2eg_metrics.items()))
    return V1Run(ser, ser_opt, val_accuracy, s2eg, ds, s2eg_metrics, device)


if __name__ == "__main__":
    main()
