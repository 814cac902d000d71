"""Train the FGD gesture-embedding autoencoder and write it in the
reference's checkpoint layout (the port's counterpart of the JAX package's
`tools/train_embedding.py`):

    python -m speech2affective_gestures_torch.train_embedding --synthetic-data \\
        --out emb.pth.tar

trains `EmbeddingNet(mode="pose")` (`train/embedding_trainer.py`) on the
corpus's pose windows, on the card unless `--device cpu` is given, and
writes `{"embedding_dict": state_dict}` to `--out`, the layout of the
reference's `outputs/embedding_net.pth.tar`: `main_v2
--embedding-net-checkpoint` and the reference's evaluator load it. That
file is the port's native format (the JAX tool's `.npz` of flax variables
is not written). The windows come from the train split of the TED LMDB
under `--base-path` (`ted_db.load_ted_db_data`, as the JAX tool reads it),
or from the synthetic corpus with `--synthetic-data` or without a base
path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import ModelConfig
from .data import ted_db
from .device import resolve_device
from .train.embedding_trainer import train_pose_embedding


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the FGD gesture-embedding net")
    p.add_argument("--base-path", default=None,
                   help="the TED db's directory, which holds the config's "
                        "<split>_data_path LMDBs")
    p.add_argument("--config", default="config/multimodal_context_v2.yml")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=5e-4)
    p.add_argument("--variational", action="store_true")
    p.add_argument("--max-windows", type=int, default=50000,
                   help="cap on training windows (device-memory bound)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="embedding_net.pth.tar")
    p.add_argument("--device", default=None,
                   help="torch device: the card unless 'cpu' is given")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = (ModelConfig.from_yaml(args.config) if os.path.exists(args.config)
           else ModelConfig())
    if args.synthetic_data or not args.base_path:
        videos = ted_db.make_synthetic_videos(n_videos=6, clip_seconds=12.0,
                                              device=device)
        ds = ted_db.build_dataset_from_videos(videos, cfg, device=device)
    else:
        ds = ted_db.load_ted_db_data(args.base_path, cfg, device=device)["train"]
    idx = np.arange(min(args.max_windows, ds.n_samples))
    windows = ted_db.decode_rows(ds, idx)["vec_seq"]
    print(f"training on {len(windows)} pose windows ({args.epochs} epochs, "
          f"bs {args.batch_size}) on {device}", flush=True)
    result = train_pose_embedding(
        windows, epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, variational=args.variational,
        seed=args.seed, log_every=1, device=device,
        log=lambda line: print(line, flush=True))
    print(f"final reconstruction loss {result['final_loss']:.6f}")
    torch.save({"embedding_dict": result["state_dict"]}, args.out)
    print(f"wrote {args.out} (reference embedding_net.pth.tar layout)")
    return result


if __name__ == "__main__":
    main()
