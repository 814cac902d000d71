"""Model configuration read from the YAML files under `config/`.

The fields are the ones the serving and training paths read, with the
defaults of the reference's `parse_args.py` overridden by
`config/multimodal_context_v2.yml`; other YAML keys are ignored, so the
reference's own YAML files load unchanged.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any

import numpy as np
import yaml

from . import constants as C


@dataclasses.dataclass
class ModelConfig:
    num_mfcc: int = 14
    mean_dir_vec: tuple = tuple(C.MEAN_DIR_VEC.tolist())
    mean_pose: tuple = tuple(C.MEAN_POSE.tolist())
    random_seed: int = -1

    # the TED LMDB splits, relative to the dataset directory
    train_data_path: str = "data/ted_db/lmdb_train"
    val_data_path: str = "data/ted_db/lmdb_val"
    test_data_path: str = "data/ted_db/lmdb_test"

    wordembed_path: str | None = None
    wordembed_dim: int = 300
    freeze_wordembed: bool = False

    epochs: int = 100
    batch_size: int = 128
    dropout_prob: float = 0.3
    n_layers: int = 4
    hidden_size: int = 300          # the TriModal comparator's GRU
    hidden_size_s2eg: int = 300     # the s2ag generator's GRU
    z_type: str = "speaker"
    input_context: str = "both"

    motion_resampling_framerate: int = 15
    n_poses: int = 34
    n_pre_poses: int = 4
    subdivision_stride: int = 10

    learning_rate: float = 5e-4
    discriminator_lr_weight: float = 0.2
    loss_regression_weight: float = 500.0
    loss_gan_weight: float = 5.0
    loss_kld_weight: float = 0.1
    loss_reg_weight: float = 0.05
    loss_warmup: int = 0

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path, **overrides: Any) -> "ModelConfig":
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        known = {}
        for k, v in raw.items():
            if k not in fields:
                continue
            # YAML 1.1 reads exponent literals without a dot ('5e-4') as
            # strings; coerce scalars to the dataclass field's type.
            default = fields[k].default
            if isinstance(default, float) and isinstance(v, (str, int)):
                v = float(v)
            elif isinstance(default, int) and not isinstance(default, bool) \
                    and isinstance(v, str):
                v = int(float(v))
            known[k] = v
        known.update(overrides)
        cfg = cls(**known)
        cfg.mean_dir_vec = tuple(np.asarray(cfg.mean_dir_vec, np.float32).reshape(-1))
        cfg.mean_pose = tuple(np.asarray(cfg.mean_pose, np.float32).reshape(-1))
        return cfg

    # --- derived geometry (reference loader_v2.py:480-484, processor_v2.py:124)
    @property
    def expected_audio_length(self) -> int:
        return int(round(self.n_poses / self.motion_resampling_framerate * C.AUDIO_SR))

    @property
    def num_mfcc_combined(self) -> int:
        return self.num_mfcc * 3 - 5

    @property
    def mfcc_length(self) -> int:
        return int(np.ceil(self.expected_audio_length / 512))

    @property
    def mean_dir_vec_array(self) -> np.ndarray:
        return np.asarray(self.mean_dir_vec, np.float32).reshape(-1)

    @property
    def mean_pose_array(self) -> np.ndarray:
        return np.asarray(self.mean_pose, np.float32).reshape(-1)
