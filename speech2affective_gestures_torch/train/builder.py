"""Model and step assembly for training (reference processor_v2.py:135-177
and its ablations' processors): the PoseGenerator and its discriminator as
the trainable pair, the PoseGeneratorTriModal as the frozen comparator. The
`variant` picks the paper model ("s2ag") or one of its two ablations
("abl_audio": the generator on the raw audio window through a WavEncoder;
"abl_aff": the generator without the AffEncoder, and the ConvDiscriminator),
as the JAX package's train/builder.py:22-71 does."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import constants as C
from ..config import ModelConfig
from ..device import resolve_device
from ..models.discriminator import AffDiscriminator, ConvDiscriminator
from ..models.generator import PoseGeneratorTriModal, make_pose_generator
from .gan_step import GanConfig, GanStep


def build_models(cfg: ModelConfig, n_words: int, n_speakers: int,
                 word_embeddings: np.ndarray | None = None,
                 variant: str = "s2ag"):
    """(generator, discriminator, TriModal comparator) of `variant` at the
    config's widths, input context and z type."""
    gen = make_pose_generator(cfg, n_words, n_speakers, variant, word_embeddings)
    dis = (ConvDiscriminator(n_poses=cfg.n_poses) if variant == "abl_aff"
           else AffDiscriminator(n_poses=cfg.n_poses))
    tri = PoseGeneratorTriModal(
        n_words=n_words, word_embed_size=cfg.wordembed_dim, hidden_size=cfg.hidden_size,
        n_layers=cfg.n_layers, dropout_prob=cfg.dropout_prob, n_speakers=n_speakers,
        word_embeddings=word_embeddings, freeze_embedding=cfg.freeze_wordembed,
        input_context=cfg.input_context, z_type=cfg.z_type)
    return gen, dis, tri


def gan_config(cfg: ModelConfig, n_speakers: int,
               divreg_draw: str = "permutation", gradient_clip: float = 0.0,
               lr_decay: float = 1.0, decay_steps_per_epoch: int = 0,
               variant: str = "s2ag") -> GanConfig:
    return GanConfig(
        loss_regression_weight=cfg.loss_regression_weight,
        loss_gan_weight=cfg.loss_gan_weight,
        loss_kld_weight=cfg.loss_kld_weight,
        loss_reg_weight=cfg.loss_reg_weight,
        loss_warmup=cfg.loss_warmup,
        learning_rate=cfg.learning_rate,
        discriminator_lr_weight=cfg.discriminator_lr_weight,
        z_type=cfg.z_type,
        n_pre_poses=cfg.n_pre_poses,
        n_speakers=n_speakers,
        generator_input="audio" if variant == "abl_audio" else "mfcc_features",
        divreg_draw=divreg_draw,
        gradient_clip=gradient_clip,
        lr_decay=lr_decay,
        decay_steps_per_epoch=decay_steps_per_epoch,
    )


def synthetic_batch(rng: np.random.Generator, batch_size: int,
                    cfg: ModelConfig, n_words: int = 1000,
                    n_speakers: int = 100) -> dict:
    """A batch with the geometry of the packed TED-db cache
    (processor_v2.py:278-283), numpy, for smoke runs and timing."""
    t = cfg.n_poses
    return {
        "extended_word_seq": rng.integers(0, n_words, (batch_size, t)).astype(np.int64),
        "vec_seq": (rng.standard_normal((batch_size, t, C.POSE_DIM)) * 0.1).astype(np.float32),
        "audio": (rng.standard_normal((batch_size, cfg.expected_audio_length)) * 0.1).astype(np.float32),
        "mfcc_features": rng.standard_normal(
            (batch_size, cfg.num_mfcc_combined, cfg.mfcc_length)).astype(np.float32),
        "vid_indices": rng.integers(0, n_speakers, (batch_size,)).astype(np.int64),
    }


def cast_floats(x, src: torch.dtype, dst: torch.dtype):
    """x at dst if it is a tensor of dtype src; tuples and lists walked."""
    if isinstance(x, (tuple, list)):
        return type(x)(cast_floats(v, src, dst) for v in x)
    return x.to(dst) if isinstance(x, torch.Tensor) and x.dtype == src else x


@contextlib.contextmanager
def bf16_parameters(module: torch.nn.Module):
    """Inside the block every float32 parameter of `module` is its bf16
    cast (differentiable, so gradients reach the float32 parameter as
    float32); after it the parameters are put back. The casts stand in the
    modules' parameter slots, so a module held under two names (the TCN
    blocks hold their convs so) sees them under both; buffers are not
    cast."""
    swapped = []
    try:
        for m in module.modules():
            for name, p in m._parameters.items():
                if p is not None and p.dtype == torch.float32:
                    swapped.append((m, name, p))
                    m._parameters[name] = p.to(torch.bfloat16)
        yield module
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


def mixed_precision_apply(module: torch.nn.Module):
    """The module's forward at bf16, as the JAX package's
    `mixed_precision_apply` (train/builder.py:87-113) wraps an apply
    function: for each call every float32 parameter is cast to bf16
    (`bf16_parameters`) and the float32 positional inputs too; every bf16
    output is cast back to float32. The BatchNorm running stats, buffers,
    stay float32 (`layers.BatchNorm1d`). Not torch.autocast, which picks a
    precision per op; here everything that the wrapper casts runs at
    bf16."""
    def wrapped(*args, **kwargs):
        with bf16_parameters(module):
            out = module(*cast_floats(args, torch.float32, torch.bfloat16), **kwargs)
        return cast_floats(out, torch.bfloat16, torch.float32)

    return wrapped


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device` (integer arrays as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def init_training(cfg: ModelConfig, seed: int, n_words: int = 1000,
                  n_speakers: int = 100,
                  word_embeddings: np.ndarray | None = None,
                  device: str | torch.device | None = None, variant: str = "s2ag",
                  divreg_draw: str = "permutation",
                  mixed_precision: bool = False, gradient_clip: float = 0.0,
                  lr_decay: float = 1.0, decay_steps_per_epoch: int = 0) -> dict:
    """Models of `variant` (`build_models`) with weights drawn from `seed`
    on `device` (the card unless `device="cpu"`), and the step over them,
    which feeds abl_audio's generator the raw audio: with `mixed_precision` its
    train step runs the three nets through `mixed_precision_apply` (JAX
    `init_training`, builder.py:204-215); its eval step stays float32.
    `gradient_clip`, `lr_decay` and `decay_steps_per_epoch` go to the
    step's `GanConfig` (JAX builder.py:120-180)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen, dis, tri = build_models(cfg, n_words, n_speakers, word_embeddings,
                                     variant=variant)
    gen, dis, tri = gen.to(dev), dis.to(dev), tri.to(dev).requires_grad_(False)
    gan_cfg = gan_config(cfg, n_speakers, divreg_draw, gradient_clip, lr_decay,
                         decay_steps_per_epoch, variant)
    return dict(gen=gen, dis=dis, tri=tri, gan_cfg=gan_cfg, device=dev,
                step=GanStep(gen, dis, gan_cfg, tri,
                             train_apply=mixed_precision_apply if mixed_precision else None))
