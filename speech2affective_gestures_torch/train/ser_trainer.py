"""The v1 pipeline's steps (JAX `train/ser_trainer.py`; reference
`processor.py`, the legacy joint trainer): the SER net's train and eval
steps, and the emotion-conditioned s2eg GAN step.

- SER optimizers (processor.py:238-248): SGD (momentum 0.9, Nesterov) or
  Adam, each with L2 weight decay added to the gradients (optax's
  `add_decayed_weights` ahead of the update; torch's `weight_decay`, not
  AdamW's decoupled decay).
- SER train step (processor.py:616-637): softmax cross-entropy on one-hot
  labels, or with `emo_as_cats=False` L1 plus the L1 of the differences
  between consecutive rows; BatchNorm statistics updated; accuracy.
- SER eval step: argmax, its one-hot, accuracy.
- s2eg GAN step (processor.py:681-836): the s2ag step's shape
  (`train/gan_step.py`), with the emotion one-hot an input of G and D.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import layers as L
from . import gan_step, losses
from .gan_step import GanConfig, build_pre_seq


def make_ser_optimizer(params, kind: str = "sgd", lr: float = 1e-3,
                       weight_decay: float = 5e-4,
                       nesterov: bool = True) -> torch.optim.Optimizer:
    """SGD(momentum 0.9, `nesterov`) or Adam, with L2 weight decay (JAX
    ser_trainer.py:26-37)."""
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=nesterov,
                               weight_decay=weight_decay)
    if kind == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(kind)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels.argmax(-1)).float().mean()


def ser_train_step(net: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   data: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator | None = None,
                   emo_as_cats: bool = True) -> dict[str, torch.Tensor]:
    """One update of `net` on blocks `data` (B, H, W, 3) and labels (B,
    num_emotions), the dropout masks drawn from `generator`; returns
    {"loss", "accuracy"} on the device (JAX ser_trainer.py:40-71)."""
    net.train()
    with L.dropout_rng(generator):
        logits = net(data)
    labels = labels.to(logits.dtype)
    if emo_as_cats:
        loss = -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    else:
        loss = (logits - labels).abs().mean() + (
            (logits[1:] - logits[:-1]) - (labels[1:] - labels[:-1])).abs().mean()
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), "accuracy": _accuracy(logits.detach(), labels)}


@torch.no_grad()
def ser_eval_step(net: torch.nn.Module, data: torch.Tensor, labels: torch.Tensor):
    """Eval-mode logits of `data` -> (pred (B,), its one-hot (B,
    num_emotions) at the logits' dtype, accuracy against `labels`) (JAX
    ser_trainer.py:74-84)."""
    logits = net.eval()(data)
    pred = logits.argmax(-1)
    one_hot = F.one_hot(pred, logits.shape[-1]).to(logits.dtype)
    return pred, one_hot, _accuracy(logits, labels.to(logits.device))


class S2egStep:
    """The v1 GAN step (JAX ser_trainer.py:87-181) over PoseGeneratorV1,
    AffDiscriminatorV1 and the Adam pair of `gan_step.make_optimizers`: one
    D update, then one G update (Huber; with the speaker z the diversity
    regularizer and the KLD; the ns-GAN term), BatchNorm running stats in
    the s2ag step's order.

    As the JAX step, which the port copies on purpose:
    - the diversity regularizer's speaker ids are always a fresh draw over
      the vocabulary excluding each sample's own
      (`gan_step.draw_other_speaker_ids` with `cfg.n_speakers`), whatever
      `cfg.divreg_draw` says;
    - D's pass on G's output in the G update takes the dropout masks of
      its pass on the fake poses in the D update (JAX hands both the same
      key, rngs[2]);
    - the metrics are "dis", "loss" (the weighted Huber term alone),
      "DIV_REG", "KLD", "gen" and "s2eg_l1".
    No clipping and no learning-rate schedule (v1's GanConfig has neither).

    Batches are dicts of tensors on the models' device:
    extended_word_seq (B, T) int64, audio (B, L), emo_labels (B,
    num_emotions), vec_seq (B, T, 27), vid_indices (B,) int64. `eps` is the
    speaker noise of the D update's and the G update's forwards,
    `eps_rand` the diversity regularizer's; either one not given is drawn
    from the step's generator."""

    def __init__(self, gen: torch.nn.Module, dis: torch.nn.Module, cfg: GanConfig):
        self.gen, self.dis, self.cfg = gen, dis, cfg
        self.gen_opt, self.dis_opt = gan_step.make_optimizers(gen, dis, cfg)
        self.step = 0

    def train_step(self, batch: dict, generator: torch.Generator, gan_on: bool = True,
                   eps: torch.Tensor | None = None,
                   eps_rand: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        cfg, gen, dis = self.cfg, self.gen.train(), self.dis.train()
        text, audio = batch["extended_word_seq"], batch["audio"]
        emo, target, vids = batch["emo_labels"], batch["vec_seq"], batch["vid_indices"]
        pre_seq = build_pre_seq(target, cfg.n_pre_poses)
        use_gan = gan_on and cfg.loss_gan_weight > 0.0
        metrics: dict[str, torch.Tensor] = {}

        with L.dropout_rng(generator):
            # ---------------------------------------------------- D update
            if use_gan:
                with torch.no_grad():
                    fake = gen(pre_seq, text, audio, emo, vids, eps, generator)[0]
                d_real = dis(target, emo)
                fake_masks = torch.Generator(device=generator.device)
                fake_masks.set_state(generator.get_state())
                d_loss = losses.dis_ns_gan(d_real, dis(fake, emo))
                self.dis_opt.zero_grad(set_to_none=True)
                d_loss.backward()
                self.dis_opt.step()
                metrics["dis"] = d_loss.detach()

            # ---------------------------------------------------- G update
            out, z, mu, logvar = gen(pre_seq, text, audio, emo, vids, eps, generator)
            loss = cfg.loss_regression_weight * losses.scaled_huber(out, target, beta=0.1)
            metrics["loss"] = loss.detach()
            if cfg.z_type == "speaker" and cfg.loss_reg_weight > 0.0:
                rand_vids = gan_step.draw_other_speaker_ids(generator, vids, cfg.n_speakers)
                with torch.no_grad():
                    out_rand, z_rand, *_ = gen(pre_seq, text, audio, emo, rand_vids,
                                               eps_rand, generator)
                div_reg = cfg.loss_reg_weight * losses.diversity_regularizer(
                    out, out_rand, z, z_rand)
                kld = cfg.loss_kld_weight * losses.kld_speaker(mu, logvar)
                loss = loss + div_reg + kld
                metrics["DIV_REG"], metrics["KLD"] = div_reg.detach(), kld.detach()
            if use_gan:
                self.dis.requires_grad_(False)
                try:
                    with L.dropout_rng(fake_masks):
                        gen_err = cfg.loss_gan_weight * losses.gen_ns_gan(dis(out, emo))
                finally:
                    self.dis.requires_grad_(True)
                loss = loss + gen_err
                metrics["gen"] = gen_err.detach()
            self.gen_opt.zero_grad(set_to_none=True)
            loss.backward()
            self.gen_opt.step()
            metrics["s2eg_l1"] = losses.l1(out.detach(), target)
        self.step += 1
        return metrics
