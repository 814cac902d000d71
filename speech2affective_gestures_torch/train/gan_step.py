"""The GAN training step of the s2ag model, and its evaluation step.

Reference `processor_v2.py:776-957` (`forward_pass_s2ag`), as the JAX
package's `train/gan_step.py` rebuilt it: one D update, then one G update
(Huber + KLD + diversity regularizer + ns-GAN), with the reference's
stop-gradient placement and BatchNorm running-stat order:

- the D step's generator forward runs under `no_grad` (the reference
  `.detach()`es its output);
- the diversity regularizer's second generator forward runs under
  `no_grad` (its outputs are constants of the loss), with noise of its own
  (JAX draws it from another key than the main forward's);
- the G step differentiates only the generator: the discriminator's
  parameters stop requiring gradients for it, so D's optimizer never sees
  G-step gradients and its GRU layers skip their weight gradients;
- every train-mode forward updates BatchNorm running stats in order: G
  (D step), D on real, D on fake, G, G (div-reg), D on G's output;
- the frozen TriModal comparator runs in train mode (batch statistics,
  dropout), as the reference leaves it, and its running-stat updates are
  discarded.

The speaker noise and the dropout masks come from the `torch.Generator`
passed to each step, on the step's device. The loss terms follow the
generator's `z_type` (`GanConfig.z_type`): the KLD only with the speaker
z, the diversity regularizer with the speaker or the random z, neither
without a z. The generator's audio input is the batch field
`GanConfig.generator_input`: the MFCCs, or the raw audio window for the
abl_audio ablation. Optimizers are Adam with betas
(0.5, 0.999), D's learning rate 0.2 times G's (ref processor_v2.py:215-220).

With `gradient_clip` each net's gradients are clipped by their global
norm before its Adam update (optax's `clip_by_global_norm`), and with
`lr_decay` each optimizer's learning rate decays per epoch of its own
updates (optax's schedule); both are off by default, as in the reference.

The train step calls the generator, the discriminator and the comparator
through `train_apply(module)` when one is given: for mixed precision,
`builder.mixed_precision_apply` (bf16 parameters, inputs and activations
per call; the JAX package's builder.py:204-212). The losses, Adam and the
BatchNorm running stats stay float32, and the eval step calls the nets
themselves (builder.py:214).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..models import layers as L
from . import losses


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """Loss and optimizer settings (config/multimodal_context_v2.yml and
    the reference's parse_args.py defaults)."""

    loss_regression_weight: float = 500.0
    loss_gan_weight: float = 5.0
    loss_kld_weight: float = 0.1
    loss_reg_weight: float = 0.05
    loss_warmup: int = 0
    learning_rate: float = 5e-4
    discriminator_lr_weight: float = 0.2
    z_type: str = "speaker"
    n_pre_poses: int = C.N_PRE_POSES
    # the batch field the generator's audio input comes from:
    # "mfcc_features" for the paper model, "audio" for abl_audio's
    # WavEncoder
    generator_input: str = "mfcc_features"
    # speaker vocabulary size, for divreg_draw='fresh'
    n_speakers: int = 0
    # the diversity regularizer's second-pass speaker ids: 'permutation'
    # permutes the batch's ids as the reference's torch.randperm does
    # (processor_v2.py:902-903); 'fresh' draws each id uniformly from the
    # vocabulary excluding the sample's own
    divreg_draw: str = "permutation"
    # global-norm clipping of each net's gradients (0 = off; the reference
    # parses --gradient-clip and drops it)
    gradient_clip: float = 0.0
    # per-epoch exponential decay: the n-th update of an optimizer (from 0)
    # runs at lr * lr_decay ** (n // decay_steps_per_epoch) (1 = off; the
    # reference's adjust_lr_s2ag call is commented out, processor_v2.py:991).
    # D updates only with the GAN terms on, so its count lags G's by the
    # warmup epochs' steps, as optax's count in the JAX package does
    lr_decay: float = 1.0
    decay_steps_per_epoch: int = 0

    @property
    def decays(self) -> bool:
        return self.lr_decay != 1.0 and self.decay_steps_per_epoch > 0

    @property
    def lr_dis(self) -> float:
        return self.learning_rate * self.discriminator_lr_weight


def make_optimizers(gen: torch.nn.Module, dis: torch.nn.Module, cfg: GanConfig):
    """The G and D Adam pair (ref processor_v2.py:215-220). `GanStep`
    applies the clipping and the schedule around their updates."""
    return (torch.optim.Adam(gen.parameters(), lr=cfg.learning_rate,
                             betas=(0.5, 0.999)),
            torch.optim.Adam(dis.parameters(), lr=cfg.lr_dis, betas=(0.5, 0.999)))


def scheduled_lr(base_lr: float, cfg: GanConfig, count: int) -> float:
    """The learning rate of an optimizer's update number `count` (from 0),
    as the JAX package's optax schedule (`_lr_schedule`, gan_step.py:111)."""
    if cfg.decays:
        return base_lr * cfg.lr_decay ** (count // cfg.decay_steps_per_epoch)
    return base_lr


def update_count(opt: torch.optim.Optimizer) -> int:
    """The updates `opt` has made: Adam's `step`, which its state dict
    (and so the checkpoint) carries, the same in every parameter's state
    (a host tensor, so reading it does not sync the device)."""
    state = next(iter(opt.state.values()), {})
    return int(state.get("step", 0))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm` on the gradients of `params`, in
    place: all of them times max_norm / g_norm when their global norm
    g_norm is max_norm or more, untouched below (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). Returns g_norm, on the device,
    without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def build_pre_seq(target_poses: torch.Tensor, n_pre_poses: int) -> torch.Tensor:
    """(B, T, D) targets -> (B, T, D+1) seed sequence: the first n_pre_poses
    frames and a constraint bit, zero after (ref processor_v2.py:784-788)."""
    b, t, _ = target_poses.shape
    mask = (torch.arange(t, device=target_poses.device) < n_pre_poses)
    poses = torch.cat([target_poses, target_poses.new_ones(b, t, 1)], dim=-1)
    return poses * mask.to(poses.dtype)[None, :, None]


def draw_other_speaker_ids(generator: torch.Generator, vids: torch.Tensor,
                           n_speakers: int) -> torch.Tensor:
    """Speaker ids for the diversity regularizer's second pass: with
    n_speakers > 1 a uniform draw over the vocabulary excluding each
    sample's own id; otherwise a permutation of the batch's ids."""
    dev = generator.device
    if n_speakers > 1:
        draw = torch.randint(0, n_speakers - 1, tuple(vids.shape),
                             generator=generator, device=dev).to(vids)
        return draw + (draw >= vids).to(vids.dtype)
    perm = torch.randperm(vids.shape[0], generator=generator, device=dev)
    return vids[perm.to(vids.device)]


@torch.no_grad()
def _forward_discarding_stats(model: torch.nn.Module, call, *args, **kwargs):
    """A train-mode forward `call(*args, **kwargs)` of `model` whose
    BatchNorm running-stat updates are undone afterwards."""
    saved = [(b, b.clone()) for b in model.buffers()]
    try:
        return call(*args, **kwargs)
    finally:
        for b, old in saved:
            b.copy_(old)


class GanStep:
    """The train and eval steps over the generator, the discriminator, the
    optional frozen TriModal comparator and the two Adam optimizers.

    Batches are dicts of tensors on the models' device: extended_word_seq
    (B, T) int64, vec_seq (B, T, 27), mfcc_features (B, 37, 71), audio
    (B, L) (the comparator's, and abl_audio's generator's) and vid_indices
    (B,) int64. `eps`, when given, is the noise (B, z_size) of every
    generator forward of the step but the diversity regularizer's, which
    takes `eps_rand` (tests inject both); either one not given is drawn
    from `generator`."""

    def __init__(self, gen: torch.nn.Module, dis: torch.nn.Module,
                 cfg: GanConfig, tri: torch.nn.Module | None = None,
                 train_apply=None):
        self.gen, self.dis, self.tri, self.cfg = gen, dis, tri, cfg
        self.gen_opt, self.dis_opt = make_optimizers(gen, dis, cfg)
        self.train_apply = train_apply
        self.step = 0
        # each net's gradient norm before its last clipped update
        self.grad_norms: dict[str, torch.Tensor] = {}

    def _update(self, who: str):
        """One Adam update of net `who` ("gen" or "dis"): its gradients
        clipped, and with decay its learning rate set after the update to
        the next one's at its own update count, so that the optimizer
        always holds the rate its next update uses (its base rate before
        the first)."""
        if self.cfg.gradient_clip > 0.0:
            self.grad_norms[who] = clip_by_global_norm_(
                getattr(self, who).parameters(), self.cfg.gradient_clip)
        getattr(self, f"{who}_opt").step()
        if self.cfg.decays:
            self.sync_lr(who)

    def sync_lr(self, who: str | None = None):
        """Set the learning rate of net `who`'s optimizer (both without
        `who`) to its schedule's at its update count."""
        for w in ((who,) if who else ("gen", "dis")):
            opt = getattr(self, f"{w}_opt")
            base = self.cfg.learning_rate if w == "gen" else self.cfg.lr_dis
            lr = scheduled_lr(base, self.cfg, update_count(opt))
            for group in opt.param_groups:
                group["lr"] = lr

    def _train_fn(self, module: torch.nn.Module):
        """The train step's call of `module`."""
        return module if self.train_apply is None else self.train_apply(module)

    def _other_speakers(self, generator, vids):
        """The diversity regularizer's speaker ids: other speakers for the
        speaker z; the same (unused) ids for the random z, as JAX draws
        none there (gan_step.py:346-349)."""
        if self.cfg.z_type != "speaker":
            return vids
        n = 0 if self.cfg.divreg_draw == "permutation" else self.cfg.n_speakers
        return draw_other_speaker_ids(generator, vids, n)

    def _div_reg_on(self) -> bool:
        return self.cfg.z_type in ("speaker", "random") and self.cfg.loss_reg_weight > 0.0

    def train_step(self, batch: dict, generator: torch.Generator,
                   gan_on: bool = True, tri_metric: bool = True,
                   eps: torch.Tensor | None = None,
                   eps_rand: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        self.gen.train()
        self.dis.train()
        gen, dis = self._train_fn(self.gen), self._train_fn(self.dis)
        text, target = batch["extended_word_seq"], batch["vec_seq"]
        mfcc, vids = batch[cfg.generator_input], batch["vid_indices"]
        pre_seq = build_pre_seq(target, cfg.n_pre_poses)
        use_gan = gan_on and cfg.loss_gan_weight > 0.0
        metrics: dict[str, torch.Tensor] = {}

        with L.dropout_rng(generator):
            # ---------------------------------------------------- D update
            if use_gan:
                with torch.no_grad():
                    fake = gen(pre_seq, text, mfcc, vids, eps, generator)[0]
                d_loss = losses.dis_ns_gan(dis(target, text), dis(fake, text))
                self.dis_opt.zero_grad(set_to_none=True)
                d_loss.backward()
                self._update("dis")
                metrics["dis"] = d_loss.detach()

            # ---------------------------------------------------- G update
            out, z, mu, logvar = gen(pre_seq, text, mfcc, vids, eps, generator)
            huber = losses.scaled_huber(out, target, beta=0.1)
            loss = cfg.loss_regression_weight * huber
            metrics["loss"] = loss.detach()
            if self._div_reg_on():
                rand_vids = self._other_speakers(generator, vids)
                with torch.no_grad():
                    out_rand, z_rand, *_ = gen(pre_seq, text, mfcc, rand_vids,
                                               eps_rand, generator)
                div_reg = cfg.loss_reg_weight * losses.diversity_regularizer(
                    out, out_rand, z, z_rand)
                loss = loss + div_reg
                metrics["DIV_REG"] = div_reg.detach()
                if cfg.z_type == "speaker":
                    kld = cfg.loss_kld_weight * losses.kld_speaker(mu, logvar)
                    loss = loss + kld
                    metrics["KLD"] = kld.detach()
            if use_gan:
                self.dis.requires_grad_(False)
                try:
                    gen_err = cfg.loss_gan_weight * losses.gen_ns_gan(dis(out, text))
                finally:
                    self.dis.requires_grad_(True)
                loss = loss + gen_err
                metrics["gen"] = gen_err.detach()
            self.gen_opt.zero_grad(set_to_none=True)
            loss.backward()
            self._update("gen")
            metrics["g_total"] = loss.detach()

            # ------------------------------ trimodal comparison (frozen)
            out = out.detach()
            s2ag_l1 = losses.l1(out, target)
            if tri_metric and self.tri is not None:
                tri_out = _forward_discarding_stats(
                    self.tri.train(), self._train_fn(self.tri), pre_seq, text,
                    batch["audio"], vids, eps, generator)[0]
                metrics["s2ag_vs_trimodal_l1"] = s2ag_l1 - losses.l1(tri_out, target)
            metrics["s2ag_l1"] = s2ag_l1
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator,
                  gan_on: bool = True, eps: torch.Tensor | None = None,
                  eps_rand: torch.Tensor | None = None):
        """Validation: eval-mode forwards (running BN stats, no dropout, no
        updates) and the same loss terms (ref per_val_epoch,
        processor_v2.py:993-1030); `eps` and `eps_rand` as `train_step`'s.
        Returns (out, metrics)."""
        cfg = self.cfg
        gen, dis = self.gen.eval(), self.dis.eval()
        text, target = batch["extended_word_seq"], batch["vec_seq"]
        mfcc, vids = batch[cfg.generator_input], batch["vid_indices"]
        pre_seq = build_pre_seq(target, cfg.n_pre_poses)
        out, z, mu, logvar = gen(pre_seq, text, mfcc, vids, eps, generator)
        metrics = {"loss": cfg.loss_regression_weight
                   * losses.scaled_huber(out, target, beta=0.1)}
        if self._div_reg_on():
            rand_vids = self._other_speakers(generator, vids)
            out_rand, z_rand, *_ = gen(pre_seq, text, mfcc, rand_vids, eps_rand,
                                       generator)
            metrics["DIV_REG"] = cfg.loss_reg_weight * losses.diversity_regularizer(
                out, out_rand, z, z_rand)
            if cfg.z_type == "speaker":
                metrics["KLD"] = cfg.loss_kld_weight * losses.kld_speaker(mu, logvar)
        if gan_on and cfg.loss_gan_weight > 0.0:
            d_fake = dis(out, text)
            metrics["dis"] = losses.dis_ns_gan(dis(target, text), d_fake)
            metrics["gen"] = cfg.loss_gan_weight * losses.gen_ns_gan(d_fake)
        s2ag_l1 = losses.l1(out, target)
        metrics["s2ag_l1"] = s2ag_l1
        if self.tri is not None:
            tri_out = self.tri.eval()(pre_seq, text, batch["audio"], vids, eps,
                                      generator)[0]
            metrics["s2ag_vs_trimodal_l1"] = s2ag_l1 - losses.l1(tri_out, target)
        return out, metrics
