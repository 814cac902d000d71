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

Two options change how the train step calls its nets (JAX
`GanConfig.fused_pass` and `remat`, gan_step.py:80-103):

- `fused_pass` runs D on real and on fake as one forward on the 2B
  concat, and, with the diversity regularizer on, G's main and div-reg
  forwards as one forward on the doubled inputs (the other speakers'
  ids in the second half; the noise one 2B draw, or eps and eps_rand
  concatenated); the outputs are split at B. Every loss keeps its
  formula, but BatchNorm takes its statistics over the 2B concat (one
  running-stat update in place of two) and the per-sample draws come from
  one 2B-shaped draw, so the step is not the unfused step's;
- `remat` ("none", "full" or "dots") rematerializes each differentiated
  train-mode call (`rematerialize`): the backward reruns its forward
  instead of keeping its activations ("full"), or keeps only the outputs
  of the products without a batch dim, `mm` and `addmm`, and reruns the
  rest ("dots", JAX's `dots_with_no_batch_dims_saveable`). It changes no
  value: the rerun sees the forward's masks and noise and leaves the
  running stats as the forward left them.

The step runs inside a CUDA graph capture (`train.step_program`) once
`GanStep.make_capturable` has put both Adams' update counts, and with
decay their learning rates, on the device; a checkpoint keeps Adam's
state in the reference's host form (`reference_optimizer_state`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch.utils import checkpoint

from .. import constants as C
from ..models import layers as L
from ..parallel import mesh as P
from . import losses, profiling


REMAT_MODES = ("none", "full", "dots")
# the ops whose outputs "dots" keeps for the backward: the products without
# a batch dim (JAX's dots_with_no_batch_dims_saveable saves dot_general's)
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


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
    # one 2B forward of D for real and fake, and of G for its main and
    # div-reg passes (module docstring)
    fused_pass: bool = False
    # rematerialization of the differentiated forwards: "none", "full" or
    # "dots" (`rematerialize`)
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {self.remat!r}: expected one of "
                             f"{REMAT_MODES}")

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
    (a host tensor, so reading it does not sync the device, unless the
    optimizer is capturable)."""
    state = next(iter(opt.state.values()), {})
    return int(state.get("step", 0))


def _step_tensor(opt: torch.optim.Optimizer) -> torch.Tensor:
    """The update count of a capturable optimizer: Adam's `step` on the
    device (`GanStep.make_capturable` made every parameter's state)."""
    return next(iter(opt.state.values()))["step"]


def scheduled_lr_tensor(base_lr: float, cfg: GanConfig, count: torch.Tensor) -> torch.Tensor:
    """`scheduled_lr` at a device count (float32), computed on the device
    in float64 as the host computes it: no host sync, so it runs inside a
    CUDA graph, where the decay may cross an epoch boundary in the middle
    of a program."""
    epochs = torch.div(count.double(), cfg.decay_steps_per_epoch, rounding_mode="floor")
    return base_lr * torch.pow(cfg.lr_decay, epochs)


def reference_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """`opt`'s state dict as the reference's non-capturable Adam writes it:
    `step` a float32 host tensor, each group's `lr` a float and
    `capturable` off, whether or not `opt` was made capturable."""
    sd = opt.state_dict()
    state = {i: {k: v.detach().to("cpu", torch.float32) if k == "step" else v
                 for k, v in s.items()} for i, s in sd["state"].items()}
    groups = [{**g, "lr": float(g["lr"]), "capturable": False} for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def clip_by_global_norm_(params, max_norm: float,
                         grid: P.Mesh2D | None = None) -> torch.Tensor:
    """optax's `clip_by_global_norm` on the gradients of `params`, in
    place: all of them times max_norm / g_norm when their global norm
    g_norm is max_norm or more, untouched below (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). On a (data, model) `grid` the norm
    counts each split parameter's slices once, summed over the model axis,
    and each replicated parameter once. Returns g_norm, on the device,
    without a host sync."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norms = torch._foreach_norm(grads)
    if grid is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        def squares(split: bool) -> torch.Tensor:
            of = [n for n, p in zip(norms, params) if hasattr(p, "model_shard") == split]
            return torch.stack(of).square().sum() if of else norms[0].new_zeros(())

        norm = torch.sqrt(P.all_reduce_(squares(True), grid.model) + squares(False))
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
    sample's own id; otherwise a permutation of the batch's ids. In a
    data-parallel step both are drawn over the global batch
    (`parallel.mesh`): the uniform ids at its shape, the permutation of
    every rank's ids, and this rank keeps its rows."""
    dev = generator.device
    if n_speakers > 1:
        draw = P.draw_local(lambda shape: torch.randint(
            0, n_speakers - 1, shape, generator=generator, device=dev), vids.shape).to(vids)
        return draw + (draw >= vids).to(vids.dtype)
    stepping = P.current()
    every = vids if stepping is None else P.all_gather_rows(vids, stepping[0])
    perm = torch.randperm(every.shape[0], generator=generator, device=dev)
    out = every[perm.to(vids.device)]
    return out if stepping is None else stepping[0].local(out, vids.shape[0])


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


def _batch_norm_stats(module: torch.nn.Module) -> list[torch.Tensor]:
    return [b for m in module.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]


def _replay_contexts(generator: torch.Generator, module: torch.nn.Module, mode: str):
    """`checkpoint`'s context_fn for one call of `module`: the forward's
    context records the dropout masks and noise it draws from `generator`
    (`layers.DrawTape`); the recompute's replays them, so that the rerun
    sees the forward's draws and the generator is not drawn from again,
    and afterwards puts back `module`'s BatchNorm running stats as it
    found them, so that each running stat is updated once a forward.
    Neither touches the generator's state on the host, so the pair also
    runs inside a CUDA graph capture. Under "dots" the selective
    checkpoint's pair runs inside them."""
    tape = L.DrawTape(generator)

    @contextlib.contextmanager
    def recompute():
        stats = [(b, b.clone()) for b in _batch_norm_stats(module)]
        try:
            with tape.replaying():
                yield
        finally:
            for b, old in stats:
                b.copy_(old)

    if mode == "full":
        return tape.recording(), recompute()
    sac_forward, sac_recompute = checkpoint.create_selective_checkpoint_contexts(
        list(DOTS_SAVED))
    return _stacked(tape.recording(), sac_forward), _stacked(recompute(), sac_recompute)


@contextlib.contextmanager
def _stacked(outer, inner):
    with outer, inner:
        yield


def rematerialize(fn, mode: str, generator: torch.Generator, module: torch.nn.Module,
                  *args):
    """fn(*args), a train-mode forward of `module` that draws from
    `generator`, under `torch.utils.checkpoint` (non-reentrant): "full"
    keeps nothing of it for the backward, which reruns it; "dots" keeps
    the outputs of `DOTS_SAVED` and reruns the rest (a selective
    checkpoint). The rerun sees the forward's draws and leaves no trace
    (`_replay_contexts`). The global RNG is not drawn from on these paths,
    so the checkpoint does not save it (reading a CUDA generator's state is
    not allowed inside a graph capture)."""
    return checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(_replay_contexts, generator, module, mode))


def _frozen(module: torch.nn.Module, fn):
    """fn with `module`'s parameters requiring no gradient while it runs
    (and so while a recompute reruns it: the rerun must save what the
    forward saved), their flags restored after."""
    def call(*args):
        flags = [(p, p.requires_grad) for p in module.parameters()]
        module.requires_grad_(False)
        try:
            return fn(*args)
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)

    return call


class GanStep:
    """The train and eval steps over the generator, the discriminator, the
    optional frozen TriModal comparator and the two Adam optimizers.

    Batches are dicts of tensors on the models' device: extended_word_seq
    (B, T) int64, vec_seq (B, T, 27), mfcc_features (B, 37, 71), audio
    (B, L) (the comparator's, and abl_audio's generator's) and vid_indices
    (B,) int64. `eps`, when given, is the noise (B, z_size) of every
    generator forward of the step but the diversity regularizer's, which
    takes `eps_rand` (tests inject both); either one not given is drawn
    from `generator`. The fused G forward takes both or neither: their
    concat, or one 2B draw."""

    def __init__(self, gen: torch.nn.Module, dis: torch.nn.Module,
                 cfg: GanConfig, tri: torch.nn.Module | None = None,
                 train_apply=None, mesh: P.DataMesh | P.Mesh2D | None = None):
        self.gen, self.dis, self.tri, self.cfg = gen, dis, tri, cfg
        self.gen_opt, self.dis_opt = make_optimizers(gen, dis, cfg)
        self.train_apply = train_apply
        # the (data, model) grid of a 2-D step, whose nets
        # `parallel.mesh.shard_params_2d` splits (None: no model axis)
        self.grid = mesh if isinstance(mesh, P.Mesh2D) else None
        # the data axis of a data-parallel step (None: one process)
        self.mesh = mesh.data if self.grid is not None else mesh
        self.step = 0
        # each net's gradient norm before its last clipped update
        self.grad_norms: dict[str, torch.Tensor] = {}

    def _update(self, who: str):
        """One Adam update of net `who` ("gen" or "dis"): its gradients
        clipped, and with decay its learning rate set after the update to
        the next one's at its own update count, so that the optimizer
        always holds the rate its next update uses (its base rate before
        the first). In a data-parallel step the gradients are first
        averaged over the data axis, so that the clip sees the global norm
        (on a grid each split parameter's slice over the ranks that hold
        it)."""
        if self.mesh is not None:
            P.all_reduce_mean_([p.grad for p in getattr(self, who).parameters()
                                if p.grad is not None], self.mesh)
        if self.cfg.gradient_clip > 0.0:
            self.grad_norms[who] = clip_by_global_norm_(
                getattr(self, who).parameters(), self.cfg.gradient_clip, self.grid)
        getattr(self, f"{who}_opt").step()
        if self.cfg.decays:
            self.sync_lr(who)

    def sync_lr(self, who: str | None = None):
        """Set the learning rate of net `who`'s optimizer (both without
        `who`) to its schedule's at its update count: on the device, from
        the device count, where `make_capturable` made the rate a tensor."""
        for w in ((who,) if who else ("gen", "dis")):
            opt = getattr(self, f"{w}_opt")
            base = self.cfg.learning_rate if w == "gen" else self.cfg.lr_dis
            for group in opt.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].copy_(scheduled_lr_tensor(base, self.cfg, _step_tensor(opt)))
                else:
                    group["lr"] = scheduled_lr(base, self.cfg, update_count(opt))

    def make_capturable(self):
        """Both Adams as a CUDA graph can capture them (`capturable`): the
        update count on the device, every state made now (zero moments,
        count 0, as Adam makes them at a first update) so that none is
        made inside a capture, and with decay the learning rate a device
        tensor that `sync_lr` sets from the device count. The arithmetic
        of a capturable update differs from the host one's by rounding.
        `reference_optimizer_state` writes the state back in the host
        form; `load_optimizer_states` reads it into the host form again."""
        for who in ("gen", "dis"):
            opt = getattr(self, f"{who}_opt")
            for group in opt.param_groups:
                group["capturable"] = True
                for p in group["params"]:
                    if not p.requires_grad:
                        continue
                    state = opt.state[p]
                    if not state:
                        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                        state["exp_avg_sq"] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    else:
                        state["step"] = state["step"].to(p.device, torch.float32)
                if self.cfg.decays and not isinstance(group["lr"], torch.Tensor):
                    group["lr"] = torch.tensor(group["lr"], dtype=torch.float32,
                                               device=group["params"][0].device)
        if self.cfg.decays:
            self.sync_lr()

    def load_optimizer_states(self, gen_state: dict, dis_state: dict):
        """Both Adams from state dicts in the reference's form (a
        checkpoint's), non-capturable, their counts on the host, and their
        learning rates the schedule's at those counts."""
        for opt, sd in ((self.gen_opt, gen_state), (self.dis_opt, dis_state)):
            opt.load_state_dict(sd)
            for state in opt.state.values():
                if "step" in state:
                    state["step"] = state["step"].to("cpu", torch.float32)
        self.sync_lr()

    def _train_fn(self, module: torch.nn.Module):
        """The train step's call of `module`."""
        return module if self.train_apply is None else self.train_apply(module)

    def _differentiated_fn(self, module: torch.nn.Module, generator: torch.Generator,
                           frozen: bool = False):
        """The train step's call of `module` in a pass that a backward
        follows: with `frozen`, its parameters take no gradient (`_frozen`);
        under `cfg.remat`, rematerialized (`rematerialize`, around the
        `train_apply` call, so that the recompute casts the parameters
        again)."""
        fn = self._train_fn(module)
        if frozen:
            fn = _frozen(module, fn)
        if self.cfg.remat == "none":
            return fn
        return functools.partial(rematerialize, fn, self.cfg.remat, generator, module)

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
        """One D update, then one G update, then the frozen comparator's
        metric, inside the spans `gan.train_step` and, in call order,
        `gan.dis.forward`, `.backward`, `.update` (with the GAN terms),
        `gan.gen.forward`, `.backward`, `.update` and `gan.tri.forward`
        (`profiling.annotate`)."""
        with profiling.annotate("gan.train_step", self.step):
            metrics = self._train_step(batch, generator, gan_on, tri_metric, eps, eps_rand)
            self.step += 1
            return self._global_metrics(metrics)

    def _train_step(self, batch, generator, gan_on, tri_metric, eps, eps_rand):
        cfg = self.cfg
        self.gen.train()
        self.dis.train()
        gen = self._train_fn(self.gen)
        text, target = batch["extended_word_seq"], batch["vec_seq"]
        mfcc, vids = batch[cfg.generator_input], batch["vid_indices"]
        pre_seq = build_pre_seq(target, cfg.n_pre_poses)
        bsz = target.shape[0]
        use_gan = gan_on and cfg.loss_gan_weight > 0.0
        metrics: dict[str, torch.Tensor] = {}

        with L.dropout_rng(generator), P.stepping(self.mesh, bsz):
            # ---------------------------------------------------- D update
            if use_gan:
                with profiling.annotate("gan.dis.forward"):
                    with torch.no_grad():
                        fake = gen(pre_seq, text, mfcc, vids, eps, generator)[0]
                    dis_d = self._differentiated_fn(self.dis, generator)
                    if cfg.fused_pass:
                        both = dis_d(torch.cat([target, fake]), torch.cat([text, text]))
                        d_real, d_fake = both[:bsz], both[bsz:]
                    else:
                        d_real, d_fake = dis_d(target, text), dis_d(fake, text)
                    d_loss = losses.dis_ns_gan(d_real, d_fake)
                with profiling.annotate("gan.dis.backward"):
                    self.dis_opt.zero_grad(set_to_none=True)
                    d_loss.backward()
                with profiling.annotate("gan.dis.update"):
                    self._update("dis")
                metrics["dis"] = d_loss.detach()

            # ---------------------------------------------------- G update
            with profiling.annotate("gan.gen.forward"):
                gen_g = self._differentiated_fn(self.gen, generator)
                fuse_g = cfg.fused_pass and self._div_reg_on()
                if fuse_g:
                    # JAX draws the other speakers before the fused forward
                    rand_vids = self._other_speakers(generator, vids)
                    if (eps is None) != (eps_rand is None):
                        raise ValueError("the fused pass takes eps and eps_rand together")
                    noise = None if eps is None else torch.cat([eps, eps_rand])
                    out2, z2, mu2, logvar2 = gen_g(
                        *(torch.cat([x, x]) for x in (pre_seq, text, mfcc)),
                        torch.cat([vids, rand_vids]), noise, generator)
                    out, out_rand = out2[:bsz], out2[bsz:]
                    z, z_rand = z2[:bsz], z2[bsz:]
                    mu, logvar = (None if x is None else x[:bsz] for x in (mu2, logvar2))
                else:
                    out, z, mu, logvar = gen_g(pre_seq, text, mfcc, vids, eps, generator)
                huber = losses.scaled_huber(out, target, beta=0.1)
                loss = cfg.loss_regression_weight * huber
                metrics["loss"] = loss.detach()
                if self._div_reg_on():
                    if not fuse_g:
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
                    dis_g = self._differentiated_fn(self.dis, generator, frozen=True)
                    gen_err = cfg.loss_gan_weight * losses.gen_ns_gan(dis_g(out, text))
                    loss = loss + gen_err
                    metrics["gen"] = gen_err.detach()
            with profiling.annotate("gan.gen.backward"):
                self.gen_opt.zero_grad(set_to_none=True)
                loss.backward()
            with profiling.annotate("gan.gen.update"):
                self._update("gen")
            metrics["g_total"] = loss.detach()

            # ------------------------------ trimodal comparison (frozen)
            out = out.detach()
            s2ag_l1 = losses.l1(out, target)
            if tri_metric and self.tri is not None:
                with profiling.annotate("gan.tri.forward"):
                    tri_out = _forward_discarding_stats(
                        self.tri.train(), self._train_fn(self.tri), pre_seq, text,
                        batch["audio"], vids, eps, generator)[0]
                    metrics["s2ag_vs_trimodal_l1"] = s2ag_l1 - losses.l1(tri_out, target)
            metrics["s2ag_l1"] = s2ag_l1
        return metrics

    def _global_metrics(self, metrics: dict) -> dict:
        """In a data-parallel step, each metric (a mean over the rank's
        rows) averaged over the ranks: the global batch's."""
        if self.mesh is not None:
            P.all_reduce_mean_(list(metrics.values()), self.mesh)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator,
                  gan_on: bool = True, eps: torch.Tensor | None = None,
                  eps_rand: torch.Tensor | None = None):
        """Validation: eval-mode forwards (running BN stats, no dropout, no
        updates) and the same loss terms (ref per_val_epoch,
        processor_v2.py:993-1030); `eps` and `eps_rand` as `train_step`'s.
        Returns (out, metrics)."""
        with P.stepping(self.mesh, batch["vec_seq"].shape[0]):
            out, metrics = self._eval(batch, generator, gan_on, eps, eps_rand)
        return out, self._global_metrics(metrics)

    def _eval(self, batch, generator, gan_on, eps, eps_rand):
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
