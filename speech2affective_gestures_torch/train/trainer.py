"""Training driver (reference `processor_v2.py` class Processor, as the JAX
package's `train/trainer.py` rebuilt it): the epoch loop with the GAN terms
gated by `epoch > loss_warmup`, validation, checkpoints named
`epoch_{:06d}_loss_{:.4f}_model.pth.tar`, and the test-split evaluation
(`generate_gestures`: L1, joint MAE, acceleration difference and FGD).

With the default `loader="device"` the train split lives on the
trainer's device (`ted_db.DeviceDataset`): the host draws each step's rows
and adversarial speakers, and the batch is gathered on the device. An
epoch runs one step at a time, or, with `steps_per_program` K > 1, as
programs of K steps (`train.step_program`: one CUDA graph a program on the
card), the JAX trainer's scanned epoch; `epoch_engine` says which. With
`loader="grain"` the split stays on the host and the batches stream from
`data.grain_loader.GrainLoader`, JAX's grain pipeline without grain, one
step at a time: an epoch is n // B batches of one stream that runs on
across epochs.

A checkpoint is the reference's save blob (`gen_model_dict`,
`dis_model_dict`, keys prefixed `module.` as its DataParallel wrapper
writes them) plus both Adam states, in the form the reference's Adam
writes whichever engine trained them, so the reference loads the weights
and this trainer resumes from them with either engine. Beside it,
`<checkpoint>_datastate.json` holds what the weights do not (JAX
trainer.py:593-662): the step generator's state, the step count, the
position in the epoch and, under grain, the stream's next batch and seed.
So a resumed run draws what the uncut run draws: from an epoch's end on
either loader, from the middle of an epoch under grain. A checkpoint
without that file (the reference's, an older run's) loads as before. The
best-checkpoint choice takes the minimum positive loss, as the JAX
package's does.
"""

from __future__ import annotations

import base64
import json
import os
import re
import time
from collections import deque

import numpy as np
import torch

from ..config import ModelConfig
from ..convert.from_jax import strip_module_prefix
from ..data.grain_loader import GrainLoader
from ..data.ted_db import (BatchSampler, DeviceBatchSampler, DeviceDataset, PackedDataset,
                           decode_rows)
from . import builder
from .evaluator import EmbeddingSpaceEvaluator, push_sample_metrics
from .gan_step import reference_optimizer_state
from .logger import TrainLogger
from .losses import AverageMeter
from .step_program import StepProgram

# the best checkpoint is looked for only after this many epochs
# (ref processor_v2.py, min_train_epochs)
MIN_TRAIN_EPOCHS = 20

_CKPT_RE = re.compile(r"epoch_(\d+)_loss_(-?[\d.]+|nan|-?inf)_model\.pth\.tar$")


def datastate_path(ckpt_path: str) -> str:
    """The data-state file beside a `.pth.tar` checkpoint."""
    return ckpt_path.removesuffix(".pth.tar") + "_datastate.json"


def parse_checkpoint_name(name: str):
    m = _CKPT_RE.match(name)
    if not m:
        return None
    return int(m.group(1)), float(m.group(2))


def find_checkpoint(work_dir: str, epoch: int | str = "best"):
    """(name, epoch, loss) of a checkpoint in `work_dir`: 'best' = the
    minimum positive loss, else the given epoch; None if there is none."""
    if not os.path.isdir(work_dir):
        return None
    entries = [(name, *parsed) for name in os.listdir(work_dir)
               if (parsed := parse_checkpoint_name(name))]
    if not entries:
        return None
    if epoch == "best":
        pool = [e for e in entries if e[2] > 0] or entries
        return min(pool, key=lambda e: e[2])
    return next((e for e in entries if e[1] == int(epoch)), None)


class Trainer:
    """GAN training on packed datasets, on `device` (the card unless
    `device="cpu"`), of the paper model or one of its ablations
    (`variant`: "s2ag", "abl_audio" or "abl_aff", kept as `self.variant`,
    which the renderer and the service read to feed abl_audio's generator
    raw audio). With `mixed_precision` the train steps run at bf16
    (`builder.mixed_precision_apply`, the JAX trainer's
    `mixed_precision`); validation, `generate_gestures` and the FGD scoring
    stay float32. `gradient_clip` (0 = off) clips each net's gradients by
    their global norm; `lr_decay` (1 = off) decays each optimizer's
    learning rate by that factor per epoch of its own updates, an epoch
    being n_train // batch_size updates (JAX trainer.py:163-183).
    `n_speakers` sizes the speaker embedding when it must differ from the
    data's speaker vocabulary: the vocabularies are per split, so a
    checkpoint trained on the train split and served with the test split
    alone carries the train split's count. `fused_pass` and `remat` (none,
    full or dots) set how the train step calls its nets (`GanConfig`; JAX
    trainer.py:112-113). `loader` is "device" (the split on the device) or
    "grain" (the split on the host, streamed; for a split past the card's
    memory). `steps_per_program` K > 1 runs the epoch K steps a program
    where it can (`_use_scanned_epoch`: the device loader); where it cannot,
    `epoch_engine_fallback` says why and K drops to 1, as in JAX
    (trainer.py:244-270)."""

    def __init__(self, cfg: ModelConfig, work_dir: str,
                 train_data: PackedDataset | None = None,
                 val_data: PackedDataset | None = None,
                 test_data: PackedDataset | None = None,
                 device: str | torch.device | None = None,
                 val_interval: int = 1, save_interval: int = 10,
                 seed: int = 1234, variant: str = "s2ag",
                 trimodal_metric_interval: int = 1,
                 divreg_draw: str = "permutation", metrics_lag: int = 8,
                 log_interval: int = 50,
                 evaluator: EmbeddingSpaceEvaluator | None = None,
                 mixed_precision: bool = False, gradient_clip: float = 0.0,
                 lr_decay: float = 1.0, n_speakers: int | None = None,
                 fused_pass: bool = False, remat: str = "none", loader: str = "device",
                 steps_per_program: int = 1):
        if loader not in ("device", "grain"):  # as JAX's trainer.py:242
            raise ValueError(f"unknown loader {loader!r} (device|grain)")
        self.cfg = cfg
        self.variant = variant
        self.work_dir = work_dir
        self.logger = TrainLogger(work_dir)
        self.train_data, self.val_data, self.test_data = train_data, val_data, test_data
        self.val_interval = val_interval
        self.save_interval = save_interval
        # the frozen FGD embedding net of generate_gestures (None: no FGD)
        self.evaluator = evaluator
        # the frozen-trimodal comparison every K-th step (1 = every step,
        # as the reference, processor_v2.py:821)
        self.trimodal_metric_interval = max(1, trimodal_metric_interval)
        # steps whose metrics may stay on the card unread, so that the host
        # queues the next step before it waits for one; the logged numbers
        # are the same for any lag
        self.metrics_lag = max(0, metrics_lag)
        self.log_interval = log_interval
        self.steps_per_program = max(1, steps_per_program)
        self.loader = loader

        ref = train_data or val_data or test_data
        n_words = ref.lang_model.n_words if ref and ref.lang_model else 1000
        if n_speakers is None:
            n_speakers = ref.speaker_model.n_words if ref and ref.speaker_model else 100
        word_embeddings = (ref.lang_model.word_embedding_weights
                           if ref and ref.lang_model else None)
        steps_per_epoch = 0
        if train_data is not None:
            steps_per_epoch = train_data.n_samples // cfg.batch_size
            if lr_decay != 1.0 and steps_per_epoch == 0:
                # a split smaller than one batch would otherwise turn off
                # a decay that was asked for
                self.logger.print_log(
                    f"Warning: --apply-lr-decay with a train split of "
                    f"{train_data.n_samples} samples, less than the batch size "
                    f"{cfg.batch_size}: each batch counts as an epoch of the decay")
                steps_per_epoch = 1
        setup = builder.init_training(
            cfg, max(seed, 0), n_words=n_words, n_speakers=n_speakers,
            word_embeddings=word_embeddings, device=device, variant=variant,
            divreg_draw=divreg_draw, mixed_precision=mixed_precision,
            gradient_clip=gradient_clip, lr_decay=lr_decay,
            decay_steps_per_epoch=steps_per_epoch if lr_decay != 1.0 else 0,
            fused_pass=fused_pass, remat=remat)
        self.device = setup["device"]
        self.gen, self.dis, self.tri = setup["gen"], setup["dis"], setup["tri"]
        self.step = setup["step"]
        self.gan_cfg = setup["gan_cfg"]
        # speaker noise, dropout masks and div-reg draws, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed if seed >= 0 else int(time.time()))
        self.best_loss = np.inf
        self.best_loss_epoch = 0
        self.epoch = 0
        # the device loader: the train split on the device, and the K-step
        # program over it (made at the first scanned epoch, dropped when a
        # checkpoint loads); grain: the stream, persistent across epochs,
        # and the batches of the current epoch it has handed out
        self._device_train = self._grain = None
        if train_data is not None and loader == "device":
            self._device_train = DeviceDataset(train_data, self.device)
        elif train_data is not None:
            self._grain = GrainLoader(train_data, cfg.batch_size, max(seed, 0), self.device)
        self._iter_in_epoch = 0
        self._program: StepProgram | None = None
        self.epoch_engine_fallback: str | None = None
        if (self.steps_per_program > 1 and train_data is not None
                and not self._use_scanned_epoch()):
            self.epoch_engine_fallback = (
                f"steps_per_program={self.steps_per_program} requested but the scanned "
                "epoch needs the 'device' loader and trimodal_metric_interval=1; fell back "
                "to the per-step loop")
            self.logger.print_log(f"Warning: {self.epoch_engine_fallback}")
            self.steps_per_program = 1

    # ------------------------------------------------------------- epochs
    @property
    def epoch_engine(self) -> str:
        """The epoch loop that runs: "scanned" (K steps a program) or
        "per_step"."""
        return "scanned" if self._use_scanned_epoch() else "per_step"

    def _use_scanned_epoch(self) -> bool:
        """K steps a program need K > 1, the device loader with a train
        split (the program gathers its batches from the resident one) and
        the trimodal comparison on every step (the body's gate is fixed),
        as JAX's (trainer.py:317-336, less its mesh condition: multi-GPU
        training is ROADMAP.md item 5)."""
        return (self.steps_per_program > 1 and self.loader == "device"
                and self._device_train is not None and self.trimodal_metric_interval == 1)

    def _batch(self, batch: dict) -> dict:
        return builder.to_device(batch, self.device)

    def _step_program(self) -> StepProgram:
        if self._program is None:
            self._program = StepProgram(self.step, self._device_train, self.generator)
        return self._program

    def _epoch_batches(self, max_iters: int | None = None):
        """(iteration, batch) of the per-step loop (JAX trainer.py:279-311).
        Grain: n // B batches (at least 1) an epoch from the persistent
        stream, from `_iter_in_epoch` on, at most `max_iters` of them; the
        count is kept after each step, so that a cut epoch resumes where it
        stopped. Device: ceil(n / B) fresh draws an epoch (the first
        `max_iters`), each epoch's sampler seeded by its number."""
        if self._grain is not None:
            steps = max(1, self.train_data.n_samples // self.cfg.batch_size)
            stop = steps if max_iters is None else min(steps, self._iter_in_epoch + max_iters)
            for i in range(self._iter_in_epoch, stop):
                yield i, next(self._grain)
                self._iter_in_epoch = i + 1
            if self._iter_in_epoch >= steps:
                self._iter_in_epoch = 0
            return
        sampler = DeviceBatchSampler(self.train_data, self.cfg.batch_size,
                                     seed=self.epoch * 7919 + 1,
                                     device_dataset=self._device_train)
        for i, batch in enumerate(sampler):
            if max_iters is not None and i >= max_iters:
                return
            yield i, batch

    def per_train_epoch(self, max_iters: int | None = None) -> float:
        """One epoch (the first `max_iters` steps of it when given), per
        step or K steps a program; every `log_interval`-th step's metrics
        logged, the epoch's mean returned."""
        gan_on = self.epoch > self.gan_cfg.loss_warmup
        tri_every = self.trimodal_metric_interval
        total, n, total_l1, n_l1 = 0.0, 0, 0.0, 0
        start = time.time()

        def consume(i, values: dict[str, float]):
            nonlocal total, n, total_l1, n_l1
            # halt on a non-finite loss instead of training on garbage
            if not np.isfinite(values["s2ag_l1"]):
                raise FloatingPointError(
                    f"non-finite training loss at epoch {self.epoch} iter {i}: {values}")
            # with an interval-gated comparator only the steps that computed
            # it contribute to the epoch mean (ref processor_v2.py:821)
            if "s2ag_vs_trimodal_l1" in values:
                total, n = total + values["s2ag_vs_trimodal_l1"], n + 1
            total_l1, n_l1 = total_l1 + values["s2ag_l1"], n_l1 + 1
            if i % self.log_interval == 0:
                line = " | ".join(f"{k}: {v:.4f}" for k, v in values.items())
                self.logger.print_log(f"\tIter {i} Done. | {line}")

        if self._use_scanned_epoch():
            self._run_scanned_epoch(gan_on, consume, max_iters)
        else:
            def read(i, metrics):
                # one device->host copy for all of the step's metrics
                consume(i, dict(zip(metrics, torch.stack(list(metrics.values())).tolist())))

            pending: deque = deque()
            for i, batch in self._epoch_batches(max_iters):
                metrics = self.step.train_step(
                    batch, self.generator, gan_on=gan_on,
                    tri_metric=(tri_every == 1 or i % tri_every == 0))
                pending.append((i, metrics))
                if len(pending) > self.metrics_lag:
                    read(*pending.popleft())
            while pending:
                read(*pending.popleft())
        if n == 0:  # no comparator this epoch
            total, n = total_l1, n_l1
        self.logger.print_log(
            f"epoch {self.epoch} train: mean_s2ag_loss {total / max(n, 1):.4f} "
            f"({time.time() - start:.1f}s, {n_l1} iters, engine {self.epoch_engine})")
        return total / max(n, 1)

    def _run_scanned_epoch(self, gan_on: bool, consume, max_iters: int | None):
        """The epoch as programs of K steps (JAX trainer.py:396-464): the
        host draws each step's rows, then its adversarial speakers, in the
        per-step loop's order from its sampler, K steps at a time; each
        program's metrics are read `metrics_lag` steps later (at lag 0 at
        once; otherwise the newest program stays pending while the older
        ones are read), and `consume`d step by step, so the logged lines
        and the finite check are the per-step loop's, the check naming the
        step."""
        bs = self.cfg.batch_size
        sampler = BatchSampler(self.train_data, bs, seed=self.epoch * 7919 + 1)
        steps = sampler.pseudo_passes()
        if max_iters is not None:
            steps = min(steps, max_iters)
        program = self._step_program()
        pending: deque = deque()   # (first step, K, metric names, (K, n) metrics)
        pend_steps = 0

        def drain(keep: int = 0):
            nonlocal pend_steps
            items = [pending.popleft() for _ in range(len(pending) - keep)]
            pend_steps = sum(k for _, k, _, _ in pending)
            for first, k, keys, values in items:
                for j, row in enumerate(values.tolist()):
                    consume(first + j, dict(zip(keys, row)))

        done = 0
        while done < steps:
            k = min(self.steps_per_program, steps - done)
            idx = np.empty((k, bs), np.int64)
            adv = np.empty((k, bs), np.int64)
            for j in range(k):
                idx[j], adv[j] = sampler.draw()
            keys, values = program.run(idx, adv, gan_on)
            pending.append((done, k, keys, values))
            pend_steps += k
            done += k
            if self.metrics_lag == 0:
                drain()
            elif len(pending) > 1 and pend_steps - k > self.metrics_lag:
                drain(keep=1)
        drain()

    def per_val_epoch(self) -> float:
        sampler = BatchSampler(self.val_data, self.cfg.batch_size, seed=999)
        gan_on = self.epoch > self.gan_cfg.loss_warmup
        collected = []
        for batch in sampler:
            _, metrics = self.step.eval_step(self._batch(batch), self.generator,
                                             gan_on=gan_on)
            collected.append(metrics.get("s2ag_vs_trimodal_l1", metrics["s2ag_l1"]))
        mean = float(torch.stack(collected).mean()) if collected else 0.0
        self.logger.print_log(f"epoch {self.epoch} val: mean_s2ag_loss {mean:.4f}")
        return mean

    def train(self, epochs: int | None = None):
        epochs = epochs or self.cfg.epochs
        for self.epoch in range(self.epoch, epochs):
            epoch_loss = self.per_train_epoch()
            save = self.epoch % self.save_interval == 0
            if self.val_data is not None and self.epoch % self.val_interval == 0:
                epoch_loss = self.per_val_epoch()
                if epoch_loss < self.best_loss and self.epoch > MIN_TRAIN_EPOCHS:
                    self.best_loss = epoch_loss
                    self.best_loss_epoch = self.epoch
                    save = True
            if save:
                self.save_checkpoint(epoch_loss)

    # -------------------------------------------------------- checkpoints
    def _ckpt_name(self, loss: float) -> str:
        return f"epoch_{self.epoch:06d}_loss_{loss:.4f}_model.pth.tar"

    def save_checkpoint(self, loss: float) -> str:
        """The checkpoint of this epoch, and its data-state file."""
        path = os.path.join(os.path.abspath(self.work_dir), self._ckpt_name(loss))
        torch.save({
            "gen_model_dict": {f"module.{k}": v for k, v in self.gen.state_dict().items()},
            "dis_model_dict": {f"module.{k}": v for k, v in self.dis.state_dict().items()},
            "gen_optimizer_dict": reference_optimizer_state(self.step.gen_opt),
            "dis_optimizer_dict": reference_optimizer_state(self.step.dis_opt),
        }, path)
        state = {
            "iter_in_epoch": self._iter_in_epoch,
            "generator_device": self.generator.device.type,
            "generator_state": base64.b64encode(
                self.generator.get_state().numpy().tobytes()).decode("ascii"),
            "step": self.step.step,
        }
        if self._grain is not None:
            state["grain"] = self._grain.state()
        with open(datastate_path(path), "w") as f:
            json.dump(state, f)
        self.logger.print_log(f"saved checkpoint {path}")
        return path

    def _restore_data_state(self, path: str) -> None:
        """The draws' state of a checkpoint's data-state file: the step
        generator's (where it was saved from a generator on this device
        type: a CPU generator's state is not a card's), the step count,
        the position in the epoch and, under grain, the stream's next batch
        and seed (the saved seed, whichever this trainer was built with,
        as JAX trainer.py:633-646)."""
        with open(path) as f:
            state = json.load(f)
        if state["generator_device"] == self.generator.device.type:
            raw = np.frombuffer(base64.b64decode(state["generator_state"]), np.uint8)
            self.generator.set_state(torch.from_numpy(raw.copy()))
        else:
            self.logger.print_log(
                f"Warning: {path} holds a {state['generator_device']} generator's state; "
                f"the {self.generator.device.type} generator keeps its own")
        self.step.step = int(state["step"])
        self._iter_in_epoch = int(state["iter_in_epoch"])
        if self._grain is not None and "grain" in state:
            self._grain.set_state(state["grain"])

    def load_checkpoint(self, epoch: int | str = "best") -> bool:
        """Resume from a checkpoint of `work_dir`: weights, BN statistics
        and both Adam states (whose update counts carry the learning-rate
        schedule's), and, where its data-state file is beside it, the
        draws' state (`_restore_data_state`); training continues at its
        epoch (under grain, at its step)."""
        found = find_checkpoint(self.work_dir, epoch)
        if not found:
            self.logger.print_log("Warning! No saved model found.")
            return False
        name, ckpt_epoch, loss = found
        blob = torch.load(os.path.join(self.work_dir, name), map_location=self.device,
                          weights_only=True)
        self.gen.load_state_dict(strip_module_prefix(blob["gen_model_dict"]), strict=True)
        self.dis.load_state_dict(strip_module_prefix(blob["dis_model_dict"]), strict=True)
        # the schedule's rate at the restored update counts; a K-step
        # program captured the old states, so the next scanned epoch makes
        # a new one
        self.step.load_optimizer_states(blob["gen_optimizer_dict"],
                                        blob["dis_optimizer_dict"])
        # in place: the generator object is the one the steps draw from,
        # and the one a captured program registered
        state_path = datastate_path(os.path.join(self.work_dir, name))
        if os.path.exists(state_path):
            self._restore_data_state(state_path)
        self._program = None
        self.epoch = ckpt_epoch
        self.best_loss, self.best_loss_epoch = loss, ckpt_epoch
        self.logger.print_log(f"restored {name}")
        return True

    def load_torch_checkpoint(self, path: str):
        """Weights of a reference .pth.tar ({'gen_model_dict',
        'dis_model_dict'}): the port's parameter names are the reference's."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.gen.load_state_dict(strip_module_prefix(blob["gen_model_dict"]), strict=True)
        self.dis.load_state_dict(strip_module_prefix(blob["dis_model_dict"]), strict=True)
        self.logger.print_log(f"loaded torch checkpoint {path}")

    def load_trimodal_torch_checkpoint(self, path: str):
        """The frozen TriModal baseline (outputs/trimodal_gen.pth.tar, key
        'trimodal_gen_dict'; ref processor_v2.py:1033-1034)."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.tri.load_state_dict(strip_module_prefix(blob["trimodal_gen_dict"]),
                                 strict=True)
        self.logger.print_log(f"loaded trimodal checkpoint {path}")

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def generate_gestures(self, batch_size: int = 2048, randomized: bool = True,
                          seed: int = 0, full_test: bool = False,
                          eps: np.ndarray | None = None) -> dict[str, float]:
        """The test split's L1, joint MAE, acceleration difference and, with
        an evaluator, FGD and feat_dist (ref generate_gestures,
        processor_v2.py:1071-1142, as the JAX trainer scores them).

        One draw of at most `batch_size` samples (the first ones unless
        `randomized`), or with `full_test` the whole split in `batch_size`
        chunks; each chunk's speakers are drawn uniformly from the speaker
        vocabulary (ref processor_v2.py:724-726), with numpy's
        `default_rng(seed)` in the JAX trainer's order. `eps` (n, 16), when
        given, is the speaker noise of the scored samples in order (tests
        inject it); otherwise it comes from the trainer's generator."""
        ds = self.test_data
        rng = np.random.default_rng(seed)
        if full_test:
            idx_all = np.arange(ds.n_samples)
        else:
            n = min(batch_size, ds.n_samples)
            idx_all = (rng.choice(ds.n_samples, n, replace=False) if randomized
                       else np.arange(n))
        speaker_pool = sorted(ds.speaker_model.word2index.values())
        losses_all, joint_mae, accel = (AverageMeter(k) for k in ("loss", "mae", "accel"))
        n_scored = 0
        for start in range(0, len(idx_all), batch_size):
            idx = idx_all[start:start + batch_size]
            batch = decode_rows(ds, idx)
            batch["vid_indices"] = rng.choice(speaker_pool, len(idx)).astype(np.int64)
            chunk_eps = None
            if eps is not None:
                chunk_eps = torch.as_tensor(eps[n_scored:n_scored + len(idx)],
                                            dtype=torch.float32, device=self.device)
            out, _ = self.step.eval_step(self._batch(batch), self.generator,
                                         gan_on=self.epoch > self.gan_cfg.loss_warmup,
                                         eps=chunk_eps)
            push_sample_metrics(batch["vec_seq"], out, self.cfg.mean_dir_vec_array,
                                losses_all, joint_mae, accel, self.cfg.n_pre_poses,
                                self.evaluator)
            n_scored += len(idx)
        if n_scored == 0:
            raise RuntimeError(f"eval scored 0 samples ({ds.n_samples} in the test "
                               "split): the metrics would be meaningless")
        result = {"l1": losses_all.avg, "joint_mae": joint_mae.avg, "accel": accel.avg}
        if self.evaluator is not None and self.evaluator.get_no_of_samples() > 0:
            result["FGD"], result["feat_dist"] = self.evaluator.get_scores()
            self.evaluator.reset()
        self.logger.print_log(
            "eval: " + " | ".join(f"{k}: {v:.4f}" for k, v in result.items()))
        return result
