"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit. In order:

1. prints the card's name and power limit, and builds the hand-written
   kernels from `speech2affective_gestures_torch/csrc/` with nvcc for
   sm_90a (one nvcc per source, started together);
2. kernel phase: each kernel against its plain PyTorch version on the card
   at the serving and training paths' shapes, within a stated tolerance,
   and twice for the same bits: the GRU forward (with and without the hp
   it saves for the backward: the same ys), the mel power, the GRU
   backward recurrence and its dW_hh reduction, and the GRU's autograd
   Function against autograd through the plain forward; the GRU forward
   and backward also at hidden sizes past 320 (their L2 tier); then the
   same three GRU kernels in the walk layout of `run_layer` (the v1 layer)
   against their plain versions and against the model layout's kernels on
   the same function; the mel kernel at shapes past the main paths' (its
   FFT tier's mixed-radix kernel at n_fft 400, 1000, 1536 and 480, its
   power-of-two kernel at 256 and at 64 bands, its DFT tier at n_fft 8192
   and 998) against its plain version and the float64 oracle; the GRU
   kernels' bf16 instances (the forward and the recurrence in the tier
   their plans name: the tensor-core tiers at H <= 320 where the batch is
   large enough, `gru_cuda.fwd_tier` and `bwd_tier`, else the register or
   L2 tier; dW on the tensor cores; both layouts) against their bf16 twins
   and against float32, each tensor tier also where its plan takes the
   register tier; and the GRU forward, recurrence and dW at the
   ConvDiscriminator's shape (T 28, B 512, H 64) and at the fused step's
   batch (B 1024, H 300 and 64) and at a data-parallel rank's batches (B
   256 and 128, H 300 and 64), float32 and bf16; and at the embedding
   net's context encoder (T 34, B 64, H 256, one direction; 64 and 256
   inputs), float32;
3. service phase: a full-width s2ag generator (config/multimodal_context_v2.yml:
   hidden 300, 4 GRU layers, embed 300; 1000 words, 100 speakers; random
   weights from seed 0) behind the HTTP server answers /synthesize for a
   10 s clip and /synthesize_batch for four clips of 3-12 s. The launch
   counters are set to 0 just before and read just after: both kernels
   must have run. The same requests through the same weights on the CPU
   (the plain path, same noise) must agree within tolerance;
4. v1 path: `gru_cuda.run_layer`, forward and backward under autograd at
   the generator's training shape, in float32 and in bf16; the counters
   are set to 0 just before and read just after: the three kernels of that
   dtype must have run; the mel path: `ops.dsp.mel_power_spectrogram` at
   n_fft 400, 80 bands (the FFT tier's mixed-radix kernel must have run),
   and at 44.1 kHz with n_fft 882 (the DFT tier must have run);
5. the auxiliary nets: the text-to-gesture path (`t2g_phase`): a
   synthetic corpus in the MPI Emotional Body Expressions layout (64
   clips of 80-240 frames of a 23-joint skeleton, sentences over 300
   words, a 300-d GloVe-format file, all from a seed) loaded by
   `load_data_with_glove`, which writes its cache, and read again from the
   cache; `train_t2g` at its defaults for 3 epochs (every loss finite);
   one step on the card against the CPU plain step from the same weights
   and batch at dropout 0; the step's p50, launches and busy share; the
   greedy decode of 8 clips over all 240 frames (unit quaternions, the
   same bits twice, against the CPU decode), its wall time and launches;
   then `aux_nets_phase`: `EmbeddingNet` in speech mode and in random mode
   (each pick) at batch 64 on raw audio, `PoseDecoderFC`,
   `DiscriminatorTriModal` at batch 512 with and without text features,
   each forward and backward in train mode on the card against the CPU on
   the same weights, inputs and dropout masks; the counters set to 0 just
   before and read just after: the GRU forward, recurrence and dW must run
   at (T 34, H 256), in each of the context encoder's two layers, and at
   (T 34, H 300);
6. embedding phase: `train_embedding.main` trains the FGD embedding net on
   the card on the synthetic corpus (every loss finite) and writes the
   `.pth.tar` that the training phase loads;
7. training phase: `main_v2.main` trains the paper's GAN at full width
   (generator hidden 300 with 4 bi-GRU layers, discriminator hidden 64,
   TriModal comparator hidden 300) at batch 512 for one epoch of a
   synthetic corpus (3 train steps, 1 validation batch), with the GAN terms
   on from the first step (`loss_warmup: -1` in a copy of the config). The
   counters are set to 0 just before and read just after: the GRU forward,
   backward and dW kernels must have run; every logged loss must be finite.
   After the epoch it scores the test split (~258 windows) with FGD
   (`--embedding-net-checkpoint`); the counters are set to 0 again just
   before `generate_gestures` and read just after: the GRU forward must
   have run; L1, joint MAE, accel, FGD and feat_dist must be finite;
8. evaluation parity: `generate_gestures` from the same weights, speakers
   and speaker noise on the card and on the CPU plain path: the generated
   poses, the embedding features and FGD must agree within tolerance;
9. one train step at full width and batch 16 on the card and on the CPU
   plain path (in float64, the reference, and in float32), from the same
   weights, batch and noise: the card's metrics, BN running stats and
   Adam's first moments must agree with the float64 step within tolerance;
   then `main_v2 --mixed-precision true` as in 6 (the bf16 instances of the
   forward, backward and dW must run in training, the forward's and the
   recurrence's tensor tiers and the tensor-core dW among them, only
   float32 in the scoring)
   and its step's p50 beside the float32 step's; one mixed-precision step
   on the card against the CPU bf16 path (weights scaled by 0.3); the
   service at `--serve-precision bf16` (/healthz and
   /metrics report bf16, its /synthesize runs the bf16 forward, its output
   against the CPU bf16 path, its p50 and p90);
10. the TED formats' route: `main_v2 --packed-data` on a raw export archive
   with clipping and LR decay, the trained checkpoint served over HTTP and
   streamed (`real_data_phase`, `trained_service_phase`, `stream_phase`);
11. the long-clip rendering of that archive's test split, of a test split
   of short clips and of a GENEA clip (`clip_render_phase`): both
   generators, per clip and batched, the
   counters set to 0 just before each and read just after (the mel kernel
   and the GRU forward must have run), batched against per clip, the card
   against the CPU plain path, the pickles loaded with `pickle` alone;
12. the paper's ablations (`ablation_phase`): `main_v2_abl_audio` and
   `main_v2_abl_aff` each train one epoch at full width and batch 512 and
   score the test split with FGD, at float32 and in mixed precision, the
   counters set to 0 just before each and read just after (the GRU
   kernels, the bf16 tensor tiers in mixed precision, the mel kernel in
   the corpus build, abl_aff's ConvDiscriminator at T 28), in their
   suffixed work dirs, every loss finite; each warm train step's p50 and
   profile; one train step of each against the CPU (float64, float32 and
   bf16); each float32 trainer's service against a CPU copy (no mel
   launch for abl_audio's generator, which eats raw audio); abl_audio's
   long-clip rendering of a test split of short clips, per clip and
   batched, with no mel launch;
13. the v1 pipeline (`v1_phase`): `main_v1` at its defaults (batch 32)
   trains the SER net (AttConvRNN at full width on (300, 40, 3) blocks)
   for one epoch of random blocks, then the emotion-conditioned GAN (the
   v1 generator at hidden 300, 4 layers; its discriminator at hidden 64)
   for one epoch of a synthetic corpus, the counters set to 0 just before
   and read just after (the float32 GRU forward, recurrence and dW, and
   the mel kernel in the corpus build), every loss and the val accuracy
   finite; one SER step (batch 4) and one GAN step (batch 16) against the
   CPU in float64 and float32, max-pool picks and ReLU branches replayed
   where float32 rounding flips them; each warm step's p50 and profile:
   the SER step, the GAN step, the SER forward on the zero blocks;
14. `main_v2`'s step options (`step_options_phase`): `main_v2` with
   `--fused-pass true` (float32 and mixed precision: the GRU kernels must
   run at B 1024, `gru_cuda.batch_launches`), `--remat full` and `--remat
   dots --mixed-precision true`, the counters set to 0 just before each
   and read just after (the GRU kernels at the run's dtype, the mel
   kernel in the corpus build), every loss finite; remat against the
   plain step at batch 512 and the config's dropout, bit for bit, in
   float32 and mixed precision (under `cudnn.deterministic` where the
   plain step does not repeat itself); the fused s2ag and abl_aff steps
   at batch 16 against the CPU float64 fused step; each step's p50,
   profile and peak memory, plain, fused, remat full and dots, float32
   and mixed;
15. `main_v2`'s scanned epoch (`scanned_epoch_phase`): `main_v2
   --steps-per-program 2` at full width, float32, mixed precision,
   `--fused-pass true` and `--remat full` (3 train steps: a CUDA graph of
   2 steps and one of 1), the counters set to 0 just before each and read
   just after: the engine must be "scanned" with no fallback, the GRU
   recurrence's and dW's training launches the warm-ups' plus each graph's
   launches per replay times its replays, every loss finite; the K-step
   graphs against their eager steps at batch 512 under
   `cudnn.deterministic`, bit for bit (LR decay inside the program, mixed
   precision, fused, remat full), with their distance from the per-step
   loop logged; the step's p50, launches, busy share and peak memory one
   step at a time and as graphs of K 1 and 4, float32 and mixed; then the
   step's MFU (`mfu_phase`): `train/flops.canonical_train_step_flops` at
   batch 512 (within 2% of 4x the tests' pinned batch-128 count), the
   card's measured bf16 and float32 peaks (`train/timing.measure_peak_flops`,
   at most 1.05x the data sheet's), the float32 per-step loop and the
   float32 and mixed K 4 graphs timed by `time_compiled_step` (the counters
   set to 0 before each: the GRU forward, recurrence and dW must run, a
   replay's launches equal to its capture's record), each MFU against the
   data sheet's and the measured peak (at most 1), and a
   `train/profiling.trace` of two steps whose file names the GRU kernels;
16. the streaming loader and resumed training (`grain_phase`): `main_v2
   --loader grain --steps-per-program 2` at full width for 2 epochs (2
   steps each from one stream), the counters set to 0 just before and
   read just after (the float32 GRU forward, recurrence and dW must run),
   every loss finite, the split off the card, the log naming loader grain,
   the per-step engine and the fallback from K 2; under
   `cudnn.deterministic`, a grain run cut in the middle of epoch 1, saved
   and resumed by a trainer built with another seed, and device-loader
   runs (per step and K 2) cut at an epoch's end and resumed so, each the
   same bits as the uncut run; a grain batch decoded on the card against
   `decode_rows` on the host, bit for bit; the step's p50 and busy share
   fed by the device loader, by the stream with its rows made in the step
   (the loader's way) and made ahead on a worker thread, launches alone
   and beside such a thread, and the host's ms per batch;
17. data-parallel training (`data_parallel_phase`, `parallel.mesh`): (a)
   two gloo ranks on this card, 256 rows each of batch 512, 3 steps,
   each against one process's step on the same global batch from the same
   state (metrics, weights, BN stats at JAX's mesh bounds), the ranks the
   same bits after each step, and a mixed-precision step; (b) one NCCL
   rank's K 2 graphs, their all-reduces captured, against their eager
   steps bit for bit under `cudnn.deterministic`; (c) with more than one
   card, `main_v2` over NCCL on every card for 2 epochs (with one card it
   logs that (c) did not run); (d) 4 gloo ranks on this card (128 rows
   each) resumed from a checkpoint against the uncut run bit for bit
   under `torch.use_deterministic_algorithms`, and a mixed step; the step
   p50s, the all-reduces' count, bytes and ms a step, the GRU launches a
   step; the GRU kernels checked and timed at a rank's batch (B 256 and
   128, float32 and bf16);
18. the 2-D (data, model) grid (`model_parallel_phase`,
   `parallel.mesh.make_mesh_2d`, `shard_params_2d`): four gloo ranks on
   this card as a 2 x 2 grid at full width and 2048 words (the text
   tables split by row, G's and the TriModal's GRU gates by column at
   tp_min_cols 900), 256 rows a data rank of batch 512: (a) 2 steps, each
   against one process's step from the same state (metrics, weights, BN
   stats at JAX's mesh bounds, Adam's first moments), the data axis' ranks
   the same bits, the placement and the slices' shapes, a clipped step,
   and three wrong grids (the slices' gradients summed over the model
   axis, BatchNorm's count over the world, the clip counting each slice
   twice) that must fail those checks; (b) a mixed-precision step against
   one process's; (c) the batched synthesis of 4 clips of 3-12 s split
   over the data axis (pad_to 2) against one process's, the GRU and mel
   kernels counted on each rank; (d) with four cards the grid over NCCL
   a card a rank, its step p50 (with fewer it logs that (d) did not
   run); the collectives and bytes a step by axis, a rank's memory and
   the GRU launches on rank 0, which must be above zero;
19. timing: each kernel's time, its plain version's, a PyTorch library
   call's that computes the same function, and the least time the card
   could take (bound), by CUDA events and by device time; the GRU
   backward (recurrence + dW) against cuDNN's recurrent backward; the L2
   tier's times; the bf16 instances against cuDNN's bf16 `nn.GRU` (and the
   bf16 forward's and recurrence's two register-range tiers against each
   other across batches); the mel kernel's mixed-radix FFT at n_fft 400
   and its DFT tier against `rfft`; the GRU kernels at the
   ConvDiscriminator's shape, at the fused batch (B 1024, H 300), at a
   rank's batch (B 256 and 128, H 300) and at the context encoder's
   (H 256, one direction, each layer's input width, against cuDNN's
   unidirectional `nn.GRU`);
   the service's synthesize p50; the
   train step's p50, samples/s and its device profile; `generate_gestures`'
   wall time and device profile; the embedding train step's p50.

It prints one `{"kernels": [...]}` line before the last, and as the last
line `{"ok": true, "device": {...}}`. It exits non-zero, with no result
line, when CUDA is unavailable, when the package is missing beside it, or
when any phase fails.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import gc
import http.client
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PKG = ROOT / "speech2affective_gestures_torch"
CONFIG = ROOT / "config" / "multimodal_context_v2.yml"

# H100 SXM, NVIDIA data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

GRU_TOL = 1e-4        # absolute, h in [-1, 1] after 34 steps
# mel power, each value against its own magnitude: |got - want| <=
# MEL_RTOL |want| + MEL_FLOOR max|want|. Float32 sums of 2048 products in
# another order differ by ~1e-5 relative even in the quiet bands; the floor
# only covers values near zero.
MEL_RTOL = 1e-4
MEL_FLOOR = 1e-7
SERVE_TOL = 1e-3      # absolute, card vs CPU plain path, whole service
# GRU backward: dxp (and dpre_n r) absolute, a 34-step chain of sums of 3H
# products; dW_hh and the bias gradients within BWD_TOL of each one's
# largest value, sums of T*B products in another order
BWD_TOL = 1e-4
# the test-split evaluation, card vs the CPU plain path: the generated poses
# within SERVE_TOL; the embedding features (of order 1) within FEAT_TOL
# absolute, the embedding of poses that agree within SERVE_TOL through
# layers of gain near 1 in eval mode; FGD within FGD_RTOL relative: it is a
# difference of traces (of the two covariances and of their product's
# root) much larger than itself when the fakes lie near the real windows,
# so the features' float32 differences reach it amplified by that ratio
FEAT_TOL = 1e-3
FGD_RTOL = 1e-2
# the embedding phase: epochs of the synthetic corpus's windows at batch 64
EMB_EPOCHS, EMB_BATCH = 5, 64
# one train step, card vs the CPU plain path in float64: metrics relative
# (plus 1e-6 absolute for the near-zero difference of two L1 means); BN
# running stats and Adam's first moments within STEP_TOL of each tensor's
# largest value
STEP_TOL = 1e-3
# a ReLU or leaky ReLU pre-activation that the card's float32 step puts on
# the other side of zero than the CPU's float64 step must lie within
# FLIP_TOL of the largest |pre-activation| of its call: float32 rounding
# (sums of a few hundred products in another order, ~1e-7 of their
# operands), not an error of the function
FLIP_TOL = 1e-5
# the training phase: 20 synthetic videos of 60 s give ~1720 windows, 70%
# of them 3 train batches of 512 and 15% one validation batch
TRAIN_BATCH, TRAIN_VIDEOS, TRAIN_SECONDS = 512, 20, 60.0
# the mel kernel's shapes: the service's MFCCs (n_fft 2048: 8 windows of 71
# frames, 32 windows, and a row count that is no multiple of the tile), and
# the corpus build's log-mel of one training video (n_fft 1024, hop 512)
MEL_SHAPES = ((568, 2048), (2272, 2048), (601, 2048),
              (1 + int(TRAIN_SECONDS * 16000) // 512, 1024))
# the mel kernel's shapes past the main paths': the FFT tier's mixed-radix
# n_fft (n_fft/2 = 2^a 3^b 5^c, no power of two), its power-of-two kernel
# below 512 and at another band count, and the DFT tier's n_fft (past 4096,
# a prime factor above 5: 998 = 2 x 499), (rows, n_fft, n_mels)
MEL_OTHER_SHAPES = ((568, 400, 80), (568, 1000, 128), (568, 1536, 128), (568, 480, 40),
                    (568, 256, 128), (568, 2048, 64), (568, 8192, 128), (568, 998, 128))
# the mel entry point's other users: a 30 s clip's log-mel front end at 16
# kHz with 25 ms windows, 10 ms hops and 80 bands (Whisper's settings: the
# FFT tier's mixed-radix kernel), and a 10 s clip at 44.1 kHz with 20 ms
# windows and 10 ms hops (n_fft 882 = 2 x 3^2 x 7^2: the DFT tier)
WHISPER_MEL = dict(seconds=30.0, n_fft=400, hop_length=160, n_mels=80)
CD_MEL = dict(sr=44100, seconds=10.0, n_fft=882, hop_length=441, n_mels=80)
# hidden sizes past what a cluster's registers hold (the GRU kernels' L2
# tier), checked beside the model's 300 and 64
L2_HIDDEN = (321, 600, 1024)
# the bf16 instances against their bf16 twins (the plain versions at the
# same rounding points, fed the same inputs): ys and h_last absolute, h in
# [-1, 1]; dxp and gn relative to each one's largest value. The twins' float32
# sums run in another order, so a rounding to bf16 may land one ulp (2^-8
# relative) apart and carry into the later steps. dW_hh and db_hh from the
# same bf16 inputs are held to BWD_TOL (exact products, float32 sums in
# another order); bf16 against float32 on the same function within
# BF16_VS_F32 absolute.
BF16_TOL = 2e-2
BF16_VS_F32 = 0.05
# the mixed-precision step and bf16 serving on the card against the CPU bf16
# path, weights scaled by 0.3 (at raw init the recurrence is expansive and
# bf16 rounding grows over the window; the JAX package's
# tests/test_serve.py:409-440): relative to the largest value (the step's
# metrics each to its own, plus 5e-4 absolute for the near-zero difference
# of two L1 means)
MP_TOL = 3e-2
MP_SCALE = 0.3
# H100 SXM, NVIDIA data sheet: dense bf16 on the tensor cores
PEAK_BF16_FLOPS = 989e12
# the real-data phase: an export archive of 20 synthetic videos of 60 s in
# the raw TED schema split 14 / 3 / 3 (~1200 train windows: 2 steps an
# epoch at batch 512 for the decay, 3 batches), trained for 2 epochs
REAL_VIDEOS, REAL_SECONDS, REAL_SPLIT, REAL_EPOCHS = 20, 60.0, (14, 3, 3), 2
# the clip rendering: the real-data phase's 3 test videos of 60 s stitch
# into clips of ~59 s (the default range keeps 5-12 s); a test split of
# SHORT_VIDEOS videos of SHORT_SECONDS, whose clips of ~9.5 s the default
# range keeps; and a GENEA directory of one 8 s clip of a 31-joint skeleton
CLIP_RANGE = [1, 120]
SHORT_VIDEOS, SHORT_SECONDS = 32, 10.0
GENEA_JOINTS, GENEA_SECONDS = 31, 8.0
# the paper's ablations and their entry points; the ConvDiscriminator's
# unpadded convs (kernel 3, three of them) leave its GRU T 34 - 6 frames
ABLATIONS = ("abl_audio", "abl_aff")
CONV_DIS_T = 34 - 6
# the fused GAN step (`--fused-pass`) runs its nets at twice the train batch
FUSED_B = 2 * TRAIN_BATCH
# main_v2's step options driven on the card (`step_options_phase`): the
# flags, and whether the run is mixed precision
STEP_OPTIONS = ((("--fused-pass", "true"), False), (("--remat", "full"), False),
                (("--remat", "dots"), True), (("--fused-pass", "true"), True))
# main_v1's default batch, at which the v1 phase trains and times its steps
V1_BATCH = 32
# main_v2's scanned epoch (`scanned_epoch_phase`): the steps per program of
# its main_v2 runs, and each run's other flags and whether it is mixed
# precision; the settings whose K-step graphs are held to their eager
# steps (the decay's epoch cut to one update, so that the rate changes
# inside each program); the rows of the random split the graphs gather
# from; the K of the timed program
SCAN_SPP = 2
SCAN_RUNS = (((), False), ((), True), (("--fused-pass", "true"), False),
             (("--remat", "full"), False))
SCAN_PARITY = (("float32, LR decay", {"lr_decay": 0.5, "decay_steps_per_epoch": 1}),
               ("mixed precision", {"mixed": True}), ("fused", {"fused_pass": True}),
               ("remat full", {"remat": "full"}))
SCAN_ROWS = 2048
SCAN_K = 4
# the streaming loader (`grain_phase`): main_v2's epochs with it, and the
# steps and batches of its numbers
GRAIN_EPOCHS = 2
GRAIN_STEPS, GRAIN_DECODES = 6, 5
# data-parallel training (`data_parallel_phase`): the checked steps of two
# gloo ranks on one card and the timed ones after them; the ranks of the
# resume check (a rank's batch TRAIN_BATCH / 4); each launch's timeout
DP_STEPS, DP_TIMED = 3, 4
DP_RESUME_RANKS = 4
DP_TIMEOUT = 600
# (a)'s Adam first moments against one process's: each tensor's moment
# difference (norm 2) within DP_MOMENT_RTOL of its gradient's share of
# the moment, plus that much of the net's share scaled to the tensor's
# size (a gradient that is exactly 0, as a bias a BatchNorm follows,
# leaves only rounding). Float32 rounding came to 1.4e-3 of it at most
# at full width on the H100; a rank's own rows' gradient comes to 0.53
# and more, a summed or lost one to 1.0
DP_MOMENT_RTOL = 1e-2
# (c)'s timed steps a rank count, after DP_WARM steps
DP_SCALING_TIMED, DP_WARM = 8, 3
# the 2-D grid (`model_parallel_phase`): a GRID_SHAPE (data, model) grid,
# its vocabulary (the text tables split by row at min_rows 1024) and
# tp_min_cols (3H: G's and the TriModal's GRU gates split by column); the
# steps checked against one process and the timed ones after them; the
# clip norm of the clipped step and its mutant; the synthesis' clips (s)
GRID_SHAPE = (2, 2)
GRID_WORDS, GRID_TP_COLS = 2048, 900
GRID_STEPS, GRID_TIMED = 2, 3
GRID_CLIP = 0.1
GRID_CLIPS = (3.0, 6.0, 9.0, 12.0)
GRID_MUTANTS = ("shard gradient summed", "BN count over the world", "clip counts shards twice")
# the sharded synthesis against one process's, absolute
GRID_SYNTH_TOL = 1e-5
# the capturable Adam against the host Adam on the same gradients: each
# parameter within n updates x (CAP_ULPS of its tensor's largest value +
# CAP_LR of the base rate)
CAP_ULPS, CAP_LR = 2.0 ** -22, 2e-5
# the text-to-gesture phase (`t2g_phase`): a synthetic corpus in the MPI
# Emotional Body Expressions layout, T2G_CLIPS clips of T2G_FRAMES frames
# (the longest sets max_time_steps) of a 23-joint skeleton (quat_dim 92),
# sentences over T2G_WORDS words, and a GloVe-format file of width
# T2G_GLOVE_DIM (that of the public 300-d GloVe tables), trained
# T2G_EPOCHS epochs at `train_t2g`'s defaults (batch T2G_BATCH, lr 1e-3);
# T2G_DECODE_CLIPS clips decoded. One step on the card against the CPU
# plain step from the same weights and batch at dropout 0 (`t2g_step_parity`
# says how far); the decode within T2G_TOL absolute
T2G_CLIPS, T2G_FRAMES, T2G_WORDS, T2G_GLOVE_DIM = 64, (80, 240), 300, 300
T2G_EPOCHS, T2G_BATCH, T2G_DECODE_CLIPS = 3, 8, 8
T2G_TOL = 1e-4
MPI_JOINTS = (("Hips", -1), ("Spine", 0), ("Spine1", 1), ("Spine2", 2), ("Spine3", 3),
              ("Neck", 4), ("Head", 5), ("LeftShoulder", 4), ("LeftArm", 7),
              ("LeftForeArm", 8), ("LeftHand", 9), ("RightShoulder", 4), ("RightArm", 11),
              ("RightForeArm", 12), ("RightHand", 13), ("LeftUpLeg", 0), ("LeftLeg", 15),
              ("LeftFoot", 16), ("LeftToeBase", 17), ("RightUpLeg", 0), ("RightLeg", 19),
              ("RightFoot", 20), ("RightToeBase", 21))
MPI_TAGS = {"Intended emotion": ("amusement", "anger", "disgust", "fear", "joy", "neutral",
                                 "pride"),
            "Intended polarity": ("positive", "negative", "neutral"),
            "Perceived category": ("amusement", "anger", "disgust", "fear", "joy", "neutral",
                                   "pride"),
            "Perceived polarity": ("positive", "negative", "neutral"),
            "Acting task": ("narration", "monologue", "dialogue"),
            "Gender": ("female", "male"), "Age": None, "Handedness": ("right", "left"),
            "Native tongue": ("german", "english", "french", "spanish")}
# the auxiliary nets (`aux_nets_phase`): the embedding net at the embedding
# trainer's batch on a window's raw audio, a vocabulary of AUX_WORDS words;
# DiscriminatorTriModal at the training batch; card against the CPU plain
# path on the same weights, inputs and dropout masks: outputs within
# AUX_TOL absolute, gradients within AUX_TOL of each tensor's largest (a
# bias ahead of a train-mode batch norm, zero but for rounding, of the
# net's largest)
AUX_BATCH, AUX_DIS_BATCH, AUX_WORDS, AUX_TOL = EMB_BATCH, TRAIN_BATCH, 1000, 1e-4
AUDIO_SAMPLES = 36267
# the context encoder's GRU: H 256, one direction; layer 0 takes 64
# inputs, layer 1 256
CONTEXT_H, CONTEXT_INPUTS = 256, (64, 256)
# the GRU kernels' symbols in the profiler's kernel names, by the launch
# counters' kernel (the dW reduction's second pass, which follows each dW
# launch, left out)
GRU_SYMBOLS = {"gru_fwd": r"\bgru_layer_fwd(?:_l2|_tc)?_kernel\b",
               "gru_bwd": r"\bgru_layer_bwd(?:_tc)?_kernel\b",
               "gru_dw": r"\bgru_dw(?:_tc)?_kernel\b"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() on the card over `iters` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_inputs(T, B, cin, H, D, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    bound = H ** -0.5
    x = torch.randn(T, B, cin, generator=g)
    w_ih = torch.empty(D * 3 * H, cin).uniform_(-bound, bound, generator=g)
    w_hh = torch.empty(D, H, 3 * H).uniform_(-bound, bound, generator=g)
    b_ih = torch.empty(D, 3 * H).uniform_(-bound, bound, generator=g)
    b_hh = torch.empty(D, 3 * H).uniform_(-bound, bound, generator=g)
    return [t.to(device).contiguous() for t in (x @ w_ih.t(), w_hh, b_ih, b_hh)]


def speech_frames(rows, device, n_fft=2048):
    """Hann-windowed frames of a synthetic voiced signal with noise."""
    import torch
    from speech2affective_gestures_torch.ops import dsp

    rng = np.random.default_rng(0)
    n = (rows + 8) * 512 + max(0, n_fft - 2048)   # whole frames at any n_fft
    t = np.arange(n) / 16000
    y = (0.4 * np.sin(2 * np.pi * (150 + 60 * np.sin(3 * t)) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    frames = dsp.windowed_frames(torch.from_numpy(y).to(device), n_fft)
    return frames.reshape(-1, n_fft)[:rows].contiguous()


def _band_errors(got, oracle):
    """Each mel band's worst relative error over the rows."""
    return ((got.double() - oracle).abs() / oracle.abs()).amax(dim=0)


def kernel_phase(device) -> dict:
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    errs = {"gru_fwd": 0.0, "mel_power": 0.0}
    T, D = 34, 2
    # the serving shapes (H 300, B 1-16, layer inputs 88 and 600), the
    # scoring and training batches (258, 512) and the discriminator's H 64
    shapes = [(300, B, cin) for B in (1, 2, 16) for cin in (88, 600)]
    shapes += [(300, 258, 600), (300, 512, 600), (64, 1, 8), (64, 512, 128)]
    # past H 320: the L2 tier
    shapes += [(H, B, 64) for H in L2_HIDDEN for B in (5, 512)]
    for H, B, cin in shapes:
        args = gru_inputs(T, B, cin, H, D, seed=B * 1000 + cin, device=device)
        ys, h_last = gru_cuda.gru_layer(*args)
        again = gru_cuda.gru_layer_forward(*args)
        # with hp saved (what training runs): the same ys, and hp within
        # tolerance of the plain loop's
        with_hp = gru_cuda.gru_layer_forward(*args, save_hp=True)
        want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(*args, save_hp=True)
        err = max((ys - want_ys).abs().max().item(),
                  (h_last - want_h).abs().max().item(),
                  (with_hp[2] - want_hp).abs().max().item())
        same = torch.equal(ys, again[0]) and torch.equal(h_last, again[1])
        same_hp = torch.equal(ys, with_hp[0]) and torch.equal(h_last, with_hp[1])
        plan = gru_cuda._device_plan(device, B, H, D)
        log(f"kernel gru_fwd T={T} B={B} cin={cin} H={H} D={D}: "
            f"max_abs_err={err:.3e} (tol {GRU_TOL}); bitwise repeatable {same}; the "
            f"same ys with hp saved {same_hp}; plan {plan._asdict()} ({D * plan.tiles} "
            f"clusters, at most {gru_cuda.max_clusters(device, H)} at once)")
        if not (err <= GRU_TOL and same and same_hp):
            raise AssertionError(f"gru_fwd disagrees with its plain version: {err}, "
                                 f"repeatable {same}, same with hp {same_hp}")
        errs["gru_fwd"] = max(errs["gru_fwd"], err)
    for rows, n_fft in MEL_SHAPES:
        frames = speech_frames(rows, device, n_fft)
        got = mel_cuda.mel_power(frames)
        same = torch.equal(got, mel_cuda.mel_power(frames))
        want = mel_cuda.mel_power_plain(frames)
        diff = (got - want).abs()
        scale = want.abs().max().item()
        ok = bool((diff <= MEL_RTOL * want.abs() + MEL_FLOOR * scale).all())
        band_rel = (diff / want.abs()).amax(dim=0)    # worst of each band
        worst = int(band_rel.argmax())
        # the float64 oracle: rfft of the frames in float64, its power, the
        # float32 filterbank's values in a float64 product
        spec = torch.fft.rfft(frames.double(), dim=-1)
        fb = torch.from_numpy(mel_cuda.dft_constants(16000, n_fft, 128)[2]).to(device)
        oracle = (spec.real ** 2 + spec.imag ** 2) @ fb.double()
        k_err, p_err = _band_errors(got, oracle), _band_errors(want, oracle)
        log(f"kernel mel_power R={rows} n_fft={n_fft}: "
            f"max_abs_err={diff.max().item():.3e} "
            f"(max |mel| {scale:.3e}); worst relative error per band: max "
            f"{band_rel[worst].item():.3e} in band {worst} (its smallest |mel| "
            f"{want[:, worst].abs().min().item():.3e}), median "
            f"{band_rel.median().item():.3e}; smallest |mel| "
            f"{want.abs().min().item():.3e}; tol {MEL_RTOL} |want| + "
            f"{MEL_FLOOR} max|want|; bitwise repeatable {same}")
        log(f"  against the float64 rfft oracle, worst relative error of a band: "
            f"kernel {k_err.max().item():.3e} (band {int(k_err.argmax())}, median "
            f"{k_err.median().item():.3e}), plain {p_err.max().item():.3e} (band "
            f"{int(p_err.argmax())}, median {p_err.median().item():.3e}); the kernel "
            f"is farther in {int((k_err > p_err).sum())} of 128 bands")
        if not (ok and same and k_err.max() <= p_err.max()):
            raise AssertionError(f"mel_power disagrees at R={rows} n_fft={n_fft}: "
                                 f"band {worst} off its plain version by "
                                 f"{band_rel[worst].item():.3e}; from the oracle "
                                 f"{k_err.max().item():.3e} against the plain "
                                 f"version's {p_err.max().item():.3e}; repeatable {same}")
        errs["mel_power"] = max(errs["mel_power"], diff.max().item())
    errs["mel_dft"] = errs["mel_power_mixed"] = 0.0
    for rows, n_fft, n_mels in MEL_OTHER_SHAPES:
        errs.update(mel_other_shape(device, rows, n_fft, n_mels, errs))
    return errs


def mel_other_shape(device, rows, n_fft, n_mels, errs) -> dict:
    """The mel kernel at a shape past the FFT tier's (n_fft) or the main
    paths' (n_mels) against its plain version (MEL_RTOL of each value plus
    MEL_FLOOR of the largest) and the float64 oracle: the FFT tier's worst
    band no farther from it than the plain version's, the DFT tier's values
    within the same tolerance of it (a dense sum, as the plain version's);
    the same bits twice. Returns the tier's updated largest error."""
    import torch
    from speech2affective_gestures_torch.ops import mel_cuda

    frames = speech_frames(rows, device, n_fft)
    plan = mel_cuda.mel_plan(rows, n_fft, n_mels)
    got = mel_cuda.mel_power(frames, n_mels=n_mels)
    same = torch.equal(got, mel_cuda.mel_power(frames, n_mels=n_mels))
    want = mel_cuda.mel_power_plain(frames, n_mels=n_mels)
    diff = (got - want).abs()
    ok = bool((diff <= MEL_RTOL * want.abs() + MEL_FLOOR * want.abs().max()).all())
    spec = torch.fft.rfft(frames.double(), dim=-1)
    fb = torch.from_numpy(mel_cuda.dft_constants(16000, n_fft, n_mels)[2]).to(device)
    oracle = (spec.real ** 2 + spec.imag ** 2) @ fb.double()
    keep = oracle.abs().amax(dim=0) > 0   # bands without a bin are zero in all three
    k_err, p_err = _band_errors(got, oracle)[keep], _band_errors(want, oracle)[keep]
    off = (got.double() - oracle).abs()
    within = bool((off <= MEL_RTOL * oracle.abs() + MEL_FLOOR * oracle.abs().max()).all())
    oracle_ok = k_err.max() <= p_err.max() if plan.tier == "fft" else within
    log(f"kernel mel_power R={rows} n_fft={n_fft} n_mels={n_mels}: {plan.tier} tier "
        f"({_mel_name(plan.tier, n_fft)}) "
        f"{plan._asdict()}; max_abs_err={diff.max().item():.3e} against the plain "
        f"version (max |mel| {want.abs().max().item():.3e}; within {MEL_RTOL} |want| + "
        f"{MEL_FLOOR} max|want|: {ok}); against the float64 oracle the worst band's "
        f"relative error: kernel {k_err.max().item():.3e}, plain {p_err.max().item():.3e}, "
        f"every value within the tolerance of the oracle {within}; "
        f"{int((~keep).sum())} bands without a bin; bitwise repeatable {same}")
    if not (ok and oracle_ok and same):
        raise AssertionError(f"mel_power disagrees at R={rows} n_fft={n_fft} "
                             f"n_mels={n_mels}: plain {ok}, oracle {oracle_ok}, "
                             f"repeatable {same}")
    name = _mel_name(plan.tier, n_fft)
    return {name: max(errs[name], diff.max().item())}


def _mel_name(tier: str, n_fft: int) -> str:
    """The mel kernel's name in the kernels line at this tier and n_fft:
    "mel_power" (the FFT tier at a power of two), "mel_power_mixed" (its
    mixed-radix kernel), "mel_dft" (the DFT tier)."""
    if tier == "dft":
        return "mel_dft"
    return "mel_power_mixed" if n_fft & (n_fft - 1) else "mel_power"


def bf16_kernel_phase(device) -> dict:
    """The GRU kernels' bf16 instances against their bf16 twins on the card
    (BF16_TOL; dW_hh and db_hh from the same inputs BWD_TOL), each launch
    counted under its bf16 name and none under float32; the same bits
    twice; and bf16 against float32 on the same function (BF16_VS_F32).
    The model layout at the serving, scoring and training batches (B 1,
    258, 512) and a batch of 5 at H 300, the discriminator's H 64, H 40,
    the odd H 301, and the L2 tier's H 600; the walk layout (`run_layer`)
    at H 300, 64, 40 and 301. The forward and the recurrence run the tiers
    their plans name (`gru_cuda.fwd_tier`, `bwd_tier`: the tensor tiers at
    H <= 320 where the batch is large enough, the register tier below), dW
    the tensor cores; each log line names both tiers. Where the forward's
    plan takes the register tier in the model layout, its tensor tier is
    also held against the twin; where the recurrence's does (either
    layout, H <= 320), its tensor tier is too, the same bits twice: partial
    m16 tiles at B 1 and 5, H 64 and 40, each launched with its own
    plan."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    bf16 = torch.bfloat16
    names = ("gru_fwd", "gru_bwd", "gru_dw")
    errs = {f"{k}{v}_bf16": 0.0 for v in ("", "_v1") for k in names}
    T, D = 34, 2
    for walk, H, B, cin in ((False, 300, 1, 600), (False, 300, 5, 600), (False, 300, 258, 600),
                            (False, 300, 512, 600), (False, 64, 512, 128),
                            (False, 40, 512, 128), (False, 301, 258, 600),
                            (False, 600, 512, 64), (True, 300, 512, 600), (True, 64, 5, 128),
                            (True, 40, 512, 128), (True, 301, 5, 600)):
        f32 = gru_inputs(T, B, cin, H, D, seed=B + 3 * H, device=device)
        if walk:
            xp32, w32, bh32, _ = v1_inputs(T, B, cin, H, D, seed=B + 3 * H, device=device)
            xp, w_hh, b_hh = (t.to(bf16).contiguous() for t in (xp32, w32, bh32))
            shape = (T, D, B, H)
            fwd = lambda save_hp=False: gru_cuda.run_layer_forward(xp, w_hh, b_hh, save_hp)
            plain_fwd = lambda: gru_cuda._walk_forward(*gru_cuda._walk_inputs(xp, w_hh, b_hh))
            rec = lambda ys, dys, hp: gru_cuda.run_layer_bwd_recurrence(xp, w_hh, b_hh, ys, dys, hp)
            plain_rec = lambda ys, dys, hp: gru_cuda.run_layer_bwd_recurrence_plain(
                xp, w_hh, b_hh, ys, dys, hp)
            dw_fn, dw_plain = gru_cuda.run_layer_dw, gru_cuda.run_layer_dw_plain
            vs32 = lambda ys: (ys.float() - gru_cuda.run_layer_forward(xp32, w32, bh32)).abs().max()
            suffix = "_v1"
        else:
            xp, w_hh, b_ih, b_hh = (t.to(bf16).contiguous() for t in f32)
            shape = (T, B, D * H)
            fwd = lambda save_hp=False: gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp)
            plain_fwd = lambda: gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh, save_hp=True)
            rec = lambda ys, dys, hp: gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
            plain_rec = lambda ys, dys, hp: gru_cuda.gru_bwd_recurrence_plain(
                xp, w_hh, b_ih, b_hh, ys, dys, hp)
            dw_fn = lambda ys, dxp, gn: gru_cuda.gru_dw(ys, dxp, gn, D)
            dw_plain = lambda ys, dxp, gn: gru_cuda.gru_dw_plain(ys, dxp, gn, D)
            vs32 = lambda ys: (ys.float() - gru_cuda.gru_layer_forward(*f32)[0]).abs().max()
            suffix = ""
        dys = torch.randn(shape, generator=torch.Generator().manual_seed(H + B)).to(device, bf16)
        before = _counters()
        out = fwd(save_hp=True)
        ys, hp = out[0], out[-1]
        dxp, gn = rec(ys, dys, hp)
        dw, db = dw_fn(ys, dxp, gn)
        torch.cuda.synchronize()
        delta = _counters() - before
        want_delta = {f"{k}{suffix}_bf16": 1 for k in names}
        if dict(delta) != want_delta:
            raise AssertionError(f"bf16 launches {dict(delta)}, expected {want_delta}")
        if walk:
            want_ys, want_hp = plain_fwd()
            fwd_err = (ys.float() - want_ys.float()).abs().max().item()
        else:
            want_ys, want_h, want_hp = plain_fwd()
            fwd_err = max((ys.float() - want_ys.float()).abs().max().item(),
                          (out[1].float() - want_h.float()).abs().max().item())
        hp_rel = _rel(hp, want_hp)
        want_dxp, want_gn = plain_rec(ys, dys, hp)
        bwd_rel = max(_rel(dxp.float(), want_dxp.float()), _rel(gn.float(), want_gn.float()))
        dw, db = dw_fn(ys, want_dxp, want_gn)
        want_dw, want_db = dw_plain(ys, want_dxp, want_gn)
        dw_rel = max(_rel(dw, want_dw), _rel(db, want_db))
        again = dw_fn(ys, want_dxp, want_gn)
        same = (torch.equal(dw, again[0]) and torch.equal(db, again[1])
                and torch.equal(ys, fwd()[0] if not walk else fwd())
                and torch.equal(dxp, rec(ys, dys, hp)[0]))
        f32_err = vs32(ys).item()
        tier = gru_cuda._device_plan(device, B, H, D, bf16).tier
        rec_tier = gru_cuda._device_bwd_plan(device, B, H, D, bf16).tier
        if rec_tier == "registers":
            # the recurrence's tensor tier at this batch, against the same twin
            plan = gru_cuda.bwd_plan(B, H, D, gru_cuda.max_clusters(device, H, "bwd", bf16,
                                                                   "tensor"), "tensor")
            b_in = gru_cuda.kernel_biases(None if walk else b_ih, b_hh, H)[0]
            def run():
                return gru_cuda._recurrence_launch(walk, xp, w_hh, b_in, hp, ys, dys, plan)
            tdx, tgn = run()
            again = run()
            tc_rel = max(_rel(tdx.float(), want_dxp.float()), _rel(tgn.float(), want_gn.float()))
            same_tc = torch.equal(tdx, again[0]) and torch.equal(tgn, again[1])
            log(f"kernel bf16 recurrence's tensor tier, {'walk' if walk else 'model'} layout, "
                f"B={B} H={H} (its plan {plan.BT} rows a tile, {plan.tiles} tiles): dxp/gn "
                f"relative {tc_rel:.3e} (tol {BF16_TOL}); bitwise repeatable {same_tc}")
            if not (tc_rel <= BF16_TOL and same_tc):
                raise AssertionError(f"the recurrence's tensor tier disagrees with its twin at "
                                     f"B {B} H {H}: {tc_rel}, repeatable {same_tc}")
            errs[f"gru_bwd{suffix}_bf16"] = max(errs[f"gru_bwd{suffix}_bf16"],
                                                (tdx.float() - want_dxp.float()).abs().max().item())
        if not walk and tier == "registers":
            # the tensor tier at this batch, against the same twin
            plan = gru_cuda.fwd_plan(B, H, D, gru_cuda.max_clusters(device, H, "fwd", bf16,
                                                                   "tensor"), "tensor")
            tys, th, thp = gru_cuda._forward_launch(xp, w_hh, b_ih, b_hh, plan, True)
            tc_err = max((tys.float() - want_ys.float()).abs().max().item(),
                         (th.float() - want_h.float()).abs().max().item(), _rel(thp, want_hp))
            again = gru_cuda._forward_launch(xp, w_hh, b_ih, b_hh, plan, False)[0]
            log(f"kernel bf16 forward's tensor tier at B={B} H={H} (its plan {plan.BT} rows "
                f"a tile): ys/h_last/hp error {tc_err:.3e} (tol {BF16_TOL}); bitwise "
                f"repeatable {torch.equal(tys, again)}")
            if not (tc_err <= BF16_TOL and torch.equal(tys, again)):
                raise AssertionError(f"the tensor tier disagrees with its twin at B {B}")
            errs["gru_fwd_bf16"] = max(errs["gru_fwd_bf16"], tc_err)
        log(f"kernel bf16 {'walk' if walk else 'model'} layout T={T} B={B} cin={cin} H={H} "
            f"D={D} (forward tier {tier}, recurrence tier {rec_tier}, dW tensor cores): "
            f"forward ys/h_last "
            f"max_abs_err={fwd_err:.3e}, hp relative {hp_rel:.3e} "
            f"(tol {BF16_TOL}); recurrence dxp/gn relative {bwd_rel:.3e} (tol {BF16_TOL}); "
            f"dW_hh/db_hh relative {dw_rel:.3e} (tol {BWD_TOL}); bitwise repeatable {same}; "
            f"bf16 against float32 ys {f32_err:.3e} (tol {BF16_VS_F32}); dtypes ys "
            f"{ys.dtype}, hp {hp.dtype}, dxp {dxp.dtype}, dW {dw.dtype}")
        if not (fwd_err <= BF16_TOL and hp_rel <= BF16_TOL and bwd_rel <= BF16_TOL
                and dw_rel <= BWD_TOL and same and f32_err <= BF16_VS_F32):
            raise AssertionError(f"a bf16 GRU kernel disagrees with its twin: {fwd_err}, "
                                 f"{hp_rel}, {bwd_rel}, {dw_rel}, {same}, {f32_err}")
        errs[f"gru_fwd{suffix}_bf16"] = max(errs[f"gru_fwd{suffix}_bf16"], fwd_err)
        errs[f"gru_bwd{suffix}_bf16"] = max(errs[f"gru_bwd{suffix}_bf16"],
                                            (dxp.float() - want_dxp.float()).abs().max().item())
        errs[f"gru_dw{suffix}_bf16"] = max(errs[f"gru_dw{suffix}_bf16"],
                                           (dw - want_dw).abs().max().item(),
                                           (db - want_db).abs().max().item())
    return errs


def _rel(got, want) -> float:
    """Largest difference over the largest value of `want`."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def bwd_kernel_phase(device) -> dict:
    """The GRU backward kernels against the plain backward at the training
    shapes (T 34, both directions; the generator's H 300 with layer inputs
    of 88 and 600 features, the discriminator's H 64 with 8 and 128; the
    L2 tier's hidden sizes past 320), each twice for the same bits, and the
    autograd Function against autograd through the plain forward."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    errs = {"gru_bwd": 0.0, "gru_dw": 0.0}
    T, D = 34, 2
    cases = [(H, B, cin) for H, cins in ((300, (88, 600)), (64, (8, 128)))
             for B in (1, 5, 512) for cin in cins]
    cases += [(H, B, 64) for H in L2_HIDDEN for B in (5, 512)]
    for H, B, cin in cases:
        xp, w_hh, b_ih, b_hh = gru_inputs(T, B, cin, H, D, seed=B + H + cin,
                                          device=device)
        g = torch.Generator().manual_seed(B * H + cin)
        dys = torch.randn(T, B, D * H, generator=g).to(device)
        ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
        dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
        rec_again = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
        want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(
            xp, w_hh, b_ih, b_hh, ys, dys)
        err = max((dxp - want_dxp).abs().max().item(),
                  (gn - want_gn).abs().max().item())
        # the reduction kernel alone, on the plain recurrence's output
        dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
        want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
        rel = max(_rel(dw, want_dw), _rel(db, want_db))
        again = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
        same = (torch.equal(dw, again[0]) and torch.equal(db, again[1])
                and torch.equal(dxp, rec_again[0]) and torch.equal(gn, rec_again[1]))
        log(f"kernel gru_bwd T={T} B={B} cin={cin} H={H} D={D}: dxp "
            f"max_abs_err={err:.3e} (tol {BWD_TOL}); gru_dw dW_hh/db_hh "
            f"max_abs_err={(dw - want_dw).abs().max().item():.3e}, "
            f"relative to the largest {rel:.3e} (tol {BWD_TOL}); "
            f"recurrence and dW bitwise repeatable {same}; plan "
            f"{gru_cuda._device_bwd_plan(device, B, H, D)._asdict()}")
        if not (err <= BWD_TOL and rel <= BWD_TOL and same):
            raise AssertionError(f"gru_bwd/gru_dw disagree with the plain "
                                 f"backward: {err}, {rel}, repeatable {same}")
        errs["gru_bwd"] = max(errs["gru_bwd"], err)
        errs["gru_dw"] = max(errs["gru_dw"],
                             (dw - want_dw).abs().max().item(),
                             (db - want_db).abs().max().item())
    for H, cin in ((300, 600), (64, 128)):
        for B in (5, 512):
            args = gru_inputs(T, B, cin, H, D, seed=7 * B + H, device=device)
            g = torch.Generator().manual_seed(H + B)
            dys = torch.randn(T, B, D * H, generator=g).to(device)
            dh = torch.randn(D, B, H, generator=g).to(device)
            grads = []
            for layer in (gru_cuda.GRULayerFunction.apply, gru_cuda.gru_layer_plain):
                leaves = [t.clone().requires_grad_() for t in args]
                ys, h_last = layer(*leaves)
                grads.append(torch.autograd.grad(
                    (ys * dys).sum() + (h_last * dh).sum(), leaves))
            (got_x, *got_w), (want_x, *want_w) = grads
            err = (got_x - want_x).abs().max().item()
            rel = max(_rel(a, b) for a, b in zip(got_w, want_w))
            log(f"GRULayerFunction vs autograd of the plain forward, B={B} H={H} "
                f"cin={cin}: dxp max_abs_err={err:.3e}, dW_hh/db_ih/db_hh relative "
                f"to each largest {rel:.3e} (tol {BWD_TOL})")
            if not (err <= BWD_TOL and rel <= BWD_TOL):
                raise AssertionError(f"GRULayerFunction disagrees with autograd: "
                                     f"{err}, {rel}")
    return errs


def v1_inputs(T, B, cin, H, D, seed, device):
    """`run_layer`'s inputs made from `gru_inputs`' model-layout ones: xp
    with b_ih added and direction 1 time-reversed (the walk layout), w_hh,
    b_hh; and the model layout's (xp, b_ih) beside them."""
    from speech2affective_gestures_torch.ops import gru_cuda

    xp, w_hh, b_ih, b_hh = gru_inputs(T, B, cin, H, D, seed, device)
    walk = gru_cuda._walk(xp.view(T, B, D, 3 * H) + b_ih, D).contiguous()
    return walk, w_hh, b_hh, (xp, b_ih)


def v1_kernel_phase(device) -> dict:
    """The walk-layout (`run_layer`) kernels against their plain versions
    at the generator's training shape (T 34, B 512, H 300, D 2, layer input
    600; the forward also at B 1), `run_layer` under autograd against
    autograd through the plain loop, and the same inputs in the model
    layout through `gru_layer`: the same function, so the same outputs and
    gradients."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    errs = {"gru_fwd_v1": 0.0, "gru_bwd_v1": 0.0, "gru_dw_v1": 0.0}
    T, H, D = 34, 300, 2
    before = [_counters()[k] for k in errs]
    for B in (1, 512):
        xw, w_hh, b_hh, (xp, b_ih) = v1_inputs(T, B, 600, H, D, seed=31 + B, device=device)
        ys, hp = gru_cuda.run_layer_forward(xw, w_hh, b_hh, save_hp=True)
        want = gru_cuda.run_layer_plain(xw, w_hh, b_hh)[0]
        err = (ys - want).abs().max().item()
        model_ys = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0]
        same = (gru_cuda._unwalk(ys) - model_ys).abs().max().item()
        log(f"kernel gru_fwd_v1 T={T} B={B} H={H} D={D}: max_abs_err={err:.3e} against "
            f"run_layer_plain, {same:.3e} against gru_fwd on the model layout (tol {GRU_TOL})")
        if not (err <= GRU_TOL and same <= GRU_TOL):
            raise AssertionError(f"gru_fwd_v1 disagrees: {err}, {same}")
        errs["gru_fwd_v1"] = max(errs["gru_fwd_v1"], err)
        if B == 1:
            continue
        g = torch.Generator().manual_seed(B + H)
        dys = torch.randn(T, D, B, H, generator=g).to(device)
        dh = torch.randn(D, B, H, generator=g).to(device)
        dxp, gn = gru_cuda.run_layer_bwd_recurrence(xw, w_hh, b_hh, ys, dys, hp)
        want_dxp, want_gn = gru_cuda.run_layer_bwd_recurrence_plain(xw, w_hh, b_hh, ys, dys)
        err = max((dxp - want_dxp).abs().max().item(), (gn - want_gn).abs().max().item())
        dw, db = gru_cuda.run_layer_dw(want, want_dxp, want_gn)
        want_dw, want_db = gru_cuda.run_layer_dw_plain(want, want_dxp, want_gn)
        rel = max(_rel(dw, want_dw), _rel(db, want_db))
        # run_layer's autograd, its plain loop's, and the model layout's
        grads = []
        for layer in (gru_cuda.run_layer, gru_cuda.run_layer_plain):
            leaves = [t.clone().requires_grad_() for t in (xw, w_hh, b_hh)]
            y1, h1 = layer(*leaves)
            grads.append(torch.autograd.grad((y1 * dys).sum() + (h1 * dh).sum(), leaves))
        leaves = [t.clone().requires_grad_() for t in (xp, w_hh, b_ih, b_hh)]
        y2, h2 = gru_cuda.gru_layer(*leaves)
        g2 = torch.autograd.grad((y2 * gru_cuda._unwalk(dys)).sum() + (h2 * dh).sum(), leaves)
        (got_x, got_w, got_b), (want_x, want_w, want_b) = grads
        fn_err = (got_x - want_x).abs().max().item()
        fn_rel = max(_rel(got_w, want_w), _rel(got_b, want_b))
        # the model layout's dxp is run_layer's, laid out; dW_hh and db_hh
        # are the same tensors
        model_err = (gru_cuda._unwalk(got_x) - g2[0]).abs().max().item()
        model_rel = max(_rel(got_w, g2[1]), _rel(got_b, g2[3]))
        log(f"kernel gru_bwd_v1 T={T} B={B} H={H} D={D}: dxp/gn max_abs_err={err:.3e}; "
            f"gru_dw_v1 dW_hh/db_hh relative to the largest {rel:.3e}; run_layer's "
            f"autograd against the plain loop's: dxp {fn_err:.3e}, dW_hh/db_hh {fn_rel:.3e}; "
            f"against gru_layer on the model layout: dxp {model_err:.3e}, dW_hh/db_hh "
            f"{model_rel:.3e} (tol {BWD_TOL})")
        if not all(e <= BWD_TOL for e in (err, rel, fn_err, fn_rel, model_err, model_rel)):
            raise AssertionError(f"the v1 backward disagrees: {err}, {rel}, {fn_err}, "
                                 f"{fn_rel}, {model_err}, {model_rel}")
        errs["gru_bwd_v1"] = max(errs["gru_bwd_v1"], err)
        errs["gru_dw_v1"] = max(errs["gru_dw_v1"], (dw - want_dw).abs().max().item(),
                                (db - want_db).abs().max().item())
    after = [_counters()[k] for k in errs]
    if not all(a > b for a, b in zip(after, before)):
        raise AssertionError(f"the v1 launch counters did not rise: {before} -> {after}")
    return errs


def v1_path_phase(device, dtype_name: str = "float32") -> dict:
    """`gru_cuda.run_layer`, the v1 layer's public entry (a drop-in for one
    layer of the scan engine), at the generator's training shape in
    float32 or bf16 (`dtype_name`): the layer's input projection with b_ih,
    direction 1 time-reversed, the layer, a loss on ys and h_last, and the
    backward to the input and every weight. The counters are set to 0 just
    before and read just after: the three kernels of that dtype must have
    run."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    dtype = getattr(torch, dtype_name)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    T, B, cin, H, D = 34, 512, 600, 300, 2
    g = torch.Generator().manual_seed(41)
    bound = H ** -0.5
    x = torch.randn(T, B, cin, generator=g).to(device, dtype).requires_grad_()
    w_ih, w_hh, b_ih, b_hh = (
        torch.empty(shape).uniform_(-bound, bound, generator=g).to(device, dtype)
        .requires_grad_()
        for shape in ((D, 3 * H, cin), (D, H, 3 * H), (D, 3 * H), (D, 3 * H)))
    _reset_counters()
    xp = torch.einsum("tbc,dkc->tdbk", x, w_ih) + b_ih[:, None, :]
    xp = torch.stack([xp[:, 0], xp[:, 1].flip(0)], dim=1).contiguous()
    ys, h_last = gru_cuda.run_layer(xp, w_hh, b_hh)
    (ys.float().square().mean() + h_last.float().sum()).backward()
    torch.cuda.synchronize()
    counts, tiers = _counters(), _tier_counters()
    launches = {k + suffix: counts[k + suffix] for k in ("gru_fwd_v1", "gru_bwd_v1",
                                                        "gru_dw_v1")}
    finite = all(bool(t.grad.isfinite().all()) and t.grad.dtype == dtype
                 for t in (x, w_ih, w_hh, b_ih, b_hh))
    # bf16: the forward's plan at this batch and dW take the tensor cores
    want_tiers = ((f"gru_fwd_v1_bf16/{gru_cuda.fwd_tier(B, H, dtype)}", "gru_dw_v1_bf16/tensor")
                  if suffix else ())
    log(f"v1 path (run_layer under autograd, {dtype_name}, T={T} B={B} H={H} D={D}): "
        f"launches {dict(counts)}, by tier {dict(tiers)}; every gradient finite and "
        f"{dtype_name} {finite}")
    if (not finite or min(launches.values()) < 1 or sum(counts.values()) != 3
            or any(tiers[k] < 1 for k in want_tiers)):
        raise AssertionError(f"run_layer did not run its kernels: {launches}, {dict(tiers)}, "
                             f"finite {finite}")
    return launches


def embedding_phase(device, work: pathlib.Path) -> pathlib.Path:
    """`train_embedding.main` on the card: the FGD embedding net trained on
    the synthetic corpus's pose windows for EMB_EPOCHS epochs at batch
    EMB_BATCH, every loss finite; returns the written `.pth.tar`. Then the
    embedding train step's p50 at that batch."""
    import torch
    from speech2affective_gestures_torch import train_embedding
    from speech2affective_gestures_torch.models.embedding_net import EmbeddingNet
    from speech2affective_gestures_torch.train.embedding_trainer import embedding_train_step

    out = work / "embedding_net.pth.tar"
    argv = ["--synthetic-data", "--epochs", str(EMB_EPOCHS), "--batch-size", str(EMB_BATCH),
            "--out", str(out)]
    log(f"embedding phase: train_embedding.main({' '.join(argv)})")
    t0 = time.perf_counter()
    result = train_embedding.main(argv)
    log(f"embedding losses per epoch {result['losses']}; "
        f"{time.perf_counter() - t0:.1f} s in all")
    if not (out.is_file() and np.isfinite(result["losses"]).all()):
        raise AssertionError(f"the embedding training failed: {result['losses']}")

    torch.manual_seed(0)
    net = EmbeddingNet().to(device)
    opt = torch.optim.Adam(net.parameters(), lr=5e-4)
    poses = (torch.randn(EMB_BATCH, 34, 27) * 0.3).to(device)
    for _ in range(3):
        embedding_train_step(net, opt, poses)
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embedding_train_step(net, opt, poses)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"embedding train step at batch {EMB_BATCH}: p50 {np.median(times):.3f} ms over "
        f"{len(times)} steps")
    return out


def clip_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)
    return (0.3 * env * np.sin(2 * np.pi * (140 + 40 * np.sin(2 * t)) * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def post(server, path, payload):
    conn = http.client.HTTPConnection(*server.server_address, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path} answered {resp.status}: {data}")
    return data


def get(server, path):
    conn = http.client.HTTPConnection(*server.server_address, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path} answered {resp.status}: {data}")
    return data


def unb64(blob, shape):
    return np.frombuffer(base64.b64decode(blob), "<f4").reshape(shape)


def service_phase(device):
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.vocab import placeholder_vocab
    from speech2affective_gestures_torch.models.generator import build_generator
    from speech2affective_gestures_torch.train import synthesis

    cfg = ModelConfig.from_yaml(CONFIG)
    vocab = placeholder_vocab(1000)
    gen = build_generator(cfg, vocab.n_words, 100, device=device, seed=0)
    log(f"generator: hidden {cfg.hidden_size_s2eg}, {cfg.n_layers} GRU layers, "
        f"embed {cfg.wordembed_dim}, {sum(p.numel() for p in gen.parameters())} "
        "parameters")
    words = [[f"<w{5 + i}>", 0.4 + 0.9 * i, 0.8 + 0.9 * i] for i in range(12)]
    single = clip_audio(10.0, 1)
    batch = [{"audio_b64": serve.encode_f32_b64(clip_audio(s, 10 + i)),
              "words": [w for w in words if w[2] < s], "vid_idx": 7 * i,
              "binary": True}
             for i, s in enumerate((3.0, 6.0, 9.0, 12.0))]

    service = serve.SynthesisService(cfg, gen, vocab, seed=0)
    service.warmup()
    server = serve.serve(service, port=0)
    try:
        _reset_counters()
        one = post(server, "/synthesize", {
            "audio_b64": serve.encode_f32_b64(single), "words": words,
            "vid_idx": 3, "binary": True})
        after_one = {k: _counters()[k] for k in ("gru_fwd", "mel_power")}
        many = post(server, "/synthesize_batch", {"requests": batch,
                                                  "binary": True})
        launches = {k: _counters()[k] for k in ("gru_fwd", "mel_power")}
    finally:
        server.shutdown()
        server.server_close()
    after_many = {k: launches[k] - after_one[k] for k in launches}
    log(f"service launches: /synthesize {after_one}, /synthesize_batch "
        f"{after_many}, total {launches}")
    for name in launches:
        if after_one[name] < 1 or after_many[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path: "
                                 f"{after_one[name]} in /synthesize, "
                                 f"{after_many[name]} in /synthesize_batch")

    gpu = [unb64(one["dir_vec_b64"], one["dir_vec_shape"])]
    gpu += [unb64(r["dir_vec_b64"], r["dir_vec_shape"]) for r in many["results"]]
    gpu_poses = [unb64(one["poses_b64"], one["poses_shape"])]
    gpu_poses += [unb64(r["poses_b64"], r["poses_shape"]) for r in many["results"]]
    audios = [single] + [np.frombuffer(base64.b64decode(r["audio_b64"]), "<f4")
                         for r in batch]
    for dv, ps, a in zip(gpu, gpu_poses, audios):
        n_win = len(synthesis.plan_subdivisions(len(a) / 16000, cfg)[0])
        frames = (n_win - 1) * (cfg.n_poses - cfg.n_pre_poses) + cfg.n_poses
        if dv.shape != (frames, 27) or ps.shape != (frames, 10, 3):
            raise AssertionError(f"bad output shapes {dv.shape} {ps.shape}, "
                                 f"expected {frames} frames")
        if not (np.isfinite(dv).all() and np.isfinite(ps).all()):
            raise AssertionError("non-finite output")
    log(f"service outputs: frames {[len(d) for d in gpu]}, all finite")

    # the same requests, same weights and same noise on the CPU plain path
    cpu_service = serve.SynthesisService(cfg, copy.deepcopy(gen).cpu(), vocab, seed=0)
    cpu_service.warmup()
    cpu_one = cpu_service.synthesize(single, words, vid_idx=3)
    cpu_many = cpu_service.synthesize_batch(batch)
    cpu = [cpu_one["dir_vec"]] + [r["dir_vec"] for r in cpu_many]
    cpu_poses = [cpu_one["poses"]] + [r["poses"] for r in cpu_many]
    err = max(max(np.abs(g - c).max() for g, c in zip(gpu, cpu)),
              max(np.abs(g - c).max() for g, c in zip(gpu_poses, cpu_poses)))
    log(f"service card vs CPU plain path: max_abs_err={err:.3e} (tol {SERVE_TOL})")
    if not err <= SERVE_TOL:
        raise AssertionError(f"card output disagrees with the CPU path: {err}")

    # request latency on the card, the service called directly
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        service.synthesize(single, words, vid_idx=3)
        times.append((time.perf_counter() - t0) * 1e3)
    btimes = []
    for _ in range(5):
        t0 = time.perf_counter()
        service.synthesize_batch(batch)
        btimes.append((time.perf_counter() - t0) * 1e3)
    log(f"synthesize 10 s clip (5 windows, bucket 8): p50 {np.median(times):.3f} ms "
        f"over {len(times)} requests; all {[round(t, 3) for t in times]}")
    log(f"synthesize_batch 4 clips 3-12 s (bucket 8): p50 {np.median(btimes):.3f} ms "
        f"over {len(btimes)} requests")
    log(f"service phases (mean ms): {service.metrics()}")
    profile_requests(service, single, words)
    return launches


def profile_requests(service, audio, words, n: int = 3) -> None:
    """Where a /synthesize request's time goes on the card."""
    profile_device("/synthesize (10 s clip)", "request",
                   lambda: service.synthesize(audio, words, vid_idx=3), n)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def busy_us(spans) -> float:
    """The time in which at least one of the (start, end) spans ran: their
    union, so that kernels running at once on several streams (as cuDNN's
    two GRU directions do) count once, and gaps between them not at all."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _profile(fn, n: int):
    """torch.profiler over n calls of fn; returns the device events' key
    averages, the device's busy ms per call (`busy_us` of its kernels and
    copies) and the wall ms per call (the profiler's own cost inside), or
    None when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a profiling session now and then returns no device events at all
    # (on the H100 machines, in three of four runs of ~50 sessions, at a
    # different call each time); it is taken again, twice at most, and the
    # time is then reported as not measured
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if spans:
            break
    else:
        return None
    return ([e for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA],
            busy_us(spans) / 1e3 / n, wall_ms)


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of fn from torch.profiler over n calls after a
    warm-up: the time in which any of its kernels (or copies) ran. Unlike
    `time_ms` it leaves out the host's launch cost and any gap between
    launches; kernels that overlap count once. NaN, logged as not
    measured, when the profiler recorded no device activity (the CUDA-event
    time beside it stands)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    got = _profile(fn, n)
    if got is None:
        log("  device time not measured: torch.profiler recorded no device activity")
        return float("nan")
    return got[1]


def profile_device(label: str, unit: str, fn, n: int = 3):
    """Device time by kernel and the device's busy share of the wall time,
    from torch.profiler over `n` calls of fn (the profiler's own cost is
    inside the wall time). Returns (kernel launches, busy ms, wall ms) per
    call and {kernel name: launches per call}, or None when not
    measured."""
    got = _profile(fn, n)
    if got is None:
        log(f"profile of {label}: not measured (torch.profiler recorded no device activity)")
        return None
    kernels, busy_ms, wall_ms = got
    n_launches = sum(e.count for e in kernels) / n
    log(f"profile of {label}: wall {wall_ms:.3f} ms/{unit} "
        f"under the profiler, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {n_launches:.0f} kernel launches/{unit}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        log(f"  {_device_us(e) / 1e3 / n:8.3f} ms {e.count / n:6.1f}x  {e.key[:90]}")
    return n_launches, busy_ms, wall_ms, {e.key: e.count / n for e in kernels}


def _counters() -> collections.Counter:
    """Each kernel instance's launches since the last reset, under its name
    in the kernels line: the GRU kernels' float32 instances by kernel
    ("gru_fwd", "gru_bwd_v1", ...), their bf16 instances with "_bf16"
    ("gru_fwd_bf16", ...); the mel kernel's FFT tier "mel_power" (at a
    power of two) and "mel_power_mixed" (its mixed-radix kernel), its DFT
    tier "mel_dft". Absent names read 0."""
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    out = collections.Counter()
    for (kernel, dtype), n in gru_cuda.launches.items():
        out[kernel + ("_bf16" if dtype == "bfloat16" else "")] += n
    out["mel_power"] += mel_cuda.fft_launches["power of two"]
    out["mel_power_mixed"] += mel_cuda.fft_launches["mixed radix"]
    out["mel_dft"] += mel_cuda.launches[("mel_dft", "float32")]
    return out


def _tier_counters() -> collections.Counter:
    """The GRU kernels' launches since the last reset by the tier that ran,
    under "<name in the kernels line>/<tier>": "gru_fwd_bf16/tensor" (the
    bf16 forward's tensor-core tier), "gru_fwd_bf16/registers",
    "gru_dw_bf16/tensor" (the bf16 dW product), "gru_dw/fma", ..."""
    from speech2affective_gestures_torch.ops import gru_cuda

    out = collections.Counter()
    for (kernel, dtype, tier), n in gru_cuda.tier_launches.items():
        out[f"{kernel}{'_bf16' if dtype == 'bfloat16' else ''}/{tier}"] += n
    return out


def _conv_dis_counters() -> collections.Counter:
    """The GRU kernels' launches since the last reset at the
    ConvDiscriminator's shape (T CONV_DIS_T, H 64), under their names in
    the kernels line: "gru_fwd_t28", "gru_bwd_t28_bf16", ..."""
    from speech2affective_gestures_torch.ops import gru_cuda

    out = collections.Counter()
    for (kernel, dtype, T, H), n in gru_cuda.shape_launches.items():
        if (T, H) == (CONV_DIS_T, 64) and not kernel.endswith("_v1"):
            out[f"{kernel}_t{T}{'_bf16' if dtype == 'bfloat16' else ''}"] += n
    return out


def _fused_batch_counters() -> collections.Counter:
    """The GRU kernels' launches since the last reset at the fused step's
    batch (B FUSED_B) and the generator's H 300, under their names in the
    kernels line: "gru_fwd_b1024", "gru_bwd_b1024_bf16", ..."""
    from speech2affective_gestures_torch.ops import gru_cuda

    out = collections.Counter()
    for (kernel, dtype, B, H, _), n in gru_cuda.batch_launches.items():
        if (B, H) == (FUSED_B, 300) and not kernel.endswith("_v1"):
            out[f"{kernel}_b{B}{'_bf16' if dtype == 'bfloat16' else ''}"] += n
    return out


def _rank_batch_counters(B: int) -> collections.Counter:
    """The GRU kernels' launches since the last reset at a data-parallel
    rank's batch B and the generator's H 300, under their names in the
    kernels line: "gru_fwd_b256", "gru_bwd_b128_bf16", ..."""
    from speech2affective_gestures_torch.ops import gru_cuda

    out = collections.Counter()
    for (kernel, dtype, b, H, _), n in gru_cuda.batch_launches.items():
        if (b, H) == (B, 300) and not kernel.endswith("_v1"):
            out[f"{kernel}_b{B}{'_bf16' if dtype == 'bfloat16' else ''}"] += n
    return out


def _reset_counters() -> None:
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    gru_cuda.launches.clear()
    gru_cuda.tier_launches.clear()
    gru_cuda.shape_launches.clear()
    gru_cuda.batch_launches.clear()
    mel_cuda.launches.clear()
    mel_cuda.fft_launches.clear()


def mel_path_phase(device) -> dict:
    """`ops.dsp.mel_power_spectrogram`, the port's mel entry point, on a
    30 s clip at WHISPER_MEL's settings (n_fft 400: the FFT tier's
    mixed-radix kernel) and on a 10 s clip at CD_MEL's (44.1 kHz, n_fft
    882: the DFT tier). For each, the counters are set to 0 just before and
    read just after: that kernel must have run, no other mel kernel. The
    output against the CPU plain path within MEL_RTOL of each value plus
    MEL_FLOOR of the largest."""
    import torch
    from speech2affective_gestures_torch.ops import dsp

    launches = collections.Counter()
    for settings, name, seed in ((WHISPER_MEL, "mel_power_mixed", 5), (CD_MEL, "mel_dft", 6)):
        kw = {k: v for k, v in settings.items() if k != "seconds"}
        kw.setdefault("sr", 16000)
        # the clip's samples at its rate (clip_audio makes 16 kHz ones)
        y = torch.from_numpy(clip_audio(settings["seconds"] * kw["sr"] / 16000, seed))
        _reset_counters()
        got = dsp.mel_power_spectrogram(y.to(device), **kw)
        torch.cuda.synchronize()
        counts = {k: n for k, n in _counters().items() if k.startswith("mel") and n}
        want = dsp.mel_power_spectrogram(y, **kw)
        ok = bool(((got.cpu() - want).abs()
                   <= MEL_RTOL * want.abs() + MEL_FLOOR * want.abs().max()).all())
        log(f"mel path (dsp.mel_power_spectrogram, {settings}): output {tuple(got.shape)}, "
            f"launches {counts}; against the CPU plain path max_abs_err="
            f"{(got.cpu() - want).abs().max().item():.3e} (max {want.abs().max().item():.3e}), "
            f"within tolerance {ok}")
        if not (ok and counts == {name: 1} and got.isfinite().all()):
            raise AssertionError(f"the mel entry point failed at {settings}: {counts}, {ok}")
        launches[name] += 1
    return launches


def _scaled_copy(model, factor: float):
    """A copy of `model` with every parameter times `factor`."""
    import torch

    model = copy.deepcopy(model)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(factor)
    return model


def bf16_service_phase(device) -> dict:
    """The service at `precision="bf16"` (`serve --serve-precision bf16`):
    the full-width generator of `service_phase` with its weights scaled by
    MP_SCALE behind the HTTP server. /healthz and /metrics report bf16; the
    counters are set to 0 just before a /synthesize of a 10 s clip and read
    just after: the GRU forward's bf16 instance and the mel kernel (the
    MFCC front-end stays float32) must have run, the forward's float32
    instance not. The output against the CPU bf16 path (same weights and
    noise) within MP_TOL of its largest value; its distance from the
    card's float32 service is logged. Then the p50 and p90 of /synthesize
    and its device profile."""
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.vocab import placeholder_vocab
    from speech2affective_gestures_torch.models.generator import build_generator
    from speech2affective_gestures_torch.ops import gru_cuda

    cfg = ModelConfig.from_yaml(CONFIG)
    vocab = placeholder_vocab(1000)
    gen = _scaled_copy(build_generator(cfg, vocab.n_words, 100, device=device, seed=0),
                       MP_SCALE)
    words = [[f"<w{5 + i}>", 0.4 + 0.9 * i, 0.8 + 0.9 * i] for i in range(12)]
    single = clip_audio(10.0, 1)
    service = serve.SynthesisService(cfg, gen, vocab, seed=0, precision="bf16")
    service.warmup()
    server = serve.serve(service, port=0)
    try:
        health = get(server, "/healthz")
        _reset_counters()
        one = post(server, "/synthesize", {
            "audio_b64": serve.encode_f32_b64(single), "words": words,
            "vid_idx": 3, "binary": True})
        counts, tiers = _counters(), _tier_counters()
        metrics = get(server, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
    launches = {k: counts[k] for k in ("gru_fwd_bf16", "mel_power")}
    # the generator runs a window at batch 1: the bf16 forward's plan there
    tier = f"gru_fwd_bf16/{gru_cuda.fwd_tier(1, cfg.hidden_size_s2eg, torch.bfloat16)}"
    log(f"bf16 service: /healthz {health}; /synthesize launches {dict(counts)}, by tier "
        f"{dict(tiers)} (the plan at batch 1: {tier}); /metrics precision "
        f"{metrics['synthesize']['precision']}")
    if (health["precision"] != "bf16" or metrics["synthesize"]["precision"] != "bf16"
            or min(launches.values()) < 1 or counts["gru_fwd"] != 0
            or tiers[tier] != counts["gru_fwd_bf16"]):
        raise AssertionError(f"the bf16 service did not run its bf16 kernels: "
                             f"{health}, {dict(counts)}")
    dv = unb64(one["dir_vec_b64"], one["dir_vec_shape"])
    ps = unb64(one["poses_b64"], one["poses_shape"])
    runs = {}
    for label, svc in (("CPU bf16", serve.SynthesisService(
            cfg, copy.deepcopy(gen).cpu(), vocab, seed=0, precision="bf16")),
            ("card float32", serve.SynthesisService(cfg, gen, vocab, seed=0))):
        svc.warmup()
        runs[label] = svc.synthesize(single, words, vid_idx=3)
    want = runs["CPU bf16"]
    err = max(_rel_np(dv, want["dir_vec"]), _rel_np(ps, want["poses"]))
    f32_dev = max(_rel_np(dv, runs["card float32"]["dir_vec"]),
                  _rel_np(ps, runs["card float32"]["poses"]))
    log(f"bf16 service card vs CPU bf16 path (weights x{MP_SCALE}): relative to the "
        f"largest value {err:.3e} (tol {MP_TOL}); card bf16 vs card float32 {f32_dev:.3e}")
    if not (np.isfinite(dv).all() and err <= MP_TOL):
        raise AssertionError(f"the bf16 service disagrees with the CPU bf16 path: {err}")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        service.synthesize(single, words, vid_idx=3)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"bf16 synthesize 10 s clip (5 windows, bucket 8): p50 {np.median(times):.3f} ms, "
        f"p90 {np.percentile(times, 90):.3f} ms over {len(times)} requests; all "
        f"{[round(t, 3) for t in times]}")
    profile_requests(service, single, words)
    return launches


def write_export_archive(path: pathlib.Path, splits: dict) -> None:
    """A raw-level export archive as the JAX package's
    `tools/export_ted_cache.py` writes it: `manifest.json` and one
    gzip'd pickle shard (protocol 4) per split (compression level 1: the
    reader does not care, and level 9 takes long on audio)."""
    import gzip
    import pickle

    path.mkdir(parents=True)
    manifest = {"level": "raw", "num_mfcc": 14, "splits": {}}
    for split, records in splits.items():
        with gzip.open(path / f"{split}_0000.pkl.gz", "wb", compresslevel=1) as f:
            pickle.dump(records, f, protocol=4)
        manifest["splits"][split] = {"shards": 1, "records": len(records)}
    (path / "manifest.json").write_text(json.dumps(manifest))


def real_data_phase(device, work: pathlib.Path, embedding_net: pathlib.Path):
    """`main_v2.main` on the TED formats' route at full width, batch 512:
    a raw-level export archive of REAL_VIDEOS synthetic videos of
    REAL_SECONDS in the raw TED schema, split REAL_SPLIT, read with
    `--packed-data`, REAL_EPOCHS epochs with the GAN terms on, gradient
    clipping at 0.1 and LR decay, then the test split scored with FGD.
    The counters are set to 0 just before `main_v2.main` and read, and set
    to 0 again, when the corpus is built (the mel kernel must have run,
    one launch per clip) and just before the scoring (the GRU forward,
    recurrence and dW kernels must have run in training); the port's npz
    caches must sit in the archive under their own names, every logged
    loss be finite, a checkpoint be written, and each optimizer's learning
    rate be base * 0.999 ** (n // steps per epoch) at its own update count
    n. Then `main_v2.main --train-s2ag false` again: it must read the
    caches, with no mel launch. Returns the launches, the argv that reads
    the archive and the config file."""
    import torch
    from speech2affective_gestures_torch import main_v2
    from speech2affective_gestures_torch.data import ted_db
    from speech2affective_gestures_torch.train import gan_step
    from speech2affective_gestures_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    videos = ted_db.make_synthetic_videos(REAL_VIDEOS, REAL_SECONDS, device=device)
    n_train, n_val, _ = REAL_SPLIT
    archive = work / "ted_archive"
    write_export_archive(archive, {"train": videos[:n_train],
                                   "val": videos[n_train:n_train + n_val],
                                   "test": videos[n_train + n_val:]})
    del videos
    log(f"real-data phase: wrote a raw export archive of {REAL_VIDEOS} videos of "
        f"{REAL_SECONDS} s (split {REAL_SPLIT}) in {time.perf_counter() - t0:.1f} s")
    cfg_path = work / "multimodal_context_v2_gan_on.yml"
    base = work / "base_real"
    reading = ["-b", str(base), "-c", str(cfg_path), "--packed-data", str(archive)]
    argv = reading + ["--batch-size", str(TRAIN_BATCH), "--s2ag-num-epoch", str(REAL_EPOCHS),
                      "--log-interval", "1", "--apply-gradient-clip", "true",
                      "--gradient-clip", "0.1", "--apply-lr-decay", "true",
                      "--embedding-net-checkpoint", str(embedding_net)]
    log(f"real-data phase: main_v2.main({' '.join(argv)})")
    counts = {}
    load, scoring = main_v2.load_datasets, Trainer.generate_gestures

    def counted_load(*args, **kwargs):
        t = time.perf_counter()
        splits = load(*args, **kwargs)
        torch.cuda.synchronize()
        counts["build_s"] = time.perf_counter() - t
        counts["windows"] = sum(ds.n_samples for ds in splits if ds is not None)
        counts["corpus"] = _counters()
        _reset_counters()
        return splits

    def counted_scoring(self, *args, **kwargs):
        torch.cuda.synchronize()
        counts["training"] = _counters()
        _reset_counters()
        result = scoring(self, *args, **kwargs)
        torch.cuda.synchronize()
        counts["evaluation"] = _counters()
        return result

    main_v2.load_datasets, Trainer.generate_gestures = counted_load, counted_scoring
    try:
        _reset_counters()
        trainer = main_v2.main(argv)
    finally:
        main_v2.load_datasets, Trainer.generate_gestures = load, scoring
    corpus, trained, evaluated = counts["corpus"], counts["training"], counts["evaluation"]
    log(f"corpus build from the archive (the MFCCs on the card): {counts['build_s']:.3f} s, "
        f"{counts['windows']} windows, {counts['windows'] / counts['build_s']:.1f} windows/s; "
        f"launches {dict(corpus)}")
    log(f"real-data training launches {dict(trained)}; test-split scoring launches "
        f"{dict(evaluated)}")
    if corpus["mel_power"] < REAL_VIDEOS or any(
            n for k, n in corpus.items() if k.startswith("gru")):
        raise AssertionError(f"the corpus build did not run the mel kernel alone: {corpus}")
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        if trained[name] < 1:
            raise AssertionError(f"kernel {name} was not launched in real-data training")
    if evaluated["gru_fwd"] < 1:
        raise AssertionError(f"generate_gestures did not run the GRU forward: {evaluated}")
    caches = sorted(p.name for p in archive.glob("*_s2ag_torch_*"))
    log(f"the port's caches in the archive: {caches}")
    if len([c for c in caches if c.endswith("_packed_mfcc_14.npz")]) != 3:
        raise AssertionError(f"the packed splits were not cached: {caches}")

    work_dir = base / "models" / "s2ag_v2_mfcc_torch" / "ted_db"
    log_txt = (work_dir / "log.txt").read_text()
    steps = [line.split("Done. | ")[1] for line in log_txt.splitlines() if "Done. | " in line]
    values = [dict((k, float(v)) for k, v in (tok.split(": ") for tok in it.split(" | ")))
              for it in steps]
    for i, metrics in enumerate(values):
        log(f"real-data train step {i} losses: {metrics}")
    if not values or not all("dis" in m and "gen" in m for m in values):
        raise AssertionError(f"expected steps with the GAN terms, got {steps}")
    if not all(np.isfinite(list(m.values())).all() for m in values):
        raise AssertionError("non-finite training loss")
    if not list(work_dir.glob("*.pth.tar")):
        raise AssertionError("main_v2 wrote no checkpoint")
    [line] = [x for x in log_txt.splitlines() if "eval: " in x]
    if "FGD" not in line:
        raise AssertionError(f"no FGD in the test-split scores: {line}")
    log(f"real-data {line.split('] ')[1]}")
    cfg = trainer.step.cfg
    rates = {}
    for who, opt, base_lr in (("gen", trainer.step.gen_opt, cfg.learning_rate),
                              ("dis", trainer.step.dis_opt, cfg.lr_dis)):
        n = gan_step.update_count(opt)
        want = base_lr * 0.999 ** (n // cfg.decay_steps_per_epoch)
        rates[who] = (n, opt.param_groups[0]["lr"], want)
        if opt.param_groups[0]["lr"] != want or n < 1:
            raise AssertionError(f"{who}'s learning rate after {n} updates is "
                                 f"{opt.param_groups[0]['lr']}, not {want}")
    log(f"learning rates after training (updates, lr, base * 0.999 ** (n // "
        f"{cfg.decay_steps_per_epoch})): {rates}; gradient clip {cfg.gradient_clip}, "
        f"last global norms {({k: float(v) for k, v in trainer.step.grad_norms.items()})}")
    del trainer

    _reset_counters()
    t0 = time.perf_counter()
    again = main_v2.main(reading + ["--train-s2ag", "false", "--embedding-net-checkpoint",
                                    str(embedding_net)])
    torch.cuda.synchronize()
    reread = _counters()
    log(f"main_v2 --train-s2ag false from the caches: {time.perf_counter() - t0:.1f} s, "
        f"launches {dict(reread)}")
    if reread["mel_power"] or reread["mel_power_mixed"] or reread["mel_dft"]:
        raise AssertionError(f"the second run rebuilt the corpus: {dict(reread)}")
    if again.train_data is not None or again.test_data.n_samples < 1:
        raise AssertionError("the second run did not read the test split alone")
    del again
    return corpus + trained + evaluated + reread, reading


def trained_service_phase(device, reading: list):
    """`serve.build_service` on the real-data phase's archive and work dir:
    it must load the best checkpoint (the generator's weights equal the
    file's) and serve with the corpus's vocabulary. The counters are set
    to 0 just before a POST /synthesize of a 10 s clip whose words come
    from that vocabulary (none may map to <UNK>) and read just after: the
    GRU forward and the mel kernel must have run. The output against a CPU
    service built from the same checkpoint, its request of the same number
    (so the same noise), within SERVE_TOL; the p50 and p90 of 20 such
    requests; `build_service` on an empty work dir must raise SystemExit.
    Returns the service, the clip, its words and the launches."""
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.convert import from_jax
    from speech2affective_gestures_torch.data.vocab import Vocab
    from speech2affective_gestures_torch.train import synthesis
    from speech2affective_gestures_torch.train.trainer import find_checkpoint

    t0 = time.perf_counter()
    service = serve.build_service(reading)
    log(f"trained service: build_service({' '.join(reading)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    work_dir = pathlib.Path(reading[1]) / "models" / "s2ag_v2_mfcc_torch" / "ted_db"
    best = work_dir / find_checkpoint(str(work_dir), "best")[0]
    want = from_jax.reference_state_dict(str(best))
    got = service.gen.state_dict()
    if set(got) != set(want) or not all(torch.equal(got[k].cpu(), want[k]) for k in want):
        raise AssertionError(f"build_service did not serve {best.name}")
    vocab = service.lang
    corpus_words = [w for w in vocab.word2index if not w.startswith("<")]
    words = [[corpus_words[i % len(corpus_words)], 0.3 + 0.7 * i, 0.6 + 0.7 * i]
             for i in range(13)]
    audio = clip_audio(10.0, 21)
    _, text, _ = synthesis.prepare_window_inputs(audio, words, vocab, service.cfg)
    ids = set(text[text != 0].tolist())
    log(f"served {best.name}: {vocab.n_words} words in the vocabulary, "
        f"{service.gen.speaker_embedding[0].weight.shape[0]} speakers; the request's "
        f"word ids {sorted(ids)}")
    if Vocab.UNK_token in ids or ids != {vocab.word2index[w] for w, _, _ in words}:
        raise AssertionError(f"the request's words did not get their dataset ids: {ids}")
    request = {"audio_b64": serve.encode_f32_b64(audio), "words": words, "vid_idx": 1,
               "binary": True}
    service.warmup()
    server = serve.serve(service, port=0)
    try:
        _reset_counters()
        one = post(server, "/synthesize", request)
        launches = {k: _counters()[k] for k in ("gru_fwd", "mel_power")}
        service.reset_metrics()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            post(server, "/synthesize", request)
            times.append((time.perf_counter() - t0) * 1e3)
        metrics = get(server, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
    log(f"trained service /synthesize launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the trained service did not run its kernels: {launches}")
    dv = unb64(one["dir_vec_b64"], one["dir_vec_shape"])
    ps = unb64(one["poses_b64"], one["poses_shape"])
    # the CPU service's second request, after its warmup, draws the same
    # noise as the card's first POST after its own
    cpu_service = serve.build_service(reading + ["--device", "cpu"])
    cpu_service.warmup()
    cpu = cpu_service.synthesize(audio, words, vid_idx=1)
    err = max(np.abs(dv - cpu["dir_vec"]).max(), np.abs(ps - cpu["poses"]).max())
    log(f"trained service card vs CPU service from the same checkpoint: max_abs_err "
        f"{err:.3e} (tol {SERVE_TOL})")
    if not (np.isfinite(dv).all() and err <= SERVE_TOL):
        raise AssertionError(f"the trained service disagrees with the CPU path: {err}")
    log(f"trained service /synthesize 10 s clip over HTTP: p50 {np.median(times):.3f} ms, "
        f"p90 {np.percentile(times, 90):.3f} ms over {len(times)} requests; all "
        f"{[round(t, 3) for t in times]}; the server's phases {metrics}")
    empty = ["-b", str(pathlib.Path(reading[1]).parent / "empty_base")] + reading[2:]
    try:
        serve.build_service(empty)
    except SystemExit as e:
        log(f"build_service on an empty work dir: SystemExit({e})")
    else:
        raise AssertionError("build_service served random weights from an empty work dir")
    return service, audio, words, launches


def stream_phase(service, audio, words) -> dict:
    """The trained service's live stream: /stream/start with seed 5,
    `trained_service_phase`'s 10 s clip in 0.5 s chunks through
    /stream/feed (binary), then /stream/flush. The counters are set to 0
    just before /stream/start and read just after the flush: the GRU
    forward and the mel kernel must have run; the frames together must
    equal the service's clip for the same audio, words and speaker, its
    noise one draw from seed 5, within SERVE_TOL. Then the p50 and p90 of
    the feed calls that emitted frames."""
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.train import synthesis

    server = serve.serve(service, port=0)
    try:
        _reset_counters()
        sid = post(server, "/stream/start", {"vid_idx": 1, "seed": 5})["stream_id"]
        frames, emitting, idle = [], [], []
        chunk = 8000
        for i in range(0, len(audio), chunk):
            t0 = time.perf_counter()
            out = post(server, "/stream/feed", {
                "stream_id": sid, "audio_b64": serve.encode_f32_b64(audio[i:i + chunk]),
                "words": words if i == 0 else [], "binary": True})
            ms = (time.perf_counter() - t0) * 1e3
            (emitting if out["frames"] else idle).append(ms)
            frames.append(unb64(out["dir_vec_b64"], out["dir_vec_shape"]))
        active = get(server, "/metrics")["active_streams"]
        out = post(server, "/stream/flush", {"stream_id": sid, "binary": True})
        frames.append(unb64(out["dir_vec_b64"], out["dir_vec_shape"]))
        launches = {k: _counters()[k] for k in ("gru_fwd", "mel_power")}
    finally:
        server.shutdown()
        server.server_close()
    n_win = len(synthesis.plan_subdivisions(len(audio) / 16000, service.cfg)[0])
    eps = torch.randn(n_win, service.gen.z_size, generator=torch.Generator().manual_seed(5))
    offline = service.synthesize(audio, words, vid_idx=1, eps=eps[:, None])["dir_vec"]
    got = np.concatenate(frames)
    err = (np.abs(got - offline).max() if got.shape == offline.shape else np.inf)
    log(f"stream of the 10 s clip in 0.5 s chunks: {len(frames) - 1} feeds "
        f"({len(emitting)} emitted frames), frames per call {[len(f) for f in frames]}, "
        f"active streams while open {active}; launches {launches}; against the service's clip "
        f"max_abs_err {err:.3e} (tol {SERVE_TOL})")
    if min(launches.values()) < 1 or active != 1:
        raise AssertionError(f"the stream did not run its kernels: {launches}, {active}")
    if not err <= SERVE_TOL:
        raise AssertionError(f"the stream disagrees with the service's clip: {err}")
    log(f"stream feeds that emitted frames: p50 {np.median(emitting):.3f} ms, p90 "
        f"{np.percentile(emitting, 90):.3f} ms over {len(emitting)} calls "
        f"(the others: p50 {np.median(idle):.3f} ms); all {[round(t, 3) for t in emitting]}")
    return launches


def write_genea_dir(root: pathlib.Path) -> None:
    """A GENEA 2020 layout of one clip (the JAX package's GENEA test's
    recipe): a 31-joint chain of unit offsets rotating about z written by
    the port's `save_as_bvh` (8 s at 30 fps), an 8 s wav at 16 kHz and a
    JSON transcript in Google's speech-to-text shape."""
    from scipy.io import wavfile
    from speech2affective_gestures_torch.render import bvh

    for sub in ("audio", "bvh_raw", "transcripts"):
        (root / sub).mkdir(parents=True)
    n_joints, n_frames = GENEA_JOINTS, int(GENEA_SECONDS * 30)
    offsets = np.zeros((n_joints, 3), np.float32)
    offsets[1:, 1] = 1.0
    angles = 0.15 * np.sin(np.linspace(0, 6 * np.pi, n_frames)[:, None]
                           + np.linspace(0, 2, n_joints)[None, :])
    quats = np.zeros((n_frames, n_joints, 4), np.float32)
    quats[..., 0], quats[..., 3] = np.cos(angles / 2), np.sin(angles / 2)
    positions = np.zeros((n_frames, n_joints, 3), np.float32)
    positions[:, 0, 1] = 10.0
    out = bvh.save_as_bvh({"joint_names": [f"j{k}" for k in range(n_joints)],
                           "joint_offsets": offsets,
                           "joint_parents": [-1] + list(range(n_joints - 1)),
                           "positions": positions, "rotations": quats},
                          str(root / "tmp_bvh"), frame_time=1.0 / 30)
    pathlib.Path(out).replace(root / "bvh_raw" / "clip0.bvh")
    wavfile.write(root / "audio" / "clip0.wav", 16000,
                  (clip_audio(GENEA_SECONDS, 31) * 32767).astype(np.int16))
    words = [{"word": w, "start_time": f"{0.4 + 0.9 * i:.1f}s",
              "end_time": f"{0.8 + 0.9 * i:.1f}s"}
             for i, w in enumerate(("so", "we", "went", "there", "and", "then", "left"))]
    (root / "transcripts" / "clip0.json").write_text(
        json.dumps([{"alternatives": [{"words": words}]}]))


def _max_err(got, want) -> float:
    """The largest difference of two renders' poses (resampled, TriModal,
    s2ag per clip), inf when their clips or shapes differ."""
    if [v for v, _ in got] != [v for v, _ in want]:
        return float("inf")
    errs = [np.abs(a - b).max() if a.shape == b.shape else np.inf
            for (_, g), (_, w) in zip(got, want) for a, b in zip(g, w)]
    return float(max(errs))


def _render_route(trainer, cpu, label: str, dataset: str, kwargs: dict,
                  out_dir: pathlib.Path, smi: str, launches: collections.Counter) -> None:
    """One route of `clip_render_phase`: per clip, then batched, each
    with the counters set to 0 just before and read just after (the GRU
    forward and the mel kernel must have run), faded out, pickles written;
    batched against per clip within GRU_TOL, every pickle loaded with
    `pickle` alone, the card against the CPU copy within SERVE_TOL; then
    3 warm calls each way (the checked calls were each batch's first,
    which pays first-use costs such as cuDNN's plans of new shapes)."""
    import torch
    from speech2affective_gestures_torch.train import clip_eval

    results = {}
    for batched in (False, True):
        way = "batched" if batched else "per clip"
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = clip_eval.generate_gestures_by_dataset(
            trainer, dataset, fade_out=True, save_pkl=True,
            save_path=str(out_dir / way.replace(" ", "_")), batched=batched, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counters()
        launches.update(counts)
        results[way] = res
        log(f"{label} {way}: {len(res)} clips in {wall:.3f} s ({len(res) / wall:.3f} clips/s, "
            f"{wall / max(len(res), 1) * 1e3:.1f} ms a clip); launches {dict(counts)}; {smi}")
        if not res or counts["gru_fwd"] < 1 or counts["mel_power"] < 1:
            raise AssertionError(f"{label} {way} did not run both kernels: {dict(counts)}")
        for _, (_, tri, s2ag) in res:
            if tri is None or not (np.isfinite(tri).all() and np.isfinite(s2ag).all()):
                raise AssertionError(f"{label} {way}: a render is missing or not finite")
        pickles = sorted((out_dir / way.replace(" ", "_")).glob("*.pkl"))
        if len(pickles) != 2 * len(res):
            raise AssertionError(f"{label} {way}: {len(pickles)} pickles for {len(res)} clips")
    err = _max_err(results["batched"], results["per clip"])
    log(f"{label} batched against per clip: max_abs_err {err:.3e} (tol {GRU_TOL})")
    if not err <= GRU_TOL:
        raise AssertionError(f"{label}: the batched render disagrees with per clip: {err}")
    check_pickles(pickles)
    t0 = time.perf_counter()
    want = clip_eval.generate_gestures_by_dataset(cpu, dataset, fade_out=True, batched=True,
                                                  **kwargs)
    err = _max_err(results["per clip"], want)
    log(f"{label} card against the CPU plain path ({time.perf_counter() - t0:.1f} s, "
        f"same weights and noise): max_abs_err {err:.3e} (tol {SERVE_TOL})")
    if not err <= SERVE_TOL:
        raise AssertionError(f"{label}: the card's render disagrees with the CPU's: {err}")

    p50s = {}
    for batched in (False, True):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = clip_eval.generate_gestures_by_dataset(trainer, dataset, fade_out=True,
                                                         batched=batched, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        p50s[batched] = p50 = float(np.median(walls))
        log(f"{label} {'batched' if batched else 'per clip'}, warm: p50 {p50:.3f} s for "
            f"{len(res)} clips ({len(res) / p50:.3f} clips/s) over {len(walls)} calls; "
            f"all {[round(w, 4) for w in walls]}; {smi}")
    log(f"{label}: batched {p50s[False] / p50s[True]:.2f}x per clip (warm p50s)")


def clip_render_phase(device, reading: list, work: pathlib.Path, smi: str) -> dict:
    """The long-clip rendering (`train/clip_eval.py`) at full width,
    float32, with both generators (s2ag on MFCC windows, the TriModal
    baseline on raw audio), on the trainer that `main_v2 --train-s2ag
    false` builds from the real-data phase's archive and work dir (its
    best checkpoint, the test split with its sidecars, a random TriModal
    baseline: no trimodal_gen.pth.tar). Three routes, each through
    `_render_route` (per clip and batched, checked against each other and
    against a CPU copy of the renderer with the same weights and noise,
    then timed warm):
    - "ted_db 60 s": that test split, whose 3 videos stitch into clips of
      ~59 s, past the default 5-12 s: `clip_duration_range` CLIP_RANGE,
      speakers drawn;
    - "ted_db 10 s": a test split of SHORT_VIDEOS synthetic videos of
      SHORT_SECONDS built with the trained corpus's vocabulary and
      speakers, the default range, speakers drawn: the batch a test split
      of many short clips gives;
    - "genea": a synthetic GENEA directory, speakers not drawn.
    Then one clip's TriModal render alone must add GRU forward launches
    (n_layers per window) and no mel launch; the device's busy share of
    one clip and of a batched call. No video: the card's machine has no
    matplotlib (`create_video_and_save` needs it)."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch import main_v2
    from speech2affective_gestures_torch.data import ted_db
    from speech2affective_gestures_torch.train import clip_eval, synthesis
    from speech2affective_gestures_torch.train.trainer import Trainer

    trainer = main_v2.main(reading + ["--train-s2ag", "false"])
    cfg, long_split = trainer.cfg, trainer.test_data
    t0 = time.perf_counter()
    videos = ted_db.make_synthetic_videos(SHORT_VIDEOS, SHORT_SECONDS, seed=11, device=device)
    short_split = dataclasses.replace(
        ted_db.build_dataset_from_videos(videos, cfg, lang_model=long_split.lang_model,
                                         keep_sidecars=True, device=device),
        speaker_model=long_split.speaker_model)
    log(f"clip render phase: {SHORT_VIDEOS} videos of {SHORT_SECONDS} s windowed into "
        f"{short_split.n_samples} test windows in {time.perf_counter() - t0:.1f} s")
    write_genea_dir(work / "genea")
    cpu = Trainer(cfg, str(work / "cpu_render"), test_data=long_split, device="cpu",
                  n_speakers=trainer.gen.speaker_embedding[0].num_embeddings)
    for name in ("gen", "tri"):
        getattr(cpu, name).load_state_dict(getattr(trainer, name).state_dict())

    def windows(audio_len):
        return len(synthesis.plan_subdivisions(audio_len / 16000, cfg)[0])

    clips = {}
    for label, split in (("ted_db 60 s", long_split), ("ted_db 10 s", short_split)):
        t0 = time.perf_counter()
        clips[label] = list(clip_eval.stitch_test_clips(split))
        lengths = sorted({round(c["time"][1] - c["time"][0], 3) for c in clips[label]})
        log(f"{label}: {split.n_samples} test windows stitch into {len(clips[label])} clips of "
            f"{lengths} s in {time.perf_counter() - t0:.4f} s (host), windows per clip "
            f"{sorted({windows(len(c['audio'])) for c in clips[label]})}")
    log(f"ted_db 60 s: clip_duration_range {CLIP_RANGE} admits its clips (default 5-12 s); "
        f"genea: one clip of {GENEA_SECONDS} s, {GENEA_JOINTS} joints, "
        f"{windows(GENEA_SECONDS * 16000)} windows")

    launches = collections.Counter()
    routes = (("ted_db 60 s", "ted_db", long_split,
               dict(data_params={"clip_duration_range": CLIP_RANGE}, randomized=True, seed=3)),
              ("ted_db 10 s", "ted_db", short_split, dict(randomized=True, seed=3)),
              ("genea", "genea_challenge_2020", long_split,
               dict(data_params={"data_path": str(work / "genea")}, randomized=False)))
    for label, dataset, split, kwargs in routes:
        trainer.test_data = cpu.test_data = split
        _render_route(trainer, cpu, label, dataset, kwargs,
                      work / "render" / label.replace(" ", "_"), smi, launches)

    # the TriModal render alone: raw-audio windows, so no mel launch
    renderer = clip_eval.ClipRenderer(trainer)
    c = clips["ted_db 60 s"][0]
    n_windows = windows(len(c["audio"]))
    words = [[w, s - c["time"][0], e - c["time"][0]] for w, s, e in c["words"]]
    eps = clip_eval.clip_noise(0, n_windows, trainer.tri.z_size)[1]
    _reset_counters()
    synthesis.synthesize_clip_fused(renderer.tri, c["audio"], words, renderer.lang, cfg,
                                    eps=eps, use_mfcc=False)
    torch.cuda.synchronize()
    tri_counts = _counters()
    log(f"TriModal render of one clip ({n_windows} windows): launches {dict(tri_counts)}")
    if (tri_counts["gru_fwd"] != cfg.n_layers * n_windows
            or tri_counts["mel_power"] or tri_counts["mel_power_mixed"]):
        raise AssertionError(f"the TriModal render's launches: {dict(tri_counts)}")

    for label, dataset, split, kwargs in routes[:2]:
        trainer.test_data = split
        c = clips[label][0]
        renderer = clip_eval.ClipRenderer(trainer)

        def one_clip(c=c, renderer=renderer):
            renderer.render_clip(c["vid"], c["poses"], c["audio"], 16000, c["words"],
                                 c["time"], clip_duration_range=CLIP_RANGE, fade_out=True)

        def all_clips(dataset=dataset, kwargs=kwargs):
            clip_eval.generate_gestures_by_dataset(trainer, dataset, batched=True,
                                                   fade_out=True, **kwargs)

        profile_device(f"{label} render_clip, one clip of {windows(len(c['audio']))} "
                       f"windows, both generators", "clip", one_clip, 2)
        profile_device(f"{label} generate_gestures_by_dataset batched, {len(clips[label])} "
                       f"clips", "call", all_clips, 2)
    del trainer, cpu
    return launches


def check_pickles(paths) -> None:
    """Load every pickle in a fresh interpreter that has no package of the
    repo on its path (`-I`, run from the pickles' directory): plain dicts
    of numpy arrays and strings."""
    script = ("import pickle, sys\n"
              "for p in sys.argv[1:]:\n"
              "    d = pickle.load(open(p, 'rb'))\n"
              "    assert sorted(d) == ['audio', 'aux_info', 'human_dir_vec', 'out_dir_vec',"
              " 'out_poses', 'sentence'], sorted(d)\n"
              "    assert all(type(d[k]).__module__ == 'numpy' for k in "
              "('audio', 'out_dir_vec', 'out_poses', 'human_dir_vec'))\n"
              "    assert isinstance(d['sentence'], str) and isinstance(d['aux_info'], str)\n"
              "print(len(sys.argv) - 1)")
    out = subprocess.run([sys.executable, "-I", "-c", script, *map(str, paths)],
                         capture_output=True, text=True, cwd=str(paths[0].parent))
    if out.returncode != 0:
        raise AssertionError(f"the pickles do not load with pickle alone: {out.stderr}")
    log(f"{out.stdout.strip()} pickles loaded with pickle alone (python -I)")


def _rel_np(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


def training_phase(device, work: pathlib.Path, embedding_net: pathlib.Path,
                   mixed_precision: bool = False, variant: str = "s2ag",
                   options: tuple = ()):
    """`main_v2.main` on the card: the paper's GAN at full width, batch 512,
    one epoch with the GAN terms on from the first step, then the test
    split scored with FGD by the card-trained embedding net. With
    `mixed_precision` (`--mixed-precision true`) the train steps run at
    bf16: the GRU kernels' bf16 instances must run in training and only
    the float32 ones in the scoring. An ablation `variant` runs its own
    entry point (`main_v2_abl_audio`, `main_v2_abl_aff`): the mel kernel
    must run in its corpus build, it must train in its suffixed work dir,
    and abl_aff's ConvDiscriminator must run the GRU kernels at T
    CONV_DIS_T, H 64 in training. `options` are more flags of the entry
    point (those of `STEP_OPTIONS`), in a work dir of their own; the GRU launches
    at the fused batch FUSED_B are logged by H and tier. Returns the
    trainer and each kernel's launches in training and in the scoring,
    with the launches at the ConvDiscriminator's shape and at the fused
    batch (H 300) also under their own names."""
    import importlib

    import torch
    import yaml
    from speech2affective_gestures_torch import main_v2
    from speech2affective_gestures_torch.ops import gru_cuda
    from speech2affective_gestures_torch.train.trainer import Trainer

    entry = importlib.import_module(
        "speech2affective_gestures_torch." + ("main_v2" if variant == "s2ag"
                                              else f"main_v2_{variant}"))
    raw = yaml.safe_load(CONFIG.read_text())
    raw["loss_warmup"] = -1       # epoch 0 > -1: the discriminator runs
    cfg_path = work / "multimodal_context_v2_gan_on.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    base = work / ((f"base_{variant}" if variant != "s2ag" else "base")
                   + ("_bf16" if mixed_precision else "")
                   + "".join("_" + o.lstrip("-").replace("-", "_") for o in options))
    work_dir = base / "models" / f"s2ag_v2_mfcc_torch{main_v2.WORK_DIR_SUFFIX[variant]}" / "ted_db"
    argv = ["-b", str(base), "-c", str(cfg_path), "--synthetic-data", "true",
            "--synthetic-videos", str(TRAIN_VIDEOS), "--synthetic-seconds",
            str(TRAIN_SECONDS), "--batch-size", str(TRAIN_BATCH),
            "--s2ag-num-epoch", "1", "--log-interval", "1",
            "--embedding-net-checkpoint", str(embedding_net),
            "--mixed-precision", str(mixed_precision).lower(), *options]
    log(f"training phase: {entry.__name__.rsplit('.', 1)[1]}.main({' '.join(argv)})")
    # the counters are read, and set to 0 again, just before main_v2 scores
    # the test split, and read just after
    counts = {}
    scoring = Trainer.generate_gestures

    def counted(self, *args, **kwargs):
        torch.cuda.synchronize()
        counts["training"] = _counters()
        counts["training tiers"] = _tier_counters()
        counts["training T28"] = _conv_dis_counters()
        counts["training B1024"] = _fused_batch_counters()
        counts["training by batch"] = {k: n for k, n in gru_cuda.batch_launches.items()
                                       if k[2] == FUSED_B}
        _reset_counters()
        t0 = time.perf_counter()
        result = scoring(self, *args, **kwargs)
        torch.cuda.synchronize()
        counts["evaluation"] = _counters()
        counts["evaluation T28"] = _conv_dis_counters()
        log(f"generate_gestures in main_v2: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        return result

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Trainer.generate_gestures = counted
    try:
        trainer = entry.main(argv)
    finally:
        Trainer.generate_gestures = scoring
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, evaluated = counts["training"], counts["evaluation"]
    tiers = counts["training tiers"]
    log(f"training launches{' (mixed precision)' if mixed_precision else ''}: "
        f"{dict(launches)}, by tier {dict(tiers)}; test-split scoring launches: "
        f"{dict(evaluated)}; main_v2.main took {wall:.1f} s in all")
    suffix = "_bf16" if mixed_precision else ""
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        if launches[name + suffix] < 1:
            raise AssertionError(f"kernel {name + suffix} was not launched in training")
    # at batch 512 the bf16 forward, the generator's recurrence and dW run on
    # the tensor cores
    for name in (("gru_fwd_bf16/tensor", "gru_bwd_bf16/tensor", "gru_dw_bf16/tensor")
                 if mixed_precision else ()):
        if tiers[name] < 1:
            raise AssertionError(f"{name} was not launched in mixed-precision training")
    if evaluated["gru_fwd"] < 1 or any(k.endswith("_bf16") and n for k, n in evaluated.items()):
        raise AssertionError(f"generate_gestures did not run float32 alone: {evaluated}")
    if trainer.device.type != device.type:
        raise AssertionError(f"main_v2 trained on {trainer.device}, not the card")
    t28 = counts["training T28"]
    if variant != "s2ag":
        log(f"{variant}: trained in {trainer.work_dir}; the corpus build's mel launches "
            f"{launches['mel_power']}; GRU launches at the ConvDiscriminator's T "
            f"{CONV_DIS_T}, H 64 in training {dict(t28)}, in the scoring "
            f"{dict(counts['evaluation T28'])}")
        if trainer.variant != variant or pathlib.Path(trainer.work_dir) != work_dir:
            raise AssertionError(f"{variant} trained as {trainer.variant} in {trainer.work_dir}")
        if launches["mel_power"] < 1:
            raise AssertionError(f"{variant}: the corpus build ran no mel kernel")
        # abl_aff's discriminator: its three kernels at the step's dtype (the
        # float32 forward also runs in the validation); no other net has T 28
        ran = {k for k, n in t28.items() if n}
        want_t28 = {f"{k}_t{CONV_DIS_T}{suffix}" for k in ("gru_fwd", "gru_bwd", "gru_dw")}
        if (variant == "abl_aff" and want_t28 - ran) or (variant != "abl_aff" and ran):
            raise AssertionError(f"{variant}: GRU launches at T {CONV_DIS_T} {dict(t28)}")

    log_txt = (work_dir / "log.txt").read_text()
    iters = [line.split("Done. | ")[1] for line in log_txt.splitlines()
             if "Done. | " in line]
    steps = [dict((k, float(v)) for k, v in (tok.split(": ") for tok in it.split(" | ")))
             for it in iters]
    for i, metrics in enumerate(steps):
        log(f"train step {i} losses: {metrics}")
    if len(steps) < 3 or not all("dis" in m and "gen" in m for m in steps):
        raise AssertionError(f"expected >= 3 steps with the GAN terms, got {iters}")
    if not all(np.isfinite(list(m.values())).all() for m in steps):
        raise AssertionError("non-finite training loss")
    for line in log_txt.splitlines():
        if "synthetic corpus" in line or "epoch 0" in line:
            log(f"  log: {line}")
    if not list(work_dir.glob("*.pth.tar")):
        raise AssertionError("main_v2 wrote no checkpoint")
    [line] = [x for x in log_txt.splitlines() if "eval: " in x]
    scores = {k: float(v) for k, v in (tok.split(": ") for tok in
                                       line.split("eval: ")[1].split(" | "))}
    log(f"test split ({trainer.test_data.n_samples} windows) scored on the card: {scores}")
    if (set(scores) != {"l1", "joint_mae", "accel", "FGD", "feat_dist"}
            or not np.isfinite(list(scores.values())).all()):
        raise AssertionError(f"bad test-split scores: {scores}")
    if options:
        log(f"GRU launches at B {FUSED_B} in training with {' '.join(options)}, by (kernel, "
            f"dtype, B, H, tier): {counts['training by batch']}")
    return trainer, (launches + evaluated + t28 + counts["evaluation T28"]
                     + counts["training B1024"])


def time_generate_gestures(trainer, n: int = 3) -> None:
    """Wall time of `generate_gestures` on the whole test split (host clock
    around each call, ended by a synchronize), then its device profile."""
    import torch

    n_test = trainer.test_data.n_samples

    def score():
        return trainer.generate_gestures(batch_size=min(2048, n_test), randomized=False)

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"generate_gestures ({n_test} windows, FGD on): p50 {np.median(times):.3f} ms over "
        f"{n} calls; all {[round(t, 3) for t in times]}")
    profile_device(f"generate_gestures ({n_test} windows)", "call", score, n=2)


def eval_parity_phase(trainer, work: pathlib.Path) -> None:
    """`generate_gestures` on the test split from the same weights, the same
    speakers (the same numpy draws) and the same speaker noise on the card
    and on the CPU plain path: the generated poses, the embedding features
    and FGD must agree."""
    from speech2affective_gestures_torch.train.evaluator import EmbeddingSpaceEvaluator
    from speech2affective_gestures_torch.train.trainer import Trainer

    n = trainer.test_data.n_samples
    eps = np.random.default_rng(7).standard_normal((n, 16)).astype(np.float32)
    cpu = Trainer(trainer.cfg, str(work / "cpu_eval"), test_data=trainer.test_data,
                  device="cpu", evaluator=EmbeddingSpaceEvaluator(
                      copy.deepcopy(trainer.evaluator.net), device="cpu"))
    for name in ("gen", "dis", "tri"):
        getattr(cpu, name).load_state_dict(getattr(trainer, name).state_dict())
    runs = {}
    for label, tr in (("card", trainer), ("CPU", cpu)):
        ev, pushed = tr.evaluator, []
        push = ev.push_samples

        def record(generated, real, ev=ev, push=push, pushed=pushed):
            push(generated, real)
            pushed.append((np.asarray(generated.cpu()), ev.generated_feat_list[-1],
                           ev.real_feat_list[-1]))

        ev.push_samples = record
        t0 = time.perf_counter()
        try:
            scores = tr.generate_gestures(batch_size=n, randomized=False, eps=eps)
        finally:
            del ev.push_samples
        runs[label] = (scores, *(np.vstack(x) for x in zip(*pushed)))
        log(f"generate_gestures on the {label} ({n} windows, same noise): {scores} in "
            f"{time.perf_counter() - t0:.1f} s")
    (card, *card_arrays), (want, *cpu_arrays) = runs["card"], runs["CPU"]
    pose_err, gen_feat_err, real_feat_err = (
        float(np.abs(a - b).max()) for a, b in zip(card_arrays, cpu_arrays))
    fgd_rel = abs(card["FGD"] - want["FGD"]) / abs(want["FGD"])
    log(f"evaluation card vs CPU plain path: poses max_abs_err={pose_err:.3e} (tol "
        f"{SERVE_TOL}); embedding features max_abs_err generated {gen_feat_err:.3e}, real "
        f"{real_feat_err:.3e} (tol {FEAT_TOL}); FGD {card['FGD']:.6f} vs {want['FGD']:.6f}, "
        f"relative {fgd_rel:.3e} (tol {FGD_RTOL})")
    if not (pose_err <= SERVE_TOL and max(gen_feat_err, real_feat_err) <= FEAT_TOL
            and fgd_rel <= FGD_RTOL):
        raise AssertionError("the card's evaluation disagrees with the CPU path")


def time_train_step(trainer, n: int = 6):
    """p50 of the train step at the trainer's batch size, host clock
    around each step ended by a synchronize; then its device profile."""
    import torch
    from speech2affective_gestures_torch.data.ted_db import BatchSampler
    from speech2affective_gestures_torch.train import builder

    sampler = iter(BatchSampler(trainer.train_data, trainer.cfg.batch_size, seed=5))
    batch = builder.to_device(next(sampler), trainer.device)

    def step():
        return trainer.step.train_step(batch, trainer.generator, gan_on=True)

    step()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    bs = trainer.cfg.batch_size
    log(f"train step at batch {bs}: p50 {p50:.3f} ms over {n} steps, "
        f"{bs / p50 * 1e3:.1f} samples/s; all {[round(t, 3) for t in times]}; "
        f"last metrics {[(k, round(float(v), 5)) for k, v in metrics.items()]}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_device(f"the train step (batch {bs}, full width)", "step", step, n=3)
    return p50


def aff_encoder_probe(gen, batch, eps, device) -> None:
    """The generator's train-mode forward on the card and on the CPU in
    float32 against the CPU in float64: the error of the first ST-GCN
    block's residual branch before and after its batch norm (its 1x1
    convolution sees the seed poses, zero at 30 of 34 frames, so each
    channel's batch mean is large against its deviation), and the leaky
    ReLUs that end both ST-GCN blocks: how many pre-activations take the
    other slope than in float64, and the smallest |pre-activation|."""
    import torch
    from speech2affective_gestures_torch import constants as C
    from speech2affective_gestures_torch.train import builder, gan_step

    runs = {}
    for name, dev, dtype in (("float64", "cpu", torch.float64),
                             ("card", device, torch.float32),
                             ("CPU", "cpu", torch.float32)):
        model = copy.deepcopy(gen).to(dev, dtype).train()
        enc, out = model.aff_encoder, {}
        hooks = {"residual conv": enc.st_gcn1.residual[0],
                 "residual batch norm": enc.st_gcn1.residual[1]}
        for i in (1, 2):
            block = getattr(enc, f"st_gcn{i}")
            hooks[f"tcn{i}"], hooks[f"res{i}"] = block.tcn, block.residual
        for key, module in hooks.items():
            module.register_forward_hook(
                lambda m, a, o, key=key: out.__setitem__(key, o.detach().cpu().double()))
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in builder.to_device(batch, torch.device(dev)).items()}
        with torch.no_grad():
            model(gan_step.build_pre_seq(b["vec_seq"], C.N_PRE_POSES),
                  b["extended_word_seq"], b["mfcc_features"], b["vid_indices"],
                  torch.from_numpy(eps).to(dev, dtype))
        for i in (1, 2):
            out[f"leaky ReLU {i}"] = out.pop(f"tcn{i}") + out.pop(f"res{i}")
        runs[name] = out
    ref = runs.pop("float64")
    for name, out in runs.items():
        errs = [f"{k} {_rel(out[k], ref[k]):.2e}"
                for k in ("residual conv", "residual batch norm")]
        for i in (1, 2):
            v, w = out[f"leaky ReLU {i}"], ref[f"leaky ReLU {i}"]
            errs.append(f"block {i} leaky ReLU: {int(((v > 0) != (w > 0)).sum())} of "
                        f"{w.numel()} on the other slope (smallest |pre-activation| "
                        f"{w.abs().min().item():.2e})")
        log(f"generator AffEncoder forward, {name} float32 against the CPU in "
            f"float64 (relative to the largest value): " + "; ".join(errs))


@contextlib.contextmanager
def _branches(replay: list | None = None):
    """Inside the block every ReLU and leaky ReLU (`torch.relu`, which
    `nn.ReLU` and the TCN's residual call, and `F.leaky_relu`) records, in
    call order, its branch (pre-activation > 0) and its pre-activations'
    magnitudes, and every max pool (`F.max_pool2d`, which `nn.MaxPool2d`
    calls) the element each window picks and its input, on the CPU; with
    `replay` (another run's record, the same calls in the same order) each
    takes that run's branch or pick instead of its own: the same function
    where they agree, with the same gradient."""
    import torch
    import torch.nn.functional as F

    record: list = []
    relu, leaky, max_pool = torch.relu, F.leaky_relu, F.max_pool2d

    def pick(x, slope):
        own = x > 0
        record.append(("branch", own.cpu(), x.detach().abs().cpu().double()))
        mask = own if replay is None else replay[len(record) - 1][1].to(x.device)
        return torch.where(mask, x, x * slope)

    def pool(x, *args, return_indices=False, **kwargs):
        out, own = max_pool(x, *args, return_indices=True, **kwargs)
        record.append(("pool", own.cpu(), x.detach().flatten(2).cpu().double()))
        if replay is not None:
            idx = replay[len(record) - 1][1].to(x.device)
            out = x.flatten(2).gather(2, idx.flatten(2)).view(out.shape)
        return (out, own) if return_indices else out

    torch.relu = lambda x: pick(x, 0.0)
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: pick(x, negative_slope)
    F.max_pool2d = pool
    try:
        yield record
    finally:
        torch.relu, F.leaky_relu, F.max_pool2d = relu, leaky, max_pool


def _branch_flips(got: list, want: list) -> list:
    """The calls of `_branches` records `got` and `want` whose branches or
    picks differ: (call, elements, the largest |pre-activation| of `want`
    at them, or for a pool the largest gap in `want`'s input between the two
    picks, over the largest |value| of the call)."""
    out = []
    for i, ((kind, mine, _), (_, ref, pre)) in enumerate(zip(got, want)):
        flips = mine != ref
        if flips.any():
            top = max(pre.abs().max().item(), 1e-30)
            if kind == "pool":
                gap = pre.gather(2, ref.flatten(2)) - pre.gather(2, mine.flatten(2))
                worst = gap.abs()[flips.flatten(2)].max().item()
            else:
                worst = pre[flips].max().item()
            out.append((i, int(flips.sum()), worst / top))
    return out


def step_parity_phase(device, gradient_clip: float = 0.0, variant: str = "s2ag",
                      fused_pass: bool = False) -> None:
    """One train step of `variant`'s nets (`builder.init_training`) at
    full width and batch 16 on the card and on the CPU plain path, from
    the same weights, batch, speaker noise (the main forwards' and the
    diversity regularizer's) and div-reg speaker ids, every dropout at
    zero.

    The CPU path runs in float64 as the reference, and in float32 for
    comparison; `aff_encoder_probe` prints where the float32 runs part
    from float64 in the generator's AffEncoder. With `gradient_clip` the
    step clips each net's gradients by their global norm
    (`gan_step.clip_by_global_norm_`): both nets' norms must exceed it on
    this batch, so that both are clipped, and are printed. With
    `fused_pass` the step is the fused one (`GanConfig.fused_pass`: D on
    real and fake, G's main and div-reg forwards, each one 2B forward,
    the noise eps and eps_rand concatenated). The card is held to the
    float64 step by `_held_to_float64` (its metrics, both nets' BN stats
    and Adam first moments within STEP_TOL, the frozen TriModal's stats
    unchanged; branch flips at float32 rounding replayed)."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.models import layers as L
    from speech2affective_gestures_torch.train import builder, gan_step

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    n_words, n_speakers, B = 1000, 100, 16
    init = builder.init_training(cfg, 0, n_words, n_speakers, device="cpu", variant=variant)
    init["gan_cfg"] = dataclasses.replace(init["gan_cfg"], gradient_clip=gradient_clip,
                                          fused_pass=fused_pass)
    for model in (init["gen"], init["dis"], init["tri"]):
        for m in model.modules():
            if isinstance(m, L.Dropout):
                m.p = 0.0
            elif isinstance(m, L.GRU):
                m.dropout = 0.0
    rng = np.random.default_rng(0)
    batch = builder.synthetic_batch(rng, B, cfg, n_words, n_speakers)
    eps = rng.standard_normal((B, 16))
    other = rng.permutation(batch["vid_indices"])
    eps_rand = rng.standard_normal((B, 16))
    if not gradient_clip and not fused_pass and variant == "s2ag":
        aff_encoder_probe(init["gen"], batch, eps, device)

    def one_step(dev, dtype):
        models = {k: copy.deepcopy(init[k]).to(dev, dtype) for k in ("gen", "dis", "tri")}
        step = gan_step.GanStep(models["gen"], models["dis"], init["gan_cfg"],
                                models["tri"])
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in builder.to_device(batch, dev).items()}
        t0 = time.perf_counter()
        metrics = step.train_step(b, torch.Generator(device=dev).manual_seed(0),
                                  gan_on=True, eps=torch.from_numpy(eps).to(dev, dtype),
                                  eps_rand=torch.from_numpy(eps_rand).to(dev, dtype))
        metrics = {k: float(v) for k, v in metrics.items()}
        norms = {k: float(v) for k, v in step.grad_norms.items()}
        log(f"one {variant}{' fused' if fused_pass else ''} train step, batch {B}, on "
            f"{dev} in {dtype}"
            f"{f', gradient clip {gradient_clip}' if gradient_clip else ''}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {metrics}"
            f"{f'; global gradient norms {norms}' if gradient_clip else ''}")
        if gradient_clip and not (set(norms) == {"gen", "dis"}
                                  and min(norms.values()) > gradient_clip):
            raise AssertionError(f"the step did not clip both nets: norms {norms}")
        return models, step, metrics

    def errors(run, want):
        (models, step, got), (ref_models, ref_step, ref_metrics) = run, want
        return {
            "metrics (relative)": _metric_err(got, ref_metrics),
            "gen BN stats": _stats_err(ref_models["gen"], models["gen"]),
            "dis BN stats": _stats_err(ref_models["dis"], models["dis"]),
            "TriModal BN stats against its initial ones": _stats_err(init["tri"],
                                                                     models["tri"]),
            "gen Adam m": _moment_err(ref_step.gen_opt, ref_models["gen"],
                                      step.gen_opt, models["gen"]),
            "dis Adam m": _moment_err(ref_step.dis_opt, ref_models["dis"],
                                      step.dis_opt, models["dis"]),
        }

    draw = gan_step.draw_other_speaker_ids
    gan_step.draw_other_speaker_ids = (
        lambda g, vids, n: torch.as_tensor(other, device=vids.device))
    try:
        _held_to_float64(device, f"{variant}{' fused' if fused_pass else ''} step"
                         f"{' (clipped)' if gradient_clip else ''}", one_step, errors)
    finally:
        gan_step.draw_other_speaker_ids = draw


def _metric_err(got: dict, want: dict, tol: float = STEP_TOL) -> float:
    """The largest difference of a step's metrics, each relative to its
    float64 value (plus 1e-6 absolute, at `tol`, for a near-zero difference
    of two means); inf where the names differ."""
    if set(got) != set(want):
        return np.inf
    return max(abs(got[k] - want[k]) / (abs(want[k]) + 1e-6 / tol) for k in want)


def _stats_err(a, b) -> float:
    """BatchNorm running stats of model b against a's, the largest
    difference relative to each tensor's largest value."""
    sa, sb = a.state_dict(), b.state_dict()
    return max(_rel(sb[k].cpu().double(), sa[k].double()) for k in sa
               if k.endswith(("running_mean", "running_var")))


def _moment_err(opt_a, model_a, opt_b, model_b, key: str = "exp_avg",
                bn_fed: tuple = ()) -> float:
    """The optimizer state `key` of model b's parameters (Adam's first
    moment, 0.5 g after step 1; SGD's momentum buffer) against model a's,
    the largest difference relative to each tensor's largest. The biases
    ahead of a batch norm in train mode have a zero gradient up to float
    noise (the batch mean removes them): a tensor whose states all lie
    below 1e-4 of the model's largest, or one named in `bn_fed` (where
    weight decay keeps its state above that), is held relative to the
    model's largest instead."""
    names = dict(model_a.named_parameters())
    pairs = [(n, opt_a.state[p][key], opt_b.state[q][key].cpu().double())
             for (n, p), q in zip(names.items(), model_b.parameters())]
    top = max(a.abs().max().item() for _, a, _ in pairs)
    return max((b - a).abs().max().item()
               / (a.abs().max().item() if a.abs().max().item() >= 1e-4 * top
                  and n not in bn_fed else top)
               for n, a, b in pairs)


def _held_to_float64(device, label: str, one_step, errors) -> None:
    """A train step on the card in float32 held to the same step on the CPU
    plain path in float64. `one_step(device, dtype)` runs the step from the
    same weights and inputs and returns what `errors(run, reference)`
    compares: {name: error}, each within STEP_TOL for the card; the CPU's
    float32 step is logged beside it.

    Each ReLU and leaky ReLU's branch and each max pool's pick are recorded
    (`_branches`). Where the card's float32 step takes another branch or
    pick than the float64 step within FLIP_TOL of its call's largest value
    (float32 rounding at zero, or at a tie: one such element can move its
    weights' gradient far past STEP_TOL), the card is held to the float64
    step rerun on the card's branches; a flip past FLIP_TOL fails the
    phase."""
    import torch

    cpu = torch.device("cpu")
    with _branches() as ref_branches:
        ref = one_step(cpu, torch.float64)
    with _branches() as card_branches:
        card = one_step(device, torch.float32)
    flips = _branch_flips(card_branches, ref_branches)
    log(f"ReLU and leaky ReLU branches and max-pool picks of the card's float32 {label} "
        f"against the float64 one's: {len(ref_branches)} calls; (call, elements on the "
        f"other branch or pick, their largest |pre-activation| or gap over the call's "
        f"largest) {flips} (tol {FLIP_TOL})")
    if any(rel > FLIP_TOL for _, _, rel in flips):
        raise AssertionError(f"the card's {label} takes another branch past float32 "
                             f"rounding: {flips}")
    # (label, run, the float64 step it is held to)
    checks = [("card", card, ref)]
    if flips:
        with _branches(replay=card_branches):
            ref_card = one_step(cpu, torch.float64)
        checks = [("card", card, ref_card),
                  ("card (against the float64 step's own branches)", card, ref)]
    checks.append(("CPU", one_step(cpu, torch.float32), ref))
    errs = {}
    for name, run, want in checks:
        errs[name] = errors(run, want)
        on = " on the card's branches" if want is not ref else ""
        log(f"{name} float32 {label} against the CPU float64 one{on}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs[name].items())
            + f" (tol {STEP_TOL} for the card)")
    if not all(v <= STEP_TOL for v in errs["card"].values()):
        raise AssertionError(f"card {label} disagrees with the CPU float64 one: "
                             f"{errs['card']}")


def mixed_step_parity_phase(device, variant: str = "s2ag") -> None:
    """One mixed-precision train step (`builder.mixed_precision_apply` over
    `variant`'s three nets) at full width and batch 16 on the card and on the CPU
    bf16 path (the GRU's plain versions at the kernels' rounding points),
    from the same weights scaled by MP_SCALE, batch, speaker noise and
    div-reg speaker ids, every dropout at zero: the step's metrics within
    MP_TOL (each relative to its own value, plus 5e-4 absolute); the
    generator's GRU and head Adam first moments logged. The same at the
    unscaled weights is logged as information only."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.models import layers as L
    from speech2affective_gestures_torch.train import builder, gan_step

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    n_words, n_speakers, B = 1000, 100, 16
    init = builder.init_training(cfg, 0, n_words, n_speakers, device="cpu", variant=variant)
    for model in (init["gen"], init["dis"], init["tri"]):
        for m in model.modules():
            if isinstance(m, L.Dropout):
                m.p = 0.0
            elif isinstance(m, L.GRU):
                m.dropout = 0.0
    rng = np.random.default_rng(1)
    batch = builder.synthetic_batch(rng, B, cfg, n_words, n_speakers)
    eps = torch.from_numpy(rng.standard_normal((B, 16)).astype(np.float32))
    other = rng.permutation(batch["vid_indices"])
    eps_rand = torch.from_numpy(rng.standard_normal((B, 16)).astype(np.float32))

    def one_step(dev, scale):
        models = {k: _scaled_copy(init[k], scale).to(dev) for k in ("gen", "dis", "tri")}
        step = gan_step.GanStep(models["gen"], models["dis"], init["gan_cfg"], models["tri"],
                                train_apply=builder.mixed_precision_apply)
        t0 = time.perf_counter()
        metrics = step.train_step(builder.to_device(batch, dev),
                                  torch.Generator(device=dev).manual_seed(0),
                                  gan_on=True, eps=eps.to(dev), eps_rand=eps_rand.to(dev))
        metrics = {k: float(v) for k, v in metrics.items()}
        log(f"one mixed-precision {variant} train step, batch {B}, weights x{scale}, on {dev}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {metrics}")
        return step, metrics

    draw = gan_step.draw_other_speaker_ids
    gan_step.draw_other_speaker_ids = (
        lambda g, vids, n: torch.as_tensor(other, device=vids.device))
    try:
        for scale in (MP_SCALE, 1.0):
            card_step, got = one_step(device, scale)
            cpu_step, want = one_step(torch.device("cpu"), scale)
            metric = max(abs(got[k] - want[k]) / (abs(want[k]) + 5e-4 / MP_TOL)
                         for k in want) if set(got) == set(want) else np.inf
            moments = max(
                _rel(card_step.gen_opt.state[p]["exp_avg"].cpu(), cpu_step.gen_opt.state[q]["exp_avg"])
                for (name, p), q in zip(card_step.gen.named_parameters(),
                                        cpu_step.gen.parameters())
                if name.startswith(("gru.", "out")))
            log(f"mixed-precision {variant} step card vs CPU bf16 path, weights x{scale}: metrics "
                f"{metric:.3e} relative (tol {MP_TOL} at x{MP_SCALE}; information only at "
                f"x1.0); generator GRU and head Adam first moments, worst relative to the "
                f"tensor's largest {moments:.3e}")
            if scale == MP_SCALE and not metric <= MP_TOL:
                raise AssertionError(f"the card's mixed-precision step disagrees with the "
                                     f"CPU bf16 path: {metric}")
    finally:
        gan_step.draw_other_speaker_ids = draw


def conv_dis_kernel_phase(device) -> dict:
    """The GRU kernels at the ConvDiscriminator's shape (abl_aff's D: T
    CONV_DIS_T after its unpadded convs, B 512, H 64, D 2; layer 0 takes 8
    features, later layers 128): `shape_kernel_phase`, under the names
    "gru_fwd_t28", ..., "gru_dw_t28_bf16"."""
    return shape_kernel_phase(device, CONV_DIS_T, 512, ((64, 8), (64, 128)),
                              f"_t{CONV_DIS_T}", "the ConvDiscriminator's shape")


def fused_batch_kernel_phase(device) -> dict:
    """The GRU kernels at the fused step's batch (B FUSED_B, T 34, D 2): the
    generator's layers (H 300, 88 and 600 features) and the
    discriminator's (H 64, 8 and 128): `shape_kernel_phase`, under the
    names "gru_fwd_b1024", ..., "gru_dw_b1024_bf16"."""
    return shape_kernel_phase(device, 34, FUSED_B,
                              ((300, 88), (300, 600), (64, 8), (64, 128)),
                              f"_b{FUSED_B}", "the fused step's batch")


def rank_batch_kernel_phase(device) -> dict:
    """The GRU kernels at a data-parallel rank's batch of TRAIN_BATCH (B 256
    on each of 2 ranks, 128 on each of 4; T 34, D 2), the generator's
    layers (H 300, 88 and 600 features) and the discriminator's (H 64, 8
    and 128): `shape_kernel_phase`, under "gru_fwd_b256", ...,
    "gru_dw_b128_bf16"."""
    errs = {}
    for ranks in (2, DP_RESUME_RANKS):
        B = TRAIN_BATCH // ranks
        errs.update(shape_kernel_phase(device, 34, B, ((300, 88), (300, 600), (64, 8),
                                                       (64, 128)),
                                       f"_b{B}", f"a rank's batch of {ranks}"))
    return errs


def shape_kernel_phase(device, T: int, B: int, shapes, tag: str, what: str, D: int = 2,
                       dtypes=("float32", "bfloat16")) -> dict:
    """The GRU kernels at T, B and each (H, input width) of `shapes`, D
    directions, in each of `dtypes`, against their plain twins on the same inputs: the
    forward (ys, h_last; hp relative), the recurrence (dxp and gn; float32
    absolute, bf16 relative to the largest) and dW (dW_hh and db_hh from
    the same inputs, relative to the largest) at the kernel phases'
    tolerances (float32 GRU_TOL and BWD_TOL, bf16 BF16_TOL; dW BWD_TOL),
    the same bits twice; at bf16 the forward and the recurrence in the
    tiers their plans name and, where that is the register tier, the
    tensor tier by its own plan too, against the same twin. Returns the
    largest error of each kernel under its name in the kernels line, the
    kernel's with `tag` ("_t28": "gru_fwd_t28", ..., "gru_dw_t28_bf16")."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    errs = {}
    for dtype in (getattr(torch, name) for name in dtypes):
        bf16 = dtype == torch.bfloat16
        sfx = tag + ("_bf16" if bf16 else "")
        tol = BF16_TOL if bf16 else GRU_TOL
        for name in ("gru_fwd", "gru_bwd", "gru_dw"):
            errs[name + sfx] = 0.0
        for H, cin in shapes:
            xp, w_hh, b_ih, b_hh = (t.to(dtype).contiguous() for t in
                                    gru_inputs(T, B, cin, H, D, seed=T + cin, device=device))
            dys = torch.randn(T, B, D * H, generator=torch.Generator().manual_seed(cin)
                              ).to(device, dtype)
            ys, h_last, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
            dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
            want_ys, want_h, want_hp = gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh,
                                                                save_hp=True)
            want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys,
                                                                   dys, hp)
            dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
            want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
            fwd_err = max((ys.float() - want_ys.float()).abs().max().item(),
                          (h_last.float() - want_h.float()).abs().max().item())
            hp_rel = _rel(hp, want_hp)
            rec_abs = max((dxp.float() - want_dxp.float()).abs().max().item(),
                          (gn.float() - want_gn.float()).abs().max().item())
            rec_rel = max(_rel(dxp.float(), want_dxp.float()), _rel(gn.float(), want_gn.float()))
            dw_rel = max(_rel(dw, want_dw), _rel(db, want_db))
            again = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
            same = (torch.equal(dw, again[0]) and torch.equal(db, again[1])
                    and torch.equal(ys, gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)[0])
                    and torch.equal(dxp, gru_cuda.gru_bwd_recurrence(
                        xp, w_hh, b_ih, b_hh, ys, dys, hp)[0]))
            tiers = (gru_cuda._device_plan(device, B, H, D, dtype).tier,
                     gru_cuda._device_bwd_plan(device, B, H, D, dtype).tier)
            rec_ok = rec_rel <= tol if bf16 else rec_abs <= BWD_TOL
            log(f"kernel {'bf16' if bf16 else 'float32'} at {what} T={T} "
                f"B={B} cin={cin} H={H} D={D} (forward tier {tiers[0]}, recurrence tier "
                f"{tiers[1]}): forward ys/h_last max_abs_err={fwd_err:.3e}, hp relative "
                f"{hp_rel:.3e} (tol {tol}); recurrence dxp/gn max_abs_err={rec_abs:.3e}, "
                f"relative {rec_rel:.3e} (tol {BF16_TOL if bf16 else BWD_TOL} "
                f"{'relative' if bf16 else 'absolute'}); dW_hh/db_hh relative {dw_rel:.3e} "
                f"(tol {BWD_TOL}); bitwise repeatable {same}")
            if not (fwd_err <= tol and hp_rel <= tol and rec_ok and dw_rel <= BWD_TOL
                    and same):
                raise AssertionError(f"a GRU kernel disagrees with its twin at T {T} H {H} "
                                     f"{dtype}: {fwd_err}, {hp_rel}, {rec_abs}, {rec_rel}, "
                                     f"{dw_rel}, {same}")
            errs["gru_fwd" + sfx] = max(errs["gru_fwd" + sfx], fwd_err)
            errs["gru_bwd" + sfx] = max(errs["gru_bwd" + sfx], rec_abs)
            errs["gru_dw" + sfx] = max(errs["gru_dw" + sfx],
                                       (dw - want_dw).abs().max().item(),
                                       (db - want_db).abs().max().item())
            if bf16 and "registers" in tiers:
                # the tensor tiers at this shape too, each by its own plan
                fplan = gru_cuda.fwd_plan(B, H, D, gru_cuda.max_clusters(
                    device, H, "fwd", dtype, "tensor"), "tensor")
                tys, th, thp = gru_cuda._forward_launch(xp, w_hh, b_ih, b_hh, fplan, True)
                bplan = gru_cuda.bwd_plan(B, H, D, gru_cuda.max_clusters(
                    device, H, "bwd", dtype, "tensor"), "tensor")
                b_in = gru_cuda.kernel_biases(b_ih, b_hh, H)[0]
                tdx, tgn = gru_cuda._recurrence_launch(False, xp, w_hh, b_in, hp, ys, dys,
                                                       bplan)
                t_fwd = max((tys.float() - want_ys.float()).abs().max().item(),
                            (th.float() - want_h.float()).abs().max().item(),
                            _rel(thp, want_hp))
                t_rec = max(_rel(tdx.float(), want_dxp.float()),
                            _rel(tgn.float(), want_gn.float()))
                log(f"  the tensor tiers by their own plans: forward error {t_fwd:.3e}, "
                    f"recurrence relative {t_rec:.3e} (tol {BF16_TOL})")
                if not (t_fwd <= BF16_TOL and t_rec <= BF16_TOL):
                    raise AssertionError(f"a tensor tier disagrees at T {T} H {H}: "
                                         f"{t_fwd}, {t_rec}")
    return errs


def _corpus_words(vocab, n: int = 13):
    """n timed words of a vocabulary's own (none maps to <UNK>), 0.7 s apart."""
    words = [w for w in vocab.word2index if not w.startswith("<")]
    return [[words[i % len(words)], 0.3 + 0.7 * i, 0.6 + 0.7 * i] for i in range(n)]


def ablation_service_check(trainer, smi: str) -> collections.Counter:
    """`SynthesisService.from_trainer` over a trained ablation: a 10 s clip
    with the counters set to 0 just before and read just after (the GRU
    forward must run; abl_audio's generator eats raw audio windows, so no
    mel kernel may run, abl_aff's its MFCCs, so the mel kernel must), the
    output against a CPU copy of the service with the same noise within
    SERVE_TOL, then the p50 of 10 warm requests."""
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.train import synthesis

    variant = trainer.variant
    service = serve.SynthesisService.from_trainer(trainer)
    if service.use_mfcc != (variant != "abl_audio"):
        raise AssertionError(f"{variant}: the service's use_mfcc is {service.use_mfcc}")
    audio, words = clip_audio(10.0, 31), _corpus_words(service.lang)
    n = len(synthesis.plan_subdivisions(10.0, trainer.cfg)[0])
    eps = torch.from_numpy(np.random.default_rng(31).standard_normal((n, 1, 16))
                           .astype(np.float32))
    service.warmup()
    _reset_counters()
    got = service.synthesize(audio, words, vid_idx=1, eps=eps)
    torch.cuda.synchronize()
    counts = _counters()
    mel = counts["mel_power"] + counts["mel_power_mixed"] + counts["mel_dft"]
    cpu = serve.SynthesisService(trainer.cfg, copy.deepcopy(trainer.gen).cpu(), service.lang,
                                 use_mfcc=service.use_mfcc)
    want = cpu.synthesize(audio, words, vid_idx=1, eps=eps)
    err = max(np.abs(got["dir_vec"] - want["dir_vec"]).max(),
              np.abs(got["poses"] - want["poses"]).max())
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        service.synthesize(audio, words, vid_idx=1)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"{variant} service (use_mfcc {service.use_mfcc}), 10 s clip: launches "
        f"{dict(counts)}; card vs CPU copy max_abs_err {err:.3e} (tol {SERVE_TOL}); warm p50 "
        f"{np.median(times):.3f} ms over {len(times)} requests; {smi}")
    if counts["gru_fwd"] < 1 or (mel > 0) != service.use_mfcc:
        raise AssertionError(f"{variant} service launches {dict(counts)}")
    if not (np.isfinite(got["dir_vec"]).all() and err <= SERVE_TOL):
        raise AssertionError(f"{variant}: the card's service disagrees with the CPU's: {err}")
    return counts


def ablation_render_check(trainer, device, smi: str) -> collections.Counter:
    """`generate_gestures_by_dataset` per clip and batched on the abl_audio
    trainer over a test split of SHORT_VIDEOS synthetic videos of
    SHORT_SECONDS (the default 5-12 s range, speakers drawn), with the
    counters set to 0 just before each and read just after: the GRU
    forward must run and no mel kernel (both generators eat raw audio
    windows); batched against per clip within GRU_TOL; the clips/s of each
    way, warm."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch.data import ted_db
    from speech2affective_gestures_torch.train import clip_eval

    long_split = trainer.test_data
    videos = ted_db.make_synthetic_videos(SHORT_VIDEOS, SHORT_SECONDS, seed=11, device=device)
    trainer.test_data = dataclasses.replace(
        ted_db.build_dataset_from_videos(videos, trainer.cfg, lang_model=long_split.lang_model,
                                         keep_sidecars=True, device=device),
        speaker_model=long_split.speaker_model)
    launches, results = collections.Counter(), {}
    try:
        for batched in (False, True):
            way = "batched" if batched else "per clip"
            _reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = clip_eval.generate_gestures_by_dataset(trainer, "ted_db", fade_out=True,
                                                         randomized=True, seed=3,
                                                         batched=batched)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counters()
            launches.update(counts)
            results[way] = res
            mel = counts["mel_power"] + counts["mel_power_mixed"] + counts["mel_dft"]
            log(f"abl_audio render {way}: {len(res)} clips in {wall:.3f} s "
                f"({len(res) / wall:.3f} clips/s); launches {dict(counts)}; {smi}")
            if not res or counts["gru_fwd"] < 1 or mel:
                raise AssertionError(f"abl_audio render {way}: launches {dict(counts)}")
            if not all(np.isfinite(s2ag).all() and np.isfinite(tri).all()
                       for _, (_, tri, s2ag) in res):
                raise AssertionError(f"abl_audio render {way}: a render is not finite")
        err = _max_err(results["batched"], results["per clip"])
        log(f"abl_audio render batched against per clip: max_abs_err {err:.3e} (tol {GRU_TOL})")
        if not err <= GRU_TOL:
            raise AssertionError(f"the abl_audio batched render disagrees: {err}")
        for batched in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = clip_eval.generate_gestures_by_dataset(trainer, "ted_db", fade_out=True,
                                                         randomized=True, seed=3,
                                                         batched=batched)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"abl_audio render {'batched' if batched else 'per clip'}, warm: {len(res)} "
                f"clips in {wall:.3f} s ({len(res) / wall:.3f} clips/s); {smi}")
    finally:
        trainer.test_data = long_split
    return launches


def ablation_phase(device, work: pathlib.Path, embedding_net: pathlib.Path,
                   smi: str) -> collections.Counter:
    """The paper's ablations at full width (`ABLATIONS`): for each, its
    entry point trains one epoch at batch 512 and scores the test split
    with FGD (`training_phase`), at float32 and with `--mixed-precision
    true`; the warm train step's p50, samples/s and device profile of
    each run; one train step at batch 16 against the CPU in float64 and
    float32 (`step_parity_phase`) and the mixed step against the CPU bf16
    path (`mixed_step_parity_phase`); the float32 trainer's service against
    a CPU copy (`ablation_service_check`); and for abl_audio the long-clip
    rendering per clip and batched (`ablation_render_check`). Returns each
    kernel's launches on these paths."""
    launches = collections.Counter()
    p50s = {}
    for variant in ABLATIONS:
        for mixed in (False, True):
            trainer, trained = training_phase(device, work, embedding_net,
                                              mixed_precision=mixed, variant=variant)
            launches.update(trained)
            p50s[(variant, mixed)] = time_train_step(trainer)
            if not mixed:
                launches.update(ablation_service_check(trainer, smi))
                if variant == "abl_audio":
                    launches.update(ablation_render_check(trainer, device, smi))
            del trainer
        step_parity_phase(device, variant=variant)
        mixed_step_parity_phase(device, variant=variant)
    for (variant, mixed), p50 in p50s.items():
        log(f"{variant} train step at batch {TRAIN_BATCH}"
            f"{', mixed precision' if mixed else ''}: p50 {p50:.3f} ms, "
            f"{TRAIN_BATCH / p50 * 1e3:.1f} samples/s; {smi}")
    return launches


def v1_main_phase(device, work: pathlib.Path):
    """`main_v1.main` on the card at its defaults (batch 32): the SER net
    at AttConvRNN's widths on (300, 40, 3) blocks for one epoch of the 64
    random blocks, then the v1 generator at config/multimodal_context_v2.yml
    (hidden 300, 4 layers) and discriminator for one epoch of the synthetic
    corpus. The counters are set to 0 just before and read just after: the
    float32 GRU forward, recurrence and dW, and the mel kernel (the corpus
    build's MFCCs), must have run; every logged loss and the SER's val
    accuracy must be finite. Returns what main trained and the launches."""
    import torch
    from speech2affective_gestures_torch import main_v1
    from speech2affective_gestures_torch.ops import gru_cuda

    base = work / "base_v1"
    argv = ["-b", str(base), "-c", str(CONFIG), "--synthetic-data", "true"]
    log(f"v1 phase: main_v1.main({' '.join(argv)})")
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = main_v1.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tiers = _counters(), _tier_counters()
    B = V1_BATCH
    log(f"main_v1 launches: {dict(launches)}, by tier {dict(tiers)}; main_v1.main took "
        f"{wall:.1f} s in all; the GRU plans at B {B}, float32: forward "
        f"{gru_cuda.fwd_tier(B, 300, torch.float32)} (H 300), "
        f"{gru_cuda.fwd_tier(B, 64, torch.float32)} (H 64), recurrence "
        f"{gru_cuda.bwd_tier(B, 300, torch.float32)} (H 300), "
        f"{gru_cuda.bwd_tier(B, 64, torch.float32)} (H 64)")
    for name in ("gru_fwd", "gru_bwd", "gru_dw", "mel_power"):
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched in main_v1")
    if any(k.endswith("_bf16") and n for k, n in launches.items()):
        raise AssertionError(f"main_v1 ran bf16 kernels: {dict(launches)}")
    if {run.device.type, next(run.ser.parameters()).device.type} != {device.type}:
        raise AssertionError(f"main_v1 ran on {run.device}, not the card")
    lines = (base / "models" / "v1_ser_s2eg" / "log.txt").read_text().splitlines()
    for line in lines:
        log(f"  log: {line}")
    [ser_line] = [x for x in lines if "SER epoch 0: " in x]
    [s2eg_line] = [x for x in lines if "s2eg epoch 0: " in x]
    ser = ser_line.split("SER epoch 0: ")[1].split()
    numbers = [float(ser[1]), float(ser[3])] + [
        float(tok.split(": ")[1]) for tok in s2eg_line.split("s2eg epoch 0: ")[1].split(" | ")]
    if len(numbers) != 8 or not np.isfinite(numbers).all():
        raise AssertionError(f"main_v1 logged {numbers}")
    return run, launches


def ser_step_parity_phase(device) -> None:
    """One SER train step (`ser_trainer.ser_train_step`, main_v1's SGD:
    lr 1e-3, momentum 0.9, Nesterov, weight decay 5e-4) of AttConvRNN at
    full width with the reference init, batch 4, dropout 0, on the card
    and on the CPU plain path from the same weights and blocks: the card's
    loss and accuracy, the row-wise batch norm's running stats and SGD's
    momentum buffers against the CPU float64 step within STEP_TOL
    (`_held_to_float64`; linear1's bias, which that batch norm follows, as
    the BN-fed biases there)."""
    import torch
    from speech2affective_gestures_torch.models.ser import AttConvRNN, apply_reference_init
    from speech2affective_gestures_torch.train import ser_trainer

    torch.manual_seed(0)
    net = apply_reference_init(AttConvRNN(7, dropout_prob=0.0),
                               torch.Generator().manual_seed(42))
    rng = np.random.default_rng(3)
    data = rng.standard_normal((4, 300, 40, 3))
    labels = np.eye(7)[rng.integers(0, 7, 4)]

    def one_step(dev, dtype):
        model = copy.deepcopy(net).to(dev, dtype)
        opt = ser_trainer.make_ser_optimizer(model.parameters())
        t0 = time.perf_counter()
        got = ser_trainer.ser_train_step(
            model, opt, torch.from_numpy(data).to(dev, dtype),
            torch.from_numpy(labels).to(dev, dtype), torch.Generator(device=dev))
        got = {k: float(v) for k, v in got.items()}
        log(f"one SER train step, batch 4, on {dev} in {dtype}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {got}")
        return model, opt, got

    def errors(run, want):
        (model, opt, got), (ref_model, ref_opt, ref_metrics) = run, want
        return {"metrics (relative)": _metric_err(got, ref_metrics),
                "BN stats": _stats_err(ref_model, model),
                "SGD momentum": _moment_err(ref_opt, ref_model, opt, model,
                                            key="momentum_buffer", bn_fed=("linear1.bias",))}

    _held_to_float64(device, "SER step", one_step, errors)


def s2eg_step_parity_phase(device) -> None:
    """One v1 GAN step (`ser_trainer.S2egStep`) of PoseGeneratorV1 at
    config/multimodal_context_v2.yml's widths (hidden 300, 4 layers; 1000
    words, 100 speakers) and AffDiscriminatorV1 (hidden 64), batch 16,
    every dropout at zero, on the card and on the CPU plain path from the
    same weights, batch, emotions, speaker noise and div-reg speaker ids:
    the metrics, both nets' BN stats and Adam first moments against the CPU
    float64 step within STEP_TOL (`_held_to_float64`)."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.models.discriminator import AffDiscriminatorV1
    from speech2affective_gestures_torch.models.generator import PoseGeneratorV1
    from speech2affective_gestures_torch.train import builder, gan_step, ser_trainer

    cfg = ModelConfig.from_yaml(CONFIG)
    n_words, n_speakers, B = 1000, 100, 16
    torch.manual_seed(0)
    init = {"gen": PoseGeneratorV1(n_words=n_words, n_speakers=n_speakers,
                                   hidden_size=cfg.hidden_size, n_layers=cfg.n_layers,
                                   dropout_prob=0.0, emb_dropout=0.0),
            "dis": AffDiscriminatorV1(n_poses=cfg.n_poses, dropout_prob=0.0)}
    gan_cfg = gan_step.GanConfig(learning_rate=cfg.learning_rate, n_speakers=n_speakers)
    rng = np.random.default_rng(4)
    batch = builder.synthetic_batch(rng, B, cfg, n_words, n_speakers)
    batch["emo_labels"] = np.eye(7, dtype=np.float32)[rng.integers(0, 7, B)]
    eps, eps_rand = rng.standard_normal((B, 16)), rng.standard_normal((B, 16))
    other = (batch["vid_indices"] + 1 + rng.integers(0, n_speakers - 1, B)) % n_speakers

    def one_step(dev, dtype):
        models = {k: copy.deepcopy(m).to(dev, dtype) for k, m in init.items()}
        step = ser_trainer.S2egStep(models["gen"], models["dis"], gan_cfg)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in builder.to_device(batch, dev).items()}
        t0 = time.perf_counter()
        got = step.train_step(b, torch.Generator(device=dev).manual_seed(0),
                              eps=torch.from_numpy(eps).to(dev, dtype),
                              eps_rand=torch.from_numpy(eps_rand).to(dev, dtype))
        got = {k: float(v) for k, v in got.items()}
        log(f"one s2eg train step, batch {B}, on {dev} in {dtype}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {got}")
        return models, step, got

    def errors(run, want):
        (models, step, got), (ref_models, ref_step, ref_metrics) = run, want
        return {"metrics (relative)": _metric_err(got, ref_metrics),
                "gen BN stats": _stats_err(ref_models["gen"], models["gen"]),
                "dis BN stats": _stats_err(ref_models["dis"], models["dis"]),
                "gen Adam m": _moment_err(ref_step.gen_opt, ref_models["gen"],
                                          step.gen_opt, models["gen"]),
                "dis Adam m": _moment_err(ref_step.dis_opt, ref_models["dis"],
                                          step.dis_opt, models["dis"])}

    draw = gan_step.draw_other_speaker_ids
    gan_step.draw_other_speaker_ids = (
        lambda g, vids, n: torch.as_tensor(other, device=vids.device))
    try:
        _held_to_float64(device, "s2eg step", one_step, errors)
    finally:
        gan_step.draw_other_speaker_ids = draw


def _p50_and_profile(label: str, fn, smi: str, n: int = 6) -> float:
    """p50 of fn on the card (host clock, each call ended by a
    synchronize) after one warm call, then its device profile."""
    import torch

    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    log(f"{label}: p50 {p50:.3f} ms over {n}; all {[round(t, 3) for t in times]}; {smi}")
    profile_device(label, "call", fn, n=3)
    return p50


def v1_phase(device, work: pathlib.Path, smi: str) -> collections.Counter:
    """The v1 pipeline (`main_v1`): trained on the card at its defaults
    (`v1_main_phase`); one SER step and one s2eg step against the CPU
    (`ser_step_parity_phase`, `s2eg_step_parity_phase`); then, on what
    main_v1 trained, each warm step's p50 and device profile at batch 32:
    the SER train step, the s2eg step, and the SER forward on the zero
    blocks that condition the GAN. Returns the kernels' launches in
    main_v1."""
    import torch
    from speech2affective_gestures_torch.data.ted_db import BatchSampler
    from speech2affective_gestures_torch.train import builder, ser_trainer

    t0 = time.perf_counter()
    run, launches = v1_main_phase(device, work)
    ser_step_parity_phase(device)
    s2eg_step_parity_phase(device)

    B = V1_BATCH
    g = torch.Generator(device=device).manual_seed(7)
    rng = np.random.default_rng(7)
    blocks = torch.from_numpy(rng.standard_normal((B, 300, 40, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(np.eye(7, dtype=np.float32)[rng.integers(0, 7, B)]).to(device)
    zeros = torch.zeros((B, 300, 40, 3), device=device)
    no_labels = torch.zeros((B, 7), device=device)
    batch = builder.to_device(next(iter(BatchSampler(run.dataset, B, seed=5))), device)
    batch["emo_labels"] = ser_trainer.ser_eval_step(run.ser, zeros, no_labels)[1]
    p50s = {
        "SER train step": _p50_and_profile(
            f"SER train step (batch {B}, full width)",
            lambda: ser_trainer.ser_train_step(run.ser, run.ser_opt, blocks, labels, g), smi),
        "s2eg step": _p50_and_profile(
            f"s2eg train step (batch {B}, full width)",
            lambda: run.s2eg.train_step(batch, g), smi),
        "SER forward on the zero blocks": _p50_and_profile(
            f"SER forward on the zero blocks (batch {B})",
            lambda: ser_trainer.ser_eval_step(run.ser, zeros, no_labels), smi),
    }
    log(f"v1 phase: {', '.join(f'{k} p50 {v:.3f} ms' for k, v in p50s.items())} at batch {B}; "
        f"{smi}; the phase took {time.perf_counter() - t0:.1f} s")
    return launches


def _step_differences(a, b) -> list[str]:
    """What differs, bit for bit, between two train steps' (metrics, step,
    generator state): the metrics, both nets' parameters and buffers (BN
    running stats and counts), their Adam states, the generator's state."""
    import torch

    (ma, sa, ga), (mb, sb, gb) = a, b
    out = [k for k in ma if k not in mb or not torch.equal(ma[k], mb[k])]
    for who in ("gen", "dis"):
        da, db = getattr(sa, who).state_dict(), getattr(sb, who).state_dict()
        out += [f"{who} {k}" for k in da if not torch.equal(da[k], db[k])]
        oa, ob = getattr(sa, f"{who}_opt"), getattr(sb, f"{who}_opt")
        for (name, p), q in zip(getattr(sa, who).named_parameters(), getattr(sb, who).parameters()):
            out += [f"{who} Adam {k} of {name}" for k in oa.state[p]
                    if not torch.equal(oa.state[p][k], ob.state[q][k])]
    if not torch.equal(ga, gb):
        out.append("the generator's state")
    return out


def _unrepeatable_gradients(init: dict, batch: dict, device) -> dict:
    """For D (on the batch's poses) and G (with the noise drawn from a
    generator), one train-mode forward and backward run twice from the
    same weights, inputs and generator state: the parameters whose
    gradients differ between the two, by net, each with its module's
    class (where a repeated step parts, the op that does not repeat)."""
    import torch
    from speech2affective_gestures_torch import constants as C
    from speech2affective_gestures_torch.models import layers as L
    from speech2affective_gestures_torch.train import gan_step

    out = {}
    for who in ("dis", "gen"):
        grads = []
        for _ in range(2):
            model = copy.deepcopy(init[who]).train()
            g = torch.Generator(device=device).manual_seed(14)
            with L.dropout_rng(g):
                if who == "dis":
                    y = model(batch["vec_seq"], batch["extended_word_seq"])
                else:
                    y = model(gan_step.build_pre_seq(batch["vec_seq"], C.N_PRE_POSES),
                              batch["extended_word_seq"], batch["mfcc_features"],
                              batch["vid_indices"], None, g)[0]
                y.square().sum().backward()
            grads.append({n: p.grad for n, p in model.named_parameters()
                          if p.grad is not None})
        out[who] = [f"{n} ({type(model.get_submodule(n.rpartition('.')[0])).__name__})"
                    for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]
    return out


def remat_parity_phase(device) -> None:
    """Remat against the plain step on the card: one train step at full
    width, batch TRAIN_BATCH, the config's dropout (0.3, the text
    embedding's 0.1), the noise and masks drawn from the step's generator,
    from the same weights, batch and generator state, under `none`,
    `full` and `dots` in float32 and under `none` and `full` in mixed
    precision: each remat step must equal the plain step bit for bit
    (`_step_differences`). The plain step runs twice first; if the two
    differ, the comparison is made under `torch.backends.cudnn.deterministic
    = True`, and fails if they still differ."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.train import builder, gan_step

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    n_words, n_speakers = 1000, 100
    init = builder.init_training(cfg, 0, n_words, n_speakers, device=device)
    batch = builder.to_device(builder.synthetic_batch(
        np.random.default_rng(14), TRAIN_BATCH, cfg, n_words, n_speakers), device)

    def one_step(remat, mixed):
        models = {k: copy.deepcopy(init[k]) for k in ("gen", "dis", "tri")}
        step = gan_step.GanStep(
            models["gen"], models["dis"], dataclasses.replace(init["gan_cfg"], remat=remat),
            models["tri"], train_apply=builder.mixed_precision_apply if mixed else None)
        g = torch.Generator(device=device).manual_seed(14)
        metrics = step.train_step(batch, g, gan_on=True)
        torch.cuda.synchronize()
        return metrics, step, g.get_state()

    deterministic = torch.backends.cudnn.deterministic
    try:
        for mixed, modes in ((False, ("full", "dots")), (True, ("full",))):
            label = "mixed-precision" if mixed else "float32"
            plain = one_step("none", mixed)
            diff = _step_differences(plain, one_step("none", mixed))
            if diff and not torch.backends.cudnn.deterministic:
                log(f"two plain {label} steps differ in {len(diff)} tensors: {diff[:16]}; "
                    "the parameters whose gradients differ between two identical "
                    f"backward passes: {_unrepeatable_gradients(init, batch, device)}; "
                    "again under torch.backends.cudnn.deterministic = True")
                torch.backends.cudnn.deterministic = True
                plain = one_step("none", mixed)
                diff = _step_differences(plain, one_step("none", mixed))
            setting = ("torch.backends.cudnn.deterministic = True"
                       if torch.backends.cudnn.deterministic else "the default cuDNN settings")
            log(f"two plain {label} steps at batch {TRAIN_BATCH} under {setting}: "
                f"{'the same bits' if not diff else f'{len(diff)} tensors differ: {diff[:16]}'}")
            if diff:
                raise AssertionError(f"the plain {label} step is not repeatable on the card")
            for mode in modes:
                got = one_step(mode, mixed)
                diff = _step_differences(plain, got)
                log(f"remat {mode} {label} step against the plain one at batch {TRAIN_BATCH}, "
                    f"dropout {cfg.dropout_prob}, under {setting}: "
                    f"{'the same bits' if not diff else f'{len(diff)} tensors differ: {diff[:16]}'}"
                    f" (metrics {[(k, float(v)) for k, v in got[0].items()]})")
                if diff:
                    raise AssertionError(f"remat {mode} changed the {label} step: {diff[:16]}")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def step_numbers(device, smi: str) -> None:
    """Each warm train step's p50 over 6 steps, its peak device memory over
    them (`torch.cuda.max_memory_allocated`) and its device profile over
    one step (busy share, launches), at full width and batch TRAIN_BATCH,
    float32 and mixed precision: the plain step beside the fused one and
    remat full and dots; then the GRU plans at the fused batch FUSED_B."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.ops import gru_cuda
    from speech2affective_gestures_torch.train import builder, gan_step

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    n_words, n_speakers = 1000, 100
    init = builder.init_training(cfg, 0, n_words, n_speakers, device=device)
    batch = builder.to_device(builder.synthetic_batch(
        np.random.default_rng(15), TRAIN_BATCH, cfg, n_words, n_speakers), device)
    summary = []
    for mixed in (False, True):
        for label, options in (("plain", {}), ("fused", {"fused_pass": True}),
                               ("remat full", {"remat": "full"}),
                               ("remat dots", {"remat": "dots"})):
            label = f"{label} {'mixed-precision' if mixed else 'float32'}"
            step = gan_step.GanStep(
                init["gen"], init["dis"], dataclasses.replace(init["gan_cfg"], **options),
                init["tri"], train_apply=builder.mixed_precision_apply if mixed else None)
            g = torch.Generator(device=device).manual_seed(15)

            def fn(step=step, g=g):
                return step.train_step(batch, g, gan_on=True)

            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(6):
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            p50 = float(np.median(times))
            log(f"{label} train step (batch {TRAIN_BATCH}, full width): p50 {p50:.3f} ms over "
                f"6; all {[round(t, 3) for t in times]}; peak memory {peak:.3f} GiB; {smi}")
            profile_device(f"the {label} train step", "step", fn, n=1)
            summary.append(f"{label} p50 {p50:.3f} ms, peak {peak:.3f} GiB")
            del step
    log(f"train steps at batch {TRAIN_BATCH}: {'; '.join(summary)}; {smi}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for H in (300, 64):
            log(f"GRU plans at B {FUSED_B}, H {H}, {gru_cuda._dtype_name(dtype)}: forward "
                f"{gru_cuda._device_plan(device, FUSED_B, H, 2, dtype)}, recurrence "
                f"{gru_cuda._device_bwd_plan(device, FUSED_B, H, 2, dtype)}, dW "
                f"{gru_cuda.dw_plan(34, FUSED_B, H, 2, sms, itemsize=dtype.itemsize)}")


def step_options_phase(device, work: pathlib.Path, embedding_net: pathlib.Path,
                       smi: str) -> collections.Counter:
    """`main_v2`'s step options on the card: `main_v2` at full width with
    each of STEP_OPTIONS (`training_phase`: one epoch of the synthetic
    corpus, the test split scored; the counters set to 0 just before and
    read just after each: the GRU forward, recurrence and dW at the run's
    dtype, and the mel kernel in the corpus build; with the fused pass the
    three GRU kernels at B FUSED_B, H 300, without it none at B FUSED_B;
    every logged loss finite); remat against the plain step bit for bit
    (`remat_parity_phase`); the fused step of s2ag and of abl_aff against
    the CPU float64 fused step (`step_parity_phase`); each step's p50,
    profile and peak memory (`step_numbers`). Returns the kernels'
    launches in the main_v2 runs."""
    t0 = time.perf_counter()
    parts = {}
    launches = collections.Counter()
    for options, mixed in STEP_OPTIONS:
        trainer, trained = training_phase(device, work, embedding_net, mixed_precision=mixed,
                                          options=options)
        fused = options[0] == "--fused-pass"
        want = (True, "none") if fused else (False, options[1])
        if (trainer.gan_cfg.fused_pass, trainer.gan_cfg.remat) != want:
            raise AssertionError(f"main_v2 {' '.join(options)} trained with {trainer.gan_cfg}")
        if trained["mel_power"] < 1:
            raise AssertionError(f"main_v2 {' '.join(options)}: the corpus build ran no mel "
                                 "kernel")
        sfx = "_bf16" if mixed else ""
        at_b = {k: trained[f"{k}_b{FUSED_B}{sfx}"] for k in ("gru_fwd", "gru_bwd", "gru_dw")}
        log(f"main_v2 {' '.join(options)}{' --mixed-precision true' if mixed else ''}: GRU "
            f"launches at B {FUSED_B}, H 300 {at_b}; mel {trained['mel_power']}")
        if (fused and min(at_b.values()) < 1) or (not fused and any(at_b.values())):
            raise AssertionError(f"main_v2 {' '.join(options)}: GRU launches at B {FUSED_B} "
                                 f"{at_b}")
        launches.update(trained)
        del trainer
    parts["main_v2 runs"] = time.perf_counter() - t0
    remat_parity_phase(device)
    parts["remat parity"] = time.perf_counter() - t0 - sum(parts.values())
    for variant in ("s2ag", "abl_aff"):
        step_parity_phase(device, variant=variant, fused_pass=True)
    parts["fused step parity"] = time.perf_counter() - t0 - sum(parts.values())
    step_numbers(device, smi)
    parts["step numbers"] = time.perf_counter() - t0 - sum(parts.values())
    log(f"step options phase took {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())}); {smi}")
    return launches


def _program_setup(device, options: dict, seed: int = 16):
    """A train step at full width (`builder.init_training` from seed 0,
    the GAN terms on) with `options` on its `GanConfig` (and "mixed" for
    mixed precision), a random packed split of SCAN_ROWS rows on the card
    (`builder.synthetic_packed`) and a step generator from `seed`."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.ted_db import DeviceDataset
    from speech2affective_gestures_torch.train import builder

    options = dict(options)
    mixed = options.pop("mixed", False)
    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    setup = builder.init_training(cfg, 0, 1000, 100, device=device, mixed_precision=mixed)
    step = setup["step"]
    step.cfg = dataclasses.replace(step.cfg, **options)
    data = DeviceDataset(builder.synthetic_packed(np.random.default_rng(seed), SCAN_ROWS, cfg),
                         device)
    return step, data, torch.Generator(device=device).manual_seed(seed)


def _program_draws(rng, k: int):
    """(k, TRAIN_BATCH) rows of the random split and speakers."""
    return rng.integers(0, SCAN_ROWS, (k, TRAIN_BATCH)), rng.integers(0, 100, (k, TRAIN_BATCH))


def capturable_adam_phase(device) -> None:
    """Both nets' Adam updates (`GanStep._update`: clipping at 0.1, the
    update, the next rate; the rate halving every 2 updates) of a
    capturable train step at full width, captured into one CUDA graph and
    replayed, against the host Adam of the same step (PyTorch's
    non-capturable Adam, its rate `scheduled_lr` on the host), over 7
    updates from the same weights with the same random gradients (the
    first update eager: the capture's warm-up). After every update the
    moments must be the same bits (the same ops on the same gradients),
    the counts equal, the float32 rate the host rate's rounding, and every
    parameter within n updates x (CAP_ULPS of its tensor's largest value +
    CAP_LR of the base rate): the two compute the bias corrections in
    another order, a few roundings of an update, and each update may round
    to the next float32. A wrong bias correction or a rate off by one
    decay step moves a parameter by about a rate."""
    import dataclasses

    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.train import builder, gan_step

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    cap, host = (builder.init_training(cfg, 0, 1000, 100, device=device)["step"]
                 for _ in range(2))
    for step in (cap, host):
        step.cfg = dataclasses.replace(step.cfg, lr_decay=0.5, decay_steps_per_epoch=2,
                                       gradient_clip=0.1)
    cap.make_capturable()
    params = {w: [[p for p in getattr(s, w).parameters() if p.requires_grad]
                  for s in (cap, host)] for w in ("gen", "dis")}
    for w in params:
        for p, q in zip(*params[w]):
            if not torch.equal(p, q):
                raise AssertionError(f"the two steps start from other {w} weights")
            p.grad, q.grad = torch.empty_like(p), torch.empty_like(q)
    rng = torch.Generator(device=device).manual_seed(5)
    graph, worst = None, {}
    for n in range(1, 8):
        for w in params:
            for p, q in zip(*params[w]):
                p.grad.normal_(generator=rng)
                q.grad.copy_(p.grad)
        if graph is None:
            cap._update("gen")
            cap._update("dis")
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                cap._update("gen")
                cap._update("dis")
        else:
            graph.replay()
        host._update("gen")
        host._update("dis")
        torch.cuda.synchronize()
        for w, base in (("gen", cap.cfg.learning_rate), ("dis", cap.cfg.lr_dis)):
            opt, ref = getattr(cap, f"{w}_opt"), getattr(host, f"{w}_opt")
            want = gan_step.scheduled_lr(base, cap.cfg, n)
            for p, q in zip(*params[w]):
                same = all(torch.equal(opt.state[p][k], ref.state[q][k])
                           for k in ("exp_avg", "exp_avg_sq"))
                counts = (opt.state[p]["step"].item(), ref.state[q]["step"].item())
                err = (p - q).abs().max().item() / (
                    n * (CAP_ULPS * q.abs().max().item() + CAP_LR * base))
                worst[w] = max(worst.get(w, 0.0), err)
                if not same or counts != (n, n) or err > 1:
                    raise AssertionError(
                        f"capturable Adam ({w}, update {n}): moments the same bits {same}, "
                        f"counts {counts}, parameter distance {err:.3e} of its bound")
            rates = [float(g["lr"]) for g in opt.param_groups] + [
                g["lr"] for g in ref.param_groups]
            if rates != [float(np.float32(want))] * len(opt.param_groups) + [want] * len(
                    ref.param_groups):
                raise AssertionError(f"capturable Adam ({w}, update {n}): rates {rates}, "
                                     f"the schedule's {want}")
    log(f"capturable Adam captured in a CUDA graph against the host Adam, full width, 7 "
        f"updates of both nets on the same random gradients (clipped at 0.1, the rate "
        f"halving every 2 updates): moments the same bits, counts and rates the schedule's; "
        f"parameters at most {', '.join(f'{w} {v:.3e}' for w, v in worst.items())} of "
        f"their bound (n x ({CAP_ULPS:.3e} of the tensor's largest + {CAP_LR} lr))")


def _optimizer_snapshot(step) -> dict:
    """Of both nets of `step`: copies of the parameters, of each one's
    Adam state and of the learning rates."""
    out = {}
    for w in ("gen", "dis"):
        opt, params = getattr(step, f"{w}_opt"), list(getattr(step, w).parameters())
        out[w] = ([p.detach().clone() for p in params],
                  [{k: v.clone() for k, v in opt.state.get(p, {}).items()} for p in params],
                  [float(g["lr"]) for g in opt.param_groups])
    return out


def _first_step_errors(got: dict, want: dict, cfg, mixed: bool) -> tuple[dict, dict]:
    """The graphs' first step (`_optimizer_snapshot` after it) against the
    per-step loop's (host Adam): {name: error over its tolerance}. D's
    gradients are the same bits (the same weights, batch and draws), so
    its moments must be too and its parameters within one update's
    rounding (CAP_ULPS, CAP_LR, as `capturable_adam_phase`); G's gradients
    pass through D's updated weights, so its first moments are held within
    STEP_TOL (`_moment_err`'s rule for the tensors whose moment is float
    noise), in float32; in mixed precision, where D's rounding moves its
    bf16 casts, they are logged (as `mixed_step_parity_phase` does); every
    count 1 and each rate the schedule's for the next update (its float32
    where the graph keeps it on the device). Returns ({name: error over
    its tolerance}, {name: error logged only})."""
    import torch

    from speech2affective_gestures_torch.train.gan_step import scheduled_lr

    errs, logged = {}, {}
    for w, base in (("gen", cfg.learning_rate), ("dis", cfg.lr_dis)):
        (params, states, rates), (ref_params, ref_states, ref_rates) = got[w], want[w]
        pairs = [(a, b) for a, b in zip(states, ref_states) if b]
        counts = {float(s["step"]) for pair in pairs for s in pair}
        errs[f"{w} counts"] = 0.0 if counts == {1.0} else np.inf
        rate = scheduled_lr(base, cfg, 1)
        graph_rate = float(np.float32(rate)) if cfg.decays else rate
        errs[f"{w} rates"] = 0.0 if ref_rates == [rate] * len(ref_rates) and rates == [
            graph_rate] * len(rates) else np.inf
        if w == "dis":
            same = all(torch.equal(a[k], b[k]) for a, b in pairs for k in ("exp_avg",
                                                                           "exp_avg_sq"))
            errs["dis Adam moments"] = 0.0 if same else np.inf
            errs["dis parameters"] = max(
                (p - q).abs().max().item() / (CAP_ULPS * q.abs().max().item() + CAP_LR * base)
                for p, q in zip(params, ref_params))
            continue
        m = [(a["exp_avg"], b["exp_avg"]) for a, b in pairs]
        top = max(b.abs().max().item() for _, b in m)
        (logged if mixed else errs)["gen Adam m"] = max(
            (a - b).abs().max().item()
            / (b.abs().max().item() if b.abs().max().item() >= 1e-4 * top else top)
            for a, b in m) / STEP_TOL
    return errs, logged


def _metrics_errors(got: dict, want: dict, n_steps: int, tol: float) -> float:
    """The largest `_metric_err` at `tol` of n_steps steps' metrics
    ({name: (n,)}) over `tol`."""
    return max(_metric_err({k: float(v[j]) for k, v in got.items()},
                           {k: float(v[j]) for k, v in want.items()}, tol)
               for j in range(n_steps)) / tol


def graph_parity_phase(device) -> None:
    """The K-step program's CUDA graphs at full width and batch
    TRAIN_BATCH, under `cudnn.deterministic`, the partial program of 1
    step then a program of 2 from the same weights, rows and generator
    seed, for each of SCAN_PARITY's settings (the config's dropout, the
    noise drawn from the step's generator):
    - against the same body run eagerly on the card
      (`StepProgram(capture=False)`, the same capturable Adams): the
      metrics, both nets' parameters and buffers, Adam's states and
      learning rates, the generator's state the same bits
      (`_step_differences`);
    - against the per-step loop (`GanStep.train_step` on the same batches,
      PyTorch's host Adam with the host schedule: the path the CPU tests
      hold to the JAX package), which rounds Adam's update otherwise:
      after the first step, D's moments the same bits and its parameters
      within an update's rounding, G's first moments within STEP_TOL in
      float32, the counts and rates the schedule's (`_first_step_errors`);
      every step's metrics within STEP_TOL (MP_TOL in mixed precision, as
      `mixed_step_parity_phase`). Past the first step the two runs' weights
      part as Adam amplifies the rounding (the measurements in PERF.md),
      so the weights after 3 steps are logged, not held."""
    import torch
    from speech2affective_gestures_torch.data.ted_db import gather
    from speech2affective_gestures_torch.train.step_program import StepProgram

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, options in SCAN_PARITY:
            runs, first = {}, {}
            for how in ("graph", "eager", "per step"):
                step, data, g = _program_setup(device, options)
                init = {w: [p.detach().clone() for p in getattr(step, w).parameters()]
                        for w in ("gen", "dis")}
                rng = np.random.default_rng(17)
                program = (StepProgram(step, data, g, capture=how == "graph")
                           if how != "per step" else None)
                metrics = collections.defaultdict(list)
                for k in (1, 2):
                    idx, adv = _program_draws(rng, k)
                    if program is not None:
                        keys, values = program.run(idx, adv, gan_on=True)
                        for key, v in zip(keys, values.T):
                            metrics[key].append(v)
                    else:
                        for j in range(k):
                            rows, vids = data.indices(idx[j], adv[j])
                            out = step.train_step(gather(data.arrays, rows, vids), g,
                                                  gan_on=True)
                            for key, v in out.items():
                                metrics[key].append(v[None])
                    if k == 1:
                        first[how] = _optimizer_snapshot(step)
                torch.cuda.synchronize()
                runs[how] = ({key: torch.cat(v) for key, v in metrics.items()}, step,
                             g.get_state())
                if program is not None:
                    runs[how] += (program,)
            diff = _step_differences(runs["graph"][:3], runs["eager"][:3])
            lrs = [[torch.as_tensor(grp["lr"]) for grp in getattr(r[1], f"{w}_opt").param_groups]
                   for r in (runs["graph"], runs["eager"]) for w in ("gen", "dis")]
            if not all(torch.equal(a, b) for a, b in zip(sum(lrs[:2], []), sum(lrs[2:], []))):
                diff.append("the learning rates")
            record = runs["graph"][3].launch_record()
            (got, step, _), (ref, ref_step, _) = runs["graph"][:3], runs["per step"]
            mixed = options.get("mixed", False)
            errs, logged = _first_step_errors(first["graph"], first["per step"], step.cfg,
                                              mixed)
            errs["metrics of 3 steps"] = _metrics_errors(got, ref, 3,
                                                         MP_TOL if mixed else STEP_TOL)
            apart = {w: max((p.detach() - q.detach()).abs().max().item()
                            / (q.detach() - p0).abs().max().item()
                            for p, q, p0 in zip(getattr(step, w).parameters(),
                                                getattr(ref_step, w).parameters(), init[w])
                            if (q.detach() - p0).abs().max().item() > 0)
                     for w in ("gen", "dis")}
            log(f"K-step graph ({label}) against its K eager steps at batch {TRAIN_BATCH}, "
                f"under cudnn.deterministic: "
                f"{'the same bits' if not diff else f'{len(diff)} tensors differ: {diff[:16]}'}; "
                f"graphs {[(key, dict(n), r) for key, (n, r) in record.items()]}; against the "
                f"per-step loop (host Adam), each of its tolerance: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + "".join(f", {k} {v:.3e} (logged)" for k, v in logged.items())
                + "; the parameters after 3 steps apart by at most "
                + ", ".join(f"{w} {v:.3e}" for w, v in apart.items())
                + " of their tensor's change from the start (not held)")
            if diff:
                raise AssertionError(f"the K-step graph ({label}) is not its eager steps: "
                                     f"{diff[:16]}")
            if not all(v <= 1 for v in errs.values()):
                raise AssertionError(f"the K-step graph ({label}) is not the per-step loop: "
                                     f"{errs}")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _replay_launches(label: str, program, k: int, got) -> None:
    """The GRU kernels' launches that the profiler saw in one replay of
    the K-step graph (`profile_device`'s kernel names, GRU_SYMBOLS) against
    those its capture recorded (`StepProgram.launch_record`), which the
    launch counters add at every replay: they must be equal."""
    if got is None:
        raise AssertionError(f"{label}: the profiler saw no device work in a replay; the "
                             "graph's launches are not measured")
    per_replay = program.launch_record()[(k, True)][0]
    seen, want = {}, {}
    for family, pattern in GRU_SYMBOLS.items():
        want[family] = sum(n for (kernel, _), n in per_replay.items()
                           if kernel in (family, f"{family}_v1"))
        seen[family] = sum(n for name, n in got[3].items() if re.search(pattern, name))
    log(f"{label}: GRU launches in one replay of the {k}-step graph, seen by the profiler "
        f"{seen}, recorded at capture {want}")
    if seen != want:
        raise AssertionError(f"{label}: a replay launched {seen}, its capture recorded {want}")


def scanned_numbers(device, smi: str) -> None:
    """The train step's p50 at full width and batch TRAIN_BATCH, float32
    and mixed precision, one step at a time (`GanStep.train_step` on
    batches gathered on the card, host Adam: the per-step loop) against
    the K-step program at K 1 and K SCAN_K (one CUDA graph a program):
    per step, the p50 over 6 programs (host clock, each ended by a
    synchronize) divided by K; launches per step and the device's busy
    share from the profiler over one program, whose GRU launches must be
    those the graph's capture recorded (`_replay_launches`); the peak
    device memory allocated and reserved, from before the graphs' capture
    on."""
    import torch
    from speech2affective_gestures_torch.data.ted_db import gather
    from speech2affective_gestures_torch.train.step_program import StepProgram

    summary = []
    for mixed in (False, True):
        for k in (0, 1, SCAN_K):
            label = (f"{'per-step loop' if k == 0 else f'K {k} graph'} "
                     f"{'mixed-precision' if mixed else 'float32'}")
            # the last setting's graphs and their pools are gone before the
            # peaks are reset
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step, data, g = _program_setup(device, {"mixed": mixed})
            rng = np.random.default_rng(18)
            if k == 0:
                def fn(step=step, data=data, g=g, rng=rng):
                    idx, adv = _program_draws(rng, 1)
                    rows, vids = data.indices(idx[0], adv[0])
                    return step.train_step(gather(data.arrays, rows, vids), g, gan_on=True)
            else:
                program = StepProgram(step, data, g)

                def fn(program=program, rng=rng, k=k):
                    return program.run(*_program_draws(rng, k), gan_on=True)
            fn()
            fn()
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / max(k, 1))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            reserved = torch.cuda.max_memory_reserved() / 2 ** 30
            p50 = float(np.median(times))
            log(f"{label} train step (batch {TRAIN_BATCH}, full width): p50 {p50:.3f} ms per "
                f"step over 6 programs; all {[round(t, 3) for t in times]}; peak memory "
                f"{peak:.3f} GiB allocated, {reserved:.3f} GiB reserved; {smi}")
            unit = "step" if k <= 1 else f"program of {k} steps"
            got = profile_device(f"the {label} train step", unit, fn, n=1)
            if k:
                _replay_launches(label, program, k, got)
            per_step = "" if got is None else (
                f", {got[0] / max(k, 1):.0f} launches/step, busy {100 * got[1] / got[2]:.1f}%")
            summary.append(f"{label} p50 {p50:.3f} ms/step{per_step}, peak {peak:.3f} GiB "
                           f"({reserved:.3f} reserved)")
            del step, data, g, fn
            program = None
    log(f"train steps at batch {TRAIN_BATCH}, one at a time and as K-step graphs: "
        f"{'; '.join(summary)}; {smi}")


def scanned_epoch_phase(device, work: pathlib.Path, embedding_net: pathlib.Path,
                        smi: str) -> collections.Counter:
    """`main_v2 --steps-per-program SCAN_SPP` on the card (`training_phase`
    with each of SCAN_RUNS: one epoch of the synthetic corpus, 3 train
    steps, so a program of 2 and the partial one of 1, each its own CUDA
    graph replayed once; the test split scored): the trainer must have run
    the scanned engine with no fallback and logged it; every logged loss
    finite; each graph's capture must have recorded the GRU forward,
    recurrence and dW (the launch counters add those at every replay;
    `scanned_numbers` holds a replay's launches, seen by the profiler, to
    its record). Then the capturable Adam against the host Adam
    (`capturable_adam_phase`), the graphs against their eager steps and the
    per-step loop (`graph_parity_phase`) and the step's numbers, one at a
    time and as graphs (`scanned_numbers`). Returns the kernels' launches
    in the main_v2 runs."""
    t0 = time.perf_counter()
    parts = {}
    launches = collections.Counter()
    for flags, mixed in SCAN_RUNS:
        options = ("--steps-per-program", str(SCAN_SPP), *flags)
        trainer, trained = training_phase(device, work, embedding_net, mixed_precision=mixed,
                                          options=options)
        label = f"main_v2 {' '.join(options)}{' --mixed-precision true' if mixed else ''}"
        log_txt = (pathlib.Path(trainer.work_dir) / "log.txt").read_text()
        if (trainer.epoch_engine != "scanned" or trainer.epoch_engine_fallback
                or "engine scanned)" not in log_txt):
            raise AssertionError(f"{label} did not run the scanned epoch: "
                                 f"{trainer.epoch_engine} ({trainer.epoch_engine_fallback})")
        program = trainer._program
        record = program.launch_record()
        if sorted(record) != [(1, True), (SCAN_SPP, True)] or any(
                replays != 1 for _, replays in record.values()):
            raise AssertionError(f"{label}: graphs {record}")
        dtype = "bfloat16" if mixed else "float32"
        sfx = "_bf16" if mixed else ""
        for kernel in ("gru_fwd", "gru_bwd", "gru_dw"):
            per_replay = {key: n[(kernel, dtype)] for key, (n, _) in record.items()}
            log(f"{label}: {kernel}{sfx} launches in training {trained[kernel + sfx]}: "
                f"warm-ups {program.warmup_launches[(kernel, dtype)]}, per replay {per_replay}")
            if min(per_replay.values()) < 1:
                raise AssertionError(f"{label}: a graph holds no {kernel}{sfx}: {per_replay}")
        launches.update(trained)
        del trainer, program
    parts["main_v2 runs"] = time.perf_counter() - t0
    capturable_adam_phase(device)
    parts["capturable Adam"] = time.perf_counter() - t0 - sum(parts.values())
    graph_parity_phase(device)
    parts["graph parity"] = time.perf_counter() - t0 - sum(parts.values())
    scanned_numbers(device, smi)
    parts["step numbers"] = time.perf_counter() - t0 - sum(parts.values())
    log(f"scanned epoch phase took {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())}); {smi}")
    return launches


# the MFU phase: the tests' pinned count of one full-width step at batch 128
# (tests/test_torch_flops.py, the JAX package's 427,243,749,959 within 2%),
# the engines it times (label, mixed precision, K steps a graph or 0 for
# the per-step loop) with their windows (in programs) and repeats
MFU_PINNED_B128 = 427_243_749_959
MFU_ENGINES = (("float32 per-step loop", False, 0, (4, 12)),
               ("float32 K 4 graph", False, SCAN_K, (2, 6)),
               ("mixed K 4 graph", True, SCAN_K, (2, 6)))
MFU_REPS = 3


def _gru_families(counts: collections.Counter) -> dict:
    """The GRU forward's, recurrence's and dW's launches in `counts`, each
    family over its float32 and bf16 instances."""
    return {f: counts[f] + counts[f + "_bf16"] for f in ("gru_fwd", "gru_bwd", "gru_dw")}


def _trace_kernels(path: pathlib.Path) -> dict:
    """GRU kernel events in a Chrome trace written by `profiling.trace`, by
    family (GRU_SYMBOLS)."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {f: sum(1 for n in names if re.search(pat, n)) for f, pat in GRU_SYMBOLS.items()}


def mfu_phase(device, smi: str) -> collections.Counter:
    """The full-width train step's MFU (`train/flops.py`, `train/timing.py`,
    `train/profiling.py`): the canonical count of one step at batch
    TRAIN_BATCH (fake tensors on the host; within 2% of 4x the tests'
    pinned batch-128 count), the card's measured dense-product peak at
    bf16 and at float32 with TF32 off (`measure_peak_flops`, at most 1.05x
    the data sheet's), each engine of MFU_ENGINES timed by
    `time_compiled_step` (the two-window slope, value-fetch barriers) and
    its MFU against the spec peak of its precision and against the
    measured one (at most 1). The GRU forward, recurrence and dW must run
    in the timed steps (the launch counters, reset before each engine's
    timing; a graph's replays add its capture's record, and one replay's
    launches seen by the profiler must equal that record,
    `_replay_launches`). Then one `profiling.trace` of two eager steps,
    whose trace file must name the GRU kernels. Returns the launches of
    the timed steps."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.ted_db import gather
    from speech2affective_gestures_torch.train import flops, profiling, timing
    from speech2affective_gestures_torch.train.step_program import StepProgram

    t_phase = time.perf_counter()
    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    t0 = time.perf_counter()
    step_flops = flops.canonical_train_step_flops(cfg, TRAIN_BATCH)
    want = MFU_PINNED_B128 * TRAIN_BATCH / 128
    log(f"MFU: canonical flops of one train step (batch {TRAIN_BATCH}, full width, D and G "
        f"updates): {step_flops:.0f} ({step_flops / want - 1:+.4%} from 4x the tests' pinned "
        f"batch-128 count {MFU_PINNED_B128}), counted in {time.perf_counter() - t0:.1f} s "
        f"on the host; {smi}")
    if abs(step_flops / want - 1) > 0.02:
        raise AssertionError(f"MFU: the step's count {step_flops:.0f} is more than 2% from "
                             f"{want:.0f}")
    spec = {"float32": PEAK_F32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}
    peaks = {}
    for name, dtype, windows, reps in (("bfloat16", torch.bfloat16, (200, 600), 5),
                                       ("float32", torch.float32, (50, 150), 3)):
        t0 = time.perf_counter()
        peaks[name] = timing.measure_peak_flops(4096, dtype, windows, reps, device)
        log(f"MFU: measured {name} peak (4096^3 products, windows {windows}, {reps} reps, "
            f"TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}): "
            f"{peaks[name] / 1e12:.3f} TFLOP/s, {peaks[name] / spec[name]:.4f} of the data "
            f"sheet's {spec[name] / 1e12:.0f} ({time.perf_counter() - t0:.1f} s); {smi}")
        if peaks[name] > 1.05 * spec[name]:
            raise AssertionError(f"MFU: a measured {name} peak above 1.05x the data sheet's: "
                                 f"{peaks[name]:.4g}")
    launches = collections.Counter()
    summary = []
    for label, mixed, k, windows in MFU_ENGINES:
        step, data, g = _program_setup(device, {"mixed": mixed}, seed=19)
        rng = np.random.default_rng(19)
        if k == 0:
            def run(_, step=step, data=data, g=g, rng=rng):
                idx, adv = _program_draws(rng, 1)
                rows, vids = data.indices(idx[0], adv[0])
                return step.train_step(gather(data.arrays, rows, vids), g, gan_on=True)
        else:
            program = StepProgram(step, data, g)

            def run(_, program=program, rng=rng, k=k):
                return program.run(*_program_draws(rng, k), gan_on=True)
        timing.fetch_scalar(run(None))  # builds, plans and the capture
        _reset_counters()
        res = timing.time_compiled_step(run, lambda: None, windows, MFU_REPS)
        counts = _counters()
        n_steps = (1 + MFU_REPS * sum(windows)) * max(k, 1)
        fams = _gru_families(counts)
        if min(fams.values()) < 1:
            raise AssertionError(f"MFU {label}: a GRU kernel did not run in the timed steps: "
                                 f"{fams}")
        launches.update(counts)
        sec = res["sec_per_step"] / max(k, 1)
        prec = "bfloat16" if mixed else "float32"
        mfu_spec = step_flops / sec / spec[prec]
        mfu_meas = step_flops / sec / peaks[prec]
        log(f"MFU {label}: {sec * 1e3:.3f} ms a train step, {1 / sec:.3f} steps/s (slope of "
            f"windows {windows} x{max(k, 1)} steps, {MFU_REPS} reps, samples "
            f"{[round(x * 1e3 / max(k, 1), 3) for x in res['slope_samples']]} ms), "
            f"{step_flops / sec / 1e12:.3f} TFLOP/s, MFU {mfu_spec:.4f} of the {prec} data "
            f"sheet peak, {mfu_meas:.4f} of the measured; GRU launches in the "
            f"{n_steps} timed and warm-up steps {fams}; {smi}")
        if k:
            got = profile_device(f"the MFU {label} train step", f"program of {k} steps",
                                 lambda: run(None), n=1)
            _replay_launches(f"MFU {label}", program, k, got)
        if max(mfu_spec, mfu_meas) > 1.0:
            raise AssertionError(f"MFU {label}: above 1 ({mfu_spec:.4f}, {mfu_meas:.4f})")
        summary.append(f"{label} {sec * 1e3:.3f} ms MFU {mfu_spec:.4f} (spec) "
                       f"{mfu_meas:.4f} (measured)")
        del step, data, g, run
        program = None
    # one trace of two eager float32 steps, which must name the GRU kernels
    step, data, g = _program_setup(device, {}, seed=20)
    rng = np.random.default_rng(20)

    def eager():
        idx, adv = _program_draws(rng, 1)
        rows, vids = data.indices(idx[0], adv[0])
        with profiling.annotate("mfu_train_step"):
            return step.train_step(gather(data.arrays, rows, vids), g, gan_on=True)

    timing.fetch_scalar(eager())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        # a profiling session now and then records no device events
        # (`_profile`): taken again, twice at most
        for _ in range(3):
            with profiling.trace(tdir):
                for _ in range(2):
                    timing.fetch_scalar(eager())
            path = pathlib.Path(tdir) / "trace.json"
            seen = _trace_kernels(path)
            if min(seen.values()) > 0:
                break
        size = path.stat().st_size
    log(f"MFU: profiling.trace of two eager float32 steps wrote {size} bytes, GRU kernels "
        f"by name {seen}; {smi}")
    if min(seen.values()) < 1:
        raise AssertionError(f"MFU: the trace does not name every GRU kernel: {seen}")
    del step, data, g
    log(f"MFU at batch {TRAIN_BATCH}, {step_flops:.0f} flops a step: {'; '.join(summary)}; "
        f"measured peaks bf16 {peaks['bfloat16'] / 1e12:.3f}, float32 "
        f"{peaks['float32'] / 1e12:.3f} TFLOP/s; phase {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return launches


def _resume_trainer(device, data, work: pathlib.Path, seed: int, **kw):
    """A full-width trainer at batch TRAIN_BATCH on `data`, the GAN terms on,
    in `work`, its frozen TriModal from the work dir's
    `trimodal_gen.pth.tar` (the first trainer's), as main_v2's
    `--trimodal-checkpoint`: a checkpoint holds G and D alone."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.train.trainer import Trainer

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1, batch_size=TRAIN_BATCH)
    t = Trainer(cfg, str(work), train_data=data, device=device, seed=seed,
                log_interval=10 ** 9, **kw)
    tri = work / "trimodal_gen.pth.tar"
    if not tri.exists():
        torch.save({"trimodal_gen_dict": t.tri.state_dict()}, tri)
    t.load_trimodal_torch_checkpoint(str(tri))
    return t


def _resume_check(label: str, a, b) -> None:
    """The uncut trainer `a` and the resumed `b` after the same steps: the
    same bits in both nets' parameters and buffers (BatchNorm statistics),
    their Adam states, the step generator's state and the step count."""
    diff = _step_differences(({}, a.step, a.generator.get_state()),
                             ({}, b.step, b.generator.get_state()))
    if a.step.step != b.step.step:
        diff.append(f"the step count {a.step.step} != {b.step.step}")
    if diff:
        raise AssertionError(f"{label}: the resumed run differs from the uncut one: "
                             f"{diff[:8]} ({len(diff)} in all)")
    log(f"{label}: the resumed run equals the uncut one bit for bit after "
        f"{a.step.step} steps (weights, BN statistics, Adam states, generator, count)")


def grain_resume_checks(device, data, work: pathlib.Path) -> None:
    """Resumed training on the card under `cudnn.deterministic` and
    `torch.use_deterministic_algorithms` (warn only): `nn.Embedding`'s
    backward on the card sums the rows of a repeated word id in no fixed
    order unless asked, and the synthetic corpus's few words repeat
    thousands of times a batch (without it, a resumed run differs from the
    uncut one in the text encoder's embedding and its Adam moments alone).
    Grain: a trainer runs epoch 0 and 1 step of epoch 1 (across the
    stream's first epoch boundary at 1204 rows), saves, and finishes epoch
    1; a trainer built with another seed loads the checkpoint (its
    data-state file names the stream's next batch and seed) and finishes
    epoch 1. The device loader, per step and as programs of SCAN_SPP: a
    trainer runs epoch 0, saves, and runs 2 steps of epoch 1; another,
    built with another seed, loads and runs the same 2 steps. Each pair
    must hold the same bits."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = (("grain mid-epoch", {"loader": "grain"}),
                ("device loader per step", {"loader": "device"}),
                (f"device loader K {SCAN_SPP}", {"loader": "device",
                                                 "steps_per_program": SCAN_SPP}))
        for label, kw in runs:
            where = work / f"resume_{label.replace(' ', '_')}"
            a = _resume_trainer(device, data, where, 5, **kw)
            a.per_train_epoch()
            if kw["loader"] == "grain":
                a.epoch = 1
                a.per_train_epoch(max_iters=1)
                a.save_checkpoint(0.5)
                a.per_train_epoch()
                b = _resume_trainer(device, data, where, 6, **kw)
                if not b.load_checkpoint("best") or b._iter_in_epoch != 1:
                    raise AssertionError(f"{label}: resumed at iteration {b._iter_in_epoch}")
                b.per_train_epoch()
            else:
                a.save_checkpoint(0.5)
                a.epoch = 1
                a.per_train_epoch(max_iters=2)
                b = _resume_trainer(device, data, where, 6, **kw)
                if not b.load_checkpoint(0):
                    raise AssertionError(f"{label}: no checkpoint to resume from")
                b.epoch = 1
                b.per_train_epoch(max_iters=2)
                if b.epoch_engine != a.epoch_engine:
                    raise AssertionError(f"{label}: engines {a.epoch_engine}, {b.epoch_engine}")
            _resume_check(label, a, b)
            del a, b
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)


def grain_batch_check(loader) -> None:
    """The stream's next batch, its rows decoded on the card
    (`grain_loader.decode`), against `decode_rows` on the host on the same
    rows: every array the same bits, the speakers the same."""
    from speech2affective_gestures_torch.data.grain_loader import batch_rows
    from speech2affective_gestures_torch.data.ted_db import decode_rows

    t, ds = loader.next_batch, loader.ds
    got = {k: v.cpu().numpy() for k, v in next(loader).items()}
    want = decode_rows(ds, batch_rows(ds.n_samples, loader.batch_size, loader.seed, t))
    want["vid_indices"] = loader.packed_batch(t, loader.seed)["vid_indices"].numpy()
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or got[k].tobytes() != want[k].tobytes()]
    if set(got) != set(want) or bad:
        raise AssertionError(f"grain batch {t} decoded on the card differs from decode_rows: "
                             f"{bad or sorted(set(got) ^ set(want))}")
    log(f"grain batch {t} decoded on the card equals decode_rows on the host bit for bit "
        f"({', '.join(sorted(want))})")


def grain_numbers(trainer, smi: str) -> None:
    """The train step at full width and batch TRAIN_BATCH fed three ways,
    each step's batch fetched inside the timed step: by the device loader
    (`DeviceDataset` gather from the host's draws), by the grain stream as
    the trainer takes it (`next`: the rows gathered into pinned memory in
    the step, copied without blocking, decoded on the card), and by the
    grain stream with each batch's rows gathered one batch ahead on a
    worker thread (the design the loader does not take). Per way the p50
    over GRAIN_STEPS steps (host clock, each ended by a synchronize), and
    for the two loaders the busy share from the profiler. Then what a
    worker thread costs the launching thread: 3000 launches of a small op,
    alone and beside a thread gathering batches without pause, p50 of 7;
    and the host's part of one grain
    batch (`packed_batch`), into pinned memory, and for comparison the
    whole decode on the host (`decode_rows`), p50 over GRAIN_DECODES."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from speech2affective_gestures_torch.data.grain_loader import batch_rows, decode
    from speech2affective_gestures_torch.data.ted_db import (BatchSampler, DeviceDataset,
                                                             decode_rows)

    loader, step, g = trainer._grain, trainer.step, trainer.generator
    device = trainer.device
    data = DeviceDataset(trainer.train_data, device)
    sampler = BatchSampler(trainer.train_data, TRAIN_BATCH, seed=5)
    worker = ThreadPoolExecutor(max_workers=1)
    ahead = [worker.submit(loader.packed_batch, loader.next_batch, loader.seed, True)]

    def made_ahead():
        raw = ahead.pop().result()
        loader.next_batch += 1
        ahead.append(worker.submit(loader.packed_batch, loader.next_batch, loader.seed, True))
        return decode({k: v.to(device, non_blocking=True) for k, v in raw.items()})

    ways = (("device loader", lambda: data.batch(*sampler.draw())),
            ("grain stream, rows made in the step", lambda: next(loader)),
            ("grain stream, rows made ahead on a worker thread", made_ahead))
    summary = []
    for label, fetch in ways:
        def fn(fetch=fetch):
            return step.train_step(fetch(), g, gan_on=True)
        fn()
        fn()
        times = []
        for _ in range(GRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(times))
        got = None if fetch is made_ahead else profile_device(
            f"the train step fed by the {label}", "step", fn, n=3)
        busy = "busy not measured" if got is None else f"busy {100 * got[1] / got[2]:.1f}%"
        log(f"train step fed by the {label} (batch {TRAIN_BATCH}, full width): p50 {p50:.3f} "
            f"ms over {GRAIN_STEPS} steps; all {[round(t, 3) for t in times]}; {busy}; {smi}")
        summary.append(f"{label} p50 {p50:.3f} ms, {busy}")
    ahead.pop().result()
    worker.shutdown()

    x = torch.ones(8, device=device)

    def launches():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3000):
            x.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    launches()
    alone = float(np.median([launches() for _ in range(7)]))
    stop = threading.Event()

    def gather():
        while not stop.is_set():
            loader.packed_batch(loader.next_batch, loader.seed, True)

    thread = threading.Thread(target=gather)
    thread.start()
    try:
        beside = float(np.median([launches() for _ in range(7)]))
    finally:
        stop.set()
        thread.join()
    host = {"packed rows pinned": [], "decode_rows": []}
    ds, seed = loader.ds, loader.seed
    for j in range(GRAIN_DECODES):
        t = loader.next_batch + j
        for name, fn in (("packed rows pinned", lambda: loader.packed_batch(t, seed, True)),
                         ("decode_rows", lambda: decode_rows(ds, batch_rows(
                             ds.n_samples, TRAIN_BATCH, seed, t)))):
            t0 = time.perf_counter()
            fn()
            host[name].append((time.perf_counter() - t0) * 1e3)
    log(f"grain loader numbers at batch {TRAIN_BATCH}: {'; '.join(summary)}; 3000 launches "
        f"p50 {alone:.3f} ms alone, {beside:.3f} ms beside a thread gathering batches; host "
        f"ms a batch, p50 over {GRAIN_DECODES}: "
        + ", ".join(f"{k} {np.median(v):.3f} (all {[round(x, 3) for x in v]})"
                    for k, v in host.items()) + f"; {smi}")


def grain_phase(device, work: pathlib.Path, embedding_net: pathlib.Path,
                smi: str) -> collections.Counter:
    """`main_v2 --loader grain --steps-per-program SCAN_SPP` on the card
    (`training_phase`: full width, batch 512, GRAIN_EPOCHS epochs of the
    synthetic corpus's 1204 train windows, 2 steps an epoch from one
    stream; the test split scored): the counters set to 0 just before and
    read just after (the GRU forward, recurrence and dW float32 must run),
    every loss finite; the split must not be on the card, the log must
    name loader grain and the per-step engine, and the fallback from K
    SCAN_SPP to one step at a time. Then the next batch decoded on the
    card against `decode_rows` (`grain_batch_check`), the resumed runs
    against the uncut ones (`grain_resume_checks`) and the step's numbers
    by loader (`grain_numbers`). Returns the kernels' launches in the main_v2 run."""
    t0 = time.perf_counter()
    options = ("--loader", "grain", "--steps-per-program", str(SCAN_SPP),
               "--s2ag-num-epoch", str(GRAIN_EPOCHS))
    trainer, trained = training_phase(device, work, embedding_net, options=options)
    log_txt = (pathlib.Path(trainer.work_dir) / "log.txt").read_text()
    per_epoch = trainer.train_data.n_samples // TRAIN_BATCH
    epochs = [ln for ln in log_txt.splitlines() if " train: mean_s2ag_loss" in ln]
    if (trainer.loader != "grain" or trainer._device_train is not None
            or trainer.epoch_engine != "per_step"
            or "'device' loader" not in (trainer.epoch_engine_fallback or "")
            or "epoch engine: per_step (1 train steps a program, loader grain); "
               f"steps_per_program={SCAN_SPP} requested" not in log_txt
            or len(epochs) != GRAIN_EPOCHS
            or not all(ln.endswith(f"{per_epoch} iters, engine per_step)") for ln in epochs)
            or trainer._grain.next_batch != GRAIN_EPOCHS * per_epoch):
        raise AssertionError(f"main_v2 {' '.join(options)}: loader {trainer.loader}, engine "
                             f"{trainer.epoch_engine} ({trainer.epoch_engine_fallback}), "
                             f"epochs {epochs}, stream at {trainer._grain.next_batch}")
    log(f"main_v2 {' '.join(options)}: {len(epochs)} epochs of {per_epoch} steps from one "
        f"stream, engine per_step ({trainer.epoch_engine_fallback})")
    grain_batch_check(trainer._grain)
    parts = {"main_v2 run": time.perf_counter() - t0}
    grain_resume_checks(device, trainer.train_data, work)
    parts["resume checks"] = time.perf_counter() - t0 - sum(parts.values())
    grain_numbers(trainer, smi)
    parts["numbers"] = time.perf_counter() - t0 - sum(parts.values())
    log(f"grain phase took {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())}); {smi}")
    return trained


def _dp_setup(device, mesh=None, mixed: bool = False):
    """A full-width train step at global batch TRAIN_BATCH
    (`builder.init_training` from seed 0, the GAN terms on) on `device`,
    one rank of `mesh` where given (the state broadcast from rank 0), and
    its step generator from seed 16."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.parallel import mesh as P
    from speech2affective_gestures_torch.train import builder

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1, batch_size=TRAIN_BATCH)
    step = builder.init_training(cfg, 0, 1000, 100, device=device,
                                 mixed_precision=mixed)["step"]
    if mesh is not None:
        step.mesh = mesh
        P.replicate_state((step.gen, step.dis, step.tri), (step.gen_opt, step.dis_opt), mesh)
    return cfg, step, torch.Generator(device=device).manual_seed(16)


def _dp_batches(cfg, device, rows=slice(None), n_steps: int = DP_STEPS,
                n_words: int = 1000) -> list:
    """n_steps global batches of TRAIN_BATCH random rows over n_words
    words (`builder.synthetic_batch`, seeds 40, 41, ...), `rows` of each
    on `device`."""
    from speech2affective_gestures_torch.train import builder

    return [builder.to_device({k: v[rows] for k, v in builder.synthetic_batch(
        np.random.default_rng(40 + i), TRAIN_BATCH, cfg, n_words, 100).items()}, device)
        for i in range(n_steps)]


def _whole_states(step) -> tuple[list, list]:
    """Both nets' state dicts and both Adams' state dicts, whole: on a
    (data, model) grid gathered (`parallel.mesh.gather_params_2d`, a
    collective that every rank makes)."""
    from speech2affective_gestures_torch.parallel import mesh as P

    nets, opts = (step.gen, step.dis), (step.gen_opt, step.dis_opt)
    if step.grid is not None:
        return P.gather_params_2d(nets, opts, step.grid)
    return [n.state_dict() for n in nets], [o.state_dict() for o in opts]


def _dp_state(step, generator) -> dict:
    """What a step starts from, whole (`_whole_states`) and copied to the
    host: both nets' parameters and buffers, both Adams' states and the
    step generator's state."""
    def host(sd):
        return {k: host(v) if isinstance(v, dict) else
                v.detach().cpu().clone() if hasattr(v, "detach") else v for k, v in sd.items()}

    (gen, dis), (gen_opt, dis_opt) = _whole_states(step)
    return {"gen": host(gen), "dis": host(dis),
            "gen_opt": {"state": host(gen_opt["state"]), "param_groups": gen_opt["param_groups"]},
            "dis_opt": {"state": host(dis_opt["state"]), "param_groups": dis_opt["param_groups"]},
            "generator": generator.get_state()}


def _dp_load_state(step, generator, state: dict) -> None:
    import copy

    step.gen.load_state_dict(state["gen"])
    step.dis.load_state_dict(state["dis"])
    step.gen_opt.load_state_dict(copy.deepcopy(state["gen_opt"]))
    step.dis_opt.load_state_dict(copy.deepcopy(state["dis_opt"]))
    generator.set_state(state["generator"])


def _dp_snapshot(step, metrics) -> dict:
    """The step's metrics, both nets' parameters and buffers and both
    Adams' first moments (by parameter index), whole (`_whole_states`), on
    the host."""
    nets, opts = _whole_states(step)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            **{w: {k: v.detach().cpu().clone() for k, v in sd.items()}
               for w, sd in zip(("gen", "dis"), nets)},
            "moments": {w: {i: st["exp_avg"].detach().cpu().clone() for i, st in sd["state"].items()}
                        for w, sd in zip(("gen", "dis"), opts)}}


def _dp_in_sync(step, generator, mesh) -> bool:
    """Whether every rank holds rank 0's bits: both nets' parameters and
    buffers, both Adams' states and the step generator's state (rank 0's
    bytes broadcast and compared on each rank, the verdicts summed)."""
    import torch
    from speech2affective_gestures_torch.parallel import mesh as P

    tensors = [t for w in ("gen", "dis") for t in getattr(step, w).state_dict().values()]
    for opt in (step.gen_opt, step.dis_opt):
        tensors += [v for st in opt.state.values() for v in st.values()
                    if isinstance(v, torch.Tensor)]
    mine = torch.cat([t.detach().reshape(-1).cpu().contiguous().view(torch.uint8)
                      for t in tensors] + [generator.get_state()])
    theirs = mine.clone()
    P.broadcast_([theirs], mesh)
    apart = torch.tensor([float(not torch.equal(mine, theirs))], device=mesh.device)
    return P.all_reduce_(apart, mesh).item() == 0


def _dp_steps_rank(mesh, out: pathlib.Path) -> None:
    """(a), one rank: DP_STEPS full-width steps on its rows of the global
    batches, float32, the ranks compared bit for bit after each
    (`_dp_in_sync`; it raises if they part); the all-reduces' count and
    bytes a step; DP_TIMED steps timed; the gradients' all-reduce timed
    alone; one mixed-precision step, finite and in sync. Rank 0 writes
    to `out` the state before each step (`_dp_state`), the snapshot
    after it and its numbers."""
    import torch
    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.parallel import mesh as P

    set_f32_numerics()
    cfg, step, g = _dp_setup(mesh.device, mesh)
    batches = _dp_batches(cfg, mesh.device, mesh.rows(TRAIN_BATCH))
    snaps, pre, synced, traffic = [], [], [], collections.Counter()
    _reset_counters()
    for b in batches:
        if mesh.rank == 0:
            pre.append(_dp_state(step, g))
        before = collections.Counter(P.traffic)
        metrics = step.train_step(b, g, gan_on=True)
        torch.cuda.synchronize()
        traffic.update(collections.Counter(P.traffic) - before)
        snaps.append(_dp_snapshot(step, metrics))
        synced.append(_dp_in_sync(step, g, mesh))
    launches = _counters() + _rank_batch_counters(TRAIN_BATCH // mesh.world)
    times = []
    for _ in range(DP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_step(batches[0], g, gan_on=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    grads = {w: [p.grad for p in getattr(step, w).parameters() if p.grad is not None]
             for w in ("gen", "dis")}
    reduce_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in ("gen", "dis"):
            P.all_reduce_mean_(grads[w], mesh)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    grad_bytes = sum(t.numel() * t.element_size() for ts in grads.values() for t in ts)
    del step, grads
    _, mstep, mg = _dp_setup(mesh.device, mesh, mixed=True)
    _reset_counters()
    mixed = {k: float(v) for k, v in mstep.train_step(batches[0], mg, gan_on=True).items()}
    mixed_launches = _counters() + _rank_batch_counters(TRAIN_BATCH // mesh.world)
    mixed_sync = _dp_in_sync(mstep, mg, mesh)
    if mesh.rank == 0:
        torch.save({"snaps": snaps, "pre": pre, "synced": synced, "traffic": dict(traffic),
                 "launches": dict(launches), "times": times, "reduce_ms": reduce_ms,
                 "grad_bytes": grad_bytes, "mixed": mixed, "mixed_sync": mixed_sync,
                 "mixed_launches": dict(mixed_launches)}, out)
    if not (all(synced) and mixed_sync and np.isfinite(list(mixed.values())).all()):
        raise AssertionError(f"rank {mesh.rank}: ranks in sync after each step {synced}, "
                             f"after the mixed step {mixed_sync}; mixed metrics {mixed}")


def _dp_graph_rank(mesh, out: pathlib.Path) -> None:
    """(b), one NCCL rank: the K-step program (`_program_setup`: full
    width, batch TRAIN_BATCH, a random split of SCAN_ROWS rows) with the
    step's all-reduces on the mesh of one, a program of 1 step then one of
    2, as captured graphs and as the same body run eagerly, from the same
    weights, rows and generator seed, under `cudnn.deterministic`: the
    same bits (`_step_differences`; it raises if not); then the graph's
    step p50 over DP_TIMED replays of 2 steps, and its GRU launches and
    all-reduces a step."""
    import json

    import torch
    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.parallel import mesh as P
    from speech2affective_gestures_torch.train.step_program import StepProgram

    set_f32_numerics()
    torch.backends.cudnn.deterministic = True
    runs = {}
    for how in ("graph", "eager"):
        step, data, g = _program_setup(mesh.device, {})
        step.mesh = mesh
        program = StepProgram(step, data, g, capture=how == "graph")
        rng = np.random.default_rng(17)
        metrics = collections.defaultdict(list)
        P.traffic.clear()
        for k in (1, 2):
            keys, values = program.run(*_program_draws(rng, k), gan_on=True)
            for key, v in zip(keys, values.T):
                metrics[key].append(v)
        torch.cuda.synchronize()
        runs[how] = ({key: torch.cat(v) for key, v in metrics.items()}, step, g.get_state(),
                     program, dict(P.traffic))
    diff = _step_differences(runs["graph"][:3], runs["eager"][:3])
    program = runs["graph"][3]
    idx, adv = _program_draws(np.random.default_rng(18), 2)
    times = []
    for _ in range(DP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.run(idx, adv, gan_on=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / 2)
    record = {str(key): ({"/".join(k): v for k, v in n.items()}, r)
              for key, (n, r) in program.launch_record().items()}
    out.write_text(json.dumps({"diff": diff, "times": times, "record": record,
                               "capture traffic": runs["graph"][4],
                               "eager traffic": runs["eager"][4]}))
    if diff:
        raise AssertionError(f"the NCCL rank's K-step graph is not its eager steps: {diff[:16]}")


def _dp_resume_rank(mesh, work: pathlib.Path) -> None:
    """(d), one of DP_RESUME_RANKS gloo ranks on the card: a full-width
    trainer on a random split of SCAN_ROWS rows runs 2 steps of epoch 0,
    writes a checkpoint (rank 0) and runs 2 steps of epoch 1; another, built
    with another seed, loads it and runs the same 2 steps; both under
    `cudnn.deterministic` and `torch.use_deterministic_algorithms`: the
    same bits on every rank (`_step_differences`; it raises if not). Then
    one mixed-precision step (`_dp_setup`), finite. Rank 0 writes its
    launches (at its batch too) and the checkpoint writes."""
    import json

    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.vocab import make_speaker_vocab
    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.train import builder
    from speech2affective_gestures_torch.train.trainer import Trainer

    set_f32_numerics()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1, batch_size=TRAIN_BATCH)
    data = builder.synthetic_packed(np.random.default_rng(16), SCAN_ROWS, cfg)
    data.speaker_model = make_speaker_vocab(f"video{i}" for i in range(100))
    tri = work / "dp_resume_trimodal.pth.tar"
    writes = []

    def trainer(seed):
        t = Trainer(cfg, str(work / "dp_resume"), train_data=data, seed=seed,
                    log_interval=10 ** 9, mesh=mesh)
        write = t._write_checkpoint
        t._write_checkpoint = lambda path: (writes.append(path), write(path))
        if seed == 5 and mesh.rank == 0:
            torch.save({"trimodal_gen_dict": t.tri.state_dict()}, tri)
        mesh.barrier()
        t.load_trimodal_torch_checkpoint(str(tri))
        return t

    _reset_counters()
    a = trainer(5)
    a.per_train_epoch(max_iters=2)
    a.save_checkpoint(0.5)
    a.epoch = 1
    a.per_train_epoch(max_iters=2)
    b = trainer(6)
    if not b.load_checkpoint(0):
        raise AssertionError(f"rank {mesh.rank}: no checkpoint to resume from")
    b.epoch = 1
    b.per_train_epoch(max_iters=2)
    diff = _step_differences(({}, a.step, a.generator.get_state()),
                             ({}, b.step, b.generator.get_state()))
    if a.step.step != b.step.step:
        diff.append(f"the step count {a.step.step} != {b.step.step}")
    steps = a.step.step
    del a, b
    _, mstep, mg = _dp_setup(mesh.device, mesh, mixed=True)
    mixed = mstep.train_step(_dp_batches(cfg, mesh.device, mesh.rows(TRAIN_BATCH))[0], mg,
                             gan_on=True)
    if not np.isfinite([float(v) for v in mixed.values()]).all():
        diff.append(f"the mixed step's metrics {mixed}")
    launches = _counters() + _rank_batch_counters(TRAIN_BATCH // mesh.world)
    if mesh.rank == 0:
        (work / "dp_resume.json").write_text(json.dumps(
            {"diff": diff, "launches": dict(launches), "steps": steps,
             "writes": len(writes)}))
    elif writes:
        diff.append(f"rank {mesh.rank} wrote {writes}")
    if diff:
        raise AssertionError(f"rank {mesh.rank}: the resumed run differs from the uncut one: "
                             f"{diff[:8]} ({len(diff)} in all)")


def _dp_errors(got: dict, want: dict) -> dict:
    """Of a rank's snapshot after a step against one process's step from
    the same state, each check's largest error over its tolerance (a check
    holds at 1 or less), JAX's bounds (tests/test_mesh_2d.py:61-116): the
    metrics (rtol 1e-3, atol 1e-5), the weights (rtol 1e-4, atol 1.1e-3:
    Adam's first update turns a near-zero gradient's rounding into up to
    lr either way, as for the bias of a convolution that a BatchNorm
    follows, whose exact gradient is 0) and the BatchNorm running stats
    (rtol 5e-3, atol 1e-4; the running means 1e-4 more, 0.1 of such a
    bias's 2 lr, since D's last forward of the step runs after its
    update)."""
    lr = 5e-4
    out = {"metrics": max(abs(got["metrics"][k] - v) / (1e-5 + 1e-3 * abs(v))
                          for k, v in want["metrics"].items())}
    weights = stats = 0.0
    for w in ("gen", "dis"):
        for k, v in want[w].items():
            if k.endswith("num_batches_tracked"):
                continue
            a, b = got[w][k].double(), v.double()
            if k.endswith(("running_mean", "running_var")):
                atol = 1e-4 + (0.1 * 2 * lr if k.endswith("running_mean") else 0.0)
                stats = max(stats, ((a - b).abs() / (atol + 5e-3 * b.abs())).max().item())
            else:
                atol = 2 * lr + 1e-4
                weights = max(weights, ((a - b).abs() / (atol + 1e-4 * b.abs())).max().item())
    return {**out, "weights": weights, "BN stats": stats}


def _dp_moment_errors(got: dict, want: dict, pre: dict, names=None) -> float:
    """Of a snapshot's Adam first moments against one process's after a
    step from `pre`, the largest over both nets' tensors of the moments'
    difference over its tolerance (DP_MOMENT_RTOL; a check holds at 1 or
    less). The difference is (1 - beta1) times the gradients', so it is
    held to the gradient's share of the one process's moment, m - beta1
    m0, which pre's moments m0 give. With `names` ({net: parameter
    names}), the three largest are logged with their tensors."""
    worst, each = 0.0, []
    for w in ("gen", "dis"):
        beta1 = pre[f"{w}_opt"]["param_groups"][0]["betas"][0]
        m0 = {i: st["exp_avg"].double() for i, st in pre[f"{w}_opt"]["state"].items()}
        share = {i: m.double() - beta1 * m0.get(i, 0.0) for i, m in want["moments"][w].items()}
        n_net = sum(v.numel() for v in share.values())
        net = _norm(share.values())
        for i, g in share.items():
            diff = (got["moments"][w][i].double() - want["moments"][w][i].double()).norm().item()
            tol = DP_MOMENT_RTOL * (g.norm().item() + net * (g.numel() / n_net) ** 0.5)
            worst = max(worst, diff / tol)
            if names is not None:
                each.append((round(diff / tol, 4), f"{w}.{names[w][i]}"))
    if names is not None:
        log(f"data parallel (a) moments, the largest errors over their tolerance: "
            f"{sorted(each, reverse=True)[:3]}")
    return worst


def _norm(tensors) -> float:
    """The norm 2 of the tensors taken as one vector."""
    return sum(float(t.double().pow(2).sum()) for t in tensors) ** 0.5


def _dp_mutants(want: dict, pre: dict, half: dict) -> dict:
    """The moment errors (`_dp_moment_errors`) that a wrong gradient would
    make against one process's step from `pre`: the gradients summed where
    they are averaged (twice the share), lost (none of it), or rank 0's
    rows alone (`half`: one process's step on them)."""
    def scaled(c):
        out = {"moments": {}}
        for w in ("gen", "dis"):
            beta1 = pre[f"{w}_opt"]["param_groups"][0]["betas"][0]
            m0 = {i: st["exp_avg"] for i, st in pre[f"{w}_opt"]["state"].items()}
            out["moments"][w] = {i: beta1 * m0.get(i, 0.0) + c * (m - beta1 * m0.get(i, 0.0))
                                 for i, m in want["moments"][w].items()}
        return out

    return {"summed": _dp_moment_errors(scaled(2.0), want, pre),
            "lost": _dp_moment_errors(scaled(0.0), want, pre),
            "rank 0's rows": _dp_moment_errors(half, want, pre)}


def _dp_time_rank(mesh, out: pathlib.Path) -> None:
    """(c)'s timing, one NCCL rank a card: the full-width step (`_dp_setup`)
    on this rank's rows of one global batch of TRAIN_BATCH, DP_WARM steps,
    then DP_SCALING_TIMED timed one by one; rank 0 writes the times (ms)."""
    import json

    import torch
    from speech2affective_gestures_torch.device import set_f32_numerics

    set_f32_numerics()
    cfg, step, g = _dp_setup(mesh.device, mesh)
    batch = _dp_batches(cfg, mesh.device, mesh.rows(TRAIN_BATCH))[0]
    times = []
    for i in range(DP_WARM + DP_SCALING_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_step(batch, g, gan_on=True)
        torch.cuda.synchronize()
        if i >= DP_WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    if mesh.rank == 0:
        out.write_text(json.dumps(times))


def _dp_scaling(work: pathlib.Path, n_cards: int, one: list, smi: str) -> dict:
    """(c)'s step p50 by card count: one NCCL rank a card on 1, 2 and 4
    (of those visible) cards, each on its rows of the same global batch
    (`_dp_time_rank`), beside one process without a mesh (`one`, (a)'s
    times on the same batch). Returns the p50s (ms) by label."""
    import json

    from speech2affective_gestures_torch.parallel import mesh as P

    p50 = {"one process": float(np.median(one))}
    for world in (1, 2, 4):
        if world > n_cards:
            continue
        out = work / f"dp_time_{world}.json"
        P.launch(_dp_time_rank, world, "nccl", args=(out,), timeout=DP_TIMEOUT)
        times = json.loads(out.read_text())
        p50[f"{world} NCCL"] = float(np.median(times))
        log(f"data parallel (c) timing, {world} NCCL rank(s), {TRAIN_BATCH // world} rows "
            f"each: step p50 {p50[f'{world} NCCL']:.3f} ms (all "
            f"{[round(t, 3) for t in times]})")
    log(f"data parallel (c) step p50 by cards at global batch {TRAIN_BATCH} ({smi}): "
        + ", ".join(f"{k} {v:.3f} ms ({TRAIN_BATCH / v * 1e3:.0f} samples/s)"
                    for k, v in p50.items()))
    return p50


def data_parallel_phase(device, work: pathlib.Path, embedding_net: pathlib.Path,
                        smi: str) -> tuple[collections.Counter, dict]:
    """Data-parallel training (`parallel.mesh`), float32 with TF32 off, full
    width, global batch TRAIN_BATCH:
    (a) two gloo ranks on this card (`_dp_steps_rank`, 256 rows each),
        DP_STEPS steps, each against one process's step on the same global
        batch from the same state (weights, Adams, generator;
        `_dp_errors`, and the Adam first moments, `_dp_moment_errors`,
        whose tolerance must fail the gradients summed, lost or of rank
        0's rows alone, `_dp_mutants`); the ranks the same bits after each
        step; a mixed-precision step;
    (b) one NCCL rank's K-step graph, its all-reduces captured, against its
        eager steps (`_dp_graph_rank`);
    (c) with more than one card, the step p50 on 1, 2 and 4 cards over
        NCCL beside one process's (`_dp_scaling`), then `main_v2` over
        NCCL on every visible card for 2 epochs (`_dp_main_v2`); with one,
        logged as not run;
    (d) DP_RESUME_RANKS gloo ranks (128 rows each) resumed from a
        checkpoint against the uncut run (`_dp_resume_rank`).
    Logs the step p50s, the all-reduces' ms and bytes a step and the
    launches a step. Returns the ranks' launches (rank 0's of (a), (d)
    and its mixed step, under the plain names and at its batch) and (c)'s
    step p50s by card count (none with one card)."""
    import json

    import torch
    from speech2affective_gestures_torch.parallel import mesh as P

    t0 = time.perf_counter()
    launches = collections.Counter()
    out = work / "dp_steps.pt"
    P.launch(_dp_steps_rank, 2, "gloo", devices=[device, device], args=(out,),
             timeout=DP_TIMEOUT)
    got = torch.load(out, weights_only=False)
    cfg, step, g = _dp_setup(device)
    errs, mutants, times = [], [], []
    for b, pre, snap in zip(_dp_batches(cfg, device), got["pre"], got["snaps"]):
        _dp_load_state(step, g, pre)
        half = {k: v[:TRAIN_BATCH // 2] for k, v in b.items()}
        half = (step.train_step(half, g, gan_on=True), _dp_snapshot(step, {}))[1]
        _dp_load_state(step, g, pre)
        want = _dp_snapshot(step, step.train_step(b, g, gan_on=True))
        names = {w: [n for n, _ in getattr(step, w).named_parameters()] for w in ("gen", "dis")}
        errs.append({**_dp_errors(snap, want),
                     "moments": _dp_moment_errors(snap, want, pre, names)})
        mutants.append(_dp_mutants(want, pre, half))
    for _ in range(DP_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.train_step(b, g, gan_on=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    del step, got["pre"]
    torch.cuda.empty_cache()
    per_step = {k: v / DP_STEPS for k, v in got["traffic"].items()}
    launches.update(got["launches"])
    launches.update(got["mixed_launches"])
    gru = {k: v / DP_STEPS for k, v in got["launches"].items() if not re.search(r"_b\d", k)}
    log(f"data parallel (a), two gloo ranks on one card, 256 rows each of batch "
        f"{TRAIN_BATCH}, each step against one process's from the same state, each check's "
        f"error over its tolerance by step: {[{k: round(v, 4) for k, v in e.items()} for e in errs]}; the ranks the "
        f"same bits after each step {got['synced']}, after a mixed-precision step "
        f"{got['mixed_sync']} (its metrics {got['mixed']}); the Adam first moments' error "
        f"over its tolerance for wrong gradients, by step (each must pass 1): "
        f"{[{k: round(v, 2) for k, v in m.items()} for m in mutants]}")
    rounded = {k: [round(t, 3) for t in v] for k, v in
               (("ranks", got["times"]), ("one", times), ("reduce", got["reduce_ms"]))}
    log(f"data parallel (a) numbers ({smi}): step p50 {np.median(got['times']):.3f} ms with "
        f"two ranks sharing the card (not a scaling figure: both ranks run on one card) "
        f"against one process's {np.median(times):.3f} ms (all {rounded['ranks']} and "
        f"{rounded['one']}); all-reduces a step {per_step.get('data all_reduce', 0):.1f}, "
        f"{per_step.get('data all_reduce bytes', 0):.0f} bytes, of them the gradients' "
        f"{got['grad_bytes']} bytes in {np.median(got['reduce_ms']):.3f} ms (p50 of "
        f"{rounded['reduce']}, through the host under gloo); GRU launches a step on a rank "
        f"{gru}")
    if not all(v <= 1 for e in errs for v in e.values()):
        raise AssertionError(f"two ranks are not one process: {errs}")
    if not all(v > 1 for m in mutants for v in m.values()):
        raise AssertionError(f"the moment check would pass a wrong gradient: {mutants}")

    out = work / "dp_graph.json"
    P.launch(_dp_graph_rank, 1, "nccl", devices=[device], args=(out,), timeout=DP_TIMEOUT)
    graph = json.loads(out.read_text())
    log(f"data parallel (b), one NCCL rank, K 2 graphs with the all-reduces captured, "
        f"against their eager steps under cudnn.deterministic: the same bits; step p50 "
        f"{np.median(graph['times']):.3f} ms ({smi}; all "
        f"{[round(t, 3) for t in graph['times']]}); graphs {graph['record']}; all-reduces "
        f"at the capture {graph['capture traffic']}, in the eager steps "
        f"{graph['eager traffic']}")

    n_cards = torch.cuda.device_count()
    scaling = {}
    if n_cards > 1:
        scaling = _dp_scaling(work, n_cards, times, smi)
        _dp_main_v2(work, embedding_net, n_cards, smi)
    else:
        log("data parallel (c), main_v2 over NCCL on several cards: not run, one card "
            "visible (torch.cuda.device_count() == 1)")

    P.launch(_dp_resume_rank, DP_RESUME_RANKS, "gloo", devices=[device] * DP_RESUME_RANKS,
             args=(work,), timeout=DP_TIMEOUT)
    resume = json.loads((work / "dp_resume.json").read_text())
    launches.update(resume["launches"])
    log(f"data parallel (d), {DP_RESUME_RANKS} gloo ranks on one card, "
        f"{TRAIN_BATCH // DP_RESUME_RANKS} rows each: the resumed run equals the uncut one "
        f"bit for bit after {resume['steps']} steps on every rank (weights, BN statistics, "
        f"Adam states, generator, count); checkpoints written: {resume['writes']} (rank 0)")
    log(f"data parallel phase took {time.perf_counter() - t0:.1f} s; rank launches "
        f"{dict(launches)}")
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        for B in (TRAIN_BATCH // 2, TRAIN_BATCH // DP_RESUME_RANKS):
            if launches[f"{name}_b{B}"] == 0:
                raise AssertionError(f"{name} did not run at a rank's batch {B}")
    return launches, scaling


def _dp_main_v2(work: pathlib.Path, embedding_net: pathlib.Path, n_cards: int,
                smi: str) -> None:
    """(c): `main_v2 --use-multiple-gpus true` at full width, batch
    TRAIN_BATCH, 2 epochs of the synthetic corpus, one NCCL rank a card:
    rank 0's log must name the ranks, hold finite losses for both epochs
    and the test split's scores; one checkpoint of epoch 0."""
    import yaml
    from speech2affective_gestures_torch import main_v2

    raw = yaml.safe_load(CONFIG.read_text())
    raw["loss_warmup"] = -1
    cfg_path = work / "multimodal_context_v2_gan_on.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    base = work / "base_data_parallel"
    t0 = time.perf_counter()
    result = main_v2.main(["-b", str(base), "-c", str(cfg_path), "--synthetic-data", "true",
                           "--synthetic-videos", str(TRAIN_VIDEOS), "--synthetic-seconds",
                           str(TRAIN_SECONDS), "--batch-size", str(TRAIN_BATCH),
                           "--s2ag-num-epoch", "2", "--log-interval", "1",
                           "--embedding-net-checkpoint", str(embedding_net),
                           "--use-multiple-gpus", "true"])
    wall = time.perf_counter() - t0
    work_dir = base / "models" / "s2ag_v2_mfcc_torch" / "ted_db"
    text = (work_dir / "log.txt").read_text()
    epochs = [ln for ln in text.splitlines() if " train: mean_s2ag_loss" in ln]
    values = [float(tok.split(": ")[1]) for ln in text.splitlines() if "Done. | " in ln
              for tok in ln.split("Done. | ")[1].split(" | ")]
    ckpts = sorted(p.name for p in work_dir.glob("*.pth.tar"))
    if (result is not None or f"data parallel: {n_cards} ranks over nccl" not in text
            or len(epochs) != 2 or not values or not np.isfinite(values).all()
            or "eval: l1" not in text or len(ckpts) != 1):
        raise AssertionError(f"main_v2 on {n_cards} cards: returned {result}, epochs {epochs}, "
                             f"checkpoints {ckpts}; log tail {text[-2000:]}")
    log(f"data parallel (c), main_v2 over NCCL on {n_cards} cards, "
        f"{TRAIN_BATCH // n_cards} rows each, 2 epochs: {epochs}; "
        f"{[ln for ln in text.splitlines() if 'eval: ' in ln]}; {wall:.1f} s in all ({smi})")


def _grid_setup(device, grid=None, mixed: bool = False, gradient_clip: float = 0.0):
    """`_dp_setup`'s full-width step at GRID_WORDS words (`builder.init_training`
    from seed 0, the GAN terms on) on `device`, on `grid` where given (its
    nets and Adams split by `shard_params_2d` at tp_min_cols GRID_TP_COLS),
    and its step generator from seed 16."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.parallel import mesh as P
    from speech2affective_gestures_torch.train import builder

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1, batch_size=TRAIN_BATCH)
    step = builder.init_training(cfg, 0, GRID_WORDS, 100, device=device, mixed_precision=mixed,
                                 gradient_clip=gradient_clip, mesh=grid)["step"]
    if grid is not None:
        P.shard_params_2d((step.gen, step.dis, step.tri), (step.gen_opt, step.dis_opt), grid,
                          tp_min_cols=GRID_TP_COLS)
    return cfg, step, torch.Generator(device=device).manual_seed(16)


@contextlib.contextmanager
def _grid_mutant(name: str, grid):
    """The grid's step with one fault: the split parameters' gradients
    summed over the model axis (the gathers' backward a reduce-scatter
    sum, the tables' sum an all-reduce), BatchNorm's count taken over the
    world, or the clip's norm summing the slices over the world (each
    counted twice)."""
    import dataclasses

    from speech2affective_gestures_torch.models import layers as L
    from speech2affective_gestures_torch.parallel import mesh as P
    from speech2affective_gestures_torch.train import gan_step

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, value)

    if name == "shard gradient summed":
        gather_bwd = P._GatherShards.backward
        patch(P._GatherShards, "backward", staticmethod(lambda ctx, *gs: gather_bwd(
            ctx, *(None if g is None else P.all_reduce_(g.clone(), ctx.mesh) for g in gs))))
        patch(P._SumOverModel, "backward",
              staticmethod(lambda ctx, g: (P.all_reduce_(g.clone(), ctx.mesh), None)))
    elif name == "BN count over the world":
        bn = L._batch_norm_global
        patch(L, "_batch_norm_global", lambda m, x, mesh: bn(
            m, x, dataclasses.replace(mesh, world=grid.world)))
    else:
        clip = gan_step.clip_by_global_norm_
        world = P.DataMesh(grid.rank, grid.world, grid.device, axis="model")
        patch(gan_step, "clip_by_global_norm_", lambda params, max_norm, g=None: clip(
            params, max_norm, None if g is None else dataclasses.replace(g, model=world)))
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def _grid_memory(step) -> dict:
    """This rank's parameter and Adam-moment bytes against the whole
    nets' (G, D and the TriModal; Adam's for G and D)."""
    def nbytes(p, whole):
        shape = p.model_shard.shape if whole and hasattr(p, "model_shard") else p.shape
        return int(np.prod(shape)) * p.element_size()

    out = {}
    for whole in (False, True):
        params = sum(nbytes(p, whole) for w in ("gen", "dis", "tri")
                     for p in getattr(step, w).parameters())
        adam = sum(2 * nbytes(p, whole) for opt in (step.gen_opt, step.dis_opt)
                   for p in opt.state)
        out["whole" if whole else "rank"] = {"params": params, "adam": adam}
    return out


def _grid_synthesis_inputs():
    """The sharded synthesis' clips (GRID_CLIPS, words with ids in both
    halves of the table), its vocabulary and its per-window noise rows."""
    from speech2affective_gestures_torch.data.vocab import placeholder_vocab

    words = [[f"<w{37 + 171 * i}>", 0.4 + 0.9 * i, 0.8 + 0.9 * i] for i in range(12)]
    clips = [(clip_audio(sec, 60 + i), [w for w in words if w[2] < sec], 11 * i)
             for i, sec in enumerate(GRID_CLIPS)]
    eps = np.random.default_rng(61).standard_normal((16, len(clips), 16)).astype(np.float32)
    return clips, placeholder_vocab(GRID_WORDS), eps


def _grid_rank(mesh, out: pathlib.Path) -> None:
    """(a)-(c) of `model_parallel_phase`, one gloo rank of the grid on the
    card: GRID_STEPS full-width steps on its rows of the global batches
    (the state before each and the snapshot after it gathered whole), the
    data axis' ranks compared bit for bit after each (`_dp_in_sync` over
    the data axis; it raises if they part), the collectives a step by
    axis, the placement and this rank's shapes, its memory, GRID_TIMED
    steps timed; a clipped step and the mutants' steps (`_grid_mutant`)
    from the first state; a mixed-precision step; then the sharded batched
    synthesis (pad_to the data axis). Rank 0 writes its results to
    `out`; every rank its synthesis launches beside it."""
    import collections as co
    import json

    import torch
    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.parallel import mesh as P
    from speech2affective_gestures_torch.train import synthesis

    set_f32_numerics()
    grid = P.make_mesh_2d(*GRID_SHAPE)
    dev = mesh.device
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, step, g = _grid_setup(dev, grid)
    nets = {w: getattr(step, w) for w in ("gen", "dis", "tri")}
    kinds = {w: {n: p.model_shard.kind if hasattr(p, "model_shard") else "rep"
                 for n, p in net.named_parameters()} for w, net in nets.items()}
    placed = {w: P.placement(net, grid.n_model, tp_min_cols=GRID_TP_COLS)
              for w, net in nets.items()}
    shapes = {f"{w}.{n}": tuple(p.shape) for w, net in nets.items()
              for n, p in net.named_parameters() if kinds[w][n] != "rep"}
    batches = _dp_batches(cfg, dev, grid.data.rows(TRAIN_BATCH), GRID_STEPS, GRID_WORDS)
    res = {"pre": [], "snaps": [], "synced": [], "traffic": co.Counter(), "kinds": kinds,
           "placement": placed, "shapes": shapes}
    _reset_counters()
    for b in batches:
        res["pre"].append(_dp_state(step, g))
        before = co.Counter(P.traffic)
        metrics = step.train_step(b, g, gan_on=True)
        torch.cuda.synchronize()
        res["traffic"].update(co.Counter(P.traffic) - before)
        res["snaps"].append(_dp_snapshot(step, metrics))
        res["synced"].append(_dp_in_sync(step, g, grid.data))
    res["launches"] = _counters() + _rank_batch_counters(TRAIN_BATCH // grid.n_data)
    res["memory"] = _grid_memory(step)
    res["times"] = []
    for _ in range(GRID_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_step(batches[0], g, gan_on=True)
        torch.cuda.synchronize()
        res["times"].append((time.perf_counter() - t0) * 1e3)
    res["peak"] = torch.cuda.max_memory_allocated() - base
    del step
    res["mutants"] = {}
    for name in ("clipped",) + GRID_MUTANTS:
        clipped = name.startswith("clip")
        with (_grid_mutant(name, grid) if name != "clipped" else contextlib.nullcontext()):
            _, mstep, mg = _grid_setup(dev, grid, gradient_clip=GRID_CLIP if clipped else 0.0)
            metrics = mstep.train_step(batches[0], mg, gan_on=True)
        res["mutants"][name] = _dp_snapshot(mstep, metrics)
        del mstep
    _, mstep, mg = _grid_setup(dev, grid, mixed=True)
    metrics = mstep.train_step(batches[0], mg, gan_on=True)
    res["mixed"] = {k: float(v) for k, v in metrics.items()}
    res["mixed dtypes"] = sorted({str(p.dtype) for w in ("gen", "dis")
                                  for p in getattr(mstep, w).parameters()})
    res["mixed sync"] = _dp_in_sync(mstep, mg, grid.data)
    del mstep
    torch.cuda.empty_cache()

    gen = _grid_setup(dev, grid)[1].gen.eval()
    clips, vocab, eps = _grid_synthesis_inputs()
    _reset_counters()
    t0 = time.perf_counter()
    results = synthesis.synthesize_clips_batched(gen, clips, vocab, cfg,
                                                 eps=torch.from_numpy(eps), mesh=grid,
                                                 pad_to=grid.n_data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counters()
    (out.parent / f"{out.stem}_synthesis_rank{grid.rank}.json").write_text(json.dumps(
        {"launches": {k: counts[k] for k in ("gru_fwd", "mel_power")}, "wall": wall}))
    if grid.rank == 0:
        res["synthesis"] = results
        torch.save(res, out)
    if not (all(res["synced"]) and res["mixed sync"]
            and np.isfinite(list(res["mixed"].values())).all()):
        raise AssertionError(f"rank {grid.rank}: the data axis' ranks in sync after each step "
                             f"{res['synced']}, after the mixed step {res['mixed sync']}; "
                             f"mixed metrics {res['mixed']}")


def _grid_time_rank(mesh, out: pathlib.Path) -> None:
    """(d), one NCCL rank a card on the grid: the full-width step
    (`_grid_setup`) on its rows of one global batch, DP_WARM steps, then
    DP_SCALING_TIMED timed one by one; rank 0 writes the times (ms)."""
    import json

    import torch
    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.parallel import mesh as P

    set_f32_numerics()
    grid = P.make_mesh_2d(*GRID_SHAPE)
    cfg, step, g = _grid_setup(mesh.device, grid)
    batch = _dp_batches(cfg, mesh.device, grid.data.rows(TRAIN_BATCH), 1, GRID_WORDS)[0]
    times = []
    for i in range(DP_WARM + DP_SCALING_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_step(batch, g, gan_on=True)
        torch.cuda.synchronize()
        if i >= DP_WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    if grid.rank == 0:
        out.write_text(json.dumps(times))


def model_parallel_phase(device, work: pathlib.Path, smi: str,
                         scaling: dict) -> collections.Counter:
    """The 2-D (data, model) grid (`parallel.mesh.make_mesh_2d`,
    `shard_params_2d`), float32 with TF32 off, full width (hidden 300, 4
    bi-GRU layers, embedding 300, 100 speakers, the AffDiscriminator and
    the frozen TriModal) at GRID_WORDS words, global batch TRAIN_BATCH,
    tp_min_cols GRID_TP_COLS; four gloo ranks on this card as a 2 x 2 grid
    (`_grid_rank`, 256 rows a data rank):
    (a) GRID_STEPS steps, each against one process's step on the same
        global batch from the same state (`_dp_errors`, JAX's mesh bounds,
        and the Adam first moments, `_dp_moment_errors`); the data axis'
        ranks the same bits; the placement `placement`'s, the tables 1024
        rows on each rank and the GRU weight_hh 450; the mutants
        (`_grid_mutant`) must fail the bounds, a clipped step (GRID_CLIP)
        pass them;
    (b) one mixed-precision step: finite, float32 masters, its metrics
        within MP_TOL of one process's mixed step;
    (c) the batched synthesis of GRID_CLIPS on the grid (pad_to 2, the MFCC
        route) against one process's within GRID_SYNTH_TOL, the GRU and
        mel launches read on each rank;
    (d) with four or more cards, the grid over NCCL a card a rank: its step
        p50 beside one process's and the 1-D four-card mesh's
        (`scaling`, `data_parallel_phase`'s (c)); with fewer, logged as not
        run.
    Logs the collectives and bytes a step by axis, the memory a rank and
    the launches on rank 0. Returns rank 0's launches of (a), at its batch
    too, and of (c)."""
    import json

    import torch
    from speech2affective_gestures_torch.parallel import mesh as P
    from speech2affective_gestures_torch.train import synthesis

    t0 = time.perf_counter()
    out = work / "grid.pt"
    n_ranks = GRID_SHAPE[0] * GRID_SHAPE[1]
    P.launch(_grid_rank, n_ranks, "gloo", devices=[device] * n_ranks, args=(out,),
             timeout=DP_TIMEOUT)
    got = torch.load(out, weights_only=False)
    ranks_s = time.perf_counter() - t0

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, step, g = _grid_setup(device)
    names = {w: [n for n, _ in getattr(step, w).named_parameters()] for w in ("gen", "dis")}
    errs, wants = [], []
    batches = _dp_batches(cfg, device, n_steps=GRID_STEPS, n_words=GRID_WORDS)
    for b, pre, snap in zip(batches, got["pre"], got["snaps"]):
        _dp_load_state(step, g, pre)
        wants.append(_dp_snapshot(step, step.train_step(b, g, gan_on=True)))
        errs.append({**_dp_errors(snap, wants[-1]),
                     "moments": _dp_moment_errors(snap, wants[-1], pre, names)})
    times = []
    for _ in range(GRID_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.train_step(batches[0], g, gan_on=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    one_peak = torch.cuda.max_memory_allocated() - base
    del step
    _, cstep, cg = _grid_setup(device, gradient_clip=GRID_CLIP)
    clipped = _dp_snapshot(cstep, cstep.train_step(batches[0], cg, gan_on=True))
    del cstep
    pre0 = got["pre"][0]

    def worst(snap, want):
        return {**_dp_errors(snap, want), "moments": _dp_moment_errors(snap, want, pre0)}

    checks = {name: worst(got["mutants"][name], clipped if name.startswith("clip") else wants[0])
              for name in ("clipped",) + GRID_MUTANTS}
    _, mstep, mg = _grid_setup(device, mixed=True)
    mixed_one = {k: float(v) for k, v in mstep.train_step(batches[0], mg, gan_on=True).items()}
    del mstep
    mixed_err = (max(abs(got["mixed"][k] - v) / (abs(v) + 5e-4 / MP_TOL)
                     for k, v in mixed_one.items())
                 if set(got["mixed"]) == set(mixed_one) else np.inf)

    gen = _grid_setup(device)[1].gen.eval()
    clips, vocab, eps = _grid_synthesis_inputs()
    one = synthesis.synthesize_clips_batched(gen, clips, vocab, cfg, eps=torch.from_numpy(eps))
    del gen
    torch.cuda.empty_cache()
    synth_err = max(float(np.abs(a - b).max()) for mine, ref in zip(got["synthesis"], one)
                    for a, b in zip(mine, ref))
    synth = [json.loads((work / f"grid_synthesis_rank{r}.json").read_text())
             for r in range(n_ranks)]

    per_step = {k: v / GRID_STEPS for k, v in sorted(got["traffic"].items())}
    gru = {k: v / GRID_STEPS for k, v in got["launches"].items() if not re.search(r"_b\d", k)}
    mem = got["memory"]
    log(f"model parallel (a), a {GRID_SHAPE[0]} x {GRID_SHAPE[1]} (data, model) grid of gloo "
        f"ranks on one card, {TRAIN_BATCH // GRID_SHAPE[0]} rows a data rank of batch "
        f"{TRAIN_BATCH}, {GRID_WORDS} words, tp_min_cols {GRID_TP_COLS}: each step against one "
        f"process's from the same state, each check's error over its tolerance by step: "
        f"{[{k: round(v, 4) for k, v in e.items()} for e in errs]}; the data axis' ranks the "
        f"same bits after each step {got['synced']}; a clipped step ({GRID_CLIP}) "
        f"{ {k: round(v, 4) for k, v in checks['clipped'].items()} }; the mutants (each must "
        f"pass 1 somewhere): "
        f"{ {n: {k: round(v, 2) for k, v in checks[n].items()} for n in GRID_MUTANTS} }")
    log(f"model parallel (a) numbers ({smi}): step p50 {np.median(got['times']):.3f} ms with "
        f"four ranks sharing the card (all {[round(t, 3) for t in got['times']]}) against one "
        f"process's {np.median(times):.3f} ms ({[round(t, 3) for t in times]}); collectives a "
        f"step by axis {per_step}; a rank's parameters {mem['rank']['params']} bytes and Adam "
        f"moments {mem['rank']['adam']} bytes against the whole nets' {mem['whole']['params']} "
        f"and {mem['whole']['adam']}; peak allocated from the nets' set-up through the timed "
        f"steps, above what the process held before: rank 0 {got['peak']} bytes, one process "
        f"{one_peak}; split "
        f"shapes on rank 0 {got['shapes']}; GRU launches a step on rank 0 {gru}")
    log(f"model parallel (b), one mixed-precision step on the grid: metrics {got['mixed']}, "
        f"masters {got['mixed dtypes']}, the data axis' ranks in sync {got['mixed sync']}; "
        f"against one process's mixed step {mixed_err:.3e} relative (tol {MP_TOL})")
    log(f"model parallel (c), the batched synthesis of {len(clips)} clips of "
        f"{GRID_CLIPS} s on the grid (pad_to {GRID_SHAPE[0]}): largest difference from one "
        f"process's {synth_err:.3e} (tol {GRID_SYNTH_TOL}); each rank's launches and wall s "
        f"{synth}; ranks' part of the phase {ranks_s:.1f} s")
    n_cards = torch.cuda.device_count()
    if n_cards >= n_ranks:
        t_out = work / "grid_time.json"
        P.launch(_grid_time_rank, n_ranks, "nccl", args=(t_out,), timeout=DP_TIMEOUT)
        grid_times = json.loads(t_out.read_text())
        log(f"model parallel (d), the 2 x 2 grid over NCCL, a card a rank ({smi}): step p50 "
            f"{np.median(grid_times):.3f} ms (all {[round(t, 3) for t in grid_times]}) against "
            f"one process's {np.median(times):.3f} ms and the 1-D mesh's on four cards "
            f"{scaling.get('4 NCCL', float('nan')):.3f} ms (`data_parallel_phase` (c))")
    else:
        log(f"model parallel (d), the 2 x 2 grid over NCCL on four cards: not run, "
            f"{n_cards} card(s) visible (torch.cuda.device_count())")
    log(f"model parallel phase took {time.perf_counter() - t0:.1f} s")

    launches = collections.Counter(got["launches"])
    for r, each in enumerate(synth):
        if not (each["launches"]["gru_fwd"] > 0 and each["launches"]["mel_power"] > 0):
            raise AssertionError(f"rank {r}'s synthesis launched {each['launches']}")
    launches.update(synth[0]["launches"])
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        if launches[name] == 0 or launches[f"{name}_b{TRAIN_BATCH // GRID_SHAPE[0]}"] == 0:
            raise AssertionError(f"{name} did not run on the grid's rank 0")
    if got["kinds"] != got["placement"]:
        raise AssertionError(f"the grid's placement is not `placement`'s: {got['kinds']}")
    table, gates = got["shapes"]["gen.text_encoder.embedding.weight"], \
        got["shapes"]["gen.gru.weight_hh_l0"]
    hidden = cfg.hidden_size_s2eg
    if table != (GRID_WORDS // 2, cfg.wordembed_dim) or gates != (3 * hidden // 2, hidden):
        raise AssertionError(f"rank 0 holds the table as {table}, weight_hh as {gates}")
    if not all(v <= 1 for e in errs + [checks["clipped"]] for v in e.values()):
        raise AssertionError(f"the grid's step is not one process's: {errs}, {checks['clipped']}")
    if not all(max(checks[n].values()) > 1 for n in GRID_MUTANTS):
        raise AssertionError(f"the checks would pass a wrong grid: {checks}")
    if not mixed_err <= MP_TOL or got["mixed dtypes"] != ["torch.float32"]:
        raise AssertionError(f"the grid's mixed step: {mixed_err}, {got['mixed dtypes']}")
    if not synth_err <= GRID_SYNTH_TOL:
        raise AssertionError(f"the grid's synthesis is {synth_err} from one process's")
    return launches


def write_mpi_corpus(root: pathlib.Path, seed: int) -> tuple[pathlib.Path, pathlib.Path]:
    """A synthetic corpus in the MPI Emotional Body Expressions layout under
    root/mpi (tag_names.txt, tags/<clip>.txt, bvh/<clip>.bvh through the
    port's BVH writer: smooth random joint angles, a drifting root), and a
    GloVe-format text file of T2G_GLOVE_DIM floats a word for most of the
    vocabulary, all from `seed`. Returns (root, the GloVe file)."""
    import shutil

    from speech2affective_gestures_torch.render import bvh

    rng = np.random.default_rng(seed)
    mpi = root / "mpi"
    (mpi / "tags").mkdir(parents=True)
    (mpi / "bvh").mkdir()
    tag_names = ["ID", *MPI_TAGS, "Text"]
    (mpi / "tag_names.txt").write_text("".join(t + "\n" for t in tag_names))
    names = [n for n, _ in MPI_JOINTS]
    parents = [p for _, p in MPI_JOINTS]
    offsets = rng.uniform(-0.3, 0.3, (len(names), 3))
    offsets[0] = 0.0
    words = [f"w{i:03d}" for i in range(T2G_WORDS)]
    lengths = rng.integers(T2G_FRAMES[0], T2G_FRAMES[1] + 1, T2G_CLIPS)
    lengths[0] = T2G_FRAMES[1]
    for c, n in enumerate(lengths):
        t = np.arange(n)[:, None, None]
        shape = (1, len(names), 3)
        angles = rng.uniform(0.05, 0.6, shape) * np.sin(
            rng.uniform(0.02, 0.15, shape) * t + rng.uniform(0, 2 * np.pi, shape))
        positions = np.zeros((n, len(names), 3))
        positions[:, 0] = np.cumsum(rng.normal(0, 0.01, (n, 3)), axis=0)
        out = bvh.save_as_bvh({"joint_names": names, "joint_parents": parents,
                               "joint_offsets": offsets, "positions": positions,
                               "rotations": bvh.from_euler(angles, "xyz")}, str(root / "anim"))
        clip = f"clip_{c:03d}"
        shutil.move(out, mpi / "bvh" / f"{clip}.bvh")
        values = [clip] + [str(rng.integers(20, 70)) if cats is None else rng.choice(cats)
                           for cats in MPI_TAGS.values()]
        values.append(" ".join(rng.choice(words, rng.integers(5, 16))))
        (mpi / "tags" / f"{clip}.txt").write_text("".join(v + "\n" for v in values))
    glove = root / "glove.300d.txt"
    with open(glove, "w") as f:
        for w in words:
            if rng.random() < 0.9:    # the rest take the loader's random rows
                f.write(w + " " + " ".join(f"{x:.5f}" for x in
                                           rng.normal(0, 0.4, T2G_GLOVE_DIM)) + "\n")
    return root, glove


def _grad_errors(got: dict, want: dict, top: float | None = None) -> tuple[float, float]:
    """The largest gradient error, each tensor's relative to its largest
    value, a tensor whose gradient is zero but for rounding (its largest
    at most 1e-3 of the net's, `top`, by default the largest of `want`)
    relative to the net's largest; and that largest."""
    if top is None:
        top = max(w.abs().max().item() for w in want.values())
    worst = 0.0
    for name, w in want.items():
        scale = w.abs().max().item()
        scale = top if scale <= 1e-3 * top else scale
        worst = max(worst, (got[name].cpu() - w).abs().max().item() / scale)
    return worst, top


def t2g_step_parity(state: dict, arrays: dict, table, device) -> None:
    """One T2G step (`t2g_train_step`, dropout 0) from the same weights
    (`state`) and batch (the first T2G_BATCH clips) on the card and on the
    CPU plain path in float64, the reference, and in float32, whose
    distance is logged as a reading of float32 rounding and held to
    nothing: the card's loss within T2G_TOL relative; each of its gradients
    within T2G_TOL of its tensor's largest (`_grad_errors`); its weights
    after the update within T2G_TOL absolute, 2 lr where the float64
    gradient is zero but for rounding, at most 1e-6 of the net's largest
    (there Adam's first step is about sign(g) lr)."""
    import torch
    from speech2affective_gestures_torch.train import t2g_trainer as T2G

    lr = 1e-3
    nets, metrics = {}, {}
    for side, dev, dtype in (("card", device, torch.float32),
                             ("cpu", torch.device("cpu"), torch.float32),
                             ("float64", torch.device("cpu"), torch.float64)):
        net = T2G.build_t2g_net(table, arrays, dev, dropout=0.0)
        net.load_state_dict(state)
        net.to(dtype)
        data = {k: [t.to(dtype) for t in v] if k == "tags" else
                v.to(dtype) if v.is_floating_point() else v
                for k, v in T2G.to_device(arrays, dev).items()}
        metrics[side] = T2G.t2g_train_step(net, T2G.make_optimizer(net, lr),
                                           T2G.select(data, torch.arange(T2G_BATCH, device=dev)),
                                           arrays["n_joints"])
        nets[side] = {k: p for k, p in net.named_parameters()}
    want = {k: p.grad for k, p in nets["float64"].items()}
    loss_rel = abs(metrics["card"]["loss"].item() - metrics["float64"]["loss"].item()) \
        / abs(metrics["float64"]["loss"].item())
    top = max(w.abs().max().item() for w in want.values())
    worst = {"card": (0.0, ""), "cpu": (0.0, "")}
    for name, w in want.items():
        for side in worst:
            err = _grad_errors({name: nets[side][name].grad.double()}, {name: w}, top)[0]
            worst[side] = max(worst[side], (err, name))
    w_err = zero_err = 0.0
    for name, p in nets["float64"].items():
        err = (nets["card"][name].detach().cpu().double() - p.detach()).abs()
        near_zero = p.grad.abs() <= 1e-6 * top
        w_err = max(w_err, err[~near_zero].max().item() if (~near_zero).any() else 0.0)
        zero_err = max(zero_err, err[near_zero].max().item() if near_zero.any() else 0.0)
    log(f"t2g step (batch {T2G_BATCH}, dropout 0) against the CPU's float64 step: loss "
        f"{metrics['card']['loss'].item():.6f} against {metrics['float64']['loss'].item():.6f} "
        f"(relative {loss_rel:.3e}); gradients: the card's worst {worst['card'][0]:.3e} of its "
        f"tensor's largest ({worst['card'][1]}), the CPU float32 step's {worst['cpu'][0]:.3e} "
        f"({worst['cpu'][1]}, a reading); weights after the update {w_err:.3e} absolute, "
        f"where the float64 gradient is zero but for rounding {zero_err:.3e} (tol {T2G_TOL}, "
        f"{2 * lr})")
    if not (loss_rel <= T2G_TOL and worst["card"][0] <= T2G_TOL and w_err <= T2G_TOL
            and zero_err <= 2 * lr):
        raise AssertionError(f"the T2G step on the card disagrees with the CPU: {loss_rel}, "
                             f"{worst}, {w_err}, {zero_err}")


def t2g_phase(device, work: pathlib.Path, smi: str) -> None:
    """The text-to-gesture path on the card: `write_mpi_corpus`, loaded by
    `load_data_with_glove` (which writes its cache) and read again from the
    cache (the same corpus); `train_t2g` at its defaults for T2G_EPOCHS
    epochs (every loss finite); one step against the CPU
    (`t2g_step_parity`); the step's p50, launches and busy share; the
    greedy decode of T2G_DECODE_CLIPS clips over every frame: unit
    quaternions, the same bits twice, against the CPU decode; its wall
    time and launches."""
    import torch
    from speech2affective_gestures_torch.data import mpi_glove
    from speech2affective_gestures_torch.train import t2g_trainer as T2G

    t0 = time.perf_counter()
    root, glove = write_mpi_corpus(work / "t2g", seed=18)
    t1 = time.perf_counter()
    corpus = mpi_glove.load_data_with_glove(str(root), "mpi", str(glove))
    t2 = time.perf_counter()
    cache = root / "mpi" / "data_dict_glove_drop_1.npz"
    again = mpi_glove.load_data_with_glove(str(root), "mpi", str(glove))
    t3 = time.perf_counter()
    data_dict, word2idx, table, cats, max_t = corpus
    same = (cache.is_file() and again[1] == word2idx and np.array_equal(again[2], table)
            and again[4] == max_t == T2G_FRAMES[1] and sorted(again[0]) == sorted(data_dict)
            and all(np.array_equal(again[0][c]["rotations"], data_dict[c]["rotations"])
                    for c in data_dict))
    log(f"t2g corpus: {len(data_dict)} clips of a {len(MPI_JOINTS)}-joint skeleton, "
        f"max_time_steps {max_t}, {len(word2idx)} words, table {table.shape}; written in "
        f"{t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s, read from its cache in {t3 - t2:.2f} s "
        f"(the same corpus: {same})")
    if not (same and table.shape == (len(word2idx), T2G_GLOVE_DIM)):
        raise AssertionError("the T2G corpus read from its cache differs from the loaded one")

    t0 = time.perf_counter()
    out = T2G.train_t2g(data_dict, word2idx, table, cats, max_t, epochs=T2G_EPOCHS,
                        batch_size=T2G_BATCH, device=device)
    torch.cuda.synchronize()
    hist = out["history"]
    log(f"train_t2g on the card: {T2G_EPOCHS} epochs of {len(data_dict)} clips at batch "
        f"{T2G_BATCH} in {time.perf_counter() - t0:.1f} s; mean losses {hist}")
    if not (len(hist) == T2G_EPOCHS and np.isfinite(hist).all()):
        raise AssertionError(f"train_t2g's losses are not finite: {hist}")
    net, opt, arrays = out["net"], out["optimizer"], out["arrays"]
    t2g_step_parity({k: v.detach().clone() for k, v in net.state_dict().items()}, arrays,
                    table, device)

    n_joints = arrays["n_joints"]
    batch = T2G.select(T2G.to_device(arrays, device), torch.arange(T2G_BATCH, device=device))
    gen = torch.Generator(device=device).manual_seed(1)
    step_p50 = _p50_and_profile(
        f"t2g train step (batch {T2G_BATCH}, T {max_t}, quat_dim {4 * n_joints}, text width "
        f"{table.shape[1]}, 4 heads, 256 units, 2 layers a side)",
        lambda: T2G.t2g_train_step(net, opt, batch, n_joints, gen), smi, n=20)

    k = T2G_DECODE_CLIPS
    args = (arrays["text"][:k], [t[:k] for t in arrays["tags"]], arrays["offset_lengths"][:k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = T2G.generate_quat_sequence(net, *args, device=device)
    wall = time.perf_counter() - t0
    again = T2G.generate_quat_sequence(net, *args, device=device)
    norms = np.linalg.norm(got.reshape(k, max_t, -1, 4), axis=-1)
    norm_err = float(np.abs(norms - 1.0).max())
    prof = profile_device(f"t2g decode ({k} clips, {max_t} frames)", "decode",
                          lambda: T2G.generate_quat_sequence(net, *args, device=device), n=1)
    t0 = time.perf_counter()
    cpu = T2G.generate_quat_sequence(copy.deepcopy(net), *args, device="cpu")
    cpu_wall = time.perf_counter() - t0
    err = float(np.abs(got - cpu).max())
    log(f"t2g decode on the card: {k} clips x {max_t} frames in {wall:.3f} s wall "
        f"({1e3 * wall / max_t:.3f} ms a frame), "
        f"{'not measured' if prof is None else f'{prof[0]:.0f}'} launches, unit norms within "
        f"{norm_err:.2e}, the same bits twice {np.array_equal(got, again)}; against the CPU "
        f"decode ({cpu_wall:.1f} s) max_abs_err {err:.3e} (tol {T2G_TOL}); step p50 "
        f"{step_p50:.3f} ms; {smi}")
    if not (got.shape == (k, max_t, 4 * n_joints) and norm_err <= 1e-5
            and np.array_equal(got, again) and err <= T2G_TOL):
        raise AssertionError(f"the T2G decode on the card fails: {got.shape}, {norm_err}, "
                             f"{err}")


def _aux_inputs(device):
    """The auxiliary nets' inputs from a seed, on the CPU and on `device`."""
    import torch

    rng = np.random.default_rng(21)
    poses = (rng.standard_normal((AUX_DIS_BATCH, 34, 27)) * 0.3).astype(np.float32)
    cpu = {"in_text": torch.from_numpy(rng.integers(0, AUX_WORDS, (AUX_BATCH, 34))),
           "in_audio": torch.from_numpy((rng.standard_normal((AUX_BATCH, AUDIO_SAMPLES))
                                         * 0.1).astype(np.float32)),
           "poses": torch.from_numpy(poses[:AUX_BATCH]),
           "pre_poses": torch.from_numpy(poses[:AUX_BATCH, :4].copy()),
           "latent": torch.from_numpy(rng.standard_normal((AUX_BATCH, 32)).astype(np.float32)),
           "eps": torch.from_numpy(rng.standard_normal((AUX_BATCH, 32)).astype(np.float32)),
           "dis_poses": torch.from_numpy(poses),
           "text_feat": torch.from_numpy(rng.standard_normal((AUX_DIS_BATCH, 34, 32))
                                         .astype(np.float32))}
    return cpu, {k: v.to(device) for k, v in cpu.items()}


def _aux_run(net, call, x: dict, seed: int) -> tuple[list, dict]:
    """net's train-mode outputs on x, dropout masks from a CPU generator of
    `seed` (the same masks on either device), and the gradients of a fixed
    random weighting of them."""
    import torch
    from speech2affective_gestures_torch.models import layers as L

    net.train()
    with L.dropout_rng(torch.Generator().manual_seed(seed)):
        outs = [o for o in call(net, x) if o is not None]
    rng = np.random.default_rng(seed)
    weights = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
               .to(o.device) for o in outs]
    sum((o * w).sum() for o, w in zip(outs, weights)).backward()
    return ([o.detach() for o in outs],
            {k: p.grad for k, p in net.named_parameters() if p.grad is not None})


@contextlib.contextmanager
def _launches_by_layer(net, counts: collections.Counter):
    """`gru_cuda.gru_layer` wrapped while the block runs: the float32 GRU
    kernels' launches in each layer of net's one-direction GRUs of H
    CONTEXT_H (told apart by their recurrent biases), its forward's and its
    backward's (those between its autograd node's pre-hook and hook), added
    to counts[(kernel, the layer's input width)]."""
    import torch
    from speech2affective_gestures_torch.models import layers as L
    from speech2affective_gestures_torch.ops import gru_cuda

    layers = [(getattr(m, f"bias_hh_l{i}"), getattr(m, f"weight_ih_l{i}").shape[1])
              for m in net.modules() if isinstance(m, L.GRU)
              and m.hidden_size == CONTEXT_H and m.num_dir == 1
              for i in range(m.num_layers)]
    layer_fn = gru_cuda.gru_layer

    def add(cin, before):
        for (kernel, dtype), n in gru_cuda.launches.items():
            if dtype == "float32":
                counts[(kernel, cin)] += n - before[(kernel, dtype)]

    def counted(xp, w_hh, b_ih, b_hh):
        cin = next((c for b, c in layers if b_hh.shape == (1, *b.shape)
                    and torch.equal(b_hh[0], b)), None)
        before = collections.Counter(gru_cuda.launches)
        out, h_last = layer_fn(xp, w_hh, b_ih, b_hh)
        if cin is not None:
            add(cin, before)
            if out.grad_fn is not None:
                start = {}
                out.grad_fn.register_prehook(
                    lambda grads: start.update(at=collections.Counter(gru_cuda.launches)))
                out.grad_fn.register_hook(lambda grads_in, grads_out: add(cin, start["at"]))
        return out, h_last

    gru_cuda.gru_layer = counted
    try:
        yield
    finally:
        gru_cuda.gru_layer = layer_fn


def aux_nets_phase(device, smi: str) -> collections.Counter:
    """The auxiliary nets forward and backward in train mode on the card
    against the CPU plain path on the same weights (random, from a seed),
    inputs and dropout masks: `EmbeddingNet` in speech mode and in random
    mode (the generator's pick, each way) at batch AUX_BATCH on a window's
    raw audio, words of a AUX_WORDS-word vocabulary, 4 seed poses and 34
    poses; `PoseDecoderFC` with seed poses; `DiscriminatorTriModal` at
    batch AUX_DIS_BATCH with and without text features; each output and
    gradient within AUX_TOL. The counters are set to 0 just before the
    card's runs and read just after: the GRU forward, recurrence and dW
    must have run at (T 34, H CONTEXT_H), the context encoder's, and (T 34,
    H 300), the GRU decoder's and the discriminator's, and each launch at
    H CONTEXT_H in one of the context encoder's layers, counted by layer
    (`_launches_by_layer`). Returns the kernels' launches, those of each
    layer also under its row name ("gru_fwd_h256_x64", ...)."""
    import torch
    from speech2affective_gestures_torch.models import discriminator as Dis
    from speech2affective_gestures_torch.models import embedding_net as E
    from speech2affective_gestures_torch.ops import gru_cuda

    t0 = time.perf_counter()
    cpu_x, dev_x = _aux_inputs(device)
    picks = {}
    for seed in range(64):       # a generator seed for each pick
        g = torch.Generator(device=device).manual_seed(seed)
        picks.setdefault(bool(torch.rand((), generator=g, device=device) < 0.5), seed)
        if len(picks) == 2:
            break

    def embedding(pick):
        def call(net, x):
            kw = ({} if pick is None else
                  {"pick_speech": pick} if x["poses"].device.type == "cpu" else
                  {"generator": torch.Generator(device=device).manual_seed(picks[pick])})
            return net(x["poses"], in_text=x["in_text"], in_audio=x["in_audio"],
                       pre_poses=x["pre_poses"], context_eps=x["eps"], **kw)
        return call

    cases = [("EmbeddingNet speech", lambda: E.EmbeddingNet(mode="speech", n_words=AUX_WORDS),
              embedding(None))]
    cases += [(f"EmbeddingNet random ({'speech' if pick else 'pose'} pick)",
               lambda: E.EmbeddingNet(mode="random", n_words=AUX_WORDS), embedding(pick))
              for pick in (True, False)]
    cases += [("PoseDecoderFC with seed poses", lambda: E.PoseDecoderFC(34, 27, True),
               lambda net, x: (net(x["latent"], x["pre_poses"]),)),
              ("DiscriminatorTriModal", lambda: Dis.DiscriminatorTriModal(),
               lambda net, x: (net(x["dis_poses"]),)),
              ("DiscriminatorTriModal with text", lambda: Dis.DiscriminatorTriModal(text_size=32),
               lambda net, x: (net(x["dis_poses"], x["text_feat"]),))]
    launches = collections.Counter()
    shapes = collections.Counter()
    by_layer = collections.Counter()
    for i, (label, make, call) in enumerate(cases):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(30 + i)
            cpu_net = make()
        dev_net = copy.deepcopy(cpu_net).to(device)
        _reset_counters()
        with _launches_by_layer(dev_net, by_layer):
            got, got_grads = _aux_run(dev_net, call, dev_x, seed=40 + i)
        torch.cuda.synchronize()
        launches.update(_counters())
        shapes.update(gru_cuda.shape_launches)
        want, want_grads = _aux_run(cpu_net, call, cpu_x, seed=40 + i)
        out_err = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
        grad_err, _ = _grad_errors(got_grads, want_grads)
        log(f"aux nets: {label} on the card against the CPU, train mode: outputs "
            f"max_abs_err {out_err:.3e}, gradients {grad_err:.3e} of each tensor's largest "
            f"(tol {AUX_TOL}); {len(want_grads)} parameter tensors")
        if not (len(got) == len(want) and sorted(got_grads) == sorted(want_grads)
                and out_err <= AUX_TOL and grad_err <= AUX_TOL):
            raise AssertionError(f"{label} on the card disagrees with the CPU: {out_err}, "
                                 f"{grad_err}")
    kernels = ("gru_fwd", "gru_bwd", "gru_dw")
    ran = {(k, H): shapes[(k, "float32", 34, H)] for k in kernels for H in (CONTEXT_H, 300)}
    layer_ran = {(k, cin): by_layer[(k, cin)] for k in kernels for cin in CONTEXT_INPUTS}
    log(f"aux nets: GRU launches at (T 34, H): {ran}; at H {CONTEXT_H} by the context "
        f"encoder's layer (kernel, input width): {layer_ran}; the phase took "
        f"{time.perf_counter() - t0:.1f} s; {smi}")
    if not (all(ran.values()) and all(layer_ran.values()) and all(
            sum(layer_ran[(k, cin)] for cin in CONTEXT_INPUTS) == ran[(k, CONTEXT_H)]
            for k in kernels)):
        raise AssertionError(f"a GRU kernel did not run at the aux nets' shapes, or not in "
                             f"each context encoder layer: {ran}, {layer_ran}")
    for (k, cin), n in layer_ran.items():
        launches[f"{k}_h{CONTEXT_H}_x{cin}"] = n
    return launches


def context_kernel_phase(device) -> dict:
    """The float32 GRU kernels at the context encoder's shape (T 34, B
    AUX_BATCH, H CONTEXT_H, D 1; 64 inputs, then 256): `shape_kernel_phase`,
    under "gru_fwd_h256_x64", ..., "gru_dw_h256_x256"."""
    errs = {}
    for cin in CONTEXT_INPUTS:
        errs.update(shape_kernel_phase(device, 34, AUX_BATCH, ((CONTEXT_H, cin),),
                                       f"_h{CONTEXT_H}_x{cin}", "the context encoder's GRU",
                                       D=1, dtypes=("float32",)))
    return errs


def context_timing(device) -> list:
    """The float32 GRU kernels at the context encoder's shape, each layer's
    input width: `shape_timing` with cuDNN's unidirectional `nn.GRU`."""
    rows = []
    for cin in CONTEXT_INPUTS:
        rows += shape_timing(device, 34, AUX_BATCH, CONTEXT_H, cin, f"_h{CONTEXT_H}_x{cin}",
                             "the context encoder's GRU", seed=cin, D=1, dtypes=("float32",))
    return rows


def bound(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    """The least time of a function on the card: its bytes over the memory
    rate or its operations over the peak rate of their type (float32
    outside the tensor cores; PEAK_BF16_FLOPS for bf16), whichever is
    larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _lib_w_ih(lib):
    """The input weights of a one-layer `nn.GRU`, both directions' stacked."""
    import torch

    return torch.cat([lib.weight_ih_l0] + ([lib.weight_ih_l0_reverse] if lib.bidirectional
                                           else [])).detach()


def cudnn_recurrent_fwd(lib, x) -> tuple[float, float]:
    """cuDNN's recurrent forward: the forward of the one-layer `nn.GRU` lib
    on x (T, B, cin) less its input projection's matmul, in ms by CUDA
    events and by device time (`device_ms`, which counts a bidirectional
    GRU's two overlapping directions once)."""
    import torch

    w_ih = _lib_w_ih(lib)
    with torch.no_grad():
        def full():
            return lib(x)

        def proj():
            return torch.matmul(x, w_ih.t())

        return (time_ms(full, iters=10) - time_ms(proj, iters=10),
                device_ms(full, n=10) - device_ms(proj, n=10))


def cudnn_recurrent_bwd(lib, x, dys, dh) -> tuple[float, float]:
    """cuDNN's recurrent backward, its dW_hh and bias gradients included:
    the forward + backward of the one-layer `nn.GRU` lib on x (T, B, cin,
    requiring grad) with the output gradients (dys, dh), less its forward
    and less the input projection's two backward products, in ms by CUDA
    events and by device time."""
    import torch

    w_ih = _lib_w_ih(lib)
    xd = x.detach()
    T, B, cin = x.shape
    dxp = torch.randn(T, B, w_ih.shape[0], device=x.device, dtype=x.dtype)
    leaves = [x, *lib.parameters()]

    def full():
        return torch.autograd.grad(lib(x), leaves, (dys, dh))

    def fwd():
        return lib(x)

    def proj_bwd():
        return (torch.matmul(dxp, w_ih),
                torch.matmul(dxp.reshape(-1, w_ih.shape[0]).t(), xd.reshape(-1, cin)))

    return (time_ms(full, iters=10) - time_ms(fwd, iters=10) - time_ms(proj_bwd, iters=10),
            device_ms(full, n=10) - device_ms(fwd, n=10) - device_ms(proj_bwd, n=10))


def rfft_mel(frames, n_mels: int = 128):
    """The mel kernel's library yardstick on frames (R, n_fft), as a
    function of no arguments: `torch.fft.rfft`, the power, and the product
    with the dense filterbank (16 kHz, n_mels mels)."""
    import torch
    from speech2affective_gestures_torch.ops import dsp_ref

    fb = dsp_ref.mel_filterbank(16000, frames.shape[-1], n_mels).T.astype(np.float32)
    fb = torch.from_numpy(np.ascontiguousarray(fb)).to(frames.device)

    def run():
        spec = torch.fft.rfft(frames, dim=-1)
        return (spec.real ** 2 + spec.imag ** 2) @ fb
    return run


def layer_times(T, B, cin, H, device, seed=9, backward_device=True) -> dict:
    """One bidirectional GRU layer at its real input width, the port's
    (`models.layers.GRU`: the input projection's matmul, then the forward
    kernel; under autograd the backward kernels and the projection's two
    matmuls) against cuDNN's `nn.GRU` with the same weights: forward (no
    grad) and forward + backward ms of each, the largest difference of
    their outputs and of their gradients, and the input projection's
    products timed alone (its forward matmul; the two matmuls of its
    backward), so that cuDNN's recurrent part reads as its time less
    theirs; with `backward_device` the backward's device times too."""
    import torch
    from speech2affective_gestures_torch.models import layers as L

    torch.manual_seed(seed)
    port = L.GRU(cin, H, num_layers=1, bidirectional=True).to(device)
    lib = torch.nn.GRU(cin, H, bidirectional=True).to(device)
    lib.load_state_dict(port.state_dict())
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, cin, generator=g).to(device).requires_grad_()
    dys = torch.randn(T, B, 2 * H, generator=g).to(device)
    dh = torch.randn(2, B, H, generator=g).to(device)
    dxp = torch.randn(T, B, 6 * H, generator=g).to(device)
    runs = {"port": (port, lambda: port(x.transpose(0, 1))), "cuDNN": (lib, lambda: lib(x))}
    out, grads = {}, {}
    for name, (module, fn) in runs.items():
        ys, h_last = fn()
        grads[name] = torch.autograd.grad((ys, h_last), [x, *module.parameters()],
                                          (dys, dh))
        out[f"{name} ys"] = torch.cat([ys.detach().flatten(), h_last.detach().flatten()])
        with torch.no_grad():
            out[f"{name} fwd"] = time_ms(fn, iters=10)

        def fwd_bwd(fn=fn):
            ys, h_last = fn()
            torch.autograd.backward((ys, h_last), (dys, dh))

        # the backward alone: forward + backward less the forward that
        # saves for it, by events and by device time
        out[f"{name} bwd"] = time_ms(fwd_bwd, iters=10) - time_ms(fn, iters=10)
        if backward_device:
            out[f"{name} bwd device"] = device_ms(fwd_bwd, n=10) - device_ms(fn, n=10)
    out["max_abs_err"] = (out.pop("port ys") - out.pop("cuDNN ys")).abs().max().item()
    out["grad_rel"] = max(_rel(a, b) for a, b in zip(grads["port"], grads["cuDNN"]))
    w_ih = torch.cat([lib.weight_ih_l0, lib.weight_ih_l0_reverse]).detach()
    xd = x.detach()

    def proj_bwd():
        return (torch.matmul(dxp, w_ih),
                torch.matmul(dxp.reshape(-1, 6 * H).t(), xd.reshape(-1, cin)))

    out["proj fwd"] = time_ms(lambda: torch.matmul(xd, w_ih.t()), iters=10)
    out["proj bwd"] = time_ms(proj_bwd, iters=10)
    out["cuDNN recurrent fwd"] = out["cuDNN fwd"] - out["proj fwd"]
    out["cuDNN recurrent bwd"] = out["cuDNN bwd"] - out["proj bwd"]
    if backward_device:
        out["cuDNN recurrent bwd device"] = (out["cuDNN bwd device"]
                                             - device_ms(proj_bwd, n=10))
    out["cuDNN recurrent fwd device"] = cudnn_recurrent_fwd(lib, xd)[1]
    log(f"GRU layer T={T} B={B} cin={cin} H={H} D=2, port against cuDNN nn.GRU "
        f"(same weights): outputs max_abs_err={out['max_abs_err']:.3e}, gradients "
        f"relative to each largest {out['grad_rel']:.3e}; forward {out['port fwd']:.4f} "
        f"vs {out['cuDNN fwd']:.4f} ms, backward {out['port bwd']:.4f} vs "
        f"{out['cuDNN bwd']:.4f} ms; the input projection's matmuls forward "
        f"{out['proj fwd']:.4f} ms, backward {out['proj bwd']:.4f} ms; cuDNN less "
        f"them: forward {out['cuDNN recurrent fwd']:.4f} ms, backward "
        f"{out['cuDNN recurrent bwd']:.4f} ms; by device time: cuDNN's recurrent forward "
        f"{out['cuDNN recurrent fwd device']:.4f} ms"
        + (f", backward (its dW_hh included) {out['cuDNN recurrent bwd device']:.4f} ms; "
           f"the port's backward {out['port bwd device']:.4f} ms" if backward_device else ""))
    return out


def bwd_timing(device):
    """The backward kernels at the training shapes: (name, source, replaces,
    ms, plain ms, library ms, bytes, FLOP, device ms, library device ms)
    rows for the generator's shape (T 34, B 512, H 300, D 2, a later
    layer's 600 inputs), and log lines for the discriminator's (H 64), for
    the forward kernel at B 512 (with and without hp saved) and for the
    L2 tier's hidden sizes; then the walk layout's (`run_layer`) three
    kernels at the generator's shape, with their forward also at B 1."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    rows = []
    T, B, D = 34, 512, 2
    for H, cin in ((300, 600), (64, 128)):
        xp, w_hh, b_ih, b_hh = gru_inputs(T, B, cin, H, D, seed=9, device=device)
        g = torch.Generator().manual_seed(9)
        dys = torch.randn(T, B, D * H, generator=g).to(device)
        ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
        dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
        args = (xp, w_hh, b_ih, b_hh, ys, dys, hp)

        def rec():
            return gru_cuda.gru_bwd_recurrence(*args)

        def dw():
            return gru_cuda.gru_dw(ys, dxp, gn, D)

        def both():
            return gru_cuda.gru_layer_bwd(*args[:6], hp=hp)

        bwd_ms, bwd_dev = time_ms(rec, iters=10), device_ms(rec, n=10)
        bwd_plain = time_ms(lambda: gru_cuda.gru_bwd_recurrence_plain(*args), iters=5)
        dw_ms, dw_dev = time_ms(dw, iters=10), device_ms(dw, n=10)
        dw_plain = time_ms(lambda: gru_cuda.gru_dw_plain(ys, dxp, gn, D), iters=10)
        # cuBLAS's product h_prev^T g on operands laid out for it (their
        # preparation not timed)
        hprev = gru_cuda._prev_states(ys, D).contiguous()
        g_op = torch.cat([dxp.view(T, B, D, 3 * H)[..., :2 * H],
                          gn.view(T, B, D, H)], dim=-1).contiguous()

        def cublas():
            return torch.einsum("tbdk,tbdj->dkj", hprev, g_op)

        dw_lib, dw_lib_dev = time_ms(cublas, iters=10), device_ms(cublas, n=10)
        layer_ms, layer_dev = time_ms(both, iters=10), device_ms(both, n=10)
        # cuDNN's recurrent backward (its dx of the recurrence, dW_hh and
        # the biases) at the layer's real width: its backward less the input
        # projection's two matmuls
        lt = layer_times(T, B, cin, H, device)
        lib_ms, lib_dev = lt["cuDNN recurrent bwd"], lt["cuDNN recurrent bwd device"]
        n_rec = 2 * T * B * D * H * 3 * H
        rec_flops = n_rec + 30 * T * B * D * H
        # reads xp, hp, ys, dys and the weights; writes dxp and gn
        rec_bytes = 4 * (3 * xp.numel() + 3 * ys.numel() + w_hh.numel() + b_ih.numel())
        dw_flops = 2 * T * B * D * (H + 1) * 3 * H
        dw_bytes = 4 * (ys.numel() + 2 * xp.numel() // 3 + gn.numel()
                        + w_hh.numel() + b_hh.numel())
        # the whole backward reads xp, hp, ys, dys and the weights once and
        # writes dxp and the weight gradients once
        both_b, both_by = bound(4 * (3 * xp.numel() + 2 * ys.numel() + 2 * w_hh.numel()
                                     + 2 * b_ih.numel() + 2 * b_hh.numel()),
                                n_rec + dw_flops)
        log(f"gru backward T={T} B={B} H={H} D={D}: recurrence {bwd_ms:.4f} ms, by device "
            f"time {bwd_dev:.4f} (plain {bwd_plain:.4f}); dW {dw_ms:.4f} ms, by device time "
            f"{dw_dev:.4f} (plain {dw_plain:.4f}; cuBLAS product {dw_lib:.4f}, by device "
            f"time {dw_lib_dev:.4f}); recurrence + dW (gru_layer_bwd: recurrence, dW_hh, "
            f"db_ih) {layer_ms:.4f} ms, by device time {layer_dev:.4f}, against cuDNN's "
            f"recurrent backward (its dW_hh included) {lib_ms:.4f} ms, by device time "
            f"{lib_dev:.4f}; bound of the three {both_b:.5f} ms ({both_by}; "
            f"{n_rec + dw_flops} FLOP); plans {gru_cuda._device_bwd_plan(device, B, H, D)._asdict()}, "
            f"{gru_cuda.dw_plan(T, B, H, D, torch.cuda.get_device_properties(device).multi_processor_count)._asdict()}")
        if H == 300:
            src = "speech2affective_gestures_torch/csrc/gru_bwd.cu"
            rows.append(("gru_bwd", src, "speech2affective_gestures_tpu/ops/gru_pallas.py:384",
                         bwd_ms, bwd_plain, lib_ms, rec_bytes, rec_flops, bwd_dev, lib_dev))
            rows.append(("gru_dw", src, "speech2affective_gestures_tpu/ops/gru_pallas.py:432",
                         dw_ms, dw_plain, dw_lib, dw_bytes, dw_flops, dw_dev, dw_lib_dev))
        # the forward kernel at the training batch (and, at H 300, the
        # scoring batch), and what saving hp costs it
        for fb in (B, 258) if H == 300 else (B,):
            fargs = gru_inputs(T, fb, cin, H, D, seed=9, device=device)
            f_ms = time_ms(lambda: gru_cuda.gru_layer_forward(*fargs), iters=10)
            f_dev = device_ms(lambda: gru_cuda.gru_layer_forward(*fargs))
            f_hp = device_ms(lambda: gru_cuda.gru_layer_forward(*fargs, save_hp=True))
            f_plain = time_ms(lambda: gru_cuda.gru_layer_plain(*fargs), iters=5)
            f_bound, f_by = bound(
                4 * (fargs[0].numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                     + T * fb * D * H + D * fb * H),
                T * D * fb * (2 * H * 3 * H + 3 * H + 12 * H))
            lib = (f"cuDNN's recurrent forward {lt['cuDNN recurrent fwd']:.4f} ms, by device "
                   f"time {lt['cuDNN recurrent fwd device']:.4f} ms, " if fb == B else "")
            log(f"gru_fwd T={T} B={fb} H={H} D={D}: {f_ms:.4f} ms, by device time "
                f"{f_dev:.4f} ms ({f_hp:.4f} with hp saved), plain {f_plain:.4f} ms, {lib}"
                f"bound {f_bound:.5f} ms ({f_by}); plan "
                f"{gru_cuda._device_plan(device, fb, H, D)._asdict()}")
        if H == 300:
            rows += v1_timing(device, lt)
    l2_timing(device)
    return rows


def l2_timing(device) -> None:
    """The GRU kernels' L2 tier (hidden sizes past 320, W_hh beyond a
    cluster's registers) at T 34, D 2, layer input 64: the forward at B 1
    and 512 and the recurrence and dW at B 512, by device time, beside
    their bounds."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    T, D = 34, 2
    for H in L2_HIDDEN[1:]:
        for B in (1, 512):
            xp, w_hh, b_ih, b_hh = gru_inputs(T, B, 64, H, D, seed=9, device=device)
            f_dev = device_ms(lambda: gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh), n=5)
            f_bound, f_by = bound(
                4 * (xp.numel() + w_hh.numel() + 2 * b_hh.numel() + T * B * D * H),
                T * D * B * (2 * H * 3 * H + 15 * H))
            line = (f"L2 tier H={H} B={B} T={T} D={D}: gru_fwd by device time {f_dev:.4f} ms, "
                    f"bound {f_bound:.5f} ms ({f_by}); plan "
                    f"{gru_cuda._device_plan(device, B, H, D)._asdict()}")
            if B > 1:
                dys = torch.randn(T, B, D * H, generator=torch.Generator().manual_seed(H)
                                  ).to(device)
                ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
                dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
                r_dev = device_ms(lambda: gru_cuda.gru_bwd_recurrence(
                    xp, w_hh, b_ih, b_hh, ys, dys, hp), n=5)
                d_dev = device_ms(lambda: gru_cuda.gru_dw(ys, dxp, gn, D), n=5)
                r_bound, _ = bound(4 * (3 * xp.numel() + 3 * ys.numel() + w_hh.numel()),
                                   2 * T * B * D * H * 3 * H)
                d_bound, _ = bound(4 * (ys.numel() + 2 * xp.numel() // 3 + gn.numel()),
                                   2 * T * B * D * (H + 1) * 3 * H)
                line += (f"; recurrence {r_dev:.4f} ms (bound {r_bound:.5f}), dW {d_dev:.4f} "
                         f"ms (bound {d_bound:.5f}); recurrence plan "
                         f"{gru_cuda._device_bwd_plan(device, B, H, D)._asdict()}")
            log(line)


def v1_timing(device, lt) -> list:
    """The walk layout's three kernels at the generator's training shape
    (T 34, B 512, H 300, D 2): rows as `bwd_timing`'s, the library times
    cuDNN's recurrent forward and backward from `lt` (the same shape) and
    cuBLAS's dW product on prepared operands; the forward also at B 1."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    fwd_src = "speech2affective_gestures_torch/csrc/gru_fwd.cu"
    bwd_src = "speech2affective_gestures_torch/csrc/gru_bwd.cu"
    tpu = "speech2affective_gestures_tpu/ops/gru_pallas.py"
    T, H, D = 34, 300, 2
    rows = []
    for B in (1, 512):
        xw, w_hh, b_hh, _ = v1_inputs(T, B, 600, H, D, seed=9, device=device)
        ys, hp = gru_cuda.run_layer_forward(xw, w_hh, b_hh, save_hp=True)
        fwd_ms = time_ms(lambda: gru_cuda.run_layer_forward(xw, w_hh, b_hh), iters=10)
        fwd_dev = device_ms(lambda: gru_cuda.run_layer_forward(xw, w_hh, b_hh))
        fwd_plain = time_ms(lambda: gru_cuda.run_layer_plain(xw, w_hh, b_hh), iters=5)
        n_cell = T * D * B * (2 * H * 3 * H + 3 * H + 12 * H)
        fwd_bytes = 4 * (xw.numel() + w_hh.numel() + b_hh.numel() + ys.numel())
        if B == 1:
            b_ms, b_by = bound(fwd_bytes, n_cell)
            log(f"gru_fwd_v1 T={T} B=1 H={H} D={D}: {fwd_ms:.4f} ms, by device time "
                f"{fwd_dev:.4f} ms, plain {fwd_plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            continue
        g = torch.Generator().manual_seed(9)
        dys = torch.randn(T, D, B, H, generator=g).to(device)
        args = (xw, w_hh, b_hh, ys, dys, hp)
        dxp, gn = gru_cuda.run_layer_bwd_recurrence(*args)
        bwd_ms = time_ms(lambda: gru_cuda.run_layer_bwd_recurrence(*args), iters=10)
        bwd_dev = device_ms(lambda: gru_cuda.run_layer_bwd_recurrence(*args), n=10)
        bwd_plain = time_ms(lambda: gru_cuda.run_layer_bwd_recurrence_plain(*args), iters=5)
        dw_ms = time_ms(lambda: gru_cuda.run_layer_dw(ys, dxp, gn), iters=10)
        dw_dev = device_ms(lambda: gru_cuda.run_layer_dw(ys, dxp, gn), n=10)
        dw_plain = time_ms(lambda: gru_cuda.run_layer_dw_plain(ys, dxp, gn), iters=10)
        hprev = gru_cuda._walk_prev(ys).contiguous()
        g_op = torch.cat([dxp[..., :2 * H], gn], dim=-1).contiguous()

        def cublas():
            return torch.einsum("tdbk,tdbj->dkj", hprev, g_op)

        dw_lib, dw_lib_dev = time_ms(cublas, iters=10), device_ms(cublas, n=10)
        n_rec = 2 * T * B * D * H * 3 * H
        dw_flops = 2 * T * B * D * (H + 1) * 3 * H
        rows += [
            ("gru_fwd_v1", fwd_src, f"{tpu}:66", fwd_ms, fwd_plain, lt["cuDNN recurrent fwd"],
             fwd_bytes, n_cell, fwd_dev, lt["cuDNN recurrent fwd device"]),
            ("gru_bwd_v1", bwd_src, f"{tpu}:123", bwd_ms, bwd_plain, lt["cuDNN recurrent bwd"],
             4 * (3 * xw.numel() + 3 * ys.numel() + w_hh.numel()),
             n_rec + 30 * T * B * D * H, bwd_dev, lt["cuDNN recurrent bwd device"]),
            ("gru_dw_v1", bwd_src, f"{tpu}:178", dw_ms, dw_plain, dw_lib,
             4 * (ys.numel() + 2 * xw.numel() // 3 + gn.numel() + w_hh.numel()
                  + b_hh.numel()), dw_flops, dw_dev, dw_lib_dev),
        ]
        log(f"gru v1 T={T} B={B} H={H} D={D}: forward {fwd_ms:.4f} ms (by device time "
            f"{fwd_dev:.4f}; plain "
            f"{fwd_plain:.4f}), recurrence {bwd_ms:.4f} ms (by device time {bwd_dev:.4f}; "
            f"plain {bwd_plain:.4f}), dW {dw_ms:.4f} ms (by device time {dw_dev:.4f}; plain "
            f"{dw_plain:.4f}, cuBLAS product {dw_lib:.4f}, by device time {dw_lib_dev:.4f})")
    return rows


def bf16_timing(device) -> list:
    """The GRU kernels' bf16 instances at the generator's training shape
    (T 34, B 512, H 300, D 2, layer input 600), model and walk layouts:
    rows as `bwd_timing`'s with the bf16 peak, bounds of bf16 bytes (hp
    float32, dW_hh and db_hh float32) and of the products' operations at
    the tensor-core rate; library times cuDNN's bf16 `nn.GRU` less its
    input projection (forward; backward with dW_hh) and cuBLAS's bf16 dW
    product on prepared operands. Log lines for the forward at B 1 and at
    the discriminator's H 64, and for both register-range tiers of the
    forward and of the recurrence across batches (the readings behind
    `gru_cuda.TENSOR_MIN_WORK` and `BWD_TENSOR_MIN_WORK`)."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    bf16 = torch.bfloat16
    fwd_src = "speech2affective_gestures_torch/csrc/gru_fwd.cu"
    bwd_src = "speech2affective_gestures_torch/csrc/gru_bwd.cu"
    tpu = "speech2affective_gestures_tpu/ops/gru_pallas.py"
    T, B, H, D, cin = 34, 512, 300, 2, 600
    xp, w_hh, b_ih, b_hh = (t.to(bf16).contiguous()
                            for t in gru_inputs(T, B, cin, H, D, seed=9, device=device))
    g = torch.Generator().manual_seed(9)
    dys = torch.randn(T, B, D * H, generator=g).to(device, bf16)
    dh = torch.randn(D, B, H, generator=g).to(device, bf16)
    ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
    dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
    fwd = lambda: gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)  # noqa: E731
    rec = lambda: gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)  # noqa: E731
    dw = lambda: gru_cuda.gru_dw(ys, dxp, gn, D)  # noqa: E731
    times = {name: (time_ms(fn, iters=10), device_ms(fn, n=10))
             for name, fn in (("fwd", fwd), ("rec", rec), ("dw", dw))}
    plain = {"fwd": time_ms(lambda: gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh), iters=5),
             "rec": time_ms(lambda: gru_cuda.gru_bwd_recurrence_plain(
                 xp, w_hh, b_ih, b_hh, ys, dys, hp), iters=5),
             "dw": time_ms(lambda: gru_cuda.gru_dw_plain(ys, dxp, gn, D), iters=10)}
    # cuDNN's bf16 GRU at the layer's width, less its input projection
    torch.manual_seed(9)
    lib = torch.nn.GRU(cin, H, bidirectional=True).to(device, bf16)
    x = torch.randn(T, B, cin, generator=g).to(device, bf16)
    lib_fwd = cudnn_recurrent_fwd(lib, x)
    lib_bwd = cudnn_recurrent_bwd(lib, x.clone().requires_grad_(), dys, dh)
    hprev = gru_cuda._prev_states(ys, D).contiguous()
    g_op = torch.cat([dxp.view(T, B, D, 3 * H)[..., :2 * H], gn.view(T, B, D, H)],
                     dim=-1).contiguous()

    def cublas():
        return torch.einsum("tbdk,tbdj->dkj", hprev, g_op)

    lib_dw = (time_ms(cublas, iters=10), device_ms(cublas, n=10))
    n_prod = 2 * T * B * D * H * 3 * H
    fwd_flops = n_prod + T * B * D * 15 * H
    rec_flops = n_prod + 30 * T * B * D * H
    dw_flops = 2 * T * B * D * (H + 1) * 3 * H
    # bf16 values 2 bytes, hp and the weight gradients 4
    fwd_bytes = 2 * (xp.numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                     + ys.numel() + D * B * H)
    rec_bytes = 2 * (2 * xp.numel() + 3 * ys.numel() + w_hh.numel() + b_ih.numel()) \
        + 4 * hp.numel()
    dw_bytes = 2 * (ys.numel() + 2 * xp.numel() // 3 + gn.numel()) \
        + 4 * (w_hh.numel() + b_hh.numel())
    rows = [
        ("gru_fwd_bf16", fwd_src, f"{tpu}:338", times["fwd"][0], plain["fwd"], lib_fwd[0],
         fwd_bytes, fwd_flops, times["fwd"][1], lib_fwd[1], PEAK_BF16_FLOPS),
        ("gru_bwd_bf16", bwd_src, f"{tpu}:384", times["rec"][0], plain["rec"], lib_bwd[0],
         rec_bytes, rec_flops, times["rec"][1], lib_bwd[1], PEAK_BF16_FLOPS),
        ("gru_dw_bf16", bwd_src, f"{tpu}:432", times["dw"][0], plain["dw"], lib_dw[0],
         dw_bytes, dw_flops, times["dw"][1], lib_dw[1], PEAK_BF16_FLOPS),
    ]
    f32 = gru_inputs(T, B, cin, H, D, seed=9, device=device)
    log(f"gru bf16 T={T} B={B} H={H} D={D}: forward (tier "
        f"{gru_cuda._device_plan(device, B, H, D, bf16).tier}) {times['fwd']} ms (events, device), "
        f"float32 forward by device time "
        f"{device_ms(lambda: gru_cuda.gru_layer_forward(*f32), n=10):.4f}; recurrence "
        f"{times['rec']}; dW {times['dw']}; cuDNN bf16 recurrent forward {lib_fwd}, "
        f"backward with dW_hh {lib_bwd}; cuBLAS bf16 dW product {lib_dw}")
    for fb, fh, fc in ((1, 300, 600), (24, 300, 600), (32, 300, 600), (64, 300, 600),
                       (258, 300, 600), (512, 64, 128)):
        a = [t.to(bf16).contiguous() for t in gru_inputs(T, fb, fc, fh, D, seed=9,
                                                         device=device)]
        # both register-range tiers at this batch, each with its own plan
        # (the comparison behind gru_cuda.TENSOR_MIN_WORK)
        tiers = {}
        for tier in ("registers", "tensor"):
            plan = gru_cuda.fwd_plan(fb, fh, D, gru_cuda.max_clusters(device, fh, "fwd", bf16,
                                                                    tier), tier)
            run = lambda: gru_cuda._forward_launch(*a, plan, False)  # noqa: E731
            tiers[tier] = (round(time_ms(run), 4), round(device_ms(run), 4))
        b_ms, b_by = bound(2 * (sum(t.numel() for t in a) + T * fb * D * fh + D * fb * fh),
                           2 * T * fb * D * fh * 3 * fh + T * fb * D * 15 * fh, PEAK_BF16_FLOPS)
        log(f"gru_fwd_bf16 T={T} B={fb} H={fh} D={D}: "
            f"{time_ms(lambda: gru_cuda.gru_layer_forward(*a)):.4f} ms, by device time "
            f"{device_ms(lambda: gru_cuda.gru_layer_forward(*a)):.4f} ms; plain "
            f"{time_ms(lambda: gru_cuda.gru_layer_plain(*a), iters=5):.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}); plan {gru_cuda._device_plan(device, fb, fh, D, bf16)._asdict()}; "
            f"each tier (events, device ms) {tiers}")
    # both register-range tiers of the recurrence, each with its own plan
    for rb, rh, rc in ((1, 300, 600), (5, 300, 600), (16, 300, 600), (32, 300, 600),
                       (64, 300, 600), (258, 300, 600), (512, 300, 600), (512, 64, 128),
                       (512, 40, 128)):
        a = [t.to(bf16).contiguous() for t in gru_inputs(T, rb, rc, rh, D, seed=9,
                                                         device=device)]
        ry, _, rhp = gru_cuda.gru_layer_forward(*a, save_hp=True)
        rdy = torch.randn(ry.shape, generator=torch.Generator().manual_seed(rb)).to(device, bf16)
        b_in = gru_cuda.kernel_biases(a[2], a[3], rh)[0]
        tiers = {}
        for tier in ("registers", "tensor"):
            plan = gru_cuda.bwd_plan(rb, rh, D, gru_cuda.max_clusters(device, rh, "bwd", bf16,
                                                                     tier), tier)
            def run():
                return gru_cuda._recurrence_launch(False, a[0], a[1], b_in, rhp, ry, rdy, plan)
            tiers[tier] = (round(time_ms(run), 4), round(device_ms(run), 4))
        log(f"gru_bwd_bf16 T={T} B={rb} H={rh} D={D}: plan's tier "
            f"{gru_cuda.bwd_tier(rb, rh, bf16)}; each tier (events, device ms) {tiers}")
    # the walk layout's instances at the same shape
    xw, wv, bv = (t.to(bf16).contiguous()
                  for t in v1_inputs(T, B, cin, H, D, seed=9, device=device)[:3])
    yw, hpw = gru_cuda.run_layer_forward(xw, wv, bv, save_hp=True)
    dyw = torch.randn(T, D, B, H, generator=g).to(device, bf16)
    dxw, gnw = gru_cuda.run_layer_bwd_recurrence(xw, wv, bv, yw, dyw, hpw)
    v1 = {"fwd": lambda: gru_cuda.run_layer_forward(xw, wv, bv),
          "rec": lambda: gru_cuda.run_layer_bwd_recurrence(xw, wv, bv, yw, dyw, hpw),
          "dw": lambda: gru_cuda.run_layer_dw(yw, dxw, gnw)}
    v1_plain = {"fwd": lambda: gru_cuda.run_layer_plain(xw, wv, bv),
                "rec": lambda: gru_cuda.run_layer_bwd_recurrence_plain(xw, wv, bv, yw, dyw,
                                                                       hpw),
                "dw": lambda: gru_cuda.run_layer_dw_plain(yw, dxw, gnw)}
    for name, key, replaces, src, nb, fl, lib_t in (
            ("gru_fwd_v1_bf16", "fwd", f"{tpu}:66", fwd_src, fwd_bytes, fwd_flops, lib_fwd),
            ("gru_bwd_v1_bf16", "rec", f"{tpu}:123", bwd_src, rec_bytes, rec_flops, lib_bwd),
            ("gru_dw_v1_bf16", "dw", f"{tpu}:178", bwd_src, dw_bytes, dw_flops, lib_dw)):
        rows.append((name, src, replaces, time_ms(v1[key], iters=10),
                     time_ms(v1_plain[key], iters=5), lib_t[0], nb, fl,
                     device_ms(v1[key], n=10), lib_t[1], PEAK_BF16_FLOPS))
    return rows


def mel_other_timing(device) -> list:
    """The mel kernel at the mel entry point's other settings: its FFT
    tier's mixed-radix kernel at WHISPER_MEL's shape (a 30 s clip's frames,
    n_fft 400, 80 bands) and its DFT tier at CD_MEL's (a 10 s clip at 44.1
    kHz, n_fft 882): rows as `bwd_timing`'s, the library time `rfft` +
    power + mel product; log lines for MEL_OTHER_SHAPES."""
    from speech2affective_gestures_torch.ops import mel_cuda

    out = []
    for settings in (WHISPER_MEL, CD_MEL):
        sr, n_fft, n_mels = settings.get("sr", 16000), settings["n_fft"], settings["n_mels"]
        rows = int(settings["seconds"] * sr) // settings["hop_length"]
        frames = speech_frames(rows, device, n_fft)
        fn = lambda: mel_cuda.mel_power(frames, sr, n_mels)  # noqa: E731
        ms, dev = time_ms(fn), device_ms(fn)
        plain = time_ms(lambda: mel_cuda.mel_power_plain(frames, sr, n_mels))
        lib = rfft_mel(frames, n_mels)
        lib_ms, lib_dev = time_ms(lib), device_ms(lib)
        nnz = int(np.count_nonzero(mel_cuda.dft_constants(sr, n_fft, n_mels)[2]))
        n_bins = n_fft // 2 + 1
        # the least work: a real FFT of each row (5 (n/2) log2 n), the power
        # of each bin, the filterbank's nonzeros; bytes: the frames, the
        # filterbank's nonzeros, the output
        flops = rows * (5 * (n_fft // 2) * np.log2(n_fft) + 3 * n_bins + 2 * nnz)
        nbytes = 4 * (frames.numel() + nnz + rows * n_mels)
        plan = mel_cuda.mel_plan(rows, n_fft, n_mels)
        name = _mel_name(plan.tier, n_fft)
        log(f"{name} R={rows} n_fft={n_fft} n_mels={n_mels}: {ms:.4f} ms, by device time "
            f"{dev:.4f} ms; plain {plain:.4f} ms; rfft mel {lib_ms:.4f} ms, by device time "
            f"{lib_dev:.4f} ms; plan {plan._asdict()}")
        out.append((name, "speech2affective_gestures_torch/csrc/mel_power.cu",
                    "speech2affective_gestures_tpu/ops/dsp_pallas.py:57", ms, plain, lib_ms,
                    nbytes, float(flops), dev, lib_dev))
    for r, nf, nm in MEL_OTHER_SHAPES:
        f = speech_frames(r, device, nf)
        log(f"mel_power R={r} n_fft={nf} n_mels={nm} ({mel_cuda.mel_plan(r, nf, nm).tier} "
            f"tier): by device time {device_ms(lambda: mel_cuda.mel_power(f, n_mels=nm)):.4f}"
            f" ms, rfft mel {device_ms(rfft_mel(f, nm)):.4f} ms")
    return out


def conv_dis_timing(device) -> list:
    """The GRU kernels at the ConvDiscriminator's shape (T CONV_DIS_T, B
    512, H 64, D 2, layer 0's 8 inputs): `shape_timing`."""
    return shape_timing(device, CONV_DIS_T, 512, 64, 8, f"_t{CONV_DIS_T}",
                        "the ConvDiscriminator's shape", seed=28)


def fused_batch_timing(device) -> list:
    """The GRU kernels at the fused step's batch with the generator's
    layers (T 34, B FUSED_B, H 300, D 2, 600 inputs): `shape_timing`."""
    return shape_timing(device, 34, FUSED_B, 300, 600, f"_b{FUSED_B}",
                        "the fused step's batch", seed=34)


def rank_batch_timing(device) -> list:
    """The GRU kernels at a data-parallel rank's batch with the generator's
    layers (T 34, B 256 and 128, H 300, D 2, 600 inputs): `shape_timing`."""
    rows = []
    for ranks in (2, DP_RESUME_RANKS):
        B = TRAIN_BATCH // ranks
        rows += shape_timing(device, 34, B, 300, 600, f"_b{B}", f"a rank's batch of {ranks}",
                             seed=B)
    return rows


def shape_timing(device, T: int, B: int, H: int, cin: int, tag: str, what: str,
                 seed: int, D: int = 2, dtypes=("float32", "bfloat16")) -> list:
    """The GRU kernels at (T, B, H, D directions, cin inputs), in each of
    `dtypes`, under their names with `tag`: rows as `bwd_timing`'s and
    `bf16_timing`'s, with the same bounds (the bf16 instances' bytes and
    the tensor-core rate), and as library times cuDNN's `nn.GRU` at that
    shape less its input projection (forward; backward with dW_hh) and
    cuBLAS's dW product on prepared operands."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    fwd_src = "speech2affective_gestures_torch/csrc/gru_fwd.cu"
    bwd_src = "speech2affective_gestures_torch/csrc/gru_bwd.cu"
    tpu = "speech2affective_gestures_tpu/ops/gru_pallas.py"
    rows = []
    for dtype in (getattr(torch, name) for name in dtypes):
        bf16 = dtype == torch.bfloat16
        xp, w_hh, b_ih, b_hh = (t.to(dtype).contiguous()
                                for t in gru_inputs(T, B, cin, H, D, seed=seed, device=device))
        g = torch.Generator().manual_seed(seed)
        dys = torch.randn(T, B, D * H, generator=g).to(device, dtype)
        dh = torch.randn(D, B, H, generator=g).to(device, dtype)
        ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
        dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp)
        fns = {"fwd": (lambda: gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh),
                       lambda: gru_cuda.gru_layer_plain(xp, w_hh, b_ih, b_hh)),
               "rec": (lambda: gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys, hp),
                       lambda: gru_cuda.gru_bwd_recurrence_plain(xp, w_hh, b_ih, b_hh, ys,
                                                                 dys, hp)),
               "dw": (lambda: gru_cuda.gru_dw(ys, dxp, gn, D),
                      lambda: gru_cuda.gru_dw_plain(ys, dxp, gn, D))}
        times = {k: (time_ms(fn, iters=10), device_ms(fn, n=10),
                     time_ms(plain, iters=5 if k == "rec" else 10))
                 for k, (fn, plain) in fns.items()}
        torch.manual_seed(seed)
        lib = torch.nn.GRU(cin, H, bidirectional=D == 2).to(device, dtype)
        x = torch.randn(T, B, cin, generator=g).to(device, dtype)
        lib_fwd = cudnn_recurrent_fwd(lib, x)
        lib_bwd = cudnn_recurrent_bwd(lib, x.clone().requires_grad_(), dys, dh)
        hprev = gru_cuda._prev_states(ys, D).contiguous()
        g_op = torch.cat([dxp.view(T, B, D, 3 * H)[..., :2 * H], gn.view(T, B, D, H)],
                         dim=-1).contiguous()

        def cublas():
            return torch.einsum("tbdk,tbdj->dkj", hprev, g_op)

        lib_dw = (time_ms(cublas, iters=10), device_ms(cublas, n=10))
        n_prod = 2 * T * B * D * H * 3 * H
        dw_flops = 2 * T * B * D * (H + 1) * 3 * H
        if bf16:
            fwd_bytes = 2 * (xp.numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                             + ys.numel() + D * B * H)
            rec_bytes = 2 * (2 * xp.numel() + 3 * ys.numel() + w_hh.numel()
                             + b_ih.numel()) + 4 * hp.numel()
            dw_bytes = 2 * (ys.numel() + 2 * xp.numel() // 3 + gn.numel()) \
                + 4 * (w_hh.numel() + b_hh.numel())
            fwd_flops, peak = n_prod + T * B * D * 15 * H, (PEAK_BF16_FLOPS,)
        else:
            fwd_bytes = 4 * (xp.numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                             + T * B * D * H + D * B * H)
            rec_bytes = 4 * (3 * xp.numel() + 3 * ys.numel() + w_hh.numel() + b_ih.numel())
            dw_bytes = 4 * (ys.numel() + 2 * xp.numel() // 3 + gn.numel()
                            + w_hh.numel() + b_hh.numel())
            fwd_flops, peak = T * D * B * (2 * H * 3 * H + 3 * H + 12 * H), ()
        rec_flops = n_prod + 30 * T * B * D * H
        sfx = tag + ("_bf16" if bf16 else "")
        for name, key, src, line, nb, fl, lib_t in (
                ("gru_fwd", "fwd", fwd_src, 338, fwd_bytes, fwd_flops, lib_fwd),
                ("gru_bwd", "rec", bwd_src, 384, rec_bytes, rec_flops, lib_bwd),
                ("gru_dw", "dw", bwd_src, 432, dw_bytes, dw_flops, lib_dw)):
            ms, dev, plain = times[key]
            rows.append((name + sfx, src, f"{tpu}:{line}", ms, plain, lib_t[0], nb, fl, dev,
                         lib_t[1], *peak))
        log(f"gru {'bf16' if bf16 else 'float32'} at {what} T={T} "
            f"B={B} cin={cin} H={H} D={D} (forward tier "
            f"{gru_cuda._device_plan(device, B, H, D, dtype).tier}, recurrence tier "
            f"{gru_cuda._device_bwd_plan(device, B, H, D, dtype).tier}), (events ms, device "
            f"ms, plain ms): forward {times['fwd']}, recurrence {times['rec']}, dW "
            f"{times['dw']}; cuDNN recurrent forward {lib_fwd}, backward with dW_hh "
            f"{lib_bwd}; cuBLAS dW product {lib_dw}")
    return rows


def timing_phase(device, errs, launches) -> list[dict]:
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    # GRU at the /synthesize shape: generator batch 1, T=34, H=300, both directions
    T, B, H, D = 34, 1, 300, 2
    args = gru_inputs(T, B, 600, H, D, seed=5, device=device)
    xp, w_hh, b_ih, b_hh = args
    gru_ms = time_ms(lambda: gru_cuda.gru_layer_forward(*args))
    gru_dev = device_ms(lambda: gru_cuda.gru_layer_forward(*args))
    gru_plain_ms = time_ms(lambda: gru_cuda.gru_layer_plain(*args), iters=5)
    # cuDNN's GRU at the layer's real width, less its input projection
    lt = layer_times(T, B, 600, H, device, seed=5, backward_device=False)
    gru_lib_ms, gru_lib_dev = lt["cuDNN recurrent fwd"], lt["cuDNN recurrent fwd device"]
    gru_bytes = 4 * (xp.numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                     + T * B * D * H + D * B * H)
    gru_flops = T * D * B * (2 * H * 3 * H + 3 * H + 12 * H)
    for extra_b in (4, 16):
        a = gru_inputs(T, extra_b, 600, H, D, seed=6, device=device)
        log(f"gru_fwd B={extra_b}: {time_ms(lambda: gru_cuda.gru_layer_forward(*a)):.4f} ms, "
            f"by device time {device_ms(lambda: gru_cuda.gru_layer_forward(*a)):.4f} ms")

    # mel at the /synthesize shape: 8 windows x 71 frames
    rows = 568
    frames = speech_frames(rows, device)
    mel_ms = time_ms(lambda: mel_cuda.mel_power(frames))
    mel_dev = device_ms(lambda: mel_cuda.mel_power(frames))
    mel_plain_ms = time_ms(lambda: mel_cuda.mel_power_plain(frames))
    lib_fn = rfft_mel(frames)
    log(f"mel_power vs rfft mel on the same frames: max_abs_err="
        f"{(lib_fn() - mel_cuda.mel_power(frames)).abs().max().item():.3e}")
    mel_lib_ms = time_ms(lib_fn)
    mel_lib_dev = device_ms(lib_fn)
    # The least work of the function: a real FFT of each row (5 (n/2)
    # log2 n operations), the power of each of the 1025 bins, and a product
    # with the filterbank's nonzeros; the least bytes: the frames read once,
    # the filterbank's nonzeros, the output.
    n_fft, n_bins = 2048, 1025
    nnz = int(np.count_nonzero(mel_cuda.dft_constants(16000, n_fft, 128)[2]))
    mel_flops = rows * (5 * (n_fft // 2) * int(np.log2(n_fft)) + 3 * n_bins
                        + 2 * nnz)
    mel_bytes = 4 * (frames.numel() + nnz + rows * 128)
    frames_big = speech_frames(2272, device)
    log(f"mel_power R=2272: {time_ms(lambda: mel_cuda.mel_power(frames_big)):.4f} ms, "
        f"by device time {device_ms(lambda: mel_cuda.mel_power(frames_big)):.4f} ms, "
        f"plain {time_ms(lambda: mel_cuda.mel_power_plain(frames_big)):.4f} ms")

    rows_out = []
    # ms and library_ms are CUDA-event means (the wrapper's host cost
    # included where the kernel is shorter); device_ms and
    # library_device_ms the profiler's kernel time per call, where measured
    for name, source, replaces, ms, plain, lib_ms, nbytes, flops, dev, lib_dev, *peak in (
            ("gru_fwd", "speech2affective_gestures_torch/csrc/gru_fwd.cu",
             "speech2affective_gestures_tpu/ops/gru_pallas.py:338",
             gru_ms, gru_plain_ms, gru_lib_ms, gru_bytes, gru_flops, gru_dev, gru_lib_dev),
            ("mel_power", "speech2affective_gestures_torch/csrc/mel_power.cu",
             "speech2affective_gestures_tpu/ops/dsp_pallas.py:57",
             mel_ms, mel_plain_ms, mel_lib_ms, mel_bytes, mel_flops, mel_dev, mel_lib_dev),
            *mel_other_timing(device), *bwd_timing(device), *bf16_timing(device),
            *conv_dis_timing(device), *fused_batch_timing(device), *rank_batch_timing(device),
            *context_timing(device)):
        b_ms, b_by = bound(nbytes, flops, *peak)
        rows_out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "device_ms": None if np.isnan(dev) else dev,
            "library_device_ms": None if np.isnan(lib_dev) else lib_dev,
        })
        by_device = f" (by device time {dev:.4f} ms, library {lib_dev:.4f} ms)"
        log(f"{name}: {ms:.4f} ms, plain {plain:.4f} ms, library {lib_ms:.4f} ms"
            f"{by_device}, bound {b_ms:.5f} ms ({b_by}; {nbytes} bytes, {flops} FLOP)")
    return rows_out


def _ok_line(torch) -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    """Every phase; with `--data-parallel`, the data- and model-parallel
    phases alone (and the embedding net that the former's main_v2 run
    scores with), for a run on several cards."""
    only_dp = sys.argv[1:] == ["--data-parallel"]
    if sys.argv[1:] and not only_dp:
        print("usage: chip_smoke.py [--data-parallel]", file=sys.stderr)
        return 2
    if not (PKG / "csrc").is_dir() or not CONFIG.is_file():
        print(f"chip_smoke: the port ({PKG.name}/) and config/ must sit beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    # one line for the numbers' notes, whatever the cards
    smi = smi.replace("\n", "; ")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from speech2affective_gestures_torch.device import set_f32_numerics
    from speech2affective_gestures_torch.ops import _build

    set_f32_numerics()
    t0 = time.perf_counter()
    libs = _build.build(["gru_fwd", "gru_bwd", "mel_power"])
    log(f"built {sorted(libs)} with nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, out in sorted(_build.build_logs.items()):
        entry = ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '[^']*?\d((?:gru|mel)_[a-z0-9_]*?kernel)"
                          r"(?=[IE])([^']*)'", line)
            if m:  # the kernel and its template arguments, from the mangled name
                args = re.findall(r"L[a-z](\d+)E", m.group(2))
                entry = f"{m.group(1)}<{'bf16, ' if 'bfloat16' in m.group(2) else ''}" \
                        f"{', '.join(args)}>"
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")

    device = torch.device("cuda", 0)
    if only_dp:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as work:
            work = pathlib.Path(work)
            _, scaling = data_parallel_phase(device, work, embedding_phase(device, work), smi)
            model_parallel_phase(device, work, smi, scaling)
        _ok_line(torch)
        return 0
    errs = kernel_phase(device)
    errs.update(bwd_kernel_phase(device))
    errs.update(v1_kernel_phase(device))
    errs.update(bf16_kernel_phase(device))
    errs.update(conv_dis_kernel_phase(device))
    errs.update(fused_batch_kernel_phase(device))
    errs.update(rank_batch_kernel_phase(device))
    errs.update(context_kernel_phase(device))
    # each kernel's launches on the paths that run it: the service's two
    # requests and the bf16 service's one, the training runs (float32 and
    # mixed precision) with their test-split scoring, run_layer in float32
    # and bf16, and the mel entry point at n_fft 400
    launches = collections.Counter(service_phase(device))
    launches.update(v1_path_phase(device))
    launches.update(v1_path_phase(device, "bfloat16"))
    launches.update(mel_path_phase(device))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        work = pathlib.Path(work)
        # the auxiliary nets: T2GNet's text-to-gesture path, the embedding
        # net's speech and random modes, DiscriminatorTriModal
        t2g_phase(device, work, smi)
        launches.update(aux_nets_phase(device, smi))
        embedding_net = embedding_phase(device, work)
        trainer, trained = training_phase(device, work, embedding_net)
        launches.update(trained)
        eval_parity_phase(trainer, work)
        time_generate_gestures(trainer)
        step_parity_phase(device)
        f32_p50 = time_train_step(trainer)
        del trainer
        trainer, trained = training_phase(device, work, embedding_net, mixed_precision=True)
        launches.update(trained)
        mp_p50 = time_train_step(trainer)
        log(f"train step at batch {TRAIN_BATCH}: mixed precision p50 {mp_p50:.3f} ms "
            f"against float32 {f32_p50:.3f} ms")
        del trainer
        mixed_step_parity_phase(device)
        launches.update(bf16_service_phase(device))
        # the TED formats' route: the archive, training with clipping and
        # decay, the trained checkpoint served with its vocabulary, live
        real, reading = real_data_phase(device, work, embedding_net)
        launches.update(real)
        step_parity_phase(device, gradient_clip=0.1)
        service, audio, words, served = trained_service_phase(device, reading)
        launches.update(served)
        launches.update(stream_phase(service, audio, words))
        del service
        # the long-clip rendering of that test split and of a GENEA clip
        launches.update(clip_render_phase(device, reading, work, smi))
        # the paper's ablations: trained, scored, checked, served, rendered
        launches.update(ablation_phase(device, work, embedding_net, smi))
        # the v1 pipeline: SER, then the emotion-conditioned GAN
        v1_launches = v1_phase(device, work, smi)
        log(f"v1 path launches (main_v1): {dict(v1_launches)}")
        launches.update(v1_launches)
        # main_v2's fused pass and rematerialization
        launches.update(step_options_phase(device, work, embedding_net, smi))
        # main_v2's scanned epoch: K train steps a CUDA graph
        launches.update(scanned_epoch_phase(device, work, embedding_net, smi))
        # the step's analytic flops, timed engines and MFU, and a trace
        launches.update(mfu_phase(device, smi))
        # the streaming loader, and resumed training on both loaders
        launches.update(grain_phase(device, work, embedding_net, smi))
        # data-parallel training: ranks over gloo on this card, one NCCL
        # rank's K-step graph, main_v2 over NCCL where there are cards
        dp_launches, scaling = data_parallel_phase(device, work, embedding_net, smi)
        launches.update(dp_launches)
        # the 2-D (data, model) grid: its step and its sharded synthesis
        launches.update(model_parallel_phase(device, work, smi, scaling))
    kernels = timing_phase(device, errs, launches)
    log(json.dumps({"kernels": kernels}))
    _ok_line(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
