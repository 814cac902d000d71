"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit. In order:

1. prints the card's name and power limit, and builds the hand-written
   kernels from `speech2affective_gestures_torch/csrc/` with nvcc for
   sm_90a (one nvcc per source, started together);
2. kernel phase: each kernel against its plain PyTorch version on the card
   at the serving and training paths' shapes, within a stated tolerance:
   the GRU forward, the mel power, the GRU backward recurrence and its
   dW_hh reduction, and the GRU's autograd Function against autograd
   through the plain forward; then the same three GRU kernels in the walk
   layout of `run_layer` (the v1 layer) against their plain versions and
   against the model layout's kernels on the same function;
3. service phase: a full-width s2ag generator (config/multimodal_context_v2.yml:
   hidden 300, 4 GRU layers, embed 300; 1000 words, 100 speakers; random
   weights from seed 0) behind the HTTP server answers /synthesize for a
   10 s clip and /synthesize_batch for four clips of 3-12 s. The launch
   counters are set to 0 just before and read just after: both kernels
   must have run. The same requests through the same weights on the CPU
   (the plain path, same noise) must agree within tolerance;
4. v1 path: `gru_cuda.run_layer`, forward and backward under autograd at
   the generator's training shape; its counters are set to 0 just before
   and read just after: its three kernels must have run;
5. embedding phase: `train_embedding.main` trains the FGD embedding net on
   the card on the synthetic corpus (every loss finite) and writes the
   `.pth.tar` that the training phase loads;
6. training phase: `main_v2.main` trains the paper's GAN at full width
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
7. evaluation parity: `generate_gestures` from the same weights, speakers
   and speaker noise on the card and on the CPU plain path: the generated
   poses, the embedding features and FGD must agree within tolerance;
8. one train step at full width and batch 16 on the card and on the CPU
   plain path (in float64, the reference, and in float32), from the same
   weights, batch and noise: the card's metrics, BN running stats and
   Adam's first moments must agree with the float64 step within tolerance;
9. timing: each kernel's time, its plain version's, a PyTorch library
   call's that computes the same function, and the least time the card
   could take (bound); the service's synthesize p50; the train step's p50,
   samples/s and its device profile; `generate_gestures`' wall time and
   device profile; the embedding train step's p50.

It prints one `{"kernels": [...]}` line before the last, and as the last
line `{"ok": true, "device": {...}}`. It exits non-zero, with no result
line, when CUDA is unavailable, when the package is missing beside it, or
when any phase fails.
"""

from __future__ import annotations

import base64
import copy
import http.client
import json
import pathlib
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
# the training phase: 20 synthetic videos of 60 s give ~1720 windows, 70%
# of them 3 train batches of 512 and 15% one validation batch
TRAIN_BATCH, TRAIN_VIDEOS, TRAIN_SECONDS = 512, 20, 60.0
# the mel kernel's shapes: the service's MFCCs (n_fft 2048: 8 windows of 71
# frames, 32 windows, and a row count that is no multiple of the tile), and
# the corpus build's log-mel of one training video (n_fft 1024, hop 512)
MEL_SHAPES = ((568, 2048), (2272, 2048), (601, 2048),
              (1 + int(TRAIN_SECONDS * 16000) // 512, 1024))


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
    n = (rows + 8) * 512
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
    for H, B, cin in shapes:
        args = gru_inputs(T, B, cin, H, D, seed=B * 1000 + cin, device=device)
        ys, h_last = gru_cuda.gru_layer(*args)
        again = gru_cuda.gru_layer_forward(*args)
        want_ys, want_h = gru_cuda.gru_layer_plain(*args)
        err = max((ys - want_ys).abs().max().item(),
                  (h_last - want_h).abs().max().item())
        same = torch.equal(ys, again[0]) and torch.equal(h_last, again[1])
        plan = gru_cuda._device_plan(device, B, H, D)
        log(f"kernel gru_fwd T={T} B={B} cin={cin} H={H} D={D}: "
            f"max_abs_err={err:.3e} (tol {GRU_TOL}); bitwise repeatable {same}; "
            f"plan {plan._asdict()} ({D * plan.tiles} clusters, at most "
            f"{gru_cuda.max_clusters(device, H)} at once)")
        if not (err <= GRU_TOL and same):
            raise AssertionError(f"gru_fwd disagrees with its plain version: {err}, "
                                 f"repeatable {same}")
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
    return errs


def _rel(got, want) -> float:
    """Largest difference over the largest value of `want`."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def bwd_kernel_phase(device) -> dict:
    """The GRU backward kernels against the plain backward at the training
    shapes (T 34, both directions; the generator's H 300 with layer inputs
    of 88 and 600 features, the discriminator's H 64 with 8 and 128), and
    the autograd Function against autograd through the plain forward."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    errs = {"gru_bwd": 0.0, "gru_dw": 0.0}
    T, D = 34, 2
    for H, cins in ((300, (88, 600)), (64, (8, 128))):
        for B in (1, 5, 512):
            for cin in cins:
                xp, w_hh, b_ih, b_hh = gru_inputs(T, B, cin, H, D, seed=B + H + cin,
                                                  device=device)
                g = torch.Generator().manual_seed(B * H + cin)
                dys = torch.randn(T, B, D * H, generator=g).to(device)
                ys, _ = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)
                dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys)
                want_dxp, want_gn = gru_cuda.gru_bwd_recurrence_plain(
                    xp, w_hh, b_ih, b_hh, ys, dys)
                err = max((dxp - want_dxp).abs().max().item(),
                          (gn - want_gn).abs().max().item())
                # the reduction kernel alone, on the plain recurrence's output
                dw, db = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
                want_dw, want_db = gru_cuda.gru_dw_plain(ys, want_dxp, want_gn, D)
                rel = max(_rel(dw, want_dw), _rel(db, want_db))
                again = gru_cuda.gru_dw(ys, want_dxp, want_gn, D)
                same = torch.equal(dw, again[0]) and torch.equal(db, again[1])
                log(f"kernel gru_bwd T={T} B={B} cin={cin} H={H} D={D}: dxp "
                    f"max_abs_err={err:.3e} (tol {BWD_TOL}); gru_dw dW_hh/db_hh "
                    f"max_abs_err={(dw - want_dw).abs().max().item():.3e}, "
                    f"relative to the largest {rel:.3e} (tol {BWD_TOL}); "
                    f"bitwise repeatable {same}")
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
    before = (gru_cuda.v1_launches, gru_cuda.v1_bwd_launches, gru_cuda.v1_dw_launches)
    for B in (1, 512):
        xw, w_hh, b_hh, (xp, b_ih) = v1_inputs(T, B, 600, H, D, seed=31 + B, device=device)
        ys = gru_cuda.run_layer_forward(xw, w_hh, b_hh)
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
        dxp, gn = gru_cuda.run_layer_bwd_recurrence(xw, w_hh, b_hh, want, dys)
        want_dxp, want_gn = gru_cuda.run_layer_bwd_recurrence_plain(xw, w_hh, b_hh, want, dys)
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
    after = (gru_cuda.v1_launches, gru_cuda.v1_bwd_launches, gru_cuda.v1_dw_launches)
    if not all(a > b for a, b in zip(after, before)):
        raise AssertionError(f"the v1 launch counters did not rise: {before} -> {after}")
    return errs


def v1_path_phase(device) -> dict:
    """`gru_cuda.run_layer`, the v1 layer's public entry (a drop-in for one
    layer of the scan engine), at the generator's training shape: the
    layer's input projection with b_ih, direction 1 time-reversed, the
    layer, a loss on ys and h_last, and the backward to the input and every
    weight. The v1 counters are set to 0 just before and read just after:
    its three kernels must have run."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    T, B, cin, H, D = 34, 512, 600, 300, 2
    g = torch.Generator().manual_seed(41)
    bound = H ** -0.5
    x = torch.randn(T, B, cin, generator=g).to(device).requires_grad_()
    w_ih, w_hh, b_ih, b_hh = (
        torch.empty(shape).uniform_(-bound, bound, generator=g).to(device).requires_grad_()
        for shape in ((D, 3 * H, cin), (D, H, 3 * H), (D, 3 * H), (D, 3 * H)))
    gru_cuda.v1_launches = gru_cuda.v1_bwd_launches = gru_cuda.v1_dw_launches = 0
    xp = torch.einsum("tbc,dkc->tdbk", x, w_ih) + b_ih[:, None, :]
    xp = torch.stack([xp[:, 0], xp[:, 1].flip(0)], dim=1).contiguous()
    ys, h_last = gru_cuda.run_layer(xp, w_hh, b_hh)
    (ys.square().mean() + h_last.sum()).backward()
    torch.cuda.synchronize()
    launches = {"gru_fwd_v1": gru_cuda.v1_launches, "gru_bwd_v1": gru_cuda.v1_bwd_launches,
                "gru_dw_v1": gru_cuda.v1_dw_launches}
    finite = all(bool(t.grad.isfinite().all()) for t in (x, w_ih, w_hh, b_ih, b_hh))
    log(f"v1 path (run_layer under autograd, T={T} B={B} H={H} D={D}): launches "
        f"{launches}; every gradient finite {finite}")
    if not finite or min(launches.values()) < 1:
        raise AssertionError(f"run_layer did not run its kernels: {launches}, finite {finite}")
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


def unb64(blob, shape):
    return np.frombuffer(base64.b64decode(blob), "<f4").reshape(shape)


def service_phase(device):
    import torch
    from speech2affective_gestures_torch import serve
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.data.vocab import placeholder_vocab
    from speech2affective_gestures_torch.models.generator import build_generator
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda
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
        gru_cuda.launches = 0
        mel_cuda.launches = 0
        one = post(server, "/synthesize", {
            "audio_b64": serve.encode_f32_b64(single), "words": words,
            "vid_idx": 3, "binary": True})
        after_one = {"gru_fwd": gru_cuda.launches, "mel_power": mel_cuda.launches}
        many = post(server, "/synthesize_batch", {"requests": batch,
                                                  "binary": True})
        launches = {"gru_fwd": gru_cuda.launches, "mel_power": mel_cuda.launches}
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
    copies) and the wall ms per call (the profiler's own cost inside)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    return ([e for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA],
            busy_us(spans) / 1e3 / n, wall_ms)


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of fn from torch.profiler over n calls after a
    warm-up: the time in which any of its kernels (or copies) ran. Unlike
    `time_ms` it leaves out the host's launch cost and any gap between
    launches; kernels that overlap count once."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _profile(fn, n)[1]


def profile_device(label: str, unit: str, fn, n: int = 3) -> None:
    """Device time by kernel and the device's busy share of the wall time,
    from torch.profiler over `n` calls of fn (the profiler's own cost is
    inside the wall time)."""
    kernels, busy_ms, wall_ms = _profile(fn, n)
    log(f"profile of {label}: wall {wall_ms:.3f} ms/{unit} "
        f"under the profiler, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels) / n:.0f} "
        f"kernel launches/{unit}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        log(f"  {_device_us(e) / 1e3 / n:8.3f} ms {e.count / n:6.1f}x  {e.key[:90]}")


def _counters() -> dict:
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    return {"gru_fwd": gru_cuda.launches, "gru_bwd": gru_cuda.bwd_launches,
            "gru_dw": gru_cuda.dw_launches, "mel_power": mel_cuda.launches}


def _reset_counters() -> None:
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    gru_cuda.launches = gru_cuda.bwd_launches = gru_cuda.dw_launches = 0
    mel_cuda.launches = 0


def training_phase(device, work: pathlib.Path, embedding_net: pathlib.Path):
    """`main_v2.main` on the card: the paper's GAN at full width, batch 512,
    one epoch with the GAN terms on from the first step, then the test
    split scored with FGD by the card-trained embedding net. Returns the
    trainer and each kernel's launches in training and in the scoring."""
    import torch
    import yaml
    from speech2affective_gestures_torch import main_v2
    from speech2affective_gestures_torch.train.trainer import Trainer

    raw = yaml.safe_load(CONFIG.read_text())
    raw["loss_warmup"] = -1       # epoch 0 > -1: the discriminator runs
    cfg_path = work / "multimodal_context_v2_gan_on.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    base = work / "base"
    argv = ["-b", str(base), "-c", str(cfg_path), "--synthetic-data", "true",
            "--synthetic-videos", str(TRAIN_VIDEOS), "--synthetic-seconds",
            str(TRAIN_SECONDS), "--batch-size", str(TRAIN_BATCH),
            "--s2ag-num-epoch", "1", "--log-interval", "1",
            "--embedding-net-checkpoint", str(embedding_net)]
    log(f"training phase: main_v2.main({' '.join(argv)})")
    # the counters are read, and set to 0 again, just before main_v2 scores
    # the test split, and read just after
    counts = {}
    scoring = Trainer.generate_gestures

    def counted(self, *args, **kwargs):
        torch.cuda.synchronize()
        counts["training"] = _counters()
        _reset_counters()
        t0 = time.perf_counter()
        result = scoring(self, *args, **kwargs)
        torch.cuda.synchronize()
        counts["evaluation"] = _counters()
        log(f"generate_gestures in main_v2: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        return result

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Trainer.generate_gestures = counted
    try:
        trainer = main_v2.main(argv)
    finally:
        Trainer.generate_gestures = scoring
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, evaluated = counts["training"], counts["evaluation"]
    log(f"training launches: {launches}; test-split scoring launches: {evaluated}; "
        f"main_v2.main took {wall:.1f} s in all")
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched in training")
    if evaluated["gru_fwd"] < 1:
        raise AssertionError("gru_fwd was not launched in generate_gestures")
    if trainer.device.type != device.type:
        raise AssertionError(f"main_v2 trained on {trainer.device}, not the card")

    log_txt = (base / "models" / "s2ag_v2_mfcc_torch" / "ted_db" / "log.txt").read_text()
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
    if not list((base / "models" / "s2ag_v2_mfcc_torch" / "ted_db").glob("*.pth.tar")):
        raise AssertionError("main_v2 wrote no checkpoint")
    [line] = [x for x in log_txt.splitlines() if "eval: " in x]
    scores = {k: float(v) for k, v in (tok.split(": ") for tok in
                                       line.split("eval: ")[1].split(" | "))}
    log(f"test split ({trainer.test_data.n_samples} windows) scored on the card: {scores}")
    if (set(scores) != {"l1", "joint_mae", "accel", "FGD", "feat_dist"}
            or not np.isfinite(list(scores.values())).all()):
        raise AssertionError(f"bad test-split scores: {scores}")
    return trainer, {k: launches[k] + evaluated[k] for k in launches}


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


def step_parity_phase(device) -> None:
    """One train step at full width and batch 16 on the card and on the
    CPU plain path, from the same weights, batch, speaker noise and
    div-reg speaker ids, every dropout at zero.

    The CPU path runs in float64 as the reference, and in float32 for
    comparison; `aff_encoder_probe` prints where the float32 runs part
    from float64 in the generator's AffEncoder."""
    import torch
    from speech2affective_gestures_torch.config import ModelConfig
    from speech2affective_gestures_torch.models import layers as L
    from speech2affective_gestures_torch.train import builder, gan_step

    cfg = ModelConfig.from_yaml(CONFIG, loss_warmup=-1)
    n_words, n_speakers, B = 1000, 100, 16
    init = builder.init_training(cfg, 0, n_words, n_speakers, device="cpu")
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
    aff_encoder_probe(init["gen"], batch, eps, device)

    def one_step(dev, dtype):
        models = {k: copy.deepcopy(init[k]).to(dev, dtype) for k in ("gen", "dis", "tri")}
        step = gan_step.GanStep(models["gen"], models["dis"], init["gan_cfg"],
                                models["tri"])
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in builder.to_device(batch, dev).items()}
        t0 = time.perf_counter()
        metrics = step.train_step(b, torch.Generator(device=dev).manual_seed(0),
                                  gan_on=True, eps=torch.from_numpy(eps).to(dev, dtype))
        metrics = {k: float(v) for k, v in metrics.items()}
        log(f"one train step, batch {B}, on {dev} in {dtype}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {metrics}")
        return models, step, metrics

    draw = gan_step.draw_other_speaker_ids
    gan_step.draw_other_speaker_ids = (
        lambda g, vids, n: torch.as_tensor(other, device=vids.device))
    try:
        ref = one_step(torch.device("cpu"), torch.float64)
        runs = {"card": one_step(device, torch.float32),
                "CPU": one_step(torch.device("cpu"), torch.float32)}
    finally:
        gan_step.draw_other_speaker_ids = draw

    def stats_err(a, b):
        sa, sb = a.state_dict(), b.state_dict()
        return max(_rel(sb[k].cpu().double(), sa[k].double()) for k in sa
                   if k.endswith(("running_mean", "running_var")))

    # Adam's first moment after step 1 is 0.5 g. The biases ahead of a batch
    # norm in train mode have a zero gradient up to float noise (the batch
    # mean removes them): a tensor whose moments all lie below 1e-4 of the
    # model's largest is held within STEP_TOL of that largest instead.
    def moment_err(opt_a, model_a, opt_b, model_b):
        pairs = [(opt_a.state[p]["exp_avg"], opt_b.state[q]["exp_avg"].cpu().double())
                 for p, q in zip(model_a.parameters(), model_b.parameters())]
        top = max(a.abs().max().item() for a, _ in pairs)
        scale = [a.abs().max().item() for a, _ in pairs]
        return max((b - a).abs().max().item() / (s if s >= 1e-4 * top else top)
                   for (a, b), s in zip(pairs, scale))

    (ref_models, ref_step, want) = ref
    errs = {}
    for name, (models, step, got) in runs.items():
        metric = max(abs(got[k] - want[k]) / (abs(want[k]) + 1e-6 / STEP_TOL)
                     for k in want)
        errs[name] = {
            "metrics (relative)": metric if set(got) == set(want) else np.inf,
            "gen BN stats": stats_err(ref_models["gen"], models["gen"]),
            "dis BN stats": stats_err(ref_models["dis"], models["dis"]),
            "TriModal BN stats against its initial ones": stats_err(init["tri"],
                                                                    models["tri"]),
            "gen Adam m": moment_err(ref_step.gen_opt, ref_models["gen"],
                                     step.gen_opt, models["gen"]),
            "dis Adam m": moment_err(ref_step.dis_opt, ref_models["dis"],
                                     step.dis_opt, models["dis"]),
        }
        log(f"{name} float32 step against the CPU float64 step: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs[name].items())
            + f" (tol {STEP_TOL} for the card)")
    if not all(v <= STEP_TOL for v in errs["card"].values()):
        raise AssertionError(f"card step disagrees with the CPU step: {errs['card']}")


def bound(nbytes, flops):
    """The least time of a function on the card: its bytes over the memory
    rate or its float32 operations over the peak, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cudnn_recurrent_fwd(lib, x) -> tuple[float, float]:
    """cuDNN's recurrent forward: the forward of the bidirectional
    `nn.GRU` lib on x (T, B, cin) less its input projection's matmul, in
    ms by CUDA events and by device time (`device_ms`, which counts the
    two directions' overlapping kernels once)."""
    import torch

    w_ih = torch.cat([lib.weight_ih_l0, lib.weight_ih_l0_reverse]).detach()
    with torch.no_grad():
        def full():
            return lib(x)

        def proj():
            return torch.matmul(x, w_ih.t())

        return (time_ms(full, iters=10) - time_ms(proj, iters=10),
                device_ms(full, n=10) - device_ms(proj, n=10))


def rfft_mel(frames):
    """The mel kernel's library yardstick on frames (R, n_fft), as a
    function of no arguments: `torch.fft.rfft`, the power, and the product
    with the dense filterbank (16 kHz, 128 mels)."""
    import torch
    from speech2affective_gestures_torch.ops import dsp_ref

    fb = dsp_ref.mel_filterbank(16000, frames.shape[-1], 128).T.astype(np.float32)
    fb = torch.from_numpy(np.ascontiguousarray(fb)).to(frames.device)

    def run():
        spec = torch.fft.rfft(frames, dim=-1)
        return (spec.real ** 2 + spec.imag ** 2) @ fb
    return run


def layer_times(T, B, cin, H, device, seed=9) -> dict:
    """One bidirectional GRU layer at its real input width, the port's
    (`models.layers.GRU`: the input projection's matmul, then the forward
    kernel; under autograd the backward kernels and the projection's two
    matmuls) against cuDNN's `nn.GRU` with the same weights: forward (no
    grad) and forward + backward ms of each, the largest difference of
    their outputs and of their gradients, and the input projection's
    products timed alone (its forward matmul; the two matmuls of its
    backward), so that cuDNN's recurrent part reads as its time less
    theirs."""
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
        # saves for it
        out[f"{name} bwd"] = time_ms(fwd_bwd, iters=10) - time_ms(fn, iters=10)
    out["max_abs_err"] = (out.pop("port ys") - out.pop("cuDNN ys")).abs().max().item()
    out["grad_rel"] = max(_rel(a, b) for a, b in zip(grads["port"], grads["cuDNN"]))
    w_ih = torch.cat([lib.weight_ih_l0, lib.weight_ih_l0_reverse]).detach()
    xd = x.detach()
    out["proj fwd"] = time_ms(lambda: torch.matmul(xd, w_ih.t()), iters=10)
    out["proj bwd"] = time_ms(lambda: (
        torch.matmul(dxp, w_ih),
        torch.matmul(dxp.reshape(-1, 6 * H).t(), xd.reshape(-1, cin))), iters=10)
    out["cuDNN recurrent fwd"] = out["cuDNN fwd"] - out["proj fwd"]
    out["cuDNN recurrent bwd"] = out["cuDNN bwd"] - out["proj bwd"]
    out["cuDNN recurrent fwd device"] = cudnn_recurrent_fwd(lib, xd)[1]
    log(f"GRU layer T={T} B={B} cin={cin} H={H} D=2, port against cuDNN nn.GRU "
        f"(same weights): outputs max_abs_err={out['max_abs_err']:.3e}, gradients "
        f"relative to each largest {out['grad_rel']:.3e}; forward {out['port fwd']:.4f} "
        f"vs {out['cuDNN fwd']:.4f} ms, backward {out['port bwd']:.4f} vs "
        f"{out['cuDNN bwd']:.4f} ms; the input projection's matmuls forward "
        f"{out['proj fwd']:.4f} ms, backward {out['proj bwd']:.4f} ms; cuDNN less "
        f"them: forward {out['cuDNN recurrent fwd']:.4f} ms, backward "
        f"{out['cuDNN recurrent bwd']:.4f} ms; cuDNN's recurrent forward by device time "
        f"{out['cuDNN recurrent fwd device']:.4f} ms")
    return out


def bwd_timing(device):
    """The backward kernels at the training shapes: (name, source, replaces,
    ms, plain ms, library ms, bytes, FLOP) rows for the generator's shape
    (T 34, B 512, H 300, D 2, a later layer's 600 inputs), and log lines
    for the discriminator's (H 64) and for the forward kernel at B 512;
    then the walk layout's (`run_layer`) three kernels at the generator's
    shape, with their forward also at B 1."""
    import torch
    from speech2affective_gestures_torch.ops import gru_cuda

    rows = []
    T, B, D = 34, 512, 2
    for H, cin in ((300, 600), (64, 128)):
        xp, w_hh, b_ih, b_hh = gru_inputs(T, B, cin, H, D, seed=9, device=device)
        g = torch.Generator().manual_seed(9)
        dys = torch.randn(T, B, D * H, generator=g).to(device)
        ys, _ = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh)
        dxp, gn = gru_cuda.gru_bwd_recurrence(xp, w_hh, b_ih, b_hh, ys, dys)
        args = (xp, w_hh, b_ih, b_hh, ys, dys)
        bwd_ms = time_ms(lambda: gru_cuda.gru_bwd_recurrence(*args), iters=10)
        bwd_plain = time_ms(lambda: gru_cuda.gru_bwd_recurrence_plain(*args), iters=5)
        dw_ms = time_ms(lambda: gru_cuda.gru_dw(ys, dxp, gn, D), iters=10)
        dw_plain = time_ms(lambda: gru_cuda.gru_dw_plain(ys, dxp, gn, D), iters=10)
        # cuBLAS's product h_prev^T g on operands laid out for it (their
        # preparation not timed)
        hprev = gru_cuda._prev_states(ys, D).contiguous()
        g_op = torch.cat([dxp.view(T, B, D, 3 * H)[..., :2 * H],
                          gn.view(T, B, D, H)], dim=-1).contiguous()
        dw_lib = time_ms(lambda: torch.einsum("tbdk,tbdj->dkj", hprev, g_op), iters=10)
        layer_ms = time_ms(lambda: gru_cuda.gru_layer_bwd(*args), iters=10)
        # cuDNN's recurrent backward (its dx of the recurrence, dW_hh and
        # the biases) at the layer's real width: its backward less the input
        # projection's two matmuls
        lt = layer_times(T, B, cin, H, device)
        lib_ms = lt["cuDNN recurrent bwd"]
        n_rec = 2 * T * B * D * H * 3 * H
        rec_flops = n_rec + 30 * T * B * D * H
        rec_bytes = 4 * (2 * xp.numel() + 3 * ys.numel() + w_hh.numel()
                         + b_ih.numel() + b_hh.numel())
        dw_flops = 2 * T * B * D * (H + 1) * 3 * H
        dw_bytes = 4 * (ys.numel() + 2 * xp.numel() // 3 + gn.numel()
                        + w_hh.numel() + b_hh.numel())
        # the whole backward reads xp, ys, dys and the weights once and
        # writes dxp and the weight gradients once
        both, both_by = bound(4 * (2 * xp.numel() + 2 * ys.numel() + 2 * w_hh.numel()
                                   + 2 * b_ih.numel() + 2 * b_hh.numel()),
                              n_rec + dw_flops)
        log(f"gru backward T={T} B={B} H={H} D={D}: recurrence {bwd_ms:.4f} ms "
            f"(plain {bwd_plain:.4f}), dW {dw_ms:.4f} ms (plain {dw_plain:.4f}, "
            f"cuBLAS product {dw_lib:.4f}), the three together (gru_layer_bwd: "
            f"recurrence, dW_hh, db_ih) {layer_ms:.4f} ms against cuDNN's recurrent "
            f"backward {lib_ms:.4f} ms; bound of the three {both:.5f} ms ({both_by}; "
            f"{n_rec + dw_flops} FLOP without the recompute)")
        if H == 300:
            src = "speech2affective_gestures_torch/csrc/gru_bwd.cu"
            rows.append(("gru_bwd", src, "speech2affective_gestures_tpu/ops/gru_pallas.py:384",
                         bwd_ms, bwd_plain, lib_ms, rec_bytes, rec_flops, None, None))
            rows.append(("gru_dw", src, "speech2affective_gestures_tpu/ops/gru_pallas.py:432",
                         dw_ms, dw_plain, dw_lib, dw_bytes, dw_flops, None, None))
        # the forward kernel at the training batch (and, at H 300, the
        # scoring batch)
        for fb in (B, 258) if H == 300 else (B,):
            fargs = gru_inputs(T, fb, cin, H, D, seed=9, device=device)
            f_ms = time_ms(lambda: gru_cuda.gru_layer_forward(*fargs), iters=10)
            f_dev = device_ms(lambda: gru_cuda.gru_layer_forward(*fargs))
            f_plain = time_ms(lambda: gru_cuda.gru_layer_plain(*fargs), iters=5)
            f_bound, f_by = bound(
                4 * (fargs[0].numel() + w_hh.numel() + b_ih.numel() + b_hh.numel()
                     + T * fb * D * H + D * fb * H),
                T * D * fb * (2 * H * 3 * H + 3 * H + 12 * H))
            lib = (f"cuDNN's recurrent forward {lt['cuDNN recurrent fwd']:.4f} ms, by device "
                   f"time {lt['cuDNN recurrent fwd device']:.4f} ms, " if fb == B else "")
            log(f"gru_fwd T={T} B={fb} H={H} D={D}: {f_ms:.4f} ms, by device time "
                f"{f_dev:.4f} ms, plain {f_plain:.4f} ms, {lib}bound {f_bound:.5f} ms "
                f"({f_by}); plan {gru_cuda._device_plan(device, fb, H, D)._asdict()}")
        if H == 300:
            rows += v1_timing(device, lt)
    return rows


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
        ys = gru_cuda.run_layer_forward(xw, w_hh, b_hh)
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
        dxp, gn = gru_cuda.run_layer_bwd_recurrence(xw, w_hh, b_hh, ys, dys)
        args = (xw, w_hh, b_hh, ys, dys)
        bwd_ms = time_ms(lambda: gru_cuda.run_layer_bwd_recurrence(*args), iters=10)
        bwd_plain = time_ms(lambda: gru_cuda.run_layer_bwd_recurrence_plain(*args), iters=5)
        dw_ms = time_ms(lambda: gru_cuda.run_layer_dw(ys, dxp, gn), iters=10)
        dw_plain = time_ms(lambda: gru_cuda.run_layer_dw_plain(ys, dxp, gn), iters=10)
        hprev = gru_cuda._walk_prev(ys).contiguous()
        g_op = torch.cat([dxp[..., :2 * H], gn], dim=-1).contiguous()
        dw_lib = time_ms(lambda: torch.einsum("tdbk,tdbj->dkj", hprev, g_op), iters=10)
        n_rec = 2 * T * B * D * H * 3 * H
        dw_flops = 2 * T * B * D * (H + 1) * 3 * H
        rows += [
            ("gru_fwd_v1", fwd_src, f"{tpu}:66", fwd_ms, fwd_plain, lt["cuDNN recurrent fwd"],
             fwd_bytes, n_cell, fwd_dev, lt["cuDNN recurrent fwd device"]),
            ("gru_bwd_v1", bwd_src, f"{tpu}:123", bwd_ms, bwd_plain, lt["cuDNN recurrent bwd"],
             4 * (2 * xw.numel() + 3 * ys.numel() + w_hh.numel() + b_hh.numel()),
             n_rec + 30 * T * B * D * H, None, None),
            ("gru_dw_v1", bwd_src, f"{tpu}:178", dw_ms, dw_plain, dw_lib,
             4 * (ys.numel() + 2 * xw.numel() // 3 + gn.numel() + w_hh.numel()
                  + b_hh.numel()), dw_flops, None, None),
        ]
        log(f"gru v1 T={T} B={B} H={H} D={D}: forward {fwd_ms:.4f} ms (by device time "
            f"{fwd_dev:.4f}; plain "
            f"{fwd_plain:.4f}), recurrence {bwd_ms:.4f} ms (plain {bwd_plain:.4f}), dW "
            f"{dw_ms:.4f} ms (plain {dw_plain:.4f}, cuBLAS product {dw_lib:.4f})")
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
    lt = layer_times(T, B, 600, H, device, seed=5)
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
    for name, source, replaces, ms, plain, lib_ms, nbytes, flops, dev, lib_dev in (
            ("gru_fwd", "speech2affective_gestures_torch/csrc/gru_fwd.cu",
             "speech2affective_gestures_tpu/ops/gru_pallas.py:338",
             gru_ms, gru_plain_ms, gru_lib_ms, gru_bytes, gru_flops, gru_dev, gru_lib_dev),
            ("mel_power", "speech2affective_gestures_torch/csrc/mel_power.cu",
             "speech2affective_gestures_tpu/ops/dsp_pallas.py:57",
             mel_ms, mel_plain_ms, mel_lib_ms, mel_bytes, mel_flops, mel_dev, mel_lib_dev),
            *bwd_timing(device)):
        b_ms, b_by = bound(nbytes, flops)
        rows_out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "device_ms": dev, "library_device_ms": lib_dev,
        })
        by_device = "" if dev is None else (
            f" (by device time {dev:.4f} ms, library {lib_dev:.4f} ms)")
        log(f"{name}: {ms:.4f} ms, plain {plain:.4f} ms, library {lib_ms:.4f} ms"
            f"{by_device}, bound {b_ms:.5f} ms ({b_by}; {nbytes} bytes, {flops} FLOP)")
    return rows_out


def main() -> int:
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
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    device = torch.device("cuda", 0)
    errs = kernel_phase(device)
    errs.update(bwd_kernel_phase(device))
    errs.update(v1_kernel_phase(device))
    served = service_phase(device)
    v1_path = v1_path_phase(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        work = pathlib.Path(work)
        embedding_net = embedding_phase(device, work)
        trainer, trained = training_phase(device, work, embedding_net)
        eval_parity_phase(trainer, work)
        time_generate_gestures(trainer)
        step_parity_phase(device)
        time_train_step(trainer)
        del trainer
    # each kernel's launches on the paths that run it: the service's two
    # requests, the training run with its test-split scoring, and run_layer
    launches = {k: served.get(k, 0) + trained.get(k, 0) for k in {*served, *trained}}
    launches.update(v1_path)
    kernels = timing_phase(device, errs, launches)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
