"""Time the port's GRU forward and mel kernels of one checkout on one GPU.

    python speech2affective_gestures_torch/tools/kernel_times.py [ROOT] [--label NAME]

Imports `speech2affective_gestures_torch` from ROOT (default: this
checkout), builds its kernels there, and times, at the main paths' shapes,
`mel_cuda.mel_power` (R 568 and 2272 rows at n_fft 2048, 1876 rows at
1024), `gru_cuda.gru_layer_forward` (T 34, H 300, D 2, layer input 600, at
B 1, 258 and 512; H 64 at B 512), `gru_cuda.run_layer_forward` (B 1 and
512), and the backward at B 512, H 300 and 64: `GRULayerFunction`'s
forward + backward, that less its forward, and `gru_cuda.gru_dw`; beside
the library yardsticks: `torch.fft.rfft` + power + the mel product, and
cuDNN's `nn.GRU` forward, and forward + backward less forward, less its
input projection's products. Where the checkout has the GRU kernels' bf16
instances, also the bf16 forward (B 1 and 512), backward and dW at H 300
beside cuDNN's bf16 `nn.GRU`, the bf16 recurrence of the walk layout
(`run_layer`), and the mel kernel at n_fft 400 (80 bands, 3000 rows),
1000, 1536 and 256 (568 rows) in the tier its plan names, beside `rfft`. Each
time is given twice: the CUDA-event mean of a call (the wrapper's host
cost included) and the device time per call from torch.profiler (the time
in which any of the call's kernels ran). The timing helpers, the inputs and
the yardsticks are this checkout's `chip_smoke.py`'s. Prints the card's
name and power limit, then one JSON object per line.

To compare two commits on one card, run it on each checkout in turns on
the same machine (parent, change, change, parent): only the ROOT differs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # before ROOT goes first: ROOT may hold its own

    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    import speech2affective_gestures_torch as pkg
    from speech2affective_gestures_torch.ops import gru_cuda, mel_cuda

    if pathlib.Path(pkg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    def emit(name, shape, fn=None, times=None):
        ms, dev = times if times is not None else (cs.time_ms(fn), cs.device_ms(fn))
        print(json.dumps({"label": label, "name": name, "shape": shape, "ms": ms,
                          "device_ms": dev}), flush=True)

    for rows, n_fft in ((568, 2048), (2272, 2048), (1876, 1024)):
        f = cs.speech_frames(rows, device, n_fft)
        emit("mel_power", [rows, n_fft], lambda: mel_cuda.mel_power(f))
        if n_fft == 2048:
            emit("rfft_mel (library)", [rows, n_fft], cs.rfft_mel(f))

    T, D, cin = 34, 2, 600
    for H, B in ((300, 1), (300, 258), (300, 512), (64, 512)):
        a = cs.gru_inputs(T, B, cin if H == 300 else 128, H, D, seed=9, device=device)
        emit("gru_fwd", [T, B, H, D], lambda: gru_cuda.gru_layer_forward(*a))
    for B in (1, 512):
        xw, w_hh, b_hh, _ = cs.v1_inputs(T, B, cin, 300, D, seed=9, device=device)
        emit("gru_fwd_v1", [T, B, 300, D], lambda: gru_cuda.run_layer_forward(xw, w_hh, b_hh))
        lib = torch.nn.GRU(cin, 300, bidirectional=True).to(device)
        x = torch.randn(T, B, cin, generator=torch.Generator().manual_seed(B)).to(device)
        emit("cuDNN recurrent forward (library)", [T, B, 300, D],
             times=cs.cudnn_recurrent_fwd(lib, x))

    # the backward at the training batch, through entry points every
    # version of the port has: the layer's autograd Function forward +
    # backward, that less its forward, and the dW reduction on the plain
    # recurrence's output
    B = 512
    for H, c in ((300, cin), (64, 128)):
        a = cs.gru_inputs(T, B, c, H, D, seed=9, device=device)
        g = torch.Generator().manual_seed(9)
        dys = torch.randn(T, B, D * H, generator=g).to(device)
        dh = torch.randn(D, B, H, generator=g).to(device)
        leaves = [t.clone().requires_grad_() for t in a]

        def fwd():
            return gru_cuda.GRULayerFunction.apply(*leaves)

        def fwd_bwd():
            return torch.autograd.grad(fwd(), leaves, (dys, dh))

        both = (cs.time_ms(fwd_bwd, iters=10), cs.device_ms(fwd_bwd, n=10))
        alone = (cs.time_ms(fwd, iters=10), cs.device_ms(fwd, n=10))
        emit("gru_layer forward + backward", [T, B, H, D], times=both)
        emit("gru_layer backward (forward + backward less forward)", [T, B, H, D],
             times=(both[0] - alone[0], both[1] - alone[1]))
        ys = gru_cuda.gru_layer_forward(*a)[0]
        dxp, gn = gru_cuda.gru_bwd_recurrence_plain(*a, ys, dys)
        emit("gru_dw", [T, B, H, D], lambda: gru_cuda.gru_dw(ys, dxp, gn, D))
        lib = torch.nn.GRU(c, H, bidirectional=True).to(device)
        x = torch.randn(T, B, c, generator=g).to(device).requires_grad_()
        emit("cuDNN recurrent backward, dW_hh included (library)", [T, B, H, D],
             times=cs.cudnn_recurrent_bwd(lib, x, dys, dh))
    if hasattr(gru_cuda, "STORAGE"):
        bf16_times(cs, gru_cuda, mel_cuda, device, emit)
    return 0


def bf16_times(cs, gru_cuda, mel_cuda, device, emit) -> None:
    """The bf16 instances at H 300 (the forward at B 1 and 512, the
    recurrence and dW at B 512, `GRULayerFunction`'s backward) against
    cuDNN's bf16 `nn.GRU`; the mel kernel's DFT tier against `rfft`."""
    import torch

    bf16 = torch.bfloat16
    T, D, H, cin = 34, 2, 300, 600
    for B in (1, 512):
        a = [t.to(bf16).contiguous() for t in cs.gru_inputs(T, B, cin, H, D, seed=9,
                                                             device=device)]
        emit("gru_fwd bf16", [T, B, H, D], lambda: gru_cuda.gru_layer_forward(*a))
        lib = torch.nn.GRU(cin, H, bidirectional=True).to(device, bf16)
        x = torch.randn(T, B, cin, generator=torch.Generator().manual_seed(B)).to(device, bf16)
        emit("cuDNN bf16 recurrent forward (library)", [T, B, H, D],
             times=cs.cudnn_recurrent_fwd(lib, x))
    g = torch.Generator().manual_seed(9)
    dys = torch.randn(T, B, D * H, generator=g).to(device, bf16)
    dh = torch.randn(D, B, H, generator=g).to(device, bf16)
    leaves = [t.clone().requires_grad_() for t in a]

    def fwd():
        return gru_cuda.GRULayerFunction.apply(*leaves)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves, (dys, dh))

    both = (cs.time_ms(fwd_bwd, iters=10), cs.device_ms(fwd_bwd, n=10))
    alone = (cs.time_ms(fwd, iters=10), cs.device_ms(fwd, n=10))
    emit("gru_layer bf16 backward (forward + backward less forward)", [T, B, H, D],
         times=(both[0] - alone[0], both[1] - alone[1]))
    ys, _, hp = gru_cuda.gru_layer_forward(*a, save_hp=True)
    emit("gru_bwd bf16 (recurrence)", [T, B, H, D],
         lambda: gru_cuda.gru_bwd_recurrence(*a, ys, dys, hp))
    dxp, gn = gru_cuda.gru_bwd_recurrence(*a, ys, dys, hp)
    emit("gru_dw bf16", [T, B, H, D], lambda: gru_cuda.gru_dw(ys, dxp, gn, D))
    x = torch.randn(T, B, cin, generator=g).to(device, bf16).requires_grad_()
    emit("cuDNN bf16 recurrent backward, dW_hh included (library)", [T, B, H, D],
         times=cs.cudnn_recurrent_bwd(lib, x, dys, dh))
    xw, ww, bw = (t.to(bf16).contiguous()
                  for t in cs.v1_inputs(T, B, cin, H, D, seed=9, device=device)[:3])
    yw, hpw = gru_cuda.run_layer_forward(xw, ww, bw, save_hp=True)
    dyw = torch.randn(yw.shape, generator=g).to(device, bf16)
    emit("gru_bwd_v1 bf16 (recurrence)", [T, B, H, D],
         lambda: gru_cuda.run_layer_bwd_recurrence(xw, ww, bw, yw, dyw, hpw))
    for rows, n_fft, n_mels in ((3000, 400, 80), (568, 1000, 128), (568, 1536, 128),
                                (568, 256, 128)):
        f = cs.speech_frames(rows, device, n_fft)
        tier = mel_cuda.mel_plan(rows, n_fft, n_mels).tier
        emit(f"mel_power {tier} tier", [rows, n_fft, n_mels],
             lambda: mel_cuda.mel_power(f, n_mels=n_mels))
        emit("rfft_mel (library)", [rows, n_fft, n_mels], cs.rfft_mel(f, n_mels))


if __name__ == "__main__":
    sys.exit(main())
