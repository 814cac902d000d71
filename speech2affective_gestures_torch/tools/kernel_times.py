"""Time the port's GRU forward and mel kernels of one checkout on one GPU.

    python speech2affective_gestures_torch/tools/kernel_times.py [ROOT] [--label NAME]

Imports `speech2affective_gestures_torch` from ROOT (default: this
checkout), builds its kernels there, and times, at the main paths' shapes,
`mel_cuda.mel_power` (R 568 and 2272 rows at n_fft 2048, 1876 rows at
1024), `gru_cuda.gru_layer_forward` (T 34, H 300, D 2, layer input 600, at
B 1, 258 and 512; H 64 at B 512) and `gru_cuda.run_layer_forward` (B 1 and
512), beside two library yardsticks: `torch.fft.rfft` + power + the mel
product, and cuDNN's `nn.GRU` forward less its input projection. Each
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
