"""Where the GRU forward kernel's time loop spends its cycles, on one GPU.

    python speech2affective_gestures_torch/tools/gru_fwd_phases.py

Builds `speech2affective_gestures_torch/csrc/gru_fwd.cu` with
`-DS2AG_FWD_PHASES` (its clock64() probes around the phases of a step)
into a library of its own in the git-ignored `_build/`, runs it at the main
paths' shapes (H 300 at B 1, 258 and 512; H 64 at B 512) and prints, per
step of the time loop, the SM cycles that thread 0 of block 0 spent in each
phase: the chunk products and their reduction (`product`), the gate update
with the stores of ys (`gate`), the float4 exchange into the cluster's h
buffers (`exchange`) and the barrier (`barrier`), summed over the step's
row groups, and the whole step (`step`); and the instrumented launch's
device time. The probes cost a few percent of the kernel's time; the
split, not the total, is the reading. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]
PHASES = ("product", "gate", "exchange", "barrier", "step")


def main() -> int:
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("gru_fwd_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from speech2affective_gestures_torch.ops import _build, gru_cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libgru_fwd_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DS2AG_FWD_PHASES", "-o",
                    str(lib_path), str(_build.CSRC / "gru_fwd.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.s2ag_gru_layer_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    device = torch.device("cuda", 0)
    T, D = 34, 2
    for H, B in ((300, 1), (300, 258), (300, 512), (64, 512)):
        xp, w_hh, b_ih, b_hh = cs.gru_inputs(T, B, 600 if H == 300 else 128, H, D,
                                             seed=9, device=device)
        p = gru_cuda._device_plan(device, B, H, D)
        ys = torch.empty((T, B, D * H), device=device)
        h_last = torch.empty((D, B, H), device=device)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            rc = fn(xp.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
                    ys.data_ptr(), h_last.data_ptr(), None, T, B, H, D,
                    *gru_cuda._plan_args(p), stream)
            if rc:
                raise RuntimeError(f"instrumented gru_fwd launch failed: CUDA error {rc}")

        ms = cs.device_ms(run)
        cycles = (ctypes.c_longlong * 5)()
        if lib.s2ag_phase_read(cycles):
            raise RuntimeError("could not read the phase counters")
        print(json.dumps({"H": H, "B": B, "plan": p._asdict(), "device_ms": ms,
                          "cycles_per_step": {n: cycles[i] / T for i, n in enumerate(PHASES)}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
