"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, loaded with `ctypes`. The
library's file name carries a hash of its source, the headers and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
build goes into `speech2affective_gestures_torch/_build/` (git-ignored) at
first use; `build()` starts one `nvcc` per source at once.

Nothing here runs at import time, so the package imports on a machine
without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC",
)

# ptxas reports (registers, shared memory, spills) of the last build of
# each source, for chip_smoke.py to print
build_logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source whose library is missing, all `nvcc`
    processes started together; raise with the compiler's output if any
    fails."""
    targets = {n: library_path(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{n}.cu:\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed; not
    for the first time inside a CUDA graph capture, whose first launch
    would set the kernels' attributes there."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import torch

            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"csrc/{name}.cu is first loaded inside a CUDA graph "
                                   "capture: run its kernels eagerly before capturing them")
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
