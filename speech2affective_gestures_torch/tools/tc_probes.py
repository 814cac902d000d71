"""What bounds the bf16 tensor-core kernels, by variants of them, on one GPU.

    python speech2affective_gestures_torch/tools/tc_probes.py

Builds edited copies of `csrc/gru_fwd.cu` and `csrc/gru_bwd.cu` into the
git-ignored `_build/probes/` (one nvcc per copy, started together) and
times each variant's kernel at the training shape (T 34, B 512, H 300, D
2, bf16), by CUDA events and device time:
- the forward's tensor tier (`gru_layer_fwd_tc_kernel`) as it is; without
  the gate update (h' the sum of the three gates' products, so the
  product, the exchange and the barrier remain); with faster gate math
  (`__expf`, `tanh.approx`); without the ys stores; without the xp loads;
  without the exchange; and bounded to two blocks an SM;
- the dW product (`gru_dw_tc_kernel`) as it is; without its products (the
  copies alone); without its copies past the prologue (the products
  alone); and with 128 x 256 tiles at one block an SM (the first design);
- the dW product as it is at B 64 to 1024 (inputs of 13 to 209 MB against
  the 50 MB L2): its time per 1000 rows.
A variant that drops work computes the wrong function: its time, not its
output, is the reading. Prints the card's name and power limit first,
then one JSON object a line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]


def _fast_gate(body: str) -> str:
    return body.replace("sigmoid_f(", "sig_fast(").replace("tanhf(", "tanh_fast(")


FAST = """
namespace {
__device__ __forceinline__ float sig_fast(float x) { return __frcp_rn(1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
}  // namespace
"""
# (name, what to replace, with what) inside the tensor tier's kernel
FWD = {
    "as it is": [],
    "no gate update": [("if (row < nrows && j + e < H) {",
                        "hnew = acc[i][0][2 * h + e] + acc[i][1][2 * h + e] + "
                        "acc[i][2][2 * h + e] + (float)(xv[i][h][0] & 1); if (0) {")],
    "fast gate math": "fast",
    "no ys stores": [("ys[row_offset<WALK>(t, step, d, b0 + row, B, D, H) + j + e] = "
                      "narrow<bf16_t>(hnew);",
                      "if (hnew == 12345.0f) ys[0] = narrow<bf16_t>(hnew);")],
    "no xp loads": [("xv[i][h][g] = pack2(ok && j < H ? bits_of(x + g * H + j) : 0,\n"
                     "                                ok && j + 1 < H ? "
                     "bits_of(x + g * H + j + 1) : 0);",
                     "xv[i][h][g] = pack2(ok ? (unsigned short)(row + g) : 0, "
                     "ok ? (unsigned short)(step + j) : 0);")],
    "no exchange": [("*reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, peer)) = v;",
                     "if (v.x == 0xdeadbeefu) "
                     "*reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, peer)) = v;")],
    "two blocks an SM": [("__launch_bounds__(TC_THREADS, 1) gru_layer_fwd_tc_kernel",
                          "__launch_bounds__(160, 2) gru_layer_fwd_tc_kernel")],
}
DW = {
    "as it is": ([], 128, 2),
    "copies alone": ([("mma_bf16(acc[mt][nt]", "if (0) mma_bf16(acc[mt][nt]")], 128, 2),
    "products alone": ([("load_stage(it + DNST - 1, (it + DNST - 1) % DNST);",
                         "cp_async_commit();")], 128, 2),
    "128 x 256 tiles, one block an SM": (
        [("constexpr int DWK = 2, DWJ = 4, DMT = 4, DNT = 4;",
          "constexpr int DWK = 2, DWJ = 4, DMT = 4, DNT = 8;"),
         ("constexpr int DW_TC_MIN_BLOCKS = 2;", "constexpr int DW_TC_MIN_BLOCKS = 1;")],
        256, 1),
}


def _edit(src: str, start: str, end: str, edits) -> str:
    """src with each (old, new) of `edits` replaced once between the markers
    `start` and `end`; an edit that does not apply is an error."""
    a, b = src.index(start), src.index(end)
    body = src[a:b]
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"tc_probes: the source no longer holds {old!r}")
        body = body.replace(old, new, 1)
    return src[:a] + body + src[b:]


def main() -> int:
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("tc_probes: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from speech2affective_gestures_torch.ops import _build, gru_cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    fwd_src = (_build.CSRC / "gru_fwd.cu").read_text()
    bwd_src = (_build.CSRC / "gru_bwd.cu").read_text()
    fwd_span = ("gru_layer_fwd_tc_kernel(\n", "// tier 0: the register instance")
    sources = {}
    for name, edits in FWD.items():
        if edits == "fast":
            text = _edit(fwd_src, *fwd_span, [])
            a, b = text.index(fwd_span[0]), text.index(fwd_span[1])
            text = text[:a] + _fast_gate(text[a:b]) + text[b:]
            text = text.replace('#include "gru_cluster.cuh"\n',
                                '#include "gru_cluster.cuh"\n' + FAST, 1)
        else:
            text = _edit(fwd_src, "constexpr int TC_THREADS", fwd_span[1], edits)
        sources[("fwd", name)] = text
    for name, (edits, _, _) in DW.items():
        sources[("dw", name)] = _edit(bwd_src, "// Warp (wk, wj) of the WK x WJ",
                                      "// The bf16 product's shared memory", edits)
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        src = out_dir / f"variant{i}.cu"
        src.write_text(text)
        lib = out_dir / f"libvariant{i}.so"
        procs[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the variant {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))

    def entry(lib, symbol, n_ptr, n_int):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def emit(kind, name, shape, run, **more):
        run()
        torch.cuda.synchronize()
        print(json.dumps({"kernel": kind, "variant": name, "shape": shape,
                          "ms": cs.time_ms(run), "device_ms": cs.device_ms(run), **more}),
              flush=True)

    device = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    T, B, H, D = 34, 512, 300, 2
    xp, w_hh, b_ih, b_hh = (t.to(bf16).contiguous()
                            for t in cs.gru_inputs(T, B, 600, H, D, seed=9, device=device))
    b_in, b_rec = gru_cuda.kernel_biases(b_ih, b_hh, H)
    ys = torch.empty((T, B, D * H), device=device, dtype=bf16)
    h_last = torch.empty((D, B, H), device=device, dtype=bf16)
    one_row = gru_cuda.fwd_plan(1, H, 1, 1, "tensor")
    for name in FWD:
        lib = libs[("fwd", name)]
        fn = entry(lib, "s2ag_gru_layer_fwd", 7, 13)
        # the plan by the variant's own count of clusters at once (the
        # two-block variant fits twice as many)
        count = getattr(lib, "s2ag_gru_fwd_max_clusters")
        count.argtypes = [ctypes.c_int] * 7
        clusters = count(one_row.S, one_row.KC, one_row.C, one_row.threads, one_row.smem,
                         gru_cuda._TIERS["tensor"], 1)
        plan = gru_cuda.fwd_plan(B, H, D, clusters, "tensor")

        def run(fn=fn, plan=plan):
            rc = fn(xp.data_ptr(), w_hh.data_ptr(), b_in.data_ptr(), b_rec.data_ptr(),
                    ys.data_ptr(), h_last.data_ptr(), 0, T, B, H, D,
                    *gru_cuda._plan_args(plan, bf16), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"the forward variant {name!r} failed: CUDA error {rc}")
        emit("gru_fwd_bf16 tensor tier", name, [T, B, H, D], run, clusters=clusters,
             tile_rows=plan.BT)

    def dw_inputs(batch):
        a = [t.to(bf16).contiguous()
             for t in cs.gru_inputs(T, batch, 600, H, D, seed=9, device=device)]
        y, _, hp = gru_cuda.gru_layer_forward(*a, save_hp=True)
        dys = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(device, bf16)
        return (y, *gru_cuda.gru_bwd_recurrence(*a, y, dys, hp))

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for batch in (64, 128, 256, 512, 1024):
        y, dxp, gn = dw_inputs(batch)
        M = T * batch
        for name, (_, tile_j, per_sm) in DW.items():
            if batch != B and name != "as it is":
                continue
            tiles = -(-(H + 1) // 128) * -(-3 * H // tile_j) * D
            S = max(1, min(per_sm * sms // tiles, M // 512))
            rows = -(-(-(-M // S)) // 32) * 32
            S = -(-M // rows)
            part = torch.empty((S, D, H + 1, 3 * H), device=device)
            dw = torch.empty((D, H, 3 * H), device=device)
            db = torch.empty((D, 3 * H), device=device)
            fn = entry(libs[("dw", name)], "s2ag_gru_layer_dw", 6, 8)

            def run(fn=fn, y=y, dxp=dxp, gn=gn, part=part, dw=dw, db=db, S=S, rows=rows,
                    batch=batch):
                rc = fn(y.data_ptr(), dxp.data_ptr(), gn.data_ptr(), part.data_ptr(),
                        dw.data_ptr(), db.data_ptr(), T, batch, H, D, S, rows,
                        gru_cuda.dw_plan(T, batch, H, D, sms, 16, 2).vec, 1,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"the dW variant {name!r} failed: CUDA error {rc}")
            inputs_mb = (y.numel() + dxp.numel() + gn.numel()) * 2 / 1e6
            emit("gru_dw_bf16", name, [T, batch, H, D], run, splits=S, inputs_mb=inputs_mb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
