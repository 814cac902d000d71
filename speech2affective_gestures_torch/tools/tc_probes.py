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
  the 50 MB L2): its time per 1000 rows;
- the bf16 recurrence's tensor tier (`gru_layer_bwd_tc_kernel`) as it is,
  with 4, 5 and 8 n8 tiles of outputs a warp (10, 8 and 5 warps at H 300:
  the independent accumulators a warp keeps against its W registers); its
  hi and lo products in separate accumulators; without the lo product
  (hi alone, the single bf16 product the split replaces); without
  products; without the partials' exchange; without the gate update's
  loads; without the dxp and gn stores; and at 16-row tiles (the most a
  block holds when every block receives the whole g row, hi and lo,
  double-buffered: the waves of that design); with its gate loop unrolled
  by 2; with at most 200 registers a thread (`__maxnreg__`, where nvcc has
  it, in place of the launch bounds' cap);
- the recurrence's two tiers (registers, tensor) at H 300 from B 1 to 512
  and at H 64 and 40: the readings behind `gru_cuda.BWD_TENSOR_MIN_WORK`.
A variant that drops work computes the wrong function: its time, not its
output, is the reading. A variant that does not build is reported and
skipped. Prints the card's name and power limit first,
then one JSON object a line. `--only rec` runs the recurrence's probes
alone.
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


# the recurrence's tensor tier: (source edits, n8 tiles a warp, rows a
# tile at most)
GATE_LOOP = "    for (int idx = threadIdx.x; idx < nrows * U; idx += blockDim.x) {"
MORE_NT = [("#define S2AG_BWD_TC_INSTANCES S2AG_BWD_TC_NT(4)",
            "#define S2AG_BWD_TC_INSTANCES S2AG_BWD_TC_NT(4) S2AG_BWD_TC_NT(5) "
            "S2AG_BWD_TC_NT(8)")]
REC = {
    "as it is": ([], None, None),
    "4 n8 tiles a warp": ([], 4, None),
    "5 n8 tiles a warp": (MORE_NT, 5, None),
    "8 n8 tiles a warp": (MORE_NT, 8, None),
    "hi and lo apart": ([
        ("float acc[NT][4];", "float acc[NT][4], acl[NT][4];"),
        ("acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;",
         "{ acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f; "
         "acl[nt][0] = acl[nt][1] = acl[nt][2] = acl[nt][3] = 0.0f; }"),
        ("mma_bf16(acc[nt], alo,", "mma_bf16(acl[nt], alo,"),
        ("make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);",
         "make_float2(acc[nt][2 * h] + acl[nt][2 * h], acc[nt][2 * h + 1] + acl[nt][2 * h + 1]);"),
    ], None, None),
    "hi alone": ([("if (nw * NT + nt < N8) mma_bf16(acc[nt], alo,",
                   "if (0) mma_bf16(acc[nt], alo,")], None, None),
    "no products": ([("if (nw * NT + nt < N8) mma_bf16(acc[nt], ahi,",
                      "if (0) mma_bf16(acc[nt], ahi,"),
                     ("if (nw * NT + nt < N8) mma_bf16(acc[nt], alo,",
                      "if (0) mma_bf16(acc[nt], alo,")], None, None),
    "no exchange": ([("*reinterpret_cast<float2*>(cluster.map_shared_rank(dst, owner)) =",
                      "if (acc[nt][0] == 12345.0f) "
                      "*reinterpret_cast<float2*>(cluster.map_shared_rank(dst, owner)) =")],
                    None, None),
    "no gate loads": ([
        ("x[gt] = rounded<bf16_t>(ld(xp + xo + gt * H) + bi);",
         "x[gt] = rounded<bf16_t>(0.001f * (float)(xo & 7) + bi);"),
        ("hh[gt] = __ldg(hp + xo + gt * H);", "hh[gt] = 0.002f * (float)(gt + (ho & 3));"),
        ("const float dy = ld(dys + ho);", "const float dy = 0.01f * (float)(ho & 15);"),
        ("has_prev ? ld(ys + row_offset<WALK>(q, q, d, b0 + row, B, D, H) + k) : 0.0f;",
         "has_prev ? 0.1f : 0.0f;"),
    ], None, None),
    "no dxp and gn stores": ([
        ("dxp[xo] = narrow<bf16_t>(dpre_r);",
         "if (dpre_r == 12345.0f) dxp[xo] = narrow<bf16_t>(dpre_r);"),
        ("dxp[xo + H] = narrow<bf16_t>(dpre_z);",
         "if (dpre_z == 12345.0f) dxp[xo + H] = narrow<bf16_t>(dpre_z);"),
        ("dxp[xo + 2 * H] = narrow<bf16_t>(dpre_n);",
         "if (dpre_n == 12345.0f) dxp[xo + 2 * H] = narrow<bf16_t>(dpre_n);"),
        ("if (gn != nullptr) gn[ho]", "if (gn != nullptr && r == 12345.0f) gn[ho]"),
    ], None, None),
    "16-row tiles (the broadcast's most)": ([], None, 16),
    "gate loop unrolled by 2": ([
        (GATE_LOOP, "#pragma unroll 2\n" + GATE_LOOP)],
        None, None),
    # at 10 warps ptxas caps a thread at 168 registers (and spills); this
    # raises the cap to 200 (the H100 refused it at launch, CUDA error 701)
    "at most 200 registers (__maxnreg__)": ([
        ("__launch_bounds__(bwd_tc_max_threads(NT), 1) gru_layer_bwd_tc_kernel",
         "__maxnreg__(200) gru_layer_bwd_tc_kernel")], None, None),
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
    only_rec = sys.argv[1:] == ["--only", "rec"]
    sources = {}
    for name, (edits, _, _) in REC.items():
        if edits:
            sources[("rec", name)] = _edit(bwd_src, "// the (KT, NT) instances",
                                           "// What the tensor tier's indexing needs", edits)
    for name, edits in ({} if only_rec else FWD).items():
        if edits == "fast":
            text = _edit(fwd_src, *fwd_span, [])
            a, b = text.index(fwd_span[0]), text.index(fwd_span[1])
            text = text[:a] + _fast_gate(text[a:b]) + text[b:]
            text = text.replace('#include "gru_cluster.cuh"\n',
                                '#include "gru_cluster.cuh"\n' + FAST, 1)
        else:
            text = _edit(fwd_src, "constexpr int TC_THREADS", fwd_span[1], edits)
        sources[("fwd", name)] = text
    for name, (edits, _, _) in ({} if only_rec else DW).items():
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
        if proc.returncode:  # reported, and the variant skipped
            print(json.dumps({"kernel": key[0], "variant": key[1], "build": "failed",
                              "nvcc": log.strip().splitlines()[-3:]}), flush=True)
            continue
        libs[key] = ctypes.CDLL(str(lib))

    def entry(lib, symbol, n_ptr, n_int):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def emit(kind, name, shape, run, **more):
        try:
            run()
        except RuntimeError as e:  # a launch the card refuses: reported, skipped
            print(json.dumps({"kernel": kind, "variant": name, "shape": shape,
                              "launch": str(e)}), flush=True)
            return
        torch.cuda.synchronize()
        print(json.dumps({"kernel": kind, "variant": name, "shape": shape,
                          "ms": cs.time_ms(run), "device_ms": cs.device_ms(run), **more}),
              flush=True)

    device = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    T, B, H, D = 34, 512, 300, 2
    rec_probes(libs, entry, emit, cs, gru_cuda, torch, device)
    if only_rec:
        return 0
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


def rec_probes(libs, entry, emit, cs, gru_cuda, torch, device) -> None:
    """The recurrence's tensor-tier variants (REC) at T 34, B 512, H 300, D
    2, then both tiers across batches and hidden sizes."""
    bf16 = torch.bfloat16
    T, D = 34, 2

    def inputs(B, H):
        xp, w_hh, b_ih, b_hh = (t.to(bf16).contiguous() for t in cs.gru_inputs(
            T, B, 600 if H == 300 else 128, H, D, seed=9, device=device))
        ys, _, hp = gru_cuda.gru_layer_forward(xp, w_hh, b_ih, b_hh, save_hp=True)
        dys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(1)).to(device, bf16)
        b_in, _ = gru_cuda.kernel_biases(b_ih, b_hh, H)
        return xp, w_hh, b_in, hp, ys, dys

    B, H = 512, 300
    xp, w_hh, b_in, hp, ys, dys = inputs(B, H)
    dxp = torch.empty_like(xp)
    gn = torch.empty_like(ys)
    for name, (edits, nt, rows) in REC.items():
        nt = nt or gru_cuda.BWD_TENSOR_NT
        clusters = gru_cuda.max_clusters(device, H, "bwd", bf16, "tensor")
        plan = gru_cuda.bwd_plan(B, H, D, clusters, "tensor", nt=nt)
        if rows:
            plan = plan._replace(BT=rows, tiles=-(-B // rows),
                                 smem=gru_cuda._bwd_tensor_smem(plan.C, plan.U,
                                                                plan.KC // 16, rows))
        if edits and ("rec", name) not in libs:
            continue  # its build failed (reported above)
        if edits:
            fn = entry(libs[("rec", name)], "s2ag_gru_layer_bwd", 8, 13)

            def run(fn=fn, plan=plan):
                rc = fn(xp.data_ptr(), w_hh.data_ptr(), b_in.data_ptr(), hp.data_ptr(),
                        ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(), gn.data_ptr(), T, B, H,
                        D, *gru_cuda._plan_args(plan, bf16),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"the recurrence variant {name!r} failed: CUDA error {rc}")
        else:
            def run(plan=plan):
                gru_cuda._recurrence_launch(False, xp, w_hh, b_in, hp, ys, dys, plan)
        emit("gru_bwd_bf16 tensor tier", name, [T, B, H, D], run, n8_tiles_a_warp=nt,
             threads=plan.threads, tile_rows=plan.BT, clusters=D * plan.tiles)
    for H, batches in ((300, (1, 5, 16, 24, 32, 48, 64, 128, 258, 512)), (64, (64, 258, 512)),
                       (40, (512,))):
        for B in batches:
            args = inputs(B, H)
            for tier in ("registers", "tensor"):
                plan = gru_cuda.bwd_plan(B, H, D, gru_cuda.max_clusters(
                    device, H, "bwd", bf16, tier), tier)
                emit(f"gru_bwd_bf16 {tier} tier", "as it is", [T, B, H, D],
                     lambda plan=plan, args=args: gru_cuda._recurrence_launch(
                         False, *args, plan), work=B * H * H)


if __name__ == "__main__":
    sys.exit(main())
