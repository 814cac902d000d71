// Forward of one (bi)directional GRU layer, the whole time loop in one kernel.
//
// Replaces the TPU kernels speech2affective_gestures_tpu/ops/gru_pallas.py
// ::_fwd_kernel_v2 (pallas_call in _fwd_call_v2) and ::_fwd_kernel (v1,
// pallas_call in _fwd_call). Torch GRU cell, gates ordered (r, z, n):
//   hp = h . W_hh + b_hh
//   r  = sigmoid(xp_r + b_ih_r + hp_r)
//   z  = sigmoid(xp_z + b_ih_z + hp_z)
//   n  = tanh(xp_n + b_ih_n + r * hp_n)
//   h' = (1 - z) * n + z * h
// The input projection xp = x . W_ih arrives precomputed (one large product
// outside the kernel, as in the JAX package).
//
// Two layouts of the same cell, chosen by the template parameter WALK (all
// row-major, contiguous):
//   model layout (WALK = false, `s2ag_gru_layer_fwd`, the layers' engine):
//     xp (T, B, D*3H) no bias, no time flip; ys (T, B, D*H) both directions
//     in forward time order (the reverse direction walks time backwards);
//     h_last (D, B, H)
//   walk layout (WALK = true, `s2ag_gru_layer_fwd_v1`, `run_layer`'s
//     contract): xp (T, D, B, 3H) with b_ih already added and direction 1
//     already time-reversed by the caller; ys (T, D, B, H) in each
//     direction's walk order; step s reads and writes row s
//   w_hh (D, H, 3H) = torch weight_hh_l{k}[_reverse] transposed
//   b_ih (D, 3H) or null (zero), b_hh (D, 3H)
//   hp (optional, null for none, always float32): h_prev . W_hh + b_hh of
//     every step, laid out as xp, written when a gradient will be taken so
//     that the backward (csrc/gru_bwd.cu) need not recompute it; the lane
//     that holds a row's totals writes them, and ys is the same bits with or
//     without it.
// Storage: float32 or bf16 (the template parameter V, the same for xp,
// w_hh, the biases, ys and h_last). The cell computes
//   r = sigmoid(round(xp_r + b_ih_r) + (hp_r + b_hh_r)), likewise z,
//   n = tanh(round(xp_n + b_ih_n) + r (hp_n + b_hh_n)),
//   h' = round((1 - z) n + z h),
// with round() the identity in float32 and a rounding to bf16 in bf16: the
// TPU kernel's `xp_ref + ball_ref` (bf16 + bf16) and its carry scratch of
// xp's dtype (gru_pallas.py:348, :352-354, :379). The wrapper hands the bf16
// instance the TPU kernel's bias fold (`gru_cuda.kernel_biases`: b_ih_r +
// b_hh_r, b_ih_z + b_hh_z, b_ih_n in bf16 as b_ih; 0, 0, b_hh_n as b_hh),
// so hp_r and hp_z take no bias there. hp stays float32. In the register
// and L2 tiers h stays float in shared memory (holding the rounded value);
// the bf16 instance's tensor tier (below) keeps it bf16.
//
// Design. On the TPU, W_hh stays in VMEM for the whole time loop. Here W_hh
// (1.08 MB per direction at H 300) is ~5x one SM's shared memory, so it is
// spread over a thread-block cluster of C blocks, one cluster per (batch
// tile of BT rows, direction), and stays on chip for the whole launch:
// block c owns hidden units [cU, (c+1)U) (U = ceil(H / C) rounded up to 4)
// and holds those units' three gate columns of W_hh (H x 3U floats, 154 KB
// at H 300, C 8, U 40) in its threads' registers (an SM has 256 KB of
// them), not in its shared memory: a register operand costs no
// shared-memory bandwidth, whereas W read from shared memory would feed
// only the few batch rows a thread holds per read, and shared memory, not
// FMA issue, would bound the product. W is read from device memory once
// per launch, in a prologue, straight from the (D, H, 3H) layout.
//
// A thread owns one unit and one chunk of KC consecutive k (S chunks cover
// H; the S lanes of a unit are neighbours in a warp). It keeps
// W[k][r|z|n][unit] for its chunk in 3 KC registers. Each step it walks the
// tile's rows in groups of S: for each row it reads its chunk of h (float4
// broadcasts from shared memory, chunks padded to KC + 4 floats so that the
// S reads of a warp meet no bank conflict) and accumulates its chunk sums
// of hp_r, hp_z and hp_n in ascending k (plain float32 fmaf, no TF32). A
// reduce-scatter of warp shuffles then adds the S chunk sums of the
// group's rows so that lane s holds the totals of row g + s, in a fixed
// order (deterministic). That lane applies the gate update in registers,
// with the row's xp read from device memory at the start of the group
// (the product hides the latency), and writes ys and h_last. The new h
// goes into the next h buffer of every block of the cluster through
// distributed shared memory, four units of a row per float4 store; h is
// double-buffered (h_buf[step % 2]), so one cluster barrier per step is
// enough: a block writes buffer (s+1) % 2 only after every block has left
// step s-1, which read it. The barrier after the last step keeps every
// block alive until no peer can still write into its shared memory. Units
// past H hold zero W and zero h; the ragged last unit slice and the ragged
// last batch tile are masked.
//
// Past H 320 W_hh no longer fits in the registers of a cluster of 8 (3 H^2
// floats a direction against 8 x 256 KB), and the L2 tier takes over
// (KC == 0 in the template, gru_cluster.cuh): the same cluster, the same h
// exchange and the same sums in the same order, but each thread reads its
// chunk of W from device memory (1/C of W_hh a block, which stays in the
// 50 MB L2) once per group of S rows, and the block walks its U units in
// passes of threads / S. Any H whose two h rows fit in a block's shared
// memory runs.
//
// The bf16 instance at H <= 320 has a third tier, the tensor tier
// (`gru_layer_fwd_tc_kernel`), which the plan takes at bf16 in the register
// range. Its product is the TPU kernel's own, `jnp.dot(h, W)` of bf16 h and
// W with float32 accumulation (gru_pallas.py:347), on the tensor cores
// (mma.sync m16n8k16: 989 TFLOP/s bf16 on the H100 against 67 for float32
// FMA, which took 78% of the register tier's step). The same cluster and
// exchange; U a multiple of 8 (C 8, U 40 at H 300); each warp holds the
// B fragments of W_hh for 8 units' r, z and n columns in registers (6 KT
// registers a lane, 114 at H 300), h is bf16 in shared memory (k padded
// to 16 KT, rows to 16), read by ldmatrix, and the accumulator layout
// hands each lane the three gates of the same four (row, unit) positions,
// so the gate update needs no shuffle; the exchange stores 16 bytes (8
// units of a row) at a time, half the float tiers' bytes. mma.sync, not
// wgmma: the 34-step chain of products, gates and barriers, not the
// tensor-core rate, sets the pace, and batch tiles are rarely the 64 rows
// wgmma takes.
//
// The launch plan (tier, S, KC, C, U, BT, the threads and the shared-memory
// bytes) is the caller's (`gru_cuda.fwd_plan`), its only owner; the launch
// refuses a plan that would leave a unit, a chunk of k or a row of h
// outside what it gives, and a plan the card cannot schedule returns a CUDA
// error. Nothing falls back.
//
// Bound on the H100: 2 T B D H 3H FLOP of the products, 0.283 ms at T 34,
// B 512, H 300, D 2 against the 67 TFLOP/s float32 rate; the bytes at B 1
// (xp and ys once, W_hh once). At B 512, H 300 the 14 clusters of 8 blocks
// (74 rows each) run in one wave; a block's step is 74 x 120 x 320 FMA from
// registers (the padding to 40 units and 8 x 40 k included), the exchange
// and the barrier. The busiest of an SM's four schedulers runs 3 of the
// block's 10 warps; the float4 reads of h and the shuffles share its issue
// with the FMAs (PERF.md has the measured split). At B 1 a step is one
// row's chunk products, the shuffles, the gate's latency and the barrier.

#include <type_traits>

#include "gru_cluster.cuh"

#ifdef S2AG_FWD_PHASES
// Built so only by speech2affective_gestures_torch/tools/gru_fwd_phases.py:
// clock64() probes of a step's phases (product, gate, exchange, barrier,
// the whole step), summed over the steps by thread 0 of block (0, 0).
__device__ long long s2ag_phase_cycles[5];
extern "C" int s2ag_phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, s2ag_phase_cycles, sizeof(long long) * 5);
}
#define PHASE_AT(v) const long long v = clock64()
#define PHASE_ADD(i, from, to) phase[i] += (to) - (from)
#else
#define PHASE_AT(v)
#define PHASE_ADD(i, from, to)
#endif

namespace {

// threads a forward block may have for a chunk of KC in the register tier
// (`gru_cuda._max_threads` plans with the same table): the 3 KC registers
// of W and ~40 others per thread within the SM's 65,536; the L2 tier
// (KC == 0) holds no W in registers
__host__ __device__ constexpr int max_threads(int KC) {
  return KC == 0 ? 512 : KC >= 40 ? 320 : KC >= 32 ? 384 : 512;
}

// the forward's register-tier (S, KC) instances: S = 2 up to H 80, 4 up to
// 160, 8 up to 320; KC = ceil(H / S) rounded up to 8. The L2 tier: S = 8.
#define S2AG_GRU_REG_INSTANCES                                                 \
  S2AG_GRU(2, 8) S2AG_GRU(2, 16) S2AG_GRU(2, 24) S2AG_GRU(2, 32) S2AG_GRU(2, 40) \
  S2AG_GRU(4, 24) S2AG_GRU(4, 32) S2AG_GRU(4, 40)                              \
  S2AG_GRU(8, 24) S2AG_GRU(8, 32) S2AG_GRU(8, 40)
// What the forward's indexing needs of a plan: every k in a chunk, every
// unit in a block (U whole float4s), the register tier's units in one pass
// of whole warps, the L2 tier's passes of a multiple of 4 units; smem the
// caller's check.
inline bool plan_ok(int S, int KC, int kc, int H, int C, int U, int threads) {
  const int chunk = KC == 0 ? kc : KC;
  if (chunk < 4 || chunk % 4 || S * chunk < H || (long long)C * U < H || U % 4 ||
      threads % 32)
    return false;
  return KC == 0 ? threads % (4 * S) == 0 && threads <= max_threads(0)
                 : threads >= U * S && threads <= max_threads(KC);
}

// This lane's chunk sums (hp_r, hp_z, hp_n over its KC rows of W, in
// ascending k) of one row of h; h is the row's chunk.
template <int KC>
__device__ __forceinline__ void chunk_sums(const float* h, const float (&wr)[KC],
                                           const float (&wz)[KC], const float (&wn)[KC],
                                           float (&acc)[3]) {
  const float4* hq = reinterpret_cast<const float4*>(h);
  acc[0] = acc[1] = acc[2] = 0.0f;
#pragma unroll
  for (int q = 0; q < KC / 4; ++q) {
    const float4 hv = hq[q];
    const float x[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0] = fmaf(x[e], wr[4 * q + e], acc[0]);
      acc[1] = fmaf(x[e], wz[4 * q + e], acc[1]);
      acc[2] = fmaf(x[e], wn[4 * q + e], acc[2]);
    }
  }
}

// The totals of the group's rows: lane s ends with those of row g0 + s in
// tot, by `group_totals`' reduce-scatter (gru_cluster.cuh) written out for
// the three gates' chunk sums from registers (the register tier's product,
// kept as PR 4 tuned it).
template <int S, int KC>
__device__ __forceinline__ void reg_group_totals(const float* hg, int rows, int s,
                                             const float (&wr)[KC], const float (&wz)[KC],
                                             const float (&wn)[KC], float (&tot)[3]) {
  constexpr int RS = S * (KC + 4);
  if (rows == 1) {
    chunk_sums<KC>(hg, wr, wz, wn, tot);
#pragma unroll
    for (int off = 1; off < S; off <<= 1)
#pragma unroll
      for (int g = 0; g < 3; ++g) tot[g] += __shfl_xor_sync(0xffffffffu, tot[g], off);
    return;
  }
  constexpr int M = S / 2;
  float v[M][3];
  const bool upper = s & M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
    if (i < rows) chunk_sums<KC>(hg + i * RS, wr, wz, wn, lo);  // uniform branches
    if (i + M < rows) chunk_sums<KC>(hg + (i + M) * RS, wr, wz, wn, hi);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      v[i][g] = (upper ? hi[g] : lo[g]) + __shfl_xor_sync(0xffffffffu, upper ? lo[g] : hi[g], M);
  }
#pragma unroll
  for (int half = M / 2; half >= 1; half /= 2) {
    const bool up = s & half;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float keep = up ? v[i + half][g] : v[i][g];
        const float send = up ? v[i][g] : v[i + half][g];
        v[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, half);
      }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) tot[g] = v[0][g];
}

// The register tier. HP: write hp (a separate instance, so that the
// forward without it is the same code as before hp existed).
template <typename V, int S, int KC, bool WALK, bool HP>
__global__ void __launch_bounds__(max_threads(KC), 1) gru_layer_fwd_kernel(
    const V* __restrict__ xp, const V* __restrict__ w_hh,
    const V* __restrict__ b_ih, const V* __restrict__ b_hh,
    V* __restrict__ ys, V* __restrict__ h_last, float* __restrict__ hp_out,
    int T, int B, int H, int D, int U, int BT) {
  constexpr int KS = KC + 4;   // a chunk's stride in h: KS / 4 odd, so the
  constexpr int RS = S * KS;   // S float4 reads of a warp hit distinct banks
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  float* h_s = smem;  // [2][BT][S][KS]

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int nrows = min(BT, B - b0);
  const int H3 = 3 * H;
  const int u0 = c * U;
  const int s = threadIdx.x % S;   // the thread's chunk of k
  const int ul = threadIdx.x / S;  // the thread's unit in the block
  const int j = u0 + ul;           // the thread's hidden unit
  const bool active = ul < U && j < H;
  const int hpos = (j / KC) * KS + j % KC;  // h[.][j] in a row

  // prologue: the W chunk into registers, read once; h = 0
  float wr[KC], wz[KC], wn[KC];
  {
    const V* W = w_hh + (size_t)d * H * H3 + j;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int k = s * KC + i;
      const bool ok = active && k < H;
      wr[i] = ok ? ld(W + (size_t)k * H3) : 0.0f;
      wz[i] = ok ? ld(W + (size_t)k * H3 + H) : 0.0f;
      wn[i] = ok ? ld(W + (size_t)k * H3 + 2 * H) : 0.0f;
    }
  }
  float bhr = 0.0f, bhz = 0.0f, bhn = 0.0f, bir = 0.0f, biz = 0.0f, bin = 0.0f;
  if (active) {
    const V* bh = b_hh + (size_t)d * H3;
    bhr = ld(bh + j);
    bhz = ld(bh + H + j);
    bhn = ld(bh + 2 * H + j);
    if (b_ih != nullptr) {
      const V* bi = b_ih + (size_t)d * H3;
      bir = ld(bi + j);
      biz = ld(bi + H + j);
      bin = ld(bi + 2 * H + j);
    }
  }
  for (int i = threadIdx.x; i < 2 * BT * RS / 4; i += blockDim.x)
    reinterpret_cast<float4*>(h_s)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // The exchange packs 4 units of one row into a float4: of the warp's S
  // rows x UW units, lane f + 8p gathers float4 f (row f % S, units 4 (f / S)
  // .. + 3 of the warp's) and stores it into peers p, p + 4, ...
  constexpr int UW = 32 / S;
  const int lane = threadIdx.x & 31;
  const int xrow = (lane & 7) % S;                               // its row in the group
  const int xu = (threadIdx.x >> 5) * UW + 4 * ((lane & 7) / S);  // its first unit
  const int xsrc = 4 * ((lane & 7) / S) * S + xrow;             // lane of (row, unit xu)
  const bool xmine = xu < U && u0 + xu < H;
  const int xpos = ((u0 + xu) / KC) * KS + (u0 + xu) % KC;
  cluster.sync();  // every block has started and cleared its h
#ifdef S2AG_FWD_PHASES
  long long phase[5] = {0, 0, 0, 0, 0};
#endif

  for (int step = 0; step < T; ++step) {
    PHASE_AT(q_step);
    const int t = (d == 0) ? step : T - 1 - step;
    const float* hc = h_s + (step & 1) * BT * RS;
    float* hn_buf = h_s + ((step + 1) & 1) * BT * RS;
    for (int g0 = 0; g0 < nrows; g0 += S) {
      // the lane's row g0 + s: its xp, loaded before the product hides it
      const int row = g0 + s;
      const bool mine = active && row < nrows;
      float xr = 0.0f, xz = 0.0f, xn = 0.0f;
      if (mine) {
        const V* x = xp + row_offset<WALK>(t, step, d, b0 + row, B, D, H3) + j;
        xr = ld(x);
        xz = ld(x + H);
        xn = ld(x + 2 * H);
      }
      PHASE_AT(q_product);
      float hp[3];  // the totals of row g0 + s
      reg_group_totals<S, KC>(hc + g0 * RS + s * KS, min(S, nrows - g0), s, wr, wz, wn, hp);
      PHASE_AT(q_gate);
      PHASE_ADD(0, q_product, q_gate);
      float hnew = 0.0f;  // 0 past H, where h must stay 0
      if (mine) {
        const float r = sigmoid_f(rounded<V>(xr + bir) + (hp[0] + bhr));
        const float z = sigmoid_f(rounded<V>(xz + biz) + (hp[1] + bhz));
        const float n = tanhf(rounded<V>(xn + bin) + r * (hp[2] + bhn));
        hnew = rounded<V>((1.0f - z) * n + z * hc[row * RS + hpos]);
        ys[row_offset<WALK>(t, step, d, b0 + row, B, D, H) + j] = narrow<V>(hnew);
        if (h_last != nullptr && step == T - 1)
          h_last[((size_t)d * B + b0 + row) * H + j] = narrow<V>(hnew);
        if constexpr (HP) {
          float* o = hp_out + row_offset<WALK>(t, step, d, b0 + row, B, D, H3) + j;
          o[0] = hp[0] + bhr;
          o[H] = hp[1] + bhz;
          o[2 * H] = hp[2] + bhn;
        }
      }
      PHASE_AT(q_exchange);
      PHASE_ADD(1, q_gate, q_exchange);
      // h' into every block's next buffer, this block's included
      float4 v;
      v.x = __shfl_sync(0xffffffffu, hnew, xsrc);
      v.y = __shfl_sync(0xffffffffu, hnew, xsrc + S);
      v.z = __shfl_sync(0xffffffffu, hnew, xsrc + 2 * S);
      v.w = __shfl_sync(0xffffffffu, hnew, xsrc + 3 * S);
      if (xmine && g0 + xrow < nrows) {
        float* dst = hn_buf + (g0 + xrow) * RS + xpos;
        for (int peer = lane >> 3; peer < C; peer += 4)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, peer)) = v;
      }
      PHASE_AT(q_exchanged);
      PHASE_ADD(2, q_exchange, q_exchanged);
    }
    PHASE_AT(q_barrier);
    if (C == 1)  // a block alone: the block barrier is enough, and cheaper
      __syncthreads();
    else
      cluster.sync();
    PHASE_AT(q_end);
    PHASE_ADD(3, q_barrier, q_end);
    PHASE_ADD(4, q_step, q_end);
  }
#ifdef S2AG_FWD_PHASES
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = 0; i < 5; ++i) s2ag_phase_cycles[i] = phase[i];
#endif
}

// The L2 tier's chunk sums of the group's `rows` rows (hg: row 0's chunk,
// rows RS apart), in the register tier's order: each W value (W: this
// unit's column of gate r at k = k0, null when the lane has no unit) read
// once per group, each row's sums in ascending k.
template <int S, typename V>
__device__ __forceinline__ void chunk_sums_l2(const float* hg, int rows, int RS,
                                              const V* W, int k0, int kc, int H,
                                              float (&acc)[S][3]) {
  const int H3 = 3 * H;
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
  for (int q = 0; q < kc; q += 4) {
    float w[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = W != nullptr && k0 + q + e < H;
      const V* wk = W + (size_t)(q + e) * H3;
#pragma unroll
      for (int g = 0; g < 3; ++g) w[g][e] = ok ? ld(wk + g * H) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i >= rows) break;  // uniform
      const float4 hv = *reinterpret_cast<const float4*>(hg + i * RS + q);
      const float x[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[i][g] = fmaf(x[e], w[g][e], acc[i][g]);
    }
  }
}

// b_hh (r, z, n) then b_ih (r, z, n) of unit j, zeros when not `active`;
// b_ih zero when null
template <typename V>
__device__ __forceinline__ void load_biases(const V* b_ih, const V* b_hh, int d, int H,
                                            int j, bool active, float (&bias)[6]) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bias[g] = active ? ld(b_hh + (size_t)d * 3 * H + g * H + j) : 0.0f;
    bias[3 + g] =
        active && b_ih != nullptr ? ld(b_ih + (size_t)d * 3 * H + g * H + j) : 0.0f;
  }
}

// The L2 tier (H > 320): the register tier's cluster, h exchange and sums
// in the same order, but each thread reads its chunk of W from device
// memory once per group of S rows (a block's slice, 1/C of W_hh, stays in
// L2) and the block walks its U units in passes of threads / S.
template <typename V, bool WALK>
__global__ void __launch_bounds__(max_threads(0), 1) gru_layer_fwd_l2_kernel(
    const V* __restrict__ xp, const V* __restrict__ w_hh,
    const V* __restrict__ b_ih, const V* __restrict__ b_hh,
    V* __restrict__ ys, V* __restrict__ h_last, float* __restrict__ hp_out,
    int T, int B, int H, int D, int U, int BT, int kc) {
  constexpr int S = L2_S;
  const int KS = kc + 4;  // a chunk's stride in h, as the register tier's
  const int RS = S * KS;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  float* h_s = smem;  // [2][BT][S][KS]

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int nrows = min(BT, B - b0);
  const int H3 = 3 * H;
  const int u0 = c * U;
  const int s = threadIdx.x % S;   // the thread's chunk of k
  const int ul = threadIdx.x / S;  // the thread's unit in the block's pass
  const int UP = (int)blockDim.x / S;  // units a pass
  const int npass = (U + UP - 1) / UP;
  for (int i = threadIdx.x; i < 2 * BT * RS / 4; i += blockDim.x)
    reinterpret_cast<float4*>(h_s)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the register tier's exchange (S = 8: lane f + 8p gathers float4 f, row
  // f, four units of the warp's, and stores it into peers p, p + 4, ...)
  constexpr int UW = 32 / S;
  const int lane = threadIdx.x & 31;
  const int xrow = (lane & 7) % S;
  const int xul = (threadIdx.x >> 5) * UW + 4 * ((lane & 7) / S);
  const int xsrc = 4 * ((lane & 7) / S) * S + xrow;
  cluster.sync();  // every block has started and cleared its h

  for (int step = 0; step < T; ++step) {
    const int t = (d == 0) ? step : T - 1 - step;
    const float* hc = h_s + (step & 1) * BT * RS;
    float* hn_buf = h_s + ((step + 1) & 1) * BT * RS;
    for (int g0 = 0; g0 < nrows; g0 += S) {
      const int rows = min(S, nrows - g0);
      for (int pass = 0; pass < npass; ++pass) {
        const int uj = pass * UP + ul;  // the thread's unit in the block
        const int j = u0 + uj;
        const bool active = uj < U && j < H;
        const int row = g0 + s;
        const bool mine = active && row < nrows;
        float xr = 0.0f, xz = 0.0f, xn = 0.0f, bias[6];
        if (mine) {
          const V* x = xp + row_offset<WALK>(t, step, d, b0 + row, B, D, H3) + j;
          xr = ld(x);
          xz = ld(x + H);
          xn = ld(x + 2 * H);
        }
        load_biases<V>(b_ih, b_hh, d, H, j, active, bias);
        float acc[S][3], hp[3];
        chunk_sums_l2<S>(hc + g0 * RS + s * KS, rows, RS,
                         active ? w_hh + ((size_t)d * H + s * kc) * H3 + j : nullptr,
                         s * kc, kc, H, acc);
        group_totals_of<S, 3>(acc, rows, s, hp);
        float hnew = 0.0f;  // 0 past H, where h must stay 0
        if (mine) {
          const float hpr = hp[0] + bias[0], hpz = hp[1] + bias[1], hpn = hp[2] + bias[2];
          const float r = sigmoid_f(rounded<V>(xr + bias[3]) + hpr);
          const float z = sigmoid_f(rounded<V>(xz + bias[4]) + hpz);
          const float n = tanhf(rounded<V>(xn + bias[5]) + r * hpn);
          hnew = rounded<V>((1.0f - z) * n + z * hc[row * RS + (j / kc) * KS + j % kc]);
          ys[row_offset<WALK>(t, step, d, b0 + row, B, D, H) + j] = narrow<V>(hnew);
          if (h_last != nullptr && step == T - 1)
            h_last[((size_t)d * B + b0 + row) * H + j] = narrow<V>(hnew);
          if (hp_out != nullptr) {
            float* o = hp_out + row_offset<WALK>(t, step, d, b0 + row, B, D, H3) + j;
            o[0] = hpr;
            o[H] = hpz;
            o[2 * H] = hpn;
          }
        }
        float4 v;
        v.x = __shfl_sync(0xffffffffu, hnew, xsrc);
        v.y = __shfl_sync(0xffffffffu, hnew, xsrc + S);
        v.z = __shfl_sync(0xffffffffu, hnew, xsrc + 2 * S);
        v.w = __shfl_sync(0xffffffffu, hnew, xsrc + 3 * S);
        const int xu = u0 + pass * UP + xul;
        if (xu - u0 < U && xu < H && g0 + xrow < nrows) {
          float* dst = hn_buf + (g0 + xrow) * RS + (xu / kc) * KS + xu % kc;
          for (int peer = lane >> 3; peer < C; peer += 4)
            *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, peer)) = v;
        }
      }
    }
    if (C == 1)
      __syncthreads();
    else
      cluster.sync();
  }
}

// The tensor tier: its instances' k16 steps (k padded with zeros to 16 KT
// >= H; `gru_cuda.TENSOR_KT`), a block's most threads (8 warps) and the m16
// tiles a warp takes at once. One block an SM: at H 300 a thread holds 114
// registers of W_hh and uses all 255; bounded to two blocks an SM (204) it
// spilled and ran 20% slower on the H100.
#define S2AG_GRU_TC_INSTANCES \
  S2AG_TC(2) S2AG_TC(3) S2AG_TC(4) S2AG_TC(5) S2AG_TC(8) S2AG_TC(12) S2AG_TC(16) S2AG_TC(19) S2AG_TC(20)
constexpr int TC_THREADS = 256;
constexpr int TC_MT = 2;
// What the tensor tier's indexing needs of a plan: k padded to KC >= H
// (KC the instance's 16 KT), whole groups of 8 units covering H, S warps a
// group.
inline bool tc_plan_ok(int S, int KC, int H, int C, int U, int threads) {
  return KC >= H && U > 0 && U % 8 == 0 && (long long)C * U >= H &&
         threads == 32 * (U / 8) * S && threads <= TC_THREADS;
}

// The warp's product for one or two m16 tiles of h (a: lane's ldmatrix row
// address in the first tile, KS the row stride), all three gates, over the
// KT k16 steps: acc[i][gate] the (16 x 8) tile of tile i. PAIR false: one
// tile, its even and odd k steps summed in acc[0] and acc[1] (two chains
// of half the length, added at the end), since alone its chain of KT
// dependent products would set the step's latency.
template <int KT, bool PAIR>
__device__ __forceinline__ void tc_product(const bf16_t* a, int KS,
                                           const unsigned (&w)[3][KT][2],
                                           float (&acc)[TC_MT][3][4]) {
#pragma unroll
  for (int i = 0; i < TC_MT; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    unsigned a0[4];
    ldmatrix_x4<false>(a0, a + 16 * ks);
    if constexpr (PAIR) {
      unsigned a1[4];
      ldmatrix_x4<false>(a1, a + 16 * KS + 16 * ks);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        mma_bf16(acc[0][g], a0, w[g][ks][0], w[g][ks][1]);
        mma_bf16(acc[1][g], a1, w[g][ks][0], w[g][ks][1]);
      }
    } else {
#pragma unroll
      for (int g = 0; g < 3; ++g) mma_bf16(acc[ks & 1][g], a0, w[g][ks][0], w[g][ks][1]);
    }
  }
  if constexpr (!PAIR) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][g][e] += acc[1][g][e];
  }
}

// The tensor tier (bf16, H <= 16 KT <= 320). The register tier's cluster,
// one per (batch tile, direction), block c owning units [cU, (c+1)U) with U
// a multiple of 8; h' into every block's next h buffer through distributed
// shared memory, one cluster barrier a step. What differs is the product:
// hp = h . W_hh on the tensor cores. h is bf16 in shared memory ([2][BTP]
// [KS] values: BTP the tile's rows rounded up to 16, rows past the tile and
// k past H zero; KS = 16 KT + 8, so that KS / 8 is odd and the 8 row
// addresses of an ldmatrix hit distinct banks). Warp w owns unit group grp
// = w % G (G = U / 8): it holds, for its 8 units, the B fragments of W_hh's
// r, z and n columns over every k16 step in registers (6 KT a lane, read
// once), and walks the tile's m16 tiles w / G, w / G + WM, ... (WM = warps
// / G) two at a time. The m16n8 accumulators of the three gates give lane
// (g, c) the same four (row, unit) positions (rows g, g + 8 of the m16
// tile, units 2c, 2c + 1 of the group): it applies the gate update there in
// registers (xp read before the product), writes ys, h_last and hp, and
// the quad of lanes g gathers its row's 8 new h values (16 bytes) to store
// them into the peers' next buffers (lane c into peers c, c + 4).
template <bool WALK, int KT>
__global__ void __launch_bounds__(TC_THREADS, 1) gru_layer_fwd_tc_kernel(
    const bf16_t* __restrict__ xp, const bf16_t* __restrict__ w_hh,
    const bf16_t* __restrict__ b_ih, const bf16_t* __restrict__ b_hh,
    bf16_t* __restrict__ ys, bf16_t* __restrict__ h_last, float* __restrict__ hp_out,
    int T, int B, int H, int D, int U, int BT) {
  constexpr int KP = 16 * KT;
  constexpr int KS = KP + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16_t* h_s = reinterpret_cast<bf16_t*>(tc_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int BTP = (BT + 15) / 16 * 16;

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int nrows = min(BT, B - b0);
  const int n_mt = (nrows + 15) / 16;
  const int H3 = 3 * H;
  const int G = U / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % G, WM = (int)blockDim.x / 32 / G;
  const int qg = lane / 4, qc = lane % 4;
  const int ju = c * U + 8 * grp;  // the group's first unit
  const int j = ju + 2 * qc;       // this lane's units j, j + 1

  // prologue: the B fragments of W_hh (column ju + qg of each gate), read
  // once; h = 0
  unsigned w[3][KT][2];
  {
    const int col = ju + qg;
    const bf16_t* W = w_hh + (size_t)d * H * H3 + col;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int ks = 0; ks < KT; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 16 * ks + 8 * half + 2 * qc;
          const unsigned short lo =
              col < H && k < H ? bits_of(W + (size_t)k * H3 + g * H) : 0;
          const unsigned short hi =
              col < H && k + 1 < H ? bits_of(W + (size_t)(k + 1) * H3 + g * H) : 0;
          w[g][ks][half] = pack2(lo, hi);
        }
  }
  float bh[3][2], bi[3][2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const bool ok = j + e < H;
      bh[g][e] = ok ? ld(b_hh + (size_t)d * H3 + g * H + j + e) : 0.0f;
      bi[g][e] = ok && b_ih != nullptr ? ld(b_ih + (size_t)d * H3 + g * H + j + e) : 0.0f;
    }
  for (int i = threadIdx.x; i < 2 * BTP * KS / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  // this lane's ldmatrix row in an m16 tile: rows lane % 8 (+ 8 for
  // matrices 1 and 3), k + 8 for matrices 2 and 3
  const int a_off = ((lane % 8) + 8 * ((lane / 8) % 2)) * KS + 8 * (lane / 16);
  cluster.sync();  // every block has started and cleared its h

  for (int step = 0; step < T; ++step) {
    const int t = (d == 0) ? step : T - 1 - step;
    const bf16_t* hc = h_s + (step & 1) * BTP * KS;
    bf16_t* hn = h_s + ((step + 1) & 1) * BTP * KS;
    for (int mt0 = (warp / G) * TC_MT; mt0 < n_mt; mt0 += WM * TC_MT) {
      const bool pair = mt0 + 1 < n_mt;  // uniform in the warp
      // xp at this lane's positions, [tile][row half][gate], units j, j + 1
      unsigned xv[TC_MT][2][3];
#pragma unroll
      for (int i = 0; i < TC_MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (mt0 + i) + qg + 8 * h;
          const bool ok = row < nrows;
          const bf16_t* x = xp + (ok ? row_offset<WALK>(t, step, d, b0 + row, B, D, H3) : 0);
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xv[i][h][g] = pack2(ok && j < H ? bits_of(x + g * H + j) : 0,
                                ok && j + 1 < H ? bits_of(x + g * H + j + 1) : 0);
        }
      float acc[TC_MT][3][4];
      if (pair)
        tc_product<KT, true>(hc + 16 * mt0 * KS + a_off, KS, w, acc);
      else
        tc_product<KT, false>(hc + 16 * mt0 * KS + a_off, KS, w, acc);
#pragma unroll
      for (int i = 0; i < TC_MT; ++i) {
        if (i > 0 && !pair) break;  // uniform
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (mt0 + i) + qg + 8 * h;
          unsigned short hb[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float hnew = 0.0f;  // 0 past H, where h must stay 0
            if (row < nrows && j + e < H) {
              const float hpr = acc[i][0][2 * h + e] + bh[0][e];
              const float hpz = acc[i][1][2 * h + e] + bh[1][e];
              const float hpn = acc[i][2][2 * h + e] + bh[2][e];
              const float xr = from_bits((unsigned short)(xv[i][h][0] >> (16 * e)));
              const float xz = from_bits((unsigned short)(xv[i][h][1] >> (16 * e)));
              const float xn = from_bits((unsigned short)(xv[i][h][2] >> (16 * e)));
              const float r = sigmoid_f(rounded<bf16_t>(xr + bi[0][e]) + hpr);
              const float z = sigmoid_f(rounded<bf16_t>(xz + bi[1][e]) + hpz);
              const float n = tanhf(rounded<bf16_t>(xn + bi[2][e]) + r * hpn);
              hnew = rounded<bf16_t>((1.0f - z) * n + z * widen(hc[row * KS + j + e]));
              ys[row_offset<WALK>(t, step, d, b0 + row, B, D, H) + j + e] = narrow<bf16_t>(hnew);
              if (h_last != nullptr && step == T - 1)
                h_last[((size_t)d * B + b0 + row) * H + j + e] = narrow<bf16_t>(hnew);
              if (hp_out != nullptr) {
                float* o = hp_out + row_offset<WALK>(t, step, d, b0 + row, B, D, H3) + j + e;
                o[0] = hpr;
                o[H] = hpz;
                o[2 * H] = hpn;
              }
            }
            hb[e] = __bfloat16_as_ushort(narrow<bf16_t>(hnew));
          }
          const unsigned mine = pack2(hb[0], hb[1]);
          // the row's 8 units of the group, gathered from the quad
          uint4 v;
          v.x = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 0);
          v.y = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 1);
          v.z = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 2);
          v.w = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 3);
          if (row < nrows && ju < KP) {
            bf16_t* dst = hn + row * KS + ju;
            for (int peer = qc; peer < C; peer += 4)
              *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, peer)) = v;
          }
        }
      }
    }
    if (C == 1)
      __syncthreads();
    else
      cluster.sync();
  }
}

// tier 0: the register instance (S, KC), with or without hp; tier 1: the
// L2 tier (S = L2_S); tier 2: the tensor tier (bf16; KC = 16 KT, S = WM
// warps a unit group). Each refuses a plan its indexing cannot take: every
// k in a chunk, every unit in a block (U whole float4s; the tensor tier
// whole groups of 8), every unit's S lanes in whole warps (the tensor
// tier: G WM warps), both h buffers of BT rows of S chunks of KC + 4 floats
// (the tensor tier: BT rounded up to 16 rows of KC + 8 bf16 values).
template <typename V, bool WALK>
int launch(const void* xp_, const void* w_hh_, const void* b_ih_, const void* b_hh_,
           void* ys_, void* h_last_, float* hp, int T, int B, int H, int D, int C, int BT,
           int S, int KC, int U, int threads, int smem, int tier, void* stream) {
  const V* xp = static_cast<const V*>(xp_);
  const V* w_hh = static_cast<const V*>(w_hh_);
  const V* b_ih = static_cast<const V*>(b_ih_);
  const V* b_hh = static_cast<const V*>(b_hh_);
  V* ys = static_cast<V*>(ys_);
  V* h_last = static_cast<V*>(h_last_);
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || C < 1 || BT < 1 || S < 1 ||
      smem < (tier == 2 ? 2 * 2 * ((BT + 15) / 16 * 16) * (KC + 8)
                        : 4 * 2 * BT * S * (KC + 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ClusterLaunch launch(C, dim3(C * ((B + BT - 1) / BT), D), threads, smem, st);
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (std::is_same_v<V, bf16_t>) {
#define S2AG_TC(KK)                                                                      \
  if (tier == 2 && KC == 16 * KK && tc_plan_ok(S, KC, H, C, U, threads)) {               \
    auto kernel = gru_layer_fwd_tc_kernel<WALK, KK>;                                     \
    err = check_config(kernel, launch);                                                  \
    if (err == cudaSuccess)                                                              \
      err = cudaLaunchKernelEx(&launch.cfg, kernel, xp, w_hh, b_ih, b_hh, ys, h_last, hp, \
                               T, B, H, D, U, BT);                                        \
  }
    S2AG_GRU_TC_INSTANCES
#undef S2AG_TC
  }
  if (tier == 1 && S == L2_S && plan_ok(S, 0, KC, H, C, U, threads)) {
    auto kernel = gru_layer_fwd_l2_kernel<V, WALK>;
    err = check_config(kernel, launch);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&launch.cfg, kernel, xp, w_hh, b_ih, b_hh, ys, h_last, hp, T, B,
                               H, D, U, BT, KC);
  }
#define S2AG_FWD_HP(SS, KK, HH)                                                           \
  {                                                                                      \
    auto kernel = gru_layer_fwd_kernel<V, SS, KK, WALK, HH>;                             \
    err = check_config(kernel, launch);                                                  \
    if (err == cudaSuccess)                                                              \
      err = cudaLaunchKernelEx(&launch.cfg, kernel, xp, w_hh, b_ih, b_hh, ys, h_last, hp, \
                               T, B, H, D, U, BT);                                        \
  }
#define S2AG_GRU(SS, KK)                                                                 \
  if (tier == 0 && S == SS && KC == KK && plan_ok(S, KC, KC, H, C, U, threads)) {        \
    if (hp != nullptr)                                                                   \
      S2AG_FWD_HP(SS, KK, true)                                                          \
    else                                                                                 \
      S2AG_FWD_HP(SS, KK, false)                                                         \
  }
  S2AG_GRU_REG_INSTANCES
#undef S2AG_GRU
#undef S2AG_FWD_HP
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The model layout. b_ih and hp may be null. (C, BT, S, KC, U, threads,
// smem, tier) is the caller's launch plan; bf16 != 0 takes the bf16
// instance (xp, w_hh, the biases, ys and h_last bf16; hp float32). Returns
// the CUDA error code of the launch (0 = success).
extern "C" int s2ag_gru_layer_fwd(const void* xp, const void* w_hh, const void* b_ih,
                                  const void* b_hh, void* ys, void* h_last, float* hp,
                                  int T, int B, int H, int D, int C, int BT, int S, int KC,
                                  int U, int threads, int smem, int tier, int bf16,
                                  void* stream) {
  return (bf16 ? launch<bf16_t, false> : launch<float, false>)(
      xp, w_hh, b_ih, b_hh, ys, h_last, hp, T, B, H, D, C, BT, S, KC, U, threads, smem, tier,
      stream);
}

// The walk layout (`run_layer`): xp (T, D, B, 3H) with b_ih folded in,
// ys (T, D, B, H), hp (T, D, B, 3H) or null; no h_last (it is ys[T - 1]).
// b_ih (null in float32) is the part of the bf16 bias fold that is added to
// xp and rounded (b_hh_r, b_hh_z, 0).
extern "C" int s2ag_gru_layer_fwd_v1(const void* xp, const void* w_hh, const void* b_ih,
                                     const void* b_hh, void* ys, float* hp, int T, int B,
                                     int H, int D, int C, int BT, int S, int KC, int U,
                                     int threads, int smem, int tier, int bf16,
                                     void* stream) {
  return (bf16 ? launch<bf16_t, true> : launch<float, true>)(
      xp, w_hh, b_ih, b_hh, ys, nullptr, hp, T, B, H, D, C, BT, S, KC, U, threads, smem, tier,
      stream);
}

namespace {

template <typename V>
int max_clusters(int S, int KC, int C, int threads, int smem, int tier) {
  int clusters = 0;
  cudaError_t err = cudaErrorInvalidValue;
  const ClusterLaunch launch(C, dim3(C), threads, smem, nullptr);
  if (tier == 1 && S == L2_S)
    err = max_active_clusters(gru_layer_fwd_l2_kernel<V, false>, launch, &clusters);
  if constexpr (std::is_same_v<V, bf16_t>) {
#define S2AG_TC(KK)     \
  if (tier == 2 && KC == 16 * KK) \
    err = max_active_clusters(gru_layer_fwd_tc_kernel<false, KK>, launch, &clusters);
    S2AG_GRU_TC_INSTANCES
#undef S2AG_TC
  }
#define S2AG_GRU(SS, KK)                                                                   \
  if (tier == 0 && S == SS && KC == KK)                                                    \
    err = max_active_clusters(gru_layer_fwd_kernel<V, SS, KK, false, false>, launch,        \
                              &clusters);
  S2AG_GRU_REG_INSTANCES
#undef S2AG_GRU
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace

// How many clusters of C blocks of the (tier, S, KC) instance (bf16 != 0:
// its bf16 instance), each block taking `threads` threads and `smem` bytes
// of shared memory, the current device runs at once (0 when none fits), or
// minus the CUDA error code. The launch plan spreads the batch over about
// this many.
extern "C" int s2ag_gru_fwd_max_clusters(int S, int KC, int C, int threads, int smem,
                                         int tier, int bf16) {
  return (bf16 ? max_clusters<bf16_t> : max_clusters<float>)(S, KC, C, threads, smem, tier);
}
