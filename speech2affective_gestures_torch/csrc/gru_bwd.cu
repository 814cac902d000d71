// Backward of one (bi)directional GRU layer: the reverse-time recurrence in
// one kernel, the recurrent weight's gradient in a second (and a fixed-order
// sum pass).
//
// Replaces the TPU kernels speech2affective_gestures_tpu/ops/gru_pallas.py
// ::_bwd_kernel_v2 (pallas_call in _bwd_call_v2) and ::_bwd_kernel (v1,
// pallas_call in _bwd_call). The forward (csrc/gru_fwd.cu) saved xp (input
// projections), ys and hp = h_prev . W_hh + b_hh; for each direction this
// walks time opposite to that direction's forward walk, recomputes r, z, n
// from xp and hp (the forward's expressions on the forward's values, so the
// same bits), and with dh = dys + carry:
//   dn     = dh (1 - z)          dz     = dh (h_prev - n)
//   dpre_n = dn (1 - n^2)        dpre_z = dz z (1 - z)
//   dpre_r = dpre_n hp_n r (1 - r)
//   dxp    = [dpre_r, dpre_z, dpre_n]            (forward time order)
//   g      = [dpre_r, dpre_z, dpre_n r]          (gradient of h . W_hh + b_hh)
//   carry  = dh z + g . W_hh^T                   (dh of the previous step)
// and then
//   dW_hh  = sum_{t,b} h_prev^T g,   db_hh = sum_{t,b} g.
// The gradient of b_ih is sum_{t,b} dxp: its r and z parts are db_hh's,
// and the wrapper sums dxp's n part with a plain reduction (the JAX
// package also sums dxp outside its kernel).
//
// Layouts (row-major, contiguous), the forward's two, chosen by the
// template parameter WALK:
//   model layout (WALK = false): xp, hp, dxp (T, B, D*3H), xp without b_ih;
//     ys, dys, gn (T, B, D*H) in forward time order; dys already holds the
//     gradient of h_last, added by the wrapper at the frame that produced
//     each direction's final state
//   walk layout (WALK = true, `run_layer`): xp, hp, dxp (T, D, B, 3H) with
//     b_ih folded into xp (so there is no b_ih); ys, dys, gn (T, D, B, H),
//     row s the walk's step s for both directions: h_prev of step s is row
//     s - 1
//   gn = dpre_n r; w_hh (D, H, 3H); b_ih (D, 3H) or null (zero); dw_hh
//   (D, H, 3H), db_hh (D, 3H).
// In the walk layout db_hh's r and z parts are the sums of dxp's, as the
// TPU kernel's fold of b_hh_r and b_hh_z into xp gives them.
// Storage: float32 or bf16 (the template parameter V: xp, w_hh, b_ih, ys,
// dys, dxp and gn; hp is the forward's float32). As the TPU kernel at bf16
// (gru_pallas.py:405-431, :482): r, z, n recomputed as the forward's bf16
// instance computed them (xp + b_ih rounded to bf16, the bias fold of
// `gru_cuda.kernel_biases`), dh, the gate gradients, g and the carry in
// float32 (its dh scratch is f32), g . W^T from float32 g and widened bf16
// W (the tensor tier: g as bf16 hi + lo, two exact products each), dxp and
// gn rounded to bf16 when stored. dW_hh and db_hh are float32
// sums of the bf16 inputs' exact products (on the tensor cores); the
// wrapper rounds them to the parameters' dtype. One step differs from the TPU kernel: its dW_hh sums
// h_prev^T g with g in float32, here g is the stored bf16 dxp and gn.
//
// Kernel 1, the recurrence: the forward's cluster design turned round. One
// cluster of C blocks per (batch tile, direction) runs the time loop; block
// c owns the units [cU, (c+1)U) and keeps the ROWS of W_hh for its units in
// its threads' registers, read once: thread (pair of units, lane s) holds
// W[k][gate H + j] of its two units k for the three gates over its chunk j
// in [s KC, (s+1) KC), 2 x 3 KC values (KC <= 20). Each step, for each
// group of S rows: the lanes' chunk sums of g . W^T (each gate's sum in
// ascending j, then r + z, + n) meet in the forward's reduce-scatter, so
// that lane s holds row g0 + s's totals of its two units; that lane adds the
// dh z it kept from the previous step, forms dh, the gate gradients and
// dxp, gn, and sends its row's g (three gates, four units a float4) into
// the next g buffer of every block of the cluster through distributed
// shared memory. g is double-buffered, so one cluster barrier a step is
// enough (a block alone, at H 64, takes a block barrier). One product with
// W_hh a step (the forward's saved hp replaces the second), W_hh never
// streamed. Past H 320 the forward's L2 tier (gru_cluster.cuh): the same
// sums, W read from device memory once per group of S rows, pairs walked in
// passes. Bound on the H100: 2 T B D H 3H FLOP of the product (0.283 ms at
// T 34, B 512, H 300 against 67 TFLOP/s float32). What holds it is shared
// memory: it gives an SM 32 floats a cycle and the FMA pipes take 128, and
// each value of g read feeds as many FMAs as a thread has units; hence the
// pairs (with one unit a thread, as the forward has, the reads take four
// times the FMAs' issue; PERF.md). The bf16 instance has a third tier at H
// <= 320, the tensor tier (`gru_layer_bwd_tc_kernel`, below): the product
// on the tensor cores from a float32 g split into bf16 hi + lo, its K split
// over the cluster, which the plan takes where the batch is large enough
// (`gru_cuda.bwd_tier`).
//
// Kernels 2 and 3, dW_hh and db_hh: a product over the T*B rows,
// [h_prev | 1]^T (H + 1 rows of k, the ones row giving db_hh) times g (3H
// columns of j), cut into S consecutive row splits; one block per (tile,
// split) sums its split's rows in order into a partial tile, and a second
// pass (`gru_dw_sum_kernel`) adds the S partials of each output in split
// order: deterministic, no atomics. The plan (`gru_cuda.dw_plan`) takes S
// so that the blocks fill the card.
//   float32 (`gru_dw_kernel`): block tiles of 64 (k) x 128 (j), 256 threads
//   with 4 x 8 outputs each (one float4 of h_prev and two of g from shared
//   memory feed 32 FMAs); the rows come through a 3-stage cp.async ring of
//   16 rows a stage (16-byte copies where H % 4 == 0, 4-byte otherwise;
//   zero-fill past the data), one barrier a stage; each thread's row offsets
//   advance by arithmetic, with no table. Plain float32 FMAs (no TF32).
//   Bound: 2 T B D (H + 1) 3H FLOP against the float32 rate.
//   bf16 (`gru_dw_tc_kernel`): the same sums on the tensor cores (bf16
//   products, exact, accumulated in float32), block tiles of 128 x 128 that
//   read each row of g half as often as the float32 tiles, a 4-stage
//   cp.async ring of 32 rows (8-byte copies where
//   H % 4 == 0, since at H 300 the second direction starts 600 bytes into a
//   row; 4-byte where H % 2 == 0, else plain loads), ldmatrix.trans for both
//   M-major operands. Bound: its bf16 bytes (the inputs once, float32
//   out), 0.026 ms at T 34, B 512, H 300.

#include <type_traits>

#include "gru_cluster.cuh"

namespace {

// The recurrence's thread shape (`gru_cuda.bwd_shape`): a thread owns a
// PAIR of units, so that each value of g it reads from shared memory feeds
// two units' FMAs (shared memory gives an SM 32 floats a cycle, its FMA
// pipes 128, and one unit a thread left the product bound by the reads).
// The register tier holds the pair's rows of W_hh over a chunk of at most
// 20 j (2 x 3 x 20 values); S lanes (2 to 16) share a pair. A block takes
// at most BWD_THREADS threads in the register tier, BWD_L2_THREADS in the
// L2 tier (whose chunk sums of S rows need the registers).
constexpr int BWD_THREADS = 320;
constexpr int BWD_L2_THREADS = 256;
__host__ __device__ constexpr int bwd_max_threads(int KC) {
  return KC == 0 ? BWD_L2_THREADS : BWD_THREADS;
}
// the register tier's (S, KC) instances: KC = ceil(H / S) rounded up to 4
// within 20, S the fewest lanes that allow it
#define S2AG_BWD_REG_INSTANCES                                                       \
  S2AG_BWD(2, 4) S2AG_BWD(2, 8) S2AG_BWD(2, 12) S2AG_BWD(2, 16) S2AG_BWD(2, 20)      \
  S2AG_BWD(4, 12) S2AG_BWD(4, 16) S2AG_BWD(4, 20) S2AG_BWD(8, 12) S2AG_BWD(8, 16)     \
  S2AG_BWD(8, 20) S2AG_BWD(16, 12) S2AG_BWD(16, 16) S2AG_BWD(16, 20)

// a chunk's stride in a row of g: KS / 4 odd, so that the float4 reads of
// the 8 lanes of a quarter warp hit distinct banks (`gru_cuda._bwd_ks`)
__host__ __device__ constexpr int bwd_ks(int kc) { return (kc / 4) % 2 ? kc : kc + 4; }

// This lane's chunk sums of one row of g . W^T for its two units: each
// gate's sum over its KC values of j in ascending j, then (r + z) + n (g:
// the row's gate-r chunk, gates GS apart; w[u][gate][i]).
template <int KC>
__device__ __forceinline__ void bwd_chunk_sums(const float* g, int GS,
                                               const float (&w)[2][3][KC], float (&out)[2]) {
  float a[2][3];
#pragma unroll
  for (int u = 0; u < 2; ++u) a[u][0] = a[u][1] = a[u][2] = 0.0f;
#pragma unroll
  for (int q = 0; q < KC / 4; ++q) {
    float x[3][4];
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      const float4 v = reinterpret_cast<const float4*>(g + gt * GS)[q];
      x[gt][0] = v.x;
      x[gt][1] = v.y;
      x[gt][2] = v.z;
      x[gt][3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) a[u][gt] = fmaf(x[gt][e], w[u][gt][4 * q + e], a[u][gt]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) out[u] = (a[u][0] + a[u][1]) + a[u][2];
}

// The L2 tier's chunk sums of the group's `rows` rows (gg: row 0's gate-r
// chunk, rows RS and gates GS apart) in bwd_chunk_sums' order, each W value
// (W[u]: unit u's row of W_hh at j = j0 of gate r, null when the lane has
// no such unit) read once per group.
template <int S, typename V>
__device__ __forceinline__ void bwd_chunk_sums_l2(const float* gg, int rows, int RS, int GS,
                                                  const V* const (&W)[2], int j0, int kc,
                                                  int H, float (&tot)[S][2]) {
  float acc[S][2][3];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) acc[i][u][0] = acc[i][u][1] = acc[i][u][2] = 0.0f;
  for (int q = 0; q < kc; q += 4) {
    float w[2][3][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = W[u] != nullptr && j0 + q + e < H;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) w[u][gt][e] = ok ? ld(W[u] + gt * H + q + e) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i >= rows) break;  // uniform
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const float4 v = *reinterpret_cast<const float4*>(gg + i * RS + gt * GS + q);
        const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < 2; ++u) acc[i][u][gt] = fmaf(x[e], w[u][gt][e], acc[i][u][gt]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) tot[i][u] = (acc[i][u][0] + acc[i][u][1]) + acc[i][u][2];
}

template <typename V, int S, int KC, bool WALK>
__global__ void __launch_bounds__(bwd_max_threads(KC), 1) gru_layer_bwd_kernel(
    const V* __restrict__ xp, const V* __restrict__ w_hh,
    const V* __restrict__ b_ih, const float* __restrict__ hp,
    const V* __restrict__ ys, const V* __restrict__ dys,
    V* __restrict__ dxp, V* __restrict__ gn, int T, int B, int H, int D, int U,
    int BT, int kc) {
  constexpr bool L2 = KC == 0;
  constexpr int P = 32 / S;      // pairs a warp
  const int KCr = L2 ? kc : KC;  // the chunk (a constant in the register tier)
  const int KS = bwd_ks(KCr);
  const int GS = S * KS;  // a gate's stride in a row of g
  const int RS = 3 * GS;  // a row of g
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  float* g_s = smem;                  // [2][BT][3][S][KS]
  float* dhz_s = smem + 2 * BT * RS;  // [BT][U]: dh z of the last step

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int nrows = min(BT, B - b0);
  const int H3 = 3 * H;
  const int u0 = c * U;
  const int s = threadIdx.x % S;   // the thread's chunk of j
  const int pl = threadIdx.x / S;  // the thread's pair in the block's pass
  const int PP = L2 ? (int)blockDim.x / S : (U + 1) / 2;  // pairs a pass
  const int npass = L2 ? (U + 2 * PP - 1) / (2 * PP) : 1;

  // prologue (register tier): rows k = u0 + 2 pl + u of W_hh, this lane's
  // chunk of each gate, into registers, read once
  float w[2][3][L2 ? 1 : KC];
  if constexpr (!L2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = u0 + 2 * pl + u;
      const bool active = pl < PP && 2 * pl + u < U && k < H;
      const V* W = w_hh + ((size_t)d * H + k) * H3 + s * KC;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const bool ok = active && s * KC + i < H;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) w[u][gt][i] = ok ? ld(W + gt * H + i) : 0.0f;
      }
    }
  }
  for (int i = threadIdx.x; i < 2 * BT * RS / 4; i += blockDim.x)
    reinterpret_cast<float4*>(g_s)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < BT * U; i += blockDim.x) dhz_s[i] = 0.0f;

  // The exchange packs 4 units (2 pairs) of one row into a float4: of the
  // warp's S rows x 2P units (16 float4s), lanes f and f + 16 gather float4
  // f (row f % S, pairs 2 (f / S) and + 1 of the warp's) and store it into
  // peers f / 16, + 2, ...
  const int lane = threadIdx.x & 31;
  const int xrow = (lane & 15) % S;
  const int xq = (lane & 15) / S;
  const int xa = 2 * xq * S + xrow;  // lane of (row, pair 2 xq)
  const int xpair = (threadIdx.x >> 5) * P + 2 * xq;  // its first pair in a pass
  cluster.sync();  // every block has started and cleared its g

  for (int step = 0; step < T; ++step) {
    // the model layout's forward walked d = 0 ascending and d = 1
    // descending; the walk layout's rows are already in walk order
    const int p = (WALK || d == 0) ? T - 1 - step : step;
    const int q = (WALK || d == 0) ? p - 1 : p + 1;  // frame of h_prev
    const bool has_prev = q >= 0 && q < T;
    const float* gc = g_s + (step & 1) * BT * RS;  // g of the step before
    float* g_next = g_s + ((step + 1) & 1) * BT * RS;
    for (int g0 = 0; g0 < nrows; g0 += S) {
      const int rows = min(S, nrows - g0);
      for (int pass = 0; pass < npass; ++pass) {
        const int row = g0 + s;
        int uk[2];      // the thread's units in the block
        bool mine[2];   // (row, unit) is this lane's
        const V* W[2];
        float x[2][3], hh[2][3], dy[2], h_prev[2];
        size_t xo[2], ho[2];
        // the lane's row: loaded before the product hides the latency
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uk[u] = 2 * (pass * PP + pl) + u;
          const int k = u0 + uk[u];
          const bool active = pl < PP && uk[u] < U && k < H;
          W[u] = active ? w_hh + ((size_t)d * H + k) * H3 + s * KCr : nullptr;
          mine[u] = active && row < nrows;
          xo[u] = mine[u] ? row_offset<WALK>(p, p, d, b0 + row, B, D, H3) + k : 0;
          ho[u] = mine[u] ? row_offset<WALK>(p, p, d, b0 + row, B, D, H) + k : 0;
          dy[u] = h_prev[u] = 0.0f;
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) x[u][gt] = hh[u][gt] = 0.0f;
          if (mine[u]) {
#pragma unroll
            for (int gt = 0; gt < 3; ++gt) {
              const float bi = b_ih != nullptr ? ld(b_ih + (size_t)d * H3 + gt * H + k) : 0.0f;
              x[u][gt] = rounded<V>(ld(xp + xo[u] + gt * H) + bi);
              hh[u][gt] = __ldg(hp + xo[u] + gt * H);
            }
            dy[u] = ld(dys + ho[u]);
            if (has_prev)
              h_prev[u] = ld(ys + row_offset<WALK>(q, q, d, b0 + row, B, D, H) + k);
          }
        }
        float tot[2] = {0.0f, 0.0f};  // row g0 + s's g . W^T (zero g before the first step)
        if (step > 0) {
          if constexpr (L2) {
            float acc[S][2];
            bwd_chunk_sums_l2<S>(gc + g0 * RS + s * KS, rows, RS, GS, W, s * kc, kc, H, acc);
            group_totals_of<S, 2>(acc, rows, s, tot);
          } else {
            const float* gg = gc + g0 * RS + s * KS;
            group_totals<S, 2>(rows, s, [&](int i, float (&out)[2]) {
              bwd_chunk_sums<KC>(gg + i * RS, GS, w, out);
            }, tot);
          }
        }
        float g3[2][3];  // 0 past H, where g must stay 0
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          g3[u][0] = g3[u][1] = g3[u][2] = 0.0f;
          if (!mine[u]) continue;
          float* dhz = dhz_s + row * U + uk[u];
          const float dh = dy[u] + (*dhz + tot[u]);
          const float r = sigmoid_f(x[u][0] + hh[u][0]);
          const float z = sigmoid_f(x[u][1] + hh[u][1]);
          const float n = tanhf(x[u][2] + r * hh[u][2]);
          const float dn = dh * (1.0f - z);
          const float dz = dh * (h_prev[u] - n);
          const float dpre_n = dn * (1.0f - n * n);
          const float dpre_z = dz * z * (1.0f - z);
          const float dpre_r = dpre_n * hh[u][2] * r * (1.0f - r);
          dxp[xo[u]] = narrow<V>(dpre_r);
          dxp[xo[u] + H] = narrow<V>(dpre_z);
          dxp[xo[u] + 2 * H] = narrow<V>(dpre_n);
          if (gn != nullptr) gn[ho[u]] = narrow<V>(dpre_n * r);
          g3[u][0] = dpre_r;
          g3[u][1] = dpre_z;
          g3[u][2] = dpre_n * r;
          *dhz = dh * z;
        }
        // g into every block's next buffer, this block's included
        const int xu = 2 * (pass * PP + xpair);  // the float4's first unit in the block
        const bool send = xpair < PP && xu < U && u0 + xu < H && g0 + xrow < nrows;
        float* dst = g_next + (g0 + xrow) * RS + ((u0 + xu) / KCr) * KS + (u0 + xu) % KCr;
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          float4 v;
          v.x = __shfl_sync(0xffffffffu, g3[0][gt], xa);
          v.y = __shfl_sync(0xffffffffu, g3[1][gt], xa);
          v.z = __shfl_sync(0xffffffffu, g3[0][gt], xa + S);
          v.w = __shfl_sync(0xffffffffu, g3[1][gt], xa + S);
          if (send)
            for (int peer = lane >> 4; peer < C; peer += 2)
              *reinterpret_cast<float4*>(cluster.map_shared_rank(dst + gt * GS, peer)) = v;
        }
      }
    }
    if (C == 1)  // a block alone: the block barrier is enough, and cheaper
      __syncthreads();
    else
      cluster.sync();
  }
}

template <typename V, int S, int KC, bool WALK>
cudaError_t launch_bwd(const V* xp, const V* w_hh, const V* b_ih, const float* hp,
                       const V* ys, const V* dys, V* dxp, V* gn, int T, int B, int H, int D,
                       int C, int BT, int kc, int U, int threads, int smem,
                       cudaStream_t stream) {
  // what the indexing needs of a plan: every j in a chunk (whole float4s),
  // every unit in a block (U whole float4s, so whole pairs), whole warps,
  // the register tier's pairs in one pass, the L2 tier's passes of whole
  // pairs of pairs; both g buffers of BT rows of 3 gates of S chunks, and
  // BT x U values of dh z
  const bool ok = kc >= 4 && kc % 4 == 0 && S * kc >= H && (long long)C * U >= H &&
                  U % 4 == 0 && threads % 32 == 0 && threads <= bwd_max_threads(KC) &&
                  (KC == 0 ? threads % (4 * S) == 0 : threads >= (U / 2) * S);
  if (!ok || smem < 4 * (2 * BT * 3 * S * bwd_ks(kc) + BT * U)) return cudaErrorInvalidValue;
  const ClusterLaunch launch(C, dim3(C * ((B + BT - 1) / BT), D), threads, smem, stream);
  auto kernel = gru_layer_bwd_kernel<V, S, KC, WALK>;
  cudaError_t err = check_config(kernel, launch);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&launch.cfg, kernel, xp, w_hh, b_ih, hp, ys, dys, dxp, gn, T, B,
                           H, D, U, BT, kc);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bf16 recurrence's tensor tier (`gru_layer_bwd_tc_kernel`, the plan's
// tier 2 at H <= 320): the carry's product g . W^T on the tensor cores, its
// K (the 3H columns of g) split over the cluster. Block c owns the units
// [cU, (c+1)U) (U even, at most 40; C 8, U 38 at H 300) and the 3U columns
// of g they produce, [g_r | g_z | g_n] of its units, which never leave it.
// Each step it multiplies its slice of g by the matching rows of W^T for
// all H outputs and stores each output pair's float32 partial sums (a
// float2) into the recv buffer of the block that owns those units, slot c;
// after one cluster barrier each block adds the C partials of its units in
// cluster order (fixed: the same bits every launch) and runs the gate
// update there. recv is double-buffered by step parity, so a fast peer's
// next partials never meet a slot still being read.
//
// The TPU kernel's product takes float32 g (gru_pallas.py:426-431); bf16
// operands would round it by 2^-9 a step. So each g is stored as two bf16
// values, hi = rn(g) and lo = rn(g - hi) (g - hi is exact in float32), and
// both multiply the exact bf16 W: hi + lo keeps g to 2^-17 of itself, far
// below the bf16 rounding of the stored dxp. Per k16 step the hi product
// and then the lo product go into the same float32 accumulator.
//
// Fragments (gru_cluster.cuh): the block's g slice is KL = 16 KT columns
// (3U padded with zeros), stored per row as [hi (KL) | lo (KL) | 8 pad] bf16
// (KRS = 2 KL + 8 values: an odd number of 16-byte segments, so the 8 row
// addresses of an ldmatrix hit distinct banks). Warp (nw, wm) of NW x WM
// holds the B fragments of W^T for NT n8 tiles of outputs [8 NT nw, +8 NT)
// over the KT k16 steps in registers (2 KT NT a lane, read once: lane (g,
// c) of tile nt holds W[n][j(kk)] for n = 8 (NT nw + nt) + g and kk = 16 ks
// + 8 half + 2c + e, j(kk) the kk-th column of the slice), and walks the
// tile's m16 tiles wm, wm + WM, ...; the NT independent accumulators keep
// the tensor pipe busy. Rows past the batch tile read whatever follows g in
// shared memory (the recv buffers) and land in accumulator rows that are
// never sent: an m16n8k16 row depends on its own A row alone.
//
// The gate update runs on every thread, (row, unit) positions in turn,
// with the register tier's expressions and rounding points; hi and lo of
// g go to the block's own buffer, dh z to shared memory. A block barrier
// then makes g visible to the next step's product.
//
// What bounds it: the 34-step chain of products, partial stores, the
// cluster barrier and the gate update, not the tensor rate nor the
// exchange. On the H100 at T 34, B 512, H 300 (`tools/tc_probes.py`,
// device time, PERF.md) it takes 0.69 ms; without the products 0.56,
// without the gate update's loads of xp, hp, dys and h_prev 0.55, without
// the lo product 0.63, without the partials' exchange 0.69. Where g lives:
// had every block received the whole g row (hi and lo, double-buffered,
// 7.4 KB a row at H 300), a tile would hold at most 16 rows, B 512 x D 2
// would take 64 clusters (5 waves of the card's 14-15), and this kernel
// at 16-row tiles takes 0.94 ms; the K split holds 74 rows a block (3.1 KB
// a row), one wave.
// a block's most warps: 10 with 4 n8 tiles a warp (H 320 in one row of
// warps), else 8 (`gru_cuda.BWD_TENSOR_MAX_WARPS`)
__host__ __device__ constexpr int bwd_tc_max_threads(int NT) { return 32 * (NT == 4 ? 10 : 8); }
// the (KT, NT) instances: KT k16 steps of a block's slice of g (3U <= 16
// KT), NT n8 tiles of outputs a warp (`gru_cuda.bwd_tensor_shape`). NT 4:
// 10 warps a block at H 300, each with four independent accumulators, ran
// faster on the H100 than 8 warps of 5 tiles or 5 warps of 8 (PERF.md;
// `tools/tc_probes.py` builds those instances too)
#define S2AG_BWD_TC_NT(NN)                                                             \
  S2AG_BWD_TC(1, NN) S2AG_BWD_TC(2, NN) S2AG_BWD_TC(3, NN) S2AG_BWD_TC(4, NN)         \
  S2AG_BWD_TC(5, NN) S2AG_BWD_TC(6, NN) S2AG_BWD_TC(7, NN) S2AG_BWD_TC(8, NN)
#define S2AG_BWD_TC_INSTANCES S2AG_BWD_TC_NT(4)

// the warps across the outputs: NT n8 tiles each over H rounded up to 8
__host__ __device__ inline int bwd_tc_nw(int H, int NT) { return ((H + 7) / 8 + NT - 1) / NT; }

template <bool WALK, int KT, int NT>
__global__ void __launch_bounds__(bwd_tc_max_threads(NT), 1) gru_layer_bwd_tc_kernel(
    const bf16_t* __restrict__ xp, const bf16_t* __restrict__ w_hh,
    const bf16_t* __restrict__ b_ih, const float* __restrict__ hp,
    const bf16_t* __restrict__ ys, const bf16_t* __restrict__ dys,
    bf16_t* __restrict__ dxp, bf16_t* __restrict__ gn, int T, int B, int H, int D, int U,
    int BT) {
  constexpr int KL = 16 * KT;
  constexpr int KRS = 2 * KL + 8;
  extern __shared__ __align__(16) unsigned char btc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  bf16_t* g_s = reinterpret_cast<bf16_t*>(btc_smem);              // [BT][KRS]
  float* recv = reinterpret_cast<float*>(g_s + (size_t)BT * KRS);  // [2][C][BT][U]
  float* dhz_s = recv + (size_t)2 * C * BT * U;                     // [BT][U]

  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const int nrows = min(BT, B - b0);
  const int n_mt = (nrows + 15) / 16;
  const int H3 = 3 * H;
  const int u0 = c * U;
  const int N8 = (H + 7) / 8;
  const int NW = bwd_tc_nw(H, NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = warp % NW, wm = warp / NW, WM = (int)blockDim.x / 32 / NW;
  const int qg = lane / 4, qc = lane % 4;

  // prologue: the B fragments of W^T, read once (zero past H and past the
  // slice's 3U columns)
  unsigned wf[NT][KT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 8 * (nw * NT + nt) + qg;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned short v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 16 * ks + 8 * half + 2 * qc + e;
          const int gate = kk / U, u = kk - gate * U;
          v[e] = n < H && kk < 3 * U && u0 + u < H
                     ? bits_of(w_hh + ((size_t)d * H + n) * H3 + gate * H + u0 + u)
                     : 0;
        }
        wf[nt][ks][half] = pack2(v[0], v[1]);
      }
  }
  for (int i = threadIdx.x; i < BT * KRS / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(g_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < BT * U; i += blockDim.x) dhz_s[i] = 0.0f;
  // this lane's ldmatrix row in an m16 tile (the forward's tensor tier's)
  const int a_off = ((lane % 8) + 8 * ((lane / 8) % 2)) * KRS + 8 * (lane / 16);
  cluster.sync();  // every block has started and cleared its g

  for (int step = 0; step < T; ++step) {
    const int p = (WALK || d == 0) ? T - 1 - step : step;
    const int q = (WALK || d == 0) ? p - 1 : p + 1;  // frame of h_prev
    const bool has_prev = q >= 0 && q < T;
    const int slot = step & 1;
    if (step > 0) {  // g is zero before the first step: so is the product
      for (int mt = wm; mt < n_mt; mt += WM) {
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
        const bf16_t* a = g_s + 16 * mt * KRS + a_off;
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          unsigned ahi[4], alo[4];
          ldmatrix_x4<false>(ahi, a + 16 * ks);
          ldmatrix_x4<false>(alo, a + KL + 16 * ks);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (nw * NT + nt < N8) mma_bf16(acc[nt], ahi, wf[nt][ks][0], wf[nt][ks][1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (nw * NT + nt < N8) mma_bf16(acc[nt], alo, wf[nt][ks][0], wf[nt][ks][1]);
        }
        // each output pair (n, n + 1) of rows qg and qg + 8 to its owner
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = 8 * (nw * NT + nt) + 2 * qc;
          if (n >= H) continue;
          const int owner = n / U, u = n - owner * U;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * mt + qg + 8 * h;
            if (row >= nrows) continue;
            float* dst = recv + (((size_t)slot * C + c) * BT + row) * U + u;
            *reinterpret_cast<float2*>(cluster.map_shared_rank(dst, owner)) =
                make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
          }
        }
      }
      if (C == 1)  // a block alone: the block barrier is enough, and cheaper
        __syncthreads();
      else
        cluster.sync();
    }
    for (int idx = threadIdx.x; idx < nrows * U; idx += blockDim.x) {
      const int row = idx / U, u = idx - row * U;
      const int k = u0 + u;
      if (k >= H) continue;
      float tot = 0.0f;  // row's g . W^T at unit k: the partials in cluster order
      if (step > 0)
        for (int cc = 0; cc < C; ++cc) tot += recv[(((size_t)slot * C + cc) * BT + row) * U + u];
      const size_t xo = row_offset<WALK>(p, p, d, b0 + row, B, D, H3) + k;
      const size_t ho = row_offset<WALK>(p, p, d, b0 + row, B, D, H) + k;
      float x[3], hh[3];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const float bi = b_ih != nullptr ? ld(b_ih + (size_t)d * H3 + gt * H + k) : 0.0f;
        x[gt] = rounded<bf16_t>(ld(xp + xo + gt * H) + bi);
        hh[gt] = __ldg(hp + xo + gt * H);
      }
      const float dy = ld(dys + ho);
      const float h_prev =
          has_prev ? ld(ys + row_offset<WALK>(q, q, d, b0 + row, B, D, H) + k) : 0.0f;
      float* dhz = dhz_s + row * U + u;
      const float dh = dy + (*dhz + tot);
      const float r = sigmoid_f(x[0] + hh[0]);
      const float z = sigmoid_f(x[1] + hh[1]);
      const float n = tanhf(x[2] + r * hh[2]);
      const float dn = dh * (1.0f - z);
      const float dz = dh * (h_prev - n);
      const float dpre_n = dn * (1.0f - n * n);
      const float dpre_z = dz * z * (1.0f - z);
      const float dpre_r = dpre_n * hh[2] * r * (1.0f - r);
      dxp[xo] = narrow<bf16_t>(dpre_r);
      dxp[xo + H] = narrow<bf16_t>(dpre_z);
      dxp[xo + 2 * H] = narrow<bf16_t>(dpre_n);
      if (gn != nullptr) gn[ho] = narrow<bf16_t>(dpre_n * r);
      const float g3[3] = {dpre_r, dpre_z, dpre_n * r};
      bf16_t* gr = g_s + row * KRS + u;
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const bf16_t hi = narrow<bf16_t>(g3[gt]);
        gr[gt * U] = hi;
        gr[KL + gt * U] = narrow<bf16_t>(g3[gt] - widen(hi));
      }
      *dhz = dh * z;
    }
    __syncthreads();  // this step's g before the next step's product
  }
}

// What the tensor tier's indexing needs of a plan: U even (a float2 of
// partials stays with one owner) covering H in C blocks, the slice's 3U
// columns within 16 KT, whole rows of NW warps across the outputs; its
// shared memory: g, both recv slots and dh z for BT rows, and g for the
// tile's rows rounded up to whole m16 tiles (the last tile's ldmatrix).
inline bool bwd_tc_plan_ok(int KT, int NT, int H, int C, int U, int BT, int threads,
                           int smem) {
  const long long KRS = 32 * KT + 8;
  const long long need = 2 * BT * KRS + 4LL * BT * U * (2 * C + 1);
  return U > 0 && U % 2 == 0 && 3 * U <= 16 * KT && (long long)C * U >= H &&
         threads % (32 * bwd_tc_nw(H, NT)) == 0 && threads <= bwd_tc_max_threads(NT) &&
         smem >= need && smem >= 2 * ((BT + 15) / 16 * 16) * KRS;
}

// tier 0: the register instance (S, KC); tier 1: the L2 tier (S = 8);
// tier 2: the bf16 tensor tier (KC = 16 KT, S = NT)
template <typename V, bool WALK>
int launch_recurrence(const void* xp_, const void* w_hh_, const void* b_ih_,
                      const float* hp, const void* ys_, const void* dys_, void* dxp_,
                      void* gn_, int T, int B, int H, int D, int C, int BT, int S, int KC,
                      int U, int threads, int smem, int tier, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || C < 1 || BT < 1)
    return (int)cudaErrorInvalidValue;
  const V* xp = static_cast<const V*>(xp_);
  const V* w_hh = static_cast<const V*>(w_hh_);
  const V* b_ih = static_cast<const V*>(b_ih_);
  const V* ys = static_cast<const V*>(ys_);
  const V* dys = static_cast<const V*>(dys_);
  V* dxp = static_cast<V*>(dxp_);
  V* gn = static_cast<V*>(gn_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<V, bf16_t>) {
    if (tier == 2) {
      if (!bwd_tc_plan_ok(KC / 16, S, H, C, U, BT, threads, smem) || KC % 16)
        return (int)cudaErrorInvalidValue;
      const ClusterLaunch launch(C, dim3(C * ((B + BT - 1) / BT), D), threads, smem, st);
#define S2AG_BWD_TC(KK, NN)                                                               \
  if (KC == 16 * KK && S == NN) {                                                         \
    auto kernel = gru_layer_bwd_tc_kernel<WALK, KK, NN>;                                  \
    cudaError_t err = check_config(kernel, launch);                                       \
    if (err == cudaSuccess)                                                               \
      err = cudaLaunchKernelEx(&launch.cfg, kernel, xp, w_hh, b_ih, hp, ys, dys, dxp, gn, \
                               T, B, H, D, U, BT);                                        \
    return (int)(err != cudaSuccess ? err : cudaGetLastError());                          \
  }
      S2AG_BWD_TC_INSTANCES
#undef S2AG_BWD_TC
      return (int)cudaErrorInvalidValue;
    }
  }
  if (tier == 1 && S == L2_S)
    return (int)launch_bwd<V, L2_S, 0, WALK>(xp, w_hh, b_ih, hp, ys, dys, dxp, gn, T, B, H,
                                             D, C, BT, KC, U, threads, smem, st);
#define S2AG_BWD(SS, KK)                                                                  \
  if (tier == 0 && S == SS && KC == KK)                                                   \
    return (int)launch_bwd<V, SS, KK, WALK>(xp, w_hh, b_ih, hp, ys, dys, dxp, gn, T, B, H, \
                                            D, C, BT, KK, U, threads, smem, st);
  S2AG_BWD_REG_INSTANCES
#undef S2AG_BWD
  return (int)cudaErrorInvalidValue;
}

// dW tile: TM rows of k (h_prev units, plus the ones row H) by TN columns
// of j (gate units), TK rows of (t, b) per stage, NSTAGE stages in flight;
// 256 threads, thread (ty, tx) owning k in [4 ty, 4 ty + 4) and j in
// [4 tx, 4 tx + 4) and [64 + 4 tx, 64 + 4 tx + 4) of the tile. The same
// constants are `gru_cuda.DW_TM`, `DW_TN`, `DW_TK`.
constexpr int TM = 64;
constexpr int TN = 128;
constexpr int TK = 16;
constexpr int NSTAGE = 3;
constexpr int DW_THREADS = 256;

// One cp.async of BYTES (4, 8 or 16) into shared memory, zero-filled when
// not `valid`.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;  // zero-fill what is not read
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC values from src to the shared dst (zeros when not `valid`): one
// cp.async where they make at least 4 bytes (float32: 4 or 16 bytes; bf16:
// 4 or 8), else a plain load (a single bf16, which cp.async cannot copy).
template <typename V, int VEC>
__device__ __forceinline__ void copy_in(V* dst, const V* src, bool valid) {
  if constexpr (sizeof(V) * VEC >= 4) {
    cp_async<sizeof(V) * VEC>(dst, src, valid);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[v] = valid ? src[v] : narrow<V>(0.0f);
  }
}

// Four consecutive shared values.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// A reduction row m = (t, b) = (m / B, m % B), advanced by whole stages
// without a division: frame t in the model layout, walk row t in the walk
// layout.
struct RowCursor {
  int t, b;
  __device__ void init(int m, int B) {
    t = m / B;
    b = m - t * B;
  }
  __device__ void advance(int n, int B) {
    b += n;
    while (b >= B) {
      b -= B;
      ++t;
    }
  }
};

// part (S, D, H + 1, 3H): split's partial sums of [dW_hh; db_hh] over its
// rows [split * rows_per_split, ...) in ascending order (float32 inputs);
// VEC: values per copy (`gru_cuda.dw_plan`: 4 when H % 4 == 0 and the
// tensors are aligned to 4 values, else 1).
template <bool WALK, int VEC>
__global__ void __launch_bounds__(DW_THREADS) gru_dw_kernel(
    const float* __restrict__ ys, const float* __restrict__ dxp, const float* __restrict__ gn,
    float* __restrict__ part, int T, int B, int H, int D, int rows_per_split) {
  using V = float;
  __shared__ __align__(16) V As[NSTAGE][TK][TM];  // h_prev (and the ones row)
  __shared__ __align__(16) V Bs[NSTAGE][TK][TN];  // g
  const int d = blockIdx.z % D;
  const int split = blockIdx.z / D;
  const int k0 = blockIdx.y * TM;
  const int j0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int H3 = 3 * H;
  const int M = T * B;
  const int m_lo = split * rows_per_split;
  const int m_hi = min(M, m_lo + rows_per_split);
  const int n_stage = (m_hi - m_lo + TK - 1) / TK;

  // this thread's copies each stage: A row ra, values [4 ca, 4 ca + 4) of
  // the tile; B rows rb and rb + 8, values [4 cb, 4 cb + 4)
  const int ra = tid / 16, ca = tid % 16;
  const int rb = tid / 32, cb = tid % 32;
  RowCursor cur_a, cur_b0, cur_b1;
  cur_a.init(m_lo + ra, B);
  cur_b0.init(m_lo + rb, B);
  cur_b1.init(m_lo + rb + 8, B);
  int m_a = m_lo + ra, m_b0 = m_lo + rb;

  auto load_stage = [&](int buf) {
    // A: h_prev at frame q (zero at the walk's first frame), 1 at k = H
    {
      const int q = (WALK || d == 0) ? cur_a.t - 1 : cur_a.t + 1;
      const bool row_ok = m_a < m_hi;
      const bool has_prev = row_ok && q >= 0 && q < T;
      const V* src = ys + (has_prev ? row_offset<WALK>(q, q, d, cur_a.b, B, D, H) : 0);
      V* dst = &As[buf][ra][4 * ca];
#pragma unroll
      for (int e = 0; e < 4; e += VEC) {
        const int k = k0 + 4 * ca + e;
        if (k < H) {
          copy_in<V, VEC>(dst + e, src + (has_prev ? k : 0), has_prev);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            dst[e + v] = narrow<V>((row_ok && k + v == H) ? 1.0f : 0.0f);
        }
      }
    }
    // B: g = [dxp_r, dxp_z, gn] at frame t
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const RowCursor& cur = h ? cur_b1 : cur_b0;
      const bool row_ok = m_b0 + 8 * h < m_hi;
      V* dst = &Bs[buf][rb + 8 * h][4 * cb];
#pragma unroll
      for (int e = 0; e < 4; e += VEC) {
        const int j = j0 + 4 * cb + e;
        const V* src = ys;
        bool ok = false;
        if (row_ok && j < 2 * H) {
          src = dxp + row_offset<WALK>(cur.t, cur.t, d, cur.b, B, D, H3) + j;
          ok = true;
        } else if (row_ok && j < H3) {
          src = gn + row_offset<WALK>(cur.t, cur.t, d, cur.b, B, D, H) + (j - 2 * H);
          ok = true;
        }
        copy_in<V, VEC>(dst + e, src, ok);
      }
    }
    cp_async_commit();
    cur_a.advance(TK, B);
    cur_b0.advance(TK, B);
    cur_b1.advance(TK, B);
    m_a += TK;
    m_b0 += TK;
  };

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < n_stage)
      load_stage(st);
    else
      cp_async_commit();  // an empty group keeps the count of groups
  }
  for (int it = 0; it < n_stage; ++it) {
    cp_async_wait<NSTAGE - 2>();  // stage it has landed (this thread's part)
    __syncthreads();              // everyone's part; stage it - 1's buffer is free
    if (it + NSTAGE - 1 < n_stage)
      load_stage((it + NSTAGE - 1) % NSTAGE);
    else
      cp_async_commit();
    const int buf = it % NSTAGE;
    const float* a_tile = &As[buf][0][0];
    const float* b_tile = &Bs[buf][0][0];
#pragma unroll
    for (int r = 0; r < TK; ++r) {
      float av[4], bv[8], bw[4];
      load4(a_tile + r * TM + 4 * ty, av);
      load4(b_tile + r * TN + 4 * tx, bw);
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = bw[b];
      load4(b_tile + r * TN + 64 + 4 * tx, bw);
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[4 + b] = bw[b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
  cp_async_wait<0>();

  float* out = part + ((size_t)split * D + d) * (H + 1) * H3;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + 4 * ty + a;
    if (k > H) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b < 4 ? 4 * tx + b : 64 + 4 * tx + b - 4);
      if (j < H3) out[(size_t)k * H3 + j] = acc[a][b];
    }
  }
}

// dW_hh and db_hh: each output the sum of its S partials in split order
__global__ void gru_dw_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw_hh,
                                  float* __restrict__ db_hh, int H, int D,
                                  int S) {
  const int H3 = 3 * H;
  const size_t per_dir = (size_t)(H + 1) * H3;
  const size_t n = (size_t)D * per_dir;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += part[s * n + idx];
    const size_t d = idx / per_dir;
    const size_t rem = idx - d * per_dir;
    const size_t k = rem / H3;
    const size_t j = rem - k * H3;
    if (k < (size_t)H) {
      dw_hh[(d * H + k) * H3 + j] = acc;
    } else {
      db_hh[d * H3 + j] = acc;
    }
  }
}

// The bf16 dW product on the tensor cores (`gru_dw_tc_kernel`): a block
// tile of DK = 128 rows of k (h_prev units and the ones row) by DJ = 128
// columns of j, DRK rows of (t, b) a stage, DNST stages in flight, 8 warps
// of 64 x 32 outputs each (117 registers a thread: two blocks an SM, so
// that one block's copies overlap the other's products, 10% faster than
// one block of 128 x 256 tiles on the H100); rows of DK + 8 and DJ + 8
// values in shared memory (a row's 16-byte segments odd in number: the 8
// rows of an ldmatrix hit distinct banks). `gru_cuda.DW_TC_K`, `DW_TC_J`,
// `DW_TC_RK` and `DW_TC_BLOCKS_PER_SM` are the same constants.
// Warp (wk, wj) of the WK x WJ warps owns DMT m16 tiles of k and DNT n8
// tiles of j.
constexpr int DWK = 2, DWJ = 4, DMT = 4, DNT = 4;
constexpr int DK = 16 * DWK * DMT;
constexpr int DJ = 8 * DWJ * DNT;
constexpr int DRK = 32;
constexpr int DNST = 4;
constexpr int DW_TC_THREADS = 32 * DWK * DWJ;
constexpr int DW_TC_MIN_BLOCKS = 2;
constexpr int DAS = DK + 8;
constexpr int DBS = DJ + 8;
constexpr int DW_TC_SMEM = DNST * DRK * (DAS + DBS) * 2;

// part (S, D, H + 1, 3H) as `gru_dw_kernel`'s, from bf16 ys, dxp and gn:
// out[k][j] = sum over the split's rows m of A[m][k] G[m][j], A = [h_prev |
// 1 | 0...] and G = [dxp_r, dxp_z, gn], float32 accumulation on the tensor
// cores. Both operands are M-major (the rows are the reduction), so both
// come out of shared memory through ldmatrix.trans: A as the m16n8k16
// product's (k x m) operand, G as its (m x j) one. Each thread copies one
// row of each stage, 8 threads a row (VEC values a copy: 8-byte cp.async
// for 4, 4-byte for 2, plain loads for 1), zero past the data. Warp (wk, wj)
// owns k [64 wk, +64) and j [32 wj, +32) of the tile, 4 x 4 accumulator
// tiles; m16 and n8 tiles wholly past the output are skipped (uniform in
// the warp). Fixed order: the same bits every launch.
template <bool WALK, int VEC>
__global__ void __launch_bounds__(DW_TC_THREADS, DW_TC_MIN_BLOCKS) gru_dw_tc_kernel(
    const bf16_t* __restrict__ ys, const bf16_t* __restrict__ dxp,
    const bf16_t* __restrict__ gn, float* __restrict__ part, int T, int B, int H, int D,
    int rows_per_split) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16_t* As = reinterpret_cast<bf16_t*>(dw_smem);  // [DNST][DRK][DAS]
  bf16_t* Bs = As + DNST * DRK * DAS;                // [DNST][DRK][DBS]
  const int d = blockIdx.z % D;
  const int split = blockIdx.z / D;
  const int k0 = blockIdx.y * DK;
  const int j0 = blockIdx.x * DJ;
  const int tid = threadIdx.x;
  const int H3 = 3 * H;
  const int M = T * B;
  const int m_lo = split * rows_per_split;
  const int m_hi = min(M, m_lo + rows_per_split);
  const int n_stage = (m_hi - m_lo + DRK - 1) / DRK;
  const int r = tid / 8, q = tid % 8;  // this thread's row of a stage, its part

  auto load_stage = [&](int it, int buf) {
    const int m = m_lo + it * DRK + r;
    const bool row_ok = m < m_hi;
    const int t = row_ok ? m / B : 0;
    const int b = row_ok ? m - t * B : 0;
    // A: h_prev at frame qf (zero at the walk's first frame), 1 at k = H
    const int qf = (WALK || d == 0) ? t - 1 : t + 1;
    const bool has_prev = row_ok && qf >= 0 && qf < T;
    const bf16_t* src = ys + (has_prev ? row_offset<WALK>(qf, qf, d, b, B, D, H) : 0);
    bf16_t* dst = As + (buf * DRK + r) * DAS;
    for (int e = VEC * q; e < DK; e += 8 * VEC) {
      const int k = k0 + e;
      if (k < H) {
        copy_in<bf16_t, VEC>(dst + e, src + (has_prev ? k : 0), has_prev);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          dst[e + v] = narrow<bf16_t>((row_ok && k + v == H) ? 1.0f : 0.0f);
      }
    }
    // G: [dxp_r, dxp_z, gn] at frame t
    const size_t ox = row_ok ? row_offset<WALK>(t, t, d, b, B, D, H3) : 0;
    const size_t og = row_ok ? row_offset<WALK>(t, t, d, b, B, D, H) : 0;
    bf16_t* dstb = Bs + (buf * DRK + r) * DBS;
    for (int e = VEC * q; e < DJ; e += 8 * VEC) {
      const int j = j0 + e;
      const bf16_t* sj = ys;
      bool ok = false;
      if (row_ok && j < 2 * H) {
        sj = dxp + ox + j;
        ok = true;
      } else if (row_ok && j < H3) {
        sj = gn + og + (j - 2 * H);
        ok = true;
      }
      copy_in<bf16_t, VEC>(dstb + e, sj, ok);
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wk = warp / DWJ, wj = warp % DWJ;
  const int kw = k0 + 16 * DMT * wk, jw = j0 + 8 * DNT * wj;
  const bool active = kw <= H && jw < H3;  // uniform in the warp
  // the lane's ldmatrix.trans rows and columns: A's matrices (m 0-7, k +0),
  // (m 0-7, k +8), (m 8-15, k +0), (m 8-15, k +8) give a0..a3; G's (m 0-7,
  // j +0), (m 8-15, j +0), (m 0-7, j +8), (m 8-15, j +8) the b0, b1 of two
  // n8 tiles
  const int a_off = ((lane % 8) + 8 * (lane / 16)) * DAS + 16 * DMT * wk + 8 * ((lane / 8) % 2);
  const int b_off = ((lane % 8) + 8 * ((lane / 8) % 2)) * DBS + 8 * DNT * wj + 8 * (lane / 16);
  float acc[DMT][DNT][4];
#pragma unroll
  for (int mt = 0; mt < DMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < DNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < DNST - 1; ++st) {
    if (st < n_stage)
      load_stage(st, st);
    else
      cp_async_commit();  // an empty group keeps the count of groups
  }
  for (int it = 0; it < n_stage; ++it) {
    cp_async_wait<DNST - 2>();  // stage it has landed (this thread's part)
    __syncthreads();            // everyone's part; stage it - 1's buffer is free
    if (it + DNST - 1 < n_stage)
      load_stage(it + DNST - 1, (it + DNST - 1) % DNST);
    else
      cp_async_commit();
    const int buf = it % DNST;
    if (active) {
      const bf16_t* at = As + buf * DRK * DAS + a_off;
      const bf16_t* bt = Bs + buf * DRK * DBS + b_off;
#pragma unroll
      for (int kk = 0; kk < DRK / 16; ++kk) {
        unsigned a[DMT][4], bq[DNT / 2][4];
#pragma unroll
        for (int mt = 0; mt < DMT; ++mt) ldmatrix_x4<true>(a[mt], at + 16 * kk * DAS + 16 * mt);
#pragma unroll
        for (int np = 0; np < DNT / 2; ++np)
          ldmatrix_x4<true>(bq[np], bt + 16 * kk * DBS + 16 * np);
#pragma unroll
        for (int mt = 0; mt < DMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < DNT; ++nt)
            if (kw + 16 * mt <= H && jw + 8 * nt < H3)
              mma_bf16(acc[mt][nt], a[mt], bq[nt / 2][2 * (nt % 2)],
                       bq[nt / 2][2 * (nt % 2) + 1]);
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  float* out = part + ((size_t)split * D + d) * (H + 1) * H3;
  const int qg = lane / 4, qc = lane % 4;
#pragma unroll
  for (int mt = 0; mt < DMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < DNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kw + 16 * mt + qg + 8 * (e / 2);
        const int j = jw + 8 * nt + 2 * qc + e % 2;
        if (k <= H && j < H3) out[(size_t)k * H3 + j] = acc[mt][nt][e];
      }
}

// The bf16 product's shared memory (above 48 KB) is opted into once per
// instance.
template <bool WALK, int VEC>
cudaError_t dw_tc_attr() {
  static const cudaError_t err =
      cudaFuncSetAttribute((const void*)gru_dw_tc_kernel<WALK, VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, DW_TC_SMEM);
  return err;
}

// dW of either storage type: the float32 FMA product (`gru_dw_kernel`) or
// the bf16 tensor-core one (`gru_dw_tc_kernel`), then the fixed-order sum.
template <typename V, bool WALK>
int launch_dw(const void* ys_, const void* dxp_, const void* gn_, float* part,
              float* dw_hh, float* db_hh, int T, int B, int H, int D, int S,
              int rows_per_split, int vec, void* stream) {
  // what the indexing needs of the plan: whole stages a split (TK rows in
  // float32, DRK in bf16), every row in a split, copies of VEC values only
  // where H % VEC == 0
  constexpr bool BF16 = std::is_same_v<V, bf16_t>;
  constexpr int RK = BF16 ? DRK : TK;
  const long long M = (long long)T * B;
  const bool vec_ok = BF16 ? (vec == 1 || vec == 2 || vec == 4) : (vec == 1 || vec == 4);
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || S < 1 || rows_per_split < RK ||
      rows_per_split % RK || (long long)S * rows_per_split < M ||
      (long long)(S - 1) * rows_per_split >= M || !vec_ok || H % vec)
    return (int)cudaErrorInvalidValue;
  const V* ys = static_cast<const V*>(ys_);
  const V* dxp = static_cast<const V*>(dxp_);
  const V* gn = static_cast<const V*>(gn_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if constexpr (BF16) {
    const dim3 grid((3 * H + DJ - 1) / DJ, (H + 1 + DK - 1) / DK, D * S);
#define S2AG_DW_TC(VV)                                                                   \
  if (vec == VV) {                                                                      \
    err = dw_tc_attr<WALK, VV>();                                        \
    if (err == cudaSuccess)                                                              \
      gru_dw_tc_kernel<WALK, VV><<<grid, DW_TC_THREADS, DW_TC_SMEM, st>>>(                \
          ys, dxp, gn, part, T, B, H, D, rows_per_split);                                  \
  }
    S2AG_DW_TC(4) S2AG_DW_TC(2) S2AG_DW_TC(1)
#undef S2AG_DW_TC
  } else {
    const dim3 grid((3 * H + TN - 1) / TN, (H + 1 + TM - 1) / TM, D * S);
    if (vec == 4)
      gru_dw_kernel<WALK, 4><<<grid, DW_THREADS, 0, st>>>(ys, dxp, gn, part, T, B, H, D,
                                                          rows_per_split);
    else
      gru_dw_kernel<WALK, 1><<<grid, DW_THREADS, 0, st>>>(ys, dxp, gn, part, T, B, H, D,
                                                          rows_per_split);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)D * (H + 1) * 3 * H;
  const int blocks = (int)((n + 255) / 256);
  gru_dw_sum_kernel<<<blocks, 256, 0, st>>>(part, dw_hh, db_hh, H, D, S);
  return (int)cudaGetLastError();
}

template <typename V>
int max_clusters(int S, int KC, int C, int threads, int smem, int tier) {
  int clusters = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (tier == 1 && S == L2_S) {
    const ClusterLaunch launch(C, dim3(C), threads, smem, nullptr);
    err = max_active_clusters(gru_layer_bwd_kernel<V, L2_S, 0, false>, launch, &clusters);
  }
#define S2AG_BWD(SS, KK)                                                                  \
  if (tier == 0 && S == SS && KC == KK) {                                                 \
    const ClusterLaunch launch(C, dim3(C), threads, smem, nullptr);                       \
    err = max_active_clusters(gru_layer_bwd_kernel<V, SS, KK, false>, launch, &clusters); \
  }
  S2AG_BWD_REG_INSTANCES
#undef S2AG_BWD
  if constexpr (std::is_same_v<V, bf16_t>) {
#define S2AG_BWD_TC(KK, NN)                                                           \
  if (tier == 2 && KC == 16 * KK && S == NN) {                                        \
    const ClusterLaunch launch(C, dim3(C), threads, smem, nullptr);                   \
    err = max_active_clusters(gru_layer_bwd_tc_kernel<false, KK, NN>, launch, &clusters); \
  }
    S2AG_BWD_TC_INSTANCES
#undef S2AG_BWD_TC
  }
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // namespace

// The recurrence, model layout. gn may be null (no weight gradient
// wanted); hp is the forward's (float32). (C, BT, S, KC, U, threads, smem,
// tier) is the caller's launch plan (`gru_cuda.bwd_plan`); bf16 != 0 takes
// the bf16 instance; tier 2 (bf16 only) the tensor tier, with S the n8
// tiles a warp and KC the padded columns of a block's slice of g. Returns
// the CUDA error code of the launch (0 = success).
extern "C" int s2ag_gru_layer_bwd(const void* xp, const void* w_hh, const void* b_ih,
                                  const float* hp, const void* ys, const void* dys,
                                  void* dxp, void* gn, int T, int B, int H, int D, int C,
                                  int BT, int S, int KC, int U, int threads, int smem,
                                  int tier, int bf16, void* stream) {
  return (bf16 ? launch_recurrence<bf16_t, false> : launch_recurrence<float, false>)(
      xp, w_hh, b_ih, hp, ys, dys, dxp, gn, T, B, H, D, C, BT, S, KC, U, threads, smem, tier,
      stream);
}

// The recurrence, walk layout (`run_layer`; b_ih null in float32, the bf16
// fold's xp part in bf16). gn may be null.
extern "C" int s2ag_gru_layer_bwd_v1(const void* xp, const void* w_hh, const void* b_ih,
                                     const float* hp, const void* ys, const void* dys,
                                     void* dxp, void* gn, int T, int B, int H, int D, int C,
                                     int BT, int S, int KC, int U, int threads, int smem,
                                     int tier, int bf16, void* stream) {
  return (bf16 ? launch_recurrence<bf16_t, true> : launch_recurrence<float, true>)(
      xp, w_hh, b_ih, hp, ys, dys, dxp, gn, T, B, H, D, C, BT, S, KC, U, threads, smem, tier,
      stream);
}

// How many clusters of C blocks of the recurrence's (tier, S, KC) instance
// (bf16 != 0: its bf16 instance), each block taking `threads` threads and
// `smem` bytes of shared memory, the current device runs at once (0 when
// none fits), or minus the CUDA error code.
extern "C" int s2ag_gru_bwd_max_clusters(int S, int KC, int C, int threads, int smem,
                                         int tier, int bf16) {
  return (bf16 ? max_clusters<bf16_t> : max_clusters<float>)(S, KC, C, threads, smem, tier);
}

// dW_hh (D, H, 3H) and db_hh (D, 3H), float32, from ys, dxp and gn (bf16 !=
// 0: bf16), through the float32 workspace part (S, D, H + 1, 3H); (S,
// rows_per_split, vec) is the caller's plan (`gru_cuda.dw_plan`). Model
// layout.
extern "C" int s2ag_gru_layer_dw(const void* ys, const void* dxp, const void* gn,
                                 float* part, float* dw_hh, float* db_hh, int T, int B,
                                 int H, int D, int S, int rows_per_split, int vec, int bf16,
                                 void* stream) {
  return (bf16 ? launch_dw<bf16_t, false> : launch_dw<float, false>)(
      ys, dxp, gn, part, dw_hh, db_hh, T, B, H, D, S, rows_per_split, vec, stream);
}

// The same in the walk layout (`run_layer`).
extern "C" int s2ag_gru_layer_dw_v1(const void* ys, const void* dxp, const void* gn,
                                    float* part, float* dw_hh, float* db_hh, int T, int B,
                                    int H, int D, int S, int rows_per_split, int vec,
                                    int bf16, void* stream) {
  return (bf16 ? launch_dw<bf16_t, true> : launch_dw<float, true>)(
      ys, dxp, gn, part, dw_hh, db_hh, T, B, H, D, S, rows_per_split, vec, stream);
}
