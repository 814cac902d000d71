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
// float32, row-major, contiguous):
//   model layout (WALK = false, `s2ag_gru_layer_fwd`, the layers' engine):
//     xp (T, B, D*3H) no bias, no time flip; ys (T, B, D*H) both directions
//     in forward time order (the reverse direction walks time backwards);
//     h_last (D, B, H)
//   walk layout (WALK = true, `s2ag_gru_layer_fwd_v1`, `run_layer`'s
//     contract): xp (T, D, B, 3H) with b_ih already added and direction 1
//     already time-reversed by the caller; ys (T, D, B, H) in each
//     direction's walk order; step s reads and writes row s, no b_ih
//   w_hh (D, H, 3H) = torch weight_hh_l{k}[_reverse] transposed
//   b_ih (D, 3H) (model layout only), b_hh (D, 3H)
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
// The launch plan (S, KC, C, U, BT, the threads and the shared-memory
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

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

// threads a block may have for a chunk of KC (`gru_cuda._max_threads`
// plans with the same table): the 3 KC registers of W and ~40 others per
// thread within the SM's 65,536
__host__ __device__ constexpr int max_threads(int KC) {
  return KC >= 40 ? 320 : KC >= 32 ? 384 : 512;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __frcp_rn(1.0f + expf(-x));  // the same bits as 1.0f / (...)
}

// offset of (step, direction d, batch row) in a tensor of C values per
// row: the step's frame t in the model layout, the walk's row in the walk
// layout
template <bool WALK>
__device__ __forceinline__ size_t row_offset(int t, int step, int d, int row,
                                             int B, int D, int C) {
  return WALK ? (((size_t)step * D + d) * B + row) * C
              : ((size_t)t * B + row) * D * C + (size_t)d * C;
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
// tot. The S lanes' chunk sums are added by a reduce-scatter in log2 S
// halvings: in each, a lane keeps the half of its rows whose bit matches its
// own and adds the partner's sums of them to its own. The first halving
// runs as each pair of rows (i, i + S/2) is computed, so that at most S/2
// rows' sums are live. A group of one row (the last of a tile) is added by
// a butterfly instead, which every lane of the unit ends with. Either way a
// fixed order: the same inputs give the same bits.
template <int S, int KC>
__device__ __forceinline__ void group_totals(const float* hg, int rows, int s,
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

template <int S, int KC, bool WALK>
__global__ void __launch_bounds__(max_threads(KC), 1) gru_layer_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ w_hh,
    const float* __restrict__ b_ih, const float* __restrict__ b_hh,
    float* __restrict__ ys, float* __restrict__ h_last,
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
    const float* W = w_hh + (size_t)d * H * H3 + j;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int k = s * KC + i;
      const bool ok = active && k < H;
      wr[i] = ok ? __ldg(W + (size_t)k * H3) : 0.0f;
      wz[i] = ok ? __ldg(W + (size_t)k * H3 + H) : 0.0f;
      wn[i] = ok ? __ldg(W + (size_t)k * H3 + 2 * H) : 0.0f;
    }
  }
  float bhr = 0.0f, bhz = 0.0f, bhn = 0.0f, bir = 0.0f, biz = 0.0f, bin = 0.0f;
  if (active) {
    const float* bh = b_hh + (size_t)d * H3;
    bhr = bh[j];
    bhz = bh[H + j];
    bhn = bh[2 * H + j];
    if (!WALK) {
      const float* bi = b_ih + (size_t)d * H3;
      bir = bi[j];
      biz = bi[H + j];
      bin = bi[2 * H + j];
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
        const float* x = xp + row_offset<WALK>(t, step, d, b0 + row, B, D, H3) + j;
        xr = __ldg(x);
        xz = __ldg(x + H);
        xn = __ldg(x + 2 * H);
      }
      PHASE_AT(q_product);
      float hp[3];  // the totals of row g0 + s
      group_totals<S, KC>(hc + g0 * RS + s * KS, min(S, nrows - g0), s, wr, wz, wn, hp);
      PHASE_AT(q_gate);
      PHASE_ADD(0, q_product, q_gate);
      float hnew = 0.0f;  // 0 past H, where h must stay 0
      if (mine) {
        const float r = sigmoid_f((WALK ? xr : xr + bir) + (hp[0] + bhr));
        const float z = sigmoid_f((WALK ? xz : xz + biz) + (hp[1] + bhz));
        const float n = tanhf((WALK ? xn : xn + bin) + r * (hp[2] + bhn));
        hnew = (1.0f - z) * n + z * hc[row * RS + hpos];
        ys[row_offset<WALK>(t, step, d, b0 + row, B, D, H) + j] = hnew;
        if (h_last != nullptr && step == T - 1)
          h_last[((size_t)d * B + b0 + row) * H + j] = hnew;
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

// The card's most shared memory a block may opt into (227 KB on the H100):
// the cap set for every configuration, so that no launch lowers another's.
cudaError_t set_smem_cap(const void* kernel) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  return err;
}

// a launch of clusters of C blocks along x (not copyable: cfg points at attr)
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int C, dim3 grid, int threads, int smem, cudaStream_t stream) : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// The attributes and the schedulability check of one (instance, C, smem,
// threads) configuration are done at its first launch; later launches reuse
// the answer. A configuration of which no cluster fits on the card is an
// error.
struct Checked {
  const void* kernel;
  int C, smem, threads, err;
};
std::mutex checked_mutex;
Checked checked[128];
int n_checked = 0;

template <typename K>
cudaError_t check_config(K kernel, const ClusterLaunch& launch) {
  const int C = (int)launch.attr[0].val.clusterDim.x;
  const int smem = (int)launch.cfg.dynamicSmemBytes;
  const int threads = (int)launch.cfg.blockDim.x;
  std::lock_guard<std::mutex> lock(checked_mutex);
  for (int i = 0; i < n_checked; ++i)
    if (checked[i].kernel == (const void*)kernel && checked[i].C == C &&
        checked[i].smem == smem && checked[i].threads == threads)
      return (cudaError_t)checked[i].err;
  cudaError_t err = set_smem_cap((const void*)kernel);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
  if (n_checked < 128) checked[n_checked++] = {(const void*)kernel, C, smem, threads, (int)err};
  return err;
}

template <int S, int KC, bool WALK>
cudaError_t launch_kc(const float* xp, const float* w_hh, const float* b_ih,
                      const float* b_hh, float* ys, float* h_last, int T, int B, int H,
                      int D, int C, int BT, int U, int threads, int smem,
                      cudaStream_t stream) {
  // what the kernel's indexing needs of a plan: every k in a chunk, every
  // unit in a block (U whole float4s), every unit's S lanes in whole warps,
  // and both h buffers of BT rows of S chunks of KC + 4 floats
  if (S * KC < H || (long long)C * U < H || U % 4 || threads < U * S || threads % 32 ||
      smem < 4 * 2 * BT * S * (KC + 4))
    return cudaErrorInvalidValue;
  const ClusterLaunch launch(C, dim3(C * ((B + BT - 1) / BT), D), threads, smem, stream);
  auto kernel = gru_layer_fwd_kernel<S, KC, WALK>;
  cudaError_t err = check_config(kernel, launch);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&launch.cfg, kernel, xp, w_hh, b_ih, b_hh, ys, h_last, T, B,
                           H, D, U, BT);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the (S, KC) instances: S = 2 up to H 80, 4 up to 160, 8 up to 320;
// KC = ceil(H / S) rounded up to 8
#define S2AG_FWD_INSTANCES                                                     \
  S2AG_FWD(2, 8) S2AG_FWD(2, 16) S2AG_FWD(2, 24) S2AG_FWD(2, 32) S2AG_FWD(2, 40) \
  S2AG_FWD(4, 24) S2AG_FWD(4, 32) S2AG_FWD(4, 40)                              \
  S2AG_FWD(8, 24) S2AG_FWD(8, 32) S2AG_FWD(8, 40)

template <bool WALK>
int launch(const float* xp, const float* w_hh, const float* b_ih, const float* b_hh,
           float* ys, float* h_last, int T, int B, int H, int D, int C, int BT, int S,
           int KC, int U, int threads, int smem, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || C < 1 || BT < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S2AG_FWD(SS, KK)                                                                \
  if (S == SS && KC == KK)                                                              \
    return (int)launch_kc<SS, KK, WALK>(xp, w_hh, b_ih, b_hh, ys, h_last, T, B, H, D, C, \
                                        BT, U, threads, smem, st);
  S2AG_FWD_INSTANCES
#undef S2AG_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The model layout. (C, BT, S, KC, U, threads, smem) is the caller's
// launch plan. Returns the CUDA error code of the launch (0 = success).
extern "C" int s2ag_gru_layer_fwd(const float* xp, const float* w_hh,
                                  const float* b_ih, const float* b_hh,
                                  float* ys, float* h_last, int T, int B,
                                  int H, int D, int C, int BT, int S, int KC, int U,
                                  int threads, int smem, void* stream) {
  return launch<false>(xp, w_hh, b_ih, b_hh, ys, h_last, T, B, H, D, C, BT, S, KC, U,
                       threads, smem, stream);
}

// The walk layout (`run_layer`): xp (T, D, B, 3H) with b_ih folded in,
// ys (T, D, B, H); no h_last (it is ys[T - 1]).
extern "C" int s2ag_gru_layer_fwd_v1(const float* xp, const float* w_hh,
                                     const float* b_hh, float* ys, int T, int B,
                                     int H, int D, int C, int BT, int S, int KC, int U,
                                     int threads, int smem, void* stream) {
  return launch<true>(xp, w_hh, nullptr, b_hh, ys, nullptr, T, B, H, D, C, BT, S, KC, U,
                      threads, smem, stream);
}

// How many clusters of C blocks of the (S, KC) instance, each block taking
// `threads` threads and `smem` bytes of shared memory, the current device
// runs at once (0 when none fits), or minus the CUDA error code. The launch
// plan spreads the batch over about this many.
extern "C" int s2ag_gru_fwd_max_clusters(int S, int KC, int C, int threads, int smem) {
  int clusters = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define S2AG_FWD(SS, KK)                                                                  \
  if (S == SS && KC == KK) {                                                              \
    auto kernel = gru_layer_fwd_kernel<SS, KK, false>;                                    \
    const ClusterLaunch launch(C, dim3(C), threads, smem, nullptr);                       \
    err = set_smem_cap((const void*)kernel);                                              \
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg); \
  }
  S2AG_FWD_INSTANCES
#undef S2AG_FWD
  return err == cudaSuccess ? clusters : -(int)err;
}
