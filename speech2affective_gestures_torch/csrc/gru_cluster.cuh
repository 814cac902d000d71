// What the GRU forward (gru_fwd.cu) and the GRU backward recurrence
// (gru_bwd.cu) share: the cell's sigmoid, the two layouts' row offsets, the
// fixed-order warp reduction of a row group's chunk sums, and the launch of
// a thread-block cluster with its one-time schedulability check.
//
// Both kernels run one cluster of C blocks per (batch tile, direction);
// block c owns hidden units [cU, (c+1)U), and S neighbouring lanes of a
// warp share a unit (the recurrence: a pair of units), lane s holding
// chunk s of KC consecutive values. Two tiers of where W_hh lives, chosen by
// the launch plan (`gru_cuda.fwd_shape`, `gru_cuda.bwd_shape`):
//   registers (H <= 320): each thread keeps its chunk of W_hh in registers
//     for the whole launch (template parameter KC);
//   L2 (KC == 0 in the template, the chunk a runtime value, S = L2_S):
//     each thread reads its W values from device memory (L2-resident: a
//     block's slice is 1/C of W_hh) once per group of S rows, and the block
//     walks its units in passes.
// The forward's bf16 instance has a third, the tensor tier (H <= 320,
// gru_fwd.cu): W_hh as tensor-core operand fragments in registers, h bf16
// in shared memory, the product on the tensor cores.
// Every other sum is plain float32 FMA in a fixed order; all of them give
// the same bits for the same inputs.
//
// Storage types: every kernel has a float and a bf16 (__nv_bfloat16)
// instance, chosen by the tensors' dtype. A bf16 value is widened to float
// when it is loaded and the arithmetic is float, so a product of two bf16
// values is exact and the FMA chains (or the tensor cores' float32
// accumulation) are the TPU kernels' f32-accumulated products
// (`preferred_element_type=jnp.float32`); a value is rounded to
// bf16 (to nearest even) where the TPU kernel stores it at the input's
// dtype. The float instance rounds nowhere (`rounded<float>` is the
// identity).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

// the L2 tier's lanes a unit (a pair of units in the recurrence)
constexpr int L2_S = 8;

using bf16_t = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16_t x) { return __bfloat162float(x); }
template <typename V>
__device__ __forceinline__ V narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_t narrow<bf16_t>(float x) { return __float2bfloat16_rn(x); }
// x as the storage type V holds it, widened back
template <typename V>
__device__ __forceinline__ float rounded(float x) { return widen(narrow<V>(x)); }
// a read-only value of the storage type, widened
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16_t* p) {
  return widen(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __frcp_rn(1.0f + expf(-x));  // the same bits as 1.0f / (...)
}

// offset of (step, direction d, batch row) in a tensor of C values per
// row: frame t in the model layout (T, B, D*C), the walk's row `step` in
// the walk layout (T, D, B, C)
template <bool WALK>
__device__ __forceinline__ size_t row_offset(int t, int step, int d, int row, int B,
                                             int D, int C) {
  return WALK ? (((size_t)step * D + d) * B + row) * C
              : ((size_t)t * B + row) * D * C + (size_t)d * C;
}

// The totals of a group of `rows` rows: lane s ends with those of row s in
// tot. sums(i, out) gives this lane's chunk sums of row i. The S lanes'
// sums are added by a reduce-scatter in log2 S halvings: in each, a lane
// keeps the half of its rows whose bit matches its own and adds the
// partner's sums of them to its own. The first halving runs as each pair
// of rows (i, i + S/2) is computed, so that at most S/2 rows' sums are
// live. A group of one row (the last of a tile) is added by a butterfly
// instead, which every lane of the unit ends with.
template <int S, int NV, typename Sums>
__device__ __forceinline__ void group_totals(int rows, int s, Sums sums, float (&tot)[NV]) {
  if (rows == 1) {
    sums(0, tot);
#pragma unroll
    for (int off = 1; off < S; off <<= 1)
#pragma unroll
      for (int g = 0; g < NV; ++g) tot[g] += __shfl_xor_sync(0xffffffffu, tot[g], off);
    return;
  }
  constexpr int M = S / 2;
  float v[M][NV];
  const bool upper = s & M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float lo[NV], hi[NV];
#pragma unroll
    for (int g = 0; g < NV; ++g) lo[g] = hi[g] = 0.0f;
    if (i < rows) sums(i, lo);  // uniform branches
    if (i + M < rows) sums(i + M, hi);
#pragma unroll
    for (int g = 0; g < NV; ++g)
      v[i][g] = (upper ? hi[g] : lo[g]) + __shfl_xor_sync(0xffffffffu, upper ? lo[g] : hi[g], M);
  }
#pragma unroll
  for (int half = M / 2; half >= 1; half /= 2) {
    const bool up = s & half;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const float keep = up ? v[i + half][g] : v[i][g];
        const float send = up ? v[i][g] : v[i + half][g];
        v[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, half);
      }
  }
#pragma unroll
  for (int g = 0; g < NV; ++g) tot[g] = v[0][g];
}

// The same totals, in the same order, from the chunk sums of all the
// group's rows at once (the L2 tier computes them together, so that each W
// value read serves S rows); rows past `rows` hold zeros.
template <int S, int NV>
__device__ __forceinline__ void group_totals_of(float (&acc)[S][NV], int rows, int s,
                                                float (&tot)[NV]) {
  group_totals<S, NV>(rows, s, [&](int i, float (&out)[NV]) {
#pragma unroll
    for (int g = 0; g < NV; ++g) out[g] = acc[i][g];
  }, tot);
}

// The tensor cores' bf16 product with float32 accumulation (mma.sync
// m16n8k16) and its operand loads from shared memory (ldmatrix), used by the
// bf16 forward's tensor tier (gru_fwd.cu) and the bf16 dW product
// (gru_bwd.cu). Fragments of lane l (g = l / 4, c = l % 4), two bf16 values
// a register, the first in the low 16 bits:
//   A (16 x 16): a0 = A[g][2c, 2c+1], a1 = A[g+8][2c, 2c+1],
//                a2 = A[g][2c+8, 2c+9], a3 = A[g+8][2c+8, 2c+9]
//   B (16 x 8):  b0 = B[2c, 2c+1][g], b1 = B[2c+8, 2c+9][g]
//   C (16 x 8, float): c0, c1 = C[g][2c, 2c+1], c2, c3 = C[g+8][2c, 2c+1]
// The products of two bf16 values are exact; the hardware adds them in a
// fixed order, so the same inputs give the same bits.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of matrix i's 8 rows (16 bytes each, 16-byte aligned); lane l
// receives in r[i] matrix i's row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1
// or, with TRANS, its rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}
// the raw bits of a bf16 value in device memory
__device__ __forceinline__ unsigned short bits_of(const bf16_t* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float from_bits(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// The card's most shared memory a block may opt into (227 KB on the H100):
// the cap set for every configuration, so that no launch lowers another's.
inline cudaError_t set_smem_cap(const void* kernel) {
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

// How many clusters of the launch's shape the current device runs at once
// (0 when none fits), after the shared-memory cap is set.
template <typename K>
cudaError_t max_active_clusters(K kernel, const ClusterLaunch& launch, int* clusters) {
  cudaError_t err = set_smem_cap((const void*)kernel);
  *clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg);
  return err;
}

// The attributes and the schedulability check of one (instance, C, smem,
// threads) configuration are done at its first launch; later launches reuse
// the answer. A configuration of which no cluster fits on the card is an
// error.
struct Checked {
  const void* kernel;
  int C, smem, threads, err;
};
std::mutex checked_mutex;
Checked checked[256];
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
  int clusters = 0;
  cudaError_t err = max_active_clusters(kernel, launch, &clusters);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
  if (n_checked < 256) checked[n_checked++] = {(const void*)kernel, C, smem, threads, (int)err};
  return err;
}

}  // namespace
