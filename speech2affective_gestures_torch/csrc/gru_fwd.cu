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
// Design: one block per (batch tile, direction); the time loop runs inside
// the block and h stays in shared memory. Each step, the threads own
// adjacent columns of W_hh, so every row of W is read coalesced; each
// thread keeps 16 loads of W in flight to cover L2 latency, and multiplies
// them into the BT rows of its batch tile. A __syncthreads separates the
// product from the gate update and the gate update from the next step.
//
// Bound on the H100: at H=300 W_hh is 300 x 900 float32 = 1.08 MB per
// direction, more than one SM's 227 KB of shared memory, so every step
// streams W from L2 into one SM. The kernel is bound by one SM's L2
// bandwidth, with only 2 * ceil(B / BT) blocks busy. Splitting W across a
// thread-block cluster (distributed shared memory) is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int KCHUNK = 16;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
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

template <int BT, bool WALK>
__global__ void __launch_bounds__(1024) gru_layer_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ w_hh,
    const float* __restrict__ b_ih, const float* __restrict__ b_hh,
    float* __restrict__ ys, float* __restrict__ h_last,
    int T, int B, int H, int D) {
  extern __shared__ float smem[];
  float* h = smem;            // [BT][H]
  float* hp = smem + BT * H;  // [BT][3H]

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int H3 = 3 * H;
  const float* W = w_hh + (size_t)d * H * H3;
  const float* bi = WALK ? nullptr : b_ih + d * H3;
  const float* bh = b_hh + d * H3;
  const int kmain = H - H % KCHUNK;

  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) h[i] = 0.0f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = (d == 0) ? step : T - 1 - step;

    // hp = h . W_hh + b_hh, one column j per thread and pass
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.0f;
      for (int k0 = 0; k0 < kmain; k0 += KCHUNK) {
        float w[KCHUNK];
#pragma unroll
        for (int kk = 0; kk < KCHUNK; ++kk)
          w[kk] = __ldg(W + (size_t)(k0 + kk) * H3 + j);
#pragma unroll
        for (int kk = 0; kk < KCHUNK; ++kk) {
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            acc[bb] = fmaf(h[bb * H + k0 + kk], w[kk], acc[bb]);
        }
      }
      for (int k = kmain; k < H; ++k) {
        const float wk = __ldg(W + (size_t)k * H3 + j);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) acc[bb] = fmaf(h[bb * H + k], wk, acc[bb]);
      }
      const float bj = bh[j];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) hp[bb * H3 + j] = acc[bb] + bj;
    }
    __syncthreads();

    // gates; each (row, unit) is read and written by one thread only
    for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
      const int bb = idx / H;
      const int i = idx - bb * H;
      const int row = b0 + bb;
      if (row >= B) continue;
      const float* x = xp + row_offset<WALK>(t, step, d, row, B, D, H3);
      const float* g = hp + bb * H3;
      const float xr = WALK ? x[i] : x[i] + bi[i];
      const float xz = WALK ? x[H + i] : x[H + i] + bi[H + i];
      const float xn = WALK ? x[2 * H + i] : x[2 * H + i] + bi[2 * H + i];
      const float r = sigmoid_f(xr + g[i]);
      const float z = sigmoid_f(xz + g[H + i]);
      const float n = tanhf(xn + r * g[2 * H + i]);
      const float hn = (1.0f - z) * n + z * h[idx];
      h[idx] = hn;
      ys[row_offset<WALK>(t, step, d, row, B, D, H) + i] = hn;
    }
    __syncthreads();
  }

  if (h_last == nullptr) return;  // the walk layout: h_last is ys[T - 1]
  for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
    const int bb = idx / H;
    const int row = b0 + bb;
    if (row < B) h_last[((size_t)d * B + row) * H + (idx - bb * H)] = h[idx];
  }
}

template <int BT, bool WALK>
cudaError_t launch(const float* xp, const float* w_hh, const float* b_ih,
                   const float* b_hh, float* ys, float* h_last, int T, int B,
                   int H, int D, cudaStream_t stream) {
  const size_t smem = (size_t)BT * 4 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_layer_fwd_kernel<BT, WALK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((B + BT - 1) / BT, D);
  gru_layer_fwd_kernel<BT, WALK><<<grid, threads, smem, stream>>>(
      xp, w_hh, b_ih, b_hh, ys, h_last, T, B, H, D);
  return cudaGetLastError();
}

template <bool WALK>
int launch_tiles(const float* xp, const float* w_hh, const float* b_ih,
                 const float* b_hh, float* ys, float* h_last, int T, int B, int H,
                 int D, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // B = 1 (one /synthesize request) gets its own instance; any other B runs
  // tiles of 4 rows, the last tile masked
  if (B == 1) return (int)launch<1, WALK>(xp, w_hh, b_ih, b_hh, ys, h_last, T, B, H, D, s);
  return (int)launch<4, WALK>(xp, w_hh, b_ih, b_hh, ys, h_last, T, B, H, D, s);
}

}  // namespace

// The model layout. Returns the CUDA error code of the launch (0 = success).
extern "C" int s2ag_gru_layer_fwd(const float* xp, const float* w_hh,
                                  const float* b_ih, const float* b_hh,
                                  float* ys, float* h_last, int T, int B,
                                  int H, int D, void* stream) {
  return launch_tiles<false>(xp, w_hh, b_ih, b_hh, ys, h_last, T, B, H, D, stream);
}

// The walk layout (`run_layer`): xp (T, D, B, 3H) with b_ih folded in,
// ys (T, D, B, H); no h_last (it is ys[T - 1]).
extern "C" int s2ag_gru_layer_fwd_v1(const float* xp, const float* w_hh,
                                     const float* b_hh, float* ys, int T, int B,
                                     int H, int D, void* stream) {
  return launch_tiles<true>(xp, w_hh, nullptr, b_hh, ys, nullptr, T, B, H, D, stream);
}
