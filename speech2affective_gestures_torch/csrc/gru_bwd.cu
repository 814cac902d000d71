// Backward of one (bi)directional GRU layer: the reverse-time recurrence in
// one kernel, the recurrent weight's gradient in a second.
//
// Replaces the TPU kernel speech2affective_gestures_tpu/ops/gru_pallas.py
// ::_bwd_kernel_v2 (pallas_call in _bwd_call_v2). The forward
// (csrc/gru_fwd.cu) saved xp (input projections, no bias) and ys; for each
// direction this walks time opposite to that direction's forward walk,
// recomputes r, z, n from h_prev (the neighbouring frame of ys) and xp,
// and with dh = dys + carry:
//   dn     = dh (1 - z)          dz     = dh (h_prev - n)
//   dpre_n = dn (1 - n^2)        dpre_z = dz z (1 - z)
//   dpre_r = dpre_n (W_hn h_prev + b_hn) r (1 - r)
//   dxp    = [dpre_r, dpre_z, dpre_n]            (forward time order)
//   g      = [dpre_r, dpre_z, dpre_n r]          (gradient of h . W_hh + b_hh)
//   carry  = dh z + g . W_hh^T                   (dh of the previous step)
// and then
//   dW_hh  = sum_{t,b} h_prev^T g,   db_hh = sum_{t,b} g.
// The gradient of b_ih is sum_{t,b} dxp, which the wrapper takes with a
// plain reduction (the JAX package also sums dxp outside its kernel).
//
// Layouts (all float32, row-major, contiguous):
//   xp, dxp (T, B, D*3H)    ys, dys (T, B, D*H)    gn (T, B, D*H) = dpre_n r
//   w_hh (D, H, 3H), w_hh_t (D, 3H, H) = its transpose (the wrapper's copy)
//   b_ih, b_hh, db_hh (D, 3H)    dw_hh (D, H, 3H)
// dys already holds the gradient of h_last, added by the wrapper at the
// frame that produced each direction's final state.
//
// Kernel 1, the recurrence: one block per (batch tile, direction), the time
// loop inside the block, h_prev, the recomputed h . W_hh, g and the carry
// in shared memory. Each step makes two products with W_hh: the recompute
// h_prev . W_hh (thread j owns column j of W_hh) and g . W_hh^T (thread
// (gate, k) owns column k of the gate's rows of W_hh^T, so both read rows
// coalesced); the three gates' shares of the second product are added in a
// fixed order. Bound on the H100: at H = 300 W_hh is 1.08 MB per
// direction, five times one SM's shared memory, so each step streams it
// twice from L2 into one SM: the chain is bound by one SM's L2 bandwidth,
// as the forward kernel is. Batch tiles of 8 rows at B >= 256 read W once
// for 8 rows and keep the grid to one wave (128 blocks at B = 512, D = 2).
// At H = 64 (the discriminator) W_hh is 49 KB; it is read the same way.
//
// Kernels 2 and 3, dW_hh and db_hh: a product over the T*B rows (h_prev
// extended by a column of ones, whose row of the output is db_hh). The rows
// are cut into S consecutive splits; one block per (64 x 64 output tile,
// split) sums its split's rows in order into a partial tile, and a second
// pass adds the S partials of each output in split order: deterministic,
// no atomics. S is chosen (s2ag_gru_dw_splits) so that about four blocks
// per SM are in flight: one block per tile alone left 12 blocks for the
// card at H = 64 and 150 at H = 300, each walking all 17,408 rows with one
// stage of loads in flight. It is bound by float32 FMA throughput
// (2 T B H 3H operations); a register-tiled product, without tensor cores,
// since the sums stay in plain float32.

#include <cuda_runtime.h>

namespace {

constexpr int KCHUNK = 16;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int BT>
__global__ void __launch_bounds__(1024) gru_layer_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ w_hh,
    const float* __restrict__ w_hh_t, const float* __restrict__ b_ih,
    const float* __restrict__ b_hh, const float* __restrict__ ys,
    const float* __restrict__ dys, float* __restrict__ dxp,
    float* __restrict__ gn, int T, int B, int H, int D) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* hprev = smem;              // [BT][H]
  float* hp = hprev + BT * H;       // [BT][3H]  h_prev . W_hh + b_hh
  float* g = hp + BT * H3;          // [BT][3H]  [dpre_r, dpre_z, dpre_n r]
  float* carry = g + BT * H3;       // [BT][H]
  float* part = carry + BT * H;     // [3][BT][H] each gate's share of g . W^T

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const float* W = w_hh + (size_t)d * H * H3;
  const float* WT = w_hh_t + (size_t)d * H3 * H;
  const float* bi = b_ih + d * H3;
  const float* bh = b_hh + d * H3;
  const size_t xrow = (size_t)D * H3;   // row stride of xp / dxp
  const size_t hrow = (size_t)D * H;    // row stride of ys / dys / gn
  const int kmain = H - H % KCHUNK;

  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) carry[i] = 0.0f;

  for (int step = 0; step < T; ++step) {
    // the forward walked d = 0 ascending and d = 1 descending
    const int p = (d == 0) ? T - 1 - step : step;
    const int q = (d == 0) ? p - 1 : p + 1;   // frame of h_prev
    const bool has_prev = q >= 0 && q < T;

    for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
      const int bb = idx / H;
      const int row = b0 + bb;
      hprev[idx] = (has_prev && row < B)
          ? ys[((size_t)q * B + row) * hrow + (size_t)d * H + (idx - bb * H)]
          : 0.0f;
    }
    __syncthreads();

    // recompute hp = h_prev . W_hh + b_hh, one column j per thread and pass
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
            acc[bb] = fmaf(hprev[bb * H + k0 + kk], w[kk], acc[bb]);
        }
      }
      for (int k = kmain; k < H; ++k) {
        const float wk = __ldg(W + (size_t)k * H3 + j);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
          acc[bb] = fmaf(hprev[bb * H + k], wk, acc[bb]);
      }
      const float bj = bh[j];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) hp[bb * H3 + j] = acc[bb] + bj;
    }
    __syncthreads();

    // gates and their gradients; each (row, unit) belongs to one thread
    for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
      const int bb = idx / H;
      const int i = idx - bb * H;
      const int row = b0 + bb;
      float* gr = g + bb * H3;
      if (row >= B) {
        gr[i] = 0.0f;
        gr[H + i] = 0.0f;
        gr[2 * H + i] = 0.0f;
        carry[idx] = 0.0f;
        continue;
      }
      const size_t xo = ((size_t)p * B + row) * xrow + (size_t)d * H3;
      const size_t ho = ((size_t)p * B + row) * hrow + (size_t)d * H + i;
      const float* x = xp + xo;
      const float* hr = hp + bb * H3;
      const float r = sigmoid_f(x[i] + bi[i] + hr[i]);
      const float z = sigmoid_f(x[H + i] + bi[H + i] + hr[H + i]);
      const float hn = hr[2 * H + i];
      const float n = tanhf(x[2 * H + i] + bi[2 * H + i] + r * hn);
      const float dh = dys[ho] + carry[idx];
      const float dn = dh * (1.0f - z);
      const float dz = dh * (hprev[idx] - n);
      const float dpre_n = dn * (1.0f - n * n);
      const float dpre_z = dz * z * (1.0f - z);
      const float dpre_r = dpre_n * hn * r * (1.0f - r);
      float* dx = dxp + xo;
      dx[i] = dpre_r;
      dx[H + i] = dpre_z;
      dx[2 * H + i] = dpre_n;
      if (gn != nullptr) gn[ho] = dpre_n * r;
      gr[i] = dpre_r;
      gr[H + i] = dpre_z;
      gr[2 * H + i] = dpre_n * r;
      carry[idx] = dh * z;
    }
    __syncthreads();

    // part[gate][bb][k] = sum over the gate's rows j of g[bb][j] W^T[j][k]
    for (int idx = threadIdx.x; idx < H3; idx += blockDim.x) {
      const int gate = idx / H;
      const int k = idx - gate * H;
      const float* Wg = WT + (size_t)gate * H * H + k;
      const float* gg = g + gate * H;
      float acc[BT];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.0f;
      for (int j0 = 0; j0 < kmain; j0 += KCHUNK) {
        float w[KCHUNK];
#pragma unroll
        for (int jj = 0; jj < KCHUNK; ++jj)
          w[jj] = __ldg(Wg + (size_t)(j0 + jj) * H);
#pragma unroll
        for (int jj = 0; jj < KCHUNK; ++jj) {
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            acc[bb] = fmaf(gg[bb * H3 + j0 + jj], w[jj], acc[bb]);
        }
      }
      for (int j = kmain; j < H; ++j) {
        const float wj = __ldg(Wg + (size_t)j * H);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
          acc[bb] = fmaf(gg[bb * H3 + j], wj, acc[bb]);
      }
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) part[(gate * BT + bb) * H + k] = acc[bb];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
      const int bb = idx / H;
      const int k = idx - bb * H;
      carry[idx] = carry[idx] + part[bb * H + k] + part[(BT + bb) * H + k] +
                   part[(2 * BT + bb) * H + k];
    }
    __syncthreads();
  }
}

template <int BT>
cudaError_t launch_bwd(const float* xp, const float* w_hh, const float* w_hh_t,
                       const float* b_ih, const float* b_hh, const float* ys,
                       const float* dys, float* dxp, float* gn, int T, int B,
                       int H, int D, cudaStream_t stream) {
  const size_t smem = (size_t)BT * 11 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_layer_bwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((B + BT - 1) / BT, D);
  gru_layer_bwd_kernel<BT><<<grid, threads, smem, stream>>>(
      xp, w_hh, w_hh_t, b_ih, b_hh, ys, dys, dxp, gn, T, B, H, D);
  return cudaGetLastError();
}

// dW tile: TM rows of k (h_prev units, plus the ones row H) by TN columns
// of j (gate units), TK rows of (t, b) per shared-memory stage; 256 threads,
// each owning a 4 x 4 block of outputs strided by 16
constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;

int dw_tiles(int H, int D) {
  return ((3 * H + TN - 1) / TN) * ((H + 1 + TM - 1) / TM) * D;
}

// rows of one split: a multiple of TK
int dw_rows_per_split(int M, int S) {
  return ((M + S - 1) / S + TK - 1) / TK * TK;
}

// part (S, D, H + 1, 3H): split s's partial sums of [dW_hh; db_hh]
__global__ void __launch_bounds__(256) gru_dw_kernel(
    const float* __restrict__ ys, const float* __restrict__ dxp,
    const float* __restrict__ gn, float* __restrict__ part, int T, int B,
    int H, int D, int rows_per_split) {
  __shared__ float As[TK][TM];   // h_prev (or 1 for the bias row)
  __shared__ float Bs[TK][TN];   // g
  const int d = blockIdx.z % D;
  const int split = blockIdx.z / D;
  const int k0 = blockIdx.y * TM;
  const int j0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int H3 = 3 * H;
  const size_t xrow = (size_t)D * H3;
  const size_t hrow = (size_t)D * H;
  const int m_lo = split * rows_per_split;
  const int m_hi = min(T * B, m_lo + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  for (int m0 = m_lo; m0 < m_hi; m0 += TK) {
    for (int e = threadIdx.x; e < TK * TM; e += blockDim.x) {
      const int r = e / TM;
      const int kk = e - r * TM;
      const int m = m0 + r;
      const int k = k0 + kk;
      float a = 0.0f;
      if (m < m_hi) {
        if (k < H) {
          const int t = m / B;
          const int b = m - t * B;
          const int q = (d == 0) ? t - 1 : t + 1;
          if (q >= 0 && q < T) a = ys[((size_t)q * B + b) * hrow + (size_t)d * H + k];
        } else if (k == H) {
          a = 1.0f;
        }
      }
      As[r][kk] = a;
    }
    for (int e = threadIdx.x; e < TK * TN; e += blockDim.x) {
      const int r = e / TN;
      const int jj = e - r * TN;
      const int m = m0 + r;
      const int j = j0 + jj;
      float v = 0.0f;
      if (m < m_hi) {
        if (j < 2 * H) {
          v = dxp[(size_t)m * xrow + (size_t)d * H3 + j];
        } else if (j < H3) {
          v = gn[(size_t)m * hrow + (size_t)d * H + (j - 2 * H)];
        }
      }
      Bs[r][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TK; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[r][ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[r][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    __syncthreads();
  }

  float* out = part + ((size_t)split * D + d) * (H + 1) * H3;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < H3 && k <= H) out[(size_t)k * H3 + j] = acc[a][c];
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

}  // namespace

// The recurrence. gn may be null (no weight gradient wanted). Returns the
// CUDA error code of the launch (0 = success).
extern "C" int s2ag_gru_layer_bwd(const float* xp, const float* w_hh,
                                  const float* w_hh_t, const float* b_ih,
                                  const float* b_hh, const float* ys,
                                  const float* dys, float* dxp, float* gn,
                                  int T, int B, int H, int D, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // B = 1 gets its own instance; large batches take 8-row tiles (one wave
  // of blocks at B = 512), the rest 4-row tiles; the last tile is masked
  if (B == 1)
    return (int)launch_bwd<1>(xp, w_hh, w_hh_t, b_ih, b_hh, ys, dys, dxp, gn,
                              T, B, H, D, s);
  if (B >= 256)
    return (int)launch_bwd<8>(xp, w_hh, w_hh_t, b_ih, b_hh, ys, dys, dxp, gn,
                              T, B, H, D, s);
  return (int)launch_bwd<4>(xp, w_hh, w_hh_t, b_ih, b_hh, ys, dys, dxp, gn,
                            T, B, H, D, s);
}

// The number of row splits S of the dW reduction on a card with `sms`
// SMs: about four blocks per SM, at least 256 rows a split.
extern "C" int s2ag_gru_dw_splits(int T, int B, int H, int D, int sms) {
  const int M = T * B;
  const int tiles = dw_tiles(H, D);
  int S = (4 * sms + tiles - 1) / tiles;
  if (S > M / 256) S = M / 256;
  if (S < 1) S = 1;
  // splits that would be empty after rounding rows up to TK
  const int rows = dw_rows_per_split(M, S);
  return (M + rows - 1) / rows;
}

// dW_hh (D, H, 3H) and db_hh (D, 3H) from ys, dxp and gn, through the
// workspace part (S, D, H + 1, 3H), S from s2ag_gru_dw_splits.
extern "C" int s2ag_gru_layer_dw(const float* ys, const float* dxp,
                                 const float* gn, float* part, float* dw_hh,
                                 float* db_hh, int T, int B, int H, int D,
                                 int S, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((3 * H + TN - 1) / TN, (H + 1 + TM - 1) / TM, D * S);
  gru_dw_kernel<<<grid, 256, 0, st>>>(ys, dxp, gn, part, T, B, H, D,
                                      dw_rows_per_split(T * B, S));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)D * (H + 1) * 3 * H;
  const int blocks = (int)((n + 255) / 256);
  gru_dw_sum_kernel<<<blocks, 256, 0, st>>>(part, dw_hh, db_hh, H, D, S);
  return (int)cudaGetLastError();
}
