// Fused mel power spectrum: mel = ((F . C)^2 + (F . S)^2) . M.
//
// Replaces the TPU kernel speech2affective_gestures_tpu/ops/dsp_pallas.py
// ::_mel_kernel (pallas_call in fused_mel_power_frames). F are Hann-windowed
// frames, C and S the real-DFT cosine and sine matrices, M the Slaney mel
// filterbank. The power spectrum never reaches device memory.
//
// Layouts (float32, row-major, contiguous):
//   frames (R, n_fft)       n_fft a multiple of KT
//   cosm, sinm (n_fft, nbp) bins zero-padded to nbp, a multiple of NBC
//   melm (nbp, NMEL)        zero rows on the padded bins
//   part (nbp / NBC, R, NMEL) workspace: one partial mel sum per bin chunk
//   out (R, NMEL)
//
// Design: two passes. Pass 1 runs one block per (tile of TR rows, chunk of
// NBC bins), so that even a few hundred rows spread over the whole card.
// The block accumulates re and im over K = n_fft through shared-memory
// tiles of KT, each thread holding 4 rows x 4 bins of re and of im in
// registers, with plain float32 FMA (no TF32), which matches the JAX
// package's Precision.HIGHEST products; the next tile's loads are issued
// into registers before the current tile is multiplied. It then squares,
// parks the chunk's power in shared memory and writes power . M_chunk, the
// chunk's (TR x NMEL) share of the mel sum, to `part`. Pass 2 adds the
// chunks' shares in a fixed order, so the result is deterministic. The
// ragged last row tile is masked: its missing rows load zeros and are not
// stored.
//
// Bound on the H100: the function itself needs an FFT's operations and one
// read of the frames, so its least time is that of the frame bytes. This
// kernel does the dense DFT instead, about 8.4 MFLOP per row, as the TPU
// kernel does, and is bound by the float32 FMA rate and by the reads of C
// and S from L2 (all of C and S once per row tile).

#include <cuda_runtime.h>

namespace {

constexpr int TR = 32;     // rows per block
constexpr int NBC = 32;    // bins per chunk, one chunk per blockIdx.y
constexpr int KT = 32;     // depth of one shared-memory tile
constexpr int NMEL = 128;  // mel bands
constexpr int THREADS = (TR / 4) * (NBC / 4);  // 4 rows x 4 bins each
constexpr int FQ = TR * KT / 4 / THREADS;      // frame float4 per thread
constexpr int CQ = KT * NBC / 4 / THREADS;     // cos (and sin) float4 per thread
constexpr int MPT = TR * NMEL / THREADS;       // mel sums per thread
static_assert(FQ * THREADS * 4 == TR * KT && CQ * THREADS * 4 == KT * NBC &&
              MPT % 4 == 0 && NMEL % MPT == 0, "tile shapes");

__global__ void __launch_bounds__(THREADS) mel_chunk_kernel(
    const float* __restrict__ frames, const float* __restrict__ cosm,
    const float* __restrict__ sinm, const float* __restrict__ melm,
    float* __restrict__ part, int R, int n_fft, int nbp) {
  __shared__ __align__(16) float fs[KT][TR];   // frames tile, k-major
  __shared__ __align__(16) float cs[KT][NBC];
  __shared__ __align__(16) float ss[KT][NBC];
  __shared__ float ps[TR][NBC + 1];            // power of the chunk

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TR;
  const int c0 = blockIdx.y * NBC;
  // DFT stage: rows 4*ty .. 4*ty+3 and bins 4*tx .. 4*tx+3 of the chunk
  const int ty = tid / (NBC / 4);
  const int tx = tid % (NBC / 4);

  // global -> register staging of one k tile: FQ float4 of frames (lane =
  // row, so the transposed store to fs is free of bank conflicts) and CQ
  // float4 each of cos and sin
  float4 fv[FQ], cv4[CQ], sv4[CQ];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int idx = q * THREADS + tid;
      const int row = idx % TR;
      const int kq = (idx / TR) * 4;
      fv[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r0 + row < R)
        fv[q] = __ldg(reinterpret_cast<const float4*>(
            frames + (size_t)(r0 + row) * n_fft + k0 + kq));
    }
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int e = (q * THREADS + tid) * 4;
      const size_t g = (size_t)(k0 + e / NBC) * nbp + c0 + e % NBC;
      cv4[q] = __ldg(reinterpret_cast<const float4*>(cosm + g));
      sv4[q] = __ldg(reinterpret_cast<const float4*>(sinm + g));
    }
  };

  float re[4][4], im[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) re[a][b] = im[a][b] = 0.0f;

  load_tile(0);
  for (int k0 = 0; k0 < n_fft; k0 += KT) {
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int idx = q * THREADS + tid;
      const int row = idx % TR;
      const int kq = (idx / TR) * 4;
      fs[kq + 0][row] = fv[q].x;
      fs[kq + 1][row] = fv[q].y;
      fs[kq + 2][row] = fv[q].z;
      fs[kq + 3][row] = fv[q].w;
    }
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int e = (q * THREADS + tid) * 4;
      *reinterpret_cast<float4*>(&cs[e / NBC][e % NBC]) = cv4[q];
      *reinterpret_cast<float4*>(&ss[e / NBC][e % NBC]) = sv4[q];
    }
    __syncthreads();
    if (k0 + KT < n_fft) load_tile(k0 + KT);
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float4 f = *reinterpret_cast<const float4*>(&fs[kk][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&cs[kk][4 * tx]);
      const float4 s = *reinterpret_cast<const float4*>(&ss[kk][4 * tx]);
      const float fr[4] = {f.x, f.y, f.z, f.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          re[a][b] = fmaf(fr[a], cv[b], re[a][b]);
          im[a][b] = fmaf(fr[a], sv[b], im[a][b]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      ps[4 * ty + a][4 * tx + b] = re[a][b] * re[a][b] + im[a][b] * im[a][b];
  __syncthreads();

  // mel stage: row mrow, mel bands m0 .. m0+MPT-1
  const int mrow = tid / (NMEL / MPT);
  const int m0 = (tid % (NMEL / MPT)) * MPT;
  float acc[MPT];
#pragma unroll
  for (int m = 0; m < MPT; ++m) acc[m] = 0.0f;
  const float* mchunk = melm + (size_t)c0 * NMEL + m0;
  for (int b = 0; b < NBC; ++b) {
    const float p = ps[mrow][b];
    const float4* mv = reinterpret_cast<const float4*>(mchunk + (size_t)b * NMEL);
#pragma unroll
    for (int q = 0; q < MPT / 4; ++q) {
      const float4 m = __ldg(mv + q);
      acc[4 * q + 0] = fmaf(p, m.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(p, m.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(p, m.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(p, m.w, acc[4 * q + 3]);
    }
  }
  if (r0 + mrow < R) {
    float4* o = reinterpret_cast<float4*>(
        part + ((size_t)blockIdx.y * R + r0 + mrow) * NMEL + m0);
#pragma unroll
    for (int q = 0; q < MPT / 4; ++q)
      o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// out[i] = sum over chunks c, in order, of part[c][i]
__global__ void mel_sum_kernel(const float* __restrict__ part,
                               float* __restrict__ out, int n, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
  out[i] = s;
}

}  // namespace

// Returns the CUDA error code of the launches (0 = success).
extern "C" int s2ag_mel_power(const float* frames, const float* cosm,
                              const float* sinm, const float* melm,
                              float* part, float* out, int R, int n_fft,
                              int nbp, int n_mels, void* stream) {
  if (R < 1 || n_fft % KT != 0 || nbp % NBC != 0 || n_mels != NMEL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = nbp / NBC;
  mel_chunk_kernel<<<dim3((R + TR - 1) / TR, chunks), THREADS, 0, s>>>(
      frames, cosm, sinm, melm, part, R, n_fft, nbp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = R * NMEL;
  mel_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, out, n, chunks);
  return (int)cudaGetLastError();
}
