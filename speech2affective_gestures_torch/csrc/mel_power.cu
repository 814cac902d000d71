// Fused mel power spectrum: mel = |rfft(F)|^2 . M, one launch.
//
// Replaces the TPU kernel speech2affective_gestures_tpu/ops/dsp_pallas.py
// ::_mel_kernel (pallas_call in fused_mel_power_frames). F are Hann-windowed
// frames, M the Slaney mel filterbank. The TPU kernel computes the spectrum
// as two dense products with the real-DFT matrices, a fit for its matrix
// unit; here that would be ~137x an FFT's operations and a read of both
// matrices (17 MB at n_fft 2048) per row tile, so the spectrum is an FFT.
//
// Layouts (float32 unless said, row-major, contiguous):
//   frames (R, N)            N = n_fft, a power of two in [512, 4096]
//   fft_tw (M) float2        e^{-2 pi i k / M}, M = N / 2
//   split_tw (M/2 + 1) float2  (cos, sin) of 2 pi k / N
//   bands (NMEL, 3) int      each band's first bin, bin count, weight offset
//   weights                  each band's run of filterbank entries
//   out (R, NMEL)
//
// Design: one block of 256 threads owns 2048 / M whole rows (2 at N 2048,
// 4 at N 1024), so a request's few hundred rows still give a block per SM.
// For each row the block
//   1. loads the row with float4 reads into shared memory as the M-point
//      complex sequence z[n] = x[2n] + i x[2n+1];
//   2. runs a Stockham (autosort) FFT over two shared-memory buffers: one
//      radix-2 pass when log2 M is odd, then radix-4 passes;
//   3. splits Z into the real FFT's bins, X[k] = (Z[k] + Z*[M-k]) / 2
//      - i e^{-2 pi i k / N} (Z[k] - Z*[M-k]) / 2 (Z[M] = Z[0]; the DC and
//      Nyquist bins are Re Z[0] +- Im Z[0]), one thread per pair (k, M-k),
//      and keeps the power |X[k]|^2 in the free buffer;
//   4. sums each mel band over its own contiguous run of bins (a bin lies in
//      at most two bands; ~2000 products per row at N 2048), in bin order,
//      so the result is deterministic.
// Plain float32 throughout; an FFT's roundoff grows like log N, where the
// dense DFT's grows like sqrt N.
//
// Bound on the H100: one read of the frames (4.65 MB at R 568, N 2048:
// 1.4 us at 3.35 TB/s); the FFT's ~5 (N/2) log2 N operations per row are
// far below the float32 rate. What bounds this kernel is its block's chain
// of shared-memory passes, each behind a __syncthreads, with 8 to 16 rows'
// worth of blocks per SM.

#include <cuda_runtime.h>

namespace {

constexpr int NMEL = 128;       // mel bands
constexpr int THREADS = 256;
constexpr int POINTS = 2048;    // complex points per block: rows x M

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// |X[k]|^2 from A = Z[k], B = conj(Z[M-k]) and (c, s) = (cos, sin) of 2 pi k / N:
// X = E + (-s - i c) D with E = (A + B) / 2, D = (A - B) / 2
__device__ __forceinline__ float bin_power(float2 a, float2 b, float c, float s) {
  const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y + b.y);
  const float dr = 0.5f * (a.x - b.x), di = 0.5f * (a.y - b.y);
  const float xr = er - s * dr + c * di;
  const float xi = ei - s * di - c * dr;
  return xr * xr + xi * xi;
}

__global__ void __launch_bounds__(THREADS) mel_fft_kernel(
    const float* __restrict__ frames, const float2* __restrict__ fft_tw,
    const float2* __restrict__ split_tw, const int* __restrict__ bands,
    const float* __restrict__ weights, float* __restrict__ out, int R, int log2m) {
  __shared__ __align__(16) float2 buf[2][POINTS];
  const int M = 1 << log2m;
  const int rows = POINTS >> log2m;
  const int r0 = blockIdx.x * rows;
  const int tid = threadIdx.x;

  // 1. the block's rows, two complex points per float4; missing rows of the
  // last block load zeros
  {
    const float4* src = reinterpret_cast<const float4*>(frames + (size_t)r0 * 2 * M);
    float4* dst = reinterpret_cast<float4*>(buf[0]);
    const int valid = min(rows, R - r0) * (M / 2);
    for (int q = tid; q < POINTS / 2; q += THREADS)
      dst[q] = q < valid ? __ldg(src + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // 2. Stockham passes: butterfly j of a radix-p pass after Ns points reads
  // in[j + r M/p], twiddles by e^{-2 pi i r (j mod Ns) / (Ns p)} and writes
  // out[(j - j mod Ns) p + j mod Ns + r Ns]
  int cur = 0;
  int ns = 1;
  if (log2m & 1) {  // the radix-2 pass, Ns = 1: no twiddles
    __syncthreads();
    const int half = M / 2;
    for (int b = tid; b < POINTS / 2; b += THREADS) {
      const int base = (b >> (log2m - 1)) << log2m;
      const int j = b & (half - 1);
      const float2 v0 = buf[0][base + j], v1 = buf[0][base + j + half];
      buf[1][base + 2 * j] = make_float2(v0.x + v1.x, v0.y + v1.y);
      buf[1][base + 2 * j + 1] = make_float2(v0.x - v1.x, v0.y - v1.y);
    }
    cur = 1;
    ns = 2;
  }
  const int q4 = M / 4;
  for (; ns < M; ns *= 4) {
    __syncthreads();
    const float2* in = buf[cur];
    float2* o = buf[cur ^ 1];
    const int stride = M / (4 * ns);  // twiddle index step
    for (int b = tid; b < POINTS / 4; b += THREADS) {
      const int base = (b >> (log2m - 2)) << log2m;
      const int j = b & (q4 - 1);
      float2 v0 = in[base + j], v1 = in[base + j + q4];
      float2 v2 = in[base + j + 2 * q4], v3 = in[base + j + 3 * q4];
      const int jm = j & (ns - 1);
      if (jm) {
        const int e = jm * stride;
        v1 = cmul(v1, __ldg(fft_tw + e));
        v2 = cmul(v2, __ldg(fft_tw + 2 * e));
        v3 = cmul(v3, __ldg(fft_tw + 3 * e));
      }
      const float2 a = make_float2(v0.x + v2.x, v0.y + v2.y);
      const float2 s = make_float2(v0.x - v2.x, v0.y - v2.y);
      const float2 c = make_float2(v1.x + v3.x, v1.y + v3.y);
      const float2 d = make_float2(v1.x - v3.x, v1.y - v3.y);
      const int od = base + (j - jm) * 4 + jm;
      o[od] = make_float2(a.x + c.x, a.y + c.y);
      o[od + ns] = make_float2(s.x + d.y, s.y - d.x);       // s - i d
      o[od + 2 * ns] = make_float2(a.x - c.x, a.y - c.y);
      o[od + 3 * ns] = make_float2(s.x - d.y, s.y + d.x);   // s + i d
    }
    cur ^= 1;
  }
  __syncthreads();

  // 3. split and power: row r's M + 1 bins at p[r (M + 1) ..] of the free
  // buffer (rows (M + 1) <= 2 POINTS floats)
  float* p = reinterpret_cast<float*>(buf[cur ^ 1]);
  {
    const int pairs = M / 2 + 1;
    for (int b = tid; b < rows * pairs; b += THREADS) {
      const int row = b / pairs;
      const int k = b - row * pairs;
      const float2* z = buf[cur] + row * M;
      float* pr = p + row * (M + 1);
      if (k == 0) {
        const float2 z0 = z[0];
        const float dc = z0.x + z0.y, ny = z0.x - z0.y;
        pr[0] = dc * dc;
        pr[M] = ny * ny;
        continue;
      }
      const float2 a = z[k], b2 = z[M - k];
      const float2 tw = __ldg(split_tw + k);
      pr[k] = bin_power(a, make_float2(b2.x, -b2.y), tw.x, tw.y);
      if (k != M - k) pr[M - k] = bin_power(b2, make_float2(a.x, -a.y), -tw.x, tw.y);
    }
  }
  __syncthreads();

  // 4. each (row, band): its run of bins in order
  for (int idx = tid; idx < rows * NMEL; idx += THREADS) {
    const int row = idx / NMEL;
    const int m = idx - row * NMEL;
    if (r0 + row >= R) break;
    const float* pr = p + row * (M + 1) + __ldg(bands + 3 * m);
    const int n = __ldg(bands + 3 * m + 1);
    const float* w = weights + __ldg(bands + 3 * m + 2);
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc = fmaf(__ldg(w + i), pr[i], acc);
    out[(size_t)(r0 + row) * NMEL + m] = acc;
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 = success).
extern "C" int s2ag_mel_power(const float* frames, const float* fft_tw,
                              const float* split_tw, const int* bands,
                              const float* weights, float* out, int R, int n_fft,
                              void* stream) {
  int log2m = -1;
  for (int m = n_fft / 2; m > 0; m >>= 1) ++log2m;
  if (R < 1 || n_fft < 512 || n_fft > 2 * POINTS || (n_fft & (n_fft - 1)))
    return (int)cudaErrorInvalidValue;
  const int rows = POINTS >> log2m;
  mel_fft_kernel<<<(R + rows - 1) / rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, reinterpret_cast<const float2*>(fft_tw),
      reinterpret_cast<const float2*>(split_tw), bands, weights, out, R, log2m);
  return (int)cudaGetLastError();
}
