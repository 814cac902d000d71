// Fused mel power spectrum: mel = |rfft(F)|^2 . M, one launch.
//
// Replaces the TPU kernel speech2affective_gestures_tpu/ops/dsp_pallas.py
// ::_mel_kernel (pallas_call in fused_mel_power_frames). F are Hann-windowed
// frames, M the Slaney mel filterbank. The TPU kernel computes the spectrum
// as two dense products with the real-DFT matrices, a fit for its matrix
// unit; here that would be ~137x an FFT's operations and a read of both
// matrices (17 MB at n_fft 2048) per row tile, so the spectrum is an FFT.
//
// Two tiers, chosen by the caller's plan (`mel_cuda.mel_plan`): the FFT
// tier for even n_fft whose half M = 2^a 3^b 5^c fits a block's 2048
// points (the serving and corpus shapes, 2048 and 1024; Whisper's 400; 256
// to 4096), the DFT tier for every other n_fft (odd, a prime factor above
// 5, M past 2048). Both take any band count n_mels.
//
// Layouts (float32 unless said, row-major, contiguous):
//   frames (R, N)            N = n_fft
//   fft_tw (M) float2        e^{-2 pi i k / M}, M = N / 2 (FFT tier)
//   split_tw (M/2 + 1) float2  (cos, sin) of 2 pi k / N (FFT tier)
//   dft_tw (N) float2        (cos, sin) of 2 pi m / N (DFT tier)
//   bands (n_mels, 3) int    each band's first bin, bin count, weight offset
//   weights                  each band's run of filterbank entries
//   out (R, n_mels)
//
// FFT tier: one block of 256 threads owns 2048 / M whole rows (2 at N 2048,
// 4 at N 1024, 10 at N 400), so a request's few hundred rows still give a
// block per SM. For each row the block
//   1. loads the row with float4 reads (float2 at a mixed-radix M) into
//      shared memory as the M-point complex sequence z[n] = x[2n] + i x[2n+1];
//   2. runs a Stockham (autosort) FFT over two shared-memory buffers: one
//      radix-2 pass when a is odd, then radix-4 passes (`mel_fft_kernel`
//      at a power of two), then radix-3 and radix-5 passes
//      (`mel_fft_mixed_kernel`, with the same radix-2 and radix-4
//      butterflies);
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
//
// DFT tier (any N; the TPU kernel's own design): the real DFT as a product
// of the frames with the cos and sin of 2 pi n k / N, squared and summed in
// registers, then multiplied by the filterbank; the power spectrum never
// reaches device memory. One block of 256 threads owns DFT_ROWS rows and
// walks the 1 + N/2 bins in tiles of 256, one bin a thread: the thread
// keeps re and im of its bin for the block's rows in registers while the
// block streams the rows' samples through shared memory in stages of
// DFT_KT; the twiddle of (n, k) is entry (n k) mod N of dft_tw, stepped by
// k per sample (the table in shared memory where it fits, else read from
// device memory through L1). The products are summed in chunks of
// DFT_KC, the chunks' sums into the stage's, the stages' into the bin's
// total, so a sum of N products rounds like one of DFT_KC + DFT_KT / DFT_KC
// + N / DFT_KT (72 at N 8192), not of N. The tile's power goes to shared memory, and
// each (row, band) adds its bins of the tile to its running sum in
// ascending bin order (deterministic). Bound: its work is 4 N (1 + N/2)
// operations a row against the float32 rate, the least work of the
// function an FFT's (the caller's `bound_ms`); a simple kernel, far from
// that.

#include <cuda_runtime.h>

namespace {

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

// Steps 3 and 4 of both FFT kernels, after the passes left the rows'
// M-point transforms in z (row r at z[r M]): the real-FFT split and power
// of row r's M + 1 bins into p[r (M + 1) ..] (the free buffer: rows (M +
// 1) <= 2 POINTS floats), then each (row, band) summed over its run of bins
// in order.
__device__ __forceinline__ void split_and_bands(const float2* buf_z, float* p,
                                                const float2* __restrict__ split_tw,
                                                const int* __restrict__ bands,
                                                const float* __restrict__ weights,
                                                float* __restrict__ out, int R, int r0,
                                                int rows, int M, int n_mels) {
  const int tid = threadIdx.x;
  {
    const int pairs = M / 2 + 1;
    for (int b = tid; b < rows * pairs; b += THREADS) {
      const int row = b / pairs;
      const int k = b - row * pairs;
      const float2* z = buf_z + row * M;
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

  for (int idx = tid; idx < rows * n_mels; idx += THREADS) {
    const int row = idx / n_mels;
    const int m = idx - row * n_mels;
    if (r0 + row >= R) break;
    const float* pr = p + row * (M + 1) + __ldg(bands + 3 * m);
    const int n = __ldg(bands + 3 * m + 1);
    const float* w = weights + __ldg(bands + 3 * m + 2);
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc = fmaf(__ldg(w + i), pr[i], acc);
    out[(size_t)(r0 + row) * n_mels + m] = acc;
  }
}

__global__ void __launch_bounds__(THREADS) mel_fft_kernel(
    const float* __restrict__ frames, const float2* __restrict__ fft_tw,
    const float2* __restrict__ split_tw, const int* __restrict__ bands,
    const float* __restrict__ weights, float* __restrict__ out, int R, int log2m,
    int n_mels) {
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

  split_and_bands(buf[cur], reinterpret_cast<float*>(buf[cur ^ 1]), split_tw, bands, weights,
                  out, R, r0, rows, M, n_mels);
}

// The DFT of P points in place (y_k = sum_n v_n e^{-2 pi i n k / P}): the
// power-of-two kernel's radix-2 and radix-4 butterflies, and radix 3 and 5
// with their constants rounded once to float32.
template <int P>
__device__ __forceinline__ void butterfly(float2 (&v)[P]);
template <>
__device__ __forceinline__ void butterfly<2>(float2 (&v)[2]) {
  const float2 v0 = v[0], v1 = v[1];
  v[0] = make_float2(v0.x + v1.x, v0.y + v1.y);
  v[1] = make_float2(v0.x - v1.x, v0.y - v1.y);
}
template <>
__device__ __forceinline__ void butterfly<4>(float2 (&v)[4]) {
  const float2 a = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 s = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 c = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 d = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
  v[0] = make_float2(a.x + c.x, a.y + c.y);
  v[1] = make_float2(s.x + d.y, s.y - d.x);  // s - i d
  v[2] = make_float2(a.x - c.x, a.y - c.y);
  v[3] = make_float2(s.x - d.y, s.y + d.x);  // s + i d
}
template <>
__device__ __forceinline__ void butterfly<3>(float2 (&v)[3]) {
  constexpr float S3 = 0.86602540378443865f;  // sin(2 pi / 3)
  const float2 t = make_float2(v[1].x + v[2].x, v[1].y + v[2].y);
  const float2 m = make_float2(v[0].x - 0.5f * t.x, v[0].y - 0.5f * t.y);
  const float2 s = make_float2(S3 * (v[1].x - v[2].x), S3 * (v[1].y - v[2].y));
  v[0] = make_float2(v[0].x + t.x, v[0].y + t.y);
  v[1] = make_float2(m.x + s.y, m.y - s.x);  // m - i s
  v[2] = make_float2(m.x - s.y, m.y + s.x);  // m + i s
}
template <>
__device__ __forceinline__ void butterfly<5>(float2 (&v)[5]) {
  constexpr float C1 = 0.30901699437494742f;   // cos(2 pi / 5)
  constexpr float C2 = -0.80901699437494742f;  // cos(4 pi / 5)
  constexpr float S1 = 0.95105651629515357f;   // sin(2 pi / 5)
  constexpr float S2 = 0.58778525229247313f;   // sin(4 pi / 5)
  const float2 t1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
  const float2 t2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
  const float2 t3 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
  const float2 t4 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
  const float2 a1 = make_float2(v[0].x + C1 * t1.x + C2 * t2.x, v[0].y + C1 * t1.y + C2 * t2.y);
  const float2 a2 = make_float2(v[0].x + C2 * t1.x + C1 * t2.x, v[0].y + C2 * t1.y + C1 * t2.y);
  const float2 b1 = make_float2(S1 * t3.x + S2 * t4.x, S1 * t3.y + S2 * t4.y);
  const float2 b2 = make_float2(S2 * t3.x - S1 * t4.x, S2 * t3.y - S1 * t4.y);
  v[0] = make_float2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
  v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
  v[4] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
  v[2] = make_float2(a2.x + b2.y, a2.y - b2.x);  // a2 - i b2
  v[3] = make_float2(a2.x - b2.y, a2.y + b2.x);  // a2 + i b2
}

// One radix-P Stockham pass after Ns points over the block's rows of M
// points (the power-of-two kernel's pass, with its indices by division):
// butterfly j of a row reads in[j + r M/P], twiddles by fft_tw[r (j mod
// Ns) M / (Ns P)] = e^{-2 pi i r (j mod Ns) / (Ns P)} and writes out[(j -
// j mod Ns) P + j mod Ns + r Ns].
template <int P>
__device__ __forceinline__ void stockham_pass(const float2* in, float2* out,
                                              const float2* __restrict__ fft_tw, int M,
                                              int rows, int ns) {
  const int q = M / P;
  const int stride = M / (ns * P);
  for (int b = threadIdx.x; b < rows * q; b += THREADS) {
    const int row = b / q;
    const int j = b - row * q;
    const int base = row * M;
    float2 v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) v[r] = in[base + j + r * q];
    const int jm = j % ns;
    if (jm) {
#pragma unroll
      for (int r = 1; r < P; ++r) v[r] = cmul(v[r], __ldg(fft_tw + r * jm * stride));
    }
    butterfly<P>(v);
    const int od = base + (j - jm) * P + jm;
#pragma unroll
    for (int r = 0; r < P; ++r) out[od + r * ns] = v[r];
  }
}

// The FFT tier at a mixed-radix size, M = n_fft / 2 = 2^a 3^b 5^c <=
// POINTS not a power of two: POINTS / M whole rows a block (10 at n_fft
// 400), each loaded as M complex points (float2: n_fft need only be even),
// then the passes in a fixed order, radix 2 when a is odd, radix 4 (a / 2
// times), radix 3 (b times), radix 5 (c times), each after a block barrier;
// then the same split, power and band sums as the power-of-two kernel.
__global__ void __launch_bounds__(THREADS) mel_fft_mixed_kernel(
    const float* __restrict__ frames, const float2* __restrict__ fft_tw,
    const float2* __restrict__ split_tw, const int* __restrict__ bands,
    const float* __restrict__ weights, float* __restrict__ out, int R, int M, int n2,
    int n4, int n3, int n5, int n_mels) {
  __shared__ __align__(16) float2 buf[2][POINTS];
  const int rows = POINTS / M;
  const int r0 = blockIdx.x * rows;
  {
    const float2* src = reinterpret_cast<const float2*>(frames) + (size_t)r0 * M;
    const int valid = min(rows, R - r0) * M;
    for (int q = threadIdx.x; q < rows * M; q += THREADS)
      buf[0][q] = q < valid ? __ldg(src + q) : make_float2(0.0f, 0.0f);
  }
  int cur = 0, ns = 1;
  const int radix[4] = {2, 4, 3, 5};
  const int count[4] = {n2, n4, n3, n5};
  for (int i = 0; i < 4; ++i)
    for (int pass = 0; pass < count[i]; ++pass) {
      __syncthreads();
      switch (radix[i]) {
        case 2: stockham_pass<2>(buf[cur], buf[cur ^ 1], fft_tw, M, rows, ns); break;
        case 4: stockham_pass<4>(buf[cur], buf[cur ^ 1], fft_tw, M, rows, ns); break;
        case 3: stockham_pass<3>(buf[cur], buf[cur ^ 1], fft_tw, M, rows, ns); break;
        default: stockham_pass<5>(buf[cur], buf[cur ^ 1], fft_tw, M, rows, ns); break;
      }
      cur ^= 1;
      ns *= radix[i];
    }
  __syncthreads();
  split_and_bands(buf[cur], reinterpret_cast<float*>(buf[cur ^ 1]), split_tw, bands, weights,
                  out, R, r0, rows, M, n_mels);
}

constexpr int DFT_ROWS = 8;
constexpr int DFT_KT = 256;  // samples a stage
constexpr int DFT_KC = 32;   // samples a chunk of a stage's sums

// dynamic shared memory: the stage's samples [DFT_KT][DFT_ROWS], the bin
// tile's power [DFT_ROWS][THREADS], the bands' running sums
// [DFT_ROWS][n_mels], then (TW_SMEM) the N twiddles
template <bool TW_SMEM>
__global__ void __launch_bounds__(THREADS) mel_dft_kernel(
    const float* __restrict__ frames, const float2* __restrict__ dft_tw,
    const int* __restrict__ bands, const float* __restrict__ weights,
    float* __restrict__ out, int R, int N, int n_mels) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;
  float* pw = xs + DFT_KT * DFT_ROWS;
  float* acc = pw + DFT_ROWS * THREADS;
  float2* tws = reinterpret_cast<float2*>(acc + ((DFT_ROWS * n_mels + 3) & ~3));
  const int r0 = blockIdx.x * DFT_ROWS;
  const int rows = min(DFT_ROWS, R - r0);
  const int nbins = N / 2 + 1;
  const int tid = threadIdx.x;
  const float2* tw = TW_SMEM ? tws : dft_tw;
  if (TW_SMEM)
    for (int i = tid; i < N; i += THREADS) tws[i] = __ldg(dft_tw + i);
  for (int i = tid; i < DFT_ROWS * n_mels; i += THREADS) acc[i] = 0.0f;

  for (int kb = 0; kb < nbins; kb += THREADS) {
    const int k = kb + tid;
    const int step = k < nbins ? k : 0;  // (n k) mod N advances by k a sample
    float re[DFT_ROWS], im[DFT_ROWS];
#pragma unroll
    for (int r = 0; r < DFT_ROWS; ++r) re[r] = im[r] = 0.0f;
    int m = 0;
    for (int n0 = 0; n0 < N; n0 += DFT_KT) {
      __syncthreads();  // the previous stage's samples (and tile's power) are read
      for (int i = tid; i < DFT_KT * DFT_ROWS; i += THREADS) {
        const int r = i / DFT_KT, n = i - r * DFT_KT;  // coalesced along n
        xs[n * DFT_ROWS + r] =
            r < rows && n0 + n < N ? __ldg(frames + (size_t)(r0 + r) * N + n0 + n) : 0.0f;
      }
      __syncthreads();
      const int nn = min(DFT_KT, N - n0);
      float sr[DFT_ROWS], si[DFT_ROWS];
#pragma unroll
      for (int r = 0; r < DFT_ROWS; ++r) sr[r] = si[r] = 0.0f;
      for (int c0 = 0; c0 < nn; c0 += DFT_KC) {
        float cr[DFT_ROWS], ci[DFT_ROWS];
#pragma unroll
        for (int r = 0; r < DFT_ROWS; ++r) cr[r] = ci[r] = 0.0f;
        const int c1 = min(nn, c0 + DFT_KC);
        for (int n = c0; n < c1; ++n) {
          const float2 c = tw[m];
          const float4 a = *reinterpret_cast<const float4*>(xs + n * DFT_ROWS);
          const float4 b = *reinterpret_cast<const float4*>(xs + n * DFT_ROWS + 4);
          const float x[DFT_ROWS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int r = 0; r < DFT_ROWS; ++r) {
            cr[r] = fmaf(x[r], c.x, cr[r]);
            ci[r] = fmaf(x[r], c.y, ci[r]);
          }
          m += step;
          if (m >= N) m -= N;
        }
#pragma unroll
        for (int r = 0; r < DFT_ROWS; ++r) {
          sr[r] += cr[r];
          si[r] += ci[r];
        }
      }
#pragma unroll
      for (int r = 0; r < DFT_ROWS; ++r) {
        re[r] += sr[r];
        im[r] += si[r];
      }
    }
#pragma unroll
    for (int r = 0; r < DFT_ROWS; ++r)
      pw[r * THREADS + tid] = k < nbins ? re[r] * re[r] + im[r] * im[r] : 0.0f;
    __syncthreads();
    // each (row, band): its bins in this tile, in order, onto its sum
    const int k_end = min(nbins, kb + THREADS);
    for (int i = tid; i < rows * n_mels; i += THREADS) {
      const int r = i / n_mels;
      const int mb = i - r * n_mels;
      const int lo = __ldg(bands + 3 * mb), cnt = __ldg(bands + 3 * mb + 1);
      const float* w = weights + __ldg(bands + 3 * mb + 2);
      const int q0 = max(lo, kb), q1 = min(lo + cnt, k_end);
      float s = acc[i];
      for (int q = q0; q < q1; ++q) s = fmaf(__ldg(w + q - lo), pw[r * THREADS + q - kb], s);
      acc[i] = s;
    }
  }
  for (int i = tid; i < rows * n_mels; i += THREADS) {
    const int r = i / n_mels;
    out[(size_t)(r0 + r) * n_mels + i - r * n_mels] = acc[i];
  }
}

}  // namespace

// The FFT tier: n_fft even with M = n_fft / 2 in [4, POINTS] and no prime
// factor above 5 (the power-of-two kernel where M is one, else the
// mixed-radix kernel). Returns the CUDA error code of the launch (0 =
// success).
extern "C" int s2ag_mel_power(const float* frames, const float* fft_tw,
                              const float* split_tw, const int* bands,
                              const float* weights, float* out, int R, int n_fft,
                              int n_mels, void* stream) {
  const int M = n_fft / 2;
  if (R < 1 || n_mels < 1 || n_fft % 2 || M < 4 || M > POINTS)
    return (int)cudaErrorInvalidValue;
  int a = 0, b = 0, c = 0, m = M;
  for (; m % 2 == 0; m /= 2) ++a;
  for (; m % 3 == 0; m /= 3) ++b;
  for (; m % 5 == 0; m /= 5) ++c;
  if (m != 1) return (int)cudaErrorInvalidValue;
  const int rows = POINTS / M;
  const dim3 grid((R + rows - 1) / rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tw = reinterpret_cast<const float2*>(fft_tw);
  const float2* stw = reinterpret_cast<const float2*>(split_tw);
  if (b == 0 && c == 0)
    mel_fft_kernel<<<grid, THREADS, 0, st>>>(frames, tw, stw, bands, weights, out, R, a,
                                             n_mels);
  else
    mel_fft_mixed_kernel<<<grid, THREADS, 0, st>>>(frames, tw, stw, bands, weights, out, R,
                                                   M, a % 2, a / 2, b, c, n_mels);
  return (int)cudaGetLastError();
}

// The DFT tier, any n_fft >= 1: DFT_ROWS rows a block, `smem` bytes of
// dynamic shared memory (the caller's plan, `mel_cuda.mel_plan`), the
// twiddle table in it when tw_in_smem != 0. Returns the CUDA error code of
// the launch (0 = success).
extern "C" int s2ag_mel_power_dft(const float* frames, const float* dft_tw,
                                  const int* bands, const float* weights, float* out,
                                  int R, int n_fft, int n_mels, int smem, int tw_in_smem,
                                  void* stream) {
  const long long need = 4LL * (DFT_KT * DFT_ROWS + DFT_ROWS * THREADS +
                                ((DFT_ROWS * n_mels + 3) & ~3)) +
                         (tw_in_smem ? 8LL * n_fft : 0);
  if (R < 1 || n_fft < 1 || n_mels < 1 || smem < need) return (int)cudaErrorInvalidValue;
  const void* kernel = tw_in_smem ? (const void*)mel_dft_kernel<true>
                                  : (const void*)mel_dft_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + DFT_ROWS - 1) / DFT_ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tw = reinterpret_cast<const float2*>(dft_tw);
  if (tw_in_smem)
    mel_dft_kernel<true><<<grid, THREADS, smem, st>>>(frames, tw, bands, weights, out, R,
                                                      n_fft, n_mels);
  else
    mel_dft_kernel<false><<<grid, THREADS, smem, st>>>(frames, tw, bands, weights, out, R,
                                                       n_fft, n_mels);
  return (int)cudaGetLastError();
}
