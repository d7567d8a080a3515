// Kernel K1: DIF-factorized STFT -> dB frontend for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels, which compute one function:
//   `_dif_kernel` behind `stft_features_dif_pallas_tm`
//     (tpumix/ops/stft_dif_pallas.py:207, :267, pallas_call :318), and
//   `_ct_kernel` behind `stft_features_ct_pallas_tm`
//     (tpumix/ops/stft_ct_pallas.py:93, :147, pallas_call :186).
// The TPU needed two factorizations because Mosaic wants 128-aligned lane
// slices (DIF: hop % 128 == 0) and cannot take stride-16 slices (DIT: the
// phase frames were built in HBM by XLA).  Neither holds here: this kernel
// reads a frame at any hop, so both entries (tpumix_torch/ops/stft_dif.py,
// stft_ct.py) launch it.
//
// Computes, per signal row b and frame t (n = 128*n1 + n2, k = 16*k2 + k1):
//   frame    f[n]         = x[reflect(t*hop + n - 1024)]   (centre padding)
//   stage A  y_k1[n2]     = sum_n1 w[n]*f[n] * W_16^(n1*k1)     k1 = 0..8
//   twiddle  z_k1[n2]     = y_k1[n2] * W_2048^(k1*n2)           k1 = 0..8
//   stage C  X[16*k2+k1]  = sum_n2 z_k1[n2] * W_128^(n2*k2)     k2 = 0..127
//   out[b, t, k] = scale * ln(max(|X|^2, amin^2))   (scale = (mult/2)/ln 10)
// and writes the 1025 onesided bins in natural order.  The input is real,
// so the bins with k1 = 9..15 are mirrors: X[16*k2 + k1] = conj X[16*(127 -
// k2) + 16 - k1], and stage C runs on the 9 series k1 = 0..8 only, each bin
// written by exactly one thread.  Stage C is itself factored (n2 = 8*p + q,
// k2 = u + 16*v):
//   C1  Y_q[u]  = sum_p z[8p+q] * W_16^(p*u)                  (radix-4 x 4 FFT)
//   C2  X_k2    = sum_q W_128^(q*u) * Y_q[u] * W_8^(q*v)      (radix-2 x 4 FFT)
//
// What bounds it on this card: memory, by the function.  It needs ~272 MB
// of HBM traffic for one 64-chunk segment (256 rows x 173 frames: the
// audio read once, the features written once), 0.081 ms at 3.35 TB/s,
// against 2.72 GFLOP of real-FFT work.  This design's own float64 work is
// ~42k instructions per frame (stage A and twiddle ~15k, C1 ~12k, C2 ~13k,
// epilogue ~3k; chip_smoke.py DIF_FP64_PER_FRAME), 1.9 G for the segment:
// 0.11 ms at the FP64 issue rate (132 SMs x 64 lanes x 1.98 GHz), above the
// byte bound.  So FP64 issue, shared-memory traffic and the latency between
// the block's barriers are what is left to pay (PERF.md has the stage
// costs).
//
// Why float64 inside: the features are float32, but the arithmetic that
// makes them is not done in float32.  The frames at the song's edges are
// reflect-padded, so frame * window is symmetric, the spectrum is real and
// crosses zero, and a few bins of every segment sit 90 dB under the frame's
// energy.  There every float32 rounding counts, in every stage: float32 DFTs
// of any structure (three hand-written ones, and cuFFT through torch.stft)
// land 0.05-0.33 dB from float64 on such input (PERF.md, Findings), at the
// limit the features are held to.  The FP64 tensor cores (DMMA) do not help
// at radix 16: a dense 16 x 9 product is more work than the FFT it replaces.
//
// What the design does about its costs:
// - No padded copy.  The kernel reads the unpadded rows and reflects the
//   index itself; only a block whose frames reach the padding (the first
//   two and last three frames of a row at hop 512) takes the reflect branch,
//   and the test is uniform over the block.  One launch, one pass over HBM.
// - Half the float64 work of a direct DFT and of 16 series: stage A is a
//   real radix-2 16-point FFT (the structure of `_fft16_real`,
//   stft_dif_pallas.py:170, literal factors), and the twiddle and stage C
//   run on the 9 series a real input needs.
// - Tables out of the inner loop: a block owns one row and TF = 4
//   consecutive frames with 128 threads; in stage A thread n2 keeps its 16
//   window values and 8 complex twiddles in registers over the block's
//   frames and prefetches the next frame's 16 samples while it transforms
//   the current one.  z (9 series x 128, float64 complex, series stride 129
//   against bank conflicts) is 18.6 KB per frame, so a block holds 74.3 KB
//   and three blocks share an SM: while one waits on its loads or a
//   barrier, the others compute.  C1 runs one 16-point FFT per thread in
//   place; C2 applies W_128^(q*u) (moved there from C1, whose 16 twiddle
//   reads per unit met up to 8-way bank conflicts; C1 took half the time
//   after) and one 8-point FFT per thread, consecutive threads on
//   consecutive bins.
// - Chosen by measurement (PERF.md, Findings): 2 frames per block were as fast,
//   8 (one block per SM) 1.7x slower; 144 threads (C1 and C2 in whole
//   passes) and two C2 units in flight per thread were not faster.
//   stft_dif_stages_launch stops after stage A or after C1; the differences
//   of its times give each stage's cost (chip_smoke.py [k1]).

#include <cuda_runtime.h>
#include <climits>

#include "dft_common.cuh"

namespace {

using namespace dftc;

constexpr int kN1 = 16;     // blocks per frame
constexpr int kN2 = 128;    // block length
constexpr int kK1U = 9;     // series a real input needs: k1 = 0..8
constexpr int kNfft = kN1 * kN2;
constexpr int kHalf = kNfft / 2;  // centre padding
constexpr int kBins = kHalf + 1;
constexpr int kThreads = kN2;     // stage A: one thread per n2
constexpr int kTF = 4;            // frames per block

// z[(f * kK1U + k1) * kKS + n2], double2; kKS odd (see above)
constexpr int kKS = kN2 + 1;

// offsets in the flat float64 table buffer (tpumix_torch/ops/stft_dif.py _kernel_tables)
constexpr int kOffWin = 0;
constexpr int kOffTwc = kOffWin + kNfft;       // [16][128] cos(2 pi k1 n2 / 2048)
constexpr int kOffTws = kOffTwc + kN1 * kN2;
constexpr int kOffC128 = kOffTws + kN1 * kN2;  // [128] cos(2 pi m / 128)
constexpr int kOffS128 = kOffC128 + kN2;

// z and W_128: 76.4 KB
constexpr size_t kSmem = sizeof(double2) * (kTF * kK1U * kKS + kN2);
// blocks per SM that shared memory allows: the register budget's hint
constexpr int kMinBlocks = 3;

// source index of padded position i + 1024 under reflect padding (S > 1024)
__device__ __forceinline__ int reflect(int i, int S) {
  i = i < 0 ? -i : i;
  return i > S - 1 ? 2 * (S - 1) - i : i;
}

// forward 4-point DFT of real values: X0, X1 = x1r + i x1i, X2 (X3 = conj X1)
__device__ __forceinline__ void fft4_real(double a0, double a1, double a2, double a3, double& x0,
                                          double& x1r, double& x1i, double& x2) {
  const double t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = a1 - a3;
  x0 = t0 + t2;
  x1r = t1;
  x1i = -t3;
  x2 = t0 - t2;
}

// forward 8-point DFT of real values, onesided: X[k] = (r[k], m[k]) for k = 0..4
// (m[0] = m[4] = 0 are implied, not written)
__device__ __forceinline__ void fft8_real(double a0, double a1, double a2, double a3, double a4,
                                          double a5, double a6, double a7, double (&r)[5],
                                          double (&m)[5]) {
  double e0, e1r, e1i, e2, o0, o1r, o1i, o2;
  fft4_real(a0, a2, a4, a6, e0, e1r, e1i, e2);
  fft4_real(a1, a3, a5, a7, o0, o1r, o1i, o2);
  constexpr double c = 0.70710678118654752;
  const double pr = c * (o1r + o1i), pi = c * (o1i - o1r);  // W_8 * O1
  r[0] = e0 + o0;
  r[1] = e1r + pr;
  m[1] = e1i + pi;
  r[2] = e2;
  m[2] = -o2;  // W_8^2 = -i, O2 real
  r[3] = e1r - pr;  // X3 = conj(E1) - conj(W_8 O1)
  m[3] = pi - e1i;
  r[4] = e0 - o0;
}

// forward 16-point DFT of 16 real values, onesided: Y[k] = (yr[k], yi[k]),
// k = 0..8, by two real 8-point DFTs of the even and odd samples
// (tpumix/ops/stft_dif_pallas.py `_fft16_real`)
__device__ __forceinline__ void fft16_real(const double (&v)[kN1], double (&yr)[kK1U],
                                           double (&yi)[kK1U]) {
  double er[5], ei[5], orr[5], oi[5];
  fft8_real(v[0], v[2], v[4], v[6], v[8], v[10], v[12], v[14], er, ei);
  fft8_real(v[1], v[3], v[5], v[7], v[9], v[11], v[13], v[15], orr, oi);
  yr[0] = er[0] + orr[0];
  yi[0] = 0.0;
  yr[8] = er[0] - orr[0];
  yi[8] = 0.0;
  yr[4] = er[4];
  yi[4] = -orr[4];  // W_16^4 = -i, E4 and O4 real
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    double pr, pi;  // P = W_16^k * O[k]
    if (k == 2) {
      const double c = cos16(2);
      pr = c * (orr[2] + oi[2]);
      pi = c * (oi[2] - orr[2]);
    } else {
      const double c = cos16(k), s = sin16(k);
      pr = c * orr[k] + s * oi[k];
      pi = c * oi[k] - s * orr[k];
    }
    yr[k] = er[k] + pr;
    yi[k] = ei[k] + pi;
    yr[8 - k] = er[k] - pr;  // X[8-k] = conj(E[k]) - conj(P)
    yi[8 - k] = pi - ei[k];
  }
}

// the 16 samples of frame t at n2 (padded index t*hop + 128*n1 + n2)
__device__ __forceinline__ void load_frame(float (&dst)[kN1], const float* row, int t, int n2,
                                           int hop, int S, bool edge) {
  const int base = t * hop - kHalf + n2;
  if (edge) {
#pragma unroll
    for (int n1 = 0; n1 < kN1; ++n1) dst[n1] = __ldg(row + reflect(base + n1 * kN2, S));
  } else {
#pragma unroll
    for (int n1 = 0; n1 < kN1; ++n1) dst[n1] = __ldg(row + base + n1 * kN2);
  }
}

// stage A + twiddle of one (frame, n2): window, real 16-point FFT over n1,
// z_k1[n2] = y_k1[n2] * W_2048^(k1*n2) for k1 = 0..8 into zf[k1 * kKS]
__device__ __forceinline__ void stage_a(const float (&xs)[kN1], const double (&w)[kN1],
                                        const double (&tc)[kK1U], const double (&ts)[kK1U],
                                        double2* zf) {
  double v[kN1];
#pragma unroll
  for (int n1 = 0; n1 < kN1; ++n1) v[n1] = static_cast<double>(xs[n1]) * w[n1];
  double yr[kK1U], yi[kK1U];
  fft16_real(v, yr, yi);
  zf[0] = make_double2(yr[0], 0.0);
#pragma unroll
  for (int k1 = 1; k1 < kK1U - 1; ++k1)  // y * e^{-i theta}
    zf[k1 * kKS] = make_double2(yr[k1] * tc[k1] + yi[k1] * ts[k1],
                                yi[k1] * tc[k1] - yr[k1] * ts[k1]);
  zf[8 * kKS] = make_double2(yr[8] * tc[8], -yr[8] * ts[8]);  // y_8 is real
}

// window and twiddles of n2 from the table
__device__ __forceinline__ void load_tables(const double* __restrict__ tab, int n2,
                                            double (&w)[kN1], double (&tc)[kK1U],
                                            double (&ts)[kK1U]) {
#pragma unroll
  for (int n1 = 0; n1 < kN1; ++n1) w[n1] = __ldg(tab + kOffWin + n1 * kN2 + n2);
#pragma unroll
  for (int k1 = 1; k1 < kK1U; ++k1) {
    tc[k1] = __ldg(tab + kOffTwc + k1 * kN2 + n2);
    ts[k1] = __ldg(tab + kOffTws + k1 * kN2 + n2);
  }
}

// C2 of unit (u, k1) from its 8 values Y_q[u]: the twiddle W_128^(q*u), the
// 8-point FFT over q, and the dB of X_k1[u + 16 v] into the frame's bins
__device__ __forceinline__ void c2_finish(double2 (&y)[8], const double2* w128, float* o, int u,
                                          int k1, float scale, double amin2) {
#pragma unroll
  for (int q = 1; q < 8; ++q) {
    const double2 tw = w128[q * u];
    y[q] = mul_conj(y[q], tw.x, tw.y);
  }
  double2 e0 = y[0], e1 = y[2], e2 = y[4], e3 = y[6];
  double2 o0 = y[1], o1 = y[3], o2 = y[5], o3 = y[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = mul_w16(o1, 2);  // W_8^v = W_16^(2v)
  o2 = mul_w16(o2, 4);
  o3 = mul_w16(o3, 6);
  // v = 0..3: k2 = u + 16v < 64, bin 16*k2 + k1
  const int k = 16 * u + k1;
  o[k] = db(e0.x + o0.x, e0.y + o0.y, scale, amin2);
  o[k + 256] = db(e1.x + o1.x, e1.y + o1.y, scale, amin2);
  o[k + 512] = db(e2.x + o2.x, e2.y + o2.y, scale, amin2);
  o[k + 768] = db(e3.x + o3.x, e3.y + o3.y, scale, amin2);
  // v = 4..7: k2 = u + 16v >= 64.  For k1 = 1..7 these are the bins
  // 2048 - 16*k2 - k1 (k1' = 16 - k1 = 9..15); for k1 = 0 only k2 = 64 (bin
  // 1024) is onesided; for k1 = 8 none is
  if (k1 >= 1 && k1 < 8) {
    const int m = kHalf - 16 * u - k1;
    o[m] = db(e0.x - o0.x, e0.y - o0.y, scale, amin2);
    o[m - 256] = db(e1.x - o1.x, e1.y - o1.y, scale, amin2);
    o[m - 512] = db(e2.x - o2.x, e2.y - o2.y, scale, amin2);
    o[m - 768] = db(e3.x - o3.x, e3.y - o3.y, scale, amin2);
  } else if (k1 == 0 && u == 0) {
    o[kHalf] = db(e0.x - o0.x, e0.y - o0.y, scale, amin2);
  }
}

// kStages: 3 runs the whole transform; 1 and 2 stop after stage A and after C1
// (measurement only: one value per block is written so that nothing is elided)
template <int kStages>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dif_kernel(const float* __restrict__ x, float* __restrict__ out, const double* __restrict__ tab,
           int S, int T, int tiles, int hop, float scale, double amin2) {
  extern __shared__ double2 smem[];
  double2* z = smem;
  double2* w128 = z + kTF * kK1U * kKS;              // (cos, sin)(2 pi m / 128)

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTF;
  const int nf = min(kTF, T - t0);
  const int tid = threadIdx.x;
  const float* row = x + (long long)b * S;
  // does any frame of the block reach into the padding?
  const bool edge = t0 * hop < kHalf || (t0 + nf - 1) * hop + kHalf > S;

  w128[tid] = make_double2(__ldg(tab + kOffC128 + tid), __ldg(tab + kOffS128 + tid));

  // ---- stage A + twiddle: thread = n2 over the block's frames ----
  // n2 is the thread's own, so its window and twiddles stay in registers
  // over the frames, and the next frame's samples load while this one
  // transforms.
  {
    const int n2 = tid;
    double w[kN1], tc[kK1U], ts[kK1U];
    load_tables(tab, n2, w, tc, ts);
    float cur[kN1], nxt[kN1];
    load_frame(cur, row, t0, n2, hop, S, edge);
#pragma unroll 1
    for (int f = 0; f < nf; ++f) {
      if (f + 1 < nf) load_frame(nxt, row, t0 + f + 1, n2, hop, S, edge);
      stage_a(cur, w, tc, ts, z + f * kK1U * kKS + n2);
#pragma unroll
      for (int n1 = 0; n1 < kN1; ++n1) cur[n1] = nxt[n1];
    }
  }
  __syncthreads();
  if (kStages == 1) {
    if (tid == 0) out[blockIdx.x] = static_cast<float>(z[kKS + 1].x);
    return;
  }

  // ---- C1: unit = (series s = f*9 + k1, q); 16-point FFT over p of z[8p + q], in place ----
  for (int wu = tid; wu < nf * kK1U * 8; wu += kThreads) {
    const int q = wu & 7;
    double2* zq = z + (wu >> 3) * kKS + q;
    double2 a[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) a[p] = zq[8 * p];
    fft16(a);
    // now a[4c + d] = Y_q[c + 4d]; store Y_q[u] at n2 = 8u + q
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int d = 0; d < 4; ++d) zq[8 * (c + 4 * d)] = a[4 * c + d];
    }
  }
  __syncthreads();
  if (kStages == 2) {
    if (tid == 0) out[blockIdx.x] = static_cast<float>(z[kKS + 1].x);
    return;
  }

  // ---- C2: unit = (f, u, k1), k1 fastest; W_128^(q*u), then an 8-point FFT
  // over q -> X_k1[u + 16 v].  The twiddle is C1's last step moved here: a
  // unit reads 7 of them, all lanes of a quarter-warp at most two distinct
  // ones, where C1's 16 per unit met up to 8-way bank conflicts ----
  constexpr int kUnits = 16 * kK1U;
  for (int wu = tid; wu < nf * kUnits; wu += kThreads) {
    const int f = wu / kUnits, u = (wu % kUnits) / kK1U, k1 = wu % kK1U;
    const double2* zu = z + (f * kK1U + k1) * kKS + 8 * u;
    double2 y[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) y[q] = zu[q];
    c2_finish(y, w128, out + ((long long)b * T + t0 + f) * kBins, u, k1, scale, amin2);
  }
}

template <int kStages>
int launch(const float* x, float* out, const double* tab, int B, int T, long long S, int hop,
           float scale, double amin2, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  // reflect padding needs S > n_fft / 2; frames end by the row's end + 1024
  if (hop <= 0 || S <= kHalf || S > INT_MAX - 2 * kNfft || (long long)(T - 1) * hop > S)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + kTF - 1) / kTF;
  const long long blocks = (long long)B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in is per device: set it once for each
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(dif_kernel<kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  dif_kernel<kStages><<<(unsigned)blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      x, out, tab, (int)S, T, tiles, hop, scale, amin2);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, S] unpadded float32 rows (S > 1024); out: [B, T, 1025] float32 with
// T - 1 <= S / hop; tab: the flat float64 tables.  Returns the cudaError_t of
// the launch.
extern "C" int stft_dif_launch(const float* x, float* out, const double* tab, int B, int T,
                               long long S, int hop, float scale, double amin2, void* stream) {
  return launch<3>(x, out, tab, B, T, S, hop, scale, amin2, stream);
}

// Measurement only: the same launch stopped after stage A (stages = 1) or
// after C1 (2).  It writes one value per block into out, not features.
extern "C" int stft_dif_stages_launch(const float* x, float* out, const double* tab, int B, int T,
                                      long long S, int hop, float scale, double amin2, int stages,
                                      void* stream) {
  switch (stages) {
    case 1: return launch<1>(x, out, tab, B, T, S, hop, scale, amin2, stream);
    case 2: return launch<2>(x, out, tab, B, T, S, hop, scale, amin2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
