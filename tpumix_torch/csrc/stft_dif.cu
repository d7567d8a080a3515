// Kernel K1: DIF-factorized STFT -> dB frontend for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_dif_kernel` behind
//   `stft_features_dif_pallas_tm` (tpumix/ops/stft_dif_pallas.py:207, :267).
//
// Computes, per padded signal row b and frame t (n = 128*n1 + n2, k = 16*k2 + k1):
//   stage A  y_k1[n2]    = sum_n1 w[n]*x[t*hop + n] * W_16^(n1*k1)      k1 <= 8
//   twiddle  z_k1[n2]    = y_k1[n2] * W_2048^(k1*n2)     k1 > 8 from conj(y_{16-k1})
//   stage C  X[16*k2+k1] = sum_n2 z_k1[n2] * W_128^(n2*k2)
//   out[b, t, k] = scale * ln(max(|X|^2, amin^2))   (scale = (mult/2)/ln 10)
// and writes the 1025 onesided bins in natural order.  Stage C is itself
// factored (n2 = 8*p + q, k2 = u + 16*v):
//   C1  Y_q[u]  = W_128^(q*u) * sum_p z[8p+q] * W_16^(p*u)   (radix-4 x 4 FFT)
//   C2  X_k2    = sum_q Y_q[u] * W_8^(q*v)                    (radix-2 x 4 FFT)
//
// What bounds it on this card: memory.  A real 2048-point FFT is about
// 2.5*N*log2(N) = 56k flops per frame, ~2.7 GFLOP for one 64-chunk segment
// (256 rows x 173 frames, window and |X|^2 included) against ~272 MB of
// input and output: 0.08 ms of FP64 work at 34 TFLOP/s against 0.08 ms of
// HBM traffic.
//
// Why float64 inside: the features are float32, but the arithmetic that
// makes them is not done in float32.  The frames at the song's edges are
// reflect-padded, so frame * window is symmetric, the spectrum is real and
// crosses zero, and a few bins of every segment sit 90 dB under the frame's
// energy.  There every float32 rounding counts, in every stage: float32
// versions of this kernel and float32 cuFFT (torch.stft) all sit near
// 0.1 dB from float64 on such input (PERF.md, Findings), at the limit the
// features are held to.  The FP64 pipes run at half the FP32 rate, which this
// memory-bound function can afford; the result matches the float64 plain
// version to the rounding of the float32 output.  Tensor cores are out
// (TF32 would cost the features their conformance).
//
// What the design does about it: a block owns one signal row and TF = 2
// frames, so the overlapping frames are read from L1/L2, not HBM.  Stage A
// (real 16-point DFT, one thread per (frame, n2)) and the twiddle leave z in
// 64.5 KB of shared memory; C1 and C2 run in place there with one thread per
// small FFT, and C2 writes bins straight to the output, 32 consecutive bins
// per warp.  z is laid out frame-major with a k1 stride of 129 so that every
// quarter-warp of 16-byte accesses hits eight distinct bank groups in stage
// A, C1 and C2.  66.5 KB per block lets three blocks share an SM.

#include <cuda_runtime.h>
#include <climits>

#include "dft_common.cuh"

namespace {

using namespace dftc;

constexpr int kN1 = 16;     // blocks per frame
constexpr int kN2 = 128;    // block length
constexpr int kK1U = 9;     // onesided stage-A outputs
constexpr int kNfft = kN1 * kN2;
constexpr int kBins = kNfft / 2 + 1;
constexpr int kTF = 2;      // frames per block
constexpr int kThreads = kTF * kN2;

// z[f * kFS + k1 * kKS + n2], double2; kKS odd (see above)
constexpr int kKS = kN2 + 1;
constexpr int kFS = kN1 * kKS;

// offsets in the flat float64 table buffer (tpumix_torch/ops/stft_dif.py _kernel_tables)
constexpr int kOffWin = 0;
constexpr int kOffTwc = kOffWin + kNfft;     // [16][128] cos(2 pi k1 n2 / 2048)
constexpr int kOffTws = kOffTwc + kN1 * kN2;
constexpr int kOffC128 = kOffTws + kN1 * kN2;  // [128] cos(2 pi m / 128)
constexpr int kOffS128 = kOffC128 + kN2;

static_assert(kTF * kN1 * 8 == kThreads, "C1: one 16-point FFT per thread");
static_assert(kTF * kN1 * 16 == 2 * kThreads, "C2: two 8-point FFTs per thread");

constexpr size_t kSmemZ = sizeof(double2) * kFS * kTF;
constexpr size_t kSmem = kSmemZ + sizeof(double2) * kN2;

__global__ void __launch_bounds__(kThreads, 2)
dif_kernel(const float* __restrict__ xp, float* __restrict__ out,
           const double* __restrict__ tab, int T, int tiles, long long Lp, int hop,
           float scale, double amin2) {
  extern __shared__ double2 smem[];
  double2* z = smem;
  double2* w128 = z + kFS * kTF;                     // (cos, sin)(2 pi m / 128)

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTF;
  const int tid = threadIdx.x;
  const float* row = xp + (long long)b * Lp;

  if (tid < kN2) w128[tid] = make_double2(__ldg(tab + kOffC128 + tid), __ldg(tab + kOffS128 + tid));

  // ---- stage A + twiddle: thread = (frame, n2) ----
  {
    const int n2 = tid & (kN2 - 1);
    const int f = tid / kN2;
    const int t = t0 + f;
    double yr[kK1U], yi[kK1U];
#pragma unroll
    for (int k = 0; k < kK1U; ++k) { yr[k] = 0.0; yi[k] = 0.0; }
    if (t < T) {
      const float* frame = row + (long long)t * hop + n2;
#pragma unroll
      for (int n1 = 0; n1 < kN1; ++n1) {
        const double v = static_cast<double>(__ldg(frame + n1 * kN2)) *
                         __ldg(tab + kOffWin + n1 * kN2 + n2);
#pragma unroll
        for (int k = 0; k < kK1U; ++k) {
          const double c = cos16(n1 * k), s = sin16(n1 * k);
          if (c != 0.0) yr[k] = fma(v, c, yr[k]);
          if (s != 0.0) yi[k] = fma(-v, s, yi[k]);
        }
      }
    }
    double2* zf = z + f * kFS + n2;
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1) {
      const double ar = k1 < kK1U ? yr[k1] : yr[kN1 - k1];
      const double ai = k1 < kK1U ? yi[k1] : -yi[kN1 - k1];
      const double ct = __ldg(tab + kOffTwc + k1 * kN2 + n2);
      const double st = __ldg(tab + kOffTws + k1 * kN2 + n2);
      zf[k1 * kKS] = make_double2(ar * ct + ai * st, ai * ct - ar * st);  // y * e^{-i theta}
    }
  }
  __syncthreads();

  // ---- C1: thread = (q, k1, f); 16-point FFT over p of z[8p + q], in place ----
  {
    const int q = tid & 7;
    const int k1 = (tid >> 3) & 15;
    const int f = tid >> 7;
    double2* zq = z + f * kFS + k1 * kKS + q;
    double2 a[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) a[p] = zq[8 * p];
    fft16(a);
    // now a[4c + d] = Y[c + 4d]; store Y[u] * W_128^(q*u) at n2 = 8u + q
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int u = c + 4 * d;
        const double2 w = w128[q * u];
        const double2 y = a[4 * c + d];
        zq[8 * u] = make_double2(y.x * w.x + y.y * w.y, y.y * w.x - y.x * w.y);
      }
    }
  }
  __syncthreads();

  // ---- C2: thread = (k1, u), both frames; 8-point FFT over q, bins 256v + 16u + k1 ----
  {
    const int k1 = tid & 15;
    const int u = tid >> 4;
#pragma unroll 1
    for (int f = 0; f < kTF; ++f) {
      const int t = t0 + f;
      if (t >= T) break;
      const double2* zu = z + f * kFS + k1 * kKS + 8 * u;
      double2 e0 = zu[0], e1 = zu[2], e2 = zu[4], e3 = zu[6];
      double2 o0 = zu[1], o1 = zu[3], o2 = zu[5], o3 = zu[7];
      dft4(e0, e1, e2, e3);
      dft4(o0, o1, o2, o3);
      o1 = mul_w16(o1, 2);  // W_8^v = W_16^(2v)
      o2 = mul_w16(o2, 4);
      o3 = mul_w16(o3, 6);
      float* o = out + ((long long)b * T + t) * kBins + 16 * u + k1;
      o[0] = db(e0.x + o0.x, e0.y + o0.y, scale, amin2);
      o[256] = db(e1.x + o1.x, e1.y + o1.y, scale, amin2);
      o[512] = db(e2.x + o2.x, e2.y + o2.y, scale, amin2);
      o[768] = db(e3.x + o3.x, e3.y + o3.y, scale, amin2);
      if (u == 0 && k1 == 0) o[1024] = db(e0.x - o0.x, e0.y - o0.y, scale, amin2);
    }
  }
}

}  // namespace

// xp: [B, Lp] reflect-padded float32 rows (Lp >= (T-1)*hop + 2048);
// out: [B, T, 1025] float32; tab: the flat float64 tables.  Returns the
// cudaError_t of the launch.
extern "C" int stft_dif_launch(const float* xp, float* out, const double* tab, int B, int T,
                               long long Lp, int hop, float scale, double amin2,
                               void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (hop <= 0 || (long long)(T - 1) * hop + kNfft > Lp) return (int)cudaErrorInvalidValue;
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
    e = cudaFuncSetAttribute(dif_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  dif_kernel<<<(unsigned)blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      xp, out, tab, T, tiles, Lp, hop, scale, amin2);
  return (int)cudaGetLastError();
}
