// Kernel K4: DIT-factorized STFT -> dB frontend for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_ct_kernel` behind
//   `stft_features_ct_pallas_tm` (tpumix/ops/stft_ct_pallas.py:93, :147) and
//   the XLA prebuild of its phase frames (`ct_phase_frames`,
//   tpumix/ops/stft.py:191).
//
// Computes, per padded signal row b and frame t (n = 16*n2 + p, k = 128*k1 + k2):
//   stage 1  A_p[k2]      = sum_n2 w[n]*x[t*hop + n] * W_128^(n2*k2)     p = 0..15
//   twiddle  B_p[k2]      = A_p[k2] * W_2048^(p*k2)
//   stage 3  X[128*k1+k2] = sum_p B_p[k2] * W_16^(p*k1)                  k1 = 0..8
//   out[b, t, k] = scale * ln(max(|X|^2, amin^2))   (scale = (mult/2)/ln 10)
// and writes the 1025 onesided bins, which this factorization yields in
// natural order (k1-major).  Stage 1 is itself factored (n2 = 8*g + q,
// k2 = u + 16*v), as stage C of stft_dif.cu:
//   1a  Y_q[u]  = W_128^(q*u) * sum_g f_p[8g+q] * W_16^(g*u)   (radix-4 x 4 FFT)
//   1b  A_p[k2] = sum_q Y_q[u] * W_8^(q*v)                      (radix-2 x 4 FFT)
//
// Differences from the TPU form.  There the phase-decimated frames
// [B, 16, T, 128] are built in HBM by XLA, because Mosaic cannot take
// stride-16 slices; here the stride-16 gather happens while a frame is staged
// into shared memory, so no such tensor exists.  The TPU kernel runs stage 1
// as a dense [T,128]@[128,256] MXU dot; here it is an FFT on the FP64 pipes.
//
// What bounds it on this card: memory, as for K1 (the same function: ~2.7
// GFLOP of FFT work for one 64-chunk segment against ~272 MB of input and
// output).
//
// Why float64 inside: as in stft_dif.cu.  A few bins of every segment sit
// 90 dB under their frame's energy (reflect-padded edge frames), where each
// float32 rounding of any stage is a large share of the bin; a float32
// version of these same stages sits near the 0.1 dB the features are held to
// (PERF.md, Findings).
//
// What the design does about it: a block owns one signal row and TF = 2
// frames, so overlapping frames are read from L1/L2.  The frames land in
// shared memory phase-major (z[p][n2], 64.5 KB), stages 1a and 1b run in place
// there with one thread per small FFT, and stage 3 (one thread per k2: the
// twiddle, a 16-point FFT over p) writes 128 consecutive bins per k1 straight
// to the output.  A phase stride of 129 and a rotation of each 8-slot group in
// 1b keep every quarter-warp of 16-byte accesses on eight distinct bank
// groups in all four phases.  The input is real, so half of stage 1 is
// redundant (two phases could share one complex FFT); it is kept simple.

#include <cuda_runtime.h>
#include <climits>

#include "dft_common.cuh"

namespace {

using namespace dftc;

constexpr int kP = 16;      // phases
constexpr int kN2 = 128;    // samples per phase
constexpr int kNfft = kP * kN2;
constexpr int kBins = kNfft / 2 + 1;
constexpr int kTF = 2;      // frames per block
constexpr int kThreads = kTF * kN2;

// z[f * kFS + p * kPS + slot], double2; kPS odd (see above)
constexpr int kPS = kN2 + 1;
constexpr int kFS = kP * kPS;

// offsets in the flat float64 table buffer (tpumix_torch/ops/stft_dif.py
// _kernel_tables; cos(2 pi p k2 / 2048) is that table's [k1][n2] twiddle)
constexpr int kOffWin = 0;
constexpr int kOffTwc = kOffWin + kNfft;     // [16][128] cos(2 pi p k2 / 2048)
constexpr int kOffTws = kOffTwc + kP * kN2;
constexpr int kOffC128 = kOffTws + kP * kN2;  // [128] cos(2 pi m / 128)
constexpr int kOffS128 = kOffC128 + kN2;

static_assert(kTF * kP * 8 == kThreads, "1a: one 16-point FFT per thread");
static_assert(kTF * kP * 16 == 2 * kThreads, "1b: two 8-point FFTs per thread");

constexpr size_t kSmem = sizeof(double2) * (kFS * kTF + kN2);

// where 1b leaves A_p[u + 16 v] inside the 8-slot group of u
__device__ __forceinline__ int slot_of(int u, int v) { return 8 * u + ((v + u) & 7); }

__global__ void __launch_bounds__(kThreads, 2)
ct_kernel(const float* __restrict__ xp, float* __restrict__ out,
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

  // ---- stage the windowed frames phase-major: thread = (frame, n mod 128) ----
  {
    const int j = tid & (kN2 - 1);
    const int f = tid / kN2;
    const int t = t0 + f;
    const int p = j & (kP - 1);            // n = j + 128 i keeps n mod 16
    double2* zp = z + f * kFS + p * kPS + (j >> 4);
    const float* frame = row + (long long)t * hop + j;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      double v = 0.0;
      if (t < T) v = static_cast<double>(__ldg(frame + i * kN2)) * __ldg(tab + kOffWin + i * kN2 + j);
      zp[8 * i] = make_double2(v, 0.0);    // n2 = (j >> 4) + 8 i
    }
  }
  __syncthreads();

  // ---- 1a: thread = (q, p, f); 16-point FFT over g of z[8g + q], in place ----
  {
    const int q = tid & 7;
    const int p = (tid >> 3) & 15;
    const int f = tid >> 7;
    double2* zq = z + f * kFS + p * kPS + q;
    double2 a[16];
#pragma unroll
    for (int g = 0; g < 16; ++g) a[g] = zq[8 * g];
    fft16(a);
    // a[4c + d] = Y[c + 4d]; store Y[u] * W_128^(q*u) at 8u + q
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int u = c + 4 * d;
        const double2 w = w128[q * u];
        zq[8 * u] = mul_conj(a[4 * c + d], w.x, w.y);
      }
    }
  }
  __syncthreads();

  // ---- 1b: thread = (p, u), both frames; 8-point FFT over q -> A_p[u + 16 v] ----
  {
    const int p = tid & 15;
    const int u = tid >> 4;
#pragma unroll 1
    for (int f = 0; f < kTF; ++f) {
      double2* zu = z + f * kFS + p * kPS + 8 * u;
      double2 e0 = zu[0], e1 = zu[2], e2 = zu[4], e3 = zu[6];
      double2 o0 = zu[1], o1 = zu[3], o2 = zu[5], o3 = zu[7];
      dft4(e0, e1, e2, e3);
      dft4(o0, o1, o2, o3);
      o1 = mul_w16(o1, 2);  // W_8^v = W_16^(2v)
      o2 = mul_w16(o2, 4);
      o3 = mul_w16(o3, 6);
      double2* zg = z + f * kFS + p * kPS;
      zg[slot_of(u, 0)] = make_double2(e0.x + o0.x, e0.y + o0.y);
      zg[slot_of(u, 1)] = make_double2(e1.x + o1.x, e1.y + o1.y);
      zg[slot_of(u, 2)] = make_double2(e2.x + o2.x, e2.y + o2.y);
      zg[slot_of(u, 3)] = make_double2(e3.x + o3.x, e3.y + o3.y);
      zg[slot_of(u, 4)] = make_double2(e0.x - o0.x, e0.y - o0.y);
      zg[slot_of(u, 5)] = make_double2(e1.x - o1.x, e1.y - o1.y);
      zg[slot_of(u, 6)] = make_double2(e2.x - o2.x, e2.y - o2.y);
      zg[slot_of(u, 7)] = make_double2(e3.x - o3.x, e3.y - o3.y);
    }
  }
  __syncthreads();

  // ---- twiddle + stage 3: thread = (frame, k2); 16-point FFT over p ----
  {
    const int k2 = tid & (kN2 - 1);
    const int f = tid / kN2;
    const int t = t0 + f;
    if (t < T) {
      const double2* zk = z + f * kFS + slot_of(k2 & 15, k2 >> 4);
      double2 a[16];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        a[p] = mul_conj(zk[p * kPS], __ldg(tab + kOffTwc + p * kN2 + k2),
                        __ldg(tab + kOffTws + p * kN2 + k2));
      }
      fft16(a);  // a[4c + d] = X[128 (c + 4d) + k2]
      float* o = out + ((long long)b * T + t) * kBins + k2;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[kN2 * c] = db(a[4 * c].x, a[4 * c].y, scale, amin2);
        o[kN2 * (c + 4)] = db(a[4 * c + 1].x, a[4 * c + 1].y, scale, amin2);
      }
      if (k2 == 0) o[kN2 * 8] = db(a[2].x, a[2].y, scale, amin2);
    }
  }
}

}  // namespace

// xp: [B, Lp] reflect-padded float32 rows (Lp >= (T-1)*hop + 2048);
// out: [B, T, 1025] float32; tab: the flat float64 tables.  Returns the
// cudaError_t of the launch.
extern "C" int stft_ct_launch(const float* xp, float* out, const double* tab, int B, int T,
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
    e = cudaFuncSetAttribute(ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  ct_kernel<<<(unsigned)blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      xp, out, tab, T, tiles, Lp, hop, scale, amin2);
  return (int)cudaGetLastError();
}
