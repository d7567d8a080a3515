// Kernel K3: naive windowed-basis STFT -> dB frontend for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_stft_kernel` behind
//   `stft_features_pallas_tm` (tpumix/ops/stft_pallas.py:64, :119).
//
// Computes, per padded signal row b, frame t and onesided bin k:
//   re = sum_n x[b, t*hop + n] * wcos[n, k]      wcos = w[n] *  cos(2 pi n k / n_fft)
//   im = sum_n x[b, t*hop + n] * wsin[n, k]      wsin = w[n] * -sin(2 pi n k / n_fft)
//   out[b, t, k] = scale * ln(max(re^2 + im^2, amin^2))   (scale = (mult/2)/ln 10)
// which is one matrix product [B*T, n_fft] x [n_fft, 2*bins] whose left
// operand is never materialised: frame rows overlap, and row m = (b, t) of it
// is read in place from the padded signal at b*Lp + t*hop.  Any n_fft that is
// a multiple of 16 and any hop; the bases come padded to a multiple of 64 bins.
//
// Differences from the TPU form.  There the bin axis is tiled to fit VMEM,
// frames are rebuilt from hop-sized rows as R = n_fft/hop partial MXU dots
// (Mosaic cannot concatenate slices at sublane offsets), and each f32 dot is
// split into bf16 passes.  None of that exists here: the frame gather is plain
// address arithmetic, and the product runs on the FP64 pipes.
//
// What bounds it on this card: operations.  4 * B*T * n_fft * bins flops
// (372 GFLOP for one 64-chunk scalar2s segment) against ~272 MB of input and
// output: it is two orders above the factorized frontends by construction and
// is the fallback for hops they cannot take.
//
// Why float64 inside: each bin sums n_fft products, and a few bins of every
// segment sit 90 dB under their frame's energy (reflect-padded edge frames).
// A float32 sum of 2048 terms there is off by more than the 0.2 dB the
// features are held to (PERF.md, Findings).
//
// What the design does about it: a register-tiled SIMT GEMM.  A block owns 64
// frames x 64 bins (re and im: 128 basis columns) and walks n in steps of 16;
// each of its 256 threads holds 4 frames x 4 bins x (re, im) = 32 float64
// sums.  The signal tile is converted to float64 while it is staged, k-major
// with a padded row so the fill and the reads stay off each other's banks;
// a thread's bins are two pairs 32 apart, so every 16-byte read of the basis
// tile is contiguous across a half-warp.  The m-tile is the fast grid axis, so
// the blocks in flight share one 2 MB basis slice in L2 while they stream
// different signal rows.

#include <cuda_runtime.h>
#include <climits>

#include "dft_common.cuh"

namespace {

using namespace dftc;

constexpr int kMT = 64;        // frames per block
constexpr int kNT = 64;        // bins per block
constexpr int kKT = 16;        // n per step
constexpr int kThreads = 256;  // 16 (bins) x 16 (frames), 4 x 4 each
constexpr int kAS = kMT + 2;   // padded row of the signal tile (keeps 16-byte alignment)

__global__ void __launch_bounds__(kThreads, 2)
basis_kernel(const float* __restrict__ xp, float* __restrict__ out,
             const double* __restrict__ cosb, const double* __restrict__ sinb,
             long long M, int T, long long Lp, int hop, int nfft, int bins, int bins_pad,
             float scale, double amin2) {
  __shared__ __align__(16) double As[kKT][kAS];
  __shared__ __align__(16) double Bs[kKT][2 * kNT];  // [.., 0:64] cos, [.., 64:128] -sin

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kMT;
  const int n0 = blockIdx.y * kNT;

  // signal-tile fill: thread = (kk = tid & 15, frames (tid >> 4) + 16 j)
  const int fkk = tid & (kKT - 1);
  const float* src[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + (tid >> 4) + 16 * j;
    src[j] = m < M ? xp + (m / T) * Lp + (m % T) * hop + fkk : nullptr;
  }
  // basis-tile fill: thread = (16-byte column pair tid & 31, rows (tid >> 5) + 8 j)
  const int bcol = 2 * (tid & 31);
  const int brow = tid >> 5;

  // compute: thread = (tx = tid & 15 -> bins 2tx, 2tx+1, 32+2tx, 33+2tx; ty -> 4 frames)
  const int tx = tid & 15;
  const int ty = tid >> 4;
  double re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) { re[i][j] = 0.0; im[i][j] = 0.0; }
  }

  for (int k0 = 0; k0 < nfft; k0 += kKT) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[fkk][(tid >> 4) + 16 * j] = src[j] ? static_cast<double>(__ldg(src[j] + k0)) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long at = (long long)(k0 + brow + 8 * j) * bins_pad + n0 + bcol;
      *reinterpret_cast<double2*>(&Bs[brow + 8 * j][bcol]) =
          __ldg(reinterpret_cast<const double2*>(cosb + at));
      *reinterpret_cast<double2*>(&Bs[brow + 8 * j][kNT + bcol]) =
          __ldg(reinterpret_cast<const double2*>(sinb + at));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const double2 a01 = *reinterpret_cast<const double2*>(&As[kk][4 * ty]);
      const double2 a23 = *reinterpret_cast<const double2*>(&As[kk][4 * ty + 2]);
      const double2 c01 = *reinterpret_cast<const double2*>(&Bs[kk][2 * tx]);
      const double2 c23 = *reinterpret_cast<const double2*>(&Bs[kk][32 + 2 * tx]);
      const double2 s01 = *reinterpret_cast<const double2*>(&Bs[kk][kNT + 2 * tx]);
      const double2 s23 = *reinterpret_cast<const double2*>(&Bs[kk][kNT + 32 + 2 * tx]);
      const double a[4] = {a01.x, a01.y, a23.x, a23.y};
      const double c[4] = {c01.x, c01.y, c23.x, c23.y};
      const double s[4] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fma(a[i], c[j], re[i][j]);
          im[i][j] = fma(a[i], s[j], im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * ty + i;
    if (m >= M) break;
    float* o = out + m * bins + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = (j < 2 ? 0 : 32) + 2 * tx + (j & 1);
      if (n0 + n < bins) o[n] = db(re[i][j], im[i][j], scale, amin2);
    }
  }
}

}  // namespace

// xp: [B, Lp] reflect-padded float32 rows (Lp >= (T-1)*hop + nfft);
// cosb, sinb: [nfft, bins_pad] float64 windowed bases, bins_pad a multiple of
// 64 with zero columns past bins; out: [B, T, bins] float32.  Returns the
// cudaError_t of the launch.
extern "C" int stft_basis_launch(const float* xp, float* out, const double* cosb,
                                 const double* sinb, int B, int T, long long Lp, int hop,
                                 int nfft, int bins, int bins_pad, float scale, double amin2,
                                 void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (hop <= 0 || nfft <= 0 || nfft % kKT != 0 || bins <= 0 || bins > bins_pad ||
      bins_pad % kNT != 0 || (long long)(T - 1) * hop + nfft > Lp) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * T;
  const long long mtiles = (M + kMT - 1) / kMT;
  const int ntiles = bins_pad / kNT;
  if (mtiles > INT_MAX || ntiles > 65535) return (int)cudaErrorInvalidValue;
  basis_kernel<<<dim3((unsigned)mtiles, (unsigned)ntiles), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      xp, out, cosb, sinb, M, T, Lp, hop, nfft, bins, bins_pad, scale, amin2);
  return (int)cudaGetLastError();
}
