// Kernel K3: naive windowed-basis STFT -> dB frontend for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_stft_kernel` behind
//   `stft_features_pallas_tm` (tpumix/ops/stft_pallas.py:64, :119).
//
// Computes, per padded signal row b, frame t and onesided bin k:
//   X[k] = sum_n w[n] * x[b, t*hop + n] * exp(-2 pi i n k / n_fft)
//   out[b, t, k] = scale * ln(max(|X[k]|^2, amin^2))   (scale = (mult/2)/ln 10)
// for any n_fft that is a multiple of 16 and any hop; frame (b, t) is read in
// place from the padded signal at b*Lp + t*hop.
//
// The TPU kernel computes this as one dense product [B*T, n_fft] x [n_fft,
// 2*bins], because the MXU makes that cheap there.  That is its tactic, not
// the function: the dense product is 4 * n_fft * bins flops per frame (372
// GFLOP for one 64-chunk scalar2s segment) where a real FFT needs about
// 2.5 * n_fft * log2(n_fft) (2.7 GFLOP), and at the FP64 pipes' rate the dense
// form cannot go under 11 ms for that segment.  On this card address
// arithmetic is free and a frame fits in shared memory, so the DFT is
// factorized.
//
// What bounds it on this card: bytes (the audio read once, the features
// written once: 272 MB for that segment, 0.08 ms), like the other two
// frontend kernels, once the arithmetic is the FFT's.  Measured
// (chip_smoke.py [k3], H100 SXM at 700 W, [64,4,88200]): 1.0-1.1 ms at n_fft
// 2048 (the dense form took 21.0, torch.stft + abs + dB 1.7), 1.3 ms at 4096,
// 5.2 ms at 1200 (the dense tail), each 7.63e-6 dB from the dense float64
// product.
//
// Why float64 inside: a few bins of every segment sit 90 dB under their
// frame's energy (reflect-padded edge frames), and float32 arithmetic in any
// DFT structure is off there by more than the 0.2 dB the features are held to
// (PERF.md, Findings).  The result is rounded to float32 once, in the shared
// dB epilogue (dft_common.cuh), so a silent row gives the same float32 as
// from the other two frontend kernels.
//
// The design, for n_fft = 16^a * r (r not a multiple of 16; a >= 1):
//   - A block owns F consecutive frames of one signal row and keeps them in
//     shared memory as complex float64, F chosen so that they take about
//     64 KB.  Index i of a frame lives at i + i/16, which keeps the late
//     stages' strided 16-byte accesses off each other's banks.
//   - Stage 0 reads the frame from global memory, windows it while it is
//     staged, and is the first radix-16 step: with n = M*n1 + n2 (M = n_fft/16),
//     a thread takes the 16 samples of one n2, runs the register fft16 of
//     dft_common.cuh over n1, multiplies result k1 by W_n_fft^(n2 k1) and
//     stores it at k1*M + n2.  That leaves 16 subsequences of length M, each
//     of which needs an M-point DFT: stage s repeats the step inside every
//     subsequence of length L = n_fft/16^s.  Twiddles come from one float64
//     table of W_n_fft^e (stft_basis.py _kernel_tables), since W_L^(n2 k1) =
//     W_n_fft^(16^s n2 k1).
//   - After a stages the subsequences have length r and get a dense r-point
//     DFT with plain FP64 FMAs (8 r^2 flops each, 9 * 16^(a-1) of them per
//     frame: 83 kflop of a 2048-point frame's ~330 kflop, nothing at r = 1,
//     405 kflop and most of the work at n_fft = 1200, r = 75).  mma.sync f64
//     is not used: r is not a tile multiple in general and the kernel is
//     bound by bytes at the sizes the port runs.
//   - Real input: subsequence idx (base-16 digits = the stages' k1, first
//     stage leading) and tail output kr hold X[k], k = reverse(idx) + 16^a kr.
//     |X[n_fft - k]| = |X[k]|, so only subsequences whose first digit is at
//     most 8 are carried through stages 1.. and the tail (9/16 of the work);
//     a result goes to bin min(k, n_fft - k), and first digits 0 and 8, which
//     meet both k and n_fft - k, keep the lower one.  Every bin is written by
//     exactly one thread, so the output is deterministic.
//   - The dB values of the block's frames are gathered in shared memory in
//     natural bin order and leave as one contiguous run of the output,
//     16 bytes per store where the run is aligned.
//
// A frame's working set is about 19 * n_fft bytes (plus 16 r); where that is
// more than the 227 KB a block may use (n_fft above about 12000), the tiled
// dense kernel below (a register-tiled FP64 SIMT GEMM, 64 frames
// x 64 bins per block) runs instead.  stft_basis_launch chooses by n_fft;
// stft_basis_route says which.

#include <cuda_runtime.h>
#include <climits>

#include "dft_common.cuh"

namespace {

using namespace dftc;

// ---------------------------------------------------------------------------
// the factorized kernel
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;
constexpr int kMaxSmem = 232448;        // bytes a block may use on sm_90
constexpr int kFrameBudget = 80 * 1024;  // shared memory the frames of a block aim at

__device__ __forceinline__ int phys(int i) { return i + (i >> 4); }

struct FactGeom {
  int nfft, a, r, bins, F;
  int zstride;  // double2 per frame: nfft + nfft/16
  int hop, T, tiles;
  long long Lp;
};

__global__ void __launch_bounds__(kFThreads, 2)
basis_fact_kernel(const float* __restrict__ xp, float* __restrict__ out,
                  const double* __restrict__ tab, const FactGeom g, float scale, double amin2) {
  extern __shared__ double2 smem[];
  double2* z = smem;
  double2* wr = z + (size_t)g.F * g.zstride;            // W_r^j = (cos, sin)(2 pi j / r)
  float* outs = reinterpret_cast<float*>(wr + g.r);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.tiles;
  const int t0 = (blockIdx.x - b * g.tiles) * g.F;
  const int nf = min(g.F, g.T - t0);  // frames this block owns
  const int N = g.nfft;
  const double* win = tab;
  const double2* tw = reinterpret_cast<const double2*>(tab + N);  // (cos, sin)(2 pi e / N)
  const float* row = xp + (long long)b * g.Lp;

  for (int j = tid; j < g.r; j += kFThreads) wr[j] = __ldg(tw + j * (N / g.r));

  // ---- stage 0: window, 16-point DFT over n1, twiddle; item = (frame, n2) ----
  {
    const int M = N >> 4;
    for (int item = tid; item < nf * M; item += kFThreads) {
      const int f = item / M;
      const int n2 = item - f * M;
      const float* frame = row + (long long)(t0 + f) * g.hop + n2;
      double2 v[16];
#pragma unroll
      for (int n1 = 0; n1 < 16; ++n1) {
        v[n1] = make_double2(static_cast<double>(__ldg(frame + n1 * M)) * __ldg(win + n1 * M + n2),
                             0.0);
      }
      fft16(v);  // v[4c + d] = Y[c + 4d]
      double2* zf = z + (size_t)f * g.zstride;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int k1 = c + 4 * d;
          if (k1 <= 8) {  // the real input's other half is never needed
            const double2 w = __ldg(tw + n2 * k1);
            zf[phys(k1 * M + n2)] = mul_conj(v[4 * c + d], w.x, w.y);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- stages 1 .. a-1, in place; item = (frame, subsequence j, n2) ----
  int subs = 9;  // subsequences carried: first digit <= 8
  for (int s = 1; s < g.a; ++s) {
    const int L = N >> (4 * s);
    const int M = L >> 4;
    const int per_frame = subs * M;
    for (int item = tid; item < nf * per_frame; item += kFThreads) {
      const int f = item / per_frame;
      const int rem = item - f * per_frame;
      const int j = rem / M;
      const int n2 = rem - j * M;
      double2* zf = z + (size_t)f * g.zstride;
      const int base = j * L + n2;
      double2 v[16];
#pragma unroll
      for (int n1 = 0; n1 < 16; ++n1) v[n1] = zf[phys(base + n1 * M)];
      fft16(v);
      const int e1 = n2 << (4 * s);  // W_L^(n2 k1) = W_N^(16^s n2 k1)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int k1 = c + 4 * d;
          const double2 w = __ldg(tw + e1 * k1);
          zf[phys(base + k1 * M)] = mul_conj(v[4 * c + d], w.x, w.y);
        }
      }
    }
    subs *= 16;
    __syncthreads();
  }

  // ---- tail: dense r-point DFT of every carried subsequence; item = (frame, idx,
  //      four consecutive kr), so each value read feeds four sums ----
  {
    const int r = g.r;
    const int groups = (r + 3) >> 2;
    const int per_frame = subs * groups;
    const int top_div = subs / 9;          // 16^(a-1)
    const int kr_step = N / r;             // 16^a
    for (int item = tid; item < nf * per_frame; item += kFThreads) {
      const int f = item / per_frame;
      const int rem = item - f * per_frame;
      const int idx = rem / groups;
      const int kr0 = 4 * (rem - idx * groups);
      const double2* zs = z + (size_t)f * g.zstride;
      double re[4] = {0.0, 0.0, 0.0, 0.0}, im[4] = {0.0, 0.0, 0.0, 0.0};
      int e[4] = {0, 0, 0, 0};  // (m * kr) mod r
      for (int m = 0; m < r; ++m) {
        const double2 y = zs[phys(idx * r + m)];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const double2 w = wr[e[q]];
          re[q] = fma(y.x, w.x, fma(y.y, w.y, re[q]));
          im[q] = fma(y.y, w.x, fma(-y.x, w.y, im[q]));
          e[q] += kr0 + q < r ? kr0 + q : 0;  // a group's spare outputs stay at W^0
          if (e[q] >= r) e[q] -= r;
        }
      }
      int klow = 0;
      for (int d = 0, v = idx; d < g.a; ++d, v >>= 4) klow = (klow << 4) | (v & 15);
      const int top = idx / top_div;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = klow + (kr0 + q) * kr_step;
        if (kr0 + q < r && ((top >= 1 && top <= 7) || 2 * k <= N)) {
          outs[f * g.bins + (2 * k <= N ? k : N - k)] = db(re[q], im[q], scale, amin2);
        }
      }
    }
  }
  __syncthreads();

  // ---- the block's frames are one contiguous run of the output ----
  {
    const long long g0 = ((long long)b * g.T + t0) * g.bins;
    float* o = out + g0;
    const int total = nf * g.bins;
    const int head = min(total, (int)((4 - (g0 & 3)) & 3));  // scalars up to a 16-byte boundary
    const int body = (total - head) >> 2;
    if (tid < head) o[tid] = outs[tid];
    for (int q = tid; q < body; q += kFThreads) {
      const int at = head + 4 * q;
      *reinterpret_cast<float4*>(o + at) =
          make_float4(outs[at], outs[at + 1], outs[at + 2], outs[at + 3]);
    }
    const int done = head + 4 * body;
    if (tid < total - done) o[done + tid] = outs[done + tid];
  }
}

// Geometry of the factorized route; false where a frame does not fit.
bool fact_geometry(int nfft, int bins, int T, FactGeom* g, int* smem_bytes) {
  int a = 0, r = nfft;
  while (r % 16 == 0) { r /= 16; ++a; }
  if (a < 1) return false;
  const long long zstride = (long long)nfft + nfft / 16;
  const long long per_frame = zstride * 16 + (long long)bins * 4;
  const long long fixed = (long long)r * 16 + 16;  // the tail's W_r table
  if (per_frame + fixed > kMaxSmem) return false;
  long long F = kFrameBudget / per_frame;
  if (F < 1) F = 1;
  if (F > 16) F = 16;
  if (F > T) F = T;
  g->nfft = nfft; g->a = a; g->r = r; g->bins = bins; g->F = (int)F;
  g->zstride = (int)zstride;
  *smem_bytes = (int)(F * per_frame + fixed);
  return true;
}

// ---------------------------------------------------------------------------
// the tiled dense kernel (frames too long for shared memory)
// ---------------------------------------------------------------------------

constexpr int kMT = 64;        // frames per block
constexpr int kNT = 64;        // bins per block
constexpr int kKT = 16;        // n per step
constexpr int kThreads = 256;  // 16 (bins) x 16 (frames), 4 x 4 each
constexpr int kAS = kMT + 2;   // padded row of the signal tile (keeps 16-byte alignment)

__global__ void __launch_bounds__(kThreads, 2)
basis_dense_kernel(const float* __restrict__ xp, float* __restrict__ out,
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

// Which kernel stft_basis_launch runs for an n_fft: 1 the factorized kernel,
// 0 the tiled dense kernel, -1 neither (n_fft not a positive multiple of 16).
extern "C" int stft_basis_route(int nfft) {
  if (nfft <= 0 || nfft % 16 != 0) return -1;
  FactGeom g;
  int smem_bytes = 0;
  return fact_geometry(nfft, nfft / 2 + 1, 1, &g, &smem_bytes) ? 1 : 0;
}

// xp: [B, Lp] reflect-padded float32 rows (Lp >= (T-1)*hop + nfft); out: [B, T,
// bins] float32, bins = nfft/2 + 1; tab: [3*nfft] float64, the window then
// (cos, sin)(2 pi e / nfft) interleaved.  cosb, sinb: [nfft, bins_pad] float64
// windowed bases, bins_pad a multiple of 64 with zero columns past bins; read
// only on the dense route and may be null otherwise.  Returns the cudaError_t
// of the launch.
extern "C" int stft_basis_launch(const float* xp, float* out, const double* tab,
                                 const double* cosb, const double* sinb, int B, int T,
                                 long long Lp, int hop, int nfft, int bins, int bins_pad,
                                 float scale, double amin2, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int route = stft_basis_route(nfft);
  if (route < 0 || hop <= 0 || bins != nfft / 2 + 1 || (long long)(T - 1) * hop + nfft > Lp) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    FactGeom g;
    int smem_bytes = 0;
    fact_geometry(nfft, bins, T, &g, &smem_bytes);
    g.hop = hop; g.T = T; g.Lp = Lp;
    g.tiles = (T + g.F - 1) / g.F;
    const long long blocks = (long long)B * g.tiles;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    // the shared-memory opt-in is per device: set it once for each
    static bool configured[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
      e = cudaFuncSetAttribute(basis_fact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      configured[dev] = true;
    }
    basis_fact_kernel<<<(unsigned)blocks, kFThreads, smem_bytes, s>>>(xp, out, tab, g, scale,
                                                                      amin2);
    return (int)cudaGetLastError();
  }
  if (cosb == nullptr || sinb == nullptr || bins > bins_pad || bins_pad % kNT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * T;
  const long long mtiles = (M + kMT - 1) / kMT;
  const int ntiles = bins_pad / kNT;
  if (mtiles > INT_MAX || ntiles > 65535) return (int)cudaErrorInvalidValue;
  basis_dense_kernel<<<dim3((unsigned)mtiles, (unsigned)ntiles), kThreads, 0, s>>>(
      xp, out, cosb, sinb, M, T, Lp, hop, nfft, bins, bins_pad, scale, amin2);
  return (int)cudaGetLastError();
}
