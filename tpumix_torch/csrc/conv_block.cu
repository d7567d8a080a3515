// Kernel K2: fused conv + folded BatchNorm + ReLU block for Hopper (sm_90a).
//
// Replaces: the four Pallas TPU entry points of tpumix/ops/conv_block_pallas.py,
//   which compute one function and differ only in Mosaic tiling tactics:
//   conv_block_fused_v2 (_kernel2), conv_block_fused_khpack_v2 (_kernel_khpack2),
//   conv_block_fused (_kernel) and conv_block_fused_khpack (_kernel_khpack).
//
// Computes  out[n, ho, wo, co] = max(scale[co] * sum_{i,j,c} x[n, ho+i, wo+j, c]
//                                               * w[i, j, c, co] + shift[co], 0)
// for NHWC float32 x, HWIO float32 w, stride 1, dilation 1, VALID padding.
// It is an implicit GEMM: M = N*Ho*Wo output pixels, N-dim = Cout, K =
// kh*kw*Cin; HWIO flattens to a row-major [K, Cout] matrix and the NHWC
// output is a row-major [M, Cout] matrix, so only A is implicit.
//
// What bounds it on this card: the FP32 pipes.  The trunk's blocks 2-5 do
// about 3.6 TFLOP per 64-chunk segment against a few GB of activations, so
// at 67 TFLOP/s and 3.35 TB/s the flops take tens of times longer than the
// bytes.  The tensor cores would need TF32, which costs the gains their 1e-3
// conformance; 3xTF32 on wgmma is later work.
//
// What the design does about it: classic register-tiled SIMT GEMM.  A block
// computes a BM x BN output tile with 256 threads, each owning TM x TN = 8x8
// (or 8x4) accumulators, and walks K in steps of 16.  Each step gathers the
// A tile (16 consecutive k = 16 channels of one tap, so every 4-float load is
// contiguous NHWC memory) and the B tile into double-buffered shared memory
// while the previous tile is multiplied, so each k costs 4 shared 128-bit
// loads for 64 FMAs.  BN tracks Cout (128, 64 or 32) so the narrow blocks
// waste no lanes.  The epilogue applies scale, shift and ReLU in registers
// and writes the output once; no intermediate reaches device memory.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBK = 16;
constexpr int kThreads = 256;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv_block_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  float* __restrict__ out, int H, int W, int Cin, int kw, int Ho, int Wo,
                  int Cout, long long M, int K) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile must cover the block tile");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "tiles are read in float4");
  constexpr int A_LD = BM * kBK / 4 / kThreads;        // float4 of A per thread
  constexpr int B_VEC = kBK * BN / 4;                   // float4 in a B tile
  constexpr int B_LD = (B_VEC + kThreads - 1) / kThreads;
  constexpr int TX = BN / TN;

  __shared__ __align__(16) float As[2][kBK][BM];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // each A slot owns one output pixel and one group of 4 k
  long long a_base[A_LD];
  bool a_ok[A_LD];
#pragma unroll
  for (int r = 0; r < A_LD; ++r) {
    const int q = tid + kThreads * r;
    const long long m = m0 + q % BM;
    a_ok[r] = m < M;
    const long long mm = a_ok[r] ? m : 0;
    const long long hw = (long long)Ho * Wo;
    const long long n = mm / hw;
    const long long rem = mm - n * hw;
    const long long ho = rem / Wo;
    const long long wo = rem - ho * Wo;
    a_base[r] = ((n * H + ho) * W + wo) * Cin;
  }

  float4 a_reg[A_LD];
  float4 b_reg[B_LD];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_LD; ++r) {
      const int q = tid + kThreads * r;
      const int k = k0 + 4 * (q / BM);
      a_reg[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_ok[r] && k < K) {
        const int tap = k / Cin;
        const int c = k - tap * Cin;
        const int i = tap / kw;
        const int j = tap - i * kw;
        a_reg[r] = __ldg(reinterpret_cast<const float4*>(
            x + a_base[r] + ((long long)i * W + j) * Cin + c));
      }
    }
#pragma unroll
    for (int r = 0; r < B_LD; ++r) {
      const int q = tid + kThreads * r;
      b_reg[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < B_VEC) {
        const int k = k0 + q / (BN / 4);
        const int col = n0 + (q % (BN / 4)) * 4;
        if (k < K && col < Cout) {
          b_reg[r] = __ldg(reinterpret_cast<const float4*>(w + (long long)k * Cout + col));
        }
      }
    }
  };

  auto store_tile = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_LD; ++r) {
      const int q = tid + kThreads * r;
      const int ml = q % BM;
      const int kq = 4 * (q / BM);
      As[buf][kq + 0][ml] = a_reg[r].x;
      As[buf][kq + 1][ml] = a_reg[r].y;
      As[buf][kq + 2][ml] = a_reg[r].z;
      As[buf][kq + 3][ml] = a_reg[r].w;
    }
#pragma unroll
    for (int r = 0; r < B_LD; ++r) {
      const int q = tid + kThreads * r;
      if (q < B_VEC) {
        *reinterpret_cast<float4*>(&Bs[buf][q / (BN / 4)][(q % (BN / 4)) * 4]) = b_reg[r];
      }
    }
  };

  // thread tile: rows ty*4 + g*(BM*4/TM) and columns tx*4 + g*(BN*4/TN), so
  // neighbouring threads read neighbouring float4 of shared memory
  const int ty = tid / TX;
  const int tx = tid % TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int ktiles = (K + kBK - 1) / kBK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load_tile((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][kk][g * (BM * 4 / TM) + ty * 4]);
        a[4 * g + 0] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[cur][kk][g * (BN * 4 / TN) + tx * 4]);
        b[4 * g + 0] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) store_tile(cur ^ 1);
    __syncthreads();
  }

  // epilogue: folded BN + ReLU, one float4 store per 4 columns
#pragma unroll
  for (int gj = 0; gj < TN / 4; ++gj) {
    const int col = n0 + gj * (BN * 4 / TN) + tx * 4;
    if (col >= Cout) continue;
    const float4 s = __ldg(reinterpret_cast<const float4*>(scale + col));
    const float4 t = __ldg(reinterpret_cast<const float4*>(shift + col));
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + (i / 4) * (BM * 4 / TM) + ty * 4 + (i % 4);
      if (m >= M) continue;
      float4 v;
      v.x = fmaxf(fmaf(acc[i][4 * gj + 0], s.x, t.x), 0.f);
      v.y = fmaxf(fmaf(acc[i][4 * gj + 1], s.y, t.y), 0.f);
      v.z = fmaxf(fmaf(acc[i][4 * gj + 2], s.z, t.z), 0.f);
      v.w = fmaxf(fmaf(acc[i][4 * gj + 3], s.w, t.w), 0.f);
      *reinterpret_cast<float4*>(out + m * Cout + col) = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* x, const float* w, const float* scale, const float* shift,
                   float* out, int H, int W, int Cin, int kw, int Ho, int Wo, int Cout,
                   long long M, int K, cudaStream_t stream) {
  const long long gx = (M + BM - 1) / BM;
  if (gx > INT_MAX) return cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)((Cout + BN - 1) / BN));
  conv_block_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, K);
  return cudaGetLastError();
}

}  // namespace

// x: [N, H, W, Cin] contiguous; w: [kh, kw, Cin, Cout] contiguous; scale, shift:
// [Cout]; out: [N, H-kh+1, W-kw+1, Cout].  All float32, 16-byte aligned, with
// Cin and Cout multiples of 4.  Returns the cudaError_t of the launch.
extern "C" int conv_block_launch(const float* x, const float* w, const float* scale,
                                 const float* shift, float* out, int N, int H, int W, int Cin,
                                 int kh, int kw, int Cout, void* stream) {
  const int Ho = H - kh + 1;
  const int Wo = W - kw + 1;
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || Cout <= 0 || Cin % 4 || Cout % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)N * Ho * Wo;
  const long long K = (long long)kh * kw * Cin;
  if (K > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (Cout > 64) {
    e = launch<128, 128, 8, 8>(x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, (int)K, s);
  } else if (Cout > 32) {
    e = launch<256, 64, 8, 8>(x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, (int)K, s);
  } else {
    e = launch<256, 32, 8, 4>(x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, (int)K, s);
  }
  return (int)e;
}
