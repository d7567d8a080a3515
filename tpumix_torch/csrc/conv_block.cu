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
// kh*kw*Cin; the NHWC output is a row-major [M, Cout] matrix and only A is
// implicit.
//
// What bounds it on this card: operations.  The trunk's blocks 2-5 do about
// 3.6 TFLOP per 64-chunk segment against a few GB of activations.  The FP32
// pipes (67 TFLOP/s) would take 53 ms for them; the tensor cores take TF32
// operands only, and one TF32 product (10 mantissa bits) would cost the
// gains their conformance.  So every product is made of three TF32 products
// ("3xTF32"): each float32 value v is split into hi = rna_tf32(v) and
// lo = v - hi (exact in float32, |lo| <= 2^-11 |v|; the tensor core reads the
// upper 19 bits of it), and
//     a * b ~= a_lo * b_hi + a_hi * b_lo + a_hi * b_hi      (small terms first)
// with float32 accumulation, dropping a_lo * b_lo (2^-22 of the product).
// At 495 TFLOP/s of TF32 that is 165 TFLOP/s of float32-grade product, which
// bounds blocks 2-5 at 21.5 ms.  Measured (chip_smoke.py [k2], H100 SXM at
// 700 W): 41.3 ms, 44-99 TFLOP/s counted once per product, 2.1-5.3x the speed
// of cuDNN's float32 convolution; block 5 holds the card at its power limit,
// where the SM clock falls from 1980 to about 1650 MHz.  Details: PERF.md.
//
// Two kernels, chosen by shape in conv_block_launch (conv_block_route says
// which):
//
// 1. wgmma (Cin % 8 == 0, Cout in {32, 48, 64, 128}, the tile fits in shared
//    memory): a block of two warpgroups computes 128 consecutive output
//    pixels of one image x all Cout channels; each warpgroup owns 64 rows and
//    issues wgmma.mma_async m64nNk8 (N = Cout) with A in registers and B in
//    shared memory.
//    - B: the weights come packed once by the wrapper (conv_block.py
//      pack_conv_weights) as hi and lo [Cout, Kp] float32 arrays, K-major as
//      TF32 wgmma requires, k ordered (i, j, c) with each kernel row i padded
//      to a multiple of 32.  A chunk of 32 k is one 128-byte row per channel;
//      cp.async writes it into a 4-stage ring in the 128-byte-swizzled layout
//      the descriptor names.
//    - A, from registers (the RS form), because for a fixed kernel row i the
//      kw*Cin values under output pixel (ho, wo) are one contiguous run of
//      NHWC memory starting at x[n, ho+i, wo, 0], and neighbouring pixels
//      overlap it shifted by Cin.  So the block stages the input strip under
//      its 128 pixels once per kernel row (cp.async, double-buffered; pixels
//      padded by 4 floats so fragment reads hit 32 distinct banks) and every
//      tap j reads its fragment from it at offset j: each input value
//      reaches shared memory kh times, not kh*kw times, no im2col tile and no
//      second (hi/lo) copy of A exists, and A needs no proxy fence.  A thread
//      loads its 4 fragment values with ld.shared, splits them in registers
//      (cvt.rna.tf32.f32, sub.f32) and issues the three products.  An SS form
//      could not name this overlapping layout in a descriptor at all.
//    - Pipeline: per chunk one __syncthreads; loads run two chunks ahead;
//      each k-step of 8 commits its three products as one group and waits
//      for the previous group only, so the tensor cores always have work
//      queued while the next fragment is split.
//    - Accumulation.  The tensor cores add into their float32 accumulators
//      by truncation, not to nearest: left alone over block 5's K = 5184 the
//      error grows with K to 3.3e-4 of an O(1) output, past the tolerance
//      (the kernel is held to rtol 1e-4, atol 5e-5 of a float64 reference).
//      So the accumulators are drained at every chunk: wait for the chunk's
//      products, add them into a second register set with add.f32 (round to
//      nearest), and let the next chunk's first product overwrite them
//      (scale-d = 0).  A chunk's partial sum is small, so what truncation
//      costs it is small.  Measured max abs error at block 5 (chip_smoke.py
//      [k2], H100 SXM): 5.2e-6 with the drain, 3.4e-4 without; the drain costs
//      about a tenth of the kernel's time.
//    - Epilogue from the registers: scale, shift, ReLU, one shuffle between
//      lane pairs so that every store is 16 bytes.
//
// 2. SIMT (every other shape with Cin % 4 == 0 and Cout % 4 == 0): the
//    register-tiled FP32 implicit GEMM on the CUDA cores.  A block computes a
//    BM x BN output tile with 256 threads, each owning 8x8 (or 8x4)
//    accumulators, and walks K in steps of 16 through double-buffered shared
//    memory.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "wgmma_tf32.cuh"

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


// ---------------------------------------------------------------------------
// the wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;      // output pixels per block: two warpgroups x 64 rows
constexpr int kWgThreads = 256;
constexpr int kWgKC = 32;       // k per weight chunk: one 128-byte swizzled row per channel
constexpr int kWgStages = 4;    // weight-chunk ring; loads run two chunks ahead
constexpr int kWgPad = 4;       // floats between staged pixels (bank spread of fragment reads)
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct WgGeom {
  int H, W, Cin, kh, kw, Wo, HoWo, tiles;  // tiles of kWgBM pixels per image
  int cpr;        // weight chunks per kernel row: ceil(kw*Cin / 32)
  int Kp;         // packed K: kh * cpr * 32
  int cs;         // staged pixel stride in floats: Cin + kWgPad
  int strip_floats;  // one strip buffer
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

template <int N, bool kDrain>
__global__ void __launch_bounds__(kWgThreads, 1)
conv_block_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        float* __restrict__ out, const WgGeom g) {
  constexpr int kTile = N * 128;           // bytes of one hi (or lo) chunk tile
  constexpr int kStage = 2 * kTile;        // hi then lo
  constexpr int kAcc = N / 2;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need a 1024-byte boundary: round the window's start up
  const uint32_t raw0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw0 + 1023u) & ~1023u;           // kWgStages x kStage
  const uint32_t strips = ring + kWgStages * kStage;       // 2 x strip_floats
  const float* strip_ptr = reinterpret_cast<const float*>(smem_raw + (strips - raw0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gq = lane >> 2;   // fragment row within 8
  const int tq = lane & 3;    // fragment column within 4
  const int n_img = blockIdx.x / g.tiles;
  const int tile = blockIdx.x - n_img * g.tiles;
  const int m0 = tile * kWgBM;
  const int m_last = min(m0 + kWgBM, g.HoWo) - 1;
  const int q0 = (m0 / g.Wo) * g.W + m0 % g.Wo;
  const int npx = (m_last / g.Wo) * g.W + m_last % g.Wo - q0 + g.kw;  // pixels in a strip
  const int c4 = g.Cin >> 2;
  const float* ximg = x + ((long long)n_img * g.H * g.W + q0) * g.Cin;

  auto load_strip = [&](int i) {
    const float* src = ximg + (long long)i * g.W * g.Cin;
    const uint32_t dst = strips + (uint32_t)(i & 1) * g.strip_floats * 4u;
    for (int p = tid; p < npx * c4; p += kWgThreads) {
      const int px = p / c4;
      const int part = p - px * c4;
      cp_async16(dst + (uint32_t)(px * g.cs + part * 4) * 4u, src + px * g.Cin + part * 4);
    }
  };
  auto load_chunk = [&](int t) {
    const uint32_t dst = ring + (uint32_t)(t % kWgStages) * kStage;
    const float* src = wp + (long long)t * kWgKC;
#pragma unroll
    for (int it = 0; it < 2 * N * 8 / kWgThreads; ++it) {
      const int p = tid + it * kWgThreads;
      const int which = p / (N * 8);
      const int rem = p - which * (N * 8);
      const int n = rem >> 3;
      const int q = rem & 7;
      cp_async16(dst + which * kTile + n * 128 + ((q ^ (n & 7)) << 4),
                 src + ((long long)which * N + n) * g.Kp + q * 4);
    }
  };

  // this thread's two fragment rows, as float offsets into a strip
  int ro[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = min(m0 + (tid >> 5) * 16 + gq + 8 * r, g.HoWo - 1);
    ro[r] = ((m / g.Wo) * g.W + m % g.Wo - q0) * g.cs + tq;
  }

  // acc: the tensor cores' running sum, restarted at every chunk (kDrain);
  // sum: the chunks' sums, added up by the FP32 pipes (round to nearest)
  float acc[kAcc], sum[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) { acc[e] = 0.f; sum[e] = 0.f; }

  const int total = g.kh * g.cpr;
  const int row_k = g.kw * g.Cin;
  load_strip(0);
  load_chunk(0);
  cp_async_commit();
  if (1 < total) load_chunk(1);
  cp_async_commit();

  int i = 0, c = 0;       // kernel row and chunk within it
  int cc = 0, koff = 0;   // channel within the tap, float offset of the k-step in the strip
  for (int t = 0; t < total; ++t) {
    // chunk t and strip i have landed (strip i rides in the group committed at
    // the first chunk of row i-1: one group back only if a row is one chunk)
    if (g.cpr < 2) cp_async_wait<0>(); else cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // every warp is past chunk t-1: stage (t+2) % 4 and strip (i+1) & 1 are free
    if (t + 2 < total) load_chunk(t + 2);
    if (c == 0 && i + 1 < g.kh) load_strip(i + 1);
    cp_async_commit();

    const float* sp = strip_ptr + (i & 1) * g.strip_floats;
    const uint64_t d_hi = wg::b_desc(ring + (uint32_t)(t % kWgStages) * kStage);
    const uint64_t d_lo = d_hi + (kTile >> 4);
    const int nk8 = min(4, (row_k - c * kWgKC) >> 3);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < nk8) {
        const float* a0 = sp + ro[0] + koff;
        const float* a1 = sp + ro[1] + koff;
        const float v[4] = {a0[0], a1[0], a0[4], a1[4]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = rna_tf32(v[e]);
          lo[e] = __float_as_uint(v[e] - __uint_as_float(hi[e]));
        }
        // a chunk's first product overwrites acc (the kernel's first, undrained)
        const int keep = (s == 0 && (kDrain || t == 0)) ? 0 : 1;
        wg::fence();
        wg::Mma<N>::rs(acc, lo, d_hi + 2 * s, keep);
        wg::Mma<N>::rs(acc, hi, d_lo + 2 * s, 1);
        wg::Mma<N>::rs(acc, hi, d_hi + 2 * s, 1);
        wg::commit();
        wg::wait<1>();
        cc += 8;
        koff += 8;
        if (cc == g.Cin) { cc = 0; koff += kWgPad; }
      }
    }
    if (++c == g.cpr) { c = 0; ++i; cc = 0; koff = 0; }
    if (kDrain) {
      wg::wait<0>();
#pragma unroll
      for (int e = 0; e < kAcc; ++e) sum[e] += acc[e];
    }
  }
  if (!kDrain) {
    wg::wait<0>();
#pragma unroll
    for (int e = 0; e < kAcc; ++e) sum[e] = acc[e];
  }

  // epilogue: folded BN + ReLU; lane pairs trade halves so each stores 16 bytes
  const int odd = tq & 1;
  const int m = m0 + (tid >> 5) * 16 + gq + 8 * odd;  // even lanes store row g, odd lanes g + 8
  float* orow = out + ((long long)n_img * g.HoWo + m) * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + col));
    const float2 h = __ldg(reinterpret_cast<const float2*>(shift + col));
    const float v0 = fmaxf(fmaf(sum[4 * j + 0], s.x, h.x), 0.f);
    const float v1 = fmaxf(fmaf(sum[4 * j + 1], s.y, h.y), 0.f);
    const float v2 = fmaxf(fmaf(sum[4 * j + 2], s.x, h.x), 0.f);
    const float v3 = fmaxf(fmaf(sum[4 * j + 3], s.y, h.y), 0.f);
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
    const float4 o = odd ? make_float4(r0, r1, v2, v3) : make_float4(v0, v1, r0, r1);
    if (m < g.HoWo) *reinterpret_cast<float4*>(orow + col - 2 * odd) = o;
  }
}

// Geometry of the wgmma route; returns false where that kernel does not
// apply (then the SIMT kernel runs).
bool wg_geometry(int N, int H, int W, int Cin, int kh, int kw, int Cout, WgGeom* g,
                 int* smem_bytes) {
  if (Cin % 8 != 0 || !(Cout == 32 || Cout == 48 || Cout == 64 || Cout == 128)) return false;
  const int Ho = H - kh + 1, Wo = W - kw + 1;
  if ((long long)Ho * Wo > INT_MAX || (long long)H * W * Cin > INT_MAX) return false;
  g->H = H; g->W = W; g->Cin = Cin; g->kh = kh; g->kw = kw; g->Wo = Wo;
  g->HoWo = Ho * Wo;
  g->tiles = (g->HoWo + kWgBM - 1) / kWgBM;
  if ((long long)N * g->tiles > INT_MAX) return false;
  const long long row_k = (long long)kw * Cin;
  const long long cpr = (row_k + kWgKC - 1) / kWgKC;
  if (cpr * kh * kWgKC > INT_MAX) return false;
  g->cpr = (int)cpr;
  g->Kp = (int)(cpr * kh * kWgKC);
  g->cs = Cin + kWgPad;
  // kWgBM consecutive output pixels span at most dho + 1 output rows
  const long long dho = (Wo + kWgBM - 2) / Wo;
  const long long strip_px = kWgBM - 1 + dho * (kw - 1) + kw;
  const long long strip_floats = strip_px * g->cs;
  const long long bytes = 1024 + (long long)kWgStages * 2 * Cout * 128 + 2 * strip_floats * 4;
  if (bytes > kMaxSmem) return false;
  g->strip_floats = (int)strip_floats;
  *smem_bytes = (int)bytes;
  return true;
}

template <int N, bool kDrain>
cudaError_t launch_wgmma(const float* x, const float* wp, const float* scale, const float* shift,
                         float* out, int batch, const WgGeom& g, int smem_bytes,
                         cudaStream_t stream) {
  // the shared-memory opt-in is per device and per instantiation: set it once for each
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(conv_block_wgmma_kernel<N, kDrain>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  conv_block_wgmma_kernel<N, kDrain><<<(unsigned)(batch * g.tiles), kWgThreads, smem_bytes, stream>>>(
      x, wp, scale, shift, out, g);
  return cudaGetLastError();
}

}  // namespace

// Which kernel conv_block_launch runs for a shape: 1 the wgmma kernel, 0 the
// SIMT kernel, -1 neither (the launch would return cudaErrorInvalidValue).
extern "C" int conv_block_route(int N, int H, int W, int Cin, int kh, int kw, int Cout) {
  const int Ho = H - kh + 1;
  const int Wo = W - kw + 1;
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || Cout <= 0 || Cin % 4 || Cout % 4 ||
      (long long)kh * kw * Cin > INT_MAX) {
    return -1;
  }
  WgGeom g;
  int smem_bytes = 0;
  return wg_geometry(N, H, W, Cin, kh, kw, Cout, &g, &smem_bytes) ? 1 : 0;
}

namespace {

template <bool kDrain>
int dispatch(const float* x, const float* w, const float* wp, const float* scale,
             const float* shift, float* out, int N, int H, int W, int Cin, int kh, int kw,
             int Cout, void* stream) {
  const int route = conv_block_route(N, H, W, Cin, kh, kw, Cout);
  if (route < 0 || (route == 0 && !kDrain)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    WgGeom g;
    int smem_bytes = 0;
    wg_geometry(N, H, W, Cin, kh, kw, Cout, &g, &smem_bytes);
    switch (Cout) {
      case 128: return (int)launch_wgmma<128, kDrain>(x, wp, scale, shift, out, N, g, smem_bytes, s);
      case 64: return (int)launch_wgmma<64, kDrain>(x, wp, scale, shift, out, N, g, smem_bytes, s);
      case 48: return (int)launch_wgmma<48, kDrain>(x, wp, scale, shift, out, N, g, smem_bytes, s);
      default: return (int)launch_wgmma<32, kDrain>(x, wp, scale, shift, out, N, g, smem_bytes, s);
    }
  }
  const int Ho = H - kh + 1;
  const int Wo = W - kw + 1;
  const long long M = (long long)N * Ho * Wo;
  const int K = kh * kw * Cin;
  if (Cout > 64) {
    return (int)launch<128, 128, 8, 8>(x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, K, s);
  }
  if (Cout > 32) {
    return (int)launch<256, 64, 8, 8>(x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, K, s);
  }
  return (int)launch<256, 32, 8, 4>(x, w, scale, shift, out, H, W, Cin, kw, Ho, Wo, Cout, M, K, s);
}

}  // namespace

// x: [N, H, W, Cin] contiguous; w: [kh, kw, Cin, Cout] contiguous (HWIO);
// wp: [2, Cout, Kp] the same weights packed K-major as TF32 hi and lo parts,
// k ordered (i, j, c) with every kernel row zero-padded to a multiple of 32
// (conv_block.py pack_conv_weights); scale, shift: [Cout]; out: [N, H-kh+1,
// W-kw+1, Cout].  All float32, 16-byte aligned, with Cin and Cout multiples of
// 4.  The route is chosen here, by shape: the wgmma kernel reads wp, the SIMT
// kernel w.  Returns the cudaError_t of the launch.
extern "C" int conv_block_launch(const float* x, const float* w, const float* wp,
                                 const float* scale, const float* shift, float* out, int N,
                                 int H, int W, int Cin, int kh, int kw, int Cout, void* stream) {
  return dispatch<true>(x, w, wp, scale, shift, out, N, H, W, Cin, kh, kw, Cout, stream);
}

// For measurement only: the wgmma kernel with the tensor cores' accumulators
// never drained (see the note at the top), to show what the drain buys.
// cudaErrorInvalidValue for a shape on the SIMT route.
extern "C" int conv_block_undrained_launch(const float* x, const float* w, const float* wp,
                                           const float* scale, const float* shift, float* out,
                                           int N, int H, int W, int Cin, int kh, int kw, int Cout,
                                           void* stream) {
  return dispatch<false>(x, w, wp, scale, shift, out, N, H, W, Cin, kh, kw, Cout, stream);
}
