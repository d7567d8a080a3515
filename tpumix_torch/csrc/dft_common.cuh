// Small float64 DFT pieces shared by the frontend kernels (stft_dif.cu,
// stft_ct.cu, stft_basis.cu): W_16 factors as literals, 4- and 16-point
// forward DFTs in registers, and the dB epilogue.

#pragma once

#include <cuda_runtime.h>

namespace dftc {

// cos(2 pi m / 16).  Called with m known at compile time (unrolled loops),
// so each folds to an immediate.
__device__ __forceinline__ double cos16(int m) {
  constexpr double c[5] = {1.0, 0.92387953251128674, 0.70710678118654752,
                           0.38268343236508977, 0.0};
  m &= 15;
  const int a = m <= 8 ? m : 16 - m;
  return a <= 4 ? c[a] : -c[8 - a];
}
__device__ __forceinline__ double sin16(int m) { return cos16(m - 4); }

// x * W_16^m = x * (cos - i sin)
__device__ __forceinline__ double2 mul_w16(double2 x, int m) {
  const double c = cos16(m), s = sin16(m);
  return make_double2(x.x * c + x.y * s, x.y * c - x.x * s);
}

// x * (c - i s)
__device__ __forceinline__ double2 mul_conj(double2 x, double c, double s) {
  return make_double2(x.x * c + x.y * s, x.y * c - x.x * s);
}

// forward 4-point DFT in place: (a0, a1, a2, a3) -> (X0, X1, X2, X3)
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2, double2& a3) {
  const double2 s02 = make_double2(a0.x + a2.x, a0.y + a2.y);
  const double2 d02 = make_double2(a0.x - a2.x, a0.y - a2.y);
  const double2 s13 = make_double2(a1.x + a3.x, a1.y + a3.y);
  const double2 d13 = make_double2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_double2(s02.x + s13.x, s02.y + s13.y);
  a2 = make_double2(s02.x - s13.x, s02.y - s13.y);
  a1 = make_double2(d02.x + d13.y, d02.y - d13.x);  // d02 - i d13
  a3 = make_double2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
}

// forward 16-point DFT in place, radix 4 x 4 (p = 4*pa + pb, u = c + 4*d):
// 4-point DFTs over pa, twiddle W_16^(pb*c), 4-point DFTs over pb.  On
// return a[4*c + d] = Y[c + 4*d].
__device__ __forceinline__ void fft16(double2 (&a)[16]) {
#pragma unroll
  for (int pb = 0; pb < 4; ++pb) {
    dft4(a[pb], a[4 + pb], a[8 + pb], a[12 + pb]);  // a[4c + pb] = t[pb][c]
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      if (pb > 0) a[4 * c + pb] = mul_w16(a[4 * c + pb], pb * c);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) dft4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
}

// scale * ln(max(|X|^2, amin^2)) with scale = (mult/2)/ln 10: the dB feature
// of one bin.  One definition for every frontend kernel, so a bin under amin
// comes out as the same float32 from each of them.
__device__ __forceinline__ float db(double re, double im, float scale, double amin2) {
  return scale * logf(static_cast<float>(fmax(re * re + im * im, amin2)));
}

}  // namespace dftc
