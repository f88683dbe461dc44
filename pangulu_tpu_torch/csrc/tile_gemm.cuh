// One thread block computes a (16*TR) x (16*TR) window of an nb x nb
// tile product, C = A·B or C -= A·B, in plain FMA of the working type
// (true f32 or f64: no tensor cores, so no TF32 rounding of inputs).
// Row-major tiles, 256 threads as a 16 x 16 grid, each thread owning a
// TR x TR register block at rows ty + 16r and columns tx + 16s.  Ragged
// edges (nb not a multiple of 16) are masked, so any nb <= 16*TR works.
//
// C may alias A or B when one block owns every element of C that the
// aliased operand feeds (the in-place panel solves): every load happens
// inside the k loop, every store after its last barrier.
#pragma once

#include <cuda_runtime.h>

namespace plu {

constexpr int kGemmThreads = 256;

__device__ __forceinline__ float fmat(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmat(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int TR, bool SUB>
__device__ void tile_gemm(const T* A, const T* B, T* C, int nb, int r0,
                          int c0) {
  constexpr int BK = 16;
  constexpr int BM = 16 * TR;
  __shared__ T As[BM][BK + 1];
  __shared__ T Bs[BK][BM + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  T acc[TR][TR];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int s = 0; s < TR; ++s) acc[r][s] = T(0);

  for (int k0 = 0; k0 < nb; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kGemmThreads) {
      const int r = e / BK, kk = e % BK;
      const int gr = r0 + r, gk = k0 + kk;
      As[r][kk] = (gr < nb && gk < nb) ? A[gr * nb + gk] : T(0);
    }
    for (int e = tid; e < BK * BM; e += kGemmThreads) {
      const int kk = e / BM, c = e % BM;
      const int gk = k0 + kk, gc = c0 + c;
      Bs[kk][c] = (gk < nb && gc < nb) ? B[gk * nb + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T av[TR], bv[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) av[r] = As[ty + 16 * r][kk];
#pragma unroll
      for (int s = 0; s < TR; ++s) bv[s] = Bs[kk][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int s = 0; s < TR; ++s) acc[r][s] = fmat(av[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int gr = r0 + ty + 16 * r;
#pragma unroll
    for (int s = 0; s < TR; ++s) {
      const int gc = c0 + tx + 16 * s;
      if (gr < nb && gc < nb) {
        T* p = C + gr * nb + gc;
        *p = SUB ? *p - acc[r][s] : acc[r][s];
      }
    }
  }
}

}  // namespace plu
