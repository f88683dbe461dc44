// One thread block computes a (16*TR) x (16*TR) window of an nb x nb
// tile product, C = A·B or C -= A·B, in plain FMA of the working type
// (true f32 or f64: no tensor cores, so no TF32 rounding of inputs).
// Row-major tiles, 256 threads as a 16 x 16 grid, each thread owning a
// TR x TR register block at rows ty + 16r and columns tx + 16s.  Ragged
// edges (nb not a multiple of 16) are masked, so any nb <= 16*TR works.
// tile_gemm_acc adds one product to the registers and tile_store writes
// them, so a block can sum several products into one window and store
// once (the grouped Schur step); tile_gemm is one of each.
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

// acc += A·B over the window at (r0, c0).  Ends with a barrier.
template <typename T, int TR>
__device__ void tile_gemm_acc(const T* A, const T* B, int nb, int r0,
                              int c0, T (&acc)[TR][TR]) {
  constexpr int BK = 16;
  constexpr int BM = 16 * TR;
  __shared__ T As[BM][BK + 1];
  __shared__ T Bs[BK][BM + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
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
}

// The window at (r0, c0) of C = acc (or C -= acc when SUB).
template <typename T, int TR, bool SUB>
__device__ void tile_store(T* C, int nb, int r0, int c0,
                           const T (&acc)[TR][TR]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

template <typename T, int TR>
__device__ __forceinline__ void zero_acc(T (&acc)[TR][TR]) {
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int s = 0; s < TR; ++s) acc[r][s] = T(0);
}

template <typename T, int TR, bool SUB>
__device__ void tile_gemm(const T* A, const T* B, T* C, int nb, int r0,
                          int c0) {
  T acc[TR][TR];
  zero_acc(acc);
  tile_gemm_acc(A, B, nb, r0, c0, acc);
  tile_store<T, TR, SUB>(C, nb, r0, c0, acc);
}

}  // namespace plu
