// Kernels of the compressed tile store (tile_storage="compressed"):
// tiles staged between the store's slot lists and dense tiles (P6), and
// the triangle inverses of a loaded compressed factor (P2).  Included
// by lu_kernels.cu, whose C interface exposes them.
//
// The store (pangulu_tpu_torch/compressed.py): values[s] holds in-tile
// position idx[s] (row-major r * nb + c; uint16 for nb <= 255, uint32
// above; a position >= nb * nb is a sentinel) of the tile t owning slots
// [off[t], off[t] + cap[t]).  The scratch tile has cap 0.
//
// P6 decompress_kernel / compress_kernel
//   Replace tools/exp_scatter.py run (the TPU probe that decompresses a
//   u16-indexed slot list into a dense tile, mode "scatter"; mode
//   "gather" is the compress direction).  The JAX package's compressed
//   engine does both as XLA gathers and scatters in its level loop
//   (pangulu_tpu/compressed.py:240-258, _compressed_factorize gather and
//   scatter) and in its solve (:295-303).
//   Bound on an H100: bytes.  Decompress writes each dense tile (nb^2
//   values) and reads the tile's cap slots (value and position);
//   compress reads cap positions and the cap dense values they name and
//   writes cap slots.  No arithmetic.
//   Design: one block of kSlotThreads threads per tile of the batch.
//   Decompress zeroes the tile with 16-byte stores, takes a barrier,
//   then writes each slot's value at its position; compress reads them
//   back.  A block loops over its tile's own cap, not the store's capmax
//   (16,384 at nb = 128 on poisson3d(32) nd, where most tiles hold far
//   fewer).  Consecutive threads take consecutive slots, so the slot
//   reads are coalesced, and a tile's positions ascend, so the dense
//   accesses of a warp fall in few rows.  The real ids of a batch are
//   distinct (the wrapper checks), so no slot is written by two blocks.
//
// P2 triangle_inverses_kernel
//   Replaces tools/exp_batched_scan.py batched_newton (the TPU probe of
//   Newton–Schulz doubling inverses of a batch of unit-lower tiles),
//   which the JAX package's compressed executor computes for a factor
//   loaded from a checkpoint (pangulu_tpu/compressed.py:367-401,
//   vmap(unit_lower_inv_newton) and upper_inv_newton,
//   pangulu_tpu/ops/kernels_jax.py:158-197).  The same function, L^-1 of
//   I + strict_lower(f) and U^-1 of triu(f) with the tiny-pivot rule
//   |d| < tol -> +tol, by another method: the TPU doubled because its
//   MXU only multiplies matrices (6 steps of two dense nb^3 products at
//   nb = 128, ~72x the operations an inverse needs, each product's error
//   adding along the chain).  An SM runs a substitution at register
//   latency instead.
//   Bound on an H100: by operations and bytes, nothing (the two inverses
//   of a tile are 1.4e6 flop and 3 nb^2 values); in fact the chain of nb
//   dependent steps of one block, as for K1 (tile_lu.cuh).
//   Design: block (b, m) forms tile b's L^-1 (m = 0) or U^-1 (m = 1) with
//   K1's own sweeps on a register tile (tile_lu.cuh): L^-1 by the
//   forward Gauss–Jordan sweep without the LU update (the multipliers
//   are the factor's own L), U^-1 by the backward sweep against U in
//   shared memory (its diagonal by the tiny-pivot rule).  nb steps, one
//   barrier each; no workspace.  Both types compute in double and round
//   once at the store: the unit triangles of P3's probe have inverses
//   near 1e17, on which an f32 sweep is no more accurate than the
//   doubling it replaces, and the f64 register tile at nb = 128 is K7's
//   (128 registers a thread).  Above nb = 128 the tile is split at 128:
//   a block for each diagonal block's sweep, then a second launch for
//   the off-diagonal block by two products on tensor cores
//   (triangle_products_kernel, tile_gemm.cuh; in T: 3xTF32 for float),
//   as K1's old blocked step formed it: L21^-1 = L22^-1·(-L21·L11^-1),
//   U12^-1 = (-U11^-1·U12)·U22^-1.
//   What holds it back: the step's latency (a barrier, a shared read, a
//   shuffle, the row's FMAs in f64, at half the f32 rate), and one block
//   an SM at nb = 128 (the f64 tile takes the registers), so 2 B blocks
//   run in ceil(2 B / 132) waves.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_gemm.cuh"
#include "tile_lu.cuh"

namespace plu {

constexpr int kSlotThreads = 256;

// Block b: the dense nb x nb tile ids[b] of the store into dense + b *
// nb^2.
template <typename T, typename I>
__global__ void __launch_bounds__(kSlotThreads)
    decompress_kernel(const T* values, const I* idx, const int* off,
                      const int* cap, const int* ids, int nb, T* dense) {
  const size_t nn = (size_t)nb * nb;
  const int t = ids[blockIdx.x];
  T* d = dense + blockIdx.x * nn;
  constexpr int V = 16 / sizeof(T);
  if (nn % V == 0) {  // then every tile starts 16-byte aligned
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (size_t e = threadIdx.x; e < nn / V; e += kSlotThreads)
      d4[e] = make_uint4(0, 0, 0, 0);
  } else {
    for (size_t e = threadIdx.x; e < nn; e += kSlotThreads) d[e] = T(0);
  }
  __syncthreads();
  const size_t o = (size_t)off[t];
  const int c = cap[t];
  for (int s = threadIdx.x; s < c; s += kSlotThreads) {
    const size_t p = idx[o + s];
    if (p < nn) d[p] = values[o + s];
  }
}

// Block b: the real slots of tile ids[b] from the dense tile dense + b *
// nb^2; sentinel slots are not written.
template <typename T, typename I>
__global__ void __launch_bounds__(kSlotThreads)
    compress_kernel(T* values, const I* idx, const int* off, const int* cap,
                    const int* ids, int nb, const T* dense) {
  const size_t nn = (size_t)nb * nb;
  const int t = ids[blockIdx.x];
  const T* d = dense + blockIdx.x * nn;
  const size_t o = (size_t)off[t];
  const int c = cap[t];
  for (int s = threadIdx.x; s < c; s += kSlotThreads) {
    const size_t p = idx[o + s];
    if (p < nn) values[o + s] = d[p];
  }
}

// Decompress (to_dense) or compress a batch of tiles; idx_bytes is the
// width of a slot position, 2 or 4.
template <typename T>
cudaError_t stage_slots(bool to_dense, T* values, const void* idx,
                        int idx_bytes, const int* off, const int* cap,
                        const int* ids, int batch, int nb, T* dense,
                        cudaStream_t st) {
  if (batch == 0) return cudaSuccess;
  if (idx_bytes == 2) {
    const auto* ix = static_cast<const uint16_t*>(idx);
    if (to_dense)
      decompress_kernel<T, uint16_t>
          <<<batch, kSlotThreads, 0, st>>>(values, ix, off, cap, ids, nb,
                                           dense);
    else
      compress_kernel<T, uint16_t>
          <<<batch, kSlotThreads, 0, st>>>(values, ix, off, cap, ids, nb,
                                           dense);
  } else if (idx_bytes == 4) {
    const auto* ix = static_cast<const uint32_t*>(idx);
    if (to_dense)
      decompress_kernel<T, uint32_t>
          <<<batch, kSlotThreads, 0, st>>>(values, ix, off, cap, ids, nb,
                                           dense);
    else
      compress_kernel<T, uint32_t>
          <<<batch, kSlotThreads, 0, st>>>(values, ix, off, cap, ids, nb,
                                           dense);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// A 64 x 64 product window (4 warps of 32 x 32): the Newton steps of
// P3 (probes.cuh) and P2's off-diagonal products above nb = 128.
template <typename T>
using NewtonWindow = Window<T, 64, 64, 2, 2>;

// C (OP) A·B for nb x nb tiles, window W by window, by the whole block
// (BAR = 0) or by the product warps of a block whose other warps do
// other work meanwhile (named barrier BAR, tile_gemm.cuh gemm_sync; the
// probes of probes.cuh); ends with a barrier of those threads after
// the last store, so they may read C next.
template <StoreOp OP, typename T, class W = NewtonWindow<T>, int BAR = 0>
__device__ void newton_product(const T* a, const T* b, T* c, int nb,
                               T* smem) {
  const int nr = (nb + W::BM - 1) / W::BM, nc = (nb + W::BN - 1) / W::BN;
  for (int w = 0; w < nr * nc; ++w)
    tile_gemm<W, OP, BAR>(tile_of(a, nb), tile_of(b, nb), tile_of(c, nb),
                          w / nc * W::BM, w % nc * W::BN, smem);
  gemm_sync<BAR>();
}

// The products of P2's off-diagonal block above nb = 128: a 128-row
// column band and a 128-column row band, each read and written in
// place (a band of the output reads only the same band of it).
template <typename T>
using InvColBand = Window<T, kLuMaxN, 32, 4, 1>;
template <typename T>
using InvRowBand = Window<T, 32, kLuMaxN, 1, 4>;

// L^-1 (upper = false) or U^-1 (upper = true) of the n x n diagonal
// block at a (row stride ld, n <= 128) of a factored tile into out (the
// same stride), computed in double and rounded once to T.  sF: 32 CB x
// kLuVec doubles, row: 2 kLuVec.
template <typename T, int CB>
__device__ void triangle_inverse(const T* a, T* out, bool upper, int n,
                                 int ld, double tol, double* sF,
                                 double* row) {
  constexpr int RA = RegTile<double, CB>::RA;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < 2 * kLuVec; e += kLuThreads) row[e] = 0.0;
  RegTile<double, CB> M;
  M.load(a, n, ld);
  if (!upper) {
    __syncthreads();
    forward_sweep<double, CB, false>(M, n, tol, nullptr, row);
#pragma unroll
    for (int ia = 0; ia < RA; ++ia)
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int i = ty + kLuWarps * ia, j = tx + 32 * b;
        if (i < n && j < n)
          out[i * ld + j] = T(j < i ? M.v[ia][b] : i == j ? 1.0 : 0.0);
      }
    return;
  }
#pragma unroll
  for (int ia = 0; ia < RA; ++ia)
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int i = ty + kLuWarps * ia, j = tx + 32 * b;
      if (i < n && j < n && j >= i)
        sF[i * kLuVec + j] = i == j ? safe_pivot(M.v[ia][b], tol)
                                    : M.v[ia][b];
    }
  __syncthreads();
  M.identity();
  backward_sweep<double, CB>(M, n, sF, row);
  M.store(out, n, ld);
}

// Block (b, m, z): L^-1 (m = 0) or U^-1 (m = 1) of the factored tile f
// + b * nb^2 into linv or uinv + b * nb^2: the whole tile (nb <= 128,
// gridDim.z = 1), or above nb = 128 its diagonal block z (128 x 128,
// then nb - 128), whose off-diagonal block triangle_products_kernel
// forms next.  CB = lu_cb(min(nb, 128)).
template <typename T, int CB>
__global__ void __launch_bounds__(kLuThreads, 1)
    triangle_inverses_kernel(const T* f, T* linv, T* uinv, int nb,
                             double tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sF = reinterpret_cast<double*>(smem_raw);
  const size_t nn = (size_t)nb * nb;
  const bool upper = blockIdx.y == 1;
  const int h = nb < kLuMaxN ? nb : kLuMaxN;
  const int n = blockIdx.z == 0 ? h : nb - h;
  const size_t d = blockIdx.z == 0 ? 0 : (size_t)h * (nb + 1);
  triangle_inverse<T, CB>(f + blockIdx.x * nn + d,
                          (upper ? uinv : linv) + blockIdx.x * nn + d, upper,
                          n, nb, tol, sF, sF + 32 * CB * kLuVec);
}

// Block (b, m), nb > 128, after triangle_inverses_kernel: the
// off-diagonal blocks of tile b's L^-1 (m = 0) or U^-1 (m = 1) from its
// diagonal blocks' inverses, by two products on tensor cores in T, and
// the zero block.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    triangle_products_kernel(const T* f, T* linv, T* uinv, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t nn = (size_t)nb * nb;
  const bool upper = blockIdx.y == 1;
  const T* a = f + blockIdx.x * nn;
  T* out = (upper ? uinv : linv) + blockIdx.x * nn;
  const int h = kLuMaxN, h2 = nb - h;
  // the zero block: U^-1's lower left, L^-1's upper right
  for (int e = threadIdx.x; e < h * h2; e += kGemmThreads) {
    if (upper)
      out[(size_t)(h + e / h) * nb + e % h] = T(0);
    else
      out[(size_t)(e / h2) * nb + h + e % h2] = T(0);
  }
  const int qd = (h2 + 63) / 64, hq = h / 64;
  if (!upper) {
    // W = -L21·L11^-1 into L^-1's lower left, then L22^-1·W there
    const Mat<T> w = block_of(out, nb, h, 0, h2, h);
    for (int j = 0; j < qd * hq; ++j)
      tile_gemm<NewtonWindow<T>, kNegate>(
          block_of(a, nb, h, 0, h2, h), block_of(out, nb, 0, 0, h, h), w,
          j / hq * 64, j % hq * 64, smem);
    __syncthreads();
    for (int s = 0; s < h / 32; ++s)
      tile_gemm<InvColBand<T>, kStore>(block_of(out, nb, h, h, h2, h2), w,
                                       w, 0, s * 32, smem);
  } else {
    // V = -U11^-1·U12 into U^-1's upper right, then V·U22^-1 there
    const Mat<T> v = block_of(out, nb, 0, h, h, h2);
    for (int j = 0; j < hq * qd; ++j)
      tile_gemm<NewtonWindow<T>, kNegate>(
          block_of(out, nb, 0, 0, h, h), block_of(a, nb, 0, h, h, h2), v,
          j / qd * 64, j % qd * 64, smem);
    __syncthreads();
    for (int s = 0; s < h / 32; ++s)
      tile_gemm<InvRowBand<T>, kStore>(v, block_of(out, nb, h, h, h2, h2),
                                       v, s * 32, 0, smem);
  }
}

// L^-1 and U^-1 of a batch of factored tiles: one launch, a block per
// tile and triangle (and diagonal block above nb = 128, where a second
// launch forms the off-diagonal blocks).
template <typename T>
cudaError_t triangle_inverses(const T* f, T* linv, T* uinv, int batch,
                              int nb, double tol, cudaStream_t st) {
  if (batch == 0) return cudaSuccess;
  const int n = nb < kLuMaxN ? nb : kLuMaxN, cb = lu_cb(n);
  void (*kern)(const T*, T*, T*, int, double) =
      cb == 1   ? triangle_inverses_kernel<T, 1>
      : cb == 2 ? triangle_inverses_kernel<T, 2>
                : triangle_inverses_kernel<T, 4>;
  const size_t smem = lu_smem_bytes<double>(n);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(batch, 2, nb > kLuMaxN ? 2 : 1), kLuThreads, smem, st>>>(
      f, linv, uinv, nb, tol);
  if ((e = cudaGetLastError()) != cudaSuccess || nb <= kLuMaxN) return e;
  size_t psm = NewtonWindow<T>::kSmemBytes;
  if (InvColBand<T>::kSmemBytes > psm) psm = InvColBand<T>::kSmemBytes;
  if (InvRowBand<T>::kSmemBytes > psm) psm = InvRowBand<T>::kSmemBytes;
  if ((e = cudaFuncSetAttribute(triangle_products_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)psm)) != cudaSuccess)
    return e;
  triangle_products_kernel<T><<<dim3(batch, 2), kGemmThreads, psm, st>>>(
      f, linv, uinv, nb);
  return cudaGetLastError();
}

}  // namespace plu
