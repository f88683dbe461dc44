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
// P2 newton_kernel
//   Replaces tools/exp_batched_scan.py batched_newton (the TPU probe of
//   Newton–Schulz doubling inverses of a batch of unit-lower tiles),
//   which the JAX package's compressed executor computes for a factor
//   loaded from a checkpoint (pangulu_tpu/compressed.py:367-401,
//   vmap(unit_lower_inv_newton) and upper_inv_newton,
//   pangulu_tpu/ops/kernels_jax.py:158-197).
//   Bound on an H100: operations.  Per tile and triangle, steps =
//   ceil(log2 nb) - 1 doubling steps (6 at nb = 128) of two nb^3-FMA
//   products, on tensor cores (3xTF32 for float, DMMA for double).
//   Design: block (b, m) computes tile b's L^-1 (m = 0) or U^-1 (m = 1)
//   with the 4 warps of tile_gemm.cuh.  T is the unit triangle (I + the
//   tile's strict lower part; or I + D^-1 times its strict upper part,
//   D its diagonal with the tiny-pivot rule |d| < tol -> +tol), X = 2I -
//   T goes to the output, and each step forms Y = 2I - T·X and X' = X·Y
//   as loops of 64 x 64 windows (tile_gemm), which stage their operands
//   through shared memory from global memory (the L2): T, X and Y of
//   one f64 tile at nb = 128 are 384 KiB, more than the 227 KB a block
//   can take.  T, Y and X' live in a workspace of three tiles a block
//   that the wrapper allocates; X and X' swap each step.  U^-1's columns
//   are scaled by D^-1 at the end.  A simple kernel: one block a
//   triangle, the windows of a product in sequence.
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

// The 64 x 64 product window of the Newton steps (4 warps of 32 x 32).
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

// Block (b, m): L^-1 (m = 0) or U^-1 (m = 1) of the factored tile f + b
// * nb^2 into linv or uinv + b * nb^2; work holds 3 tiles a block.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    newton_kernel(const T* f, T* linv, T* uinv, T* work, int nb, int steps,
                  T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t nn = (size_t)nb * nb;
  const bool upper = blockIdx.y == 1;
  const T* a = f + blockIdx.x * nn;
  T* out = (upper ? uinv : linv) + blockIdx.x * nn;
  T* t = work + ((size_t)blockIdx.x * 2 + blockIdx.y) * 3 * nn;
  T* y = t + nn;
  T* x2 = y + nn;
  // T and X = 2I - T
  for (size_t e = threadIdx.x; e < nn; e += kGemmThreads) {
    const int r = e / nb, c = e % nb;
    T v = r == c ? T(1) : T(0);
    if (!upper && r > c) v = a[e];
    if (upper && r < c)
      v = a[e] * (T(1) / safe_pivot(a[(size_t)r * nb + r], tol));
    t[e] = v;
    out[e] = (r == c ? T(2) : T(0)) - v;
  }
  __syncthreads();
  T* x = out;
  for (int s = 0; s < steps; ++s) {
    newton_product<kNegate>(t, x, y, nb, smem);  // Y = -T·X
    for (int i = threadIdx.x; i < nb; i += kGemmThreads)
      y[(size_t)i * nb + i] += T(2);             // Y = 2I - T·X
    __syncthreads();
    newton_product<kStore>(x, y, x2, nb, smem);  // X' = X·Y
    T* tmp = x;
    x = x2;
    x2 = tmp;
  }
  for (size_t e = threadIdx.x; e < nn; e += kGemmThreads) {
    T v = x[e];
    if (upper) {
      const int c = e % nb;
      v = v * (T(1) / safe_pivot(a[(size_t)c * nb + c], tol));
    }
    out[e] = v;
  }
}

// L^-1 and U^-1 of a batch of factored tiles: one launch, a block per
// tile and triangle.
template <typename T>
cudaError_t newton_inverses(const T* f, T* linv, T* uinv, T* work, int batch,
                            int nb, int steps, double tol, cudaStream_t st) {
  if (batch == 0) return cudaSuccess;
  const size_t smem = NewtonWindow<T>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      newton_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  newton_kernel<T><<<dim3(batch, 2), kGemmThreads, smem, st>>>(
      f, linv, uinv, work, nb, steps, (T)tol);
  return cudaGetLastError();
}

}  // namespace plu
