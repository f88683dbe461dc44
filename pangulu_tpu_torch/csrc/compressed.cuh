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
//   Bound on an H100: bytes.  Decompress reads a tile's cap slots
//   (value and position) and writes its nb^2 dense values once;
//   compress reads cap positions and the cap dense values they name and
//   writes cap slots.  No arithmetic.
//   What the first design lost: one block of 256 threads a tile, so a
//   batch of B tiles ran on B SMs (the compressed path's median batch is
//   8 tiles of 132 SMs, and a one-tile launch walked up to 64 slots a
//   thread on one SM); one slot in flight a thread (no pointer was
//   __restrict__, so each iteration's store could alias the next load);
//   and decompress wrote every dense line twice (zeros, a barrier, then
//   the slots).
//   Design: decompress block (b, j) builds rows [j R, (j + 1) R) of
//   dense tile b in shared memory: it zeroes them, finds the range of
//   the tile's slots whose positions fall in those rows (a tile's
//   positions ascend strictly, which the wrapper checks once a store)
//   by a block-wide search of two rounds of loads (slot_range; a tile
//   of at most kSlotDirect slots is read whole instead), scatters the
//   range's slots of those rows into shared memory and writes the rows
//   out with 16-byte stores, so each dense byte is written once.
//   Compress block (b, j) takes slots [j S, (j + 1) S) of tile b;
//   blocks past the tile's cap exit at once.  Both walk their rows or
//   slots grid-stride, so any grid is right.  A thread takes kSlotGroup
//   consecutive slots at once (one vector load of their values and one
//   of their positions where the group is aligned and whole; a range's
//   ragged head and tail slot by slot), every load before the stores.
//   The wrapper picks R and S (kernels_cuda.stage_geometry) so that the
//   grid holds a few blocks an SM where the batch allows.  The real ids
//   of a batch are distinct (the wrapper checks), so no slot is written
//   by two blocks.
//   Where it stands: near the byte bound on a wide batch; a small
//   launch takes ~3 us, the launch and its chain of dependent loads
//   (ids, then offset and cap, then positions, then values or dense
//   values), whatever its size.
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
// consecutive slots a thread takes at once
constexpr int kSlotGroup = 4;
// the position of a slot outside the range a thread works on
constexpr unsigned kNoSlot = 0xFFFFFFFFu;
// shared memory of a decompress block at most (the rows it builds)
constexpr size_t kSlotChunkBytes = 48 * 1024;
// blocks along a grid's second dimension at most
constexpr int kSlotGridY = 65535;
// a decompress block reads a tile of at most this many slots whole,
// keeping those of its rows, rather than searching them (two rounds of
// loads saved on the small tiles of most launches)
constexpr int kSlotDirect = 2 * kSlotGroup * kSlotThreads;

// kSlotGroup values or positions from p (kSlotGroup-aligned slots of an
// array whose start is 16-byte aligned) by vector loads, and back.
__device__ __forceinline__ void load_group(const float* __restrict__ p,
                                           float (&v)[kSlotGroup]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_group(const double* __restrict__ p,
                                           double (&v)[kSlotGroup]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load_group(const uint16_t* __restrict__ p,
                                           unsigned (&v)[kSlotGroup]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = q.x & 0xFFFFu, v[1] = q.x >> 16, v[2] = q.y & 0xFFFFu,
  v[3] = q.y >> 16;
}
__device__ __forceinline__ void load_group(const uint32_t* __restrict__ p,
                                           unsigned (&v)[kSlotGroup]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void store_group(float* __restrict__ p,
                                            const float (&v)[kSlotGroup]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_group(double* __restrict__ p,
                                            const double (&v)[kSlotGroup]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Whether the slot arrays take load_group and store_group.
template <typename T, typename I>
__device__ __forceinline__ bool groups_aligned(const T* values,
                                               const I* idx) {
  return reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(idx) % (kSlotGroup * sizeof(I)) == 0;
}

// The first slots s0 and s1 of a tile's c strictly ascending positions
// pos[0, c) at or above p0 and at or above p1, by the whole block in two
// rounds of loads.  Round 1: thread i reads the sample at slot i * step
// (step = ceil(c / kSlotThreads)); the k samples below p are the first k,
// so the first slot at or above p lies in ((k - 1) step, min(k step, c)]
// (0 when k = 0).  Round 2 counts that bucket's positions below p (one
// pass while c <= kSlotThreads^2).  Its barriers also order what the
// block wrote to shared memory before it.
template <typename I>
__device__ __forceinline__ void slot_range(const I* __restrict__ pos, int c,
                                           unsigned p0, unsigned p1,
                                           int& s0, int& s1) {
  const int step = (c + kSlotThreads - 1) / kSlotThreads;
  const int s = threadIdx.x * step;
  const bool in = s < c;
  const unsigned v = in ? (unsigned)pos[s] : 0u;
  const int k0 = __syncthreads_count(in && v < p0);
  const int k1 = __syncthreads_count(in && v < p1);
  const int a0 = k0 ? (k0 - 1) * step + 1 : 0;
  const int a1 = k1 ? (k1 - 1) * step + 1 : 0;
  const int e0 = k0 ? min(k0 * step, c) : 0;
  const int e1 = k1 ? min(k1 * step, c) : 0;
  const int len = max(e0 - a0, e1 - a1);
  s0 = a0, s1 = a1;
  for (int r = 0; r < len; r += kSlotThreads) {
    const int i = r + threadIdx.x;
    const bool q0 = a0 + i < e0 && (unsigned)pos[a0 + i] < p0;
    const bool q1 = a1 + i < e1 && (unsigned)pos[a1 + i] < p1;
    s0 += __syncthreads_count(q0);
    s1 += __syncthreads_count(q1);
  }
}

// Block (b, j): rows [j rows, (j + 1) rows) of the dense nb x nb tile
// ids[b] of the store into dense + b * nb^2, and every gridDim.y-th such
// chunk after it.  Shared memory: rows * nb values (16-byte rounded).
template <typename T, typename I>
__global__ void __launch_bounds__(kSlotThreads)
    decompress_kernel(const T* __restrict__ values, const I* __restrict__ idx,
                      const int* __restrict__ off, const int* __restrict__ cap,
                      const int* __restrict__ ids, int nb, int rows,
                      T* __restrict__ dense) {
  extern __shared__ uint4 chunk4[];
  T* chunk = reinterpret_cast<T*>(chunk4);
  const int t = ids[blockIdx.x];
  const long long o = off[t];
  const int c = cap[t];
  const bool vec = groups_aligned(values, idx);
  T* tile = dense + (size_t)blockIdx.x * nb * nb;
  for (int r0 = blockIdx.y * rows; r0 < nb; r0 += gridDim.y * rows) {
    const int n = (min(r0 + rows, nb) - r0) * nb;  // the chunk's values
    const unsigned p0 = (unsigned)r0 * nb, p1 = p0 + n;
    const int words = (n * (int)sizeof(T) + 15) / 16;
    for (int e = threadIdx.x; e < words; e += kSlotThreads)
      chunk4[e] = make_uint4(0, 0, 0, 0);
    int s0 = 0, s1 = c;
    if (c > kSlotDirect)
      slot_range(idx + o, c, p0, p1, s0, s1);  // its barriers follow the zeros
    else
      __syncthreads();
    const long long lo = o + s0, hi = o + s1;
#pragma unroll 2
    for (long long g = (lo & ~(long long)(kSlotGroup - 1)) +
                       kSlotGroup * threadIdx.x;
         g < hi; g += kSlotGroup * kSlotThreads) {
      unsigned p[kSlotGroup];
      T v[kSlotGroup];
      if (vec && g >= lo && g + kSlotGroup <= hi) {
        load_group(idx + g, p);
        load_group(values + g, v);
      } else {
#pragma unroll
        for (int k = 0; k < kSlotGroup; ++k) {
          const bool in = g + k >= lo && g + k < hi;
          p[k] = in ? (unsigned)idx[g + k] : kNoSlot;
          v[k] = in ? values[g + k] : T(0);
        }
      }
#pragma unroll
      for (int k = 0; k < kSlotGroup; ++k)  // the slots of its rows
        if (p[k] - p0 < (unsigned)n) chunk[p[k] - p0] = v[k];
    }
    __syncthreads();
    T* d = tile + p0;
    if (reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
        n * sizeof(T) % 16 == 0) {
      uint4* d4 = reinterpret_cast<uint4*>(d);
      for (int e = threadIdx.x; e < words; e += kSlotThreads)
        d4[e] = chunk4[e];
    } else {
      for (int e = threadIdx.x; e < n; e += kSlotThreads) d[e] = chunk[e];
    }
    __syncthreads();  // before the next chunk's zeros
  }
}

// Block (b, j): slots [j span, (j + 1) span) of tile ids[b], and every
// gridDim.y-th such range after it, from the dense tile dense + b *
// nb^2; sentinel slots (position >= nb^2) are not written.
template <typename T, typename I>
__global__ void __launch_bounds__(kSlotThreads)
    compress_kernel(T* __restrict__ values, const I* __restrict__ idx,
                    const int* __restrict__ off, const int* __restrict__ cap,
                    const int* __restrict__ ids, int nb, int span,
                    const T* __restrict__ dense) {
  const int t = ids[blockIdx.x];
  const int c = cap[t];
  const long long o = off[t];
  const unsigned nn = (unsigned)nb * nb;
  const T* d = dense + (size_t)blockIdx.x * nn;
  const bool vec = groups_aligned(values, idx);
  for (long long s0 = (long long)blockIdx.y * span; s0 < c;
       s0 += (long long)gridDim.y * span) {
    const long long lo = o + s0, hi = o + min(s0 + span, (long long)c);
    for (long long g = (lo & ~(long long)(kSlotGroup - 1)) +
                       kSlotGroup * threadIdx.x;
         g < hi; g += kSlotGroup * kSlotThreads) {
      unsigned p[kSlotGroup];
      const bool whole = vec && g >= lo && g + kSlotGroup <= hi;
      if (whole) {
        load_group(idx + g, p);
      } else {
#pragma unroll
        for (int k = 0; k < kSlotGroup; ++k)
          p[k] = g + k >= lo && g + k < hi ? (unsigned)idx[g + k] : kNoSlot;
      }
      T v[kSlotGroup];
      bool all = whole;
#pragma unroll
      for (int k = 0; k < kSlotGroup; ++k) {
        v[k] = p[k] < nn ? d[p[k]] : T(0);
        all = all && p[k] < nn;
      }
      if (all) {
        store_group(values + g, v);
      } else {
#pragma unroll
        for (int k = 0; k < kSlotGroup; ++k)
          if (p[k] < nn) values[g + k] = v[k];
      }
    }
  }
}

template <typename T, typename I>
cudaError_t stage_slots_of(bool to_dense, T* values, const I* idx,
                           const int* off, const int* cap, const int* ids,
                           int batch, int nb, int rows, int chunks, int span,
                           int spans, T* dense, cudaStream_t st) {
  if (to_dense) {
    const size_t smem = ((size_t)rows * nb * sizeof(T) + 15) / 16 * 16;
    decompress_kernel<T, I><<<dim3(batch, chunks), kSlotThreads, smem, st>>>(
        values, idx, off, cap, ids, nb, rows, dense);
  } else {
    compress_kernel<T, I><<<dim3(batch, spans), kSlotThreads, 0, st>>>(
        values, idx, off, cap, ids, nb, span, dense);
  }
  return cudaGetLastError();
}

// Decompress (to_dense) or compress a batch of tiles; idx_bytes is the
// width of a slot position, 2 or 4.  The grid (kernels_cuda.
// stage_geometry): decompress (batch, chunks) blocks of rows rows,
// compress (batch, spans) blocks of span slots.
template <typename T>
cudaError_t stage_slots(bool to_dense, T* values, const void* idx,
                        int idx_bytes, const int* off, const int* cap,
                        const int* ids, int batch, int nb, int rows,
                        int chunks, int span, int spans, T* dense,
                        cudaStream_t st) {
  if (batch == 0) return cudaSuccess;
  if (batch < 0 || nb < 1 || rows < 1 || chunks < 1 ||
      chunks > kSlotGridY || (size_t)rows * nb * sizeof(T) > kSlotChunkBytes ||
      span < 1 || spans < 1 || spans > kSlotGridY)
    return cudaErrorInvalidValue;
  if (idx_bytes == 2)
    return stage_slots_of(to_dense, values, static_cast<const uint16_t*>(idx),
                          off, cap, ids, batch, nb, rows, chunks, span, spans,
                          dense, st);
  if (idx_bytes == 4)
    return stage_slots_of(to_dense, values, static_cast<const uint32_t*>(idx),
                          off, cap, ids, batch, nb, rows, chunks, span, spans,
                          dense, st);
  return cudaErrorInvalidValue;
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
