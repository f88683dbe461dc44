// Kernels of the compressed tile store (tile_storage="compressed"):
// tiles staged between the store's slot lists and dense tiles (P6), and
// the triangle inverses of a loaded compressed factor (P2).  Included
// by lu_kernels.cu, whose C interface exposes them.
//
// The store (pangulu_tpu_torch/compressed.py): values[s] holds in-tile
// position idx[s] (row-major r * nb + c; uint16 for nb <= 255, uint32
// above; a position >= nb * nb is a sentinel) of the tile t owning slots
// [off[t], off[t] + cap[t]).  The scratch tile has cap 0.  A value is
// float32, float64, complex64 or complex128.
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
//   P6 moves values and computes nothing, so the kernels take a slot
//   as a word of its width (SlotWord: 4 bytes for float32, 8 for
//   float64 and complex64, 16 for complex128), not as a value type.
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
//   of a tile are 1.4e6 flop at nb = 128 and 3 nb^2 values); in fact the
//   chain of nb dependent steps of one block, as for K1 (tile_lu.cuh).
//   Design: block (b, m, z) forms the 128-wide diagonal block z (the last
//   one narrower) of tile b's L^-1 (m = 0) or U^-1 (m = 1) with K1's own
//   sweeps on a register tile (tile_lu.cuh): L^-1 by the forward
//   Gauss–Jordan sweep without the LU update (the multipliers are the
//   factor's own L), U^-1 by the backward sweep against U in shared
//   memory (its diagonal by the tiny-pivot rule).  n steps, one barrier
//   each; no workspace.  Both types compute in double and round once at
//   the store: the unit triangles of P3's probe have inverses near 1e17,
//   on which an f32 sweep is no more accurate than the doubling it
//   replaces, and the f64 register tile at nb = 128 is K7's (128
//   registers a thread).  Above nb = 128 the off-diagonal blocks form
//   bottom-up over a tree of halves of the 128-wide blocks, one launch
//   of triangle_products_kernel a level (1 at nb <= 256, 2 at 288-512):
//   node (o, h1, h2) joins the complete inverses of its halves [o, o +
//   h1) and [o + h1, o + h1 + h2) by two products on tensor cores
//   (tile_gemm.cuh; in T: 3xTF32 for float, DMMA for double), as the
//   JAX package's recursion forms its parent inverses
//   (kernels_jax.py:200-248): L21^-1 = L22^-1·(-L21·L11^-1), U12^-1 =
//   (-U11^-1·U12)·U22^-1.  The first product lands in the other
//   triangle's zero block of the node (its shape), which the block then
//   zeroes: still no workspace (kernels_torch.triangle_inverses is the
//   same tree).
//   What holds it back: the step's latency (a barrier, a shared read, a
//   shuffle, the row's FMAs in f64, at half the f32 rate), and one block
//   an SM at nb = 128 (the f64 tile takes the registers), so 2 B blocks
//   run in ceil(2 B / 132) waves; above 256 a node's products run on one
//   block of 4 warps (two 256-cubed products at the top of nb = 512).
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

// A slot's value as P6 moves it: a word of its width in bytes.
template <int W>
struct SlotWord;
template <>
struct SlotWord<4> {
  using T = uint32_t;
};
template <>
struct SlotWord<8> {
  using T = uint2;
};
template <>
struct SlotWord<16> {
  using T = uint4;
};

// kSlotGroup slot words from p (kSlotGroup-aligned slots of an array
// whose start is 16-byte aligned) by 16-byte loads, and back.
__device__ __forceinline__ void load_group(const uint32_t* __restrict__ p,
                                           uint32_t (&v)[kSlotGroup]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_group(const uint2* __restrict__ p,
                                           uint2 (&v)[kSlotGroup]) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  v[0] = make_uint2(a.x, a.y), v[1] = make_uint2(a.z, a.w);
  v[2] = make_uint2(b.x, b.y), v[3] = make_uint2(b.z, b.w);
}
__device__ __forceinline__ void load_group(const uint4* __restrict__ p,
                                           uint4 (&v)[kSlotGroup]) {
#pragma unroll
  for (int k = 0; k < kSlotGroup; ++k) v[k] = p[k];
}
__device__ __forceinline__ void store_group(uint32_t* __restrict__ p,
                                            const uint32_t (&v)[kSlotGroup]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_group(uint2* __restrict__ p,
                                            const uint2 (&v)[kSlotGroup]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(v[0].x, v[0].y, v[1].x, v[1].y);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(v[2].x, v[2].y, v[3].x, v[3].y);
}
__device__ __forceinline__ void store_group(uint4* __restrict__ p,
                                            const uint4 (&v)[kSlotGroup]) {
#pragma unroll
  for (int k = 0; k < kSlotGroup; ++k) p[k] = v[k];
}
// kSlotGroup positions from p, the same way.
__device__ __forceinline__ void load_positions(const uint16_t* __restrict__ p,
                                               unsigned (&v)[kSlotGroup]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = q.x & 0xFFFFu, v[1] = q.x >> 16, v[2] = q.y & 0xFFFFu,
  v[3] = q.y >> 16;
}
__device__ __forceinline__ void load_positions(const uint32_t* __restrict__ p,
                                               unsigned (&v)[kSlotGroup]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
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
// chunk after it.  Shared memory: rows * nb slot words (16-byte
// rounded).  T is a SlotWord.
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
        load_positions(idx + g, p);
        load_group(values + g, v);
      } else {
#pragma unroll
        for (int k = 0; k < kSlotGroup; ++k) {
          const bool in = g + k >= lo && g + k < hi;
          p[k] = in ? (unsigned)idx[g + k] : kNoSlot;
          v[k] = in ? values[g + k] : T{};
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
        load_positions(idx + g, p);
      } else {
#pragma unroll
        for (int k = 0; k < kSlotGroup; ++k)
          p[k] = g + k >= lo && g + k < hi ? (unsigned)idx[g + k] : kNoSlot;
      }
      T v[kSlotGroup];
      bool all = whole;
#pragma unroll
      for (int k = 0; k < kSlotGroup; ++k) {
        v[k] = p[k] < nn ? d[p[k]] : T{};
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

// Decompress (to_dense) or compress a batch of tiles of slot words T
// (SlotWord: 4, 8 or 16 bytes); idx_bytes is the width of a slot
// position, 2 or 4.  The grid (kernels_cuda.stage_geometry): decompress
// (batch, chunks) blocks of rows rows, compress (batch, spans) blocks of
// span slots.
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

// Block (b, m, z): L^-1 (m = 0) or U^-1 (m = 1) of the diagonal block z
// of the factored tile f + b * nb^2 (rows [128 z, min(128 z + 128, nb)):
// the whole tile up to nb = 128) into linv or uinv + b * nb^2; above nb
// = 128 triangle_products_kernel forms the off-diagonal blocks next.
// CB = lu_cb(min(nb, 128)).
template <typename T, int CB>
__global__ void __launch_bounds__(kLuThreads, 1)
    triangle_inverses_kernel(const T* f, T* linv, T* uinv, int nb,
                             double tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sF = reinterpret_cast<double*>(smem_raw);
  const size_t nn = (size_t)nb * nb;
  const bool upper = blockIdx.y == 1;
  const int o = blockIdx.z * kLuMaxN;
  const int n = min(kLuMaxN, nb - o);
  const size_t d = (size_t)o * (nb + 1);
  triangle_inverse<T, CB>(f + blockIdx.x * nn + d,
                          (upper ? uinv : linv) + blockIdx.x * nn + d, upper,
                          n, nb, tol, sF, sF + 32 * CB * kLuVec);
}

// C (OP) A·B over every window of C, by the whole block; ends with a
// barrier after the last store, so that the block may read C next.
template <StoreOp OP, typename T, typename TA, typename TB>
__device__ void block_product(const Mat<TA>& a, const Mat<TB>& b,
                              const Mat<T>& c, T* smem) {
  using W = NewtonWindow<T>;
  const int nr = (c.rows + W::BM - 1) / W::BM;
  const int nc = (c.cols + W::BN - 1) / W::BN;
  for (int w = 0; w < nr * nc; ++w)
    tile_gemm<W, OP>(a, b, c, w / nc * W::BM, w % nc * W::BN, smem);
  __syncthreads();
}

// Block (b, m, i), after the levels below: node i of level `level` >= 1
// of P2's tree over the 128-wide diagonal blocks of tile b joins its
// halves, rows [o, o + h1) and [o + h1, o + h1 + h2) with h1 = 128 ·
// 2^(level - 1), o = 2 h1 i and h2 = min(h1, nb - o - h1) (no node where
// h2 <= 0): m = 0 forms L^-1's block (o + h1, o) as L22^-1·(-L21·
// L11^-1), m = 1 U^-1's block (o, o + h1) as (-U11^-1·U12)·U22^-1, each
// by two products on tensor cores in T.  The first product goes to the
// node's zero block of the other triangle (U^-1's (o + h1, o), L^-1's (o,
// o + h1): the same shape), which the block zeroes after the second.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    triangle_products_kernel(const T* f, T* linv, T* uinv, int nb,
                             int level) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int h1 = kLuMaxN << (level - 1);
  const int o = 2 * h1 * blockIdx.z, m = o + h1;
  const int h2 = min(h1, nb - m);
  if (h2 <= 0) return;
  const size_t nn = (size_t)nb * nb;
  const bool upper = blockIdx.y == 1;
  const T* a = f + blockIdx.x * nn;
  T* out = (upper ? uinv : linv) + blockIdx.x * nn;
  T* other = (upper ? linv : uinv) + blockIdx.x * nn;
  Mat<T> s;
  if (!upper) {
    // S = -L21·L11^-1 (h2 x h1), then L^-1's block = L22^-1·S
    s = block_of(other, nb, m, o, h2, h1);
    block_product<kNegate>(block_of(a, nb, m, o, h2, h1),
                           block_of(out, nb, o, o, h1, h1), s, smem);
    block_product<kStore>(block_of(out, nb, m, m, h2, h2), s,
                          block_of(out, nb, m, o, h2, h1), smem);
  } else {
    // S = -U11^-1·U12 (h1 x h2), then U^-1's block = S·U22^-1
    s = block_of(other, nb, o, m, h1, h2);
    block_product<kNegate>(block_of(out, nb, o, o, h1, h1),
                           block_of(a, nb, o, m, h1, h2), s, smem);
    block_product<kStore>(s, block_of(out, nb, m, m, h2, h2),
                          block_of(out, nb, o, m, h1, h2), smem);
  }
  for (int e = threadIdx.x; e < s.rows * s.cols; e += kGemmThreads)
    s.p[(size_t)(e / s.cols) * nb + e % s.cols] = T(0);
}

// Levels of P2's tree at nb: ceil(log2(ceil(nb / 128))).
inline int triangle_tree_levels(int nb) {
  int levels = 0;
  while ((kLuMaxN << levels) < nb) ++levels;
  return levels;
}

// L^-1 and U^-1 of a batch of factored tiles: one launch of the sweeps
// (a block per tile, triangle and 128-wide diagonal block), then one
// launch of the products a level of the tree above nb = 128.
template <typename T>
cudaError_t triangle_inverses(const T* f, T* linv, T* uinv, int batch,
                              int nb, double tol, cudaStream_t st) {
  if (batch == 0) return cudaSuccess;
  if (batch < 0 || nb < 1) return cudaErrorInvalidValue;
  const int n = nb < kLuMaxN ? nb : kLuMaxN, cb = lu_cb(n);
  const int leaves = (nb + kLuMaxN - 1) / kLuMaxN;
  void (*kern)(const T*, T*, T*, int, double) =
      cb == 1   ? triangle_inverses_kernel<T, 1>
      : cb == 2 ? triangle_inverses_kernel<T, 2>
                : triangle_inverses_kernel<T, 4>;
  const size_t smem = lu_smem_bytes<double>(n);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(batch, 2, leaves), kLuThreads, smem, st>>>(f, linv, uinv, nb,
                                                         tol);
  if ((e = cudaGetLastError()) != cudaSuccess || leaves == 1) return e;
  const int psm = (int)NewtonWindow<T>::kSmemBytes;
  if ((e = cudaFuncSetAttribute(triangle_products_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                psm)) != cudaSuccess)
    return e;
  const int levels = triangle_tree_levels(nb);
  for (int level = 1; level <= levels; ++level) {
    const int nodes = (leaves + (1 << level) - 1) >> level;
    triangle_products_kernel<T><<<dim3(batch, 2, nodes), kGemmThreads, psm,
                                  st>>>(f, linv, uinv, nb, level);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace plu
