// K1 for tiles wider than 256: getrf_with_inverses at nb > kMaxNb.
//
// Replaces pangulu_tpu/ops/kernels_pallas.py getrf_with_inverses
// (_getrf_inv_kernel -> _lu_inverses, pallas_call at :605) for the tiles
// the JAX package's fused and levels engines give it at nb = 384 or 512:
// one [nb, nb] tile in, (f, L^-1, U^-1) out.  The TPU kernel holds the
// whole tile in VMEM and scans it.  On the H100 a tile of 512 is 1 MiB
// in float and 2 MiB in double; K1's cluster kernel for 128 < nb <= 256
// (lu_cluster_kernel) keeps a 256-row working matrix and its panel rows
// in the shared memory of 2 (float) or 4 (double) CTAs, and at 512 a
// CTA would need its own rows and 128 KiB of panel rows in double, above
// the 227 KB a block may take.  So a wide tile is factored by the
// recursive block step of the JAX package's XLA diagonal step
// (pangulu_tpu/ops/kernels_jax.py:200-248), split at wide_split (the JAX
// _split: about half, a multiple of 32), on K1's own kernels:
//   1. (F11, L11^-1, U11^-1) of A11: K1 (DiagStep) on a copy of A11, or
//      recursively when A11 is wider than 256;
//   2. U12 = L11^-1·A12 and L21 = A21·U11^-1 (one launch, two products);
//   3. S22 = A22 - L21·U12 into a scratch block (a copy, then a product);
//   4. (F22, L22^-1, U22^-1) of S22: K1 in place on the scratch block;
//   5. Tl = L21·L11^-1 and Tu = U12·U22^-1, then L^-1[2, 1] = -L22^-1·Tl
//      and U^-1[1, 2] = -U11^-1·Tu (two launches of two products).
// The products are tile_gemm's 64 x 64 windows on tensor cores (3xTF32
// for float, DMMA for double), as in K2's Schur stage; every operand is a
// block of a row-major matrix with its own row stride, so no block is
// copied for a product.  The leaves' results go to their blocks of f,
// L^-1 and U^-1 with one copy launch, and the zero blocks of the two
// inverses are written with the copy of A22.  The tiny-pivot rule holds
// in each leaf, where K1 applies it.  At 256 < nb <= 512 a call is 10
// device launches: 2 of K1, 1 copy in (A11), 1 of A22 with the zero
// blocks, 2 out (the leaves' results), 4 of products; nb above 512
// recurses once more.  A call counts as one K1 launch, its device
// launches beside it.
//
// Bound on an H100 at nb = 512 in float, batch 1: the tile read once and
// f, L^-1 and U^-1 written once, 4 MiB, 1.3e-03 ms at 3.35 TB/s; its
// ~1.8e8 operations (lu_inverse_flop) 2.7e-03 ms at 67 TFLOP/s, less on
// tensor cores.  In fact a chain of dependent launches: the two leaves'
// cluster K1 (~0.13 ms each at 256, PERF.md) and six stages of products
// that fill 16 of the 132 SMs each.  A one-launch K1 at 512 (a cluster
// of 8 CTAs in float, the panel rows streamed in double) is ROADMAP W4.
//
// The plain twin is kernels_torch.getrf_with_inverses_wide with
// kernels_torch.k1_leaf at the leaves.
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace plu {

// C (OP) A·B on every tile b of a batch: an operand is the block at p +
// b * s (s: the batch stride, in elements) with row stride ld.
template <typename T>
struct WideProduct {
  const T* a;
  const T* b;
  T* c;
  size_t sa, sb, sc;
  int lda, ldb, ldc, m, n, k;
};

// Up to two independent products of one store op in one launch.
template <typename T>
struct WideProducts {
  WideProduct<T> p[2];
};

// Block (q, b, z): the 64 x 64 window q of product z on tile b.
template <typename T, StoreOp OP>
__global__ void __launch_bounds__(kGemmThreads)
    wide_gemm_kernel(WideProducts<T> ps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideProduct<T> p = blockIdx.z ? ps.p[1] : ps.p[0];
  const int qn = (p.n + kQuad - 1) / kQuad;
  const int q = blockIdx.x;
  if (q >= qn * ((p.m + kQuad - 1) / kQuad)) return;
  const size_t b = blockIdx.y;
  const Mat<const T> A{p.a + b * p.sa, p.lda, p.m, p.k};
  const Mat<const T> B{p.b + b * p.sb, p.ldb, p.k, p.n};
  const Mat<T> C{p.c + b * p.sc, p.ldc, p.m, p.n};
  tile_gemm<Quad<T>, OP>(A, B, C, q / qn * kQuad, q % qn * kQuad,
                         reinterpret_cast<T*>(smem_raw));
}

// dst = src (m x n blocks, batch strides as WideProduct), or dst = 0
// where src is nullptr.
template <typename T>
struct WideCopy {
  const T* src;
  T* dst;
  size_t ss, sd;
  int lds, ldd, m, n;
};

constexpr int kWideCopies = 3;
constexpr int kCopyThreads = 256;

template <typename T>
struct WideCopies {
  WideCopy<T> c[kWideCopies];
};

// Block (x, b, z): a grid-stride share of copy z on tile b.
template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
    wide_copy_kernel(WideCopies<T> cs) {
  const WideCopy<T> c = blockIdx.z == 0   ? cs.c[0]
                        : blockIdx.z == 1 ? cs.c[1]
                                          : cs.c[2];
  const size_t b = blockIdx.y;
  const int total = c.m * c.n;
  for (int e = blockIdx.x * kCopyThreads + threadIdx.x; e < total;
       e += gridDim.x * kCopyThreads) {
    const int r = e / c.n, j = e - r * c.n;
    c.dst[b * c.sd + (size_t)r * c.ldd + j] =
        c.src ? c.src[b * c.ss + (size_t)r * c.lds + j] : T(0);
  }
}

// The first half of a split of m (kernels_jax._split, base 32).
inline int wide_split(int m) {
  constexpr int base = 32;
  const int h = ((m + 1) / 2 + base - 1) / base * base;
  if (m - h < base && m > base) return h < m - base ? h : m - base;
  return h;
}

// Elements of scratch a tile of m needs: a leaf its three m x m blocks,
// a split S22 and the two products Tl, Tu, beside the larger need of its
// halves.
inline size_t wide_work_elems(int m) {
  if (m <= kMaxNb) return 3 * (size_t)m * m;
  const size_t m1 = wide_split(m), m2 = m - m1;
  const size_t half = wide_work_elems((int)m1) > wide_work_elems((int)m2)
                          ? wide_work_elems((int)m1)
                          : wide_work_elems((int)m2);
  return m2 * m2 + 2 * m1 * m2 + half;
}

// One call of K1 on a batch of wide tiles: the recursion of the note
// above, the scratch taken from ``work`` as a stack.
template <typename T>
struct WideLu {
  T* f;
  T* linv;
  T* uinv;
  T* work;  // batch * wide_work_elems(nb)
  int nb, batch;
  T tol;
  cudaStream_t st;
  int launches = 0;

  cudaError_t done() {
    ++launches;
    return cudaGetLastError();
  }

  cudaError_t copies(const WideCopy<T>* c, int count) {
    WideCopies<T> cs{};
    int most = 0;
    for (int i = 0; i < count; ++i) {
      cs.c[i] = c[i];
      if (c[i].m * c[i].n > most) most = c[i].m * c[i].n;
    }
    int blocks = (most + kCopyThreads - 1) / kCopyThreads;
    if (blocks > 64) blocks = 64;
    wide_copy_kernel<T>
        <<<dim3(blocks, batch, count), kCopyThreads, 0, st>>>(cs);
    return done();
  }

  template <StoreOp OP>
  cudaError_t products(const WideProduct<T>* p, int count) {
    WideProducts<T> ps{};
    int most = 0;
    for (int i = 0; i < count; ++i) {
      ps.p[i] = p[i];
      const int q = ((p[i].m + kQuad - 1) / kQuad) *
                    ((p[i].n + kQuad - 1) / kQuad);
      if (q > most) most = q;
    }
    cudaError_t e = cudaFuncSetAttribute(
        wide_gemm_kernel<T, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)schur_smem_bytes<T>());
    if (e != cudaSuccess) return e;
    wide_gemm_kernel<T, OP><<<dim3(most, batch, count), kGemmThreads,
                              schur_smem_bytes<T>(), st>>>(ps);
    return done();
  }

  // The block of f, linv or uinv at (r, c) of each tile.
  T* at(T* base, int r, int c) const { return base + (size_t)r * nb + c; }

  // (F, L^-1, U^-1) of the m x m block ``src`` (row stride lds, batch
  // stride ss) into the diagonal block at (o, o) of f, linv and uinv;
  // ``top`` is the free scratch.  ``own``: src is a scratch block (lds ==
  // m, ss == m * m), which a leaf factors in place.
  cudaError_t run(const T* src, int lds, size_t ss, int m, int o, T* top,
                  bool own) {
    const size_t nn = (size_t)nb * nb;
    cudaError_t e;
    if (m <= kMaxNb) {
      const size_t mm = (size_t)m * m;
      T* sa = own ? const_cast<T*>(src) : top;
      T* sl = own ? top : sa + batch * mm;
      T* su = sl + batch * mm;
      if (!own) {
        const WideCopy<T> in{src, sa, ss, mm, lds, m, m, m};
        if ((e = copies(&in, 1)) != cudaSuccess) return e;
      }
      DiagStep<T> diag;
      if ((e = diag.init(m)) != cudaSuccess) return e;
      int k1[2] = {0, 0};
      if ((e = diag.run(sa, sa, sl, su, mm, nullptr, nullptr, batch, tol, k1,
                        st)) != cudaSuccess)
        return e;
      launches += k1[1];
      const WideCopy<T> out[3] = {
          {sa, at(f, o, o), mm, nn, m, nb, m, m},
          {sl, at(linv, o, o), mm, nn, m, nb, m, m},
          {su, at(uinv, o, o), mm, nn, m, nb, m, m}};
      return copies(out, 3);
    }
    const int m1 = wide_split(m), m2 = m - m1, p = o + m1;
    const size_t s22 = (size_t)m2 * m2, t = (size_t)m1 * m2;
    T* sb = top;                    // S22, then L22's factor in place
    T* tl = sb + batch * s22;       // L21·L11^-1 (m2 x m1)
    T* tu = tl + batch * t;         // U12·U22^-1 (m1 x m2)
    T* next = tu + batch * t;
    if ((e = run(src, lds, ss, m1, o, next, false)) != cudaSuccess)
      return e;
    const WideProduct<T> panels[2] = {
        // U12 = L11^-1·A12, L21 = A21·U11^-1
        {at(linv, o, o), src + m1, at(f, o, p), nn, ss, nn, nb, lds, nb, m1,
         m2, m1},
        {src + (size_t)m1 * lds, at(uinv, o, o), at(f, p, o), ss, nn, nn,
         lds, nb, nb, m2, m1, m1}};
    if ((e = products<kStore>(panels, 2)) != cudaSuccess) return e;
    // S22 = A22 into the scratch; L^-1[1, 2] = 0, U^-1[2, 1] = 0
    const WideCopy<T> fill[3] = {
        {src + (size_t)m1 * lds + m1, sb, ss, s22, lds, m2, m2, m2},
        {nullptr, at(linv, o, p), 0, nn, 0, nb, m1, m2},
        {nullptr, at(uinv, p, o), 0, nn, 0, nb, m2, m1}};
    if ((e = copies(fill, 3)) != cudaSuccess) return e;
    // S22 -= L21·U12
    const WideProduct<T> schur{at(f, p, o), at(f, o, p), sb, nn, nn, s22,
                               nb, nb, m2, m2, m2, m1};
    if ((e = products<kSubtract>(&schur, 1)) != cudaSuccess) return e;
    if ((e = run(sb, m2, s22, m2, p, next, true)) != cudaSuccess)
      return e;
    const WideProduct<T> inner[2] = {
        // Tl = L21·L11^-1, Tu = U12·U22^-1
        {at(f, p, o), at(linv, o, o), tl, nn, nn, t, nb, nb, m1, m2, m1, m1},
        {at(f, o, p), at(uinv, p, p), tu, nn, nn, t, nb, nb, m2, m1, m2, m2}};
    if ((e = products<kStore>(inner, 2)) != cudaSuccess) return e;
    const WideProduct<T> outer[2] = {
        // L^-1[2, 1] = -L22^-1·Tl, U^-1[1, 2] = -U11^-1·Tu
        {at(linv, p, p), tl, at(linv, p, o), nn, t, nn, nb, m1, nb, m2, m1,
         m2},
        {at(uinv, o, o), tu, at(uinv, o, p), nn, t, nn, nb, m2, nb, m1, m2,
         m1}};
    return products<kNegate>(outer, 2);
  }
};

// K1 on ``batch`` tiles of nb > kMaxNb from a into f, linv, uinv (all
// [batch, nb, nb]; f may not be a), with ``work`` of batch *
// wide_work_elems(nb) elements.  counts[0] += 1, counts[1] += the
// device launches.
template <typename T>
int getrf_inv_wide(const T* a, T* f, T* linv, T* uinv, T* work, int batch,
                   int nb, double tol, int* counts, cudaStream_t st) {
  if (nb <= kMaxNb || a == f) return cudaErrorInvalidValue;
  WideLu<T> w{f, linv, uinv, work, nb, batch, (T)tol, st};
  const cudaError_t e = w.run(a, nb, (size_t)nb * nb, nb, 0, work, false);
  if (e != cudaSuccess) return e;
  ++counts[0];
  counts[1] += w.launches;
  return cudaSuccess;
}

}  // namespace plu
