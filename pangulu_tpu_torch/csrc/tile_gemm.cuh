// Tile products of the factorization engines on Hopper's tensor cores:
// C = A·B, C -= A·B or C = -A·B over a window of row-major matrices: nb
// x nb tiles, or blocks of them (Mat: a row stride apart from the
// bounds).
//
// Replaces the precision=HIGHEST dots inside pangulu_tpu/ops/
// kernels_pallas.py _mega_kernel (K2: the panel solves L·U^-1 and
// L^-1·U, the Schur products dst -= L·U) and _group_kernel (K4: the
// same per group member, and the summed Schur stream), and the MXU dots
// of the blocked diagonal LU (_lu_blocked) in K1's step for nb > 128.
//
// Bound on an H100: a product is nb^3 FMA on tiles that sit in L2, so
// operations bound it: 128^3 FMA is 4.2 MFLOP, 0.06 us of the card's
// 67 TFLOP/s f32 CUDA-core peak, 0.025 us at 3 x 1/495 TFLOP/s for
// 3xTF32.  A level has tens of products, so a level is one wave on
// part of the card and each block's latency sets the stage time: the
// dependent loads of its indices, the first slice and the destination,
// then its k loop.  The FMA routine this replaces ran one 128^3 panel
// product on one block (31.7 us) and a 64 x 64 Schur quadrant at ~20
// GFMA/s a block.
//
// Design:
//   * Tensor cores, true f32.  float runs error-compensated 3xTF32 on
//     mma.sync.m16n8k8: each operand element x splits into big =
//     tf32(x) and small = tf32(x - big) as its fragment is loaded (no
//     second copy in shared memory, 16 extra registers), and each
//     8-deep step issues small·big, big·small, then big·big into one
//     accumulator that starts at zero every step; that step sum is then
//     added to the running sum with an f32 add (round to nearest), so
//     the tensor core's own rounding applies to 8-term sums only (one
//     accumulator across all steps measured less accurate than the f32
//     plain version against f64 on the bench problem, and spilled in
//     group_schur_kernel; this form is not: PERF.md, measured with
//     tools/probe_products.py).  small·small is dropped.  tf32() rounds
//     as cvt.rna.tf32.f32 does, in two integer operations (see
//     tf32_rna; ptxas emits cvt.rna as several, and the products
//     measured slower with it).  double runs mma.sync.m8n8k4
//     (DMMA, which rounds like an FMA).  Both go through one routine;
//     only the atom (Mma<T>) differs.  Plain TF32 inputs are never
//     used.
//   * 4 warps (128 threads); the window is WM x WN warp tiles: 2 x 2
//     (64 x 64, a Schur quadrant), 1 x 4 (a 32-row band of an L panel)
//     or 4 x 1 (a 32-column band of a U panel), so a panel tile runs on
//     nb/32 blocks.  A band spans the whole tile: 128 wide for nb <=
//     128 (32 x 32 warp tiles), 256 wide for nb <= 256 (32 x 64 and 64 x
//     32).
//   * A and B slices (BK = 32 f32 / 16 f64 deep) are staged with
//     cp.async, double buffered: slice s+1's copy is issued after the
//     barrier that ends slice s-1 and overlaps slice s's MMAs, one
//     barrier a slice.  16-byte copies when a row is 16-byte aligned
//     (nb·sizeof(T) % 16 == 0), element copies otherwise (f32 nb not a
//     multiple of 4, e.g. 10; f64 odd nb); out-of-bounds rows, columns
//     and k are zero-filled by the copy's src-size operand, so an MMA
//     never reads past a matrix, and any bounds up to the window's
//     width work (nb <= 256 with the 256-wide bands, a block of a tile
//     with its own row stride and a k range).  Shared rows are padded
//     so that every fragment load is free of bank conflicts.
//   * The store loads every old value of a C -= A·B window before its
//     first store, 2-wide when C's pairs are aligned (row stride,
//     column bound and offset even, as for any even nb): the compiler
//     cannot tell that rows of C do not alias, so a load after a store
//     waits for it, and interleaved they were 16 dependent round trips.
//
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace plu {

constexpr int kGemmWarps = 4;
constexpr int kGemmThreads = 32 * kGemmWarps;

// A rows x cols row-major matrix at p with row stride ld: a whole nb x
// nb tile (tile_of), or a block of one (block_of).  T may be const.
template <typename T>
struct Mat {
  T* p;
  int ld, rows, cols;
};
template <typename T>
__device__ __forceinline__ Mat<T> tile_of(T* p, int nb) {
  return {p, nb, nb, nb};
}
// The rows x cols block at (r, c) of a matrix at p with row stride ld.
template <typename T>
__device__ __forceinline__ Mat<T> block_of(T* p, int ld, int r, int c,
                                           int rows, int cols) {
  return {p + (size_t)r * ld + c, ld, rows, cols};
}

// What tile_store does with the product: C = A·B, C -= A·B, C = -A·B.
enum StoreOp { kStore, kSubtract, kNegate };

__device__ __forceinline__ float fmat(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmat(double a, double b, double c) {
  return fma(a, b, c);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value: to
// nearest, ties away from zero, the low 13 bits cleared (adding half of
// the dropped range to the magnitude bits carries into the kept ones;
// kernels_torch.tf32_round is the same formula).  For sm_90 ptxas
// emits cvt.rna.tf32.f32 as several instructions, a floating compare
// and a select among them; this form is two, and differs only on NaN
// inputs, which no finite factorization feeds the products.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The MMA atom of a type: its shape, the staged slice depth, the row
// padding of the A (row-major, k contiguous) and B (k-major, n
// contiguous) slices, fragment loads from those slices (PTX ISA mma
// fragment layouts; g = lane / 4, t = lane % 4), one step, and where
// accumulator i of a fragment sits (row, col).
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int M = 16, N = 8, K = 8, NC = 4;
  // Pads: A rows of 36 words put (g, t) on bank 4g + t; B rows of BN + 8
  // words put (t, g) on bank 8t + g.
  static constexpr int BK = 32, PAD_A = 4, PAD_B = 8;
  struct AFrag {
    uint32_t big[4], small[4];
  };
  struct BFrag {
    uint32_t big[2], small[2];
  };
  __device__ static void load_a(AFrag& f, const float* s, int ld, int m0,
                                int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (m0 + g) * ld + k0 + t;
    split_tf32(p[0], f.big[0], f.small[0]);
    split_tf32(p[8 * ld], f.big[1], f.small[1]);
    split_tf32(p[4], f.big[2], f.small[2]);
    split_tf32(p[8 * ld + 4], f.big[3], f.small[3]);
  }
  __device__ static void load_b(BFrag& f, const float* s, int ld, int k0,
                                int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (k0 + t) * ld + n0 + g;
    split_tf32(p[0], f.big[0], f.small[0]);
    split_tf32(p[4 * ld], f.big[1], f.small[1]);
  }
  // c += a·b in 3xTF32: the three terms into a zeroed step sum, small
  // terms first, then one f32 add (round to nearest) into c.
  __device__ static void step(float (&c)[4], const AFrag& a,
                              const BFrag& b) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, a.small, b.big);
    mma_tf32(d, a.big, b.small);
    mma_tf32(d, a.big, b.big);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += d[i];
  }
  __device__ static int row(int i) {
    return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
  }
  __device__ static int col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }
};

template <>
struct Mma<double> {
  static constexpr int M = 8, N = 8, K = 4, NC = 2;
  // Pads: rows of 20 (A) and BN + 4 (B) doubles keep each half-warp's
  // 64-bit fragment loads on distinct bank pairs.
  static constexpr int BK = 16, PAD_A = 4, PAD_B = 4;
  struct AFrag {
    double v;
  };
  struct BFrag {
    double v;
  };
  __device__ static void load_a(AFrag& f, const double* s, int ld, int m0,
                                int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    f.v = s[(m0 + g) * ld + k0 + t];
  }
  __device__ static void load_b(BFrag& f, const double* s, int ld, int k0,
                                int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    f.v = s[(k0 + t) * ld + n0 + g];
  }
  __device__ static void step(double (&c)[2], const AFrag& a,
                              const BFrag& b) {
    mma_f64(c, a.v, b.v);
  }
  __device__ static int row(int i) { return (threadIdx.x & 31) >> 2; }
  __device__ static int col(int i) { return 2 * (threadIdx.x & 3) + i; }
};

// A BM x BN window of the product, cut into WM x WN warp tiles of TM x
// TN, its two shared-memory stages, and one thread's accumulators.
template <typename T_, int BM_, int BN_, int WM, int WN>
struct Window {
  using T = T_;
  using Mt = Mma<T>;
  static_assert(WM * WN == kGemmWarps, "one warp tile per warp");
  static constexpr int BM = BM_, BN = BN_, TM = BM / WM, TN = BN / WN;
  static constexpr int MF = TM / Mt::M, NF = TN / Mt::N;
  static_assert(MF * Mt::M * WM == BM && NF * Mt::N * WN == BN,
                "whole atoms a warp tile");
  static constexpr int BK = Mt::BK;
  static constexpr int LDA = BK + Mt::PAD_A, LDB = BN + Mt::PAD_B;
  static constexpr int STAGE = BM * LDA + BK * LDB;
  static constexpr size_t kSmemBytes = 2 * STAGE * sizeof(T);
  struct Acc {
    T v[MF][NF][Mt::NC];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int i = 0; i < Mt::NC; ++i) v[m][n][i] = T(0);
    }
  };
  // the first row and column of this thread's warp tile
  __device__ static int warp_row() { return threadIdx.x / 32 / WN * TM; }
  __device__ static int warp_col() { return threadIdx.x / 32 % WN * TN; }
};

// cp.async of BYTES (4, 8 or 16) bytes, zero-filled when !in.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS x COLS of the nr x nc matrix src (row stride lds) at (gr0, gc0)
// into dst (row stride ld), zero outside the matrix.  With vec every
// row of src is 16-byte aligned and nc a multiple of the chunk, so a
// chunk is wholly inside or wholly outside.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int lds,
                                      int nr, int nc, int gr0, int gc0,
                                      bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), CPR = COLS / V;
    static_assert(ROWS * CPR % kGemmThreads == 0, "whole copies a thread");
#pragma unroll
    for (int j = 0; j < ROWS * CPR / kGemmThreads; ++j) {
      const int e = threadIdx.x + j * kGemmThreads;
      const int r = e / CPR, c = e % CPR * V, gr = gr0 + r, gc = gc0 + c;
      const bool in = gr < nr && gc < nc;
      cp_async<16>(dst + r * ld + c, in ? src + (size_t)gr * lds + gc : src,
                   in);
    }
  } else {
    static_assert(ROWS * COLS % kGemmThreads == 0, "whole copies a thread");
#pragma unroll 4
    for (int j = 0; j < ROWS * COLS / kGemmThreads; ++j) {
      const int e = threadIdx.x + j * kGemmThreads;
      const int r = e / COLS, c = e % COLS, gr = gr0 + r, gc = gc0 + c;
      const bool in = gr < nr && gc < nc;
      cp_async<sizeof(T)>(dst + r * ld + c,
                          in ? src + (size_t)gr * lds + gc : src, in);
    }
  }
}

// The barrier of a product's threads: the whole block (BAR = 0), or,
// for a block whose other warps do other work at the same time (the
// probes of probes.cuh), named barrier BAR of the kGemmThreads threads
// of the block's first kGemmWarps warps.
template <int BAR>
__device__ __forceinline__ void gemm_sync() {
  if constexpr (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(kGemmThreads)
                 : "memory");
}

// acc += A·B over the window W at (r0, c0), k over A.cols (= B.rows);
// smem holds W::kSmemBytes.  Ends with a barrier (gemm_sync<BAR>).
template <class W, int BAR = 0, typename TA, typename TB>
__device__ void tile_gemm_acc(const Mat<TA>& A, const Mat<TB>& B, int r0,
                              int c0, typename W::Acc& acc,
                              typename W::T* smem) {
  using T = typename W::T;
  using Mt = typename W::Mt;
  // 16-byte copies when both operands' rows start 16-byte aligned and
  // each bound along a row is a whole number of chunks
  constexpr int V = 16 / sizeof(T);
  const bool vec = (A.ld | B.ld | A.cols | B.cols) % V == 0 &&
                   ((size_t)A.p | (size_t)B.p) % 16 == 0;
  const int nk = (A.cols + W::BK - 1) / W::BK;
  const int wr = W::warp_row(), wc = W::warp_col();
  // slice s into buffer s & 1, as one copy group.  Double buffered: a
  // block has 4 f32 slices at nb = 128, 8 at nb = 256 (a 4-slice ring
  // is a variant of tools/probe_products.py; PERF.md has its times).
  auto load = [&](int s) {
    T* sa = smem + (s & 1) * W::STAGE;
    stage<T, W::BM, W::BK>(sa, W::LDA, A.p, A.ld, A.rows, A.cols, r0,
                           s * W::BK, vec);
    stage<T, W::BK, W::BN>(sa + W::BM * W::LDA, W::LDB, B.p, B.ld, B.rows,
                           B.cols, s * W::BK, c0, vec);
    cp_async_commit();
  };
  load(0);
  for (int s = 0; s < nk; ++s) {
    // slice s has landed for every thread, and every read of slice
    // s - 1 is done, so its buffer takes slice s + 1
    cp_async_wait_all();
    gemm_sync<BAR>();
    if (s + 1 < nk) load(s + 1);
    const T* sa = smem + (s & 1) * W::STAGE;
    const T* sb = sa + W::BM * W::LDA;
#pragma unroll
    for (int kk = 0; kk < W::BK; kk += Mt::K) {
      typename Mt::AFrag a[W::MF];
      typename Mt::BFrag b[W::NF];
#pragma unroll
      for (int m = 0; m < W::MF; ++m)
        Mt::load_a(a[m], sa, W::LDA, wr + m * Mt::M, kk);
#pragma unroll
      for (int n = 0; n < W::NF; ++n)
        Mt::load_b(b[n], sb, W::LDB, kk, wc + n * Mt::N);
#pragma unroll
      for (int m = 0; m < W::MF; ++m)
#pragma unroll
        for (int n = 0; n < W::NF; ++n) Mt::step(acc.v[m][n], a[m], b[n]);
    }
  }
  gemm_sync<BAR>();  // the last slice's reads are done
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using V = float2;
};
template <>
struct Pair<double> {
  using V = double2;
};

// This thread's accumulators of the window W come in pairs (acc[m][n][i],
// acc[m][n][i+1]) at row r and columns c, c + 1 of the tile; pair_at
// gives (r, c) of a pair.
template <class W>
__device__ __forceinline__ void pair_at(int r0, int c0, int m, int n, int i,
                                        int& r, int& c) {
  using Mt = typename W::Mt;
  r = r0 + W::warp_row() + m * Mt::M + Mt::row(i);
  c = c0 + W::warp_col() + n * Mt::N + Mt::col(i);
}

// The window W at (r0, c0) of C = acc (OP kStore), C -= acc
// (kSubtract) or C = -acc (kNegate).  A pair is one 2-wide access when
// the row stride, the column bound and C's offset are even (then every
// pair is aligned and wholly inside or outside C); otherwise its second
// column may be outside.  With kSubtract every old value is loaded
// before the first store, so that the loads are in flight together:
// the compiler cannot tell that rows of C do not alias, so a load
// after a store waits for it.
template <class W, StoreOp OP>
__device__ void tile_store(const Mat<typename W::T>& C, int r0, int c0,
                           const typename W::Acc& acc) {
  using T = typename W::T;
  using V = typename Pair<T>::V;
  constexpr bool SUB = OP == kSubtract;
  const int nr = C.rows, nc = C.cols;
  const bool wide =
      (C.ld | nc | (int)((size_t)C.p / sizeof(T))) % 2 == 0;
  typename W::Acc old;
  if (SUB) {
#pragma unroll
    for (int m = 0; m < W::MF; ++m)
#pragma unroll
      for (int n = 0; n < W::NF; ++n)
#pragma unroll
        for (int i = 0; i < W::Mt::NC; i += 2) {
          int r, c;
          pair_at<W>(r0, c0, m, n, i, r, c);
          if (r >= nr || c >= nc) continue;
          const T* p = C.p + (size_t)r * C.ld + c;
          if (wide) {
            const V v = *reinterpret_cast<const V*>(p);
            old.v[m][n][i] = v.x;
            old.v[m][n][i + 1] = v.y;
          } else {
            old.v[m][n][i] = p[0];
            old.v[m][n][i + 1] = c + 1 < nc ? p[1] : T(0);
          }
        }
  }
#pragma unroll
  for (int m = 0; m < W::MF; ++m)
#pragma unroll
    for (int n = 0; n < W::NF; ++n)
#pragma unroll
      for (int i = 0; i < W::Mt::NC; i += 2) {
        int r, c;
        pair_at<W>(r0, c0, m, n, i, r, c);
        if (r >= nr || c >= nc) continue;
        T* p = C.p + (size_t)r * C.ld + c;
        T x = acc.v[m][n][i], y = acc.v[m][n][i + 1];
        if (SUB) {
          x = old.v[m][n][i] - x;
          y = old.v[m][n][i + 1] - y;
        } else if (OP == kNegate) {
          x = -x;
          y = -y;
        }
        if (wide) {
          *reinterpret_cast<V*>(p) = V{x, y};
        } else {
          p[0] = x;
          if (c + 1 < nc) p[1] = y;
        }
      }
}

// The window W at (r0, c0) of C (OP) A·B; BAR as for tile_gemm_acc.
template <class W, StoreOp OP, int BAR = 0, typename TA, typename TB>
__device__ void tile_gemm(const Mat<TA>& A, const Mat<TB>& B,
                          const Mat<typename W::T>& C, int r0, int c0,
                          typename W::T* smem) {
  typename W::Acc acc;
  acc.zero();
  tile_gemm_acc<W, BAR>(A, B, r0, c0, acc, smem);
  tile_store<W, OP>(C, r0, c0, acc);
}

}  // namespace plu
