// Kernels of the TPU compiler probes P5, P4 and P3, which lie on no path
// of the solver: each asks the card a question that decides a design of
// the factorization.  Included by lu_kernels.cu, whose C interface
// exposes them; pangulu_tpu_torch/tools/probe_{overlap,scan_multi,
// newton_loop}.py ask the questions.
//
// The scan chain (P5, P4): step s of an n x n chain f (n <= 128) at
// pivot k = s mod n is f[i][j] = fma(-(f[i][k] / p), f[k][j], f[i][j])
// for i, j > k, with p = f[k][k] and |p| < 1e-8 -> +1e-8; no multiplier
// is stored, so later passes (k wraps) use the columns the first left
// (tools/exp_overlap.py _scan_step; kernels_torch.probe_scan_step is
// the plain twin, rounding the update once as this FMA does).  It is
// K1's step without L^-1 and the stored L: 8 warps hold a chain in
// registers as K1 holds its tile (tile_lu.cuh: warp sw owns rows sw +
// 8a, lane tx columns tx + 32b, the step loop unrolled over the row
// block so that every register index is a constant), row k goes
// through shared memory (one row buffer, double buffered by the step's
// parity: one barrier a step), column k by a shuffle, the division by
// quot as in K1.
//
// The products' types (P5, P4): acc <- a · acc from acc = b, one a step,
// on the tensor cores (tile_gemm.cuh's atoms), on copies of a and acc
// of the product type P:
//   * P = double (the default, "f64"): DMMA (mma.sync f64 m16n8k8,
//     MmaF64 below) on float64 copies; the result is rounded to float32
//     once, at the end.
//     At least as accurate as float32 (the probes' Precision.HIGHEST):
//     the instance the checks hold to true f32.
//   * P = float ("tf32x3"): 3xTF32, the solver's float products (K2,
//     K4), timed beside it so that the probes' answers hold for the
//     products the solver runs.  Not true f32 on this chain: the tensor
//     core truncates the sums it accumulates, and with a ~ I every
//     product of the chain truncates the same way, so the chain drifts:
//     3.9x the plain float32 chain's error against float64 after 128
//     products on the H100 (PERF.md), against the 2x of true f32.
//
// P5 overlap_kernel<MODE, P> (replaces tools/exp_overlap.py run,
//   :63-72): f = a through `steps` scan steps (unless kProbeDots) and
//   acc = a^steps · b (unless kProbeScan); out = f + acc (kProbeDots: a
//   + acc; kProbeScan: f + b).
//   Bound on an H100: operations.  4096 products of 2 * 128^3 flop are
//   1.72e10 flop: 0.2564 ms at 67 TFLOP/s (DMMA) on the whole card,
//   2.115 ms on the 16 SMs this layout runs them on (3xTF32: 0.859 ms
//   there at 495/3 TFLOP/s); the scan's updates are ~4.5e7 flop (32
//   passes), but its 4096 dependent steps bound it by latency (~244 ns
//   a step: a barrier, a shared read, a shuffle and a division).
//   Layout: acc's columns over CTAs.  Column j of a^s · b depends only
//   on column j of b, so a CTA that owns whole columns of acc and holds
//   all of a needs nothing from any other CTA for the whole chain.  A
//   copy is (n + 7) / 8 product CTAs (16 at n = 128); CTA j owns acc's
//   columns 8j ... 8j + 7 (one MmaF64 or Mma<float> atom wide), loads a
//   (in P, 128 x 132: 135,168 bytes of double) and b's strip once, and
//   runs the chain on its strip from shared memory, the strip twice (by
//   step parity: one barrier a step), on 4 warps of 32 rows each, one to
//   an SM sub-partition.  Nothing of acc leaves the CTA until the end.
//   A step is bound by its shared-memory reads, not by DMMA (clock64 and
//   timing-only edits, PERF.md PR 14: all of a and the strip, ~160 KB, in
//   ~1,900 cycles; the MMAs alone ~1,300): so each warp keeps the A
//   fragments of k's first chunks in registers for the whole chain, 8 of
//   16 in mode dots, 4 beside the scan (strip_reg_chunks), and reads the
//   rest a step (dots 4.37 -> 3.69 ms, the same bits).
//   P4's 2D blocks (PR 12) need, for block (i, j) of a · acc, all of
//   acc's column strip j from 4 owners: a copy through distributed
//   shared memory and a cluster barrier every step (2.67 us a step);
//   whole columns need neither.  The scan is K1's layout (scan_loop
//   below), on the SM of CTA 0: kProbeScan, one CTA of the 8 scan
//   warps; kProbeBoth and kProbeSplit, CTA 0 holds the scan's 8 warps
//   beside strip 0's 4 product warps (warps 0-3 products, 4-11 scan):
//   kProbeSplit takes one CTA barrier a step, so a product and a scan
//   step run side by side (t ~ max), kProbeBoth two, the scan step
//   between the first and the second and the product after the second,
//   so they run in turn (t ~ sum), as the probe's one loop body asks.
//   CTAs 1 ... of those modes run only their products: a launch has one
//   block shape, and one CTA an SM either way (shared memory), so their
//   scan warps return at once and their product warps take a named
//   barrier of their own.  The sum: each CTA writes its part (f, or its
//   strip of acc rounded once to float) to global memory, and the CTA
//   that arrives last (a completion counter of the call's own behind
//   __threadfence, reset by that CTA) adds out = f + acc, one addition
//   an element, in the plain version's order; no CTA waits on another.
//   Measured and dropped (pangulu_tpu_torch/tools/probe_overlap.py
//   --edits; PERF.md PR 14): 8 product warps of 16 rows (no faster: the
//   same bytes a step); 2 CTAs a strip in a cluster of 2, 64 rows each,
//   the strip's halves exchanged through distributed shared memory
//   (dots 5.5 ms: a cluster barrier a step); 2 or 4 accumulators an
//   atom over k (no faster: not the MMAs' latency); 16-byte fragment
//   loads, k's pairs side by side and the strip transposed (dots 5.3
//   ms: the loads' bytes stay, and the transposed stores conflict);
//   more chunks in registers (spills).
//
// P4 scan_multi_kernel<C, P> (replaces tools/exp_scan_multi.py run)
//   Q chains f_i = a + i through `steps` scan steps and (C > 0) acc <-
//   a · acc from acc = b; output ((f_0 + f_1) + ...) + acc (acc = b
//   without products).  One launch a call:
//   * every chain on a CTA of its own, in registers (the layout above);
//     a chain is 64 KB of f32, so a CTA holds one and no chain lives in
//     shared or global memory;
//   * the chain of products on a thread block cluster of C CTAs (C = 4,
//     8, 16; ClusterBlocks below): acc in the cluster's shared memory in
//     2D blocks, CTA (i, j) holding block (i, j) twice (read and
//     written by parity) and a's row strip i for the whole run.  A step:
//     the CTA copies the column strip j of acc from its owners'
//     (distributed shared memory), forms its block of a · acc on the
//     tensor cores, stores it, and takes one cluster barrier;
//   * a CTA that finishes writes its part (a chain, or its block of acc
//     rounded once to float) to a workspace, and the last CTA of a copy
//     (a completion counter behind __threadfence; the kernel resets it
//     to 0) sums the parts in the plain twin's order.
//   The cluster launch gives every CTA of the grid a cluster: the chain
//   CTAs form clusters of their own (C + ceil(Q / C) C CTAs a copy, the
//   spare ones return at once); without products a copy is Q CTAs.  A
//   product CTA's shared memory: a's row strip, acc's column strip and
//   its own block twice; with float64 products at C = 4 that is 236,544
//   bytes, more than the 232,448 a CTA may have, so the card refuses it
//   (3xTF32 at C = 4: 121,344).
//   Bound: the products' operations (2048 products of 2 * 128^3 flop,
//   0.128 ms at 67 TFLOP/s DMMA); a dependent chain cannot reach it: a
//   step is one block product on each CTA (32 x 32 x 128 at C = 16, ~0.5
//   us at one SM's DMMA share), the copy of a column strip (32 KB at C =
//   16) and a cluster barrier; the chains' steps run beside it on other
//   SMs (243.7 ns a step, PERF.md).
//
// P3 newton_loop_kernel<S, C> (replaces tools/exp_batched_scan.py
//   newton_loop): X = 2I - L, then `steps` times X <- X (2I - L X), for
//   each of G members L as given.  One cluster of C CTAs a member (C =
//   4, 8, 16; grid C x G, one launch), the member padded to 128 with the
//   identity (its iterates stay I there), in float64, cut into
//   ClusterBlocks' 2D blocks, except that the 32 rows of row block i are
//   the 16-row groups i and 7 - i.  CTA (i, j) forms block (i, j) of
//   each product.  It keeps L's rows in shared memory for the whole run;
//   X (by step parity) and Y pass between the CTAs through a workspace
//   in global memory (L2): a CTA stores its block there, and after the
//   cluster barrier loads by cp.async what its next product reads (X's
//   column strip j, and X's rows while L·X runs; Y's column strip j).  A
//   step is two products, each with one cluster barrier; the products
//   run in float64 on MmaF64, rounded to S once, at the store of the
//   result.  Distributed shared memory carried the blocks in the first
//   design and bounded it (~10-14 bytes a cycle into an SM on the H100,
//   PERF.md; L2 gives 2-3x that), and holding X twice in shared
//   memory shut out C = 4, the one size whose 16 clusters (G = 16) fit
//   the card in one wave.  A member whose strictly upper part is zero (a
//   flag each CTA forms for its rows, OR-ed over the cluster through
//   distributed shared memory at the first barrier) keeps X and Y lower
//   triangular, so a tile sums k only from its first column to its last
//   row, rows of a strip outside a CTA's k are not loaded, and pieces
//   above the diagonal are zero-filled, not read; a general member takes
//   full products.  The rows of a lower
//   triangle cost in proportion to their index: with the groups i and 7
//   - i a row block, and NewtonTiles pairing each warp's tiles, the SM's
//   sub-partitions take like shares (at C = 4 the heaviest sums 1.33x
//   the cluster's mean, 40,960 multiply-adds a product, against 65,536
//   for the one tile that sums all 128 k with contiguous rows; at C = 8
//   and 16 the column blocks on the left still sum more;
//   tests/test_torch_probe_clusters.py).  Measured slower on the H100
//   (PERF.md): loading the B operand in 4 groups of 32 rows, each
//   product starting on the first while the others land (its 4 CTA
//   barriers a product cost more than the overlap saved); keeping a
//   CTA's own blocks in shared memory and loading only the peers'; and
//   skipping the pieces no product reads (a test a piece cost more than
//   the loads it saved).  Shared memory a CTA: 2 row strips (32
//   x 132) and one column strip (128 x (128 / (C / 4) + 4)) of doubles:
//   202,768 bytes at C = 4, 137,232 at 8, 104,464 at 16.
//   Bound: bytes.  The function is the inverse of G unit lower
//   triangles: G nb^2 values in and out (2.1 MB at G = 16, nb = 128,
//   0.63 us at 3.35 TB/s), and G (nb^3 / 3) flop whatever the
//   algorithm (1.1e7, 0.17 us at 67 TFLOP/s); the doubling's 2 steps
//   products a member are this algorithm's, not the function's.  In
//   fact a chain of 2 steps dependent products, each a cluster barrier
//   (~0.45 us at C = 4), a load from L2 and a block product.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_gemm.cuh"
#include "tile_lu.cuh"

namespace plu {

// A chain's register tile is 128 x 128 (a smaller n is zero-padded, and
// the padding stays 0: its multipliers and row entries are 0).
constexpr int kProbeNb = 128;
constexpr int kScanWarps = kLuWarps;
constexpr int kChainRows = kProbeNb / kScanWarps;  // rows a thread holds
constexpr int kChainCols = kProbeNb / 32;          // columns a thread holds
constexpr float kProbeTol = 1e-8f;

enum ProbeMode { kProbeScan, kProbeDots, kProbeBoth, kProbeSplit };

struct ChainTile {
  float v[kChainRows][kChainCols];
};

// Step k = 8 ka + w (row block ka, column block kb = ka / 4) of a chain
// in registers, row k in `row` (stored by its owner warp before the
// step's barrier).  sw: this thread's scan warp, tx its lane.  Called
// from loops unrolled over ka, so that ka and kb are constants.
__device__ __forceinline__ void chain_step(ChainTile& f, const float* row,
                                           int k, int ka, int kb, int w,
                                           int sw, int tx) {
  const int c = k & 31;  // the lane that holds column k
  const float piv = safe_pivot(row[k], kProbeTol);
  const float rp = recip(piv);
  float rv[kChainCols];
#pragma unroll
  for (int b = kb; b < kChainCols; ++b) rv[b] = row[tx + 32 * b];
#pragma unroll
  for (int ia = ka; ia < kChainRows; ++ia) {
    if (ia == ka && sw <= w) continue;  // row k, or a row above it
    const float l = quot(__shfl_sync(0xffffffffu, f.v[ia][kb], c), piv, rp);
#pragma unroll
    for (int b = kb; b < kChainCols; ++b) {
      const float nv = fmaf(-l, rv[b], f.v[ia][b]);
      f.v[ia][b] = (b > kb || tx > c) ? nv : f.v[ia][b];
    }
  }
}

// The scan warps' loop: `steps` steps of the chain in f.  A step: the
// owner warp of row k stores it from f, a CTA barrier, the update, and
// in kProbeBoth a second CTA barrier, after which the product warps run
// the step's product.  bcast: 2 row buffers.
template <int MODE>
__device__ __forceinline__ void scan_loop(ChainTile& f, float* bcast, int n,
                                          int steps, int sw, int tx) {
  for (int s0 = 0; s0 < steps; s0 += n) {
#pragma unroll
    for (int ka = 0; ka < kChainRows; ++ka) {
      const int kb = ka / (32 / kScanWarps);
#pragma unroll 1
      for (int w = 0; w < kScanWarps; ++w) {
        const int k = kScanWarps * ka + w;
        if (k >= n || s0 + k >= steps) break;
        // the step's parity: consecutive steps differ also where k wraps
        float* row = bcast + ((s0 + k) & 1) * kProbeNb;
        if (sw == w) {
#pragma unroll
          for (int b = kb; b < kChainCols; ++b) row[tx + 32 * b] = f.v[ka][b];
        }
        __syncthreads();
        chain_step(f, row, k, ka, kb, w, sw, tx);
        if (MODE == kProbeBoth) __syncthreads();
      }
    }
  }
}

// ------------------------------------------------ clusters (P4, P3)

// The CTAs of P4's and P3's kernels: 8 warps (a chain's register tile).
constexpr int kClusterWarps = kScanWarps;
constexpr int kClusterThreads = 32 * kClusterWarps;

// One barrier of the whole cluster (.aligned: each warp reaches it
// converged).  Release and acquire: a CTA's shared-memory stores before
// it are seen by the peers' reads after it.
__device__ __forceinline__ void cluster_sync_all() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 2D blocks of a 128 x 128 matrix over a cluster of C CTAs: 4 row
// blocks of BR = 32 rows and C / 4 column blocks of BC columns; the CTA
// of rank r owns block (i, j) = (r / PC, r % PC).  The 8 warps cut a
// block into 2 x 4 warp tiles of TM x TN.
template <int C>
struct ClusterBlocks {
  static_assert(C == 4 || C == 8 || C == 16, "4 row blocks, C / 4 columns");
  static constexpr int PR = 4, PC = C / PR;
  static constexpr int BR = kProbeNb / PR, BC = kProbeNb / PC;
  static constexpr int WM = 2, WN = kClusterWarps / WM;
  static constexpr int TM = BR / WM, TN = BC / WN;
  // the first row and column of this thread's warp tile in the block
  __device__ static int warp_row() { return threadIdx.x / 32 / WN * TM; }
  __device__ static int warp_col() { return threadIdx.x / 32 % WN * TN; }
};

// Hopper's float64 tensor-core product at its full rate: mma.sync
// m16n8k8 f64 (sm_90).  tile_gemm.cuh's Mma<double> (m8n8k4, the shape
// the solver's kernels keep) issued at about 20 cycles a product on a
// sub-partition of the H100 in P3's first design, 2.6x below the 8 its
// 67 TFLOP/s imply (PERF.md).  The fragments are those of
// Mma<float>'s m16n8k8 with 64-bit elements (g = lane / 4, t = lane %
// 4): A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g), (t +
// 4, g); C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Rows of
// 4 mod 16 doubles keep each half-warp's loads on distinct banks.
struct MmaF64 {
  static constexpr int M = 16, N = 8, K = 8, NC = 4;
  static constexpr int PAD_A = 4, PAD_B = 4;
  struct AFrag {
    double v[4];
  };
  struct BFrag {
    double v[2];
  };
  __device__ static void load_a(AFrag& f, const double* s, int ld, int m0,
                                int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const double* p = s + (m0 + g) * ld + k0 + t;
    f.v[0] = p[0];
    f.v[1] = p[8 * ld];
    f.v[2] = p[4];
    f.v[3] = p[8 * ld + 4];
  }
  __device__ static void load_b(BFrag& f, const double* s, int ld, int k0,
                                int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const double* p = s + (k0 + t) * ld + n0 + g;
    f.v[0] = p[0];
    f.v[1] = p[4 * ld];
  }
  __device__ static void step(double (&c)[4], const AFrag& a,
                              const BFrag& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a.v[0]), "d"(a.v[1]), "d"(a.v[2]), "d"(a.v[3]), "d"(b.v[0]),
          "d"(b.v[1]));
  }
  __device__ static int row(int i) {
    return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
  }
  __device__ static int col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }
};

// The atom of a cluster product of type T: the full-rate DMMA for
// double, 3xTF32 (tile_gemm.cuh) for float.
template <typename T>
struct ClusterMma {
  using type = Mma<T>;
};
template <>
struct ClusterMma<double> {
  using type = MmaF64;
};

// A warp's tile of a cluster block product in type T (ClusterMma's
// atom), and the row strides that keep its fragment loads free of bank
// conflicts: LDA for a row strip (BR x 128, k along a row), LDB for a
// column strip (128 x BC).
template <typename T, int C>
struct ClusterAcc {
  using G = ClusterBlocks<C>;
  using Mt = typename ClusterMma<T>::type;
  static constexpr int MF = G::TM / Mt::M, NF = G::TN / Mt::N;
  static_assert(MF * Mt::M == G::TM && NF * Mt::N == G::TN,
                "whole atoms a warp tile");
  static constexpr int LDA = kProbeNb + Mt::PAD_A, LDB = G::BC + Mt::PAD_B;
  T v[MF][NF][Mt::NC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) v[m][n][i] = T(0);
  }
  // acc += A·B over k in [kb, ke) (multiples of 8) for this warp's tile:
  // A a row strip (BR rows, stride LDA, column = k), B a column strip
  // (row = k, stride LDB), both in this CTA's shared memory.
  __device__ __forceinline__ void product(const T* A, const T* B, int kb,
                                          int ke) {
    const int m0 = G::warp_row(), n0 = G::warp_col();
#pragma unroll 2
    for (int k = kb; k < ke; k += Mt::K) {
      typename Mt::AFrag fa[MF];
      typename Mt::BFrag fb[NF];
#pragma unroll
      for (int m = 0; m < MF; ++m) Mt::load_a(fa[m], A, LDA, m0 + m * Mt::M, k);
#pragma unroll
      for (int n = 0; n < NF; ++n) Mt::load_b(fb[n], B, LDB, k, n0 + n * Mt::N);
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int n = 0; n < NF; ++n) Mt::step(v[m][n], fa[m], fb[n]);
    }
  }
  // f(r, c, x, y) for each pair of accumulators: x at (r, c) of the
  // block, y at (r, c + 1); c is even.
  template <class F>
  __device__ __forceinline__ void pairs(F f) const {
    const int m0 = G::warp_row(), n0 = G::warp_col();
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int i = 0; i < Mt::NC; i += 2)
          f(m0 + m * Mt::M + Mt::row(i), n0 + n * Mt::N + Mt::col(i),
            v[m][n][i], v[m][n][i + 1]);
  }
};

template <typename T>
__device__ __forceinline__ void store_pair(T* p, T x, T y) {
  *reinterpret_cast<typename Pair<T>::V*>(p) = typename Pair<T>::V{x, y};
}

// One block to copy: BR rows of BC elements from src (row stride lds)
// to dst (ldd); src is a peer's shared memory (distributed shared
// memory, a generic address) or this CTA's.
template <typename T>
struct BlockCopy {
  const T* src;
  T* dst;
  int lds, ldd;
};

// The blocks at(0), ..., at(nblk - 1) (BlockCopy<T>) of the cluster
// grid G, in 16-byte pieces, batches of U a thread: all loads of a
// batch are issued before its stores, so that one round trip to the
// peers' shared memory serves a batch.
template <typename T, class G, class At>
__device__ __forceinline__ void copy_blocks(int nblk, At at) {
  constexpr int V = 16 / sizeof(T), CPR = G::BC / V;
  constexpr int PER = G::BR * CPR / kClusterThreads;  // pieces a block
  constexpr int U = 16;
  static_assert(PER * kClusterThreads == G::BR * CPR, "whole pieces");
  const int total = nblk * PER;
  for (int u0 = 0; u0 < total; u0 += U) {
    uint4 v[U];
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int u = u0 + uu;
      if (u < total) {
        const BlockCopy<T> bc = at(u / PER);
        const int e = threadIdx.x + u % PER * kClusterThreads;
        v[uu] = *reinterpret_cast<const uint4*>(
            bc.src + (size_t)(e / CPR) * bc.lds + e % CPR * V);
      }
    }
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int u = u0 + uu;
      if (u < total) {
        const BlockCopy<T> bc = at(u / PER);
        const int e = threadIdx.x + u % PER * kClusterThreads;
        *reinterpret_cast<uint4*>(bc.dst + (size_t)(e / CPR) * bc.ldd +
                                  e % CPR * V) = v[uu];
      }
    }
  }
}

// The launch of kern in clusters of c CTAs (c < 2: none; dynamic
// shared memory cfg's): opted in, and refused unless a cluster of this
// shape fits on the card.  A refusal is returned and the runtime's last
// error cleared, so that a later launch's check does not report it.
template <class K>
cudaError_t cluster_ready(K kern, const cudaLaunchConfig_t& cfg, int c) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (e == cudaSuccess && c > 8)  // above the portable cluster size
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = c > 1 ? 0 : 1;
  if (e == cudaSuccess && c > 1)
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e == cudaSuccess && clusters < 1) e = cudaErrorLaunchOutOfResources;
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// A launch configuration of `grid` CTAs of kClusterThreads in clusters
// of c along x (c = 1: no cluster attribute).
inline cudaLaunchConfig_t cluster_launch(dim3 grid, int c, size_t smem,
                                         cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (c > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = c;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// ------------------------------------------------------------------ P5

// The products' type of a probe launch: 0 float64 (DMMA), 1 float
// (3xTF32).
enum ProbeProducts { kProductsF64, kProductsTf32x3 };

// acc's columns a P5 product CTA owns (one atom wide: MmaF64::N,
// Mma<float>::N), and its product warps, one to an SM sub-partition.
constexpr int kStripCols = 8;
constexpr int kStripWarps = kGemmWarps;
constexpr int kStripThreads = 32 * kStripWarps;

template <int MODE>
__host__ __device__ constexpr int probe_threads() {
  return MODE == kProbeScan   ? 32 * kScanWarps
         : MODE == kProbeDots ? kStripThreads
                             : kStripThreads + 32 * kScanWarps;
}

// A P5 product CTA's shared memory (elements of P): all of a (k along a
// row) and acc's strip twice (by step parity); TM rows of the strip a
// warp.  Strip rows of 12 doubles put each half-warp's B fragment loads
// (t, g) on distinct bank pairs, rows of 8 floats each warp's on
// distinct banks (8t + g); a's rows take the atoms' PAD_A.
template <typename P>
struct StripLayout {
  using Mt = typename ClusterMma<P>::type;
  static constexpr int TM = kProbeNb / kStripWarps, MF = TM / Mt::M;
  static_assert(MF * Mt::M == TM && Mt::N == kStripCols, "whole atoms");
  static constexpr int LDA = kProbeNb + Mt::PAD_A;
  static constexpr int LDB = kStripCols + (sizeof(P) == 8 ? 4 : 0);
  static constexpr size_t kA = (size_t)kProbeNb * LDA;
  static constexpr size_t kB = (size_t)kProbeNb * LDB;
  static constexpr size_t kSmemBytes = (kA + 2 * kB) * sizeof(P);
};

// k's chunks of 8 whose A fragments each product warp holds in
// registers for the whole chain, read once from global memory; the
// others are read from shared memory every step, and those reads bound
// a step (PERF.md PR 14).  As many as the CTA's registers leave: 255 a
// thread in a block of 128 (dots), 168 in one of 384 (the scan's warps
// beside; 16 registers a chunk).
template <int MODE>
__host__ __device__ constexpr int strip_reg_chunks() {
  return MODE == kProbeDots ? 8 : 4;
}

// This warp's A fragments of chunks 0 ... RK - 1 (RK = 0: none, the
// first design, which tools/probe_overlap.py's regs0 times).
template <typename P, int RK>
struct StripRegs {
  typename StripLayout<P>::Mt::AFrag f[RK][StripLayout<P>::MF];
};
template <typename P>
struct StripRegs<P, 0> {};

// Element i of an A fragment: the value (float64), or its TF32 split
// (3xTF32).
__device__ __forceinline__ void frag_set(MmaF64::AFrag& f, int i, double x) {
  f.v[i] = x;
}
__device__ __forceinline__ void frag_set(Mma<float>::AFrag& f, int i,
                                         float x) {
  split_tf32(x, f.big[i], f.small[i]);
}

// This warp's fragments of a (n x n, zero outside) in chunks 0 ... RK - 1:
// element i of atom m at row m0 + 16 m + g + 8 (i % 2), column 8 q + t +
// 4 (i / 2), as Mt::load_a reads them.
template <typename P, int RK>
__device__ __forceinline__ void strip_regs_load(StripRegs<P, RK>& ar,
                                                const float* a, int n) {
  if constexpr (RK > 0) {
    using L = StripLayout<P>;
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int m0 = (threadIdx.x >> 5) * L::TM;
#pragma unroll
    for (int q = 0; q < RK; ++q)
#pragma unroll
      for (int m = 0; m < L::MF; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + m * 16 + g + 8 * (i & 1);
          const int c = 8 * q + t + 4 * (i >> 1);
          frag_set(ar.f[q][m], i,
                   r < n && c < n ? P(a[(size_t)r * n + c]) : P(0));
        }
  }
}

// nxt = a · cur on a strip: warp w forms rows [w TM, (w + 1) TM), MF
// atoms of 16 x 8 over k = 0 ... 127 in order, A's fragments from ar
// (chunks below RK) or from shared memory, B's from shared memory.
template <typename P, int RK>
__device__ __forceinline__ void strip_product(const StripRegs<P, RK>& ar,
                                              const P* As, const P* cur,
                                              P* nxt) {
  using L = StripLayout<P>;
  using Mt = typename L::Mt;
  const int m0 = (threadIdx.x >> 5) * L::TM;
  P v[L::MF][Mt::NC];
#pragma unroll
  for (int m = 0; m < L::MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; ++i) v[m][i] = P(0);
  if constexpr (RK > 0) {
#pragma unroll
    for (int q = 0; q < RK; ++q) {
      typename Mt::BFrag fb;
      Mt::load_b(fb, cur, L::LDB, q * Mt::K, 0);
#pragma unroll
      for (int m = 0; m < L::MF; ++m) Mt::step(v[m], ar.f[q][m], fb);
    }
  }
#pragma unroll 4
  for (int k = RK * Mt::K; k < kProbeNb; k += Mt::K) {
    typename Mt::AFrag fa[L::MF];
    typename Mt::BFrag fb;
#pragma unroll
    for (int m = 0; m < L::MF; ++m)
      Mt::load_a(fa[m], As, L::LDA, m0 + m * Mt::M, k);
    Mt::load_b(fb, cur, L::LDB, k, 0);
#pragma unroll
    for (int m = 0; m < L::MF; ++m) Mt::step(v[m], fa[m], fb);
  }
#pragma unroll
  for (int m = 0; m < L::MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; i += 2)
      store_pair(nxt + (m0 + m * Mt::M + Mt::row(i)) * L::LDB + Mt::col(i),
                 v[m][i], v[m][i + 1]);
}

// The product warps' barrier: the whole CTA where the scan's warps
// share it (CTA 0 of kProbeBoth and kProbeSplit), else named barrier 1
// of the product warps alone.
__device__ __forceinline__ void strip_sync(bool whole) {
  if (whole)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(kStripThreads) : "memory");
}

// P5, copy blockIdx.y, CTA blockIdx.x = j: strip j's products (unless
// kProbeScan) and, on CTA 0, the scan (unless kProbeDots).  With both:
// part, acc rounded to float (n x n a copy); done, a completion counter
// a copy, 0 before the launch and after it.
template <int MODE, typename P>
__global__ void __launch_bounds__(probe_threads<MODE>(), 1)
    overlap_kernel(const float* a, const float* b, float* out, float* part,
                   int* done, int n, int steps) {
  using L = StripLayout<P>;
  constexpr bool SCAN = MODE != kProbeDots, DOT = MODE != kProbeScan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int strips = (n + kStripCols - 1) / kStripCols;
  const size_t nn = (size_t)n * n;
  out += blockIdx.y * nn;
  const int j = blockIdx.x;                    // the strip of the products
  const bool scan_cta = SCAN && j == 0;        // the CTA of the scan
  const bool whole = SCAN && DOT && scan_cta;  // both on barrier 0
  if (SCAN && warp >= (DOT ? kStripWarps : 0)) {
    if (!scan_cta) return;
    const int sw = warp - (DOT ? kStripWarps : 0);
    ChainTile f;
#pragma unroll
    for (int i = 0; i < kChainRows; ++i)
#pragma unroll
      for (int c = 0; c < kChainCols; ++c) {
        const int r = sw + kScanWarps * i, cc = tx + 32 * c;
        f.v[i][c] = r < n && cc < n ? a[(size_t)r * n + cc] : 0.f;
      }
    scan_loop<MODE>(f, reinterpret_cast<float*>(smem_raw), n, steps, sw,
                    tx);
    __syncthreads();  // the products' last step is stored
#pragma unroll
    for (int i = 0; i < kChainRows; ++i)
#pragma unroll
      for (int c = 0; c < kChainCols; ++c) {
        const int r = sw + kScanWarps * i, cc = tx + 32 * c;
        if (r >= n || cc >= n) continue;
        const size_t e = (size_t)r * n + cc;
        out[e] = DOT ? f.v[i][c] : f.v[i][c] + b[e];
      }
    if (DOT) {
      __threadfence();
      __syncthreads();  // f is out before the products' arrival
    }
    return;
  }
  // the products of strip j: a and b's strip, in P, zero outside n x n
  P* As = reinterpret_cast<P*>(smem_raw +
                               (SCAN ? 2 * kProbeNb * sizeof(float) : 0));
  P* acc[2] = {As + L::kA, As + L::kA + L::kB};
  const int c0 = j * kStripCols;
  for (int e = threadIdx.x; e < kProbeNb * kProbeNb; e += kStripThreads) {
    const int r = e / kProbeNb, c = e % kProbeNb;
    As[r * L::LDA + c] = r < n && c < n ? P(a[(size_t)r * n + c]) : P(0);
  }
  for (int e = threadIdx.x; e < kProbeNb * kStripCols; e += kStripThreads) {
    const int r = e / kStripCols, c = c0 + e % kStripCols;
    acc[0][r * L::LDB + c - c0] =
        r < n && c < n ? P(b[(size_t)r * n + c]) : P(0);
  }
  StripRegs<P, strip_reg_chunks<MODE>()> ar;
  strip_regs_load(ar, a, n);
  for (int s = 0; s < steps; ++s) {
    strip_sync(whole);
    if (MODE == kProbeBoth && whole) strip_sync(whole);
    strip_product(ar, As, acc[s & 1], acc[(s + 1) & 1]);
  }
  strip_sync(whole);  // the last step is stored
  const P* fin = acc[steps & 1];
  float* dst = SCAN ? part + blockIdx.y * nn : out;
  for (int e = threadIdx.x; e < kProbeNb * kStripCols; e += kStripThreads) {
    const int r = e / kStripCols, c = c0 + e % kStripCols;
    if (r >= n || c >= n) continue;
    const size_t g = (size_t)r * n + c;
    const float v = float(fin[r * L::LDB + c - c0]);
    dst[g] = SCAN ? v : a[g] + v;
  }
  if (!SCAN) return;
  // the CTA that arrives last sums the copy: out = f + acc
  __threadfence();
  strip_sync(whole);  // in CTA 0 with the scan warps: f is out
  if (threadIdx.x == 0)
    last = atomicAdd(done + blockIdx.y, 1) == strips - 1;
  strip_sync(false);
  if (!last) return;
  __threadfence();
  const float* pt = part + blockIdx.y * nn;
  for (size_t e = threadIdx.x; e < nn; e += kStripThreads)
    out[e] = __ldcg(out + e) + __ldcg(pt + e);
  if (threadIdx.x == 0) done[blockIdx.y] = 0;
}

template <int MODE, typename P>
cudaError_t launch_overlap(const float* a, const float* b, float* out,
                           float* part, int* done, int copies, int n,
                           int steps, cudaStream_t st) {
  const int strips = (n + kStripCols - 1) / kStripCols;
  const size_t smem =
      (MODE == kProbeDots ? 0 : 2 * kProbeNb * sizeof(float)) +
      (MODE == kProbeScan ? 0 : StripLayout<P>::kSmemBytes);
  cudaError_t e = cudaFuncSetAttribute(
      overlap_kernel<MODE, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  overlap_kernel<MODE, P><<<dim3(MODE == kProbeScan ? 1 : strips, copies),
                            probe_threads<MODE>(), smem, st>>>(
      a, b, out, part, done, n, steps);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_overlap(int products, const float* a, const float* b,
                           float* out, float* part, int* done, int copies,
                           int n, int steps, cudaStream_t st) {
  switch (products) {
    case kProductsF64:
      return launch_overlap<MODE, double>(a, b, out, part, done, copies, n,
                                          steps, st);
    case kProductsTf32x3:
      return launch_overlap<MODE, float>(a, b, out, part, done, copies, n,
                                         steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// P5 in mode (ProbeMode) on `copies` copies, its products of type
// `products` (ProbeProducts; the scan mode has none and takes only
// kProductsF64).  Modes both and split: part holds an n x n float tile
// a copy, done `copies` counters that are 0 (and are 0 again after).
inline cudaError_t scan_overlap(int mode, int products, const float* a,
                                const float* b, float* out, float* part,
                                int* done, int copies, int n, int steps,
                                cudaStream_t st) {
  if (n < 1 || n > kProbeNb || steps < 0 || copies < 1 || copies > 65535)
    return cudaErrorInvalidValue;
  if ((mode == kProbeBoth || mode == kProbeSplit) && (!part || !done))
    return cudaErrorInvalidValue;
  switch (mode) {
    case kProbeScan:
      if (products != kProductsF64) return cudaErrorInvalidValue;
      return launch_overlap<kProbeScan, double>(a, b, out, part, done,
                                                copies, n, steps, st);
    case kProbeDots:
      return launch_overlap<kProbeDots>(products, a, b, out, part, done,
                                        copies, n, steps, st);
    case kProbeBoth:
      return launch_overlap<kProbeBoth>(products, a, b, out, part, done,
                                        copies, n, steps, st);
    case kProbeSplit:
      return launch_overlap<kProbeSplit>(products, a, b, out, part, done,
                                         copies, n, steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ P4

// A P4 product CTA's shared memory (elements of P): a's row strip i,
// the column strip j of acc copied from its owners, and acc's own block
// (i, j) twice, in the column strip's row stride.
template <typename P, int C>
struct ScanProducts {
  using A = ClusterAcc<P, C>;
  using G = ClusterBlocks<C>;
  static constexpr size_t kA = (size_t)G::BR * A::LDA;
  static constexpr size_t kS = (size_t)kProbeNb * A::LDB;
  static constexpr size_t kB = (size_t)G::BR * A::LDB;
  static constexpr size_t kSmemBytes = (kA + kS + 2 * kB) * sizeof(P);
};

// P4's chain of products on this CTA's cluster: acc <- a · acc, `steps`
// times from acc = b, in P; this CTA's block of the result, rounded
// once to float, to part (n x n, rows and columns below n only).
template <int C, typename P>
__device__ __forceinline__ void scan_products(const float* a, const float* b,
                                              float* part, int n, int steps,
                                              unsigned char* smem) {
  using G = ClusterBlocks<C>;
  using A = ClusterAcc<P, C>;
  using L = ScanProducts<P, C>;
  namespace cgr = cooperative_groups;
  P* As = reinterpret_cast<P*>(smem);
  P* Sb = As + L::kA;
  P* own[2] = {Sb + L::kS, Sb + L::kS + L::kB};
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j = rank % G::PC, r0 = rank / G::PC * G::BR, c0 = j * G::BC;
  // a's rows r0.. and b's block, in P, zero outside n x n
  for (int e = threadIdx.x; e < G::BR * kProbeNb; e += kClusterThreads) {
    const int r = e / kProbeNb, c = e % kProbeNb, gr = r0 + r;
    As[r * A::LDA + c] = gr < n && c < n ? P(a[(size_t)gr * n + c]) : P(0);
  }
  for (int e = threadIdx.x; e < G::BR * G::BC; e += kClusterThreads) {
    const int r = e / G::BC, c = e % G::BC, gr = r0 + r, gc = c0 + c;
    own[0][r * A::LDB + c] =
        gr < n && gc < n ? P(b[(size_t)gr * n + gc]) : P(0);
  }
  cluster_sync_all();
  for (int s = 0; s < steps; ++s) {
    P* cur = own[s & 1];
    // acc's column strip j from its owners (this CTA's own block too)
    copy_blocks<P, G>(G::PR, [&](int ib) {
      return BlockCopy<P>{cluster.map_shared_rank(cur, ib * G::PC + j),
                          Sb + ib * G::BR * A::LDB, A::LDB, A::LDB};
    });
    __syncthreads();
    A acc;
    acc.zero();
    acc.product(As, Sb, 0, kProbeNb);
    P* nxt = own[(s + 1) & 1];
    acc.pairs([&](int r, int c, P x, P y) {
      store_pair(nxt + r * A::LDB + c, x, y);
    });
    cluster_sync_all();  // the block is stored; every read of cur is done
  }
  const P* fin = own[steps & 1];
  for (int e = threadIdx.x; e < G::BR * G::BC; e += kClusterThreads) {
    const int r = e / G::BC, c = e % G::BC, gr = r0 + r, gc = c0 + c;
    if (gr < n && gc < n)
      part[(size_t)gr * n + gc] = float(fin[r * A::LDB + c]);
  }
}

// P4's chain i = a + i through `steps` scan steps in this CTA's
// registers, to part (n x n).  bcast: 2 row buffers.
__device__ __forceinline__ void scan_chain(const float* a, float* part,
                                           float* bcast, int i, int n,
                                           int steps) {
  const int sw = threadIdx.x >> 5, tx = threadIdx.x & 31;
  ChainTile f;
#pragma unroll
  for (int ia = 0; ia < kChainRows; ++ia)
#pragma unroll
    for (int b = 0; b < kChainCols; ++b) {
      const int r = sw + kScanWarps * ia, c = tx + 32 * b;
      f.v[ia][b] = r < n && c < n ? a[(size_t)r * n + c] + float(i) : 0.f;
    }
  scan_loop<kProbeScan>(f, bcast, n, steps, sw, tx);
#pragma unroll
  for (int ia = 0; ia < kChainRows; ++ia)
#pragma unroll
    for (int b = 0; b < kChainCols; ++b) {
      const int r = sw + kScanWarps * ia, c = tx + 32 * b;
      if (r < n && c < n) part[(size_t)r * n + c] = f.v[ia][b];
    }
}

// P4, copy blockIdx.y: CTAs x < C (C > 0) the products' cluster, CTA C
// + i chain i < q.  work: q + 1 parts of n x n a copy (the chains, then
// acc); done: a completion counter a copy, 0 before the launch and
// after it.
template <int C, typename P>
__global__ void __launch_bounds__(kClusterThreads, 1)
    scan_multi_kernel(const float* a, const float* b, float* out,
                      float* work, int* done, int q, int n, int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const size_t nn = (size_t)n * n;
  float* parts = work + blockIdx.y * (q + 1) * nn;
  bool chain = true;
  if constexpr (C > 0) {
    if ((int)blockIdx.x < C) {
      scan_products<C, P>(a, b, parts + q * nn, n, steps, smem_raw);
      chain = false;
    }
  }
  if (chain) {
    const int i = blockIdx.x - C;
    if (i >= q) return;  // a spare CTA of the chains' last cluster
    scan_chain(a, parts + i * nn, reinterpret_cast<float*>(smem_raw), i, n,
               steps);
  }
  // the last CTA of the copy sums the parts, in the plain twin's order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + blockIdx.y, 1) == q + C - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  out += blockIdx.y * nn;
  for (size_t e = threadIdx.x; e < nn; e += kClusterThreads) {
    float v = __ldcg(parts + e);
    for (int i = 1; i < q; ++i) v = v + __ldcg(parts + i * nn + e);
    out[e] = v + (C > 0 ? __ldcg(parts + q * nn + e) : b[e]);
  }
  if (threadIdx.x == 0) done[blockIdx.y] = 0;
}

template <int C, typename P>
cudaError_t launch_scan_multi(const float* a, const float* b, float* out,
                              float* work, int* done, int q, int copies,
                              int n, int steps, cudaStream_t st) {
  size_t smem = 2 * kProbeNb * sizeof(float);  // a chain's row buffers
  int ctas = q;
  if constexpr (C > 0) {
    const size_t prod = ScanProducts<P, C>::kSmemBytes;
    smem = prod > smem ? prod : smem;
    ctas = C + (q + C - 1) / C * C;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_launch(dim3(ctas, copies), C, smem, st, &attr);
  cudaError_t e = cluster_ready(scan_multi_kernel<C, P>, cfg, C);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, scan_multi_kernel<C, P>, a, b, out, work,
                         done, q, n, steps);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

// P4 with q chains on `copies` copies, products as for scan_overlap on a
// cluster of `cluster` CTAs (4, 8, 16; unused without them); work: q +
// 1 tiles of n x n a copy; done: `copies` counters, 0.
inline cudaError_t scan_multi(int q, bool with_dot, int products,
                              int cluster, const float* a, const float* b,
                              float* out, float* work, int* done, int copies,
                              int n, int steps, cudaStream_t st) {
  if (q < 1 || n < 1 || n > kProbeNb || steps < 0 || copies < 1 ||
      copies > 65535)
    return cudaErrorInvalidValue;
  if (!with_dot)
    return products == kProductsF64
               ? launch_scan_multi<0, float>(a, b, out, work, done, q, copies,
                                             n, steps, st)
               : cudaErrorInvalidValue;
#define PLU_SCAN_PRODUCTS(CL)                                               \
  case CL:                                                                  \
    return products == kProductsF64                                         \
               ? launch_scan_multi<CL, double>(a, b, out, work, done, q,    \
                                               copies, n, steps, st)        \
               : launch_scan_multi<CL, float>(a, b, out, work, done, q,     \
                                              copies, n, steps, st);
  if (products != kProductsF64 && products != kProductsTf32x3)
    return cudaErrorInvalidValue;
  switch (cluster) {
    PLU_SCAN_PRODUCTS(4)
    PLU_SCAN_PRODUCTS(8)
    PLU_SCAN_PRODUCTS(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef PLU_SCAN_PRODUCTS
}

// ------------------------------------------------------------------ P3

// A P3 CTA's shared memory (doubles): L's row strip i and X's row strip
// i (the A operands of L·X and X·Y), the column strip j (the B operand:
// X's, then Y's), and the member's flag.
template <int C>
struct NewtonCluster {
  using A = ClusterAcc<double, C>;
  static constexpr size_t kA = (size_t)ClusterBlocks<C>::BR * A::LDA;
  static constexpr size_t kS = (size_t)kProbeNb * A::LDB;
  static constexpr size_t kSmemBytes = (2 * kA + kS) * sizeof(double) + 16;
};

// A warp's tiles of a P3 block product (MmaF64).  The block's 32 rows
// are the 16-row groups i (local rows 0-15) and 7 - i (16-31), its BC
// columns 4 NT tiles of TN a group, and warp w takes NT tiles of one
// group.  With lower triangles a tile's k runs from its first column to
// its group's last row, so tile t of a group costs its length less 16 t
// (C = 4; 8 t at C = 8): with NT = 2, warps 0-3 take the pairs (p, 7 -
// p) of group 7 - i and warps 4-7 the pairs (3 - p, 4 + p) of group i,
// p = w % 4 the SM sub-partition warp w issues on, so that each
// sub-partition's pairs cost alike.  At C = 16 (BC = 32, tiles of 8
// columns, NT = 1) sub-partition p takes column tile p / 2 of one group
// with warp p and column tile 3 - p / 2 of the other with warp p + 4.
template <int C>
struct NewtonTiles {
  using G = ClusterBlocks<C>;
  using Mt = MmaF64;
  static constexpr int NT = G::BC >= 64 ? 2 : 1;
  static constexpr int TN = G::BC / (4 * NT), NF = TN / Mt::N;
  static_assert(NF * Mt::N == TN, "whole atoms a tile");
  static constexpr int LDA = ClusterAcc<double, C>::LDA;
  static constexpr int LDB = ClusterAcc<double, C>::LDB;
  double v[NT][NF][Mt::NC];
  int m0, n0[NT], kb[NT], ke[NT];
  // this warp's tiles; kb[u], ke[u] from kb0 to each tile's last row
  // (lower triangles) or all of k
  __device__ __forceinline__ void init(int i, int c0, bool general) {
    const int w = threadIdx.x / 32, p = w % 4;
    if (NT == 2) {
      m0 = w < 4 ? 16 : 0;
      n0[0] = (w < 4 ? p : 3 - p) * TN;
      n0[NT - 1] = (w < 4 ? 7 - p : 4 + p) * TN;
    } else {
      m0 = (w + w / 4) % 2 * 16;
      n0[0] = (w < 4 ? p / 2 : 3 - p / 2) * TN;
    }
    const int last = (m0 == 0 ? 16 * i : 16 * (7 - i)) + 16;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      kb[u] = general ? 0 : c0 + n0[u];
      ke[u] = general ? kProbeNb : last;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < Mt::NC; ++e) v[u][n][e] = 0.0;
  }
  // v += A·B over each tile's k: A the 32 rows (stride LDA, column =
  // k), B the column strip (row = k, stride LDB).
  __device__ __forceinline__ void product(const double* A, const double* B) {
    int k0 = kProbeNb, k1 = 0;
#pragma unroll
    for (int u = 0; u < NT; ++u)
      if (kb[u] < ke[u]) {
        k0 = min(k0, kb[u]);
        k1 = max(k1, ke[u]);
      }
#pragma unroll 2
    for (int k = k0; k < k1; k += Mt::K) {
      typename Mt::AFrag fa;
      Mt::load_a(fa, A, LDA, m0, k);
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        if (k < kb[u] || k >= ke[u]) continue;
        typename Mt::BFrag fb[NF];
#pragma unroll
        for (int n = 0; n < NF; ++n)
          Mt::load_b(fb[n], B, LDB, k, n0[u] + n * Mt::N);
#pragma unroll
        for (int n = 0; n < NF; ++n) Mt::step(v[u][n], fa, fb[n]);
      }
    }
  }
  // f(r, c, x, y) for each pair: x at local (r, c), y at (r, c + 1)
  template <class F>
  __device__ __forceinline__ void pairs(F f) const {
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < Mt::NC; e += 2)
          f(m0 + Mt::row(e), n0[u] + n * Mt::N + Mt::col(e), v[u][n][e],
            v[u][n][e + 1]);
  }
};

// Rows [r0, r1) x columns [c0, c1) (even) of the 128 x 128 float64
// matrix m in global memory (L2) into dst (row stride ldd) at (r - dr,
// c - dc), by cp.async in 16-byte pieces that skip L1 (peers wrote m
// before the last cluster barrier).  With tri, m is lower triangular: a
// piece above the diagonal is zero-filled without a read.  (Skipping
// the pieces no product reads, a test a piece, measured slower.)
__device__ __forceinline__ void stage_from_l2(double* dst, int ldd, int dr,
                                              int dc, const double* m,
                                              int r0, int r1, int c0, int c1,
                                              bool tri) {
  const int w = (c1 - c0) / 2;  // pieces a row
  const int total = (r1 - r0) * w;
  for (int e = threadIdx.x; e < total; e += kClusterThreads) {
    const int r = r0 + e / w, c = c0 + 2 * (e % w);
    cp_async<16>(dst + (r - dr) * ldd + (c - dc), m + r * kProbeNb + c,
                 !tri || c <= r);
  }
}

// P3: cluster blockIdx.y takes member blockIdx.y of lm (G x nb x nb, nb
// <= 128) and writes X after `steps` steps to out; S the members' type,
// the products in double.  ws: 3 float64 128 x 128 matrices a member
// in global memory (X by step parity, Y), through which the CTAs pass
// their blocks.  The note at the top gives the design.
template <typename S, int C>
__global__ void __launch_bounds__(kClusterThreads, 1)
    newton_loop_kernel(const S* lm, S* out, double* ws, int nb, int steps) {
  using G = ClusterBlocks<C>;
  using A = ClusterAcc<double, C>;
  using L = NewtonCluster<C>;
  namespace cgr = cooperative_groups;
  constexpr int N = kProbeNb;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* Ls = reinterpret_cast<double*>(smem_raw);
  double* Xa = Ls + L::kA;
  double* Sb = Ls + 2 * L::kA;
  int* flag = reinterpret_cast<int*>(Sb + L::kS);
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int i = rank / G::PC, c0 = rank % G::PC * G::BC;
  // this CTA's rows: groups i and 7 - i of 16 (local rows 0-15 and 16-31)
  auto grow = [&](int r) {
    return r < 16 ? 16 * i + r : 16 * (7 - i) + r - 16;
  };
  const size_t nn = (size_t)nb * nb;
  lm += blockIdx.y * nn;
  out += blockIdx.y * nn;
  ws += (size_t)blockIdx.y * 3 * N * N;
  double* wx[2] = {ws, ws + N * N};
  double* wy = ws + 2 * N * N;
  // L's rows, padded with the identity, and whether they hold an entry
  // above the diagonal
  bool upper = false;
  for (int e = threadIdx.x; e < G::BR * N; e += kClusterThreads) {
    const int r = e / N, c = e % N, gr = grow(r);
    const double v = gr < nb && c < nb ? double(lm[(size_t)gr * nb + c])
                     : gr == c         ? 1.0
                                       : 0.0;
    Ls[r * A::LDA + c] = v;
    upper = upper || (c > gr && v != 0.0);
  }
  upper = __syncthreads_or(upper);
  if (threadIdx.x == 0) *flag = upper;
  // X = 2I - L, this CTA's block, to the workspace
  for (int e = threadIdx.x; e < G::BR * G::BC; e += kClusterThreads) {
    const int r = e / G::BC, c = c0 + e % G::BC, gr = grow(r);
    wx[0][gr * N + c] = (gr == c ? 2.0 : 0.0) - Ls[r * A::LDA + c];
  }
  cluster_sync_all();
  const bool general = __syncthreads_or(
      (int)threadIdx.x < C && *cluster.map_shared_rank(flag, threadIdx.x));
  const bool tri = !general;
  // The k a product sums: all of them for a general member; for lower
  // triangles those from the first column to the last row, of this
  // CTA's block (kb, ke) and of each of this warp's tiles (acc.kb,
  // acc.ke; NewtonTiles).
  const int kb = general ? 0 : c0;
  const int ke = general ? N : 16 * max(i, 7 - i) + 16;
  const bool any = kb < ke;
  NewtonTiles<C> acc;
  acc.init(i, c0, general);
  for (int s = 0; s < steps; ++s) {
    const double* x = wx[s & 1];
    // X's column strip j (the B operand of L·X), then X's rows (the A
    // operand of X·Y, which land while L·X runs)
    if (any) {
      stage_from_l2(Sb, A::LDB, 0, c0, x, kb, ke, c0, c0 + G::BC, tri);
      cp_async_commit();
      for (int h = 0; h < 2; ++h) {
        const int g0 = grow(16 * h);
        stage_from_l2(Xa, A::LDA, g0 - 16 * h, 0, x, g0, g0 + 16, kb, ke,
                      tri);
      }
    }
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    acc.zero();
    acc.product(Ls, Sb);
    acc.pairs([&](int r, int c, double u, double v) {
      const int gr = grow(r), d = gr - (c0 + c);  // the diagonal at d = 0
      store_pair(wy + gr * N + c0 + c, (d == 0 ? 2.0 : 0.0) - u,
                 (d == 1 ? 2.0 : 0.0) - v);
    });
    cluster_sync_all();  // Y is whole; every read of the strip is done
    // Y's column strip j (the B operand of X·Y)
    if (any)
      stage_from_l2(Sb, A::LDB, 0, c0, wy, kb, ke, c0, c0 + G::BC, tri);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    acc.zero();
    acc.product(Xa, Sb);
    double* xn = wx[(s + 1) & 1];
    acc.pairs([&](int r, int c, double u, double v) {
      store_pair(xn + grow(r) * N + c0 + c, u, v);
    });
    cluster_sync_all();  // X' is whole; every read of X and Y is done
  }
  if (steps == 0) {
    // X = 2I - L; peers may still read this CTA's flag
    for (int e = threadIdx.x; e < G::BR * G::BC; e += kClusterThreads) {
      const int r = e / G::BC, gr = grow(r), gc = c0 + e % G::BC;
      if (gr < nb && gc < nb)
        out[(size_t)gr * nb + gc] =
            S((gr == gc ? 2.0 : 0.0) - Ls[r * A::LDA + gc]);
    }
    cluster_sync_all();
    return;
  }
  // the last product's block, rounded once to S
  acc.pairs([&](int r, int c, double u, double v) {
    const int gr = grow(r), gc = c0 + c;
    if (gr >= nb) return;
    if (gc < nb) out[(size_t)gr * nb + gc] = S(u);
    if (gc + 1 < nb) out[(size_t)gr * nb + gc + 1] = S(v);
  });
}

template <typename S, int C>
cudaError_t launch_newton_loop(const S* lm, S* out, double* ws, int g,
                               int nb, int steps, cudaStream_t st) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(
      dim3(C, g), C, NewtonCluster<C>::kSmemBytes, st, &attr);
  cudaError_t e = cluster_ready(newton_loop_kernel<S, C>, cfg, C);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, newton_loop_kernel<S, C>, lm, out, ws, nb,
                         steps);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

// P3 of g members of nb <= 128 on clusters of `cluster` CTAs (4, 8,
// 16), one a member; ws: 3 float64 128 x 128 matrices a member.
template <typename S>
cudaError_t newton_loop(const S* lm, S* out, double* ws, int g, int nb,
                        int steps, int cluster, cudaStream_t st) {
  if (g == 0) return cudaSuccess;
  if (g < 0 || g > 65535 || nb < 1 || nb > kProbeNb || steps < 0)
    return cudaErrorInvalidValue;
  switch (cluster) {
    case 4:
      return launch_newton_loop<S, 4>(lm, out, ws, g, nb, steps, st);
    case 8:
      return launch_newton_loop<S, 8>(lm, out, ws, g, nb, steps, st);
    case 16:
      return launch_newton_loop<S, 16>(lm, out, ws, g, nb, steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ``iters`` cluster barriers on one cluster of c CTAs of kClusterThreads:
// the floor of a dependent step of P4's and P3's kernels; on no path.
__global__ void __launch_bounds__(kClusterThreads)
    cluster_sync_probe_kernel(int iters) {
  for (int i = 0; i < iters; ++i) cluster_sync_all();
}

inline cudaError_t cluster_sync_probe(int c, int iters, cudaStream_t st) {
  if (c < 2 || c > 16 || iters < 0) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch(dim3(c), c, 0, st, &attr);
  cudaError_t e = cluster_ready(cluster_sync_probe_kernel, cfg, c);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, cluster_sync_probe_kernel, iters);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace plu
