// Hand-written Hopper kernels of the main path: init -> gstrf -> gstrs
// on the dense tile store.  Built with nvcc for sm_90a into a shared
// library with a plain C interface (pangulu_tpu_torch/ops/build.py) and
// called through ctypes (pangulu_tpu_torch/ops/kernels_cuda.py).
//
// Every entry runs on the caller's stream, allocates nothing, never
// synchronises, and returns the first CUDA error (cudaGetLastError after
// each launch), 0 on success.  Tiles are row-major nb x nb, nb <= 256,
// except K1's, which takes wider tiles (wide_lu.cuh: one thread block
// cluster launch up to nb = 512, a recursion on such launches above),
// and the compressed store's P6 and P2 (compressed.cuh), which take any
// nb their caller's checks allow.
//
// K1 getrf_with_inverses
//   Replaces pangulu_tpu/ops/kernels_pallas.py getrf_with_inverses
//   (_getrf_inv_kernel -> _lu_inverses).  One block per tile of the
//   batch; the per-tile body is plu::lu_inverses_tile (tile_lu.cuh),
//   whose note gives the bound and the design: the tile in registers,
//   one barrier per elimination step.  Instances by the register tile
//   a thread holds (nb <= 32, 64, 128).
//   For 128 < nb <= 256 a tile (256 KiB of f32 at 256, 512 KiB of f64)
//   fits neither one block's registers nor its 227 KB of shared memory.
//   It goes to a thread block cluster instead (lu_cluster_kernel, one
//   launch a batch): 2 CTAs a tile in float, 4 in double, each holding
//   128 or 64 rows of the tile, padded to 256 x 256 with the identity,
//   in shared memory.  The blocking is the TPU kernel's MXU mode
//   (_lu_blocked, r = 32, kernels_pallas.py:261-300): per panel of 32
//   columns one warp factors the diagonal block and inverts its
//   triangles (diag_panel), then L21 = A21·U11^-1, U12 = L11^-1·A12 and
//   A22 -= L21·U12 as 32-deep tensor-core products (tile_gemm.cuh's
//   atoms: 3xTF32 for float, DMMA for double).  Both inverses form in
//   the same launch by the blocked Gauss–Jordan that K1's body runs one
//   column at a time: the rows below the panel carry L^-1's columns
//   left of it, the columns right of it U^-1's rows above it, so one
//   product per panel updates the trailing block and both inverses.
//   The panel's rows go from their owner to the other CTAs through L2,
//   with one cluster barrier a panel.
//   Bound: by bytes 3.1e-04 ms (f32), by operations less (PERF.md §6);
//   in fact the chain of 8 panels, each the diagonal warp's 32 dependent
//   steps, then a cluster barrier, the copy of the panel's rows and three
//   32-deep product stages with a few block barriers, in place of the
//   512 block barriers of the two 128-step chains of the blocked step it
//   replaced.  On an H100 (clock64 probes, PERF.md findings) a panel
//   takes ~30K cycles in f32: the diagonal warp ~10K (f64 ~18K), the
//   products and copies the rest; without the diagonal warp the kernel
//   would run at lu_factor_ex's time.  Three designs of the diagonal
//   warp measured slower: its two sweeps unrolled (their ~10^4
//   instructions, run once a panel, were bound by their fetch), a
//   backward Gauss–Jordan sweep for U11^-1 (32 more dependent steps),
//   and a diagonal warp of its own with lookahead (a block of 288
//   threads caps registers at 168).  A batch of 132 tiles in f64 runs
//   in 4 waves of one CTA an SM.
//   Above nb = 256 (to 512) a tile goes to one cluster of ceil(nb / 32)
//   CTAs of 32 rows each, the same panel step with the warps over
//   columns and lookahead on the diagonal chain (wide_lu.cuh, whose
//   note gives its design); wider tiles recurse on such launches.

// K2 mega_factorize
//   Replaces pangulu_tpu/ops/kernels_pallas.py mega_factorize
//   (_mega_kernel): the whole numeric factorization.
//   Bound on an H100: the dependent level chain.  Per level the work is
//   one tile LU (latency-bound, above), nl + nu panel products and nup
//   Schur products of nb^3 FMA each (the bench problem has at most 14
//   panel tiles and 49 updates a level, 6,958 updates in all), so a
//   level fills at most a fraction of the 132 SMs and the run is bound
//   by per-level latency: the diagonal step, then each product stage's
//   block latency.  By operations alone the whole run is 0.52 ms at the
//   67 TFLOP/s f32 peak and 0.21 ms at 3xTF32 (495 / 3 TFLOP/s).
//   Design: the TPU kernel ran everything in one launch because its
//   grid is sequential and it hand-scheduled DMAs; here each level is
//   three stream-ordered launches (the diagonal step, which is K1's
//   kernel on one tile in place, then panels, then Schur; above nb =
//   128 the diagonal step is K1's cluster launch) read from
//   device-resident tables, driven by one host loop over host copies
//   of the per-level counts, with no host synchronisation and no
//   device-to-host read.  Stream order is the level barrier.  The
//   products run on tensor cores (tile_gemm.cuh: 3xTF32 for float,
//   DMMA for double).  A panel tile is nb / 32 blocks, one per row
//   band (L·U^-1) or column band (L^-1·U), so that a level's panels
//   fill more SMs and each block's k loop is a quarter as long; a band
//   spans the tile (128 wide up to nb = 128, 256 wide above).  Schur
//   destinations are unique within a level, so each update is one
//   block per 64 x 64 quadrant with no atomics; the TPU's (u-chunk,
//   l-chunk, l) sort was for VMEM reuse and changes no result here.
//   The TPU kernel's super-level variant (flag_tab, lev_tab: the levels
//   in dependency-depth order, the next same-depth level's diagonal LU
//   run ahead inside the current level's work) is the chain-ahead of
//   mega_levels: that diagonal step goes to a second stream, ordered by
//   events, beside the current level's launches (PANGULU_TPU_SUPERLEVEL
//   = 1, float32).  One persistent cooperative launch (or a CUDA graph
//   of this loop) is the follow-up.
//
// K3 mega_solve
//   Replaces pangulu_tpu/ops/kernels_pallas.py mega_solve
//   (_mega_solve_kernel): forward then backward block solve against the
//   triangle inverses that K2 persisted.
//   Bound on an H100: again the level chain, 2 * bl dependent steps of
//   tiny work (one nb x nb matrix-vector product per RHS, plus a panel
//   of them); the bytes are each tile read once (about 190 MiB of f32
//   for the bench problem, ~60 us at full bandwidth).
//   Design: one cooperative persistent launch per sweep
//   (solve_sweep_kernel), 2 per solve, in place of two launches per
//   level.  The kernel walks the levels with one grid barrier each
//   (cooperative_groups grid.sync); the grid is the widest level's
//   (panel tile, RHS) item count, capped at the blocks that fit on the
//   card, and blocks take items in a grid-stride loop.  Every block
//   with items at level k recomputes inv_k · x_k into its own shared
//   memory (the inverse is one tile, read from L2) instead of waiting
//   on a second barrier for one block to publish it; the contraction
//   goes to a second buffer, so no block overwrites the x_k that
//   another still reads.  The panel's rows are distinct, so its tiles
//   update x without atomics.  Each product is warp-per-row so that
//   tile reads are coalesced, with a warp's rows summed together so
//   that all their loads are in flight at once.  One grid barrier
//   measured 1.1 us on the H100 (PERF.md), so per-segment ready flags
//   (the reference's synchronisation-free SpTRSV) would not pay: per
//   level the two dependent tile products cost more than the barrier.
//   That is the design up to nb = 128.  Above, one block a level
//   streamed a 256-row inverse and tile through one SM (~24 us a
//   level), so the sweep runs on thread block clusters instead, each
//   CTA a slice of every matrix's rows (solve_clusters.cuh, whose note
//   gives the design).
//
// K4 mega_factorize_groups
//   Replaces pangulu_tpu/ops/kernels_pallas.py mega_factorize_groups
//   (_group_kernel): the whole factorization, one super-level group of
//   G independent same-depth columns per step (nested-dissection
//   schedules: poisson3d(32) nb=128 nd packs 256 levels into 90 groups
//   of at most 5 members).
//   Bound on an H100: as for K2, the dependent chain, now of groups;
//   per group one batched diagonal step (G blocks of K1's body), then
//   the members' panel products and the group's Schur products (up to
//   450 in one group there).  By operations alone: 1.36 ms at 67
//   TFLOP/s f32, 0.55 ms at 3xTF32.
//   Design: per group three stream-ordered launches from one host loop
//   over host copies of the counts, as K2: K1's kernel with one block per
//   member (above nb = 128 one cluster per member; tile ids from
//   gdiag, inverse slots from glev, so
//   invs stays indexed by level), the panels (each tile times ITS
//   member's inverse, nb / 32 bands a tile as in K2; the member is found
//   from the panel offsets), and the Schur step.  Products on tensor cores
//   as in K2.  Within a group several members' updates may hit one
//   destination (separator tiles; up to 5 there), which the TPU kernel
//   handled with VMEM slots and load/write bits.  Here a host-built view
//   of the same tables (schedule.group_dst_csr) lists each distinct
//   destination with its updates, and one block per (destination, 64 x 64
//   quadrant) sums its products in its MMA accumulators and subtracts
//   once: no atomics, the same sum order on every run, each destination
//   read and written once.  Only l = udl & 0xFFFFF and u = udu & 0xFFF are
//   read from the packed words; the rest is the TPU's buffer management.
//
// K5 mega_solve_groups
//   Replaces pangulu_tpu/ops/kernels_pallas.py mega_solve_groups
//   (_mega_solve_groups_kernel): forward then backward block solve over
//   the groups of group_solve_tables.
//   Bound on an H100: by bytes, each panel tile and inverse read once
//   (4,220 tiles and 512 inverses of f32 for poisson3d(32) nb=128 nd,
//   296 MiB, 0.093 ms at 3.35 TB/s); by latency, the chain of dependent
//   matrix-vector steps, one a super-level and sweep (2 * 25 there),
//   each a grid barrier (1.1 us measured) plus the loads around it.
//   Design: one cooperative persistent launch per sweep
//   (group_sweep_kernel), 2 per solve, walking a host-built step list
//   (schedule.group_solve_steps) with one grid barrier between steps.
//   Consecutive groups that do not depend on each other (the gmax-wide
//   chunks of one super-level) form one bundle, and step p joins bundle
//   p-1's row updates with bundle p's member contractions: a row that
//   is also a member is one item (subtract the row's panel products,
//   then the inverse).  So a sweep is one barrier a super-level (25
//   steps there, not 2 * 35), with no inverse product done twice.
//   Rows of x are shared by several members' tiles (up to 8 in the
//   forward sweep there): an item sums all of them in registers and
//   subtracts once; the inverse product goes to a second buffer (x ->
//   y forward, y -> x backward), so within a step every item owns its
//   segment and reads only what earlier steps wrote: no atomics,
//   bit-identical runs, and the scratch segment is never written.
//   Tiles and inverses are read-only, so before each barrier the grid
//   asks L2 for the next step's (a bulk prefetch each); only x waits.
//   The kernel takes no dynamic shared memory (the shared v is one
//   segment), so no row is too long for it.  One block per item
//   (1024 threads, one block an SM at the 64-register cap).  Measured
//   on the H100 and not kept (PERF.md, tools/probe_solve_groups.py):
//   two steps a group (members, then rows); staging a block's next
//   item (inverse and first tiles) in shared memory with cp.async
//   before the barrier; warming its L1 with the next item; reading an
//   item's entry rows into shared memory at once; loading the next
//   step's descriptors while a step runs, into registers or by cp.async
//   into shared memory.  Each early load added registers at the cap,
//   and the spills cost more than the latency it hid.  Above nb = 128
//   an item's rows go over a thread block cluster instead
//   (solve_clusters.cuh).
//
// P6 decompress_tiles / compress_tiles and P2 newton_inverses
//   The compressed tile store's kernels, in compressed.cuh (its note
//   gives their bounds and designs).
//
// P5 scan_overlap, P4 scan_multi and P3 newton_loop
//   The TPU compiler probes, on no path of the solver, in probes.cuh
//   (its note gives their questions, bounds and designs).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "compressed.cuh"
#include "probes.cuh"
#include "tile_gemm.cuh"
#include "tile_lu.cuh"

namespace plu {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------- K1
// Block b factors the n x n diagonal block at (off, off) of tile t =
// (ids ? ids[b] : b) of ``a`` (nb x nb tiles, n <= 128) into the same
// place of ``f`` (which may be ``a``: in place) and writes its inverses
// to the same block of linv/uinv + i * inv_stride, i = (inv_ids ?
// inv_ids[b] : b).  Every caller passes the whole tile (off = 0, n =
// nb <= 128); with off and n as arguments the kernel compiles to the
// instructions it had when an earlier blocked step factored diagonal
// blocks with it, which ran ~1.6% faster on an H100 than with n = nb
// folded in (chip_smoke.py's K1 timing, PERF.md).  The batched entry
// calls it with both tables nullptr; K2's diagonal step with one block,
// ids = &diag_tab[k] and the level's slots of ``invs``; K4's with one
// block per member, ids = the group's diagonal tiles and inv_ids = their
// levels (slots of ``invs`` 2 * nb * nb apart).  CB = lu_cb(n) sizes
// the register tile (lu_kernel_for picks it).
template <typename T, int CB>
__global__ void __launch_bounds__(kLuThreads, 1)
    getrf_inv_kernel(const T* a, T* f, T* linv, T* uinv, size_t inv_stride,
                     const int* ids, const int* inv_ids, int nb, int off,
                     int n, T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sF = reinterpret_cast<T*>(smem_raw);
  const size_t d = (size_t)off * (nb + 1);  // the block's first element
  const size_t t =
      (size_t)(ids ? ids[blockIdx.x] : blockIdx.x) * nb * nb + d;
  const size_t slot =
      (size_t)(inv_ids ? inv_ids[blockIdx.x] : blockIdx.x) * inv_stride + d;
  lu_inverses_tile<T, CB>(a + t, f + t, linv + slot, uinv + slot, n, nb,
                          tol, sF, sF + 32 * CB * kLuVec);
}

template <typename T>
using LuKernel = void (*)(const T*, T*, T*, T*, size_t, const int*,
                          const int*, int, int, int, T);

// K1's instance for tiles of n <= 128, with its dynamic shared memory
// opted in.
template <typename T>
cudaError_t lu_kernel_for(int n, LuKernel<T>* kern) {
  const int cb = lu_cb(n);
  *kern = cb == 1   ? getrf_inv_kernel<T, 1>
          : cb == 2 ? getrf_inv_kernel<T, 2>
                    : getrf_inv_kernel<T, 4>;
  return cudaFuncSetAttribute(*kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lu_smem_bytes<T>(n));
}

// ---------------------------------------------------------------- K2

// The product windows: a 32-row band of an L panel, a 32-column band
// of a U panel, a 64 x 64 Schur quadrant, each over kGemmWarps warps.
// A panel is computed in place, so it is split only where a band of
// the output reads nothing but the same band of the tile: L·U^-1 by
// rows, L^-1·U by columns; a band spans the tile, so the bands have
// two widths: kSplit for nb <= 128, kMaxNb for nb <= 256.
constexpr int kSplit = kLuMaxN;  // 128: K1's largest register tile
constexpr int kMaxNb = 256;
constexpr int kBand = 32;
constexpr int kQuad = 64;
// Warp tiles 32 x 32 (1 x 4, 4 x 1 and 2 x 2 of them) at width 128, 32
// x 64 and 64 x 32 at width 256.  8 warps of 32 x 16 measured no faster
// end to end on the H100 at width 128 (tools/probe_products.py,
// PERF.md).
template <typename T, int NB> using LBand = Window<T, kBand, NB, 1, 4>;
template <typename T, int NB> using UBand = Window<T, NB, kBand, 4, 1>;
template <typename T> using Quad = Window<T, kQuad, kQuad, 2, 2>;

// Dynamic shared memory of a panel block (the larger of the two
// windows) and of a Schur block.
template <typename T, int NB>
constexpr size_t panel_smem_bytes() {
  return LBand<T, NB>::kSmemBytes > UBand<T, NB>::kSmemBytes
             ? LBand<T, NB>::kSmemBytes
             : UBand<T, NB>::kSmemBytes;
}
template <typename T>
constexpr size_t schur_smem_bytes() {
  return Quad<T>::kSmemBytes;
}

// Row band s of an L panel tile t <- t·U^-1, or column band s of a U
// panel tile t <- L^-1·t, with the bands of width NB >= nb.
template <typename T, int NB>
__device__ __forceinline__ void panel_band(T* t, const T* inv, bool is_l,
                                           int s, int nb, T* smem) {
  const Mat<T> c = tile_of(t, nb);
  if (is_l)
    tile_gemm<LBand<T, NB>, kStore>(c, tile_of(inv, nb), c, s * kBand, 0,
                                    smem);
  else
    tile_gemm<UBand<T, NB>, kStore>(tile_of(inv, nb), c, c, 0, s * kBand,
                                    smem);
}

// Block (b, s): b < nl: row band s of L panel lid[k][b] <- L·U^-1; else
// column band s of U panel uid[k][b-nl] <- L^-1·U, with the inverses in
// slot ``slot`` of invs (k, or in chain-ahead tables the level's
// original id).
template <typename T, int NB>
__global__ void __launch_bounds__(kGemmThreads)
    panel_kernel(T* tiles, const T* invs, const int* lid, const int* uid,
                 int lw, int uw, int k, int slot, int nl, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t nn = (size_t)nb * nb;
  const int b = blockIdx.x;
  const bool is_l = b < nl;
  const size_t id =
      is_l ? lid[(size_t)k * lw + b] : uid[(size_t)k * uw + b - nl];
  panel_band<T, NB>(tiles + id * nn, invs + (size_t)(2 * slot + is_l) * nn,
                    is_l, blockIdx.y, nb, reinterpret_cast<T*>(smem_raw));
}

// Block (j, q): update j of level k, output quadrant q of 64 x 64.
// Update j sits in chunk j / uch, entry j % uch of the [bl, nchunks,
// row_w] tables.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    schur_kernel(T* tiles, const int* lid, const int* uid, const int* udst,
                 const int* udl, const int* udu, int lw, int uw, int nchunks,
                 int row_w, int uch, int k, int nb, int qdim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t nn = (size_t)nb * nb;
  const int j = blockIdx.x;
  const size_t o = ((size_t)k * nchunks + j / uch) * row_w + j % uch;
  const T* l = tiles + (size_t)lid[(size_t)k * lw + udl[o]] * nn;
  const T* u = tiles + (size_t)uid[(size_t)k * uw + udu[o]] * nn;
  T* dst = tiles + (size_t)udst[o] * nn;
  const int qr = blockIdx.y / qdim, qc = blockIdx.y % qdim;
  tile_gemm<Quad<T>, kSubtract>(tile_of(l, nb), tile_of(u, nb),
                                tile_of(dst, nb), qr * kQuad, qc * kQuad,
                                reinterpret_cast<T*>(smem_raw));
}

// ------------------------------------------- K1, blocked (nb > 128)
// A tile of 128 < nb <= 256 is factored by one cluster of CL CTAs
// (lu_cluster_kernel; the note at the top gives the design).  W, a
// 256 x 256 working matrix padded with the identity, starts as the
// tile; CTA c holds its rows [c RPC, (c + 1) RPC) in shared memory.  At
// panel p (columns P = [k0, k0 + 32); D the columns before it, B those
// after) W holds, off the finished blocks: in rows B, L^-1's columns D
// and P (partial) and the trailing block; in columns B, U^-1's rows D
// and P (partial).  Per panel:
//   1. the owner of rows P, warp 0: F11, L11^-1 and U11^-1 of W[P, P]
//      (diag_panel), which becomes L11^-1 below its diagonal and U11^-1
//      on and above it;
//   2. the owner copies its rows P into its R and into S, the same rows
//      of UI in global memory (the final store overwrites them); after a
//      cluster barrier the others load S into their R through L2 (read
//      from the owner's shared memory they took ~14K cycles a panel in
//      f64 on an H100, 4 CTAs reading one SM; through L2 ~2K, PERF.md).
//      Every CTA splits U11^-1 off into U, leaves L11^-1 in R[:, P] and
//      forms R = L11^-1·R off the panel's columns: [X_PD | L11^-1 |
//      U12], L^-1's rows P and the factor's U12;
//   3. the owner sets W[P, D] = X_PD and W[P, B] = 0 (U^-1's rows P
//      start there);
//   4. every CTA, its rows i outside P: a_i = W[i, P]·U11^-1 (rows D:
//      U^-1's final W[D, P]; rows B: L21, to the factor, and W[i, P] =
//      0, where L^-1's entries start); rows P: a_i = U11^-1's row;
//   5. every CTA: W[i, j] -= a_i·R[:, j] for i in B (all j: L^-1's
//      columns D and P, and the trailing update A22 -= L21·U12) and for
//      i outside B, j in B (U^-1's columns B).
// One cluster barrier a panel, and one before the final store, which
// overwrites the rows of S that the last panel's readers load; no CTA
// reads another's shared memory.  Panels past nb, all padding, are
// skipped.  The plain twin is kernels_torch.getrf_with_inverses_blocked.
// In exact arithmetic each step is that of K1's body, one panel at a
// time.

constexpr int kPanel = 32;
constexpr int kClWarps = 8;
constexpr int kClThreads = 32 * kClWarps;
constexpr int kRowBuf = kPanel + 8;  // a row, its pivot and reciprocal

// The cluster's shape and its shared memory (elements of T): W (its
// rows, LDW apart: A fragments are free of bank conflicts at 4 mod 32
// words), R (the panel's rows), A (each row's a_i), U (U11^-1), and two
// broadcast rows of the diagonal warp.
template <typename T>
struct LuCluster {
  using Mt = Mma<T>;
  static constexpr int CL = sizeof(T) == 4 ? 2 : 4;
  static constexpr int RPC = kMaxNb / CL;
  static constexpr int MW = RPC / kClWarps;  // rows a warp: one MMA row
  static_assert(MW == Mt::M, "a warp's rows are one atom's");
  static constexpr int LDW = kMaxNb + 4;
  static constexpr int LDR = kMaxNb + Mt::PAD_B;
  static constexpr int LDA = kPanel + Mt::PAD_A;
  static constexpr int LDU = kPanel + Mt::PAD_B;
  static constexpr size_t kW = (size_t)RPC * LDW, kR = kPanel * LDR,
                          kA = (size_t)RPC * LDA, kU = kPanel * LDU;
  static constexpr size_t kSmemBytes =
      (kW + kR + kA + kU + 2 * kRowBuf) * sizeof(T);
};

// The split cluster barrier (.aligned: each warp reaches it converged).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of T: float4 or double2, taken apart and put together by
// compile-time indices.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  static constexpr int N = 4;
  __device__ static V make(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static void get(const V& v, float* x) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using V = double2;
  static constexpr int N = 2;
  __device__ static V make(const double* x) { return make_double2(x[0], x[1]); }
  __device__ static void get(const V& v, double* x) {
    x[0] = v.x;
    x[1] = v.y;
  }
};

template <typename T, int MF, int NF>
__device__ __forceinline__ void zero_acc(T (&acc)[MF][NF][Mma<T>::NC]) {
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int i = 0; i < Mma<T>::NC; ++i) acc[m][n][i] = T(0);
}

// acc += A·B for one warp: A rows [m0, m0 + MF M), k in [0, 32); B
// columns [n0, n0 + NF N); row-major, in shared memory.
template <typename T, int MF, int NF>
__device__ __forceinline__ void warp_mma_k32(T (&acc)[MF][NF][Mma<T>::NC],
                                             const T* A, int lda, int m0,
                                             const T* B, int ldb, int n0) {
  using Mt = Mma<T>;
#pragma unroll
  for (int kk = 0; kk < kPanel; kk += Mt::K) {
    typename Mt::AFrag fa[MF];
    typename Mt::BFrag fb[NF];
#pragma unroll
    for (int m = 0; m < MF; ++m) Mt::load_a(fa[m], A, lda, m0 + m * Mt::M, kk);
#pragma unroll
    for (int n = 0; n < NF; ++n) Mt::load_b(fb[n], B, ldb, kk, n0 + n * Mt::N);
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n) Mt::step(acc[m][n], fa[m], fb[n]);
  }
}

// x <- x rotated left by one place: x[i] = x[i + 1].
template <typename T>
__device__ __forceinline__ void rotate_left(T (&x)[kPanel]) {
  const T t = x[0];
#pragma unroll
  for (int i = 0; i + 1 < kPanel; ++i) x[i] = x[i + 1];
  x[kPanel - 1] = t;
}

// Step 1, by one warp, in place on the 32 x 32 block at w (row stride
// ldw, 16-byte aligned rows): F11, then L11^-1 below the diagonal and
// U11^-1 on and above it.  L and U also go to the factor F (global,
// row stride ldf; rows and columns of the tile from k0, those < nb).
//  - LU with L^-1 by forward Gauss–Jordan, K1's body on 32 columns:
//    lane i holds row i.  Row k goes through shared memory (rowbuf: 2 x
//    40 values, double-buffered so that one __syncwarp a step
//    suffices), 16 bytes at a time, with its pivot and the pivot's
//    reciprocal, which lane k formed during step k - 1 right after
//    updating that entry first.  Every lane runs the same instructions,
//    a row above k with a zero multiplier.  The steps are a loop: so
//    that every index stays a compile-time one, lane i holds its row
//    rotated, x[j] = column (k + j) mod 32 at step k, and lane k writes
//    it in that order: column k is always x[0], the next pivot's x[1].
//  - U^-1 by columns, once U is in w: lane j solves U y = e_j from the
//    bottom up, y_i = (e_j[i] - sum_{m > i} U[i, m] y_m) / d_i, reading
//    U as broadcasts and the 1 / d_i that lane i published.  No lane
//    waits for another, so the 32 dependent steps of a backward
//    Gauss–Jordan sweep (each a row through shared memory and a
//    __syncwarp) become one lane's chain of 32 FMAs and quotients.
// Measured on an H100 (clock64, PERF.md): ~10K cycles a panel in f32,
// ~18K in f64.  Two sweeps of Gauss–Jordan steps took ~25K as loops
// (11.6K the backward one) and 15K-23K unrolled, bound by the fetch of
// their ~10^4 instructions, which run once a panel.
template <typename T>
__device__ __forceinline__ void diag_panel(T* w, int ldw, T* rowbuf, T* F,
                                           int ldf, int k0, int nb, T tol) {
  using Q = Vec16<T>;
  constexpr int QP = kPanel / Q::N;  // 16-byte pieces of a row
  const int lane = threadIdx.x & 31;
  const bool in = k0 + lane < nb;
  T* frow = F + (size_t)(k0 + lane) * ldf + k0;
  T x[kPanel];
#pragma unroll
  for (int q = 0; q < QP; ++q)
    Q::get(reinterpret_cast<const typename Q::V*>(w + lane * ldw)[q],
           x + q * Q::N);
  T piv = safe_pivot(x[0], tol), rp = recip(piv);  // lane 0's
  T dv = T(1);                                     // the lane's pivot
#pragma unroll 1
  for (int k = 0; k < kPanel; ++k) {
    T* rb = rowbuf + (k & 1) * kRowBuf;
    if (lane == k) {
#pragma unroll
      for (int q = 0; q < QP; ++q)
        reinterpret_cast<typename Q::V*>(rb)[q] = Q::make(x + q * Q::N);
      rb[kPanel] = piv;
      rb[kPanel + 1] = rp;
    }
    __syncwarp();
    T rv[kPanel];
#pragma unroll
    for (int q = 0; q < QP; ++q)
      Q::get(reinterpret_cast<const typename Q::V*>(rb)[q], rv + q * Q::N);
    const T pk = rb[kPanel];
    const T l = quot(x[0], pk, rb[kPanel + 1]);
    const T lm = lane > k ? l : T(0);
    if (lane > k && in && k0 + k < nb) frow[k] = l;
    x[1] -= lm * rv[1];  // the next pivot first (at k = 31, lm = 0)
    piv = safe_pivot(x[1], tol);
    rp = recip(piv);
#pragma unroll
    for (int j = 2; j < kPanel; ++j) x[j] -= lm * rv[j];
    x[0] = lane > k ? -l : lane == k ? pk : x[0];
    dv = lane == k ? pk : dv;
    rotate_left(x);
  }
  // 32 rotations: x[j] is column j again; U's row to F, the row to w,
  // 1 / d to rowbuf (its last reads were before step 31's __syncwarp)
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
    if (j >= lane && in && k0 + j < nb) frow[j] = x[j];
#pragma unroll
  for (int q = 0; q < QP; ++q)
    reinterpret_cast<typename Q::V*>(w + lane * ldw)[q] =
        Q::make(x + q * Q::N);
  rowbuf[lane] = recip(dv);
  __syncwarp();
  // y: e_j less the sums so far; y_m once row m is done, which then
  // leaves the rows above (y_{m-1} first: the chain is one FMA and one
  // quotient a row)
  T y[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) y[i] = lane == i ? T(1) : T(0);
#pragma unroll
  for (int m = kPanel - 1; m >= 0; --m) {
    y[m] = quot(y[m], w[m * ldw + m], rowbuf[m]);
#pragma unroll
    for (int i = m - 1; i >= 0; --i) y[i] -= w[i * ldw + m] * y[m];
  }
  __syncwarp();  // every read of U is done
#pragma unroll
  for (int i = 0; i < kPanel; ++i)
    if (i <= lane) w[i * ldw + lane] = y[i];
  __syncwarp();
}

// Cluster (CL CTAs along x) y: member y of the batch, its tile and
// inverse slots addressed as getrf_inv_kernel's block.  Warp w takes
// rows [w MW, (w + 1) MW) of the CTA's in the products; warp 0 of the
// panel's owner factors its diagonal block.
template <typename T>
__global__ void __launch_bounds__(kClThreads, 1)
    lu_cluster_kernel(const T* a, T* f, T* linv, T* uinv, size_t inv_stride,
                      const int* ids, const int* inv_ids, int nb, T tol) {
  using C = LuCluster<T>;
  using Mt = Mma<T>;
  using Q = Vec16<T>;
  constexpr int QR = kMaxNb / Q::N;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);
  T* R = W + C::kW;
  T* Ab = R + C::kR;
  T* Ui = Ab + C::kA;
  T* rowbuf = Ui + C::kU;
  const int rank = (int)cg::this_cluster().block_rank();
  const int r0 = rank * C::RPC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const size_t nn = (size_t)nb * nb;
  const size_t t = (size_t)(ids ? ids[b] : b) * nn;
  const size_t slot = (size_t)(inv_ids ? inv_ids[b] : b) * inv_stride;
  const T* A = a + t;
  T* F = f + t;
  T* LI = linv + slot;
  T* UI = uinv + slot;
  // W: this CTA's rows of the tile, zero outside it, all copies in
  // flight at once; then the identity on the padding's diagonal
  const bool vec = nb % Q::N == 0 && (size_t)A % 16 == 0;
  const bool fvec = nb % Q::N == 0 && (size_t)F % 16 == 0;
  if (vec) {
    for (int e = threadIdx.x; e < C::RPC * QR; e += kClThreads) {
      const int i = e / QR, j = e % QR * Q::N, gi = r0 + i;
      const bool in = gi < nb && j < nb;
      cp_async<16>(W + i * C::LDW + j, in ? A + (size_t)gi * nb + j : A, in);
    }
  } else {
    for (int e = threadIdx.x; e < C::RPC * kMaxNb; e += kClThreads) {
      const int i = e / kMaxNb, j = e % kMaxNb, gi = r0 + i;
      const bool in = gi < nb && j < nb;
      cp_async<sizeof(T)>(W + i * C::LDW + j,
                          in ? A + (size_t)gi * nb + j : A, in);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < C::RPC; i += kClThreads)
    if (r0 + i >= nb) W[i * C::LDW + r0 + i] = T(1);
  __syncthreads();
  const int lw = warp * C::MW, gw = r0 + lw;  // the warp's first row
  // S: the staging rows of the panel's rows P, UI's rows P (the final
  // store below overwrites them); 16-byte pieces when rows allow
  const bool svec = nb % Q::N == 0 && (size_t)UI % 16 == 0;
  // panels that hold only padding change no row of the tile
#pragma unroll 1
  for (int k0 = 0; k0 < nb; k0 += kPanel) {
    const int owner = k0 / C::RPC, lr = k0 - r0, kb = k0 + kPanel;
    const bool mine = owner == rank;
    T* S = UI + (size_t)k0 * nb;
    if (mine) {
      if (warp == 0)  // 1. the diagonal block
        diag_panel(W + (size_t)lr * C::LDW + k0, C::LDW, rowbuf, F, nb, k0,
                   nb, tol);
      __syncthreads();
      // 2. the owner's rows P into its R and, their part inside the
      // tile, into S
      for (int e = threadIdx.x; e < kPanel * QR; e += kClThreads) {
        const int i = e / QR, j = e % QR * Q::N;
        const typename Q::V v = *reinterpret_cast<const typename Q::V*>(
            W + (size_t)(lr + i) * C::LDW + j);
        *reinterpret_cast<typename Q::V*>(R + i * C::LDR + j) = v;
        if (k0 + i >= nb || j >= nb) continue;
        if (svec) {
          *reinterpret_cast<typename Q::V*>(S + (size_t)i * nb + j) = v;
        } else {
          T x[Q::N];
          Q::get(v, x);
#pragma unroll
          for (int q = 0; q < Q::N; ++q)
            if (j + q < nb) S[(size_t)i * nb + j + q] = x[q];
        }
      }
    }
    cluster_arrive();
    cluster_wait();  // S holds the owner's rows P
    if (!mine) {  // 2. the others load them from S (through L2 only);
      // outside the tile they are the padding's identity
      for (int e = threadIdx.x; e < kPanel * QR; e += kClThreads) {
        const int i = e / QR, j = e % QR * Q::N;
        T* d = R + i * C::LDR + j;
        const T* s = S + (size_t)i * nb + j;
        if (svec && k0 + i < nb && j < nb) {
          cp_async<16>(d, s, true);
        } else {
#pragma unroll
          for (int q = 0; q < Q::N; ++q)
            d[q] = k0 + i < nb && j + q < nb ? __ldcg(s + q)
                                             : T(k0 + i == j + q ? 1 : 0);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    // R: U11^-1 split off, L11^-1 left
    for (int e = threadIdx.x; e < kPanel * kPanel; e += kClThreads) {
      const int i = e / kPanel, j = e % kPanel;
      T* p = R + i * C::LDR + k0 + j;
      Ui[i * C::LDU + j] = j >= i ? *p : T(0);
      if (j >= i) *p = T(j == i ? 1 : 0);
    }
    __syncthreads();
    {  // R = L11^-1·R off the panel; warp w takes columns [32 w, 32 w + 32)
      constexpr int MF = kPanel / Mt::M;
      const int n0 = warp * kPanel;
      if (n0 != k0) {
        T acc[MF][4][Mt::NC];
        zero_acc(acc);
        warp_mma_k32<T, MF, 4>(acc, R + k0, C::LDR, 0, R, C::LDR, n0);
        __syncwarp();  // the warp's reads of its columns are done
#pragma unroll
        for (int m = 0; m < MF; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < Mt::NC; ++i) {
              const int r = m * Mt::M + Mt::row(i);
              const int j = n0 + n * Mt::N + Mt::col(i);
              R[r * C::LDR + j] = acc[m][n][i];
            }
      }
    }
    __syncthreads();
    if (mine) {  // 3. the owner's rows P: X_PD, then U^-1's zeros; U12
      for (int e = threadIdx.x; e < kPanel * QR; e += kClThreads) {
        const int i = e / QR, j = e % QR * Q::N;
        if (j >= k0 && j < kb) continue;
        T v[Q::N], z[Q::N];
        Q::get(*reinterpret_cast<const typename Q::V*>(R + i * C::LDR + j),
               v);
#pragma unroll
        for (int q = 0; q < Q::N; ++q) z[q] = T(0);
        *reinterpret_cast<typename Q::V*>(W + (size_t)(lr + i) * C::LDW +
                                          j) = Q::make(j < k0 ? v : z);
        if (j >= kb && k0 + i < nb) {
          T* fp = F + (size_t)(k0 + i) * nb + j;
          if (fvec && j < nb) {
            *reinterpret_cast<typename Q::V*>(fp) = Q::make(v);
          } else {
#pragma unroll
            for (int q = 0; q < Q::N; ++q)
              if (j + q < nb) fp[q] = v[q];
          }
        }
      }
    }
    // 4. a_i for the warp's rows
    if (gw >= k0 && gw < kb) {
      for (int e = lane; e < C::MW * kPanel; e += 32) {
        const int i = e / kPanel, j = e % kPanel;
        Ab[(lw + i) * C::LDA + j] = Ui[(gw - k0 + i) * C::LDU + j];
      }
    } else {
      T acc[1][4][Mt::NC];
      zero_acc(acc);
      warp_mma_k32<T, 1, 4>(acc, W + k0, C::LDW, lw, Ui, C::LDU, 0);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) {
          const int r = lw + Mt::row(i), j = n * Mt::N + Mt::col(i);
          const T v = acc[0][n][i];
          Ab[r * C::LDA + j] = v;
          const int gi = r0 + r;
          if (gi >= kb) {
            W[(size_t)r * C::LDW + k0 + j] = T(0);
            if (gi < nb && k0 + j < nb) F[(size_t)gi * nb + k0 + j] = v;
          } else {
            W[(size_t)r * C::LDW + k0 + j] = v;
          }
        }
    }
    __syncthreads();
    // 5. W[i, j] -= a_i·R[:, j], 64 columns at a time; the warp's A
    // fragments are loaded once
    {
      const bool below = gw >= kb;
      typename Mt::AFrag fa[kPanel / Mt::K];
#pragma unroll
      for (int s = 0; s < kPanel / Mt::K; ++s)
        Mt::load_a(fa[s], Ab, C::LDA, lw, s * Mt::K);
#pragma unroll 1
      for (int c0 = below ? 0 : kb / 64 * 64; c0 < kMaxNb; c0 += 64) {
        T acc[8][Mt::NC];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < Mt::NC; ++i) acc[n][i] = T(0);
#pragma unroll
        for (int s = 0; s < kPanel / Mt::K; ++s) {
          typename Mt::BFrag fb[8];
#pragma unroll
          for (int n = 0; n < 8; ++n)
            Mt::load_b(fb[n], R, C::LDR, s * Mt::K, c0 + n * Mt::N);
#pragma unroll
          for (int n = 0; n < 8; ++n) Mt::step(acc[n], fa[s], fb[n]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < Mt::NC; ++i) {
            const int r = lw + Mt::row(i), j = c0 + n * Mt::N + Mt::col(i);
            if (below || j >= kb) W[(size_t)r * C::LDW + j] -= acc[n][i];
          }
      }
    }
    __syncthreads();
  }
  // L^-1 below W's diagonal (1 on it), U^-1 on and above it, once
  // every CTA has loaded the last panel's S
  cluster_arrive();
  cluster_wait();
  if (vec && ((size_t)LI | (size_t)UI) % 16 == 0) {
    for (int e = threadIdx.x; e < C::RPC * QR; e += kClThreads) {
      const int i = e / QR, j = e % QR * Q::N, gi = r0 + i;
      if (gi >= nb || j >= nb) continue;
      T w[Q::N], l[Q::N], u[Q::N];
      Q::get(*reinterpret_cast<const typename Q::V*>(W + i * C::LDW + j), w);
#pragma unroll
      for (int q = 0; q < Q::N; ++q) {
        l[q] = j + q < gi ? w[q] : T(j + q == gi ? 1 : 0);
        u[q] = j + q >= gi ? w[q] : T(0);
      }
      *reinterpret_cast<typename Q::V*>(LI + (size_t)gi * nb + j) = Q::make(l);
      *reinterpret_cast<typename Q::V*>(UI + (size_t)gi * nb + j) = Q::make(u);
    }
  } else {
    for (int e = threadIdx.x; e < C::RPC * kMaxNb; e += kClThreads) {
      const int i = e / kMaxNb, j = e % kMaxNb, gi = r0 + i;
      if (gi < nb && j < nb) {
        const T v = W[(size_t)i * C::LDW + j];
        LI[(size_t)gi * nb + j] = j < gi ? v : T(j == gi ? 1 : 0);
        UI[(size_t)gi * nb + j] = j >= gi ? v : T(0);
      }
    }
  }
}

// ---------------------------------------------------------------- K3
constexpr int kSolveThreads = 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// out[i] (=|-=) sum_j M[i][j] * xs[j], one warp per row i.  Every block
// sums a row in the same order, so copies computed by different blocks
// agree bit for bit.  With SUB, out is read through L2 (__ldcg): other
// blocks wrote it before the last grid barrier, and L1 is not coherent.
// A warp's rows (kSplit / 32 warps = 4 a pass) are summed together, so
// that the loads of all of them, and with SUB the old values of out,
// are in flight at once.  The one instance, NB = 128, takes one pass.
// With XG, xs is x in global memory, read through L2 by each lane (no
// shared copy, no barrier before the sum).
template <typename T, int NB, bool SUB, bool XG = false>
__device__ void tile_matvec(const T* M, const T* xs, T* out, int nb) {
  constexpr int kWarps = kSolveThreads / 32, kRows = kSplit / kWarps;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll 1
  for (int i0 = 0; i0 < NB; i0 += kSplit) {
    T acc[kRows], old[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + warp + q * kWarps;
      acc[q] = T(0);
      old[q] = SUB && lane == 0 && i < nb ? __ldcg(out + i) : T(0);
    }
#pragma unroll 4
    for (int j = lane; j < nb; j += 32) {
      const T xj = XG ? __ldcg(xs + j) : xs[j];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = i0 + warp + q * kWarps;
        if (i < nb) acc[q] = fmat(M[i * nb + j], xj, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + warp + q * kWarps;
      if (i < nb) {  // uniform across the warp
        const T sum = warp_sum(acc[q]);
        if (lane == 0) out[i] = SUB ? old[q] - sum : sum;
      }
    }
  }
}

// One sweep of the block solve in one cooperative launch; the kernel
// walks the bl levels itself with one grid barrier per level.  Level k
// (ascending, or descending for the backward sweep) has n = cnt[k]
// panel tiles; its items are (t, r), t < max(n, 1), r < nrhs, taken
// r-major by a grid-stride loop.  A block with items recomputes
// x_k = inv_k · src[r, k] into shared memory once per r it meets (the
// same sum on every block); the holder of item (0, r) writes it to
// dst[r, k], and item (t < n, r) subtracts T_t · x_k from src[r,
// rows[k][t]].  src[r, k] is read at level k only and dst[r, k] written
// there only, while the panel rows of a level are distinct and never k
// (Schedule.mega_solve_tables), so no two blocks touch one value
// between two barriers: no atomics, the same result on every run.  One
// instance, NB = 128 (above, solve_clusters.cuh).
template <typename T, int NB>
__global__ void __launch_bounds__(kSolveThreads)
    solve_sweep_kernel(T* src, T* dst, int nrhs, const T* tiles,
                       const T* invs, int slot, const int* ids,
                       const int* rows, const int* cnt, int bl, int w,
                       int nb, int descending) {
  __shared__ T xk[NB];
  cg::grid_group grid = cg::this_grid();
  const size_t nn = (size_t)nb * nb;
  const size_t rhs_stride = (size_t)(bl + 1) * nb;
  for (int s = 0; s < bl; ++s) {
    const int k = descending ? bl - 1 - s : s;
    const int n = cnt[k], nt = n > 0 ? n : 1;
    int have = -1;
    for (int it = blockIdx.x; it < nt * nrhs; it += gridDim.x) {
      const int r = it / nt, t = it % nt;
      T* xr = src + r * rhs_stride;
      // the item's panel tile and x row, read before the inverse
      // product so that their latency overlaps it
      const T* tile = nullptr;
      T* xrow = nullptr;
      if (t < n) {
        const size_t e = (size_t)k * w + t;
        tile = tiles + (size_t)ids[e] * nn;
        xrow = xr + (size_t)rows[e] * nb;
      }
      if (r != have) {
        __syncthreads();  // every reader of the last x_k is done
        tile_matvec<T, NB, false, true>(invs + (size_t)(2 * k + slot) * nn,
                                        xr + (size_t)k * nb, xk, nb);
        __syncthreads();
        have = r;
      }
      if (t == 0)
        for (int i = threadIdx.x; i < nb; i += kSolveThreads)
          dst[r * rhs_stride + (size_t)k * nb + i] = xk[i];
      if (t < n) tile_matvec<T, NB, true>(tile, xk, xrow, nb);
    }
    grid.sync();
  }
}

// Spins through ``iters`` grid barriers: measures one barrier's cost.
__global__ void __launch_bounds__(kSolveThreads)
    grid_sync_probe_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

// Cooperative launch of ``kern`` on at most ``want`` blocks, as many as
// fit on the card at once (a cooperative grid must be co-resident:
// the launch refuses a larger one, and a larger one would deadlock).
// The kernels launched here take no dynamic shared memory: a kernel
// that did would have to give its bytes to the occupancy query too.
// *blocks receives the grid, *per_sm (if given) the blocks an SM holds.
template <typename K>
cudaError_t launch_cooperative(K kern, int want, void** args,
                               cudaStream_t st, int* blocks,
                               int* per_sm = nullptr) {
  int dev, sms, fit;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern,
                                                    kSolveThreads, 0);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm) *per_sm = fit;
  *blocks = want < fit * sms ? want : fit * sms;
  if (*blocks < 1) *blocks = 1;
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(*blocks),
                                  dim3(kSolveThreads), args, 0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K4

// Block (b, s): b < npl: row band s of L panel tile b of group g <-
// L·U^-1 of its member; else column band s of U panel tile b - npl <-
// L^-1·U.  The member m of panel tile p is the one with off[m] <= p <
// off[m+1] (gloff or guoff row of g).
template <typename T, int NB>
__global__ void __launch_bounds__(kGemmThreads)
    group_panel_kernel(T* tiles, const T* invs, const int* lid,
                       const int* uid, const int* glev, const int* gloff,
                       const int* guoff, int g, int gw, int lw, int uw,
                       int gs, int npl, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t nn = (size_t)nb * nb;
  const bool is_l = blockIdx.x < npl;
  const int p = is_l ? blockIdx.x : blockIdx.x - npl;
  const int* off = (is_l ? gloff : guoff) + (size_t)g * (gw + 1);
  int m = 0;
  while (m + 1 < gs && off[m + 1] <= p) ++m;
  const size_t k = glev[(size_t)g * gw + m];
  const size_t id = is_l ? lid[(size_t)g * lw + p] : uid[(size_t)g * uw + p];
  panel_band<T, NB>(tiles + id * nn, invs + (2 * k + is_l) * nn, is_l,
                    blockIdx.y, nb, reinterpret_cast<T*>(smem_raw));
}

// Block (d, q): distinct destination doff + d of group g, output
// quadrant q of 64 x 64.  Its updates are dent[dptr[.]:dptr[.+1]],
// indices j into the group's update list (chunk j / uch, entry j % uch
// of the [ngroups, nchunks, row_w] tables); the products are summed in
// registers and subtracted from the destination once.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    group_schur_kernel(T* tiles, const int* lid, const int* uid,
                       const int* udl, const int* udu, const int* dkey,
                       const int* dptr, const int* dent, int g, int doff,
                       int lw, int uw, int nchunks, int row_w, int uch,
                       int nb, int qdim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t nn = (size_t)nb * nb;
  const int d = doff + blockIdx.x;
  const int r0 = blockIdx.y / qdim * kQuad, c0 = blockIdx.y % qdim * kQuad;
  typename Quad<T>::Acc acc;
  acc.zero();
  for (int e = dptr[d]; e < dptr[d + 1]; ++e) {
    const int j = dent[e];
    const size_t o = ((size_t)g * nchunks + j / uch) * row_w + j % uch;
    const T* l = tiles + (size_t)lid[(size_t)g * lw + (udl[o] & 0xFFFFF)] * nn;
    const T* u = tiles + (size_t)uid[(size_t)g * uw + (udu[o] & 0xFFF)] * nn;
    tile_gemm_acc<Quad<T>>(tile_of(l, nb), tile_of(u, nb), r0, c0, acc,
                           smem);
  }
  tile_store<Quad<T>, kSubtract>(tile_of(tiles + (size_t)dkey[d] * nn, nb),
                                 r0, c0, acc);
}

// ---------------------------------------------------------------- K5

// Asks L2 to fetch [p, p + bytes) (cp.async.bulk.prefetch: one
// instruction for a whole tile, no registers, no wait), cut to the
// 16-byte bounds inside the range as the instruction requires.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const size_t a = __cvta_generic_to_global(p);
  const size_t lo = (a + 15) & ~size_t(15), hi = (a + bytes) & ~size_t(15);
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo),
                 "r"((unsigned)(hi - lo))
                 : "memory");
}

// acc[q] += sum_j M[i][j] * x[j] for the rows i = i0 + warp + q *
// kWarps < nb, in column order within a lane; x is read through L2
// (__ldcg): other blocks wrote it before the last grid barrier.
template <typename T, int R>
__device__ __forceinline__ void rows_dot(const T* M, const T* x, int nb,
                                         int i0, T (&acc)[R]) {
  constexpr int kWarps = kSolveThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll 4
  for (int j = lane; j < nb; j += 32) {
    const T xj = __ldcg(x + j);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = i0 + warp + q * kWarps;
      if (i < nb) acc[q] = fmat(M[i * nb + j], xj, acc[q]);
    }
  }
}

// One item d = (seg, inv, e0, e1) of a step of schedule.group_solve_steps
// for one RHS (xs, xd: its source and destination buffers):
// v = xs[seg] - sum_e T_e · xd[k_e] over entries ent[e0:e1] = (tile,
// k_e), summed in registers in entry order, one warp per row; then
// xd[seg] = inv · v (through shared v) if d.inv, else xs[seg] = v.
template <typename T, int NB>
__device__ void group_item(T* xs, T* xd, const T* tiles, const T* inv,
                           int4 d, const int2* ent, int nb, T* v) {
  constexpr int kWarps = kSolveThreads / 32, kRows = kSplit / kWarps;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T* row = xs + (size_t)d.x * nb;
#pragma unroll 1
  for (int i0 = 0; i0 < NB; i0 += kSplit) {
    T acc[kRows], old[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + warp + q * kWarps;
      acc[q] = T(0);
      old[q] = lane == 0 && i < nb ? __ldcg(row + i) : T(0);
    }
    for (int e = d.z; e < d.w; ++e) {
      const int2 te = __ldg(ent + e);
      rows_dot(tiles + (size_t)te.x * nb * nb, xd + (size_t)te.y * nb, nb,
               i0, acc);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + warp + q * kWarps;
      if (i < nb) {  // uniform across the warp
        const T val = old[q] - warp_sum(acc[q]);
        if (lane == 0) {
          if (d.y)
            v[i] = val;
          else
            row[i] = val;
        }
      }
    }
  }
  if (d.y) {  // uniform across the block
    __syncthreads();
    tile_matvec<T, NB, false>(inv, v, xd + (size_t)d.x * nb, nb);
    __syncthreads();  // v is free for the block's next item
  }
}

// One sweep of K5 in one cooperative launch: the kernel walks the steps
// of schedule.group_solve_steps (step[s] = first item, first entry)
// with one grid barrier between two steps.  Step s's items (i, r), i
// < n items, r < nrhs, are taken r-major by a grid-stride loop.  Within
// a step every item has its own segment and reads dst only where an
// earlier step wrote it, so no two blocks touch one value between two
// barriers: no atomics, one sum order, the same bits on every run.
// Before the barrier that ends step s, the grid asks L2 for step s+1's
// tiles and inverses (read-only for the whole solve; a bulk prefetch
// each): only x has to wait for the barrier.  One instance, NB = 128
// (above, solve_clusters.cuh).
template <typename T, int NB>
__global__ void __launch_bounds__(kSolveThreads)
    group_sweep_kernel(T* src, T* dst, int nrhs, const T* tiles,
                       const T* invs, int slot, const int2* step,
                       const int4* item, const int2* ent, int nsteps, int bl,
                       int nb) {
  __shared__ T v[NB];
  cg::grid_group grid = cg::this_grid();
  const size_t nn = (size_t)nb * nb, rhs_stride = (size_t)(bl + 1) * nb;
  int2 cur = __ldg(step), nxt = __ldg(step + 1);
  for (int s = 0;; ++s) {
    const int n = nxt.x - cur.x;
    for (int it = blockIdx.x; it < n * nrhs; it += gridDim.x) {
      const int r = it / n;
      const int4 d = __ldg(item + cur.x + it % n);
      group_item<T, NB>(src + r * rhs_stride, dst + r * rhs_stride, tiles,
                        invs + (2 * (size_t)d.x + slot) * nn, d, ent, nb,
                        v);
    }
    if (s + 1 == nsteps) break;
    const int2 after = __ldg(step + s + 2);
    const int ne = after.y - nxt.y, np = ne + after.x - nxt.x;
    for (int p = blockIdx.x + threadIdx.x * gridDim.x; p < np;
         p += gridDim.x * kSolveThreads) {
      if (p < ne) {
        prefetch_l2(tiles + (size_t)__ldg(ent + nxt.y + p).x * nn,
                    nn * sizeof(T));
      } else {
        const int4 d = __ldg(item + nxt.x + p - ne);
        if (d.y)
          prefetch_l2(invs + (2 * (size_t)d.x + slot) * nn, nn * sizeof(T));
      }
    }
    cur = nxt;
    nxt = after;
    grid.sync();
  }
}

}  // namespace plu

// K3 and K5 at tile width 256, on thread block clusters
#include "solve_clusters.cuh"

namespace plu {

// ------------------------------------------------------ host launchers

// Opts a panel and a Schur kernel into their dynamic shared memory (the
// f64 panel window is above the 48 KB a block gets without asking).
template <typename P, typename S>
cudaError_t products_for(P panel, S schur, size_t panel_smem,
                         size_t schur_smem) {
  cudaError_t e = cudaFuncSetAttribute(
      panel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)panel_smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      schur, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)schur_smem);
}

// The cluster launch of lu_cluster_kernel for ``batch`` tiles.
template <typename T>
cudaLaunchConfig_t cluster_config(int batch, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  using C = LuCluster<T>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::CL, batch);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C::CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// K1 for tiles of one nb: its instance picked and opted in once (init),
// then launched per batch (run): one device launch, K1's body up to nb
// = 128, the cluster kernel above it.
template <typename T>
struct DiagStep {
  int nb;
  LuKernel<T> lu;  // K1's body, nb <= 128
  size_t smem;

  cudaError_t init(int nb_) {
    nb = nb_;
    if (nb <= kSplit) {
      smem = lu_smem_bytes<T>(nb);
      return lu_kernel_for<T>(nb, &lu);
    }
    cudaError_t e = cudaFuncSetAttribute(
        lu_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)LuCluster<T>::kSmemBytes);
    if (e != cudaSuccess) return e;
    // a cluster of this shape must fit on the card at all
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<T>(1, 0, &attr);
    int clusters = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&clusters, lu_cluster_kernel<T>,
                                            &cfg)) != cudaSuccess)
      return e;
    return clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
  }

  // ``batch`` tiles (ids, inv_ids and inv_stride as getrf_inv_kernel)
  // from a into f (in place when a == f).  counts[0] += 1 for the K1
  // launch, counts[1] += its device launches (1).
  cudaError_t run(const T* a, T* f, T* linv, T* uinv, size_t inv_stride,
                  const int* ids, const int* inv_ids, int batch, T tol,
                  int* counts, cudaStream_t st) const {
    cudaError_t e;
    if (nb <= kSplit) {
      lu<<<batch, kLuThreads, smem, st>>>(a, f, linv, uinv, inv_stride, ids,
                                          inv_ids, nb, 0, nb, tol);
      e = cudaGetLastError();
    } else {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config<T>(batch, st, &attr);
      e = cudaLaunchKernelEx(&cfg, lu_cluster_kernel<T>, a, f, linv, uinv,
                             inv_stride, ids, inv_ids, nb, tol);
      if (e == cudaSuccess) e = cudaGetLastError();
    }
    if (e != cudaSuccess) return e;
    ++counts[0];
    ++counts[1];
    return cudaSuccess;
  }
};

template <typename T>
int getrf_inv(const T* a, T* f, T* linv, T* uinv, int batch, int nb,
              double tol, int* k1_launches, cudaStream_t st) {
  DiagStep<T> diag;
  cudaError_t e = diag.init(nb);
  if (e != cudaSuccess) return e;
  return diag.run(a, f, linv, uinv, (size_t)nb * nb, nullptr, nullptr, batch,
                  (T)tol, k1_launches, st);
}

// K1 in place on ``batch`` tiles ids of a tile store, their inverses
// into invs ([levels, 2, nb, nb]) at slots inv_ids: K4's diagonal step
// alone.
template <typename T>
int diag_step(T* tiles, T* invs, const int* ids, const int* inv_ids,
              int batch, int nb, double tol, int* k1_launches,
              cudaStream_t st) {
  DiagStep<T> diag;
  cudaError_t e = diag.init(nb);
  if (e != cudaSuccess) return e;
  const size_t nn = (size_t)nb * nb;
  return diag.run(tiles, tiles, invs, invs + nn, 2 * nn, ids, inv_ids,
                  batch, (T)tol, k1_launches, st);
}

// K2's and K4's panel kernels and their shared memory for tiles of nb:
// the bands of width kSplit up to nb = 128, of kMaxNb above.
template <typename T>
struct PanelKernels {
  decltype(&panel_kernel<T, kSplit>) chain;
  decltype(&group_panel_kernel<T, kSplit>) group;
  size_t smem;
  explicit PanelKernels(int nb) {
    const bool narrow = nb <= kSplit;
    chain = narrow ? panel_kernel<T, kSplit> : panel_kernel<T, kMaxNb>;
    group = narrow ? group_panel_kernel<T, kSplit>
                   : group_panel_kernel<T, kMaxNb>;
    smem = narrow ? panel_smem_bytes<T, kSplit>()
                  : panel_smem_bytes<T, kMaxNb>();
  }
};

// K2's diagonal steps run ahead (chain-ahead tables): a second stream,
// the caller's, and two events.  ``start`` marks a level's start on the
// main stream (every earlier level done); ``done`` follows the last
// diagonal step run ahead on the side stream.  The events are made per
// call and destroyed after the join, which CUDA allows while work
// recorded on them is pending.
struct Ahead {
  cudaStream_t side = nullptr;
  cudaEvent_t start = nullptr, done = nullptr;
  bool used = false;

  cudaError_t init(cudaStream_t s) {
    side = s;
    cudaError_t e = cudaEventCreateWithFlags(&start, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
    return e;
  }

  // The main stream waits for everything queued on the side stream,
  // then the events go.  Runs on every path out of mega_factorize.
  cudaError_t join(cudaStream_t st) {
    cudaError_t e = cudaSuccess;
    if (used && (e = cudaEventRecord(done, side)) == cudaSuccess)
      e = cudaStreamWaitEvent(st, done, 0);
    if (start != nullptr) cudaEventDestroy(start);
    if (done != nullptr) cudaEventDestroy(done);
    return e;
  }
};

// K2's level loop.  With chain-ahead tables (h_flag, h_lev: levels in
// dependency-depth order, flag 1 where a level has the depth of the one
// before it; pangulu_tpu/ops/kernels_pallas.py:662-690, 759-800) and a
// side stream, the diagonal step of a flagged level k + 1 goes to the
// side stream at level k's start, behind an event of the main stream,
// and runs beside level k's diagonal step, panels and Schur updates;
// level k + 1 then waits for it in place of running it.  Equal depth
// means that level k writes nothing the step reads or writes
// (schedule.check_ahead holds the tables to that), and K1 keeps no state
// between launches, so the two streams share nothing.  One diagonal
// ahead at a time, as the TPU kernel.  Without a side stream the same
// tables run every step on the main stream: the same arithmetic, so the
// same bits.  Position k's inverses go to slot h_lev[k] (k without
// tables), so the solves read them by original level.  counts[0] and
// counts[1]: K1's launches and device launches (bl each, on either
// stream); counts[2]: the diagonal steps run on the side stream.
template <typename T>
cudaError_t mega_levels(T* tiles, T* invs, const int* diag_tab,
                        const int* lid, const int* uid, const int* udst,
                        const int* udl, const int* udu, const int* h_nl,
                        const int* h_nu, const int* h_nup, const int* h_flag,
                        const int* h_lev, int bl, int lw, int uw,
                        int nchunks, int row_w, int uch, int nb, double tol,
                        int* counts, cudaStream_t st, Ahead& ahead) {
  DiagStep<T> diag;
  cudaError_t e = diag.init(nb);
  if (e != cudaSuccess) return e;
  const PanelKernels<T> pk(nb);
  const size_t psm = pk.smem, ssm = schur_smem_bytes<T>();
  if ((e = products_for(pk.chain, schur_kernel<T>, psm, ssm)) != cudaSuccess)
    return e;
  const size_t nn = (size_t)nb * nb;
  const int qdim = (nb + kQuad - 1) / kQuad, bands = (nb + kBand - 1) / kBand;
  // K1 on tile diag_tab[k], in place, its inverses to its slot
  auto diag_at = [&](int k, cudaStream_t s) {
    T* linv = invs + (size_t)(2 * (h_lev ? h_lev[k] : k)) * nn;
    return diag.run(tiles, tiles, linv, linv + nn, 0, diag_tab + k, nullptr,
                    1, (T)tol, counts, s);
  };
  const bool ahead_on = ahead.side != nullptr;
  for (int k = 0; k < bl; ++k) {
    const bool next = ahead_on && k + 1 < bl && h_flag[k + 1];
    if (next && (e = cudaEventRecord(ahead.start, st)) != cudaSuccess)
      return e;
    if (ahead_on && h_flag[k]) {
      // run ahead beside level k - 1
      if ((e = cudaStreamWaitEvent(st, ahead.done, 0)) != cudaSuccess)
        return e;
    } else if ((e = diag_at(k, st)) != cudaSuccess) {
      return e;
    }
    if (next) {
      ahead.used = true;
      if ((e = cudaStreamWaitEvent(ahead.side, ahead.start, 0)) !=
              cudaSuccess ||
          (e = diag_at(k + 1, ahead.side)) != cudaSuccess ||
          (e = cudaEventRecord(ahead.done, ahead.side)) != cudaSuccess)
        return e;
      ++counts[2];
    }
    const int np = h_nl[k] + h_nu[k];
    if (np > 0) {
      pk.chain<<<dim3(np, bands), kGemmThreads, psm, st>>>(
          tiles, invs, lid, uid, lw, uw, k, h_lev ? h_lev[k] : k, h_nl[k],
          nb);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (h_nup[k] > 0) {
      schur_kernel<T><<<dim3(h_nup[k], qdim * qdim), kGemmThreads, ssm, st>>>(
          tiles, lid, uid, udst, udl, udu, lw, uw, nchunks, row_w, uch, k, nb,
          qdim);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// K2: the level loop, with a side stream when ``side`` is given with
// chain-ahead tables.  If the events cannot be made the call fails:
// there is no fallback to one stream.
template <typename T>
int mega_factorize(T* tiles, T* invs, const int* diag_tab, const int* lid,
                   const int* uid, const int* udst, const int* udl,
                   const int* udu, const int* h_nl, const int* h_nu,
                   const int* h_nup, const int* h_flag, const int* h_lev,
                   int bl, int lw, int uw, int nchunks, int row_w, int uch,
                   int nb, double tol, int* counts, cudaStream_t st,
                   cudaStream_t side) {
  Ahead ahead;
  cudaError_t e = cudaSuccess;
  if (side != nullptr) {
    if (h_flag == nullptr) return cudaErrorInvalidValue;
    e = ahead.init(side);
  }
  if (e == cudaSuccess)
    e = mega_levels(tiles, invs, diag_tab, lid, uid, udst, udl, udu, h_nl,
                    h_nu, h_nup, h_flag, h_lev, bl, lw, uw, nchunks, row_w,
                    uch, nb, tol, counts, st, ahead);
  const cudaError_t j = ahead.join(st);
  return e != cudaSuccess ? e : j;
}

// One sweep: up to nb = 128 one cooperative launch whose grid h_n (host
// copy of cnt) sizes to the widest level's item count, capped at what
// fits on the card; above, K3's cluster kernel (solve_cluster_sweep).
// grid[0] receives the blocks launched, grid[1] the blocks an SM holds
// (nb <= 128) or the clusters that fit (above).
template <typename T>
int sweep(T* src, T* dst, int nrhs, const T* tiles, const T* invs, int slot,
          const int* ids, const int* rows, const int* cnt, const int* h_n,
          int bl, int w, int nb, int descending, int* grid, cudaStream_t st) {
  if (nb > kSplit)
    return solve_cluster_sweep(
        SolveSweep<T>{src, dst, nrhs, tiles, invs, slot, ids, rows, cnt, bl,
                      w, nb, descending},
        grid, st);
  int widest = 1;
  for (int k = 0; k < bl; ++k) widest = h_n[k] > widest ? h_n[k] : widest;
  void* args[] = {&src,  &dst, &nrhs, &tiles, &invs, &slot,      &ids,
                  &rows, &cnt, &bl,   &w,     &nb,   &descending};
  return launch_cooperative(solve_sweep_kernel<T, kSplit>, widest * nrhs,
                            args, st, &grid[0], &grid[1]);
}

// x: the right-hand sides on entry, the solution on exit; y: scratch of
// x's shape that holds the forward sweep's result (the backward sweep
// reads it and writes x).  grid[0], grid[1]: the blocks of the forward
// and backward launch; grid[2]: the blocks an SM holds, or above nb =
// 128 the clusters that fit; grid[3]: the CTAs a cluster (1 up to nb =
// 128).
template <typename T>
int mega_solve(T* x, T* y, int nrhs, const T* tiles, const T* invs,
               const int* lid, const int* lrow, const int* ucid,
               const int* ucrow, const int* nl, const int* nuc,
               const int* h_nl, const int* h_nuc, int bl, int w, int nb,
               int* grid, cudaStream_t st) {
  int g[2];
  int e = sweep(x, y, nrhs, tiles, invs, 0, lid, lrow, nl, h_nl, bl, w, nb,
                0, g, st);
  if (e != cudaSuccess) return e;
  grid[0] = g[0];
  grid[2] = g[1];
  grid[3] = nb > kSplit ? kSolveCluster : 1;
  e = sweep(y, x, nrhs, tiles, invs, 1, ucid, ucrow, nuc, h_nuc, bl, w, nb,
            1, g, st);
  grid[1] = g[0];
  return e;
}

template <typename T>
int mega_factorize_groups(T* tiles, T* invs, const int* gdiag,
                          const int* glev, const int* gloff,
                          const int* guoff, const int* lid, const int* uid,
                          const int* udl, const int* udu, const int* dkey,
                          const int* dptr, const int* dent, const int* h_gs,
                          const int* h_npl, const int* h_npu,
                          const int* h_ndst, const int* h_doff, int ng,
                          int gw, int lw, int uw, int nchunks, int row_w,
                          int uch, int nb, double tol, int* k1_launches,
                          cudaStream_t st) {
  DiagStep<T> diag;
  cudaError_t e = diag.init(nb);
  if (e != cudaSuccess) return e;
  const PanelKernels<T> pk(nb);
  const size_t psm = pk.smem, ssm = schur_smem_bytes<T>();
  if ((e = products_for(pk.group, group_schur_kernel<T>, psm, ssm)) !=
      cudaSuccess)
    return e;
  const size_t nn = (size_t)nb * nb;
  const int qdim = (nb + kQuad - 1) / kQuad, bands = (nb + kBand - 1) / kBand;
  for (int g = 0; g < ng; ++g) {
    // diagonal step: K1 on the group's members as one batch, in place;
    // its launches are reported to the wrapper through k1_launches
    if ((e = diag.run(tiles, tiles, invs, invs + nn, 2 * nn,
                      gdiag + (size_t)g * gw, glev + (size_t)g * gw, h_gs[g],
                      (T)tol, k1_launches, st)) != cudaSuccess)
      return e;
    const int np = h_npl[g] + h_npu[g];
    if (np > 0) {
      pk.group<<<dim3(np, bands), kGemmThreads, psm, st>>>(
          tiles, invs, lid, uid, glev, gloff, guoff, g, gw, lw, uw, h_gs[g],
          h_npl[g], nb);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (h_ndst[g] > 0) {
      group_schur_kernel<T>
          <<<dim3(h_ndst[g], qdim * qdim), kGemmThreads, ssm, st>>>(
              tiles, lid, uid, udl, udu, dkey, dptr, dent, g, h_doff[g], lw,
              uw, nchunks, row_w, uch, nb, qdim);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// One sweep of K5: up to nb = 128 one cooperative launch whose grid
// nsteps steps of at most ``width`` items (host values) size, capped at
// what fits on the card; above, K5's cluster kernel on clusters of
// `cluster` CTAs (group_cluster_sweep, bar its barrier's counters).
// grid as for sweep.
template <typename T>
int group_sweep(T* src, T* dst, int nrhs, const T* tiles, const T* invs,
                int slot, const int* step, const int* item, const int* ent,
                int nsteps, int width, int bl, int nb, int cluster,
                unsigned* bar, int* grid, cudaStream_t st) {
  const int2* step2 = reinterpret_cast<const int2*>(step);
  const int4* item4 = reinterpret_cast<const int4*>(item);
  const int2* ent2 = reinterpret_cast<const int2*>(ent);
  if (nb > kSplit)
    return group_cluster_sweep(
        GroupSweep<T>{src, dst, nrhs, tiles, invs, slot, step2, item4, ent2,
                      nsteps, bl, nb},
        width, cluster, bar, grid, st);
  void* args[] = {&src,  &dst,   &nrhs, &tiles,  &invs, &slot,
                  &step2, &item4, &ent2, &nsteps, &bl,   &nb};
  return launch_cooperative(group_sweep_kernel<T, kSplit>, width * nrhs,
                            args, st, &grid[0], &grid[1]);
}

// x: the right-hand sides on entry, the solution on exit; y: scratch of
// x's shape that holds the forward sweep's result (the backward sweep
// reads it and writes x).  grid as for mega_solve.
template <typename T>
int mega_solve_groups(T* x, T* y, int nrhs, const T* tiles, const T* invs,
                      const int* fstep, const int* fitem, const int* fent,
                      const int* bstep, const int* bitem, const int* bent,
                      int fsteps, int fwidth, int bsteps, int bwidth, int bl,
                      int nb, unsigned* bar, int* grid, cudaStream_t st) {
  int cluster = 1;  // above nb = 128, one size for both sweeps
  if (nb > kSplit) {
    int dev, sms;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cluster = group_cluster_size(fwidth > bwidth ? fwidth : bwidth, nrhs, sms);
  }
  int g[2];
  int e = group_sweep(x, y, nrhs, tiles, invs, 0, fstep, fitem, fent, fsteps,
                      fwidth, bl, nb, cluster, bar, g, st);
  if (e != cudaSuccess) return e;
  grid[0] = g[0];
  grid[2] = g[1];
  grid[3] = cluster;
  e = group_sweep(y, x, nrhs, tiles, invs, 1, bstep, bitem, bent, bsteps,
                  bwidth, bl, nb, cluster, bar, g, st);
  grid[1] = g[0];
  return e;
}

}  // namespace plu

// ------------------------------------------------------ C interface
// K1 for tiles wider than 256: its cluster kernel up to 512, built on
// diag_panel and the atoms above, and the recursion beyond
#include "wide_lu.cuh"

#define PLU_STREAM(s) reinterpret_cast<cudaStream_t>(s)

extern "C" {

// Bumped with every change of an entry's signature; kernels_cuda.py
// checks it at load.
int plu_kernels_abi() { return 18; }

// ``iters`` grid barriers on (at most) ``want`` cooperative blocks of
// K3's size; *blocks receives the grid actually launched.  A
// measurement of the barrier K3 takes once per level, on no path.
int plu_grid_sync_probe(int dev, int want, int iters, int* blocks,
                        void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  void* args[] = {&iters};
  return plu::launch_cooperative(plu::grid_sync_probe_kernel, want, args,
                                 PLU_STREAM(st), blocks);
}

const char* plu_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int plu_getrf_inv_f32(int dev, const float* a, float* f, float* linv,
                      float* uinv, int batch, int nb, double tol,
                      int* k1_launches, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::getrf_inv(a, f, linv, uinv, batch, nb, tol, k1_launches,
                        PLU_STREAM(st));
}

int plu_getrf_inv_f64(int dev, const double* a, double* f, double* linv,
                      double* uinv, int batch, int nb, double tol,
                      int* k1_launches, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::getrf_inv(a, f, linv, uinv, batch, nb, tol, k1_launches,
                        PLU_STREAM(st));
}

// K1 on tiles of nb > 256 (wide_lu.cuh): ``work`` holds batch *
// plu_wide_work_elems(nb) elements.
#define PLU_GETRF_INV_WIDE(NAME, T)                                           \
  int NAME(int dev, const T* a, T* f, T* linv, T* uinv, T* work, int batch, \
           int nb, double tol, int* k1_launches, void* st) {                 \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::getrf_inv_wide(a, f, linv, uinv, work, batch, nb, tol,      \
                               k1_launches, PLU_STREAM(st));                 \
  }
PLU_GETRF_INV_WIDE(plu_getrf_inv_wide_f32, float)
PLU_GETRF_INV_WIDE(plu_getrf_inv_wide_f64, double)

long long plu_wide_work_elems(int nb) {
  return (long long)plu::wide_work_elems(nb);
}

// The cluster kernel's plan for a tile of 1 <= nb <= 512 of elements of
// elem_bytes (4 or 8): out[0..3] = CTAs a cluster, rows a CTA, dynamic
// shared memory a CTA, columns of a warp's stripe (kernels_cuda.
// wide_plan mirrors it).
int plu_wide_plan(int nb, int elem_bytes, int* out) {
  if (nb < 1 || nb > plu::kWideLeaf || (elem_bytes != 4 && elem_bytes != 8))
    return cudaErrorInvalidValue;
  const plu::WidePlan pl = elem_bytes == 4 ? plu::wide_plan<float>(nb)
                                           : plu::wide_plan<double>(nb);
  out[0] = pl.ctas;
  out[1] = pl.rows;
  out[2] = pl.smem;
  out[3] = pl.stripe;
  return cudaSuccess;
}

// The cluster kernel alone (lookahead 0, 1 or 2; clk: nullptr, or 16 *
// plu_wide_clk_slots() device readings that receive the clock64 phases
// of cluster 0), and clusters of a tile of nb that fit at once: a
// measurement, on no path.
int plu_wide_clk_slots() { return plu::kWideClk; }
#define PLU_WIDE_PROBE(NAME, FIT, T)                                          \
  int NAME(int dev, const T* a, T* f, T* linv, T* uinv, int batch, int nb,  \
           double tol, int lookahead, long long* clk, void* st) {           \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::wide_probe(a, f, linv, uinv, batch, nb, tol, lookahead, clk, \
                           PLU_STREAM(st));                                  \
  }                                                                          \
  int FIT(int dev, int nb, int* fit) {                                       \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    if (nb < 1 || nb > plu::kWideLeaf) return cudaErrorInvalidValue;         \
    return plu::wide_fit<T>(plu::wide_plan<T>(nb).ctas, fit);                \
  }
PLU_WIDE_PROBE(plu_wide_probe_f32, plu_wide_fit_f32, float)
PLU_WIDE_PROBE(plu_wide_probe_f64, plu_wide_fit_f64, double)

// K1 in place on the tiles ids of a store, inverses to invs slots
// inv_ids (K4's diagonal step alone).
#define PLU_DIAG_STEP(NAME, T)                                                \
  int NAME(int dev, T* tiles, T* invs, const int* ids, const int* inv_ids,  \
           int batch, int nb, double tol, int* k1_launches, void* st) {     \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::diag_step(tiles, invs, ids, inv_ids, batch, nb, tol,         \
                          k1_launches, PLU_STREAM(st));                      \
  }
PLU_DIAG_STEP(plu_diag_step_f32, float)
PLU_DIAG_STEP(plu_diag_step_f64, double)

// K2; h_flag and h_lev: chain-ahead tables on the host, or null; side:
// the second stream for the diagonal steps run ahead, or null (the same
// tables on the main stream alone).  counts[3] as plu::mega_levels.
#define PLU_MEGA_FACTORIZE(NAME, T)                                           \
  int NAME(int dev, T* tiles, T* invs, const int* diag_tab, const int* lid,  \
           const int* uid, const int* udst, const int* udl, const int* udu,  \
           const int* h_nl, const int* h_nu, const int* h_nup,               \
           const int* h_flag, const int* h_lev, int bl, int lw, int uw,      \
           int nchunks, int row_w, int uch, int nb, double tol, int* counts, \
           void* st, void* side) {                                           \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_factorize(tiles, invs, diag_tab, lid, uid, udst, udl,   \
                               udu, h_nl, h_nu, h_nup, h_flag, h_lev, bl,    \
                               lw, uw, nchunks, row_w, uch, nb, tol, counts, \
                               PLU_STREAM(st), PLU_STREAM(side));            \
  }
PLU_MEGA_FACTORIZE(plu_mega_factorize_f32, float)
PLU_MEGA_FACTORIZE(plu_mega_factorize_f64, double)

// K3; grid as plu::mega_solve fills it.
#define PLU_MEGA_SOLVE(NAME, T)                                               \
  int NAME(int dev, T* x, T* y, int nrhs, const T* tiles, const T* invs,     \
           const int* lid, const int* lrow, const int* ucid,                 \
           const int* ucrow, const int* nl, const int* nuc,                  \
           const int* h_nl, const int* h_nuc, int bl, int w, int nb,         \
           int* grid, void* st) {                                            \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_solve(x, y, nrhs, tiles, invs, lid, lrow, ucid, ucrow,  \
                           nl, nuc, h_nl, h_nuc, bl, w, nb, grid,            \
                           PLU_STREAM(st));                                  \
  }
PLU_MEGA_SOLVE(plu_mega_solve_f32, float)
PLU_MEGA_SOLVE(plu_mega_solve_f64, double)

#define PLU_MEGA_FACTORIZE_GROUPS(NAME, T)                                    \
  int NAME(int dev, T* tiles, T* invs, const int* gdiag, const int* glev,    \
           const int* gloff, const int* guoff, const int* lid,               \
           const int* uid, const int* udl, const int* udu, const int* dkey,  \
           const int* dptr, const int* dent, const int* h_gs,                \
           const int* h_npl, const int* h_npu, const int* h_ndst,            \
           const int* h_doff, int ng, int gw, int lw, int uw, int nchunks,   \
           int row_w, int uch, int nb, double tol, int* k1_launches,         \
           void* st) {                                                       \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_factorize_groups(                                       \
        tiles, invs, gdiag, glev, gloff, guoff, lid, uid, udl, udu, dkey,    \
        dptr, dent, h_gs, h_npl, h_npu, h_ndst, h_doff, ng, gw, lw, uw,      \
        nchunks, row_w, uch, nb, tol, k1_launches, PLU_STREAM(st));          \
  }
PLU_MEGA_FACTORIZE_GROUPS(plu_mega_factorize_groups_f32, float)
PLU_MEGA_FACTORIZE_GROUPS(plu_mega_factorize_groups_f64, double)

// K5: bar, two unsigned counters of the stream st's own, the first 0
// (each launch leaves it so; used above nb = 128); grid as for K3.
#define PLU_MEGA_SOLVE_GROUPS(NAME, T)                                        \
  int NAME(int dev, T* x, T* y, int nrhs, const T* tiles, const T* invs,     \
           const int* fstep, const int* fitem, const int* fent,              \
           const int* bstep, const int* bitem, const int* bent, int fsteps,  \
           int fwidth, int bsteps, int bwidth, int bl, int nb, unsigned* bar, \
           int* grid, void* st) {                                            \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_solve_groups(x, y, nrhs, tiles, invs, fstep, fitem,     \
                                  fent, bstep, bitem, bent, fsteps, fwidth,  \
                                  bsteps, bwidth, bl, nb, bar, grid,         \
                                  PLU_STREAM(st));                           \
  }
PLU_MEGA_SOLVE_GROUPS(plu_mega_solve_groups_f32, float)
PLU_MEGA_SOLVE_GROUPS(plu_mega_solve_groups_f64, double)

// P6: the tiles ids of the compressed store to dense (to_dense = 1) or
// back (0), an instance by the width of a slot's value in bytes (4:
// float32; 8: float64, complex64; 16: complex128); idx_bytes is the
// width of a slot position (2 or 4); the grid as plu::stage_slots takes
// it.
#define PLU_STAGE_SLOTS(NAME, T)                                              \
  int NAME(int dev, int to_dense, T* values, const void* idx, int idx_bytes, \
           const int* off, const int* cap, const int* ids, int batch, int nb, \
           int rows, int chunks, int span, int spans, T* dense, void* st) {   \
    cudaError_t e = cudaSetDevice(dev);                                       \
    if (e != cudaSuccess) return e;                                           \
    return plu::stage_slots(to_dense != 0, values, idx, idx_bytes, off, cap,  \
                            ids, batch, nb, rows, chunks, span, spans, dense, \
                            PLU_STREAM(st));                                  \
  }
PLU_STAGE_SLOTS(plu_stage_slots_4, plu::SlotWord<4>::T)
PLU_STAGE_SLOTS(plu_stage_slots_8, plu::SlotWord<8>::T)
PLU_STAGE_SLOTS(plu_stage_slots_16, plu::SlotWord<16>::T)

// P2: L^-1 and U^-1 of a batch of factored tiles of any nb: 1 launch up
// to nb = 128, 1 + triangle_tree_levels(nb) above.
#define PLU_TRIANGLE_INVERSES(NAME, T)                                        \
  int NAME(int dev, const T* f, T* linv, T* uinv, int batch, int nb,         \
           double tol, void* st) {                                           \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::triangle_inverses(f, linv, uinv, batch, nb, tol,             \
                                  PLU_STREAM(st));                           \
  }
PLU_TRIANGLE_INVERSES(plu_triangle_inverses_f32, float)
PLU_TRIANGLE_INVERSES(plu_triangle_inverses_f64, double)

// P5: mode 0 scan, 1 dots, 2 both, 3 split (plu::ProbeMode); products
// 0 float64 (DMMA), 1 3xTF32 (plu::ProbeProducts; scan takes 0); modes
// both and split: part holds an n x n float tile a copy, done `copies`
// counters that are 0 (and are 0 again after).
int plu_scan_overlap_f32(int dev, int mode, int products, const float* a,
                         const float* b, float* out, float* part, int* done,
                         int copies, int n, int steps, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::scan_overlap(mode, products, a, b, out, part, done, copies, n,
                           steps, PLU_STREAM(st));
}

// P4: q >= 1 chains; products as for P5 (0 without the dot) on a
// cluster of `cluster` CTAs (4, 8, 16); work holds q + 1 tiles of n x n
// a copy, done `copies` counters that are 0 (and are 0 again after).
int plu_scan_multi_f32(int dev, int q, int with_dot, int products,
                       int cluster, const float* a, const float* b,
                       float* out, float* work, int* done, int copies, int n,
                       int steps, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::scan_multi(q, with_dot != 0, products, cluster, a, b, out,
                         work, done, copies, n, steps, PLU_STREAM(st));
}

// P3: g members of nb <= 128, a cluster of `cluster` CTAs (4, 8, 16)
// each; ws holds 3 float64 128 x 128 matrices a member.
#define PLU_NEWTON_LOOP(NAME, T)                                              \
  int NAME(int dev, const T* lm, T* out, double* ws, int g, int nb,          \
           int steps, int cluster, void* st) {                               \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::newton_loop(lm, out, ws, g, nb, steps, cluster,              \
                            PLU_STREAM(st));                                 \
  }
PLU_NEWTON_LOOP(plu_newton_loop_f32, float)
PLU_NEWTON_LOOP(plu_newton_loop_f64, double)

// ``iters`` cluster barriers on one cluster of 2 <= c <= 16 CTAs: the
// floor of a dependent step of P4's and P3's kernels; on no path.
int plu_cluster_sync_probe(int dev, int c, int iters, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::cluster_sync_probe(c, iters, PLU_STREAM(st));
}

}  // extern "C"
