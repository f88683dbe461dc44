// Hand-written Hopper kernels of the main path: init -> gstrf -> gstrs
// on the dense tile store.  Built with nvcc for sm_90a into a shared
// library with a plain C interface (pangulu_tpu_torch/ops/build.py) and
// called through ctypes (pangulu_tpu_torch/ops/kernels_cuda.py).
//
// Every entry runs on the caller's stream, allocates nothing, never
// synchronises, and returns the first CUDA error (cudaGetLastError after
// each launch), 0 on success.  Tiles are row-major nb x nb, nb <= 256.
//
// K1 getrf_with_inverses
//   Replaces pangulu_tpu/ops/kernels_pallas.py getrf_with_inverses
//   (_getrf_inv_kernel -> _lu_inverses).  One block per tile of the
//   batch; the per-tile body is plu::lu_inverses_tile (tile_lu.cuh),
//   whose note gives the bound and the design: the tile in registers,
//   one barrier per elimination step.  Instances by the register tile
//   a thread holds (nb <= 32, 64, 128).
//   For 128 < nb <= 256 a tile (256 KiB of f32 at 256: a whole SM's
//   registers) does not fit one block's register tile.  The step is
//   blocked instead, as the TPU kernel's _lu_blocked and the C
//   reference's dense GETRF are: split at 128, K1's body on each
//   diagonal block, the panels, the trailing update and the inverses'
//   off-diagonal blocks as tensor-core products (tile_gemm.cuh) between
//   them: five stream-ordered launches, counted as one K1 launch (see
//   "K1, blocked" below).  Bound: still the two dependent chains of
//   128 and nb - 128 steps, plus four product stages' latency.  A
//   thread block cluster holding the whole tile (rows over 2 CTAs in
//   f32, 4 in f64, the pivot row broadcast through distributed shared
//   memory) is the follow-up, ROADMAP W4.
//
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
//   kernel on one tile in place, then panels, then Schur; seven above
//   nb = 128, where the diagonal step is K1's blocked five) read from
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
//   One persistent cooperative launch (or a CUDA graph of this loop),
//   and lookahead of the next diagonal tile, are the follow-ups.
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
//   member (above nb = 128 each stage of K1's blocked step over all
//   members at once; tile ids from gdiag, inverse slots from glev, so
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
//   and the spills cost more than the latency it hid.
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
// (ids ? ids[b] : b) of ``a`` (nb x nb tiles) into the same place of
// ``f`` (which may be ``a``: in place) and writes its inverses to the
// same block of linv/uinv + i * inv_stride, i = (inv_ids ? inv_ids[b] :
// b).  For nb <= 128 the block is the tile (off = 0, n = nb); the
// blocked step for nb > 128 runs it on both diagonal blocks.  The
// batched entry calls it with both tables nullptr; K2's diagonal step
// with one block, ids = &diag_tab[k] and the level's slots of ``invs``;
// K4's with one block per member, ids = the group's diagonal tiles and
// inv_ids = their levels (slots of ``invs`` 2 * nb * nb apart).
// CB = lu_cb(n) sizes the register tile (lu_kernel_for picks it).
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

// K1's instance for an n x n block, with its dynamic shared memory
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
constexpr int kSplit = kLuMaxN;  // 128: K1's split of a larger tile
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
// column band s of U panel uid[k][b-nl] <- L^-1·U.
template <typename T, int NB>
__global__ void __launch_bounds__(kGemmThreads)
    panel_kernel(T* tiles, const T* invs, const int* lid, const int* uid,
                 int lw, int uw, int k, int nl, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t nn = (size_t)nb * nb;
  const int b = blockIdx.x;
  const bool is_l = b < nl;
  const size_t id =
      is_l ? lid[(size_t)k * lw + b] : uid[(size_t)k * uw + b - nl];
  panel_band<T, NB>(tiles + id * nn, invs + (size_t)(2 * k + is_l) * nn,
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
// A tile of 128 < nb <= 256 is split at h = kSplit into [[A11, A12],
// [A21, A22]] (A22 of h2 = nb - h) and factored in place by five
// stream-ordered launches (DiagStep::run): K1's body on A11; the panels
// (lu_panels_kernel); the trailing update and the inverses' first
// products (lu_update_kernel); K1's body on A22; the inverses' second
// products (lu_inverse_kernel).  kernels_torch.getrf_with_inverses_
// blocked is the plain twin, step for step.  Each stage takes a batch:
// blockIdx.y is the member, addressed as getrf_inv_kernel's blockIdx.x.

// Member blockIdx.y of a K1 batch: its tile and inverse slots.
template <typename T>
struct LuMember {
  T *f, *linv, *uinv;
  __device__ LuMember(T* tiles, T* linv0, T* uinv0, size_t inv_stride,
                      const int* ids, const int* inv_ids, int nb) {
    const int b = blockIdx.y;
    f = tiles + (size_t)(ids ? ids[b] : b) * nb * nb;
    const size_t slot = (size_t)(inv_ids ? inv_ids[b] : b) * inv_stride;
    linv = linv0 + slot;
    uinv = uinv0 + slot;
  }
};

// Block x < nbands: row band x of L21 <- A21·U11^-1; else column band
// x - nbands of U12 <- L11^-1·A12 (both in place, as K2's panels).
// nbands = ceil(h2 / 32).  Each block also zeroes its band of the
// inverses' zero blocks: U^-1's lower-left, L^-1's upper-right.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    lu_panels_kernel(T* tiles, T* linv, T* uinv, size_t inv_stride,
                     const int* ids, const int* inv_ids, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const LuMember<T> m(tiles, linv, uinv, inv_stride, ids, inv_ids, nb);
  constexpr int h = kSplit;
  const int h2 = nb - h, nbands = (h2 + kBand - 1) / kBand;
  const bool is_l = blockIdx.x < nbands;
  const int b0 = (is_l ? blockIdx.x : blockIdx.x - nbands) * kBand;
  const int bw = min(kBand, h2 - b0);
  if (is_l) {
    const Mat<T> a21 = block_of(m.f, nb, h, 0, h2, h);
    tile_gemm<LBand<T, kSplit>, kStore>(a21, block_of(m.uinv, nb, 0, 0, h, h),
                                        a21, b0, 0, smem);
    for (int e = threadIdx.x; e < bw * h; e += kGemmThreads)
      m.uinv[(size_t)(h + b0 + e / h) * nb + e % h] = T(0);
  } else {
    const Mat<T> a12 = block_of(m.f, nb, 0, h, h, h2);
    tile_gemm<UBand<T, kSplit>, kStore>(block_of(m.linv, nb, 0, 0, h, h), a12,
                                        a12, 0, b0, smem);
    for (int e = threadIdx.x; e < h * bw; e += kGemmThreads)
      m.linv[(size_t)(e / bw) * nb + h + b0 + e % bw] = T(0);
  }
}

// 64 x 64 quadrant jobs, qd = ceil(h2 / 64): x < qd^2: A22 -= L21·U12;
// then 2 qd of L^-1's lower-left block <- -L21·L11^-1 (W); then 2 qd of
// U^-1's upper-right block <- -U11^-1·U12 (V).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    lu_update_kernel(T* tiles, T* linv, T* uinv, size_t inv_stride,
                     const int* ids, const int* inv_ids, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const LuMember<T> m(tiles, linv, uinv, inv_stride, ids, inv_ids, nb);
  constexpr int h = kSplit, hq = kSplit / kQuad;
  const int h2 = nb - h, qd = (h2 + kQuad - 1) / kQuad;
  const Mat<T> l21 = block_of(m.f, nb, h, 0, h2, h);
  const Mat<T> u12 = block_of(m.f, nb, 0, h, h, h2);
  int j = blockIdx.x;
  if (j < qd * qd) {
    tile_gemm<Quad<T>, kSubtract>(l21, u12, block_of(m.f, nb, h, h, h2, h2),
                                  j / qd * kQuad, j % qd * kQuad, smem);
  } else if ((j -= qd * qd) < qd * hq) {
    tile_gemm<Quad<T>, kNegate>(l21, block_of(m.linv, nb, 0, 0, h, h),
                                block_of(m.linv, nb, h, 0, h2, h),
                                j / hq * kQuad, j % hq * kQuad, smem);
  } else {
    j -= qd * hq;
    tile_gemm<Quad<T>, kNegate>(block_of(m.uinv, nb, 0, 0, h, h), u12,
                                block_of(m.uinv, nb, 0, h, h, h2),
                                j / qd * kQuad, j % qd * kQuad, smem);
  }
}

// Block x < h / 32: column band x of L^-1's lower-left block <-
// L22^-1·W; else row band x - h / 32 of U^-1's upper-right block <-
// V·U22^-1 (both in place: a band reads only itself).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    lu_inverse_kernel(T* tiles, T* linv, T* uinv, size_t inv_stride,
                      const int* ids, const int* inv_ids, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const LuMember<T> m(tiles, linv, uinv, inv_stride, ids, inv_ids, nb);
  constexpr int h = kSplit, nbands = kSplit / kBand;
  const int h2 = nb - h;
  if (blockIdx.x < nbands) {
    const Mat<T> w = block_of(m.linv, nb, h, 0, h2, h);
    tile_gemm<UBand<T, kSplit>, kStore>(block_of(m.linv, nb, h, h, h2, h2), w,
                                        w, 0, blockIdx.x * kBand, smem);
  } else {
    const Mat<T> v = block_of(m.uinv, nb, 0, h, h, h2);
    tile_gemm<LBand<T, kSplit>, kStore>(v, block_of(m.uinv, nb, h, h, h2, h2),
                                        v, (blockIdx.x - nbands) * kBand, 0,
                                        smem);
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
// are in flight at once.  Tiles of NB = 256 take two passes of 128 rows
// with the registers of one.  With XG, xs is x in global memory, read
// through L2 by each lane (no shared copy, no barrier before the sum).
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
// instance a tile width NB >= nb: 128 and 256.
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
// Tiles of NB = 256 take two passes of 128 rows, each over all the
// entries, with the registers of one (tile_matvec).
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
// each): only x has to wait for the barrier.  One instance a tile width
// NB >= nb: 128 and 256.
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

// K1 for tiles of one nb: its instances picked and opted in once
// (init), then launched per batch (run), in one launch for nb <= 128,
// in the five of the blocked step above it.
template <typename T>
struct DiagStep {
  int nb, h2;
  LuKernel<T> lu, lu2;  // K1's body on the tile (or A11), and on A22
  size_t smem, smem2;

  cudaError_t init(int nb_) {
    nb = nb_;
    h2 = nb - kSplit;
    cudaError_t e = lu_kernel_for<T>(nb <= kSplit ? nb : kSplit, &lu);
    smem = lu_smem_bytes<T>(nb <= kSplit ? nb : kSplit);
    if (e != cudaSuccess || nb <= kSplit) return e;
    if ((e = lu_kernel_for<T>(h2, &lu2)) != cudaSuccess) return e;
    smem2 = lu_smem_bytes<T>(h2);
    const size_t psm = panel_smem_bytes<T, kSplit>();
    if ((e = products_for(lu_panels_kernel<T>, lu_update_kernel<T>, psm,
                          schur_smem_bytes<T>())) != cudaSuccess)
      return e;
    return cudaFuncSetAttribute(lu_inverse_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)psm);
  }

  // ``batch`` tiles (ids, inv_ids and inv_stride as getrf_inv_kernel)
  // from a into f.  Above 128, a != f only from the batched entry
  // (ids == nullptr: the batch is contiguous), which copies a to f
  // first; every stage then runs in place.  counts[0] += 1 when the
  // whole step was launched (one K1 launch), counts[1] += each device
  // launch it made (1 up to nb = 128, 5 above).
  cudaError_t run(const T* a, T* f, T* linv, T* uinv, size_t inv_stride,
                  const int* ids, const int* inv_ids, int batch, T tol,
                  int* counts, cudaStream_t st) const {
    cudaError_t e;
    auto launched = [counts]() {
      const cudaError_t le = cudaGetLastError();
      counts[1] += le == cudaSuccess;
      return le;
    };
    if (nb <= kSplit) {
      lu<<<batch, kLuThreads, smem, st>>>(a, f, linv, uinv, inv_stride, ids,
                                          inv_ids, nb, 0, nb, tol);
      if ((e = launched()) != cudaSuccess) return e;
      ++counts[0];
      return cudaSuccess;
    }
    if (a != f &&
        (e = cudaMemcpyAsync(f, a, sizeof(T) * batch * nb * nb,
                             cudaMemcpyDeviceToDevice, st)) != cudaSuccess)
      return e;
    const int nbands = (h2 + kBand - 1) / kBand, qd = (h2 + kQuad - 1) / kQuad;
    const size_t psm = panel_smem_bytes<T, kSplit>();
    lu<<<batch, kLuThreads, smem, st>>>(f, f, linv, uinv, inv_stride, ids,
                                        inv_ids, nb, 0, kSplit, tol);
    if ((e = launched()) != cudaSuccess) return e;
    lu_panels_kernel<T><<<dim3(2 * nbands, batch), kGemmThreads, psm, st>>>(
        f, linv, uinv, inv_stride, ids, inv_ids, nb);
    if ((e = launched()) != cudaSuccess) return e;
    lu_update_kernel<T>
        <<<dim3(qd * qd + 2 * qd * (kSplit / kQuad), batch), kGemmThreads,
           schur_smem_bytes<T>(), st>>>(f, linv, uinv, inv_stride, ids,
                                        inv_ids, nb);
    if ((e = launched()) != cudaSuccess) return e;
    lu2<<<batch, kLuThreads, smem2, st>>>(f, f, linv, uinv, inv_stride, ids,
                                          inv_ids, nb, kSplit, h2, tol);
    if ((e = launched()) != cudaSuccess) return e;
    lu_inverse_kernel<T>
        <<<dim3(2 * (kSplit / kBand), batch), kGemmThreads, psm, st>>>(
            f, linv, uinv, inv_stride, ids, inv_ids, nb);
    if ((e = launched()) != cudaSuccess) return e;
    ++counts[0];
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

template <typename T>
int mega_factorize(T* tiles, T* invs, const int* diag_tab, const int* lid,
                   const int* uid, const int* udst, const int* udl,
                   const int* udu, const int* h_nl, const int* h_nu,
                   const int* h_nup, int bl, int lw, int uw, int nchunks,
                   int row_w, int uch, int nb, double tol, int* k1_launches,
                   cudaStream_t st) {
  DiagStep<T> diag;
  cudaError_t e = diag.init(nb);
  if (e != cudaSuccess) return e;
  const PanelKernels<T> pk(nb);
  const size_t psm = pk.smem, ssm = schur_smem_bytes<T>();
  if ((e = products_for(pk.chain, schur_kernel<T>, psm, ssm)) != cudaSuccess)
    return e;
  const size_t nn = (size_t)nb * nb;
  const int qdim = (nb + kQuad - 1) / kQuad, bands = (nb + kBand - 1) / kBand;
  for (int k = 0; k < bl; ++k) {
    // diagonal step: K1 on tile diag_tab[k], in place; its launches are
    // reported to the wrapper through k1_launches
    T* linv = invs + (size_t)(2 * k) * nn;
    if ((e = diag.run(tiles, tiles, linv, linv + nn, 0, diag_tab + k,
                      nullptr, 1, (T)tol, k1_launches, st)) != cudaSuccess)
      return e;
    const int np = h_nl[k] + h_nu[k];
    if (np > 0) {
      pk.chain<<<dim3(np, bands), kGemmThreads, psm, st>>>(
          tiles, invs, lid, uid, lw, uw, k, h_nl[k], nb);
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

// One sweep: h_n (host copy of cnt) sizes the grid to the widest
// level's item count, capped at what fits on the card.
template <typename T>
int sweep(T* src, T* dst, int nrhs, const T* tiles, const T* invs, int slot,
          const int* ids, const int* rows, const int* cnt, const int* h_n,
          int bl, int w, int nb, int descending, cudaStream_t st) {
  int widest = 1;
  for (int k = 0; k < bl; ++k) widest = h_n[k] > widest ? h_n[k] : widest;
  void* args[] = {&src,  &dst, &nrhs, &tiles, &invs, &slot,      &ids,
                  &rows, &cnt, &bl,   &w,     &nb,   &descending};
  int blocks;
  return launch_cooperative(nb <= kSplit ? solve_sweep_kernel<T, kSplit>
                                         : solve_sweep_kernel<T, kMaxNb>,
                            widest * nrhs, args, st, &blocks);
}

// x: the right-hand sides on entry, the solution on exit; y: scratch of
// x's shape that holds the forward sweep's result (the backward sweep
// reads it and writes x).
template <typename T>
int mega_solve(T* x, T* y, int nrhs, const T* tiles, const T* invs,
               const int* lid, const int* lrow, const int* ucid,
               const int* ucrow, const int* nl, const int* nuc,
               const int* h_nl, const int* h_nuc, int bl, int w, int nb,
               cudaStream_t st) {
  int e = sweep(x, y, nrhs, tiles, invs, 0, lid, lrow, nl, h_nl, bl, w, nb,
                0, st);
  if (e != cudaSuccess) return e;
  return sweep(y, x, nrhs, tiles, invs, 1, ucid, ucrow, nuc, h_nuc, bl, w,
               nb, 1, st);
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

// One sweep of K5: nsteps steps of at most ``width`` items (host
// values) size the grid, capped at what fits on the card.
template <typename T>
int group_sweep(T* src, T* dst, int nrhs, const T* tiles, const T* invs,
                int slot, const int* step, const int* item, const int* ent,
                int nsteps, int width, int bl, int nb, cudaStream_t st,
                int* blocks, int* per_sm) {
  const int2* step2 = reinterpret_cast<const int2*>(step);
  const int4* item4 = reinterpret_cast<const int4*>(item);
  const int2* ent2 = reinterpret_cast<const int2*>(ent);
  void* args[] = {&src,  &dst,   &nrhs, &tiles,  &invs, &slot,
                  &step2, &item4, &ent2, &nsteps, &bl,   &nb};
  return launch_cooperative(nb <= kSplit ? group_sweep_kernel<T, kSplit>
                                         : group_sweep_kernel<T, kMaxNb>,
                            width * nrhs, args, st, blocks, per_sm);
}

// x: the right-hand sides on entry, the solution on exit; y: scratch of
// x's shape that holds the forward sweep's result (the backward sweep
// reads it and writes x).  grid[0], grid[1]: the blocks of the forward
// and backward launch; grid[2]: the blocks an SM holds.
template <typename T>
int mega_solve_groups(T* x, T* y, int nrhs, const T* tiles, const T* invs,
                      const int* fstep, const int* fitem, const int* fent,
                      const int* bstep, const int* bitem, const int* bent,
                      int fsteps, int fwidth, int bsteps, int bwidth, int bl,
                      int nb, int* grid, cudaStream_t st) {
  int e = group_sweep(x, y, nrhs, tiles, invs, 0, fstep, fitem, fent, fsteps,
                      fwidth, bl, nb, st, &grid[0], &grid[2]);
  if (e != cudaSuccess) return e;
  return group_sweep(y, x, nrhs, tiles, invs, 1, bstep, bitem, bent, bsteps,
                     bwidth, bl, nb, st, &grid[1], nullptr);
}

}  // namespace plu

// ------------------------------------------------------ C interface
#define PLU_STREAM(s) reinterpret_cast<cudaStream_t>(s)

extern "C" {

// Bumped with every change of an entry's signature; kernels_cuda.py
// checks it at load.
int plu_kernels_abi() { return 9; }

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

#define PLU_MEGA_FACTORIZE(NAME, T)                                           \
  int NAME(int dev, T* tiles, T* invs, const int* diag_tab, const int* lid,  \
           const int* uid, const int* udst, const int* udl, const int* udu,  \
           const int* h_nl, const int* h_nu, const int* h_nup, int bl,       \
           int lw, int uw, int nchunks, int row_w, int uch, int nb,          \
           double tol, int* k1_launches, void* st) {                         \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_factorize(tiles, invs, diag_tab, lid, uid, udst, udl,   \
                               udu, h_nl, h_nu, h_nup, bl, lw, uw, nchunks,  \
                               row_w, uch, nb, tol, k1_launches,             \
                               PLU_STREAM(st));                              \
  }
PLU_MEGA_FACTORIZE(plu_mega_factorize_f32, float)
PLU_MEGA_FACTORIZE(plu_mega_factorize_f64, double)

#define PLU_MEGA_SOLVE(NAME, T)                                               \
  int NAME(int dev, T* x, T* y, int nrhs, const T* tiles, const T* invs,     \
           const int* lid, const int* lrow, const int* ucid,                 \
           const int* ucrow, const int* nl, const int* nuc,                  \
           const int* h_nl, const int* h_nuc, int bl, int w, int nb,         \
           void* st) {                                                       \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_solve(x, y, nrhs, tiles, invs, lid, lrow, ucid, ucrow,  \
                           nl, nuc, h_nl, h_nuc, bl, w, nb, PLU_STREAM(st)); \
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

#define PLU_MEGA_SOLVE_GROUPS(NAME, T)                                        \
  int NAME(int dev, T* x, T* y, int nrhs, const T* tiles, const T* invs,     \
           const int* fstep, const int* fitem, const int* fent,              \
           const int* bstep, const int* bitem, const int* bent, int fsteps,  \
           int fwidth, int bsteps, int bwidth, int bl, int nb, int* grid,    \
           void* st) {                                                       \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_solve_groups(x, y, nrhs, tiles, invs, fstep, fitem,     \
                                  fent, bstep, bitem, bent, fsteps, fwidth,  \
                                  bsteps, bwidth, bl, nb, grid,              \
                                  PLU_STREAM(st));                           \
  }
PLU_MEGA_SOLVE_GROUPS(plu_mega_solve_groups_f32, float)
PLU_MEGA_SOLVE_GROUPS(plu_mega_solve_groups_f64, double)

// P6: the tiles ids of the compressed store to dense (to_dense = 1) or
// back (0); idx_bytes is the width of a slot position (2 or 4).
#define PLU_STAGE_SLOTS(NAME, T)                                              \
  int NAME(int dev, int to_dense, T* values, const void* idx, int idx_bytes, \
           const int* off, const int* cap, const int* ids, int batch, int nb, \
           T* dense, void* st) {                                              \
    cudaError_t e = cudaSetDevice(dev);                                       \
    if (e != cudaSuccess) return e;                                           \
    return plu::stage_slots(to_dense != 0, values, idx, idx_bytes, off, cap,  \
                            ids, batch, nb, dense, PLU_STREAM(st));           \
  }
PLU_STAGE_SLOTS(plu_stage_slots_f32, float)
PLU_STAGE_SLOTS(plu_stage_slots_f64, double)

// P2: L^-1 and U^-1 of a batch of factored tiles; work holds 6 tiles a
// member.
#define PLU_NEWTON_INVERSES(NAME, T)                                          \
  int NAME(int dev, const T* f, T* linv, T* uinv, T* work, int batch, int nb, \
           int steps, double tol, void* st) {                                 \
    cudaError_t e = cudaSetDevice(dev);                                       \
    if (e != cudaSuccess) return e;                                           \
    return plu::newton_inverses(f, linv, uinv, work, batch, nb, steps, tol,   \
                                PLU_STREAM(st));                              \
  }
PLU_NEWTON_INVERSES(plu_newton_inverses_f32, float)
PLU_NEWTON_INVERSES(plu_newton_inverses_f64, double)

// P5: mode 0 scan, 1 dots, 2 both, 3 split (plu::ProbeMode); products
// 0 float64 (DMMA), 1 3xTF32 (plu::ProbeProducts; scan takes 0); work
// holds 3 tiles of the products' type a copy.
int plu_scan_overlap_f32(int dev, int mode, int products, const float* a,
                         const float* b, float* out, void* work, int copies,
                         int n, int steps, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::scan_overlap(mode, products, a, b, out, work, copies, n, steps,
                           PLU_STREAM(st));
}

// P4: q in {1, 2, 4, 8}; products as for P5 (0 without the dot); work
// holds 3 tiles a copy, mem q - 2 chains of 128 x 128 a copy.
int plu_scan_multi_f32(int dev, int q, int with_dot, int products,
                       const float* a, const float* b, float* out, void* work,
                       float* mem, int copies, int n, int steps, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::scan_multi(q, with_dot != 0, products, a, b, out, work, mem,
                         copies, n, steps, PLU_STREAM(st));
}

// P3: work holds 4 f64 tiles a block.
#define PLU_NEWTON_LOOP(NAME, T)                                              \
  int NAME(int dev, const T* lm, T* out, double* work, int g, int nb,        \
           int steps, int blocks, void* st) {                                \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::newton_loop(lm, out, work, g, nb, steps, blocks,             \
                            PLU_STREAM(st));                                 \
  }
PLU_NEWTON_LOOP(plu_newton_loop_f32, float)
PLU_NEWTON_LOOP(plu_newton_loop_f64, double)

}  // extern "C"
