// K1 for tiles wider than 256: getrf_with_inverses at nb > kMaxNb.
//
// Replaces pangulu_tpu/ops/kernels_pallas.py getrf_with_inverses
// (_getrf_inv_kernel -> _lu_inverses, pallas_call at :605) for the tiles
// the JAX package's fused and levels engines give it above 256: one
// [nb, nb] tile in, (f, L^-1, U^-1) out.  The TPU kernel holds the tile
// in VMEM; its MXU mode (_lu_blocked, r = 32, :261) runs in panels of 32.
//
// Up to nb = kWideLeaf = 512 a call is one launch, lu_wide_kernel: a
// thread block cluster a tile of the batch, ceil(nb / 32) CTAs of 32
// rows each (9 at 288, 16 at 512: above 8, the card's non-portable
// cluster sizes).  W, the tile padded with the identity to the cluster's
// rows, lives in the CTAs' shared memory, each CTA its own rows.  The
// step is K1's cluster kernel at nb = 256 (lu_cluster_kernel; its note
// in lu_kernels.cu gives the blocked Gauss–Jordan) run over the whole
// tile: per panel P of 32 columns the owner's warp factors the diagonal
// block (diag_panel), every CTA forms a_i = W[i, P]·U11^-1 for its rows
// and W[i, j] -= a_i·R[:, j], R = L11^-1·(the panel's rows).  What the
// wider tile changes:
//   - A CTA holds one panel's height of rows, so its 8 warps split
//     columns.  The panel's rows go through L2: their owner writes them
//     to staging rows (UI's rows P, which the final store overwrites),
//     and each warp reads its own 32-column stripes of them straight
//     into registers as tensor-core fragments, forms its stripe of R in
//     a shared buffer of its own and updates its stripe of W.  No block
//     barrier between stripes, and R never sits whole in a CTA: at 512
//     in double it would take 128 KiB beside W's 129 KiB, over the 227
//     KB a block may have.  No CTA reads another's shared memory.  (R
//     formed once by the owner and staged measured slower: its product
//     and 130 KB of stores a panel then sit on the chain; PERF.md.)
//   - Lookahead: in the owner of panel p + 1, warps 0-3 update that
//     panel's stripe first, 8 columns each, and meet at a named barrier;
//     then warp 0 factors panel p + 1's diagonal block while the other
//     warps finish panel p.  The rows of panel p + 1 go to staging as
//     their stripes finish.  (Warp 0 alone on that stripe, warp 4 idle
//     beside the diagonal warp, the other warps held until the stripe
//     is done, and its loads issued at the cluster barrier all measured
//     slower: tools/probe_k1_wide.py, PERF.md.  The lookahead modes
//     stay a run-time argument: the float instance sits at 254 of 255
//     registers, and the same kernel without the modes spilled.)
//   - One cluster barrier a panel (its staging rows complete) and one
//     before the final store.
// Bound on an H100 at nb = 512 in float, batch 1: the tile read once
// and f, L^-1 and U^-1 written once, 4 MiB, 1.3e-03 ms at 3.35 TB/s;
// ~1.8e8 operations (lu_inverse_flop), 2.7e-03 ms at 67 TFLOP/s, less
// on tensor cores.  In fact the chain of 16 panels, each the diagonal
// warp's 32 dependent steps (~10K cycles in f32, ~18K in f64; PERF.md),
// a cluster barrier, the diagonal block's load through L2, the a_i and
// the stripe of panel p + 1; PERF.md gives the clock64 phases
// (tools/probe_k1_wide.py).
//
// From 512 to W_T (flow_max_nb: 1408 in float, 1120 in double, the
// widest tile whose rows fit a CTA's shared memory) a call is one
// cooperative launch of lu_flow_kernel: the same panel step and the same
// arithmetic (its bits are lu_wide_kernel's where both run), on ceil(nb /
// 32) CTAs of 32 rows (float) or twice as many of 16 (double: 32 rows
// of 544 already pass a block's shared memory) a tile, every tile of the
// batch at once, one CTA an SM.  A batch whose tiles do not all fit (4
// at 1088 in float: 136 CTAs on 132 SMs) takes the recursion below on
// narrower leaves (flow_leaf): a second round of the same CTAs would
// cost a whole tile's chain.  (The kernel can run rounds, tiles b, b +
// S, ...: flow_probe times them.)  Ready flags in global memory do what
// the cluster's barrier did, so that no CTA waits for the slowest one
// each panel:
//   - the owner of panel p + 1 publishes each 32-column stripe of its
//     staging rows as it finishes panel p (the diagonal block's once
//     factored): a flag a (tile in flight, panel, stripe, CTA of the
//     panel), set with a release store to the launch's epoch plus its
//     round, so that no call clears them (K3's grid-barrier pair is kept
//     the same way, a pair a device and stream);
//   - each stripe s of R = L11^-1·(the panel's staging rows) is formed
//     once, by the first CTA of panel s's rows (stripe p + 1 by the next
//     owner's lookahead, which forms it anyway), into L^-1's rows P, and
//     flagged; every CTA applies each stripe once its flag is set.  R
//     formed by each warp, as lu_wide_kernel does, took half of every
//     CTA's work a panel; formed by the owner alone, it waited for the
//     owner's other work (tools/probe_k1_wide.py, PERF.md);
//   - in the next panel's owner, up to FlowDiagAlone panels, warp 4 (on
//     the diagonal warp's sub-partition) takes no stripe: the diagonal
//     block runs ~1.1x faster beside one warp less, which pays where its
//     chain bounds the tile and costs where the stripes do (wide float
//     tiles);
//   - every CTA of a set waits for the others once, before the final
//     store overwrites the staging rows and the rows of R.
// With two CTAs a panel (double) each publishes its half of the staging
// rows; the first waits for the second's half of the diagonal block
// (cp.async through L2), factors it in warp 0's stripe buffer and
// publishes it whole.  A flag that stays unset traps (flow_wait): the
// launch fails instead of hanging.  The bound is the chain of diagonal
// blocks, each the diagonal warp's 32 dependent steps (~18K cycles in
// float, ~29K in double, PERF.md), and in wide float tiles each CTA's
// stripes a panel (~34 of ~4.5K cycles a warp at 1088).
//
// Above the leaf width (flow_leaf: W_T where the batch fits on the card
// at once, else the widest width at which it does, or 512) the tile is
// factored by the recursive block step of the JAX package's XLA
// diagonal step (pangulu_tpu/ops/kernels_jax.py: 200-248), split at
// wide_split (the JAX _split: about half, a multiple of 32), with the
// flow kernel (the cluster kernel up to 512) on the leaves, read and
// written in place as blocks of the tile:
//   1. (F11, L11^-1, U11^-1) of A11: one launch on the block, or
//      recursively when A11 is wider than the leaf;
//   2. U12 = L11^-1·A12 and L21 = A21·U11^-1 (one launch, two products);
//   3. S22 = A22 - L21·U12 into a scratch block (a copy, then a product);
//   4. (F22, L22^-1, U22^-1) of S22, as step 1;
//   5. Tl = L21·L11^-1 and Tu = U12·U22^-1, then L^-1[2, 1] = -L22^-1·Tl
//      and U^-1[1, 2] = -U11^-1·Tu (two launches of two products).
// The products are tile_gemm's 64 x 64 windows on tensor cores (3xTF32
// for float, DMMA for double), as in K2's Schur stage, on strided
// blocks.  L^-1's and U^-1's zero blocks are written with the copy of
// A22.  A call counts as one K1 launch, its device launches beside it
// (kernels_cuda.k1_device_launches): 1 on one leaf, 7 on two.
//
// The plain twin is kernels_torch.getrf_with_inverses_blocked on a leaf
// and kernels_torch.getrf_with_inverses_wide on the same leaves above
// (kernels_torch.k1_wide).
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace plu {

// ---------------------------------------------- the cluster kernel
constexpr int kWideLeaf = 512;  // the widest tile one cluster takes
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideMaxCtas = 16;  // the card's largest cluster
// lookahead on the main path (lu_wide_kernel's note): 2, warps 0-3
// update the next panel's stripe before warp 0 factors its block; 1
// (warp 0 alone) and 0 (none) only in measurements
constexpr int kWideLookahead = 2;
// clock64 readings a CTA of a timed launch: start, tile loaded, 8 a
// panel (top, barrier passed, L11^-1 and U11^-1 loaded, a_i formed,
// warp 0's stripes done, panel done, diagonal block start and end),
// after the loop, end
constexpr int kWideClkPanel = 8;
constexpr int kWideClk = 4 + kWideClkPanel * (kWideLeaf / kPanel);

// Rows a CTA holds, by type (kernels_cuda.WIDE_ROWS mirrors it).
template <typename T>
struct WideRows {
  static constexpr int value = 32;
};

// The shared memory of a CTA (elements of T): W (its RPC rows of the
// padded tile, ldw apart: np + 4 keeps A fragments free of bank
// conflicts), L11^-1, the rows' a_i, a 32 x 32 stripe of R a warp (U11^-1
// sits in warp 0's while the a_i form) and the diagonal warp's two
// broadcast rows.
template <typename T, int RPC>
struct WideCluster {
  using Mt = Mma<T>;
  static_assert(RPC % kPanel == 0 || kPanel % RPC == 0,
                "whole panels a CTA, or whole CTAs a panel");
  static constexpr int MF = RPC / Mt::M;     // MMA row blocks of the rows
  static constexpr int PF = kPanel / Mt::M;  // and of a panel
  static constexpr int KS = kPanel / Mt::K;  // k steps of a panel
  static constexpr int BE = Mt::K / 4;  // B values a lane a (k step, n)
  static constexpr int LDA = kPanel + Mt::PAD_A;  // L11^-1, a_i
  static constexpr int LDS = kPanel + Mt::PAD_B;  // R's stripes, U11^-1
  __host__ __device__ static constexpr int ldw(int np) { return np + 4; }
  __host__ __device__ static constexpr size_t smem_bytes(int np) {
    return ((size_t)RPC * ldw(np) + (size_t)(kPanel + RPC) * LDA +
            (size_t)kWideWarps * kPanel * LDS + 2 * kRowBuf) *
           sizeof(T);
  }
};

// The launch's plan for a tile of n: CTAs a cluster, rows a CTA, dynamic
// shared memory a CTA, columns of a warp's stripe.
struct WidePlan {
  int ctas, rows, smem, stripe;
};
template <typename T>
WidePlan wide_plan(int n) {
  constexpr int R = WideRows<T>::value;
  const int cl = (n + R - 1) / R;
  return {cl, R, (int)WideCluster<T, R>::smem_bytes(cl * R), kPanel};
}

// One launch: tiles of n x n at a + b * sa (row stride lda) into f,
// linv, uinv + b * so (row stride ldo); f may not be a.
template <typename T>
struct WideTile {
  const T* a;
  T* f;
  T* linv;
  T* uinv;
  size_t sa, so;
  int lda, ldo, n;
  T tol;
  int lookahead;
  long long* clk;  // kWideClk readings a CTA of cluster 0, or nullptr
};

// B fragments from a lane's values: rows t (and t + 4) of a k step.
__device__ __forceinline__ void bfrag_of(Mma<float>::BFrag& f,
                                         const float (&v)[2]) {
  split_tf32(v[0], f.big[0], f.small[0]);
  split_tf32(v[1], f.big[1], f.small[1]);
}
__device__ __forceinline__ void bfrag_of(Mma<double>::BFrag& f,
                                         const double (&v)[1]) {
  f.v = v[0];
}

// By one warp: the panel's staging rows S (row stride ld: the rows of
// panel k0), columns [c, c + 8 NFW), as B fragments of the lane, through
// L2; outside the tile, the padding's identity.
template <typename T, int RPC, int NFW>
__device__ __forceinline__ void load_stripe(
    T (&v)[WideCluster<T, RPC>::KS][NFW][WideCluster<T, RPC>::BE],
    const T* S, int ld, int k0, int c, int n) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int e = 0; e < C::BE; ++e) {
        const int i = kk * Mt::K + (lane & 3) + 4 * e;
        const int j = c + nf * Mt::N + (lane >> 2);
        v[kk][nf][e] = k0 + i < n && j < n ? __ldcg(S + (size_t)i * ld + j)
                                           : T(k0 + i == j ? 1 : 0);
      }
}

// By one warp, columns [c, c + 8 NFW) of stripe s at panel p (its
// first column k0): W[i, c..] -= a_i·R[:, c..] for the CTA's rows below
// P, and right of P for the rest, with R = L11^-1·(the staging rows S),
// or L11^-1 itself on stripe p, formed in the warp's buffer Rw; the
// owner of P (mine, its rows at lr) makes its rows X_PD left of P
// (L^-1's rows P) and 0 right of it (U^-1's rows P start there), with
// U12 to the factor.
template <typename T, int RPC, int NFW>
__device__ __forceinline__ void wide_stripe(T* W, int ldw, const T* Lb,
                                            const T* Ab, T* Rw, T* F,
                                            const T* S, int ld, int r0,
                                            int k0, int lr, bool mine, int s,
                                            int p, int c, int n) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  constexpr int NW = NFW * Mt::N;  // columns
  const int lane = threadIdx.x & 31, kb = k0 + kPanel;
  if (s == p) {
    for (int e = lane; e < kPanel * NW; e += 32)
      Rw[e / NW * C::LDS + e % NW] = Lb[e / NW * C::LDA + c - k0 + e % NW];
  } else {
    T raw[C::KS][NFW][C::BE];
    load_stripe<T, RPC, NFW>(raw, S, ld, k0, c, n);
    T acc[C::PF][NFW][Mt::NC];
#pragma unroll
    for (int m = 0; m < C::PF; ++m)
#pragma unroll
      for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) acc[m][nf][i] = T(0);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      typename Mt::AFrag fa[C::PF];
      typename Mt::BFrag fb[NFW];
#pragma unroll
      for (int m = 0; m < C::PF; ++m)
        Mt::load_a(fa[m], Lb, C::LDA, m * Mt::M, kk * Mt::K);
#pragma unroll
      for (int nf = 0; nf < NFW; ++nf) bfrag_of(fb[nf], raw[kk][nf]);
#pragma unroll
      for (int m = 0; m < C::PF; ++m)
#pragma unroll
        for (int nf = 0; nf < NFW; ++nf) Mt::step(acc[m][nf], fa[m], fb[nf]);
    }
#pragma unroll
    for (int m = 0; m < C::PF; ++m)
#pragma unroll
      for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) {
          const int r = m * Mt::M + Mt::row(i);
          const int j = nf * Mt::N + Mt::col(i);
          const T v = acc[m][nf][i];
          Rw[r * C::LDS + j] = v;
          if constexpr (RPC < kPanel) {
            if (lr + r < 0 || lr + r >= RPC) continue;
          }
          if (mine) {
            W[(size_t)(lr + r) * ldw + c + j] = s < p ? v : T(0);
            if (s > p && k0 + r < n && c + j < n)
              F[(size_t)(k0 + r) * ld + c + j] = v;
          }
        }
  }
  __syncwarp();
#pragma unroll
  for (int mf = 0; mf < C::MF; ++mf) {
    if (r0 + mf * Mt::M < kb && s <= p) continue;
    T u[NFW][Mt::NC];
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int i = 0; i < Mt::NC; ++i) u[nf][i] = T(0);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      typename Mt::AFrag fa;
      Mt::load_a(fa, Ab, C::LDA, mf * Mt::M, kk * Mt::K);
#pragma unroll
      for (int nf = 0; nf < NFW; ++nf) {
        typename Mt::BFrag fb;
        Mt::load_b(fb, Rw, C::LDS, kk * Mt::K, nf * Mt::N);
        Mt::step(u[nf], fa, fb);
      }
    }
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int i = 0; i < Mt::NC; ++i)
        W[(size_t)(mf * Mt::M + Mt::row(i)) * ldw + c + nf * Mt::N +
          Mt::col(i)] -= u[nf][i];
  }
  __syncwarp();
}

// By one warp: rows [i0, i1) of the panel at k0 (W's rows lr + i),
// columns [c, c + 32), to their staging rows S (row stride ld); only the
// tile's rows and columns (< n).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* W, int ldw, int lr,
                                           T* S, int ld, int k0, int c,
                                           int n, int i0, int i1) {
  const int j = c + (threadIdx.x & 31);
  if (j >= n) return;
  for (int i = i0; i < i1 && k0 + i < n; ++i)
    S[(size_t)i * ld + j] = W[(size_t)(lr + i) * ldw + j];
}

// The same for all 32 rows of the panel (W's rows [lr, lr + 32)).
template <typename T>
__device__ __forceinline__ void stage_block(const T* W, int ldw, int lr,
                                            T* S, int ld, int k0, int c,
                                            int n) {
  stage_rows(W, ldw, lr, S, ld, k0, c, n, 0, kPanel);
}

// Cluster y: tile y of the batch; its gridDim.x CTAs of RPC rows each.
template <typename T, int RPC>
__global__ void __launch_bounds__(kWideThreads, 1)
    lu_wide_kernel(const WideTile<T> t) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  using Q = Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = t.n, ld = t.ldo;
  const int np = gridDim.x * RPC, ldw = C::ldw(np);
  T* W = reinterpret_cast<T*>(smem_raw);
  T* Lb = W + (size_t)RPC * ldw;  // L11^-1: unit lower, 0 above
  T* Ab = Lb + kPanel * C::LDA;   // a_i of the CTA's rows
  T* Rs = Ab + RPC * C::LDA;      // the warps' stripes of R
  T* rowbuf = Rs + kWideWarps * kPanel * C::LDS;
  T* Ub = Rs;  // U11^-1 (0 below), until the stripes start
  const int rank = (int)cg::this_cluster().block_rank();
  const int r0 = rank * RPC;
  const int warp = threadIdx.x >> 5;
  T* Rw = Rs + warp * kPanel * C::LDS;
  const size_t b = blockIdx.y;
  const T* A = t.a + b * t.sa;
  T* F = t.f + b * t.so;
  T* LI = t.linv + b * t.so;
  T* UI = t.uinv + b * t.so;
  long long* clk = t.clk && b == 0 && threadIdx.x == 0
                       ? t.clk + (size_t)rank * kWideClk
                       : nullptr;
  const auto tick = [clk](int i) {
    if (clk) clk[i] = clock64();
  };
  tick(0);
  // W: this CTA's rows of the tile, zero outside it, all copies in
  // flight at once; then the identity on the padding's diagonal
  {
    const int qr = np / Q::N;  // 16-byte pieces of a row
    if (t.lda % Q::N == 0 && n % Q::N == 0 && (size_t)A % 16 == 0) {
      for (int e = threadIdx.x; e < RPC * qr; e += kWideThreads) {
        const int i = e / qr, j = e % qr * Q::N, gi = r0 + i;
        const bool in = gi < n && j < n;
        cp_async<16>(W + (size_t)i * ldw + j,
                     in ? A + (size_t)gi * t.lda + j : A, in);
      }
    } else {
      for (int e = threadIdx.x; e < RPC * np; e += kWideThreads) {
        const int i = e / np, j = e % np, gi = r0 + i;
        const bool in = gi < n && j < n;
        cp_async<sizeof(T)>(W + (size_t)i * ldw + j,
                            in ? A + (size_t)gi * t.lda + j : A, in);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < RPC; i += kWideThreads)
      if (r0 + i >= n) W[(size_t)i * ldw + r0 + i] = T(1);
    __syncthreads();
  }
  tick(1);
  const int npan = (n + kPanel - 1) / kPanel;
  // panel 0: its diagonal block, then its rows to staging
  if (rank == 0) {
    if (warp == 0) {
      tick(2 + 6);
      diag_panel(W, ldw, rowbuf, F, ld, 0, n, t.tol);
      tick(2 + 7);
    }
    __syncthreads();
    for (int s = warp; s < npan; s += kWideWarps)
      stage_block(W, ldw, 0, UI, ld, 0, s * kPanel, n);
  }
#pragma unroll 1
  for (int p = 0; p < npan; ++p) {
    const int k0 = p * kPanel, kb = k0 + kPanel, tk = 2 + kWideClkPanel * p;
    const bool mine = k0 / RPC == rank;
    const bool next = p + 1 < npan && kb / RPC == rank;  // owns panel p + 1
    const int lr = k0 - r0, lr1 = kb - r0;
    const T* S = UI + (size_t)k0 * ld;
    T* S1 = UI + (size_t)kb * ld;
    // This CTA's stripes: all with rows below P or P's rows, else those
    // right of P; a warp's, in the order p + 1, ..., npan - 1, s_lo,
    // ..., p: round robin over the 8 warps, or with lookahead in the
    // owner of panel p + 1, stripe p + 1 to warps 0-3 or warp 0 (below)
    // and the rest round robin over warps 1-7
    const int s_lo = r0 + RPC > kb || mine ? 0 : p + 1;
    const int cnt = npan - s_lo;
    const bool la = t.lookahead && next;
    const bool lead = la && warp == 0;  // stripe p + 1, then its block
    const int q0 = warp;
    const int dq = !la ? kWideWarps : warp == 0 ? cnt : kWideWarps - 1;
    tick(tk);
    cluster_arrive();
    cluster_wait();  // panel p's staging rows are complete
    tick(tk + 1);
    // L11^-1 and U11^-1 from the staging rows' diagonal block (outside
    // the tile: the padding's identity)
    for (int e = threadIdx.x; e < kPanel * kPanel; e += kWideThreads) {
      const int i = e / kPanel, j = e % kPanel;
      const T v = k0 + i < n && k0 + j < n
                      ? __ldcg(S + (size_t)i * ld + k0 + j)
                      : T(i == j ? 1 : 0);
      Lb[i * C::LDA + j] = j < i ? v : T(j == i ? 1 : 0);
      Ub[i * C::LDS + j] = j >= i ? v : T(0);
    }
    __syncthreads();
    tick(tk + 2);
    // a_i of the CTA's rows: W[i, P]·U11^-1, rows P U11^-1's row; by
    // (row block, 8 columns) pieces, kept in registers until every read
    // of W[:, P] is done.  Rows below P: W[i, P] = 0 (L^-1's entries
    // start there) and L21 to the factor; rows above: U^-1's W[i, P].
    {
      constexpr int PIECES = C::MF * 4;
      constexpr int PW = (PIECES + kWideWarps - 1) / kWideWarps;
      T acc[PW][Mt::NC];
#pragma unroll
      for (int q = 0; q < PW; ++q) {
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) acc[q][i] = T(0);
        const int pc = warp + q * kWideWarps, mf = pc / 4, nf = pc % 4;
        const int gr = r0 + mf * Mt::M;
        if (pc >= PIECES || (gr >= k0 && gr < kb)) continue;
#pragma unroll
        for (int kk = 0; kk < C::KS; ++kk) {
          typename Mt::AFrag fa;
          typename Mt::BFrag fb;
          Mt::load_a(fa, W + k0, ldw, mf * Mt::M, kk * Mt::K);
          Mt::load_b(fb, Ub, C::LDS, kk * Mt::K, nf * Mt::N);
          Mt::step(acc[q], fa, fb);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        const int pc = warp + q * kWideWarps, mf = pc / 4, nf = pc % 4;
        if (pc >= PIECES) continue;
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) {
          const int r = mf * Mt::M + Mt::row(i), j = nf * Mt::N + Mt::col(i);
          const int gi = r0 + r;
          T v = acc[q][i];
          if (gi >= k0 && gi < kb) {
            v = Ub[(gi - k0) * C::LDS + j];
          } else if (gi >= kb) {
            W[(size_t)r * ldw + k0 + j] = T(0);
            if (gi < n && k0 + j < n) F[(size_t)gi * ld + k0 + j] = v;
          } else {
            W[(size_t)r * ldw + k0 + j] = v;
          }
          Ab[r * C::LDA + j] = v;
        }
      }
      __syncthreads();
    }
    tick(tk + 3);
    // The stripes (wide_stripe).  With lookahead 2, stripe p + 1 of its
    // owner goes to warps 0-3 first, 8 columns each, joined by a named
    // barrier of theirs (barrier 0 is __syncthreads) before warp 0
    // factors the block; with 1, to warp 0 alone.
    if (la && t.lookahead == 2 && warp < 4) {
      wide_stripe<T, RPC, 1>(W, ldw, Lb, Ab, Rw, F, S, ld, r0, k0, lr, mine,
                             p + 1, p, kb + warp * Mt::N, n);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
#pragma unroll 1
    for (int q = q0; q < cnt; q += dq) {
      int s = p + 1 + q;
      if (s >= npan) s = s_lo + s - npan;
      const int c = s * kPanel;
      if (!lead || t.lookahead != 2)
        wide_stripe<T, RPC, 4>(W, ldw, Lb, Ab, Rw, F, S, ld, r0, k0, lr,
                               mine, s, p, c, n);
      // panel p + 1's rows, done with panel p, to its staging rows; its
      // diagonal block once factored
      if (next && s != p + 1) stage_block(W, ldw, lr1, S1, ld, kb, c, n);
      if (lead) {
        tick(kWideClkPanel * (p + 1) + 2 + 6);
        diag_panel(W + (size_t)lr1 * ldw + kb, ldw, rowbuf, F, ld, kb, n,
                   t.tol);
        tick(kWideClkPanel * (p + 1) + 2 + 7);
        stage_block(W, ldw, lr1, S1, ld, kb, kb, n);
      }
      __syncwarp();  // Rw is free for the warp's next stripe
    }
    tick(tk + 4);
    if (!t.lookahead) {
      __syncthreads();
      if (next && warp == 0) {
        tick(kWideClkPanel * (p + 1) + 2 + 6);
        diag_panel(W + (size_t)lr1 * ldw + kb, ldw, rowbuf, F, ld, kb, n,
                   t.tol);
        tick(kWideClkPanel * (p + 1) + 2 + 7);
        stage_block(W, ldw, lr1, S1, ld, kb, kb, n);
      }
    }
    tick(tk + 5);
  }
  // L^-1 below W's diagonal (1 on it), U^-1 on and above it, once every
  // CTA has read the last staging rows
  cluster_arrive();
  cluster_wait();
  tick(kWideClk - 2);
  if (ld % Q::N == 0 && n % Q::N == 0 && ((size_t)LI | (size_t)UI) % 16 == 0) {
    const int qr = np / Q::N;
    for (int e = threadIdx.x; e < RPC * qr; e += kWideThreads) {
      const int i = e / qr, j = e % qr * Q::N, gi = r0 + i;
      if (gi >= n || j >= n) continue;
      T w[Q::N], l[Q::N], u[Q::N];
      Q::get(*reinterpret_cast<const typename Q::V*>(W + (size_t)i * ldw + j),
             w);
#pragma unroll
      for (int q = 0; q < Q::N; ++q) {
        l[q] = j + q < gi ? w[q] : T(j + q == gi ? 1 : 0);
        u[q] = j + q >= gi ? w[q] : T(0);
      }
      *reinterpret_cast<typename Q::V*>(LI + (size_t)gi * ld + j) = Q::make(l);
      *reinterpret_cast<typename Q::V*>(UI + (size_t)gi * ld + j) = Q::make(u);
    }
  } else {
    for (int e = threadIdx.x; e < RPC * np; e += kWideThreads) {
      const int i = e / np, j = e % np, gi = r0 + i;
      if (gi < n && j < n) {
        const T v = W[(size_t)i * ldw + j];
        LI[(size_t)gi * ld + j] = j < gi ? v : T(j == gi ? 1 : 0);
        UI[(size_t)gi * ld + j] = j >= gi ? v : T(0);
      }
    }
  }
  tick(kWideClk - 1);
}

// Per device and cluster size, the clusters of that shape that fit at
// once plus 1 (0: not asked yet), by type; internal to this library, so
// that each loaded copy of it opts its own kernels in.
static int g_wide_fit[2][16][kWideMaxCtas + 1];

// Clusters of the plan's shape that fit on the current device at once,
// asked once a (device, cluster size) with the kernel opted in to its
// largest shared memory and to non-portable cluster sizes; 0 when none.
template <typename T>
cudaError_t wide_fit(int ctas, int* fit) {
  constexpr int R = WideRows<T>::value;
  constexpr int kDevices = 16;
  int(&known)[kDevices][kWideMaxCtas + 1] = g_wide_fit[sizeof(T) == 8];
  auto kern = lu_wide_kernel<T, R>;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (ctas < 1 || ctas > kWideMaxCtas) return cudaErrorInvalidValue;
  if (dev < kDevices && known[dev][ctas]) {
    *fit = known[dev][ctas] - 1;
    return cudaSuccess;
  }
  const int most = (int)WideCluster<T, R>::smem_bytes(kWideLeaf);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(ctas, 1);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = WideCluster<T, R>::smem_bytes(ctas * R);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  *fit = 0;
  e = cudaOccupancyMaxActiveClusters(fit, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (dev < kDevices) known[dev][ctas] = *fit + 1;
  return cudaSuccess;
}

// The cluster launch of lu_wide_kernel on ``batch`` tiles (clusters
// beyond those that fit at once run in waves); raises no fallback: a
// cluster of the plan's shape that does not fit at all is an error.
template <typename T>
cudaError_t wide_launch(const WideTile<T>& t, int batch, cudaStream_t st) {
  constexpr int R = WideRows<T>::value;
  if (t.n < 1 || t.n > kWideLeaf || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  const WidePlan pl = wide_plan<T>(t.n);
  int fit;
  cudaError_t e = wide_fit<T>(pl.ctas, &fit);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(pl.ctas, batch);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lu_wide_kernel<T, R>, t);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

// ---------------------------------------------- the flow kernel

// Rows a CTA of the flow kernel holds, by type (kernels_cuda.FLOW_ROWS
// mirrors it): 32 in float; 16 in double, where 32 rows of a tile of
// 544 already pass a block's shared memory, so that a panel's rows sit
// in two CTAs and its diagonal block passes through L2.
template <typename T>
struct FlowRows {
  static constexpr int value = sizeof(T) == 4 ? 32 : 16;
};

constexpr int kFlowSmem = 232448;  // dynamic shared memory a block may have

// W_T: the widest tile (a multiple of 32) whose CTAs of FlowRows<T> rows
// fit kFlowSmem: 1408 in float, 1120 in double.
template <typename T>
constexpr int flow_max_nb() {
  using C = WideCluster<T, FlowRows<T>::value>;
  int np = kPanel;
  while (C::smem_bytes(np + kPanel) <= kFlowSmem) np += kPanel;
  return np;
}

// Ready flags a (device, stream): kernels_cuda allocates them zeroed.
constexpr int kFlowFlags = 16384;
// Up to this many panels (by type), warp 4 of the next panel's owner,
// on the diagonal warp's sub-partition, takes no stripe, so that the
// diagonal block runs beside one warp less: the chain of diagonal
// blocks bounds the narrower tiles, the stripes the wider ones in float
// (tools/probe_k1_wide.py, PERF.md).
template <typename T>
struct FlowDiagAlone {
  static constexpr int panels = sizeof(T) == 4 ? 28 : 64;
};
// clock64 readings a CTA of a timed launch (set 0, its first tile), as
// kWideClk: start, tile loaded, 8 a panel (top, diagonal block's flag
// passed, L11^-1 and U11^-1 loaded, a_i formed, warp 0's stripes done,
// the CTA's barrier at the top passed, diagonal block start and end),
// readers done, end
constexpr int kFlowClk = 4 + kWideClkPanel * (flow_max_nb<float>() / kPanel);

// The launch's plan for a tile of n: CTAs a tile (whole panels),
// rows a CTA, dynamic shared memory a CTA, and tiles in flight on
// ``sms`` SMs, one CTA an SM.
struct FlowPlan {
  int ctas, rows, smem, sets;
};
template <typename T>
FlowPlan flow_plan(int n, int sms) {
  constexpr int R = FlowRows<T>::value;
  const int npan = (n + kPanel - 1) / kPanel;
  const int ctas = npan * (kPanel / R);
  return {ctas, R, (int)WideCluster<T, R>::smem_bytes(npan * kPanel),
          sms / ctas};
}

// A launch's flags: per set of CTAs (a tile in flight) npan x npan x H
// stripe flags (panel, stripe, half of the panel's rows: its staging
// rows published), then per set npan x npan R flags (panel, stripe: its
// R formed over them), then one done flag a CTA of each set.  Round r of the launch (its r-th tile a
// set) publishes base + r + 1, so that no launch clears them: a flag
// is set when it has reached that value, compared modulo 2^32 (a flag
// trails the launch's value by fewer than 2^31 rounds).
struct FlowSync {
  unsigned* flags;
  unsigned base;
  int sets;
};

__device__ __forceinline__ unsigned flow_load(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Spins until *p >= ep; every calling thread acquires.  A flag that
// stays unset for 2^26 reads (seconds; a wait on the path lasts at most
// one tile's time, about a millisecond) traps: the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void flow_wait(const unsigned* p, unsigned ep) {
  for (unsigned k = 0; (int)(flow_load(p) - ep) < 0;)
    if (++k == 1u << 26) __trap();
}

// By one warp, after its lanes' writes of staging rows: *p = ep.
__device__ __forceinline__ void flow_publish(unsigned* p, unsigned ep) {
  __threadfence();
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(ep)
                 : "memory");
}

// By one warp: R = L11^-1·(the staging rows S of the panel at k0,
// columns [c, c + 32)), formed as wide_stripe forms it, to the same
// place in the rows D (the tile's rows and columns only; outside, R is
// the padding's identity, which load_stripe supplies).  In double, 16
// columns at a time (each entry's sum is the same), which keeps the
// stripe's raw values and sums within the registers.
template <typename T, int RPC>
__device__ __forceinline__ void flow_form_r(const T* Lb, const T* S, T* D,
                                            int ld, int k0, int c, int n) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  constexpr int NF = sizeof(T) == 8 ? 2 : 4;  // n blocks at a time
#pragma unroll 1
  for (int c2 = c; c2 < c + kPanel; c2 += NF * Mt::N) {
    T raw[C::KS][NF][C::BE];
    load_stripe<T, RPC, NF>(raw, S, ld, k0, c2, n);
    T acc[C::PF][NF][Mt::NC];
#pragma unroll
    for (int m = 0; m < C::PF; ++m)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) acc[m][nf][i] = T(0);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      typename Mt::AFrag fa[C::PF];
      typename Mt::BFrag fb[NF];
#pragma unroll
      for (int m = 0; m < C::PF; ++m)
        Mt::load_a(fa[m], Lb, C::LDA, m * Mt::M, kk * Mt::K);
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) bfrag_of(fb[nf], raw[kk][nf]);
#pragma unroll
      for (int m = 0; m < C::PF; ++m)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) Mt::step(acc[m][nf], fa[m], fb[nf]);
    }
#pragma unroll
    for (int m = 0; m < C::PF; ++m)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < Mt::NC; ++i) {
          const int r = m * Mt::M + Mt::row(i), j = nf * Mt::N + Mt::col(i);
          if (k0 + r < n && c2 + j < n)
            D[(size_t)r * ld + c2 + j] = acc[m][nf][i];
        }
  }
}

// load_stripe for the flow kernel's readers: without its checks where
// the stripe lies inside the tile.
template <typename T, int RPC, int NFW>
__device__ __forceinline__ void flow_load_stripe(
    T (&v)[WideCluster<T, RPC>::KS][NFW][WideCluster<T, RPC>::BE],
    const T* S, int ld, int k0, int c, int n) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  if (k0 + kPanel > n || c + NFW * Mt::N > n) {
    load_stripe<T, RPC, NFW>(v, S, ld, k0, c, n);
    return;
  }
  const int lane = threadIdx.x & 31;
  const T* q = S + (size_t)(lane & 3) * ld + c + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int e = 0; e < C::BE; ++e)
        v[kk][nf][e] = __ldcg(q + (size_t)(kk * Mt::K + 4 * e) * ld + nf * Mt::N);
}

// By one warp: L11^-1's columns [c, c + 8 NFW) (of Lb, the panel at k0)
// as load_stripe's B fragments: R of the panel's own stripe.
template <typename T, int RPC, int NFW>
__device__ __forceinline__ void lb_stripe(
    T (&v)[WideCluster<T, RPC>::KS][NFW][WideCluster<T, RPC>::BE],
    const T* Lb, int k0, int c) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int e = 0; e < C::BE; ++e)
        v[kk][nf][e] = Lb[(kk * Mt::K + (lane & 3) + 4 * e) * C::LDA + c - k0 +
                          nf * Mt::N + (lane >> 2)];
}

// By one warp, columns [c, c + 8 NFW) of stripe s at panel p, with R in
// the lane's B fragments (rv): the owner's rows of P (mine; W's rows at
// lr) take R left of P and 0 right of it, with U12 to the factor; then
// W[i, c..] -= a_i·R as in wide_stripe, the same products in the same
// order.
template <typename T, int RPC, int NFW>
__device__ __forceinline__ void flow_apply(
    T* W, int ldw, const T* Ab,
    const T (&rv)[WideCluster<T, RPC>::KS][NFW][WideCluster<T, RPC>::BE],
    T* F, int ld, int r0, int k0, int lr, bool mine, int s, int p, int c,
    int n) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  const int lane = threadIdx.x & 31, kb = k0 + kPanel;
  if (mine && s != p) {
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
      for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
        for (int e = 0; e < C::BE; ++e) {
          const int r = kk * Mt::K + (lane & 3) + 4 * e;
          const int j = nf * Mt::N + (lane >> 2);
          if (lr + r < 0 || lr + r >= RPC) continue;
          W[(size_t)(lr + r) * ldw + c + j] = s < p ? rv[kk][nf][e] : T(0);
          if (s > p && k0 + r < n && c + j < n)
            F[(size_t)(k0 + r) * ld + c + j] = rv[kk][nf][e];
        }
    __syncwarp();
  }
#pragma unroll
  for (int mf = 0; mf < C::MF; ++mf) {
    if (r0 + mf * Mt::M < kb && s <= p) continue;
    T u[NFW][Mt::NC];
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int i = 0; i < Mt::NC; ++i) u[nf][i] = T(0);
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      typename Mt::AFrag fa;
      Mt::load_a(fa, Ab, C::LDA, mf * Mt::M, kk * Mt::K);
#pragma unroll
      for (int nf = 0; nf < NFW; ++nf) {
        typename Mt::BFrag fb;
        bfrag_of(fb, rv[kk][nf]);
        Mt::step(u[nf], fa, fb);
      }
    }
#pragma unroll
    for (int nf = 0; nf < NFW; ++nf)
#pragma unroll
      for (int i = 0; i < Mt::NC; ++i)
        W[(size_t)(mf * Mt::M + Mt::row(i)) * ldw + c + nf * Mt::N +
          Mt::col(i)] -= u[nf][i];
  }
  __syncwarp();
}

// One cooperative launch: sets x ctas CTAs, CTA x the rank x % ctas of
// set x / ctas, which takes tiles set, set + sets, ... of the batch.
// lu_wide_kernel's steps with its cluster barriers replaced by flags:
// the owner of panel p + 1 publishes each 32-column stripe of its
// staging rows as it finishes panel p (the diagonal block's once
// factored).  At panel p each stripe s of R is formed once from them,
// into L^-1's rows P (LI's, which the final store overwrites), by the
// first CTA of panel s's rows: stripe p + 1 by the next panel's owner,
// whose warps 0-3 form and apply it first (its lookahead), the others by
// warp 0 after the a_i; every CTA applies each other stripe of R once its
// flag is set.  A panel of two CTAs (RPC = 16): each publishes its half
// of the staging rows; the first (the lead) waits for the second's half
// of the diagonal block, factors the block in warp 0's stripe buffer and
// publishes it whole.
// Before the final store overwrites its staging rows and its rows of R
// (UI's and LI's), a CTA waits for every CTA of its set to finish the
// panel loop.
template <typename T, int RPC>
__global__ void __launch_bounds__(kWideThreads, 1)
    lu_flow_kernel(const WideTile<T> t, const FlowSync sy, int batch) {
  using C = WideCluster<T, RPC>;
  using Mt = Mma<T>;
  using Q = Vec16<T>;
  constexpr int H = RPC < kPanel ? kPanel / RPC : 1;  // CTAs a panel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = t.n, ld = t.ldo;
  const int npan = (n + kPanel - 1) / kPanel, ctas = npan * H;
  const int np = npan * kPanel, ldw = C::ldw(np);
  T* W = reinterpret_cast<T*>(smem_raw);
  T* Lb = W + (size_t)RPC * ldw;
  T* Ab = Lb + kPanel * C::LDA;
  T* Rs = Ab + RPC * C::LDA;
  T* rowbuf = Rs + kWideWarps * kPanel * C::LDS;
  T* Ub = Rs;
  const int set = blockIdx.x / ctas, rank = blockIdx.x % ctas;
  const int half = rank % H;  // of the rows of panel rank / H
  const int r0 = rank * RPC;
  const int warp = threadIdx.x >> 5;
  T* Rw = Rs + warp * kPanel * C::LDS;
  // warp 4 of the next panel's owner idle beside the diagonal block
  const bool alone = npan <= FlowDiagAlone<T>::panels;
  // the set's stripe flags, [panel][stripe][half], and R flags
  const auto flag = [&sy, set, npan](int p, int s, int h) {
    return sy.flags + (size_t)set * npan * npan * H +
           ((size_t)p * npan + s) * H + h;
  };
  const auto rflag = [&sy, set, npan](int p, int s) {
    return sy.flags + (size_t)sy.sets * npan * npan * H +
           ((size_t)set * npan + p) * npan + s;
  };
#pragma unroll 1
  for (int b = set, round = 0; b < batch; b += sy.sets, ++round) {
    const unsigned ep = sy.base + round + 1;
    T* F = t.f + (size_t)b * t.so;
    T* LI = t.linv + (size_t)b * t.so;
    T* UI = t.uinv + (size_t)b * t.so;
    const bool timed = t.clk && set == 0 && round == 0 && threadIdx.x == 0;
    const auto tick = [&t, timed, rank](int i) {
      if (timed) t.clk[(size_t)rank * kFlowClk + i] = clock64();
    };
    tick(0);
    // W: this CTA's rows of the tile, zero outside it; the identity on
    // the padding's diagonal
    {
      const T* A = t.a + (size_t)b * t.sa;
      const int qr = np / Q::N;
      if (t.lda % Q::N == 0 && n % Q::N == 0 && (size_t)A % 16 == 0) {
        for (int e = threadIdx.x; e < RPC * qr; e += kWideThreads) {
          const int i = e / qr, j = e % qr * Q::N, gi = r0 + i;
          const bool in = gi < n && j < n;
          cp_async<16>(W + (size_t)i * ldw + j,
                       in ? A + (size_t)gi * t.lda + j : A, in);
        }
      } else {
        for (int e = threadIdx.x; e < RPC * np; e += kWideThreads) {
          const int i = e / np, j = e % np, gi = r0 + i;
          const bool in = gi < n && j < n;
          cp_async<sizeof(T)>(W + (size_t)i * ldw + j,
                              in ? A + (size_t)gi * t.lda + j : A, in);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int i = threadIdx.x; i < RPC; i += kWideThreads)
        if (r0 + i >= n) W[(size_t)i * ldw + r0 + i] = T(1);
      __syncthreads();
    }
    tick(1);
    // By warp 0 of the owner of panel q (its rows at W's row lq, its
    // staging rows Sq): the diagonal block factored and published whole
    // (RPC = 32, or the lead of two), or the second CTA's half of it
    // published for the lead.
    const auto diag_step = [&](int q, int lq, T* Sq) {
      const int kq = q * kPanel;
      tick(kWideClkPanel * q + 2 + 6);
      if constexpr (H == 1) {
        diag_panel(W + (size_t)lq * ldw + kq, ldw, rowbuf, F, ld, kq, n,
                   t.tol);
        stage_block(W, ldw, lq, Sq, ld, kq, kq, n);
        flow_publish(flag(q, q, 0), ep);
      } else if (half != 0) {
        stage_rows(W, ldw, lq, Sq, ld, kq, kq, n, -lq, kPanel);
        flow_publish(flag(q, q, half), ep);
      } else {
        // the block in Rw: this CTA's rows from W, the rest from their
        // staging rows through L2, 16 bytes a copy, all in flight at once
        // where the block lies inside the tile (else one value at a time,
        // the padding's identity outside the tile)
        const int lane = threadIdx.x & 31;
        for (int h = 1; h < H; ++h) flow_wait(flag(q, q, h), ep);
        constexpr int QN = 16 / sizeof(T);  // values a copy
        const bool vec = kq + kPanel <= n && ld % QN == 0 &&
                         (size_t)(Sq + kq) % 16 == 0;
        if (vec) {
          for (int e = lane; e < (kPanel - RPC) * kPanel / QN; e += 32) {
            const int i = RPC + e / (kPanel / QN), j = e % (kPanel / QN) * QN;
            cp_async<16>(Rw + i * C::LDS + j, Sq + (size_t)i * ld + kq + j,
                         true);
          }
          cp_async_commit();
        } else {
#pragma unroll 1
          for (int i = RPC; i < kPanel; ++i)
            Rw[i * C::LDS + lane] =
                kq + i < n && kq + lane < n
                    ? __ldcg(Sq + (size_t)i * ld + kq + lane)
                    : T(i == lane ? 1 : 0);
        }
#pragma unroll 4
        for (int i = 0; i < RPC; ++i)
          Rw[i * C::LDS + lane] = W[(size_t)(lq + i) * ldw + kq + lane];
        if (vec) cp_async_wait_all();
        __syncwarp();
        diag_panel(Rw, C::LDS, rowbuf, F, ld, kq, n, t.tol);
#pragma unroll 1
        for (int i = 0; i < kPanel && kq + i < n; ++i)
          if (kq + lane < n) Sq[(size_t)i * ld + kq + lane] = Rw[i * C::LDS + lane];
        flow_publish(flag(q, q, 0), ep);
      }
      tick(kWideClkPanel * q + 2 + 7);
    };
    // panel 0: its rows to staging, its diagonal block by warp 0
    if (rank / H == 0) {
      if (warp == 0) {
        diag_step(0, -r0, UI);
      } else {
        for (int s = warp; s < npan; s += kWideWarps - 1) {
          stage_rows(W, ldw, -r0, UI, ld, 0, s * kPanel, n, r0,
                     r0 + RPC < kPanel ? r0 + RPC : kPanel);
          flow_publish(flag(0, s, half), ep);
        }
      }
    }
#pragma unroll 1
    for (int p = 0; p < npan; ++p) {
      const int k0 = p * kPanel, kb = k0 + kPanel, tk = 2 + kWideClkPanel * p;
      const bool mine = rank / H == p;
      const bool next = p + 1 < npan && rank / H == p + 1;
      const int lr = k0 - r0, lr1 = kb - r0;
      const T* S = UI + (size_t)k0 * ld;
      T* S1 = UI + (size_t)kb * ld;
      const int s_lo = r0 + RPC > kb || mine ? 0 : p + 1;
      const int cnt = npan - s_lo;
      const bool lead = next && warp == 0;
      // in the next panel's owner, warp 0 takes stripe p + 1 and the
      // others the rest (not warp 4 where it leaves the block alone)
      const bool idle = alone && next && warp == 4;
      const int q0 = !next || !alone || warp < 4 ? warp : warp - 1;
      const int dq = !next ? kWideWarps
                     : warp == 0 ? cnt
                                 : kWideWarps - 1 - alone;
      tick(tk);
      __syncthreads();  // Lb, Ub and Rs are free
      tick(tk + 5);
      flow_wait(flag(p, p, 0), ep);
      tick(tk + 1);
      for (int e = threadIdx.x; e < kPanel * kPanel; e += kWideThreads) {
        const int i = e / kPanel, j = e % kPanel;
        const T v = k0 + i < n && k0 + j < n
                        ? __ldcg(S + (size_t)i * ld + k0 + j)
                        : T(i == j ? 1 : 0);
        Lb[i * C::LDA + j] = j < i ? v : T(j == i ? 1 : 0);
        Ub[i * C::LDS + j] = j >= i ? v : T(0);
      }
      __syncthreads();
      tick(tk + 2);
      // a_i of the CTA's rows, as lu_wide_kernel; with two CTAs a
      // panel, rows P also take the factored block into W here
      {
        constexpr int PIECES = C::MF * 4;
        constexpr int PW = (PIECES + kWideWarps - 1) / kWideWarps;
        T acc[PW][Mt::NC];
#pragma unroll
        for (int q = 0; q < PW; ++q) {
#pragma unroll
          for (int i = 0; i < Mt::NC; ++i) acc[q][i] = T(0);
          const int pc = warp + q * kWideWarps, mf = pc / 4, nf = pc % 4;
          const int gr = r0 + mf * Mt::M;
          if (pc >= PIECES || (gr >= k0 && gr < kb)) continue;
#pragma unroll
          for (int kk = 0; kk < C::KS; ++kk) {
            typename Mt::AFrag fa;
            typename Mt::BFrag fb;
            Mt::load_a(fa, W + k0, ldw, mf * Mt::M, kk * Mt::K);
            Mt::load_b(fb, Ub, C::LDS, kk * Mt::K, nf * Mt::N);
            Mt::step(acc[q], fa, fb);
          }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < PW; ++q) {
          const int pc = warp + q * kWideWarps, mf = pc / 4, nf = pc % 4;
          if (pc >= PIECES) continue;
#pragma unroll
          for (int i = 0; i < Mt::NC; ++i) {
            const int r = mf * Mt::M + Mt::row(i), j = nf * Mt::N + Mt::col(i);
            const int gi = r0 + r;
            T v = acc[q][i];
            if (gi >= k0 && gi < kb) {
              v = Ub[(gi - k0) * C::LDS + j];
              if constexpr (H > 1)
                W[(size_t)r * ldw + k0 + j] =
                    j < gi - k0 ? Lb[(gi - k0) * C::LDA + j] : v;
            } else if (gi >= kb) {
              W[(size_t)r * ldw + k0 + j] = T(0);
              if (gi < n && k0 + j < n) F[(size_t)gi * ld + k0 + j] = v;
            } else {
              W[(size_t)r * ldw + k0 + j] = v;
            }
            Ab[r * C::LDA + j] = v;
          }
        }
        __syncthreads();
      }
      tick(tk + 3);
      // This CTA's stripe of R (stripe rank / H, by the first CTA of its
      // panel's rows; not P's own, and stripe p + 1's below)
      const int sr = rank / H;
      if (warp == 0 && half == 0 && sr != p && sr != p + 1) {
        for (int h = 0; h < H; ++h) flow_wait(flag(p, sr, h), ep);
        flow_form_r<T, RPC>(Lb, S, LI + (size_t)k0 * ld, ld, k0, sr * kPanel,
                            n);
        flow_publish(rflag(p, sr), ep);
      }
      // The stripes, each once its flag is set: in the owner of panel p
      // + 1, stripe p + 1 first (warps 0-3, 8 columns each), then warp 0
      // its diagonal block; the rest round robin
      if (next && warp < 4) {
        for (int h = 0; h < H; ++h) flow_wait(flag(p, p + 1, h), ep);
        wide_stripe<T, RPC, 1>(W, ldw, Lb, Ab, Rw, F, S, ld, r0, k0, lr, mine,
                               p + 1, p, kb + warp * Mt::N, n);
        // its columns of R to the rows of R, published by warp 1 (the
        // first CTA of panel p + 1's rows) once the four are written;
        // warp 0's by warp 1 after the barrier where warp 0 leaves its
        // buffer alone (RPC = 32), so that its block starts at once
        const bool form = half == 0;
        const auto copy_r = [&](int w) {
          const int lane = threadIdx.x & 31, j = kb + w * Mt::N + lane % 8;
          const T* Rv = Rs + w * kPanel * C::LDS;
          T* D = LI + (size_t)k0 * ld;
          for (int i = lane / 8; i < kPanel && k0 + i < n; i += 4)
            if (j < n) D[(size_t)i * ld + j] = Rv[i * C::LDS + lane % 8];
        };
        if (form && (warp > 0 || H > 1)) copy_r(warp);
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (form && warp == 1) {
          if (H == 1) copy_r(0);
          flow_publish(rflag(p, p + 1), ep);
        }
      }
#pragma unroll 1
      for (int q = idle ? cnt : q0; q < cnt; q += dq) {
        int s = p + 1 + q;
        if (s >= npan) s = s_lo + s - npan;
        const int c = s * kPanel;
        if (!lead) {
          T rv[C::KS][4][C::BE];
          if (s == p) {
            lb_stripe<T, RPC, 4>(rv, Lb, k0, c);
          } else {
            flow_wait(rflag(p, s), ep);
            flow_load_stripe<T, RPC, 4>(rv, LI + (size_t)k0 * ld, ld, k0, c,
                                        n);
          }
          flow_apply<T, RPC, 4>(W, ldw, Ab, rv, F, ld, r0, k0, lr, mine, s, p,
                                c, n);
        }
        // panel p + 1's rows, done with panel p, to its staging rows
        // (those this CTA holds: all 32, or its half)
        if (next && s != p + 1) {
          stage_rows(W, ldw, lr1, S1, ld, kb, c, n, half * RPC,
                     H > 1 ? half * RPC + RPC : kPanel);
          flow_publish(flag(p + 1, s, half), ep);
        }
        if (lead) diag_step(p + 1, lr1, S1);
        __syncwarp();  // Rw is free for the warp's next stripe
      }
      tick(tk + 4);
    }
    // L^-1 and U^-1, over R and the staging rows, once every CTA of the
    // set has read its last ones
    __syncthreads();
    if (warp == 0) {
      unsigned* done = sy.flags + (size_t)sy.sets * npan * npan * (H + 1) +
                       (size_t)set * ctas;
      flow_publish(done + rank, ep);
      for (int c = threadIdx.x; c < ctas; c += 32) flow_wait(done + c, ep);
    }
    __syncthreads();
    tick(kFlowClk - 2);
    const bool vec =
        ld % Q::N == 0 && n % Q::N == 0 && ((size_t)LI | (size_t)UI) % 16 == 0;
    for (int u = 0; u < 2; ++u) {
      T* O = u ? UI : LI;
      if (vec) {
        const int qr = np / Q::N;
        for (int e = threadIdx.x; e < RPC * qr; e += kWideThreads) {
          const int i = e / qr, j = e % qr * Q::N, gi = r0 + i;
          if (gi >= n || j >= n) continue;
          T w[Q::N], o[Q::N];
          Q::get(*reinterpret_cast<const typename Q::V*>(W + (size_t)i * ldw + j),
                 w);
#pragma unroll
          for (int q = 0; q < Q::N; ++q)
            o[q] = u ? (j + q >= gi ? w[q] : T(0))
                     : (j + q < gi ? w[q] : T(j + q == gi ? 1 : 0));
          *reinterpret_cast<typename Q::V*>(O + (size_t)gi * ld + j) = Q::make(o);
        }
      } else {
        for (int e = threadIdx.x; e < RPC * np; e += kWideThreads) {
          const int i = e / np, j = e % np, gi = r0 + i;
          if (gi < n && j < n) {
            const T v = W[(size_t)i * ldw + j];
            O[(size_t)gi * ld + j] =
                u ? (j >= gi ? v : T(0)) : (j < gi ? v : T(j == gi ? 1 : 0));
          }
        }
      }
    }
    tick(kFlowClk - 1);
    __syncthreads();  // W is free for the next tile
  }
}

// Per device and type, whether the flow kernel took its largest shared
// memory (this library's own copy, as g_wide_fit).
static bool g_flow_ready[2][16];

// The cooperative launch of lu_flow_kernel on ``batch`` tiles: as many
// sets of CTAs as fit on the card at once (the tiles beyond run as
// further rounds of the same CTAs), flags from ``flags`` (kFlowFlags,
// the stream's own), *epoch advanced by the launch's rounds; *sets
// receives the tiles in flight.  No fallback: a tile whose CTAs do not
// fit on the card at once is an error.
template <typename T>
cudaError_t flow_launch(const WideTile<T>& t, int batch, unsigned* flags,
                        unsigned* epoch, cudaStream_t st,
                        int* sets = nullptr) {
  constexpr int R = FlowRows<T>::value;
  if (t.n < 1 || t.n > flow_max_nb<T>() || batch < 1 || !flags || !epoch)
    return cudaErrorInvalidValue;
  auto kern = lu_flow_kernel<T, R>;
  int dev, sms, fit;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !g_flow_ready[sizeof(T) == 8][dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)WideCluster<T, R>::smem_bytes(flow_max_nb<T>()));
    if (e != cudaSuccess) return e;
    if (dev < 16) g_flow_ready[sizeof(T) == 8][dev] = true;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const FlowPlan pl = flow_plan<T>(t.n, sms);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, kWideThreads,
                                                    pl.smem);
  if (e != cudaSuccess) return e;
  const int room = fit * sms / pl.ctas;
  if (room < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int s = batch < room ? batch : room;
  const int npan = (t.n + kPanel - 1) / kPanel;
  if ((size_t)s * ((size_t)npan * (pl.ctas + npan) + pl.ctas) > kFlowFlags)
    return cudaErrorInvalidValue;
  const FlowSync sy{flags, *epoch, s};
  *epoch += (batch + s - 1) / s;
  if (sets) *sets = s;
  void* args[] = {(void*)&t, (void*)&sy, (void*)&batch};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(s * pl.ctas),
                                  dim3(kWideThreads), args, pl.smem, st);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

// ------------------------------------ the recursion above the leaf width

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

// The widest leaf of the recursion for a batch on ``sms`` SMs
// (kernels_torch.k1_leaf_width mirrors it): the widest multiple of 32,
// at most W_T, at which all the batch's tiles run at once on the flow
// kernel, one CTA an SM, so that no tile waits a round for another's
// CTAs (a round costs a whole tile's chain, more than the recursion's
// narrower leaves and products); kWideLeaf, the cluster kernel's (its
// clusters run in waves, as they always did), where that is no wider.
template <typename T>
int flow_leaf(int batch, int sms) {
  constexpr int per = kPanel / FlowRows<T>::value;  // CTAs a panel
  const long w = (long)(sms / ((long)batch * per)) * kPanel;
  const long top = w < flow_max_nb<T>() ? w : flow_max_nb<T>();
  return top > kWideLeaf ? (int)top : kWideLeaf;
}

// Elements of scratch a tile of m needs at the narrowest leaves the
// recursion takes (kWideLeaf): none at a leaf; a split its S22 and the
// two products Tl, Tu, beside the larger need of its halves.
inline size_t wide_work_elems(int m) {
  if (m <= kWideLeaf) return 0;
  const size_t m1 = wide_split(m), m2 = m - m1;
  const size_t w1 = wide_work_elems((int)m1), w2 = wide_work_elems((int)m2);
  return m2 * m2 + 2 * m1 * m2 + (w1 > w2 ? w1 : w2);
}

// One call of K1 on a batch of wide tiles: the recursion of the note
// above, the scratch taken from ``work`` as a stack.
template <typename T>
struct WideLu {
  T* f;
  T* linv;
  T* uinv;
  T* work;  // batch * wide_work_elems(nb)
  unsigned* flags;  // the flow kernel's (kFlowFlags)
  unsigned* epoch;  // on the host, advanced by each flow launch
  int nb, batch;
  T tol;
  cudaStream_t st;
  int leaf;  // flow_leaf(batch, the device's SMs)
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
  // ``top`` is the free scratch.
  cudaError_t run(const T* src, int lds, size_t ss, int m, int o, T* top) {
    const size_t nn = (size_t)nb * nb;
    cudaError_t e;
    if (m <= leaf) {
      const WideTile<T> t{src, at(f, o, o), at(linv, o, o), at(uinv, o, o),
                          ss, nn, lds, nb, m, tol, kWideLookahead, nullptr};
      e = m <= kWideLeaf ? wide_launch(t, batch, st)
                         : flow_launch(t, batch, flags, epoch, st);
      if (e != cudaSuccess) return e;
      return done();
    }
    const int m1 = wide_split(m), m2 = m - m1, p = o + m1;
    const size_t s22 = (size_t)m2 * m2, t = (size_t)m1 * m2;
    T* sb = top;                    // S22
    T* tl = sb + batch * s22;       // L21·L11^-1 (m2 x m1)
    T* tu = tl + batch * t;         // U12·U22^-1 (m1 x m2)
    T* next = tu + batch * t;
    if ((e = run(src, lds, ss, m1, o, next)) != cudaSuccess) return e;
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
    if ((e = run(sb, m2, s22, m2, p, next)) != cudaSuccess) return e;
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
// wide_work_elems(nb) elements and the stream's flow flags and epoch
// (flow_launch), on leaves of at most flow_leaf(batch, the device's
// SMs).  counts[0] += 1, counts[1] += the device launches.
template <typename T>
int getrf_inv_wide(const T* a, T* f, T* linv, T* uinv, T* work,
                   unsigned* flags, unsigned* epoch, int batch, int nb,
                   double tol, int* counts, cudaStream_t st) {
  if (nb <= kMaxNb || a == f || batch < 1) return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  WideLu<T> w{f, linv, uinv, work, flags, epoch, nb, batch, (T)tol, st,
              flow_leaf<T>(batch, sms)};
  e = w.run(a, nb, (size_t)nb * nb, nb, 0, work);
  if (e != cudaSuccess) return e;
  ++counts[0];
  counts[1] += w.launches;
  return cudaSuccess;
}

// lu_wide_kernel alone on ``batch`` tiles of 1 <= nb <= kWideLeaf, with
// lookahead 0, 1 or 2 and, with clk (kWideMaxCtas * kWideClk device
// readings), the clock64 phases of cluster 0: a measurement, on no path.
template <typename T>
int wide_probe(const T* a, T* f, T* linv, T* uinv, int batch, int nb,
               double tol, int lookahead, long long* clk, cudaStream_t st) {
  if (a == f) return cudaErrorInvalidValue;
  const size_t nn = (size_t)nb * nb;
  const WideTile<T> t{a, f, linv, uinv, nn, nn, nb, nb, nb, (T)tol,
                      lookahead, clk};
  return wide_launch(t, batch, st);
}

// lu_flow_kernel alone on ``batch`` tiles of 1 <= nb <= W_T, with, given
// clk (ctas * kFlowClk device readings), the clock64 phases of its first
// tile; *sets receives the tiles in flight: a measurement, on no path
// at nb <= 512.
template <typename T>
int flow_probe(const T* a, T* f, T* linv, T* uinv, unsigned* flags,
               unsigned* epoch, int batch, int nb, double tol,
               long long* clk, int* sets, cudaStream_t st) {
  if (a == f) return cudaErrorInvalidValue;
  const size_t nn = (size_t)nb * nb;
  const WideTile<T> t{a, f, linv, uinv, nn, nn, nb, nb, nb, (T)tol,
                      kWideLookahead, clk};
  return flow_launch(t, batch, flags, epoch, st, sets);
}

}  // namespace plu
