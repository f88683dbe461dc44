// K3 and K5 at tile width 256 (128 < nb <= 256) on thread block
// clusters.  Included by lu_kernels.cu after K5, whose helpers
// (warp_sum, prefetch_l2, kMaxNb) it uses; the C entries are there.
//
// What held the one-block sweeps back at this width (PERF.md):
// K3 ran 4 blocks on a 132-SM card at poisson3d(32) rcm, each block
// streaming the level's 256 KiB inverse and a 256 KiB panel tile
// through one SM (~21-27 GB/s into an SM, ~24 us a level); K5's
// heaviest item streamed up to 13 such tiles through one SM while the
// rest of the step waited at the grid barrier.
//
// Design: the rows of every matrix a sweep reads are split over a
// cluster of C CTAs (RowSplit: CTA c of the cluster owns rows [c R,
// c R + R), R = 256 / C, a warp one row or several).  CTA c computes
// its rows of x_k = inv_k · src_k (all of src_k, 1 KiB of f32, from
// L2), publishes them in its shared memory, and after a cluster barrier
// gathers the whole x_k from its peers through distributed shared
// memory (the 1 KiB vector a level shares; DSMEM is too slow for tiles,
// ~10-14 bytes a cycle into an SM, PERF.md).  It then subtracts its
// rows of T_t · x_k from its rows of the target segments: every CTA
// writes only its own rows of x, so no two CTAs touch one value between
// two barriers.  Each row's dot product runs on one warp in the one-block
// kernels' order (lane j sums columns j, j + 32, ... in turn, then
// warp_sum), so the sweeps give the bits of tile_matvec and rows_dot:
// the same results as the one-block kernels, on every run.
//
// K3 (solve_cluster_kernel, clusters of kSolveCluster CTAs): per level
// two cluster barriers, one after the updates (x_k's source rows are
// whole) and one after x_k's rows are published.  The inverse and the
// level's first panel tiles are read-only, so a CTA stages the next
// level's rows of them into shared memory by cp.async (two stages of
// SweepSmem::kMats matrices) before it waits at the barrier; only x
// waits for it.  The level tables come two levels ahead, the old values
// of its target rows when a level starts, by cp.async too.  One cluster
// walks the whole sweep with cluster barriers only, clusters taking
// right-hand sides (RHS r to cluster r mod Q), each cluster up to kRhs
// of them at once.
//
// K5 (group_cluster_kernel, clusters of group_cluster_size CTAs): one (item,
// RHS) of a step a cluster (spread over the clusters by a grid-stride
// loop), CTA c computing its rows of each entry in one of the one-block
// kernel's 128-row passes (all of a warp's rows in flight together); an
// item with an inverse exchanges v through distributed shared memory
// after a cluster barrier, then each CTA writes its rows of inv · v.  A
// grid barrier between two steps, before it the L2 prefetch of the next
// step's tiles and inverses, as the one-block kernel.
//
// The cluster sizes, K3's layout and staging, and K5's choice of its
// cluster size were measured fastest on the H100 (PERF.md;
// tools/probe_solve_sweeps.py weighs other sizes and designs as textual
// edits of this file).
//
// K5's grid barrier needs every CTA of the grid resident at once: its
// launcher sizes the grid by cudaOccupancyMaxActiveClusters and launches
// it cooperative as well, so that the runtime refuses a grid that is
// not.

namespace plu {

// The cluster size of K3's sweeps.
constexpr int kSolveCluster = 16;

// The cluster size of K5's sweeps for nrhs right-hand sides whose widest
// step has `width` items, on a card of `sms` SMs: 4 CTAs while the
// widest step holds fewer than two (item, RHS) pairs an SM (a step then
// waits for its heaviest items, which a wider split ends sooner), else 2
// (the card is full of items, and clusters of 2 leave fewer SMs idle
// than clusters of 4, which a GPC's SMs need not divide into: 132 of
// the H100's against 120).
inline int group_cluster_size(int width, int nrhs, int sms) {
  return width * nrhs < 2 * sms ? 4 : 2;
}

// The rows of a 256-row matrix over a cluster of C CTAs: CTA rank c
// owns rows [c R, c R + R), one warp a row, or R / 32 rows a warp
// (kRows) in CTAs of 32 warps.
template <int C>
struct RowSplit {
  static_assert(C == 2 || C == 4 || C == 8 || C == 16,
                "clusters of 2, 4, 8 or 16");
  static constexpr int R = kMaxNb / C;
  static constexpr int kWarps = R < 32 ? R : 32;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = R / kWarps;
};

// acc + sum_j m[j] x[j] over j = lane, lane + 32, ... < nb, in that
// order (tile_matvec's and rows_dot's), with every load of the lane
// issued before its first product.  With XG, x is in global memory and
// read through L2 (another CTA wrote it before the last barrier).
template <typename T, bool XG>
__device__ __forceinline__ T row_dot(const T* m, const T* x, int nb, T acc) {
  constexpr int kQ = kMaxNb / 32;
  const int lane = threadIdx.x % 32;
  T mv[kQ], xv[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = lane + 32 * q;
    mv[q] = j < nb ? m[j] : T(0);
    xv[q] = j < nb ? (XG ? __ldcg(x + j) : x[j]) : T(0);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (lane + 32 * q < nb) acc = fmat(mv[q], xv[q], acc);
  return acc;
}

// A barrier of every CTA of the grid (all resident).  bar[0] counts the
// arrivals and is 0 again after each barrier, bar[1] counts barriers;
// bar[0] starts at 0.  The counters are the launch stream's own
// (kernels_cuda keeps a pair a stream): launches on one stream take
// them in turn, launches on two streams share nothing.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned ctas) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == ctas - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Loads of tables and of x in global memory for the tiles past what K3
// stages: asm volatile, so that the compiler keeps them inside their
// branch, off the staged path.
__device__ __forceinline__ int ld_table(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_l2(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];\n" : "=d"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ bool aligned16(const void* g, size_t bytes) {
  return (__cvta_generic_to_global(g) | bytes) % 16 == 0;
}

// count read-only elements from g to s by cp.async: in 16-byte pieces
// when g and the length allow, else one element a copy.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_rows(T* s, const T* g, int count) {
  if (aligned16(g, count * sizeof(T))) {
    constexpr int V = 16 / sizeof(T);
    for (int e = threadIdx.x * V; e < count; e += kThreads * V)
      cp_async<16>(s + e, g + e, true);
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads)
      cp_async<sizeof(T)>(s + e, g + e, true);
  }
}

// K3's shared memory: two stages of kMats matrices' rows of this CTA
// (the level's inverse, then its first kTiles panel tiles, each R x nb
// in row stride nb), the old values of this CTA's target rows of the
// level's first kOldTiles tiles for kRhs right-hand sides, this CTA's
// rows of x_k for kRhs right-hand sides and the whole x_k of each (all
// elements of T); then three levels' table entries (Tabs), loaded two
// levels ahead.  kMats is what fits a 200 KiB budget twice (0 if none
// fits: the matrices are then read from global memory).
template <typename T, int C>
struct SweepSmem {
  static constexpr int kRhs = 4;
  static constexpr int kOldTiles = 8;
  static constexpr size_t kMat = (size_t)RowSplit<C>::R * kMaxNb;
  static constexpr int kMats = (int)(200 * 1024 / (2 * kMat * sizeof(T)));
  static constexpr int kTiles = kMats > 1 ? kMats - 1 : 0;
  static constexpr size_t kStageElems = (size_t)kMats * kMat;
  static constexpr size_t kOld = (size_t)kOldTiles * kRhs * RowSplit<C>::R;
  static constexpr size_t kPub = (size_t)kRhs * RowSplit<C>::R;
  static constexpr size_t kTabs =
      (2 * kStageElems + kOld + kPub + (size_t)kRhs * kMaxNb) * sizeof(T);
};

// A level's table entries in K3's shared memory: its count and the ids
// and target rows of its first kTabW panel tiles (the rest are read from
// the tables in global memory).
struct Tabs {
  static constexpr int kTabW = 16;
  int cnt;
  int ids[kTabW];
  int rows[kTabW];
};

template <typename T, int C>
constexpr size_t sweep_smem_bytes() {
  return SweepSmem<T, C>::kTabs + 3 * sizeof(Tabs);
}

// The arguments of one sweep of K3, as solve_sweep_kernel takes them.
template <typename T>
struct SolveSweep {
  T* src;
  T* dst;
  int nrhs;
  const T* tiles;
  const T* invs;
  int slot;
  const int* ids;
  const int* rows;
  const int* cnt;
  int bl, w, nb, descending;
};

// One sweep of K3 (solve_sweep_kernel's contract) on clusters of C
// CTAs.
template <typename T, int C>
__global__ void __launch_bounds__(RowSplit<C>::kThreads, 1)
    solve_cluster_kernel(const SolveSweep<T> a) {
  using S = RowSplit<C>;
  using M = SweepSmem<T, C>;
  constexpr int kV = 16 / sizeof(T);  // elements a 16-byte piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  T* olds = stage + 2 * M::kStageElems;
  T* pub = olds + M::kOld;
  T* xk = pub + M::kPub;
  Tabs* tabs = reinterpret_cast<Tabs*>(smem_raw + M::kTabs);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int q = blockIdx.x / C, nq = gridDim.x / C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nb = a.nb, w = a.w, nrhs = a.nrhs;
  const int r0 = c * S::R, nr = max(0, min(S::R, nb - r0));
  const size_t nn = (size_t)nb * nb, rhs_stride = (size_t)(a.bl + 1) * nb;
  // this cluster's RHS are q, q + nq, ...
  auto level = [&](int s) { return a.descending ? a.bl - 1 - s : s; };
  // level s's table entries into tabs[s % 3] (one cp.async group)
  auto issue_tabs = [&](int s) {
    if (s < a.bl) {
      Tabs& tb = tabs[s % 3];
      const size_t k = level(s);
      const int n = min(w, Tabs::kTabW);
      for (int e = threadIdx.x; e < 2 * n + 1; e += S::kThreads) {
        if (e < n)
          cp_async<4>(tb.ids + e, a.ids + k * w + e, true);
        else if (e < 2 * n)
          cp_async<4>(tb.rows + e - n, a.rows + k * w + e - n, true);
        else
          cp_async<4>(&tb.cnt, a.cnt + k, true);
      }
    }
    cp_async_commit();
  };
  // the id and target row of level s's panel tile t
  auto tile_id = [&](int s, int t) {
    if (t < Tabs::kTabW) return tabs[s % 3].ids[t];
    return ld_table(a.ids + (size_t)level(s) * w + t);
  };
  auto tile_row = [&](int s, int t) {
    if (t < Tabs::kTabW) return tabs[s % 3].rows[t];
    return ld_table(a.rows + (size_t)level(s) * w + t);
  };
  // this CTA's rows of level s's inverse and first tiles into stage
  // buffer s % 2 (one cp.async group, empty if none fits); the tiles
  // past them are asked of L2
  auto issue = [&](int s) {
    const int k = level(s), nm = tabs[s % 3].cnt;
    T* buf = stage + (s & 1) * M::kStageElems;
    if (M::kMats > 0 && nr > 0) {
      stage_rows<T, S::kThreads>(
          buf, a.invs + (2 * (size_t)k + a.slot) * nn + (size_t)r0 * nb,
          nr * nb);
      for (int m = 0; m < nm; ++m) {
        const T* t = a.tiles + (size_t)tile_id(s, m) * nn +
                     (size_t)r0 * nb;
        if (m < M::kTiles)
          stage_rows<T, S::kThreads>(buf + (1 + m) * M::kMat, t, nr * nb);
        else if (threadIdx.x == 0)
          prefetch_l2(t, (size_t)nr * nb * sizeof(T));
      }
    }
    cp_async_commit();
  };
  for (int rb = q; rb < nrhs; rb += nq * M::kRhs) {
    // a pass over the sweep with RHS rb + h nq, h < nrh
    const int nrh = min(M::kRhs, (nrhs - rb + nq - 1) / nq);
    __syncthreads();  // every read of the last pass's stage is done
    issue_tabs(0);
    issue_tabs(1);
    cp_async_wait_all();
    __syncthreads();
    issue(0);
    for (int s = 0; s < a.bl; ++s) {
      const int k = level(s), nm = tabs[s % 3].cnt;
      const T* sm = stage + (s & 1) * M::kStageElems;
      cp_async_wait_all();
      // x_k's source rows are whole (and this CTA's stage and level s +
      // 1's tables have landed)
      cluster_sync_all();
      // the old values of this CTA's target rows (only this CTA writes
      // them) through L2, one cp.async group before the stage's and the
      // tables', so that they come in while x_k is formed
      const int no = nr == 0 ? 0 : min(nm, M::kOldTiles) * nrh;
      const bool vec = nb % kV == 0;
      const int per = vec ? nr / kV : nr;
      for (int p = threadIdx.x; p < no * per; p += S::kThreads) {
        const int j = p / per, u = p % per * (vec ? kV : 1);
        const int m = j / nrh, h = j % nrh;
        const T* g = a.src + (size_t)(rb + h * nq) * rhs_stride +
                     (size_t)tile_row(s, m) * nb + r0 + u;
        if (vec)
          cp_async<16>(olds + j * S::R + u, g, true);
        else
          olds[j * S::R + u] = __ldcg(g);
      }
      cp_async_commit();
      if (s + 1 < a.bl)
        issue(s + 1);
      else
        cp_async_commit();
      issue_tabs(s + 2);
      const T* inv = M::kMats > 0 ? sm
                                  : a.invs + (2 * (size_t)k + a.slot) * nn +
                                        (size_t)r0 * nb;
      for (int p = warp; p < nrh * S::R; p += S::kWarps) {
        const int h = p / S::R, i = p % S::R;
        if (i >= nr) continue;  // uniform across the warp
        const size_t xr =
            (size_t)(rb + h * nq) * rhs_stride + (size_t)k * nb;
        const T sum = warp_sum(
            row_dot<T, true>(inv + (size_t)i * nb, a.src + xr, nb, T(0)));
        if (lane == 0) {
          pub[h * S::R + i] = sum;
          a.dst[xr + r0 + i] = sum;
        }
      }
      cluster_sync_all();  // x_k's rows are published
      for (int e = threadIdx.x; e < nrh * nb; e += S::kThreads) {
        const int h = e / nb, j = e % nb;
        xk[h * kMaxNb + j] =
            cluster.map_shared_rank(pub, j / S::R)[h * S::R + j % S::R];
      }
      // the old values (not the next stage and tables)
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      __syncthreads();
      // this CTA's rows of T_t · x_k off their targets, a warp's jobs
      // (tile m, RHS h, row i) two at a time
      const int nj = nm * nrh * S::R;
      auto job = [&](int p, const T*& t, const T*& x, T*& out, T& old) {
        const int m = p / (nrh * S::R), h = p / S::R % nrh, i = p % S::R;
        t = (m < M::kTiles ? sm + (1 + m) * M::kMat
                           : a.tiles + (size_t)tile_id(s, m) * nn +
                                 (size_t)r0 * nb) +
            (size_t)i * nb;
        x = xk + h * kMaxNb;
        out = a.src + (size_t)(rb + h * nq) * rhs_stride +
              (size_t)tile_row(s, m) * nb + r0 + i;
        old = T(0);
        if (lane == 0) {
          if (m < M::kOldTiles)
            old = olds[(m * nrh + h) * S::R + i];
          else
            old = ld_l2(out);
        }
        return i < nr;  // uniform across the warp
      };
      for (int p = warp; p < nj; p += 2 * S::kWarps) {
        const T *ta, *xa, *tb = nullptr, *xb = nullptr;
        T *oa, *ob = nullptr;
        T olda, oldb = T(0);
        const bool va = job(p, ta, xa, oa, olda);
        const bool vb = p + S::kWarps < nj &&
                        job(p + S::kWarps, tb, xb, ob, oldb);
        const T sa = va ? row_dot<T, false>(ta, xa, nb, T(0)) : T(0);
        const T sb = vb ? row_dot<T, false>(tb, xb, nb, T(0)) : T(0);
        const T ra = warp_sum(sa), rb2 = warp_sum(sb);
        if (lane == 0) {
          if (va) *oa = olda - ra;
          if (vb) *ob = oldb - rb2;
        }
      }
    }
  }
  cluster_sync_all();  // no CTA leaves while a peer reads its x_k rows
}

// The arguments of one sweep of K5, as group_sweep_kernel takes them.
template <typename T>
struct GroupSweep {
  T* src;
  T* dst;
  int nrhs;
  const T* tiles;
  const T* invs;
  int slot;
  const int2* step;
  const int4* item;
  const int2* ent;
  int nsteps, bl, nb;
};

// acc[q] += sum_j M[i_q][j] x[j] for this warp's rows i_q = i0 + q
// kWarps of the split, i_q < i1: rows_dot's loop (the loads of all the
// rows in flight at once, each row summed in column order within a
// lane); x in global memory through L2 (XG) or in shared memory.
template <typename T, int kWarps, int kRows, bool XG>
__device__ __forceinline__ void split_rows_dot(const T* M, const T* x, int nb,
                                               int i0, int i1,
                                               T (&acc)[kRows]) {
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int j = lane; j < nb; j += 32) {
    const T xj = XG ? __ldcg(x + j) : x[j];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + q * kWarps;
      if (i < i1) acc[q] = fmat(M[(size_t)i * nb + j], xj, acc[q]);
    }
  }
}

// One sweep of K5 (group_sweep_kernel's contract) on clusters of C
// CTAs: item it of a step (its RHS it / n) on cluster it mod Q, CTA c
// of the cluster taking the item's rows [c R, c R + R) in one pass of
// the one-block kernel's 128-row passes (kRows rows a warp, their loads
// in flight together); an item with an inverse exchanges v through
// distributed shared memory after a cluster barrier, then each CTA
// writes its rows of inv · v.  Before the grid barrier that ends a step
// the grid asks L2 for the next step's tiles and inverses, as the
// one-block kernel.  bar: the grid barrier's counters.
template <typename T, int C>
__global__ void __launch_bounds__(RowSplit<C>::kThreads, 1)
    group_cluster_kernel(const GroupSweep<T> a, unsigned* bar) {
  using S = RowSplit<C>;
  __shared__ T pub[2][S::R];  // this CTA's rows of v, by parity
  __shared__ T v[kMaxNb];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int q = blockIdx.x / C, nq = gridDim.x / C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nb = a.nb;
  const int r0 = c * S::R, r1 = min(nb, r0 + S::R);
  const size_t nn = (size_t)nb * nb, rhs_stride = (size_t)(a.bl + 1) * nb;
  const int i0 = r0 + warp;  // this warp's first row
  int par = 0;
  int2 cur = __ldg(a.step), nxt = __ldg(a.step + 1);
  for (int s = 0;; ++s) {
    const int n = nxt.x - cur.x;
    for (int it = q; it < n * a.nrhs; it += nq) {
      const int r = it / n;
      const int4 d = __ldg(a.item + cur.x + it % n);
      T* xs = a.src + r * rhs_stride;
      T* xd = a.dst + r * rhs_stride;
      T* row = xs + (size_t)d.x * nb;
      T acc[S::kRows], old[S::kRows];
#pragma unroll
      for (int k = 0; k < S::kRows; ++k) {
        const int i = i0 + k * S::kWarps;
        acc[k] = T(0);
        old[k] = lane == 0 && i < r1 ? __ldcg(row + i) : T(0);
      }
      for (int e = d.z; e < d.w; ++e) {
        const int2 te = __ldg(a.ent + e);
        split_rows_dot<T, S::kWarps, S::kRows, true>(
            a.tiles + (size_t)te.x * nn, xd + (size_t)te.y * nb, nb, i0, r1,
            acc);
      }
#pragma unroll
      for (int k = 0; k < S::kRows; ++k) {
        const int i = i0 + k * S::kWarps;
        if (i < r1) {  // uniform across the warp
          const T val = old[k] - warp_sum(acc[k]);
          if (lane == 0) {
            if (d.y)
              pub[par][i - r0] = val;
            else
              row[i] = val;
          }
        }
      }
      if (d.y) {  // uniform across the cluster
        cluster_sync_all();  // v's rows are published
        for (int j = threadIdx.x; j < nb; j += S::kThreads)
          v[j] = cluster.map_shared_rank(&pub[par][0], j / S::R)[j % S::R];
        __syncthreads();
        T sum[S::kRows];
#pragma unroll
        for (int k = 0; k < S::kRows; ++k) sum[k] = T(0);
        split_rows_dot<T, S::kWarps, S::kRows, false>(
            a.invs + (2 * (size_t)d.x + a.slot) * nn, v, nb, i0, r1, sum);
#pragma unroll
        for (int k = 0; k < S::kRows; ++k) {
          const int i = i0 + k * S::kWarps;
          if (i < r1) {
            const T val = warp_sum(sum[k]);
            if (lane == 0) xd[(size_t)d.x * nb + i] = val;
          }
        }
        par ^= 1;
      }
    }
    if (s + 1 == a.nsteps) break;
    const int2 after = __ldg(a.step + s + 2);
    const int ne = after.y - nxt.y, np = ne + after.x - nxt.x;
    for (int p = blockIdx.x + threadIdx.x * gridDim.x; p < np;
         p += gridDim.x * S::kThreads) {
      if (p < ne) {
        prefetch_l2(a.tiles + (size_t)__ldg(a.ent + nxt.y + p).x * nn,
                    nn * sizeof(T));
      } else {
        const int4 d = __ldg(a.item + nxt.x + p - ne);
        if (d.y)
          prefetch_l2(a.invs + (2 * (size_t)d.x + a.slot) * nn,
                      nn * sizeof(T));
      }
    }
    cur = nxt;
    nxt = after;
    grid_barrier(bar, gridDim.x);
  }
  cluster_sync_all();  // no CTA leaves while a peer reads its v rows
}

// ------------------------------------------------------ host launchers

// The launch of kern on clusters of c CTAs (threads a CTA, smem bytes
// of dynamic shared memory), opted in; *fit receives how many clusters
// of it the card holds at once (a refusal is returned, and the
// runtime's last error cleared).
template <typename K>
cudaError_t sweep_cluster_config(K kern, int c, int threads, size_t smem,
                                 cudaStream_t st, cudaLaunchAttribute* attr,
                                 cudaLaunchConfig_t* cfg, int* fit) {
  *cfg = {};
  cfg->gridDim = dim3(c);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && c > 8)  // above the portable cluster size
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *fit = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(fit, kern, cfg);
  if (e == cudaSuccess && *fit < 1) e = cudaErrorLaunchOutOfResources;
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// One sweep of K3 at 128 < nb <= 256 on min(nrhs, fit) clusters of
// kSolveCluster CTAs.  grid[0] receives the CTAs launched, grid[1] the
// clusters that fit.
template <typename T>
int solve_cluster_sweep(const SolveSweep<T>& a, int* grid, cudaStream_t st) {
  constexpr int C = kSolveCluster;
  auto kern = solve_cluster_kernel<T, C>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int fit;
  cudaError_t e = sweep_cluster_config(kern, C, RowSplit<C>::kThreads,
                                       sweep_smem_bytes<T, C>(), st, &attr,
                                       &cfg, &fit);
  if (e != cudaSuccess) return e;
  const int q = a.nrhs < fit ? a.nrhs : fit;
  cfg.gridDim = dim3(q * C);
  grid[0] = q * C;
  grid[1] = fit;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One sweep of K5 at 128 < nb <= 256 on min(width * nrhs, fit) clusters
// of C CTAs, a cooperative launch; bar: the grid barrier's counters,
// st's own; grid as for solve_cluster_sweep.
template <typename T, int C>
int group_cluster_sweep(const GroupSweep<T>& a, int width, unsigned* bar,
                        int* grid, cudaStream_t st) {
  auto kern = group_cluster_kernel<T, C>;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  int fit;
  cudaError_t e = sweep_cluster_config(kern, C, RowSplit<C>::kThreads, 0, st,
                                       attr, &cfg, &fit);
  if (e != cudaSuccess) return e;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  int q = width * a.nrhs;
  q = q < 1 ? 1 : q < fit ? q : fit;
  cfg.gridDim = dim3(q * C);
  grid[0] = q * C;
  grid[1] = fit;
  e = cudaLaunchKernelEx(&cfg, kern, a, bar);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K5's sweep on clusters of `cluster` CTAs (group_cluster_size's).
template <typename T>
int group_cluster_sweep(const GroupSweep<T>& a, int width, int cluster,
                        unsigned* bar, int* grid, cudaStream_t st) {
  return cluster == 2 ? group_cluster_sweep<T, 2>(a, width, bar, grid, st)
                      : group_cluster_sweep<T, 4>(a, width, bar, grid, st);
}

}  // namespace plu
