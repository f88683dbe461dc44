// Hand-written Hopper kernels of the main path: init -> gstrf -> gstrs
// on the dense tile store.  Built with nvcc for sm_90a into a shared
// library with a plain C interface (pangulu_tpu_torch/ops/build.py) and
// called through ctypes (pangulu_tpu_torch/ops/kernels_cuda.py).
//
// Every entry runs on the caller's stream, allocates nothing, never
// synchronises, and returns the first CUDA error (cudaGetLastError after
// each launch), 0 on success.  Tiles are row-major nb x nb, nb <= 128.
//
// K1 getrf_with_inverses
//   Replaces pangulu_tpu/ops/kernels_pallas.py getrf_with_inverses
//   (_getrf_inv_kernel -> _lu_inverses).  One block per tile of the
//   batch; the per-tile body is plu::lu_inverses_tile (tile_lu.cuh),
//   whose note gives the bound and the design.
//
// K2 mega_factorize
//   Replaces pangulu_tpu/ops/kernels_pallas.py mega_factorize
//   (_mega_kernel): the whole numeric factorization.
//   Bound on an H100: the dependent level chain.  Per level the work is
//   one tile LU (latency-bound, above), nl + nu panel products and nup
//   Schur products of nb^3 FMA each (the bench problem has at most 14
//   panel tiles and 49 updates a level, 6,958 updates in all), so a
//   level fills at most a fraction of the 132 SMs and the run is bound
//   by per-level latency: three launches and the diagonal step.
//   Design: the TPU kernel ran everything in one launch because its
//   grid is sequential and it hand-scheduled DMAs; here each level is
//   three stream-ordered launches (the diagonal step, which is K1's
//   kernel on one tile in place, then panels, then Schur) read from
//   device-resident tables, driven by one host loop over host copies
//   of the per-level counts, with no host synchronisation and no
//   device-to-host read.  Stream order is the level barrier.  Schur
//   destinations are unique within a level, so each update is one
//   block (or four, one per 64 x 64 quadrant) with no atomics; the
//   TPU's (u-chunk, l-chunk, l) sort was for VMEM reuse and changes no
//   result here.  One persistent cooperative launch (or a CUDA graph
//   of this loop) is the follow-up.
//
// K3 mega_solve
//   Replaces pangulu_tpu/ops/kernels_pallas.py mega_solve
//   (_mega_solve_kernel): forward then backward block solve against the
//   triangle inverses that K2 persisted.
//   Bound on an H100: again the level chain, 2 * bl dependent steps of
//   tiny work (one nb x nb matrix-vector product per RHS, plus a panel
//   of them); the bytes are each tile read once (about 180 MiB of f32
//   for the bench problem, ~55 us at full bandwidth).
//   Design: per level two stream-ordered launches, the diagonal
//   contraction and the panel updates; the panel's rows are distinct,
//   so its tiles update x in parallel blocks without atomics.  Each
//   product is warp-per-row so that tile reads are coalesced.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"
#include "tile_lu.cuh"

namespace plu {

// ---------------------------------------------------------------- K1
// Block b factors tile t = (ids ? ids[b] : b) of ``a`` into the same
// slot of ``f`` (which may be ``a``: in place) and writes its inverses
// to linv/uinv + b * inv_stride.  The batched entry calls it with
// ids = nullptr; the factorization's diagonal step (K2) calls it with
// one block, ids = &diag_tab[k] and the level's slots of ``invs``.
template <typename T>
__global__ void __launch_bounds__(kLuThreads)
    getrf_inv_kernel(const T* a, T* f, T* linv, T* uinv, size_t inv_stride,
                     const int* ids, int nb, T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LuSmem<T> s(smem_raw, nb);
  const size_t nn = (size_t)nb * nb;
  const size_t off = (size_t)(ids ? ids[blockIdx.x] : blockIdx.x) * nn;
  T* li = linv + blockIdx.x * inv_stride;
  T* ui = uinv + blockIdx.x * inv_stride;
  copy_tile(a + off, s.F, nb);
  __syncthreads();
  lu_inverses_tile(s.F, s.lc, s.g ? s.g : li, s.g ? s.g : ui, li, ui, nb,
                   tol);
  copy_tile(s.F, f + off, nb);
}

// ---------------------------------------------------------------- K2

// Block b < nl: L panel lid[k][b] <- L·U^-1; else U panel
// uid[k][b-nl] <- L^-1·U.  In place: one block owns the whole tile.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    panel_kernel(T* tiles, const T* invs, const int* lid, const int* uid,
                 int lw, int uw, int k, int nl, int nb) {
  const size_t nn = (size_t)nb * nb;
  const int b = blockIdx.x;
  if (b < nl) {
    T* t = tiles + (size_t)lid[(size_t)k * lw + b] * nn;
    tile_gemm<T, 8, false>(t, invs + (size_t)(2 * k + 1) * nn, t, nb, 0, 0);
  } else {
    T* t = tiles + (size_t)uid[(size_t)k * uw + (b - nl)] * nn;
    tile_gemm<T, 8, false>(invs + (size_t)(2 * k) * nn, t, t, nb, 0, 0);
  }
}

// Block (j, q): update j of level k, output quadrant q of 64 x 64.
// Update j sits in chunk j / uch, entry j % uch of the [bl, nchunks,
// row_w] tables.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    schur_kernel(T* tiles, const int* lid, const int* uid, const int* udst,
                 const int* udl, const int* udu, int lw, int uw, int nchunks,
                 int row_w, int uch, int k, int nb, int qdim) {
  const size_t nn = (size_t)nb * nb;
  const int j = blockIdx.x;
  const size_t o = ((size_t)k * nchunks + j / uch) * row_w + j % uch;
  const T* l = tiles + (size_t)lid[(size_t)k * lw + udl[o]] * nn;
  const T* u = tiles + (size_t)uid[(size_t)k * uw + udu[o]] * nn;
  T* dst = tiles + (size_t)udst[o] * nn;
  const int qr = blockIdx.y / qdim, qc = blockIdx.y % qdim;
  tile_gemm<T, 4, true>(l, u, dst, nb, qr * 64, qc * 64);
}

// ---------------------------------------------------------------- K3
constexpr int kSolveThreads = 1024;
constexpr int kMaxNb = 128;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// out[i] (=|-=) sum_j M[i][j] * xs[j], one warp per row i.
template <typename T, bool SUB>
__device__ void tile_matvec(const T* M, const T* xs, T* out, int nb) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = warp; i < nb; i += kSolveThreads / 32) {
    T acc = T(0);
    for (int j = lane; j < nb; j += 32) acc = fmat(M[i * nb + j], xs[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[i] = SUB ? out[i] - acc : acc;
  }
}

// Block r: x[r, k, :] <- inv · x[r, k, :].
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
    solve_diag_kernel(T* x, const T* inv, size_t rhs_stride, int k, int nb) {
  __shared__ T xs[kMaxNb];
  T* xk = x + blockIdx.x * rhs_stride + (size_t)k * nb;
  for (int i = threadIdx.x; i < nb; i += kSolveThreads) xs[i] = xk[i];
  __syncthreads();
  tile_matvec<T, false>(inv, xs, xk, nb);
}

// Block (t, r): x[r, rows[k][t], :] -= T_t · x[r, k, :].
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
    solve_panel_kernel(T* x, const T* tiles, const int* ids, const int* rows,
                       int w, size_t rhs_stride, int k, int nb) {
  __shared__ T xs[kMaxNb];
  const size_t nn = (size_t)nb * nb;
  const size_t e = (size_t)k * w + blockIdx.x;
  const T* t = tiles + (size_t)ids[e] * nn;
  T* xr = x + blockIdx.y * rhs_stride;
  for (int i = threadIdx.x; i < nb; i += kSolveThreads)
    xs[i] = xr[(size_t)k * nb + i];
  __syncthreads();
  tile_matvec<T, true>(t, xs, xr + (size_t)rows[e] * nb, nb);
}

// ------------------------------------------------------ host launchers
template <typename T>
int getrf_inv(const T* a, T* f, T* linv, T* uinv, int batch, int nb,
              double tol, cudaStream_t st) {
  const size_t smem = lu_smem_bytes<T>(nb);
  cudaError_t e = cudaFuncSetAttribute(
      getrf_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  getrf_inv_kernel<T><<<batch, kLuThreads, smem, st>>>(
      a, f, linv, uinv, (size_t)nb * nb, nullptr, nb, (T)tol);
  return cudaGetLastError();
}

template <typename T>
int mega_factorize(T* tiles, T* invs, const int* diag_tab, const int* lid,
                   const int* uid, const int* udst, const int* udl,
                   const int* udu, const int* h_nl, const int* h_nu,
                   const int* h_nup, int bl, int lw, int uw, int nchunks,
                   int row_w, int uch, int nb, double tol, int* diag_launches,
                   cudaStream_t st) {
  const size_t smem = lu_smem_bytes<T>(nb);
  cudaError_t e = cudaFuncSetAttribute(
      getrf_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const size_t nn = (size_t)nb * nb;
  const int qdim = (nb + 63) / 64;
  for (int k = 0; k < bl; ++k) {
    // diagonal step: K1's kernel on tile diag_tab[k], in place
    T* linv = invs + (size_t)(2 * k) * nn;
    getrf_inv_kernel<T><<<1, kLuThreads, smem, st>>>(
        tiles, tiles, linv, linv + nn, 0, diag_tab + k, nb, (T)tol);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ++*diag_launches;  // K1's launch count, reported to the wrapper
    const int np = h_nl[k] + h_nu[k];
    if (np > 0) {
      panel_kernel<T><<<np, kGemmThreads, 0, st>>>(tiles, invs, lid, uid, lw,
                                                   uw, k, h_nl[k], nb);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (h_nup[k] > 0) {
      schur_kernel<T><<<dim3(h_nup[k], qdim * qdim), kGemmThreads, 0, st>>>(
          tiles, lid, uid, udst, udl, udu, lw, uw, nchunks, row_w, uch, k, nb,
          qdim);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename T>
int sweep(T* x, int nrhs, const T* tiles, const T* invs, int slot,
          const int* ids, const int* rows, const int* h_n, int bl, int w,
          int nb, bool descending, cudaStream_t st) {
  const size_t nn = (size_t)nb * nb;
  const size_t rhs_stride = (size_t)(bl + 1) * nb;
  cudaError_t e;
  for (int i = 0; i < bl; ++i) {
    const int k = descending ? bl - 1 - i : i;
    solve_diag_kernel<T><<<nrhs, kSolveThreads, 0, st>>>(
        x, invs + (size_t)(2 * k + slot) * nn, rhs_stride, k, nb);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (h_n[k] > 0) {
      solve_panel_kernel<T><<<dim3(h_n[k], nrhs), kSolveThreads, 0, st>>>(
          x, tiles, ids, rows, w, rhs_stride, k, nb);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename T>
int mega_solve(T* x, int nrhs, const T* tiles, const T* invs, const int* lid,
               const int* lrow, const int* ucid, const int* ucrow,
               const int* h_nl, const int* h_nuc, int bl, int w, int nb,
               cudaStream_t st) {
  int e = sweep(x, nrhs, tiles, invs, 0, lid, lrow, h_nl, bl, w, nb, false,
                st);
  if (e != cudaSuccess) return e;
  return sweep(x, nrhs, tiles, invs, 1, ucid, ucrow, h_nuc, bl, w, nb, true,
               st);
}

}  // namespace plu

// ------------------------------------------------------ C interface
#define PLU_STREAM(s) reinterpret_cast<cudaStream_t>(s)

extern "C" {

// Bumped with every change of an entry's signature; kernels_cuda.py
// checks it at load.
int plu_kernels_abi() { return 2; }

const char* plu_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int plu_getrf_inv_f32(int dev, const float* a, float* f, float* linv,
                      float* uinv, int batch, int nb, double tol, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::getrf_inv(a, f, linv, uinv, batch, nb, tol, PLU_STREAM(st));
}

int plu_getrf_inv_f64(int dev, const double* a, double* f, double* linv,
                      double* uinv, int batch, int nb, double tol, void* st) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  return plu::getrf_inv(a, f, linv, uinv, batch, nb, tol, PLU_STREAM(st));
}

#define PLU_MEGA_FACTORIZE(NAME, T)                                           \
  int NAME(int dev, T* tiles, T* invs, const int* diag_tab, const int* lid,  \
           const int* uid, const int* udst, const int* udl, const int* udu,  \
           const int* h_nl, const int* h_nu, const int* h_nup, int bl,       \
           int lw, int uw, int nchunks, int row_w, int uch, int nb,          \
           double tol, int* diag_launches, void* st) {                       \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_factorize(tiles, invs, diag_tab, lid, uid, udst, udl,   \
                               udu, h_nl, h_nu, h_nup, bl, lw, uw, nchunks,  \
                               row_w, uch, nb, tol, diag_launches,           \
                               PLU_STREAM(st));                              \
  }
PLU_MEGA_FACTORIZE(plu_mega_factorize_f32, float)
PLU_MEGA_FACTORIZE(plu_mega_factorize_f64, double)

#define PLU_MEGA_SOLVE(NAME, T)                                               \
  int NAME(int dev, T* x, int nrhs, const T* tiles, const T* invs,           \
           const int* lid, const int* lrow, const int* ucid,                 \
           const int* ucrow, const int* h_nl, const int* h_nuc, int bl,      \
           int w, int nb, void* st) {                                        \
    cudaError_t e = cudaSetDevice(dev);                                      \
    if (e != cudaSuccess) return e;                                          \
    return plu::mega_solve(x, nrhs, tiles, invs, lid, lrow, ucid, ucrow,     \
                           h_nl, h_nuc, bl, w, nb, PLU_STREAM(st));          \
  }
PLU_MEGA_SOLVE(plu_mega_solve_f32, float)
PLU_MEGA_SOLVE(plu_mega_solve_f64, double)

}  // extern "C"
