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
// through shared memory (one row buffer a chain, double buffered by
// the step's parity: one barrier a step), column k by a shuffle, the
// division by quot as in K1.
//
// The products (P5, P4): acc <- a · acc from acc = b, one a step, on
// the tensor cores through compressed.cuh newton_product (tile_gemm.cuh),
// four warps, a 128 x 128 product as sixteen 32 x 32 windows, on copies
// of a and acc of the product type P:
//   * P = double (the default, "f64"): DMMA (mma.sync m8n8k4 f64) on
//     float64 copies; the result is rounded to float32 once, at the end.
//     At least as accurate as float32 (the probes' Precision.HIGHEST):
//     the instance the checks hold to true f32.
//   * P = float ("tf32x3"): 3xTF32, the solver's float products (K2,
//     K4), timed beside it so that the probes' answers hold for the
//     products the solver runs.  Not true f32 on this chain: the tensor
//     core truncates the sums it accumulates, and with a ~ I every
//     product of the chain truncates the same way, so the chain drifts:
//     3.9x the plain float32 chain's error against float64 after 128
//     products on the H100 (PERF.md), against the 2x of true f32.
// Out of place: a and acc (double buffered) are in a workspace in
// global memory (three tiles of P a copy, in L2), staged through shared
// memory slice by slice, as every product of the port is; the first
// scan chain is in registers.  So a block holds the windows' stages (19
// KB for f64), the row buffers and P4's second chain, not a, acc and
// acc' (192 KB of f32).
//
// P5 overlap_kernel<MODE, P> (replaces tools/exp_overlap.py run)
//   kProbeScan: the scan's 8 warps; kProbeDots: the product's 4 warps;
//   kProbeBoth and kProbeSplit: both, 12 warps, the product on warps
//   0-3 (their barriers inside a product are named barrier 1), the scan
//   on warps 4-11.  kProbeSplit takes one CTA barrier a step, so a
//   product and a scan step run side by side (t ~ max); kProbeBoth
//   takes two, the scan step between the first and the second and the
//   product after the second, so they run in turn (t ~ sum), as the
//   probe's one loop body asks.  Output f + acc.  The probe's question:
//   does the scan hide under the products?
//   Bound on an H100: operations.  4096 products of 2 * 128^3 flop are
//   1.72e10 flop: 0.256 ms at 67 TFLOP/s (DMMA) on the whole card, 34
//   ms on one SM (3xTF32: 0.104 and 13.7 ms at 495/3 TFLOP/s); the
//   scan's updates are ~4.5e7 flop (32 passes), 0.67 us at 67 TFLOP/s,
//   88 us on one SM, but its 4096 dependent steps bound it by latency:
//   a barrier, a shared read, a shuffle and a division a step.
//
// P4 scan_multi_kernel<Q, WITH_DOT, P> (replaces tools/exp_scan_multi.py
//   run): Q chains f_i = a + i in one loop body, each step of each
//   chain behind one barrier, with (WITH_DOT) the product warps of
//   kProbeSplit beside them.  Output ((f_0 + f_1) + ...) + acc.  Where
//   the chains live: a 128 x 128 f32 chain is 64 KB, against an SM's
//   256 KB of registers and 228 KB of shared memory.  Chain 0 is in
//   registers (64 a thread); a second register chain would need more
//   than the 168 registers a thread has beside the product warps (384
//   threads), and spilled.  Chain 1 is in shared memory (64 KB), in the
//   same layout, each step loading and storing the rows below k; chains
//   2 to Q - 1, which fit on the SM nowhere, are in a workspace in
//   global memory (64 KB each, L2-resident), the same way.  The probe's
//   question: do independent chains pipeline, i.e. does a step of Q
//   chains cost less than Q steps?  (With this layout: chains in
//   registers beyond the first are not measured.)
//   Bound: the dependent chain of steps (latency), as for P5's scan.
//
// Both: a grid of `copies` CTAs, each an identical copy of the problem
// (its own output and workspaces), so that one launch can fill more
// SMs.
//
// P3 newton_loop_kernel<S> (replaces tools/exp_batched_scan.py
//   newton_loop): X = 2I - L, then `steps` times X <- X (2I - L X), for
//   each of G matrices L as given, one CTA walking its members in turn
//   (a grid of B CTAs, member m on CTA m mod B).  The products are
//   those of P2's first design, a doubling (compressed.cuh
//   newton_product, 64 x 64 windows staged from L2), in float64 (DMMA)
//   for float members too: with 3xTF32 the probe's unit triangles
//   (inverse entries up to ~1e17) came to 2.7x the plain float32
//   version's error against float64 on the H100 (PERF.md), against
//   true f32's 2x.  A CTA's workspace holds L, X, the next X and L X in
//   float64.  The question: is one CTA walking several members cheaper
//   than a CTA a member?  (Neither: P2 now runs a sweep instead.)
//   Bound: bytes.  The function is the inverse of G unit lower
//   triangles: G nb^2 values in and out (2.1 MB at G = 16, nb = 128,
//   0.63 us at 3.35 TB/s), and G (nb^3 / 3) flop whatever the
//   algorithm (1.1e7, 0.17 us at 67 TFLOP/s); the doubling's G * steps
//   * 2 * 2 nb^3 flop (8.1e8) are this algorithm's, not the function's.
#pragma once

#include <cuda_runtime.h>

#include "compressed.cuh"
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

template <int MODE>
__host__ __device__ constexpr int probe_threads() {
  return MODE == kProbeScan   ? 32 * kScanWarps
         : MODE == kProbeDots ? kGemmThreads
                             : kGemmThreads + 32 * kScanWarps;
}

// The products' 32 x 32 window (warp tiles of 16 x 16) of type P: the
// product warps share a block of 384 threads, 168 registers a thread,
// with the scan's, and a 64 x 32 f64 window spilled there beside P4's
// second chain (a 64 x 64 one of 3xTF32 spilled anyway).
template <typename P>
using ProbeWindow = Window<P, 32, 32, 2, 2>;

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

// The same step of a chain m in shared or global memory (128 x 128, row
// stride 128, zero-padded, in the register tile's layout): row k and
// this thread's rows below k are loaded, the rows below stored back.
__device__ __forceinline__ void chain_step_mem(float* m, int k, int ka,
                                               int kb, int w, int sw, int tx) {
  const int c = k & 31;
  const float* rowk = m + (size_t)k * kProbeNb;
  const float piv = safe_pivot(rowk[k], kProbeTol);
  const float rp = recip(piv);
  float rv[kChainCols];
#pragma unroll
  for (int b = kb; b < kChainCols; ++b) rv[b] = rowk[tx + 32 * b];
#pragma unroll
  for (int ia = ka; ia < kChainRows; ++ia) {
    if (ia == ka && sw <= w) continue;
    float* ri = m + (size_t)(sw + kScanWarps * ia) * kProbeNb;
    float v[kChainCols];
#pragma unroll
    for (int b = kb; b < kChainCols; ++b) v[b] = ri[tx + 32 * b];
    const float l = quot(__shfl_sync(0xffffffffu, v[kb], c), piv, rp);
#pragma unroll
    for (int b = kb; b < kChainCols; ++b)
      if (b > kb || tx > c) ri[tx + 32 * b] = fmaf(-l, rv[b], v[b]);
  }
}

// The scan warps' loop: `steps` steps of Q chains, chain 0 in f, chain
// 1 (Q >= 2) in shared memory at sh, chains 2 to Q - 1 in global memory
// at gm.  A step: the owner warp of row k stores it from f, a CTA
// barrier, every chain's update, and in kProbeBoth a second CTA
// barrier, after which the product warps run the step's product.
// bcast: 2 row buffers.
template <int Q, int MODE>
__device__ __forceinline__ void scan_loop(ChainTile& f, float* sh, float* gm,
                                          float* bcast, int n, int steps,
                                          int sw, int tx) {
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
        if (Q >= 2) chain_step_mem(sh, k, ka, kb, w, sw, tx);
#pragma unroll 1
        for (int q = 2; q < Q; ++q)
          chain_step_mem(gm + (size_t)(q - 2) * kProbeNb * kProbeNb, k, ka,
                         kb, w, sw, tx);
        if (MODE == kProbeBoth) __syncthreads();
      }
    }
  }
}

// Element (r, c) of chain q >= 1 of a block: in shared memory (q = 1)
// or in global memory.
__device__ __forceinline__ float& chain_at(float* sh, float* gm, int q, int r,
                                           int c) {
  const size_t e = (size_t)r * kProbeNb + c;
  return q == 1 ? sh[e] : gm[(size_t)(q - 2) * kProbeNb * kProbeNb + e];
}

// One copy (block blockIdx.x) of P4 or P5: Q chains f_i = a + i through
// `steps` scan steps (unless kProbeDots) and acc <- a · acc from acc = b
// (unless kProbeScan) in products of type P; out = ((f_0 + f_1) + ...)
// + acc.  The product warps and the scan warps take the same number of
// CTA barriers: one a step (two in kProbeBoth) and one after the last.
// Shared memory: the row buffers, chain 1 (Q >= 2), the product
// windows' stages.  work: a, then acc and acc', of type P (3 tiles a
// copy).
template <int Q, int MODE, typename P>
__device__ __forceinline__ void probe_body(const float* a, const float* b,
                                           float* out, P* work, float* gm,
                                           int n, int steps) {
  constexpr bool SCAN = MODE != kProbeDots, DOT = MODE != kProbeScan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bcast = reinterpret_cast<float*>(smem_raw);
  float* sh = bcast + 2 * kProbeNb;
  P* stages = reinterpret_cast<P*>(
      SCAN ? sh + (Q >= 2 ? kProbeNb * kProbeNb : 0) : bcast);
  const size_t nn = (size_t)n * n;
  out += blockIdx.x * nn;
  P* ap = work + blockIdx.x * 3 * nn;
  P* acc = ap + nn;
  const P* accf = acc + (steps & 1) * nn;  // the last product
  const int warp = threadIdx.x >> 5, tx = threadIdx.x & 31;
  if (Q > 2) gm += (size_t)blockIdx.x * (Q - 2) * kProbeNb * kProbeNb;
  if (DOT && warp < kGemmWarps) {
    constexpr int BAR = SCAN ? 1 : 0;
    for (size_t e = threadIdx.x; e < nn; e += kGemmThreads) {
      ap[e] = a[e];
      acc[e] = b[e];
    }
    for (int s = 0; s < steps; ++s) {
      __syncthreads();
      if (MODE == kProbeBoth) __syncthreads();
      newton_product<kStore, P, ProbeWindow<P>, BAR>(
          ap, acc + (s & 1) * nn, acc + ((s + 1) & 1) * nn, n, stages);
    }
    __syncthreads();
    if (!SCAN)
      for (size_t e = threadIdx.x; e < nn; e += kGemmThreads)
        out[e] = a[e] + float(accf[e]);
    return;
  }
  if (!SCAN) return;
  const int sw = warp - (DOT ? kGemmWarps : 0);
  ChainTile f;
#pragma unroll
  for (int i = 0; i < kChainRows; ++i)
#pragma unroll
    for (int j = 0; j < kChainCols; ++j) {
      const int r = sw + kScanWarps * i, c = tx + 32 * j;
      const bool in = r < n && c < n;
      const float v = in ? a[(size_t)r * n + c] : 0.f;
      f.v[i][j] = v;
      for (int q = 1; q < Q; ++q)
        chain_at(sh, gm, q, r, c) = in ? v + float(q) : 0.f;
    }
  scan_loop<Q, MODE>(f, sh, gm, bcast, n, steps, sw, tx);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kChainRows; ++i)
#pragma unroll
    for (int j = 0; j < kChainCols; ++j) {
      const int r = sw + kScanWarps * i, c = tx + 32 * j;
      if (r >= n || c >= n) continue;
      float v = f.v[i][j];
      for (int q = 1; q < Q; ++q) v = v + chain_at(sh, gm, q, r, c);
      const size_t e = (size_t)r * n + c;
      out[e] = v + (DOT ? float(accf[e]) : b[e]);
    }
}

// Dynamic shared memory of a probe block.
template <int Q, int MODE, typename P>
constexpr size_t probe_smem_bytes() {
  return (MODE == kProbeDots
              ? 0
              : (2 * kProbeNb + (Q >= 2 ? kProbeNb * kProbeNb : 0)) *
                    sizeof(float)) +
         (MODE == kProbeScan ? 0 : ProbeWindow<P>::kSmemBytes);
}

// The kernel's launch with its dynamic shared memory opted in (chain 1
// takes it above the default 48 KB).
template <class K, class... Args>
cudaError_t launch_probe(K kernel, int copies, int threads, size_t smem,
                         cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<copies, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// P5: one copy of the probe's problem a block.
template <int MODE, typename P>
__global__ void __launch_bounds__(probe_threads<MODE>(), 1)
    overlap_kernel(const float* a, const float* b, float* out, P* work,
                   int n, int steps) {
  probe_body<1, MODE, P>(a, b, out, work, nullptr, n, steps);
}

// P4: one copy a block; the products, if any, on their own warps.
template <int Q, bool WITH_DOT, typename P>
__global__ void __launch_bounds__(
    probe_threads<WITH_DOT ? kProbeSplit : kProbeScan>(), 1)
    scan_multi_kernel(const float* a, const float* b, float* out, P* work,
                      float* gm, int n, int steps) {
  probe_body<Q, WITH_DOT ? kProbeSplit : kProbeScan, P>(a, b, out, work, gm,
                                                        n, steps);
}

// The products' type of a probe launch: 0 float64 (DMMA), 1 float
// (3xTF32).
enum ProbeProducts { kProductsF64, kProductsTf32x3 };

template <int MODE, typename P>
cudaError_t launch_overlap(const float* a, const float* b, float* out,
                           void* work, int copies, int n, int steps,
                           cudaStream_t st) {
  return launch_probe(overlap_kernel<MODE, P>, copies, probe_threads<MODE>(),
                      probe_smem_bytes<1, MODE, P>(), st, a, b, out,
                      static_cast<P*>(work), n, steps);
}

template <int MODE>
cudaError_t launch_overlap(int products, const float* a, const float* b,
                           float* out, void* work, int copies, int n,
                           int steps, cudaStream_t st) {
  switch (products) {
    case kProductsF64:
      return launch_overlap<MODE, double>(a, b, out, work, copies, n, steps,
                                          st);
    case kProductsTf32x3:
      return launch_overlap<MODE, float>(a, b, out, work, copies, n, steps,
                                         st);
    default:
      return cudaErrorInvalidValue;
  }
}

// P5 in mode (ProbeMode) on `copies` blocks, its products of type
// `products` (ProbeProducts; the scan mode has none and takes only
// kProductsF64); work: 3 tiles of that type a copy.
inline cudaError_t scan_overlap(int mode, int products, const float* a,
                                const float* b, float* out, void* work,
                                int copies, int n, int steps,
                                cudaStream_t st) {
  switch (mode) {
    case kProbeScan:
      if (products != kProductsF64) return cudaErrorInvalidValue;
      return launch_overlap<kProbeScan, double>(a, b, out, work, copies, n,
                                                steps, st);
    case kProbeDots:
      return launch_overlap<kProbeDots>(products, a, b, out, work, copies, n,
                                        steps, st);
    case kProbeBoth:
      return launch_overlap<kProbeBoth>(products, a, b, out, work, copies, n,
                                        steps, st);
    case kProbeSplit:
      return launch_overlap<kProbeSplit>(products, a, b, out, work, copies,
                                         n, steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int Q, bool WITH_DOT, typename P>
cudaError_t launch_scan_multi(const float* a, const float* b, float* out,
                              void* work, float* gm, int copies, int n,
                              int steps, cudaStream_t st) {
  constexpr int MODE = WITH_DOT ? kProbeSplit : kProbeScan;
  return launch_probe(scan_multi_kernel<Q, WITH_DOT, P>, copies,
                      probe_threads<MODE>(), probe_smem_bytes<Q, MODE, P>(),
                      st, a, b, out, static_cast<P*>(work), gm, n, steps);
}

template <int Q>
cudaError_t launch_scan_multi(bool with_dot, int products, const float* a,
                              const float* b, float* out, void* work,
                              float* gm, int copies, int n, int steps,
                              cudaStream_t st) {
  if (!with_dot)
    return products == kProductsF64
               ? launch_scan_multi<Q, false, double>(a, b, out, work, gm,
                                                     copies, n, steps, st)
               : cudaErrorInvalidValue;
  switch (products) {
    case kProductsF64:
      return launch_scan_multi<Q, true, double>(a, b, out, work, gm, copies,
                                                n, steps, st);
    case kProductsTf32x3:
      return launch_scan_multi<Q, true, float>(a, b, out, work, gm, copies,
                                               n, steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// P4 with q chains on `copies` blocks, products as for scan_overlap;
// work: 3 tiles a copy, mem: q - 2 chains of 128 x 128 a copy (chains 2
// to q - 1).
inline cudaError_t scan_multi(int q, bool with_dot, int products,
                              const float* a, const float* b, float* out,
                              void* work, float* mem, int copies, int n,
                              int steps, cudaStream_t st) {
  switch (q) {
    case 1:
      return launch_scan_multi<1>(with_dot, products, a, b, out, work, mem,
                                  copies, n, steps, st);
    case 2:
      return launch_scan_multi<2>(with_dot, products, a, b, out, work, mem,
                                  copies, n, steps, st);
    case 4:
      return launch_scan_multi<4>(with_dot, products, a, b, out, work, mem,
                                  copies, n, steps, st);
    case 8:
      return launch_scan_multi<8>(with_dot, products, a, b, out, work, mem,
                                  copies, n, steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// P3: block b walks members b, b + gridDim.x, ...; work holds 4 f64
// tiles a block (L, X and the next X, L X).  S is the type of the
// members and results; the products run in float64 (DMMA) for both.
template <typename S>
__global__ void __launch_bounds__(kGemmThreads)
    newton_loop_kernel(const S* lm, S* out, double* work, int g, int nb,
                       int steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const size_t nn = (size_t)nb * nb;
  double* l = work + (size_t)blockIdx.x * 4 * nn;
  double* xs[2] = {l + nn, l + 2 * nn};
  double* y = l + 3 * nn;
  for (int m = blockIdx.x; m < g; m += gridDim.x) {
    for (size_t e = threadIdx.x; e < nn; e += kGemmThreads) {
      const double v = lm[m * nn + e];
      l[e] = v;
      xs[0][e] = (e / nb == e % nb ? 2.0 : 0.0) - v;  // X = 2I - L
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      double* x = xs[s & 1];
      newton_product<kNegate>(l, x, y, nb, smem);  // Y = -L·X
      for (int i = threadIdx.x; i < nb; i += kGemmThreads)
        y[(size_t)i * nb + i] += 2.0;              // Y = 2I - L·X
      __syncthreads();
      newton_product<kStore>(x, y, xs[(s + 1) & 1], nb, smem);  // X' = X·Y
    }
    const double* x = xs[steps & 1];
    for (size_t e = threadIdx.x; e < nn; e += kGemmThreads)
      out[m * nn + e] = S(x[e]);
    __syncthreads();
  }
}

// P3 of g members on `blocks` blocks (<= g).
template <typename S>
cudaError_t newton_loop(const S* lm, S* out, double* work, int g, int nb,
                        int steps, int blocks, cudaStream_t st) {
  if (g == 0) return cudaSuccess;
  const size_t smem = NewtonWindow<double>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      newton_loop_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  newton_loop_kernel<S><<<blocks, kGemmThreads, smem, st>>>(lm, out, work, g,
                                                            nb, steps);
  return cudaGetLastError();
}

}  // namespace plu
