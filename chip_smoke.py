#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pangulu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

From the root of the repository, on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It

  1. prints the card's name and power limit and builds the CUDA
     kernels from pangulu_tpu_torch/csrc (timed), printing what ptxas
     says of K1's instances (registers, spills: none may spill), of
     K3's and K5's one-block sweep kernels at tile width 128 (K5's may
     spill at most K5_SPILL_BYTES), of their 6 thread block cluster
     kernels above nb = 128 (csrc/solve_clusters.cuh: at most
     CLUSTER_SWEEP_SPILL_BYTES each) and of the float and double
     instances of K2's and K4's product kernels (panels for bands 128
     and 256 wide; no float instance may spill) and of K1's cluster
     kernel for 128 < nb <= 256 (lu_cluster_kernel, float and double:
     neither may spill) and of K1's kernels above 256 (csrc/wide_lu.cuh:
     no float instance may spill, nor either lu_flow_kernel instance);
  2. holds each kernel against its plain PyTorch version on the same
     CUDA tensors, printing max errors and CUDA-event times beside the
     plain version's: K1 getrf_with_inverses at nb = 10, 16, 64, 128
     and on tiles whose pivot is zero mid-elimination (f32, f64); K1's
     cluster kernel at nb = 129, 200, 255, 256, and on tiles with zero
     pivots in the first and in later panels, against its plain twin
     (getrf_with_inverses_blocked, panels of 32) at the f32 contract and
     the rank-1 plain version at the blocked-LU bound (BLOCKED_TOL), one
     device launch a K1 launch, and true f32 at nb=256 (the f32 kernel's
     error against the f64 twin at most 2x the f32 twin's); K1 timed per
     launch over many back-to-back launches at batch 1, 5, 16 and 132,
     at nb=128 and nb=256, beside torch.linalg.lu_factor_ex(pivot=False)
     as a yardstick;
     the cost of one grid barrier (K3 takes one per level); K2
     mega_factorize and K3 mega_solve (1 and 4 right-hand sides, two
     solves bit-identical) on poisson2d(16) nb=16 (r32 and
     r64) and poisson3d(32) nb=128 (r32), rcm; K4 mega_factorize_groups
     and K5 mega_solve_groups on poisson2d(12) nb=16 nd (uch 64 and 8,
     shared destinations), poisson3d(32) nb=128 nd (r32) and
     poisson2d(24) nb=16 nd (r64); all four at nb=256 (uch =
     mega_uch(256) = 16) on poisson3d(32) r32, rcm and nd, and on
     poisson3d(16) r64, rcm and nd.  Two kernel factorizations of one
     store must be bit-identical; on poisson3d(32) (rcm and nd, nb=128
     and nb=256) the f32 kernel's error against the plain f64
     factorization of the same store must be at most 2x the f32 plain
     version's (true f32), and the f64 kernel must agree with that
     plain f64 one to 1e-12 (its factorization is timed there beside its
     bound at the DMMA rate: K6, K2's double instance, and K4's);
  3. drives the rcm path, init -> gstrf -> gstrs on poisson3d(32) with
     nb=128, r32, device="cuda", with every launch count zeroed before
     and read after (exactly K1 = block_length, K2 = 1, K3 = 3, K4 =
     K5 = 0, and K1's device launches, as the C entries report them,
     one a K1 launch), then times the factorization and the solve (median of
     several, CUDA events), traces one factorization with
     torch.profiler and prints its panel and Schur kernels' device ms
     beside the stage yardsticks: per level, the panel products as one
     torch.bmm and the Schur products as one torch.baddbmm on tiles
     gathered beforehand, full f32;
  4. drives the nested-dissection path the same way with ordering="nd"
     (engines mega_group; exactly K1 = number of groups, K4 = 1, K5 = 3,
     K2 = K3 = 0), times it, compares its stages with their yardsticks
     per group, times the chain engine (K2, K3) forced on the same nd
     schedule, and traces one nd solve: its launches, device and wall
     time and idle share are printed, and it must be exactly 2 launches
     of K5's group_sweep_kernel (one per sweep) and no other K5 kernel;
     K5's cooperative grid and blocks per SM are printed; then drives
     both paths again at nb=256 (exactly K1 = 128 and 34 by the
     schedules, K2 = K4 = 1, K3 = K5 = 3, and K1's device launches
     exactly one a K1 launch, the cluster kernel's; the same residual
     limits; ms per factorization and per solve; the cluster size and
     grid of K3's or K5's sweeps, which must run on clusters) and traces
     one factorization and one solve of each: every kernel's launches
     and device ms, K1's share of the factorization's device ms, and
     the solve exactly 2 launches of solve_cluster_kernel (rcm) or
     group_cluster_kernel (nd) and no other sweep kernel;
  5. solves the reference's config 1, trefethen(20) nb=10 r64, and
     poisson2d(24) nb=16 nd r64 on the grouped path;
  6. drives the rest of the public surface on the nd path of
     poisson3d(32), nb=128, r32, each part with the launch counts zeroed
     before and read after: (a) write_matrix to .mtx and .lid, both read
     back bit-equal, then `python -m pangulu_tpu_torch -f <the .mtx>
     -nb 128 --dtype r32 --ordering nd --check --profile-dir DIR` in a
     subprocess (exit 0, residual < 1e-10, one trace file in DIR); (b) gstrs(trans=True), ||A^T x - b||/||b|| <
     1e-10 after refinement, no hand kernel launched, its time beside the
     forward solve's; (c) update_values with the values scaled by
     (1 + 0.1 u), then gstrf: exactly K1 = number of groups, K4 = 1,
     gstrf residual < 1e-5, its host ms beside init's; (d) gstrs_device
     on a CUDA tensor of 4 right-hand sides with refine=1: a CUDA tensor
     back, 2 K5 calls of 2 device launches each, residuals < 5e-5; (e)
     analyze leaves torch.cuda.memory_allocated() unchanged; (f)
     factor_diagnostics on poisson2d(24), nb=16, r64, nd: logabsdet
     within 1e-10 of splu's with its sign, cond1_est between exact/3 and
     exact (dense f64);
  7. drives tile_storage="compressed" (compressed_phase; step 1 also
     fails if one of the 20 P6/P2 instances spills): init, CompressedLU
     built as gstrf builds it off the panel route (gstrf takes PanelLU
     here, step 7b), its factorization and gstrs on poisson3d(32),
     nb=128, nd, r32 with the launch counts
     zeroed before and read after (exactly K1 = 256 and
     the P6 decompress and compress launches the level structure
     implies, testing.compressed_launches), gstrf residual < 1e-5, solve
     residual < 1e-10, the store's bytes against the dense store's, the
     gstrf peak of max_memory_allocated against the dense nd engines',
     the densified factors against the dense K4 factors (2e-4) and under
     the true-f32 rule (error against the plain f64 factorization <= 2x
     the plain f32 one's), ms per factorization and per solve (CUDA
     events) beside the dense nd engines' of step 4, one traced
     factorization and P6's device ms in it, the factorization once more
     with P6's plain versions in the wrappers' place (its factored
     values must be the kernel path's bit for bit); P6 against its
     plain version bit for bit (float and double, uint16 and uint32
     positions, the TPU probe's one-tile case
     of 1024 slots at nb=128, scratch tiles in the batch); P2 against its
     plain twin (triangle_inverses: the path's 256 diagonal tiles at
     nb=128, 32 tiles at nb=256: f64 within 1e-12, f32 within 1e-5) and
     true f32 against the JAX package's method (the f32 kernel's error
     against the plain f64 doubling <= 2x the plain f32 doubling's, on
     those tiles and, by max and by row, on P3's unit triangles); P6 per
     launch at three batches of the path (pangulu_tpu_torch/tools/
     probe_p6.py p6_batches: (a) the one-tile launch of the largest cap,
     (b) a launch of the median size, (c) the widest level's update
     tiles; the kernels line takes (c)) and P2 per launch at
     batch 256, each beside its bound, its plain version and one
     PyTorch call (zero_ + scatter_, gather, solve_triangular);
     save_factor -> load_factor -> gstrs with exact counts (one P6
     launch for the diagonal tiles, one P2) and the peak device bytes
     of the reload (max_memory_allocated); poisson2d(256)
     nb=128 nd r32 (the panel route; store ratio, solve residual <
     1e-10) and circuit(600, seed=2) nb=32 r64 (CompressedLU; < 1e-6),
     each with its engine; its numbers go out as a {"compressed": ...}
     JSON line;
 7b. drives the out-of-core panel driver (panel_phase; the compressed
     route at r32 and nb 128 or 256 on the card: K2 once a panel cross,
     K1 inside it, P6 for the cross and for each out-update chunk):
     init -> gstrf -> gstrs on poisson3d(32), nb=128, nd, r32, the
     default budget, with exact launches (testing.panel_launches), gstrf
     residual < 1e-5, solve residual < 1e-10, its panel count, the gstrf
     peak of max_memory_allocated, the factors against the dense K4
     factors (2e-4) and under the true-f32 rule, two factorizations of
     one store bit-identical, ms per factorization and per solve (CUDA
     events, median of 7) beside CompressedLU's and the dense nd
     engines', one traced factorization (K1's, K2's products' and P6's
     device ms); save_factor -> load_factor -> gstrs (P6, P2, exact
     counts); gstrf again under PANGULU_OOC_PANEL_GB=0.0625 (width 30,
     9 panels) and PANGULU_OOC_CROSS_GB=0.125 (the width halved), each
     store within 2e-4 of the single panel's; update_values -> gstrf
     (the same store refilled); nb=256 under PANGULU_OOC_PANEL_GB=0.25
     (u32 positions, at least 3 panels); poisson3d(48) at the default
     budget with the host seconds of init and of the store's build; a
     {"panel": ...} JSON line;
  8. drives the complex types through the real 2x2 embedding
     (complex_phase) on poisson3d(32) with imaginary parts
     (testing.with_imaginary_parts: +1 on the diagonal, 0.1 U(-1, 1) on
     the stored off-diagonal entries, seed 0), nb=128: r32 on the real
     part alone and then cr32, with rcm (K1, K2, K3; K1 = the embedded
     block_length, 512) and with nd (K1 batched, K4, K5), their ms per
     factorization and per solve side by side with the time and flop
     ratios, each dense factorization beside its bound; cr64 rcm (the
     double instances of K1, K2, K3); cr32 nd compressed (the panel
     route, testing.panel_launches) on poisson3d(24) with imaginary
     parts, then
     save_factor -> load_factor -> gstrs (P6, P2).  Each run with the
     launch counts zeroed before and read after (exact), the residual
     ||b - A x|| / ||b|| in complex128 against A in the working precision
     (< 1e-10 for cr32 after the default 2 refinement rounds, < 1e-12
     for cr64), two factorizations of one store bit-identical, ms per
     factorization and per solve (CUDA events, median of 7), one traced
     factorization of each dense run (K1's share); a {"complex": ...}
     JSON line;
 8b. drives the multi-device engine (dist_phase; pangulu_tpu_torch/
     parallel): (a) in this process the collective engine on a 1 x 1
     grid (force_collective) on poisson3d(32), nb=128, r32, rcm and nd:
     exactly one K1 launch a distributed group (256 rcm, 90 nd), the
     distributed gstrf check < 1e-5, an unrefined distributed solve <
     1e-5, two factorizations the same bits, the factors within the f32
     tile tolerance of K2's (rcm) and K4's (nd), its wall ms per
     factorization beside theirs; (b) four ranks on a 2 x 2 grid, all on
     this card, joined by gloo (pangulu_tpu_torch/tools/
     run_multiprocess.py; the library built in step 1 first): poisson3d
     (32) nb=128 r32 rcm and nd, and poisson3d(16) nb=128 r64 nd, each
     init -> gstrf(check) -> gstrs of 1 and 3 RHS -> 1 timed
     factorization and solve -> update_values -> gstrf -> gstrs on
     every rank: K1 launches (and device launches) on every rank equal
     to the groups, gstrf residuals < 1e-5 (r32) or 1e-12 (r64), refined
     solve residuals < 1e-10 or 1e-12, two factorizations of a rank the
     same bits, every rank the same x and tables' digest, the 2 x 2 r32
     factors within the f32 tile tolerance of (a)'s (bit-identical or
     not, printed); ms per factorization and per solve, all-reduces and
     MiB a factorization and rank (four ranks sharing one card over
     host-staged gloo: not a scaling result); a {"dist": ...} JSON line;
  9. runs the TPU probes' kernels (probes_phase; step 1 also fails if
     one of their 20 instances spills): P5 scan_overlap in its four
     modes (acc's column strips over 16 CTAs) and P4 scan_multi at Q =
     1, 2, 4, 8 without and with the products (on clusters of 8 and 16
     CTAs), at 128 and 256 steps on the probes' inputs
     (testing.probe_inputs), P4 and P5 (split) with 3 copies at n = 100,
     and P3 newton_loop at G = 4 and 16, nb = 16, 100 and 128, on unit
     triangles and on a batch with a general member
     (testing.newton_mixed_inputs), at the probe's steps and at 0 and 2,
     on clusters of 4, 8 and 16 CTAs, each against its plain version:
     float32 true f32 (the kernel's error against the plain float64
     version at most 2x the plain float32 version's, relative to max
     |f64|, for P3 to each row's max, or one f32 eps), P3's float64
     within 1e-12 of each row's max; the instances with 3xTF32 products
     (timed only) within 1e-4 of max |f64| at 128 steps; with b = 0 (the
     products stay 0), every instance with products bit-equal to the one
     without, at the probes' own 4096 (P5) and 2048 (P4) steps, which
     checks their scan part; then, with the launch counts zeroed before
     and read after (each probe kernel launched at least once), the
     probes' own path: pangulu_tpu_torch/tools/probe_{overlap,
     scan_multi,newton_loop}.run at the probes' sizes (4096 and 2048
     steps, G up to 16), which print their tables and time one cluster
     barrier at each cluster size beside a grid barrier; those sizes are
     timed only (the chain of products leaves float32's range); the
     plain versions timed at the kernels line's sizes; a {"probes": ...}
     JSON line (with each probe's bound on the SMs it runs on);
 9b. drives the fused and levels engines (xla_engines_phase; the JAX
     package's XLA engines, the only ones above nb = 256 and for native
     complex; step 1 also fails if a float instance of the 10 kernels of
     K1 for wide tiles, csrc/wide_lu.cuh, spills): (a) K1's cluster
     kernel's plan (CTAs, rows, shared memory, stripe) from the C side
     against kernels_cuda.wide_plan at every nb up to 512, and the
     clusters that fit; K1 at nb = 288, 384, 512 and 640, float and
     double, batch 1 and 4, against its plain twin (kernels_torch.
     k1_wide: the blocked step over the whole tile, or on the leaves
     of k1_leaf_width) at the contract and the rank-1 scan at
     BLOCKED_TOL, and with zero pivots at 0 and wide_split(nb) (float
     U^-1 at 640 by testing.zero_pivot_uinv_errors); one K1 launch a
     call, of kernels_cuda.k1_device_launches (the flow kernel's one at
     640 but for float64 batch 4: 7); true f32
     at nb = 512; per launch device ms beside the bound, the twin and
     lu_factor_ex; (b) init -> gstrf -> gstrs on poisson3d(32), nb=512,
     r32, rcm and nd, dispatch auto: engine fused on backend cuda, K1
     once a level (64, one device launch each) and no other kernel,
     gstrf residual on the card
     < 1e-5, refined solve residual < 1e-10, ms per factorization and
     per solve, one traced factorization each (K1's device ms and
     share); (c) the same at r64 rcm (< 1e-12); (d) levels with
     panel_solve="trsm" on (b)'s rcm store (within 1e-5 of fused, solve
     < 1e-10), and gstrf at nb=384 nd (86 levels); (e)
     complex_mode="native", cr32 and cr64, nb=128, nd, on poisson3d(24)
     with imaginary parts: fused on backend torch, no hand kernel,
     residuals < 1e-10 / 1e-12, within 1e-6 / 1e-9 of the embedding's
     solution; an {"xla_engines": ...} JSON line;
 9c. drives the compressed store and the multi-device engine at nb >
     256 and with native complex tiles (wide_native_stores_phase): (a)
     P6 at nb = 288, 384, 512 on the widest level of poisson3d(32)'s rcm
     store at that nb, float32, float64, complex64 and complex128 slots
     (4-, 8- and 16-byte words), bit-equal to its plain versions, and
     per launch at nb=512 beside its bound, the plain versions and
     zero_ + scatter_ / gather; (b) P2 at nb = 384 and 512 (the sweeps on
     128-wide leaves, one products launch a level of its tree) against
     its twin (f64 1e-12, f32 1e-5), per launch beside solve_triangular;
     (c) init -> gstrf -> gstrs with tile_storage="compressed" on
     poisson3d(32), nb=512, r32 rcm and nd and r64 rcm (CompressedLU, K1
     for wide tiles as its diagonal step): exact launch counts, one K1
     device launch a level, gstrf residual on the card < 1e-5 (r64
     1e-12), refined solve < 1e-10 (r64 1e-12), the factors within the
     tile tolerance of the fused engine's, ms per factorization and per
     solve, store bytes against dense, a traced r32 factorization of
     each ordering (K1's and P6's device ms and share), save -> load ->
     gstrs with one P2 launch; (d) complex_mode="native" compressed,
     cr32 and cr64, poisson3d(16) with imaginary parts, nb=128, rcm: P6
     on complex slots with exact counts, no K1 or P2, residuals < 1e-10
     / 1e-12, a reload, and P6 per launch on complex128 slots; (e) 2 x 2
     gloo ranks on this card: poisson3d(32) nb=512 r32 rcm and native
     cr64 on poisson3d(16), launches, residuals, the same bits on every
     rank; prints its seconds and a {"wide_native_stores": ...} line;
 10. drives the last public pieces (extras_phase, ~40 s): (a)
     profile_dir on a gstrf of poisson3d(32) nb=128 nd r32 (plain,
     traced, traced, plain: exact launch counts, one Chrome trace file
     a traced call holding K1 and K4 kernel events, the same factor
     bits, host ms of each); (b) the examples of pangulu_tpu_torch/
     examples through main() on the card, with their asserts and exact
     launch counts; (c) pangulu_tpu_torch/tools/demo_outofcore.py as a
     subprocess on poisson3d(DEMO_NX) under --device-gib DEMO_GIB,
     below its dense store (exit 0, several panels, peak allocation
     below the cap and the dense bytes, residual < 1e-4); (d) K1 at
     EXTRAS_SPLIT_NB = 1088, one device launch of the flow kernel,
     against its plain twin in f32 and f64; prints an {"extras": ...}
     line;
 10b. drives the JAX package's superfused and segmented engines
     (superfused_phase, ~35 s): (a) poisson3d(32) nd r32 at nb = 128,
     256 and 512, LUFactorizer(dispatch="superfused") on a fresh store
     with the counts zeroed before and read after: exactly one K1
     launch (one device launch) a super-level (25, 15, 10) and no K2-K5
     launch, the factor within 1e-5 of the fused engine's on the same
     store, two runs the same bits, gstrf residual on the card < 1e-5,
     gstrs through the handle (the solve auto picks: K5 on inverses
     rebuilt from the factor at nb <= 256, the fused level solve at
     512) < 1e-10 and its ms, ms per factorization beside fused's and,
     at nb <= 256, mega_group's, one traced factorization of each at 512 (K1's device ms and share,
     busy against wall); (b) the same at r64 nb=256 (K7's cluster
     kernel on batches up to 48; residuals < 1e-12); (c) native cr32
     on poisson3d(24) with imaginary parts, nb=128 (backend torch, no
     hand kernel, residual < 1e-10, ms beside fused's); (d) rcm at
     nb=128: 256 K1 launches and fused's bits; (e) dispatch
     "segmented", taken as the fused engine: fused's bits; (f) K1 on
     each widest super-level's batch (85, 48, 27 tiles; 48 in f64) as
     the path gives it, against its twin, beside its bound and
     lu_factor_ex; a {"superfused": ...} line;
 10c. drives K2's chain-ahead (chain_ahead_phase, PANGULU_TPU_SUPERLEVEL
     =1: the levels in dependency-depth order, each same-depth level's
     diagonal step run on a second stream beside the level before it):
     (a) r32 on poisson3d(32) nd at nb = 128 and 256, smallworld(90) nd
     and circuit(20000) nd at nb=128, and poisson3d(32) rcm (nothing
     flagged: the original tables), dispatch="mega" with the switch
     unset and set and mega_group on one store: exact counts (K1 = bl,
     K2 = 1, the steps run ahead = the flagged levels), the same bits
     with the second stream off, the factor within 2e-4 of the level
     order's, gstrf residual < 1e-5, solve residual < 1e-10 (elsewhere
     than poisson3d both within 2x the level order's), ms per
     factorization of the four; (b) at nb =
     128 and 256 on poisson3d(32) nd, K2 on the chain-ahead tables
     against its plain version at TOL_F32 (the "chain_ahead" entry of
     K2 in the kernels line, from nb=128); (c) the panel driver with
     the switch set
     and unset (exact counts, residuals, the stores within 2e-4, ms);
     (d) one traced chain-ahead factorization of each (b) case: busy
     over both streams, idle share, K1's share and the K1 intervals
     that overlap a product kernel (nb=128 must show some); a
     {"chain_ahead": ...} line;
 10d. drives K1 above 512 on the flow kernel (flow_phase, csrc/
     wide_lu.cuh lu_flow_kernel: one cooperative launch a call, its
     CTAs passing the panels by ready flags, where the batch fits on
     the card at once): (a) its plan, C side against kernels_cuda, at
     every nb up to W_T (1408 in f32, 1120 in f64), and the leaf width
     a batch; (b) K1 at 640, 768, 1024, 1088 and W_T, float and double,
     batch 1 and 4: kernels_cuda.k1_device_launches a call (one at
     batch 1), against its plain twin,
     per launch beside its bound, the twin and lu_factor_ex; the flow
     kernel alone at 512 beside the cluster kernel; (c) poisson3d(32) at
     nb=1024 through the fused engine (r32 and r64, rcm) and superfused
     (r32, nd): exact K1 launches and device launches,
     residuals, the factor against the same engine on the plain twin,
     ms per factorization, one trace (K1's device ms and share, busy,
     wall, idle); a {"flow": ...} line;
 11. with --profile, also traces one rcm solve and prints, per phase,
     each kernel's launches and device time, the host wall time and the
     device's idle share (K3's solve: exactly 2 launches of its sweep
     kernel);
 12. prints the numbers of step 6 as one JSON line, then one JSON
     line of per-kernel results, K1-K5 at nb=128 and again at nb=256
     (named name@nb=256, its launches from the nb=256 paths; K1 also
     with "dist_launches", a rank's in each case of step 8b (b)), P6
     (decompress_tiles, compress_tiles) and P2 (newton_inverses), their
     launches from the compressed path and the reloaded factor (K1, K2
     and P6 also with "panel_launches", those of step 7b's main path;
     K1 at nb = 128, 256 and 512 also with "superfused_launches", step
     10b (a)'s; K2 also with "chain_ahead", step 10c's variant: its
     error against its plain version, ms, launches, the steps run
     ahead, bound),
     and the
     probes P5, P4, P3 (scan_overlap at mode both and 4096 steps,
     scan_multi at Q = 8 with products and 2048 steps, both with DMMA
     products, P4's on its default cluster, kernels_cuda.SCAN_CLUSTER;
     newton_loop at G = 16 on clusters of kernels_cuda.NEWTON_CLUSTER;
     launches from the probes' path, none on the solver's), K1 at
     nb = 512 and 384 (getrf_with_inverses@nb=512 and @nb=384, the
     cluster kernel of csrc/wide_lu.cuh; launches from step 9b's rcm
     path at 512 and nd gstrf at 384, and at 512 also those of step
     9c's compressed path), K1 at nb = 1024 (getrf_with_inverses@nb=1024,
     the flow kernel; launches from step 10d's fused r32 rcm path), P6 at nb=512 (float32 slots, launches from
     step 9c's compressed r32 rcm path) and at nb=128 on complex128
     slots (step 9c (d)), P2 at nb=512 (launches from step 9c's
     reload), with
     max_rel_err, their
     largest difference from the plain float32 version over max |plain
     f64| (P3: each row's):
     time, launches, error, plain and library times, and the bound:
     the larger of the bytes over 3.35 TB/s and the operations over
     the H100 SXM's published peak for the units that run them: 495 /
     3 TFLOP/s (3xTF32 on tensor cores) for K2's and K4's f32
     products and for the products of K1's cluster kernel (67 TFLOP/s
     DMMA in f64), 67 TFLOP/s f32 (34 f64) on the CUDA cores for the
     rest, K1's register-tile chains among them (P2's operations are
     those of two triangle inverses, not of its doubling's products);
     the CUDA-core bound of K2 and K4 is kept in the details file; the
     probes' products at 67 TFLOP/s (they run as DMMA on float64
     copies); P3's bound is its function's, G unit-triangle inverses
     (the members in and out, nb^3/3 flop each), not its doubling's
     products.
     Before it, a {"retraced": ...} line names any phase whose trace
     was taken again (up to 3 more times), with its number of traces:
     the nb=128 nd solve's when it showed fewer than its 2 K5 launches,
     the nb=256 rcm and nd solves' when they showed fewer than their 2
     cluster kernel launches, the gstrs_device call's when it showed
     fewer than its 4 K5 launches (the profiler loses the first kernels
     of some traces; the last trace is checked as the first; any other
     empty trace fails); then the last line {"ok": true, "device":
     {...}}.

Any failure raises and exits non-zero.  Without a CUDA device, or
without the package beside this file, it prints no result and exits 2.
Details go to pangulu_tpu_torch/_build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = "pangulu_tpu_torch/csrc/lu_kernels.cu"
# K1's body; its kernel and launch are in SRC
SOURCE = {"getrf_with_inverses": "pangulu_tpu_torch/csrc/tile_lu.cuh",
          "decompress_tiles": "pangulu_tpu_torch/csrc/compressed.cuh",
          "compress_tiles": "pangulu_tpu_torch/csrc/compressed.cuh",
          "newton_inverses": "pangulu_tpu_torch/csrc/compressed.cuh",
          "scan_overlap": "pangulu_tpu_torch/csrc/probes.cuh",
          "scan_multi": "pangulu_tpu_torch/csrc/probes.cuh",
          "newton_loop": "pangulu_tpu_torch/csrc/probes.cuh"}
# above nb = 128 K3's and K5's kernels are thread block clusters of their
# own (their launch in SRC); K1's cluster kernel is in SRC
SOURCE_256 = {"mega_solve": "pangulu_tpu_torch/csrc/solve_clusters.cuh",
              "mega_solve_groups": "pangulu_tpu_torch/csrc/solve_clusters.cuh"}
# above nb = 256 K1 is the cluster kernel of csrc/wide_lu.cuh (and a
# recursion on it above 512)
SOURCE_WIDE = "pangulu_tpu_torch/csrc/wide_lu.cuh"
# the dense store's kernels (each also at nb=256) and the compressed
# store's (csrc/compressed.cuh)
DENSE = ("getrf_with_inverses", "mega_factorize", "mega_solve",
         "mega_factorize_groups", "mega_solve_groups")
COMPRESSED = ("decompress_tiles", "compress_tiles", "newton_inverses")
# the TPU probes P5, P4, P3 (csrc/probes.cuh), on no path of the solver
PROBES = ("scan_overlap", "scan_multi", "newton_loop")
REPLACES = {
    "getrf_with_inverses": "pangulu_tpu/ops/kernels_pallas.py:599",
    "mega_factorize": "pangulu_tpu/ops/kernels_pallas.py:1187",
    "mega_solve": "pangulu_tpu/ops/kernels_pallas.py:2155",
    "mega_factorize_groups": "pangulu_tpu/ops/kernels_pallas.py:1915",
    "mega_solve_groups": "pangulu_tpu/ops/kernels_pallas.py:2350",
    "decompress_tiles": "tools/exp_scatter.py:73",
    "compress_tiles": "tools/exp_scatter.py:73",
    "newton_inverses": "tools/exp_batched_scan.py:87",
    "scan_overlap": "tools/exp_overlap.py:64",
    "scan_multi": "tools/exp_scan_multi.py:63",
    "newton_loop": "tools/exp_batched_scan.py:123",
}
# Tolerances (the JAX package's own contract, ROADMAP.md "Tolerances",
# tests/test_mega.py:31,82, tests/test_mega_group.py:66,140): rtol, atol.
# Grouped f32 factors sum a group's updates in another order: 2e-4.
TOL_F32 = (1e-5, 1e-5)
TOL_GROUP_F32 = (2e-4, 2e-4)
TOL_SOLVE_F32 = (1e-4, 1e-5)
TOL_F64 = (1e-12, 1e-12)
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# FLOP/s outside the tensor cores, float32 and float64.
HBM_BYTES_S = 3.35e12
FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}
# The same sheet's tensor-core peaks, for the products' own bound:
# 3xTF32 is three TF32 passes (495 TFLOP/s / 3), DMMA 67 TFLOP/s.
TC_FLOP_S = {torch.float32: 495e12 / 3, torch.float64: 67e12}
# K1's cluster kernel for 128 < nb <= 256 is held to the rank-1 plain
# version at pangulu_tpu_torch.testing.BLOCKED_TOL (the JAX package's
# bound for its blocked LU against the scan), and to its plain twin
# (getrf_with_inverses_blocked) at TOL_F32 / TOL_F64.
# K2's and K4's product kernels (csrc/lu_kernels.cu), one instance each
# for float and double (panels: one for bands 128 wide, one for 256)
PRODUCT_KERNELS = ("panel_kernel", "schur_kernel", "group_panel_kernel",
                   "group_schur_kernel")
PRODUCT_INSTANCES = 12
# P6: decompress and compress for slot words of 4, 8 and 16 bytes
# (float32; float64 and complex64; complex128), uint16 and uint32
# positions; P2: triangle_inverses for float and double, register tiles
# of 32, 64 and 128, and the products of its tree's levels above 128
COMPRESSED_INSTANCES = 20
# P5: overlap_kernel in 4 modes, the 3 with products in float64 (DMMA)
# and in 3xTF32; P4: scan_multi_kernel<C, P> without products (C = 0),
# and with them in either type on clusters of 4, 8, 16; P3:
# newton_loop_kernel<type, C> for float and double, C = 4, 8, 16
PROBE_INSTANCES = 20
# K1 above nb = 256 (csrc/wide_lu.cuh): lu_wide_kernel<type, rows> for
# float and double; up to W_T lu_flow_kernel<type, rows> for float and
# double; above W_T wide_gemm_kernel<type, op> for float and double and
# the three store ops, wide_copy_kernel<type>
WIDE_INSTANCES = 12
# SMs of an H100 SXM: a probe's bound on the s SMs it runs on is the
# card's operations bound times this / s (kept in the details file)
SMS = 132
# P4's and P5's 3xTF32 instances, timed only, are held within this of
# max |plain f64| at 128 steps (they drift on the chain of products,
# ~7e-6 there, against plain f32's ~2e-6: not true f32, by design)
TF32X3_REL = 1e-4
# K5's sweep kernel sits at the 64-register cap of 1024-thread blocks;
# its spill bytes may not exceed these, by type (tile width 128: above,
# the cluster kernels below take the tiles; more spills have made it
# slower every time at 128)
K5_SPILL_BYTES = {("float", 128): 12, ("double", 128): 148}
# K3's and K5's cluster kernels for 128 < nb <= 256 (csrc/
# solve_clusters.cuh): solve_cluster_kernel<type, 16> and
# group_cluster_kernel<type, 4> and <type, 2> for float and double; their
# spill bytes may not exceed these, by type (K5's double instance on
# clusters of 2 sits at the 64-register cap of 1024-thread CTAs, as the
# one-block kernel does)
CLUSTER_SWEEP_INSTANCES = 6
CLUSTER_SWEEP_SPILL_BYTES = {"float": 0, "double": 148}


def bound(nbytes: float, flop: float, dtype=torch.float32,
          peak=FLOP_S, tc_flop: float = 0.0) -> dict:
    """The least time the card could take for work that moves nbytes
    and does flop operations of dtype at the rate peak[dtype], and
    tc_flop more on the tensor cores (TC_FLOP_S[dtype]), which run
    beside the CUDA cores; and which of the two, bytes or operations,
    sets it."""
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = max(flop / peak[dtype], tc_flop / TC_FLOP_S[dtype]) * 1e3
    return dict(bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def lu_inverse_flop(nb: int) -> int:
    """Operations of K1 on one tile: the LU's divisions and rank-1
    updates, then the Gauss-Jordan steps of L^-1 and of U^-1."""
    k = np.arange(nb)
    r = nb - k - 1
    return int((r + 2 * r * r).sum() + (2 * r * k).sum()
               + ((nb - k) + 2 * k * (nb - k)).sum())


def unit_triangle_inverse_flop(nb: int) -> int:
    """Operations of the inverse of one nb x nb unit-lower triangle,
    whatever the algorithm: entry (i, j), i > j, is an inner product of
    i - j terms."""
    d = np.arange(1, nb)
    return int((2 * d * (nb - d)).sum())


def triangle_inverses_flop(nb: int) -> int:
    """Operations the function of P2 needs on one tile, whatever the
    algorithm: the inverse of a unit-lower triangle and that of an upper
    triangle (the same, plus one scaling by D^-1 for each entry of the
    triangle)."""
    return 2 * unit_triangle_inverse_flop(nb) + nb * (nb + 1) // 2


def k1_bound(nb: int, batch: int, dtype) -> dict:
    """K1's bound on batch tiles of nb: the tile read and its factor and
    two inverses written; lu_inverse_flop(nb) operations a tile.  Up to
    nb = 128 all run on the CUDA cores.  Above, the cluster kernel runs
    the 32 x 32 diagonal blocks of its panels on the CUDA cores and the
    rest of the operations as products on tensor cores."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * batch * nb * nb * elt
    flop = batch * lu_inverse_flop(nb)
    if nb <= 128:
        return bound(nbytes, flop, dtype)
    chains = batch * sum(lu_inverse_flop(min(32, nb - k0))
                         for k0 in range(0, nb, 32))
    return bound(nbytes, chains, dtype, tc_flop=flop - chains)


def p2_bound(nb: int, batch: int, dtype) -> dict:
    """P2's bound on batch factored tiles of nb: the factor read and
    L^-1 and U^-1 written; triangle_inverses_flop(nb) operations a tile.
    The sweeps of its 128-wide diagonal blocks run on the CUDA cores;
    above nb = 128 the rest, the off-diagonal blocks of its tree of
    halves, runs as products on tensor cores."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 3 * batch * nb * nb * elt
    flop = batch * triangle_inverses_flop(nb)
    sweeps = batch * sum(triangle_inverses_flop(min(128, nb - k0))
                         for k0 in range(0, nb, 128))
    return bound(nbytes, sweeps, dtype, tc_flop=flop - sweeps)


def ptxas_by_kernel(log: str) -> dict:
    """Per entry function of an ``nvcc -Xptxas -v`` log: its registers,
    its spill bytes (stores + loads) and the lines that say so."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            cur = out.setdefault(m.group(1), {"lines": []})
        if cur is None or not ("spill" in ln or "registers" in ln):
            continue
        cur["lines"].append(ln.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
    return out


def kernel_label(name: str):
    """(kernel, "float" or "double", its int template argument or None)
    of a mangled plu:: kernel name, or None for any other name."""
    m = re.search(r"plu\d+(\w+?_kernel)I([fd])(?:Li(\d+)E)?E", name)
    if not m:
        return None
    return (m[1], dict(f="float", d="double")[m[2]],
            int(m[3]) if m[3] else None)


def sweep_label(name: str):
    """(kernel, "float" or "double", cluster size) of a mangled K3 or K5
    cluster kernel name, or None for any other name."""
    m = re.search(r"plu\d+(solve_cluster_kernel|group_cluster_kernel)I([fd])"
                  r"Li(\d+)EE", name)
    if not m:
        return None
    return m[1], dict(f="float", d="double")[m[2]], int(m[3])


def fail(msg: str) -> None:
    raise AssertionError(msg)


def compare(name, got, ref, rtol, atol):
    """max |got - ref| and max relative error; raise unless
    |got - ref| <= atol + rtol |ref| everywhere and all is finite."""
    got64, ref64 = got.double(), ref.double()
    if not torch.isfinite(got64).all():
        fail(f"{name}: non-finite values")
    diff = (got64 - ref64).abs()
    bound = atol + rtol * ref64.abs()
    abs_err = float(diff.max())
    rel_err = float((diff / ref64.abs().clamp_min(1e-30)).max())
    ok = bool((diff <= bound).all())
    print(f"  {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
          f"(rtol={rtol:g}, atol={atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with the plain version")
    return abs_err


def rel_err(got, ref64, per_row: bool = False) -> float:
    """The largest error relative to the result's scale, max |got -
    ref| / max |ref|, in float64; per_row: the scale of each row (the
    last dimension) for that row's errors, so that rows of small entries
    count as much as those of large ones."""
    diff = (got.double() - ref64).abs()
    if not per_row:
        return float(diff.max() / ref64.abs().max())
    scale = ref64.abs().amax(-1, keepdim=True).clamp_min(1e-300)
    return float((diff / scale).max())


def cuda_ms(fn, setup=lambda: None, reps=5, warmup=1) -> float:
    """Median CUDA-event time of fn(setup()) in ms; setup runs outside
    the timed region."""
    for _ in range(warmup):
        fn(setup())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int, reps: int = 3) -> float:
    """Device ms per call of fn over n back-to-back calls between one
    pair of CUDA events, median of reps.  The calls are queued behind a
    device sleep, so the card runs them without waiting on the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


# per traced phase that took a second trace, the traces it took (written
# out as a JSON line)
RETRACED = {}


def trace_once(fn, arg, pause: float = 0.0, events=None) -> tuple:
    """One call fn(arg) under torch.profiler, ``pause`` seconds after the
    trace starts (pangulu_tpu_torch/tools/probe_profiler.py weighs a
    pause): (host wall ms of the call, launch to synchronise; the device
    intervals; per kernel name its launches and device ms).  ``events``,
    a list, receives each device event as (start us, end us, name, the
    profiler's device resource id: the stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(pause)
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        name = e.name.split("(")[0].removeprefix("void ")
        if events is not None:
            events.append((lo, hi, name,
                           getattr(e, "device_resource_id", None)))
        k = kernels.setdefault(name, {"launches": 0, "device_ms": 0.0})
        k["launches"] += 1
        k["device_ms"] += (hi - lo) * 1e-3
    return wall_ms, spans, kernels


def profile(fn, setup=lambda: None, retry: str = "",
            complete=lambda kernels: True) -> dict:
    """Trace one call of fn(setup()) after a warm-up: per kernel name its
    launches and device ms, the host wall ms of the call (launch to
    synchronise), the device's busy ms (union of kernel intervals) and
    its idle share of the wall time.  A trace with no device activity
    fails, unless ``retry`` names the phase: then a trace with none, or
    one whose kernels fail ``complete`` (the profiler loses the first
    kernels of some traces, twice in a row once), is taken again, up to
    3 more times, and the phase goes into RETRACED with the number of
    traces; the caller checks the last trace as it would the first."""
    fn(setup())
    wall_ms, spans, kernels = trace_once(fn, setup())
    for n in range(2, 5):
        if not retry or (spans and complete(kernels)):
            break
        print(f"  (the profiler recorded {'no' if not spans else 'too few'}"
              f" kernels in {retry}; tracing again)")
        RETRACED[retry] = n
        wall_ms, spans, kernels = trace_once(fn, setup())
    if not spans:
        fail("the profiler saw no device activity")
    busy_ms = union_us(spans) * 1e-3
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, kernels=kernels)


def union_us(spans) -> float:
    """The length of the union of the intervals (lo, hi): a device's
    busy time, whatever stream each kernel ran on."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def print_profile(prof: dict) -> None:
    for phase, p in prof.items():
        print(f"  profile {phase}: wall {p['wall_ms']:.3f} ms, device "
              f"busy {p['busy_ms']:.3f} ms, idle share "
              f"{p['idle_share']:.3f}")
        for name, k in sorted(p["kernels"].items(),
                              key=lambda kv: -kv[1]["device_ms"]):
            print(f"    {name}: {k['launches']} launches, "
                  f"{k['device_ms']:.3f} device ms")


def timed_calls(calls, reps: int = 3) -> float:
    """Device ms of ``calls`` (pairs of a function and its arguments),
    each between its own pair of CUDA events and summed, all queued
    behind a device sleep so that the card runs them without waiting on
    the host; median of reps."""
    for fn, a in calls:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in calls]
        torch.cuda._sleep(100_000_000)
        for (start, end), (fn, a) in zip(ev, calls):
            start.record()
            fn(*a)
            end.record()
        torch.cuda.synchronize()
        times.append(sum(start.elapsed_time(end) for start, end in ev))
    return statistics.median(times)


def stage_yardsticks(tiles, invs, tables, grouped: bool) -> dict:
    """The yardstick of each product stage of K2 (chain) or K4 (groups),
    which the port never calls: per level or group, the panel products
    as one torch.bmm and the Schur products as one torch.baddbmm (dst -
    L·U), in full f32 (allow_tf32 is False), on tiles gathered
    beforehand (the gathers are not timed).  Returns the summed device
    ms of each stage.  A group's updates that share a destination are
    separate products here; the kernel sums them before it subtracts."""
    from pangulu_tpu_torch.schedule import group_update_lists

    h, d = tables.host, tables.dev
    calls = {"panel": [], "schur": []}

    def add(lt, linv, uinv, ut, dst=None, lu=None, uu=None):
        a, b = torch.cat([lt, linv]), torch.cat([uinv, ut])
        if len(a):
            calls["panel"].append((torch.bmm, (a, b)))
        if dst is not None and len(dst):
            calls["schur"].append((
                lambda c, x, y: torch.baddbmm(c, x, y, alpha=-1),
                (tiles[dst], tiles[lu], tiles[uu])))

    def on_dev(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=tiles.device)

    if grouped:
        updates = group_update_lists(h)
        for g in range(int(h["ngroups"])):
            gs = int(h["gs_tab"][g])
            lev = d["glev_tab"][g, :gs].long()
            lm, um = (on_dev(np.repeat(np.arange(gs),
                                       np.diff(h[o][g][:gs + 1])))
                      for o in ("gloff_tab", "guoff_tab"))
            lids = d["lid_tab"][g, :len(lm)].long()
            uids = d["uid_tab"][g, :len(um)].long()
            dst, ul, uu = (on_dev(x) for x in updates[g])
            add(tiles[lids], invs[lev[um], 0], invs[lev[lm], 1], tiles[uids],
                dst, lids[ul], uids[uu])
    else:
        uch, nb = int(h["uch"]), tiles.shape[-1]
        for k in range(len(h["diag_tab"])):
            nl, nu, nup = (int(h[t][k]) for t in ("nl_tab", "nu_tab",
                                                   "nup_tab"))
            lids = d["lid_tab"][k, :nl].long()
            uids = d["uid_tab"][k, :nu].long()
            dst, ul, uu = (d[t][k, :, :uch].reshape(-1)[:nup].long()
                           for t in ("udst_tab", "udl_tab", "udu_tab"))
            add(tiles[lids], invs[k, 0].expand(nu, nb, nb),
                invs[k, 1].expand(nl, nb, nb), tiles[uids], dst, lids[ul],
                uids[uu])
    return {f"{s}_library_ms": timed_calls(c) for s, c in calls.items()}


def cycle_parity(p) -> int:
    """Sign of the permutation p, from its cycle lengths."""
    p, seen, sign = np.asarray(p), np.zeros(len(p), bool), 1
    for i in range(len(p)):
        j, length = i, 0
        while not seen[j]:
            seen[j], j, length = True, p[j], length + 1
        if length and length % 2 == 0:
            sign = -sign
    return sign


def surface_phase(a, dev) -> dict:
    """The rest of the public surface on the nd path of poisson3d(32),
    nb=128, r32 (the matrix ``a``), with the launch counts zeroed before
    and read after each part: (a) the CLI on files written and read
    back, (b) the transpose solve, (c) update_values + gstrf, (d)
    gstrs_device, (e) analyze; then (f) factor_diagnostics on
    poisson2d(24), nb=16, r64, nd.  Returns its numbers; any failure
    raises."""
    import os
    import tempfile

    import scipy.sparse.linalg as spla

    from pangulu_tpu_torch import (InitOptions, analyze, factor_diagnostics,
                                   gstrf, gstrs, gstrs_device, init,
                                   update_values)
    from pangulu_tpu_torch.io.mmio import read_matrix, write_matrix
    from pangulu_tpu_torch.models import poisson2d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.utils.perf import residual_norm

    out = {}
    opts = dict(nb=128, dtype="r32", ordering="nd", device="cuda")
    s = a.to_scipy()

    def zero_but(**counts):
        return {k: counts.get(k, 0) for k in kc.LAUNCHES}

    def expect_launches(what, want):
        got = dict(kc.LAUNCHES)
        print(f"  launches: {got}")
        if got != want:
            fail(f"{what}: launch counts {got}, expected {want}")
        return got

    # (a) files and the CLI
    print("surface (a): write_matrix -> .mtx and .lid, read back, and "
          "python -m pangulu_tpu_torch on the .mtx")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ext: os.path.join(tmp, f"p3d32.{ext}") for ext in
                 ("mtx", "lid")}
        for p in paths.values():
            write_matrix(p, a)
        back = {ext: read_matrix(p, dtype=np.float64)
                for ext, p in paths.items()}
        for ext, m in back.items():
            for f in ("colptr", "rowidx", "values"):
                if not np.array_equal(getattr(m, f), getattr(a, f)):
                    fail(f"the .{ext} file read back another CSC ({f})")
        print(f"  .mtx and .lid read back bit-equal (n={a.n}, nnz={a.nnz})")
        prof = os.path.join(tmp, "prof")
        cmd = [sys.executable, "-m", "pangulu_tpu_torch", "-f",
               paths["mtx"], "-nb", "128", "--dtype", "r32", "--ordering",
               "nd", "--check", "--profile-dir", prof]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ,
                                                   PYTHONPATH=str(ROOT)))
        out["cli_wall_s"] = time.perf_counter() - t0
        traces = list(pathlib.Path(prof).glob("*.pt.trace.json"))
    if res.returncode != 0:
        fail(f"the CLI exited {res.returncode}:\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    if len(traces) != 1:
        fail(f"the CLI with --profile-dir wrote {len(traces)} trace files, "
             "expected 1")
    line = [ln for ln in res.stdout.splitlines() if "solve residual" in ln]
    out["cli_residual"] = float(line[-1].split("=")[1]) if line else None
    out["cli_stdout"] = res.stdout
    print(f"  CLI: exit 0 in {out['cli_wall_s']:.3f} s (wall, process start "
          f"to exit), solve residual {out['cli_residual']:.3e} (< 1e-10), "
          f"one trace file in --profile-dir")
    if not (out["cli_residual"] is not None and out["cli_residual"] < 1e-10):
        fail("the CLI's solve residual is missing or too large")

    # the handle of parts (b) to (e)
    print("surface: init -> gstrf, poisson3d(32), nb=128, r32, nd, cuda")
    t0 = time.perf_counter()
    h = init(a, InitOptions(check=True, **opts))
    out["init_host_ms"] = (time.perf_counter() - t0) * 1e3
    gstrf(h)
    ng = h._factorizer.tables.host["ngroups"]

    # (b) the transpose solve
    print("surface (b): gstrs(trans=True)")
    rng = np.random.default_rng(7)
    xt = rng.standard_normal(a.n)
    bt = s.T @ xt
    kc.reset_launch_counts()
    x = gstrs(h, bt, trans=True)
    expect_launches("the transpose solve (PyTorch ops, no hand kernel)",
                    zero_but())
    out["trans_residual"] = residual_norm(s.T.tocsc(), x, bt)
    print(f"  ||A^T x - b||/||b|| after refinement = "
          f"{out['trans_residual']:.3e} (< 1e-10)")
    if not out["trans_residual"] < 1e-10:
        fail("the transpose solve's residual is too large")
    ts = h._trisolver
    xb = ts.blockify_rhs(h.reordering.transform_b_trans(
        bt.astype(np.float32)))
    out["trans_solve_ms"] = cuda_ms(
        lambda _: ts.solve_blocked_trans(h.factor_tiles, xb), reps=5)
    out["forward_solve_ms"] = cuda_ms(
        lambda _: ts.solve_blocked(h.factor_tiles, xb), reps=5)
    t0 = time.perf_counter()
    gstrs(h, bt, trans=True)
    out["gstrs_trans_host_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"  one solve, CUDA events, median of 5: transpose "
          f"{out['trans_solve_ms']:.3f} ms, forward (K5) "
          f"{out['forward_solve_ms']:.3f} ms; gstrs(trans=True) with 2 "
          f"refinement rounds {out['gstrs_trans_host_ms']:.3f} host ms")
    p = profile(lambda _: ts.solve_blocked_trans(h.factor_tiles, xb))
    out["trans_trace"] = p
    print_profile({"transpose solve": p})

    # (c) the refactorization
    print("surface (c): update_values (values x (1 + 0.1 u)) -> gstrf")
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.1 * np.random.default_rng(8).random(
        s2.nnz))
    t0 = time.perf_counter()
    update_values(h, s2)
    out["update_values_host_ms"] = (time.perf_counter() - t0) * 1e3
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    gstrf(h)
    torch.cuda.synchronize()
    out["refactor_gstrf_host_ms"] = (time.perf_counter() - t0) * 1e3
    out["refactor_launches"] = expect_launches(
        "update_values + gstrf",
        zero_but(getrf_with_inverses=ng, mega_factorize_groups=1))
    out["refactor_gstrf_residual"] = h.perf.kernels["gstrf_residual"]
    print(f"  update_values {out['update_values_host_ms']:.3f} host ms "
          f"(init {out['init_host_ms']:.3f} host ms); gstrf "
          f"{out['refactor_gstrf_host_ms']:.3f} host ms (with its check); "
          f"gstrf residual {out['refactor_gstrf_residual']:.3e} (< 1e-5)")
    if not out["refactor_gstrf_residual"] < 1e-5:
        fail("the refactorization's gstrf residual is too large")
    # the cycle a Newton or transient user repeats, without the check
    h.opts.check = False
    t0 = time.perf_counter()
    update_values(h, s2)
    t1 = time.perf_counter()
    gstrf(h)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    h.opts.check = True
    out["update_values_host_ms_2"] = (t1 - t0) * 1e3
    out["refactor_gstrf_nocheck_host_ms"] = (t2 - t1) * 1e3
    print(f"  again without the check: update_values "
          f"{out['update_values_host_ms_2']:.3f} host ms, gstrf "
          f"{out['refactor_gstrf_nocheck_host_ms']:.3f} host ms (call to "
          "synchronise)")

    # (d) the device-resident solve
    print("surface (d): gstrs_device, 4 right-hand sides, refine=1")
    b4 = torch.as_tensor(s2 @ rng.standard_normal((a.n, 4)),
                         dtype=torch.float32, device=dev)
    kc.reset_launch_counts()
    x4 = gstrs_device(h, b4, refine=1)
    torch.cuda.synchronize()
    expect_launches("gstrs_device", zero_but(mega_solve_groups=2))
    if not (x4.is_cuda and tuple(x4.shape) == (a.n, 4)):
        fail("gstrs_device did not return an [n, 4] CUDA tensor")
    a32 = h.a_origin   # the new values in working precision
    b4h, x4h = b4.cpu().numpy(), x4.cpu().numpy()
    out["device_residuals"] = [residual_norm(a32, x4h[:, c], b4h[:, c])
                               for c in range(4)]
    print(f"  residuals {', '.join(f'{r:.3e}' for r in out['device_residuals'])}"
          f" (< 5e-5, tests/test_device_solve.py)")
    if not max(out["device_residuals"]) < 5e-5:
        fail("gstrs_device's residual is too large")
    def sweeps_of(kernels):
        return {n: k["launches"] for n, k in kernels.items()
                if "group_sweep_kernel" in n}

    p = profile(lambda _: gstrs_device(h, b4, refine=1),
                retry="gstrs_device",
                complete=lambda k: sum(sweeps_of(k).values()) == 4)
    sweeps = sweeps_of(p["kernels"])
    print(f"  traced: {sweeps} (2 a solve_blocked call, 2 calls)")
    out["gstrs_device_trace"] = p
    print_profile({"gstrs_device(refine=1)": p})
    if sum(sweeps.values()) != 4:
        fail(f"one gstrs_device call made {sweeps}, expected 4 launches "
             "of K5's group_sweep_kernel")
    out["gstrs_device_ms"] = cuda_ms(
        lambda _: gstrs_device(h, b4, refine=1), reps=5)
    print(f"  gstrs_device(refine=1), CUDA events, median of 5: "
          f"{out['gstrs_device_ms']:.3f} ms")

    # (e) analyze allocates nothing on the card
    print("surface (e): analyze")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    info = analyze(a, InitOptions(**opts))
    torch.cuda.synchronize()
    out["analyze_allocated_bytes"] = torch.cuda.memory_allocated() - before
    print(f"  tiles {info['tiles']}, flops {info['flops']:.3e}, "
          f"factor_hbm_bytes {info['factor_hbm_bytes']}; device bytes "
          f"allocated by it: {out['analyze_allocated_bytes']}")
    if out["analyze_allocated_bytes"] != 0 or \
            info["tiles"] != h.blocked.num_tiles:
        fail("analyze allocated device memory or reports another store")
    del h, xb, x4, b4
    torch.cuda.empty_cache()

    # (f) factor_diagnostics on a small r64 system
    print("surface (f): factor_diagnostics, poisson2d(24), nb=16, r64, nd")
    a2 = poisson2d(24)
    s2 = a2.to_scipy().tocsc()
    h2 = init(a2, InitOptions(nb=16, dtype="r64", ordering="nd",
                              device="cuda"))
    gstrf(h2)
    np.random.seed(0)
    d = factor_diagnostics(h2)
    lu = spla.splu(s2)
    du = lu.U.diagonal()
    logdet = float(np.sum(np.log(np.abs(du))))
    sign = (float(np.prod(np.sign(du))) * cycle_parity(lu.perm_r)
            * cycle_parity(lu.perm_c))
    dense = s2.toarray()
    exact = float(np.linalg.norm(dense, 1)
                  * np.linalg.norm(np.linalg.inv(dense), 1))
    out["diagnostics"] = dict(d, splu_logabsdet=logdet, splu_sign=sign,
                              exact_cond1=exact)
    print(f"  logabsdet {d['logabsdet']:.12e} (splu {logdet:.12e}), sign "
          f"{d['sign']:+.0f} (splu {sign:+.0f}), cond1_est "
          f"{d['cond1_est']:.6e} (exact {exact:.6e})")
    if not (abs(d["logabsdet"] - logdet) <= 1e-10 * abs(logdet)
            and d["sign"] == sign):
        fail("factor_diagnostics' determinant disagrees with splu's")
    if not exact / 3 <= d["cond1_est"] <= exact * (1 + 1e-8):
        fail("factor_diagnostics' condition estimate is out of its band")
    return out


def compressed_phase(dev, nd: dict, a) -> tuple:
    """tile_storage="compressed" on the card: (1) init -> gstrf -> gstrs
    on poisson3d(32), nb=128, nd, r32 with exact launch counts, its
    factors against the dense nd engines' under the true-f32 rule, its
    store bytes and gstrf peak memory beside the dense store's, ms per
    factorization and per solve beside the dense nd engines' (``nd``,
    from the nd path of this run) and one trace; (2) P6 against its plain
    version bit for bit (float and double, uint16 and uint32 positions,
    the TPU probe's one-tile case, scratch tiles in the batch); (3) P2
    against its plain version at nb=128 (the path's 256 diagonal tiles)
    and nb=256; (4) save_factor -> load_factor -> gstrs with exact counts
    (P6 on the diagonal tiles, then P2); (5) poisson2d(256) nb=128 nd r32
    and circuit(600) nb=32 r64.  ``a`` is poisson3d(32) on the card.
    (1) builds CompressedLU itself, as gstrf builds it off the panel
    route (panel_phase drives that route on this matrix).  Returns
    (details, kernel entries, launches of the main-path runs, the dense
    K4 factors and the plain f32 and f64 ones of (1)'s store)."""
    import os
    import tempfile

    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.blocks import gather_factor
    from pangulu_tpu_torch.compressed import CompressedLU, CompressedTiles
    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.models import circuit, poisson2d, poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.ops.kernels_torch import Indices
    from pangulu_tpu_torch.testing import compressed_launches, newton_inputs
    from pangulu_tpu_torch.tools.probe_p6 import (measure_batch, p6_batches,
                                                   p6_in_trace, print_batch)
    from pangulu_tpu_torch.utils.perf import (factorization_residual,
                                              residual_norm)

    # the path's tile width and its K1 launches (one a level), the
    # poisson2d grid of (5) and the poisson3d grid of P6's nb=256 store
    nb, nlevels, p2d, small3d = 128, 256, 256, 16
    out, kern = {}, {}

    def expect_launches(what, want):
        want = {k: want.get(k, 0) for k in kc.LAUNCHES}
        got = dict(kc.LAUNCHES)
        print(f"  launches: {got}")
        if got != want:
            fail(f"{what}: launch counts {got}, expected {want}")
        return got

    # (1) the main path
    s = a.to_scipy()
    b = s @ np.ones(a.n)
    print(f"compressed (1): init -> gstrf -> gstrs, poisson3d(32), nb={nb}, "
          f"r32, nd, tile_storage='compressed', {dev}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kc.reset_launch_counts()
    h = init(a, InitOptions(nb=nb, dtype="r32", ordering="nd",
                            tile_storage="compressed", device=str(dev)))
    # gstrf takes PanelLU at r32 and nb=128 on the card (panel_phase
    # drives that route): CompressedLU is built here as gstrf builds it
    # elsewhere, so that its counts and P6's history stay comparable
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clu = CompressedLU(h.blocked, h.schedule, h.reordering.reordered,
                       perf=h.perf, device=dev)
    h._factorizer = clu
    h.factor_tiles = h._comp_store = clu.factorize()
    torch.cuda.synchronize()
    out["gstrf_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    # the gstrf check (api.gstrf with check=True)
    out["gstrf_residual"] = factorization_residual(
        h.reordering.reordered.to_scipy(),
        *gather_factor(h.blocked, h.factor_tiles.to_dense()))
    x = gstrs(h, b)
    sch, st = h.schedule, h.factor_tiles
    want = compressed_launches(sch, factorizations=1, solves=3)
    if want["getrf_with_inverses"] != nlevels:
        fail(f"the schedule should have {nlevels} levels")
    out["launches"] = expect_launches("the compressed path", want)
    out["solve_residual"] = residual_norm(s, x, b)
    print(f"  gstrf residual {out['gstrf_residual']:.3e} (< 1e-5), solve "
          f"residual after refine {out['solve_residual']:.3e} (< 1e-10)")
    if x.shape != (a.n,) or not np.isfinite(x).all():
        fail("the compressed solution has the wrong shape or non-finite "
             "values")
    if not (out["gstrf_residual"] < 1e-5 and out["solve_residual"] < 1e-10):
        fail("the compressed path's residuals are too large")
    out.update(store_bytes=st.compressed_bytes, dense_bytes=st.dense_bytes,
               slots=st.values.numel(), capmax=st.capmax)
    print(f"  store: {st.compressed_bytes / 2**20:.3f} MiB compressed "
          f"({st.values.numel()} slots) against {st.dense_bytes / 2**20:.3f}"
          f" MiB dense ({st.dense_bytes / st.compressed_bytes:.3f}x)")
    if not st.compressed_bytes < st.dense_bytes:
        fail("the compressed store is not smaller than the dense one")

    # the dense nd engines on the same store: factors (true f32), peak
    a3 = h.reordering.reordered
    st.refill(a3)
    v0 = st.values.clone()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fac = LUFactorizer(h.blocked, sch, device=dev)
    kfac = fac.factorize()
    torch.cuda.synchronize()
    out["dense_gstrf_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    peaks = (out["gstrf_peak_bytes"] / 2**20,
             out["dense_gstrf_peak_bytes"] / 2**20)
    print(f"  gstrf peak device bytes (max_memory_allocated above what was "
          f"allocated before): compressed {peaks[0]:.3f} MiB, dense nd "
          f"engines {peaks[1]:.3f} MiB")
    # ms per factorization and per solve, CUDA events
    out["ms_per_factorization"] = cuda_ms(
        lambda _: clu.factorize(), setup=lambda: st.values.copy_(v0), reps=5)
    xb = torch.as_tensor(np.zeros((sch.block_length + 1, nb, 1),
                                  np.float32), device=dev)
    xb[:sch.block_length].view(-1)[:a.n] = torch.as_tensor(
        h.reordering.transform_b(b.astype(np.float32)), device=dev)
    out["ms_per_solve"] = cuda_ms(lambda _: clu.solve_blocked(xb), reps=5)
    dense_ms = (nd["ms_per_factorization"], nd["ms_per_solve"])
    print(f"  {out['ms_per_factorization']:.3f} ms per factorization, "
          f"{out['ms_per_solve']:.3f} ms per solve (CUDA events, median of "
          f"5); dense nd engines in this run: {dense_ms[0]:.3f} and "
          f"{dense_ms[1]:.3f}")
    prof = profile(lambda _: clu.factorize(),
                   setup=lambda: st.values.copy_(v0))
    out["trace"] = prof
    print_profile({"compressed gstrf": prof})
    out["trace_p6"] = tp6 = p6_in_trace(prof["kernels"])
    print(f"  P6 in that trace: {tp6['device_ms']:.3f} device ms of "
          f"{prof['busy_ms']:.3f} busy (decompress "
          f"{tp6['decompress']['launches']} launches, "
          f"{tp6['decompress']['device_ms']:.3f} ms; compress "
          f"{tp6['compress']['launches']} launches, "
          f"{tp6['compress']['device_ms']:.3f} ms)")
    # the same factorization with P6's plain versions in the wrappers'
    # place (K1 and the products are the same launches on the same
    # card): the factored values must be the kernel path's, bit for bit
    st.values.copy_(v0)
    clu.factorize()
    kernel_values = st.values.clone()
    st.values.copy_(v0)
    wrappers = kc.decompress_tiles, kc.compress_tiles
    try:
        kc.decompress_tiles = lambda *a: kt.decompress_tiles(*a).contiguous()
        kc.compress_tiles = kt.compress_tiles
        clu.factorize()
    finally:
        kc.decompress_tiles, kc.compress_tiles = wrappers
    torch.cuda.synchronize()
    out["factor_bit_equal_plain_p6"] = torch.equal(st.values, kernel_values)
    print("  factored with P6's plain versions: values "
          f"{'bit-equal' if out['factor_bit_equal_plain_p6'] else 'DIFFER'}"
          " to the kernel path's")
    if not out["factor_bit_equal_plain_p6"]:
        fail("the compressed factorization with the hand P6 differs from "
             "the one with the plain P6")
    del kernel_values
    comp = torch.as_tensor(st.to_dense(), device=dev)
    nt, bl = h.blocked.num_tiles, sch.block_length
    t0 = h.blocked.device_tiles(dev)
    kw = dict(nb=nb, bl=bl)
    p32 = kt.mega_factorize_groups(t0.clone(), fac.tables,
                                   tol=kt.DEFAULT_TOL[torch.float32], **kw)[0]
    r64 = kt.mega_factorize_groups(t0.double(), fac.tables,
                                   tol=kt.DEFAULT_TOL[torch.float64], **kw)[0]
    errs = {n: rel_err(t[:nt], r64[:nt]) for n, t in
            (("compressed", comp), ("dense_k4", kfac), ("plain_f32", p32))}
    out["true_f32"] = errs
    print(f"  true f32, factors against the plain f64 version (max |err| / "
          f"max |f64|): compressed {errs['compressed']:.3e}, dense K4 "
          f"{errs['dense_k4']:.3e}, plain f32 {errs['plain_f32']:.3e} "
          "(compressed <= 2x plain)")
    compare("compressed factors against the dense K4 factors", comp[:nt],
            kfac[:nt], *TOL_GROUP_F32)
    if errs["compressed"] > 2 * errs["plain_f32"]:
        fail("the compressed factors are less accurate than true f32")
    # the dense K4 factors and the plain versions' of this store, for
    # panel_phase's factors of the same matrix
    refs = dict(dense_k4=kfac[:nt], plain_f32=p32[:nt], plain_f64=r64[:nt])
    del comp, t0, p32, r64, kfac, fac
    torch.cuda.empty_cache()

    # (2) P6 against its plain version, bit for bit
    print("compressed (2): P6 against its plain version, bit for bit")
    rng = np.random.default_rng(11)
    nn = 128 * 128
    probe_pos = np.sort(rng.permutation(nn)[:1024])
    probe = dict(values=np.r_[rng.standard_normal(1024), np.zeros(8)],
                 idx=np.r_[probe_pos, [nn] * 8].astype(np.uint16),
                 off=[0, 1024], cap=[1024, 0], ids=[1, 0, 1], nb=128)
    h256 = init(poisson3d(small3d), InitOptions(nb=256, dtype="r64",
                                           ordering="nd", device="cpu"))
    st256 = CompressedTiles(h256.blocked, h256.reordering.reordered, dev)
    cases = [("the TPU probe's tile (1024 slots, nb=128, u16)",
              torch.as_tensor(probe["values"], device=dev),
              torch.as_tensor(probe["idx"], device=dev),
              Indices.build(probe["off"], dev),
              Indices.build(probe["cap"], dev),
              Indices.build(probe["ids"], dev), 128)]
    for label, store in ((f"poisson3d(32) nb={nb} nd factored (u16)", st),
                         (f"poisson3d({small3d}) nb=256 nd (u32)", st256)):
        ids = np.r_[store.num_tiles, np.arange(store.num_tiles)[::-1],
                    store.num_tiles]
        cases.append((label, store.values, store.idx, store.off, store.cap,
                      Indices.build(ids, dev), store.nb))
    out["p6_cases"] = []
    for label, vals, idx, off, cap, ids, nbc in cases:
        for dt in (torch.float32, torch.float64):
            v = vals.to(dt)
            got = kc.decompress_tiles(v, idx, off, cap, ids, nbc)
            ref = kt.decompress_tiles(v, idx, off, cap, ids, nbc)
            backs = [torch.full_like(v, 5.0) for _ in range(2)]
            kc.compress_tiles(backs[0], idx, off, cap, ids, got)
            kt.compress_tiles(backs[1], idx, off, cap, ids, got)
            torch.cuda.synchronize()
            live = backs[1] != 5.0
            ok = (torch.equal(got, ref) and torch.equal(backs[0], backs[1])
                  and torch.equal(backs[0][live], v[live]))
            print(f"  {label}, {dt}: {len(ids)} tiles, decompress and "
                  f"compress {'bit-equal' if ok else 'DIFFER'}")
            out["p6_cases"].append(dict(case=label, dtype=str(dt), ok=ok))
            if not ok:
                fail(f"P6 disagrees with its plain version ({label}, {dt})")
    del st256, h256, cases

    # P6 per launch at three batches of the path: (a) the one-tile launch
    # of the largest cap, (b) a launch of the median size, (c) the widest
    # level's update tiles (pangulu_tpu_torch/tools/probe_p6.py)
    st.values.copy_(v0)
    out["p6"] = p6 = {}
    for key, ids in p6_batches(clu).items():
        p6[key] = measure_batch(sys.modules[__name__], st, ids)
        print_batch(f"({key})", p6[key])
    if not torch.equal(st.values, v0):
        fail("compressing a batch's own tiles changed the store")
    for name, d in (("decompress_tiles", "decompress"),
                    ("compress_tiles", "compress")):
        kern[name] = dict(max_abs_err=0.0, ms=p6["c"][f"{d}_ms"],
                          plain_ms=p6["c"][f"{d}_plain_ms"],
                          library_ms=p6["c"][f"{d}_library_ms"],
                          **p6["c"][f"{d}_bound"],
                          batches={k: dict(
                              tiles=m["tiles"], slots=m["slots"],
                              ms=m[f"{d}_ms"], plain_ms=m[f"{d}_plain_ms"],
                              library_ms=m[f"{d}_library_ms"],
                              bound_ms=m[f"{d}_bound"]["bound_ms"])
                              for k, m in p6.items()})

    # (3) P2 against its plain twin, and true f32 against the JAX
    # package's method (the plain Newton doubling)
    print("compressed (3): P2 against its plain twin (the sweeps) and "
          "true f32 against the plain doubling")
    diag = Indices.build([lev.diag for lev in sch.levels], dev)
    st.values.copy_(v0)
    clu.factorize()
    d128 = kc.decompress_tiles(st.values, st.idx, st.off, st.cap, diag, nb)
    f256 = kt.getrf_with_inverses(torch.as_tensor(
        rng.standard_normal((32, 256, 256)) + 256 * np.eye(256),
        device=dev))[0]
    p2 = {}
    err32 = 0.0
    tol32 = kt.DEFAULT_TOL[torch.float32]
    for label, f64 in ((f"nb={nb}, the path's {bl} diagonal tiles",
                        d128.double()), ("nb=256, 32 tiles", f256)):
        for g, r, n in zip(kc.newton_inverses(f64),
                           kt.triangle_inverses(f64), ("L^-1", "U^-1")):
            e = rel_err(g, r)
            print(f"  {label} f64 {n}: {e:.3e} of max |twin| (<= 1e-12)")
            if not e <= 1e-12:
                fail(f"P2 f64 disagrees with its plain twin ({label})")
        f32 = f64.float()
        for g, t, p, r, n in zip(kc.newton_inverses(f32),
                                 kt.triangle_inverses(f32),
                                 kt.newton_inverses(f32),
                                 kt.newton_inverses(f32.double(), tol32),
                                 ("L^-1", "U^-1")):
            et, ek, ep = rel_err(g, t.double()), rel_err(g, r), rel_err(p, r)
            err32 = max(err32, float((g - t).abs().max()))
            print(f"  {label} f32 {n}: {et:.3e} of max |twin| (<= 1e-5); "
                  f"against the plain f64 doubling: kernel {ek:.3e}, plain "
                  f"f32 doubling {ep:.3e} (kernel <= 2x plain) "
                  f"{'ok' if ek <= 2 * ep else 'FAIL'}")
            p2[f"{label} {n}"] = dict(twin=et, kernel=ek, plain=ep)
            if not et <= TOL_F32[0]:
                fail(f"P2 f32 disagrees with its plain twin ({label})")
            if ek > 2 * ep:
                fail(f"P2 f32 is less accurate than true f32 ({label})")
    # P3's unit triangles, whose inverses reach ~1e17: by max and by row
    lm = torch.as_tensor(newton_inputs(16, nb, seed=nb), device=dev)
    got = kc.newton_inverses(lm)[0]
    p32 = kt.newton_inverses(lm)[0]
    p64 = kt.newton_inverses(lm.double(), tol32)[0]
    for scale, row in (("max", False), ("row", True)):
        ek, ep = rel_err(got, p64, row), rel_err(p32, p64, row)
        print(f"  P3's 16 unit triangles, nb={nb}, f32 L^-1 by {scale}: "
              f"kernel {ek:.3e}, plain f32 doubling {ep:.3e} (kernel <= 2x "
              f"plain) {'ok' if ek <= 2 * ep else 'FAIL'}")
        p2[f"P3 unit triangles by {scale}"] = dict(kernel=ek, plain=ep)
        if ek > 2 * ep:
            fail(f"P2 f32 is less accurate than true f32 on P3's unit "
                 f"triangles (by {scale})")
    del lm, got, p32, p64
    d32 = d128.contiguous()
    nb_, batch = nb, d32.shape[0]
    eye = torch.eye(nb_, device=dev).expand(2 * batch, nb_, nb_)
    dg = torch.diagonal(d32, dim1=-2, dim2=-1)
    safe = torch.where(dg.abs() < kt.DEFAULT_TOL[torch.float32],
                       torch.full_like(dg, kt.DEFAULT_TOL[torch.float32]),
                       dg)
    lower = torch.cat([torch.tril(d32, -1) + eye[:batch],
                       (torch.triu(d32, 1) + torch.diag_embed(safe))
                       .transpose(-1, -2)]).contiguous()
    p2["ms"] = device_ms(lambda: kc.newton_inverses(d32), n=20)
    p2["plain_ms"] = cuda_ms(lambda _: kt.triangle_inverses(d32), reps=3)
    p2["library_ms"] = device_ms(lambda: torch.linalg.solve_triangular(
        lower, eye, upper=False), n=20)
    # the factor read, L^-1 and U^-1 written; the operations the two
    # triangle inverses need, whatever the method
    p2["bound"] = p2_bound(nb_, batch, torch.float32)
    p2["max_abs_err_f32"] = err32
    print(f"  P2 per launch, nb={nb}, batch {batch} (both triangles): "
          f"{p2['ms']:.4f} ms (bound {p2['bound']['bound_ms']:.4f}, "
          f"{p2['bound']['bound_by']}), plain {p2['plain_ms']:.3f}, "
          f"solve_triangular on the stacked triangles "
          f"{p2['library_ms']:.4f}")
    out["p2"] = p2
    kern["newton_inverses"] = dict(max_abs_err=err32, ms=p2["ms"],
                                   plain_ms=p2["plain_ms"],
                                   library_ms=p2["library_ms"],
                                   **p2["bound"])
    del d128, f256, d32, lower, eye

    # (4) a checkpoint reloaded on the card
    print("compressed (4): save_factor -> load_factor -> gstrs")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "comp.npz")
        save_factor(h, path)
        out["checkpoint_bytes"] = os.path.getsize(path)
        kc.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        h2 = load_factor(path, device=str(dev))
        x2 = gstrs(h2, b)
        torch.cuda.synchronize()
        out["reload_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        out["reload_launches"] = expect_launches(
            "the reloaded compressed factor",
            compressed_launches(sch, solves=3, reloads=1))
    out["reload_solve_residual"] = residual_norm(s, x2, b)
    print(f"  .npz {out['checkpoint_bytes']} bytes; peak device bytes of "
          f"load -> gstrs above what was allocated before: "
          f"{out['reload_peak_bytes']} ({out['reload_peak_bytes'] / 2**20:.1f}"
          f" MiB); solve residual {out['reload_solve_residual']:.3e} "
          "(< 1e-10)")
    compare("reloaded solution against the first", torch.as_tensor(x2),
            torch.as_tensor(x), *TOL_SOLVE_F32)
    if not out["reload_solve_residual"] < 1e-10:
        fail("the reloaded factor's solve residual is too large")
    del h2, x2, h, clu, st, v0, xb
    torch.cuda.empty_cache()

    # (5) the other matrices
    for key, label, gen, nbm, dtype, ordering, limit in (
            ("p2d256", f"poisson2d({p2d})", lambda: poisson2d(p2d), nb, "r32",
             "nd", 1e-10),
            ("circuit600", "circuit(600, seed=2)",
             lambda: circuit(600, seed=2), 32, "r64", "auto", 1e-6)):
        print(f"compressed (5): {label}, nb={nbm}, {dtype}, {ordering}")
        m = gen()
        bm = m.to_scipy() @ np.ones(m.n)
        t0 = time.perf_counter()
        hm = init(m, InitOptions(nb=nbm, dtype=dtype, ordering=ordering,
                                 tile_storage="compressed", device=str(dev)))
        gstrf(hm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        xm = gstrs(hm, bm)
        t2 = time.perf_counter()
        sm = hm.factor_tiles
        res = dict(n=m.n, bl=hm.schedule.block_length,
                   tiles=hm.blocked.num_tiles,
                   engine=hm.perf.kernels["engine"],
                   panels=hm.perf.kernels.get("panels"),
                   store_bytes=sm.compressed_bytes,
                   dense_bytes=sm.dense_bytes,
                   init_gstrf_host_s=t1 - t0, gstrs_host_s=t2 - t1,
                   solve_residual=residual_norm(m.to_scipy(), xm, bm))
        out[key] = res
        print(f"  engine {res['engine']}" + (
            f" ({res['panels']} panels)" if res["panels"] else "")
            + f", {res['bl']} levels, store "
            f"{sm.compressed_bytes / 2**20:.3f}"
              f" MiB against {sm.dense_bytes / 2**20:.3f} MiB dense "
              f"({sm.dense_bytes / sm.compressed_bytes:.3f}x); init + gstrf "
              f"{res['init_gstrf_host_s']:.3f} s, gstrs "
              f"{res['gstrs_host_s']:.3f} s (host wall); solve residual "
              f"{res['solve_residual']:.3e} (< {limit:g})")
        if not res["solve_residual"] < limit:
            fail(f"{label} compressed: solve residual too large")
        del hm, sm
        torch.cuda.empty_cache()
    return out, kern, {"decompress_tiles": out["launches"]["decompress_tiles"],
                       "compress_tiles": out["launches"]["compress_tiles"],
                       "newton_inverses":
                           out["reload_launches"]["newton_inverses"]}, refs


def panel_phase(dev, nd: dict, comp: dict, refs: dict, nx: int = 32,
                nx_large: int = 48) -> tuple:
    """The out-of-core panel driver (outofcore.PanelLU), which gstrf
    takes for tile_storage="compressed" at r32 and nb 128 or 256 on the
    card: K2 once a panel cross (K1 inside it), P6 for the cross and for
    each out-update chunk.  On poisson3d(nx), nb=128, nd, r32: (a) init
    -> gstrf -> gstrs at the default budget with exact launches
    (testing.panel_launches), the repo's r32 residual limits, the peak
    max_memory_allocated of gstrf, the factors against the dense K4
    factors (2e-4) and under the true-f32 rule (``refs``, from
    compressed_phase's store of the same matrix), two factorizations of
    one store bit-equal, ms per factorization and per solve beside
    CompressedLU's (``comp``) and the dense nd engines' (``nd``), one
    traced factorization (K1's, K2's and P6's device ms); (b)
    save_factor -> load_factor -> gstrs (P6, then P2); (c) gstrf again
    under PANGULU_OOC_PANEL_GB=0.0625 (width 30, 9 panels) and under
    PANGULU_OOC_CROSS_GB=0.125 (2048 tiles: the width halved), each store
    against (a)'s at 2e-4; (d) update_values -> gstrf -> gstrs; then (e)
    nb=256 under PANGULU_OOC_PANEL_GB=0.25 (u32 positions, 4 panels) and
    (f) poisson3d(nx_large) at the default budget with the host seconds
    of init and of the store's build.  Returns (its numbers, the
    launches of (a))."""
    import contextlib
    import os
    import tempfile

    from pangulu_tpu_torch import (InitOptions, gstrf, gstrs, init,
                                   update_values)
    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.outofcore import PanelLU
    from pangulu_tpu_torch.testing import compressed_launches, panel_launches
    from pangulu_tpu_torch.tools.probe_p6 import p6_in_trace
    from pangulu_tpu_torch.utils.perf import residual_norm

    nb = 128
    out = {}

    @contextlib.contextmanager
    def env(**kv):
        old = {k: os.environ.get(k) for k in kv}
        os.environ.update(kv)
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def counts(what, want):
        want = {k: want.get(k, 0) for k in kc.LAUNCHES}
        got = dict(kc.LAUNCHES)
        print(f"  launches: {got}")
        if got != want:
            fail(f"{what}: launch counts {got}, expected {want}")
        return got

    def route(label, h, s, b, solves=3, check=True):
        """gstrf -> gstrs on the handle (a refactorization refills its
        store) with the counts zeroed before and read after; the
        numbers of the run."""
        print(f"panel: gstrf -> gstrs, {label}, {dev}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kc.reset_launch_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pre = h.perf.phase_time.get("preprocess", 0.0)
        t0 = time.perf_counter()
        gstrf(h)
        torch.cuda.synchronize()
        gstrf_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        x = gstrs(h, b)
        plu = h._factorizer
        if not isinstance(plu, PanelLU) or h.perf.kernels["engine"] != \
                "panel":
            fail(f"{label}: gstrf did not take the panel engine")
        launches = counts(label, panel_launches(plu, solves=solves))
        k1_dev = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        if k1_dev != launches["getrf_with_inverses"]:
            fail(f"{label}: K1 made {k1_dev} device launches in "
                 f"{launches['getrf_with_inverses']} launches")
        chunks = sum(len(plu._pass(*c).chunks) for c in plu.panel_cols)
        res = dict(panels=len(plu.panel_cols), panel_width=plu.panel_width,
                   panel_cols=[(int(c0), int(c1))
                               for c0, c1 in plu.panel_cols],
                   out_chunks=chunks,
                   launches=launches, gstrf_peak_bytes=peak,
                   gstrf_host_s=gstrf_s,
                   store_build_host_s=h.perf.phase_time["preprocess"] - pre,
                   solve_residual=residual_norm(s, x, b),
                   idx_dtype=str(plu.store.idx.dtype))
        print(f"  {res['panels']} panels (width {res['panel_width']}): "
              f"{res['panel_cols']}; {chunks} out-update chunks; gstrf peak "
              f"device bytes {peak / 2**20:.3f} MiB (max_memory_allocated "
              f"above what was allocated before); gstrf {gstrf_s:.3f} s "
              f"host, of it the store's build {res['store_build_host_s']:.3f}"
              f" s; positions {res['idx_dtype']}")
        if check:
            res["gstrf_residual"] = h.perf.kernels["gstrf_residual"]
            print(f"  gstrf residual {res['gstrf_residual']:.3e} (< 1e-5)")
            if not res["gstrf_residual"] < 1e-5:
                fail(f"{label}: gstrf residual too large")
        print(f"  solve residual after refine {res['solve_residual']:.3e} "
              "(< 1e-10)")
        if x.shape != (s.shape[0],) or not np.isfinite(x).all():
            fail(f"{label}: the solution has the wrong shape or non-finite "
                 "values")
        if not res["solve_residual"] < 1e-10:
            fail(f"{label}: solve residual too large")
        return plu, x, res

    def timings(plu, a3, xb):
        """ms per factorization and per solve (CUDA events, median of 7),
        the store refilled before each factorization."""
        st = plu.store
        st.refill(a3)
        v0 = st.values.clone()
        fms = cuda_ms(lambda _: plu.factorize(),
                      setup=lambda: st.values.copy_(v0), reps=7)
        sms = cuda_ms(lambda _: plu.solve_blocked(xb), reps=7)
        return fms, sms, v0

    def blocked_rhs(h, b):
        bl = h.schedule.block_length
        xb = torch.zeros((bl + 1, h.blocked.nb, 1), dtype=torch.float32,
                         device=dev)
        xb[:bl].view(-1)[:h.blocked.n] = torch.as_tensor(
            h.reordering.transform_b(b.astype(np.float32)), device=dev)
        return xb

    a = poisson3d(nx)
    s = a.to_scipy()
    b = s @ np.ones(a.n)

    # (a) the public route at the default budget
    kc.reset_launch_counts()
    t0 = time.perf_counter()
    h = init(a, InitOptions(nb=nb, dtype="r32", ordering="nd",
                            tile_storage="compressed", check=True,
                            device=str(dev)))
    init_s = time.perf_counter() - t0
    plu, x, main = route(f"poisson3d({nx}), nb={nb}, r32, nd, "
                         "tile_storage='compressed', the default budget",
                         h, s, b)
    main["init_host_s"] = init_s
    if main["launches"]["mega_factorize"] != main["panels"]:
        fail("K2 was not launched once a panel")
    st, a3, nt = plu.store, h.reordering.reordered, h.blocked.num_tiles
    got = torch.as_tensor(st.to_dense(), device=dev)[:nt]
    compare("panel factors against the dense K4 factors", got,
            refs["dense_k4"], *TOL_GROUP_F32)
    ek = rel_err(got, refs["plain_f64"])
    ep = rel_err(refs["plain_f32"], refs["plain_f64"])
    main["true_f32"] = dict(panel=ek, plain_f32=ep)
    print(f"  true f32, factors against the plain f64 version: panel "
          f"{ek:.3e}, plain f32 {ep:.3e} (panel <= 2x plain)")
    if ek > 2 * ep:
        fail("the panel factors are less accurate than true f32")
    del got
    xb = blocked_rhs(h, b)
    fms, sms, v0 = timings(plu, a3, xb)
    st.values.copy_(v0)
    first = plu.factorize().values.clone()
    st.values.copy_(v0)
    main["bit_equal"] = torch.equal(plu.factorize().values, first)
    print(f"  two factorizations of one store: "
          f"{'the same bits' if main['bit_equal'] else 'DIFFER'}")
    if not main["bit_equal"]:
        fail("two panel factorizations of one store differ")
    single = first
    main.update(ms_per_factorization=fms, ms_per_solve=sms)
    print(f"  {fms:.3f} ms per factorization, {sms:.3f} ms per solve (CUDA "
          f"events, median of 7); CompressedLU in this run "
          f"{comp['ms_per_factorization']:.3f} and {comp['ms_per_solve']:.3f}"
          f" (its gstrf peak {comp['gstrf_peak_bytes'] / 2**20:.3f} MiB), "
          f"the dense nd engines {nd['ms_per_factorization']:.3f} and "
          f"{nd['ms_per_solve']:.3f}")
    prof = profile(lambda _: plu.factorize(),
                   setup=lambda: st.values.copy_(v0))
    print_profile({"panel gstrf": prof})
    kern = prof["kernels"]
    main["trace"] = dict(
        prof, p6=p6_in_trace(kern),
        k1_device_ms=sum(k["device_ms"] for n, k in kern.items()
                         if "getrf_inv_kernel" in n),
        k2_products_device_ms=sum(
            k["device_ms"] for n, k in kern.items()
            if n.split("<")[0].split("::")[-1] in ("panel_kernel",
                                                   "schur_kernel")))
    tr = main["trace"]
    print(f"  in that trace: K1 {tr['k1_device_ms']:.3f} device ms, K2's "
          f"products {tr['k2_products_device_ms']:.3f}, P6 "
          f"{tr['p6']['device_ms']:.3f} ({tr['p6']['decompress']['launches']}"
          f" + {tr['p6']['compress']['launches']} launches) of "
          f"{prof['busy_ms']:.3f} busy and {prof['wall_ms']:.3f} wall ms")
    out["default"] = main

    # (b) a checkpoint of the panel-factored store, reloaded on the card
    print("panel: save_factor -> load_factor -> gstrs")
    st.values.copy_(single)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "panel.npz")
        save_factor(h, path)
        kc.reset_launch_counts()
        h2 = load_factor(path, device=str(dev))
        x2 = gstrs(h2, b)
        out["reload_launches"] = counts(
            "the reloaded panel factor",
            compressed_launches(h.schedule, solves=3, reloads=1))
    out["reload_solve_residual"] = residual_norm(s, x2, b)
    print(f"  solve residual {out['reload_solve_residual']:.3e} (< 1e-10)")
    compare("reloaded solution against the first", torch.as_tensor(x2),
            torch.as_tensor(x), *TOL_SOLVE_F32)
    if not out["reload_solve_residual"] < 1e-10:
        fail("the reloaded panel factor's solve residual is too large")
    del h2, x2

    # (c) split budgets: the width from PANGULU_OOC_PANEL_GB, then the
    # halving against the measured cross.  factorize() reads the cross
    # budget from the environment at each call, so the timings and the
    # repeated factorization run inside the same environment, and the
    # panels they factored are checked against the route's.
    for key, kv, want in (
            ("panel_gb", dict(PANGULU_OOC_PANEL_GB="0.0625"), (30, 9)),
            ("cross_gb", dict(PANGULU_OOC_CROSS_GB="0.125"), None)):
        with env(**kv):
            plu, _, res = route(f"poisson3d({nx}), nb={nb}, nd, {kv}", h, s,
                                b)
            if want and (res["panel_width"], res["panels"]) != want:
                fail(f"{kv}: width {res['panel_width']} in {res['panels']} "
                     f"panels, expected {want}")
            if want is None and not (res["panels"] > 1 and max(
                    c1 - c0 for c0, c1 in res["panel_cols"])
                    < res["panel_width"]):
                fail(f"{kv}: the width was not halved")
            res["store_max_abs_err"] = compare(
                f"the store of {res['panels']} panels against one panel's",
                plu.store.values, single, 2e-4, 2e-4)
            res["ms_per_factorization"], _, v1 = timings(plu, a3, xb)
            timed_cols = [(int(c0), int(c1)) for c0, c1 in plu.panel_cols]
            plu.store.values.copy_(v1)
            once = plu.factorize().values.clone()
            plu.store.values.copy_(v1)
            res["bit_equal"] = torch.equal(plu.factorize().values, once)
            del once, v1
        if timed_cols != res["panel_cols"]:
            fail(f"{kv}: timed {len(timed_cols)} panels {timed_cols}, the "
                 f"route factored {res['panel_cols']}")
        print(f"  {res['ms_per_factorization']:.3f} ms per factorization "
              f"(CUDA events, median of 7, {len(timed_cols)} panels); two "
              f"factorizations of one store ({res['out_chunks']} out-update "
              f"chunks): {'the same bits' if res['bit_equal'] else 'DIFFER'}")
        if not res["bit_equal"]:
            fail(f"{kv}: two panel factorizations of one store differ")
        out[key] = res

    # (d) a refactorization through update_values
    rng = np.random.default_rng(7)
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, s2.nnz))
    update_values(h, s2)
    store = h._comp_store
    # A in the working precision, as update_values keeps it
    s2w = s2.astype(np.float32).astype(np.float64)
    _, _, out["refactorization"] = route(
        f"update_values -> gstrf -> gstrs, poisson3d({nx})", h, s2w,
        s2w @ np.ones(a.n))
    if h._comp_store is not store:
        fail("the refactorization did not refill the store")
    del h, plu, st, v0, single, first, xb
    torch.cuda.empty_cache()

    # (e) nb=256: u32 positions, at least 3 panels
    h = init(a, InitOptions(nb=256, dtype="r32", ordering="nd",
                            tile_storage="compressed", check=True,
                            device=str(dev)))
    with env(PANGULU_OOC_PANEL_GB="0.25"):
        plu, _, res = route(f"poisson3d({nx}), nb=256, nd, "
                            "PANGULU_OOC_PANEL_GB=0.25", h, s, b)
        if res["panels"] < 3 or res["idx_dtype"] != "torch.uint32":
            fail("nb=256: expected at least 3 panels and u32 positions")
        res["ms_per_factorization"], res["ms_per_solve"], _ = timings(
            plu, h.reordering.reordered, blocked_rhs(h, b))
    if len(plu.panel_cols) != res["panels"]:
        fail(f"nb=256: timed {len(plu.panel_cols)} panels, the route "
             f"factored {res['panels']}")
    print(f"  {res['ms_per_factorization']:.3f} ms per factorization, "
          f"{res['ms_per_solve']:.3f} ms per solve (CUDA events, median of "
          "7)")
    out["nb256"] = res
    del h, plu
    torch.cuda.empty_cache()

    # (f) a larger grid at the default budget (no gstrf check: its dense
    # factor on the host would take tens of GB)
    al = poisson3d(nx_large)
    sl = al.to_scipy()
    bl_ = sl @ np.ones(al.n)
    t0 = time.perf_counter()
    h = init(al, InitOptions(nb=nb, dtype="r32", ordering="nd",
                             tile_storage="compressed", device=str(dev)))
    init_s = time.perf_counter() - t0
    plu, _, res = route(f"poisson3d({nx_large}), nb={nb}, nd, the default "
                        "budget", h, sl, bl_, check=False)
    res.update(init_host_s=init_s, n=al.n, bl=h.schedule.block_length,
               tiles=h.blocked.num_tiles,
               store_bytes=plu.store.compressed_bytes,
               dense_bytes=plu.store.dense_bytes,
               flops=h.schedule.flop_estimate())
    res["ms_per_factorization"], res["ms_per_solve"], _ = timings(
        plu, h.reordering.reordered, blocked_rhs(h, bl_))
    print(f"  init {init_s:.3f} s host; {res['bl']} levels, {res['tiles']} "
          f"tiles, store {res['store_bytes'] / 2**20:.3f} MiB against "
          f"{res['dense_bytes'] / 2**20:.3f} MiB dense; "
          f"{res['ms_per_factorization']:.3f} ms per factorization, "
          f"{res['ms_per_solve']:.3f} ms per solve (CUDA events, median of 7)")
    out[f"p3d{nx_large}"] = res
    del h, plu
    torch.cuda.empty_cache()
    return out, main["launches"]


def complex_phase(dev, nx: int = 32, nx_small: int = 24,
                  nb: int = 128) -> dict:
    """cr32 and cr64 through the real 2x2 embedding on the card, on
    poisson3d(nx) with imaginary parts (testing.with_imaginary_parts:
    +1 on the diagonal, 0.1 U(-1, 1) on every stored off-diagonal entry,
    seed 0), nb=128: cr32 rcm (K1, K2, K3) and cr32 nd (K1, K4, K5), each
    after r32 on the real part alone at the same nb and ordering, their
    time ratios printed beside the flop ratios; cr64 rcm (K1's and K2's,
    K3's double instances); cr32 nd in the compressed store on
    poisson3d(nx_small) with imaginary parts (the panel route: K2 and K1
    on each panel cross, P6; after save_factor -> load_factor, P6 and
    P2).  Each run: init -> gstrf -> gstrs with
    the launch counts zeroed before and read after, exactly the
    schedule's (K1 = the embedded block_length or group count; the
    solve 3 calls after the default 2 refinement rounds of cr32, 1 for
    cr64); the residual ||b - A x|| / ||b|| in complex128 on the host,
    A in the working precision (rounded to complex64 for cr32, as the
    r32 phases' A is exact in float32), below 1e-10 for cr32 and 1e-12
    for cr64; two factorizations of one store bit-identical; the median
    ms per factorization and per solve (CUDA events); one traced
    factorization of each dense run (K1's share).  Returns its numbers;
    any failure raises."""
    import os
    import tempfile

    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.sparse import VALUE_DTYPES, complex_embed_rhs
    from pangulu_tpu_torch.testing import (compressed_launches,
                                           panel_launches,
                                           with_imaginary_parts)
    from pangulu_tpu_torch.utils.perf import residual_norm

    out = {}

    def counts(what, want):
        want = {k: want.get(k, 0) for k in kc.LAUNCHES}
        got = dict(kc.LAUNCHES)
        print(f"  launches: {got}")
        if got != want:
            fail(f"{what}: launch counts {got}, expected {want}")
        return got

    def run(label, a, dtype, ordering, engine, expect, limit,
            compressed=False):
        """One run as the docstring says; returns (handle, its numbers,
        the working-precision system (A, b, x))."""
        cdt = np.dtype(VALUE_DTYPES[dtype])
        cplx = cdt.kind == "c"
        aw = a.to_scipy().astype(cdt)
        acc = np.complex128 if cplx else np.float64
        b = aw.astype(acc) @ np.full(a.n, 1 + 1j if cplx else 1.0, acc)
        print(f"complex: init -> gstrf -> gstrs, {label}, nb={nb}, {dtype}, "
              f"{ordering}" + (", tile_storage='compressed'" if compressed
                               else "") + f", {dev}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device=str(dev), tile_storage=(
                                    "compressed" if compressed else "dense")))
        init_s = time.perf_counter() - t0
        gstrf(h)
        x = gstrs(h, b)
        launches = counts(f"{label} {dtype} {ordering}", expect(h))
        k1_dev = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        if k1_dev != launches["getrf_with_inverses"]:
            fail(f"K1 made {k1_dev} device launches in "
                 f"{launches['getrf_with_inverses']} launches, expected one "
                 "each")
        res = residual_norm(aw, x, b)
        eng = h.perf.kernels.get("engine")
        print(f"  engine {eng}, n {h.blocked.n}, block_length "
              f"{h.schedule.block_length}, tiles {h.blocked.num_tiles}; "
              f"init {init_s:.3f} s (host); residual ||b - A x|| / ||b|| = "
              f"{res:.3e} (< {limit:g})")
        if (x.shape != (a.n,) or x.dtype != np.dtype(acc)
                or not np.isfinite(x).all()):
            fail(f"{label} {dtype}: solution of shape {x.shape}, type "
                 f"{x.dtype}, expected ({a.n},) {np.dtype(acc)}, finite")
        if engine and eng != engine:
            fail(f"{label} {dtype} {ordering} took the {eng} engine, "
                 f"expected {engine}")
        if not res < limit:
            fail(f"{label} {dtype} {ordering}: residual too large")
        wdt = h.blocked.dtype
        br = (complex_embed_rhs(b) if cplx else b).astype(wdt)
        sch, bl = h.schedule, h.schedule.block_length
        fac = h._factorizer
        if compressed:
            # the store refilled with A before each factorization
            st = h.factor_tiles
            st.refill(h.reordering.reordered)
            v0 = st.values.clone()

            def setup():
                return None

            def factor(_):
                st.values.copy_(v0)
                fac.factorize()
                return st.values

            xb = torch.zeros((bl + 1, nb, 1), dtype=st.values.dtype,
                             device=dev)
            xb[:bl].view(-1)[:h.blocked.n] = torch.as_tensor(
                h.reordering.transform_b(br), device=dev)
            solve = fac.solve_blocked
        else:
            ts = h._trisolver

            def setup():
                return h.blocked.device_tiles(dev)

            def factor(tiles):
                return fac.factorize(tiles, sync=False)

            def solve(xb):
                return ts.solve_blocked(h.factor_tiles, xb)

            xb = ts.blockify_rhs(h.reordering.transform_b(br))
        first = factor(setup()).clone()
        same = torch.equal(first, factor(setup()))
        del first
        print(f"  two factorizations of one store: "
              f"{'the same bits' if same else 'DIFFER'}")
        if not same:
            fail(f"{label} {dtype} {ordering}: two factorizations of one "
                 "store differ")
        fms = cuda_ms(factor, setup=setup, reps=7)
        sms = cuda_ms(lambda _: solve(xb), reps=7)
        flops = sch.flop_estimate()
        print(f"  {fms:.3f} ms per factorization, {sms:.3f} ms per solve "
              f"(CUDA events, median of 7); {flops:.3e} flop (dense-tile "
              "model)")
        num = dict(n=h.blocked.n, bl=bl, tiles=h.blocked.num_tiles,
                   engine=eng, launches=launches, k1_device_launches=k1_dev,
                   residual=res, init_host_s=init_s,
                   ms_per_factorization=fms, ms_per_solve=sms, flops=flops)
        if not compressed:
            # K2's or K4's bound on this store: every tile read and
            # written once, the inverses written, the products at the
            # tensor cores' rate (3xTF32, or DMMA for cr64)
            fb = bound(2 * (h.blocked.num_tiles + bl) * nb * nb
                       * np.dtype(wdt).itemsize, flops,
                       h.blocked.torch_dtype, TC_FLOP_S)
            num["factor_bound"] = fb
            print(f"  factorization bound {fb['bound_ms']:.4f} ms "
                  f"({fb['bound_by']}), {fb['bound_ms'] / fms:.2%} of it")
            tr = profile(factor, setup=setup)
            k1_ms = sum(k["device_ms"] for n, k in tr["kernels"].items()
                        if "getrf_inv_kernel" in n or "lu_cluster_kernel" in n)
            num.update(trace=tr, k1_device_ms=k1_ms,
                       k1_share=k1_ms / tr["busy_ms"])
            print(f"  one factorization traced: busy {tr['busy_ms']:.3f} of "
                  f"{tr['wall_ms']:.3f} wall ms, K1 {k1_ms:.3f} device ms "
                  f"({k1_ms / tr['busy_ms']:.1%} of busy)")
        return h, num, (aw, b, x)

    def chain(h):
        return dict(getrf_with_inverses=h.schedule.block_length,
                    mega_factorize=1, mega_solve=3 if h.blocked.dtype
                    == np.float32 else 1)

    def groups(h):
        return dict(getrf_with_inverses=h._factorizer.tables.host["ngroups"],
                    mega_factorize_groups=1, mega_solve_groups=3)

    real = poisson3d(nx)
    cplx = with_imaginary_parts(real)
    label = f"poisson3d({nx})"
    for ordering, engine, expect in (("rcm", "mega", chain),
                                     ("nd", "mega_group", groups)):
        pair = {}
        for dtype, a in (("r32", real), ("cr32", cplx)):
            h, pair[dtype], _ = run(
                label + (" with imaginary parts" if dtype == "cr32"
                         else " (the real part)"),
                a, dtype, ordering, engine, expect, 1e-10)
            if ordering == "nd":
                pair[dtype]["groups"] = h._factorizer.tables.host["ngroups"]
            del h
        r, c = pair["r32"], pair["cr32"]
        ratio = {k: c[k] / r[k] for k in ("ms_per_factorization",
                                          "ms_per_solve", "flops", "bl",
                                          "tiles")}
        print(f"  cr32 against r32 on the real part, {ordering} nb={nb}: "
              f"factorization {c['ms_per_factorization']:.3f} / "
              f"{r['ms_per_factorization']:.3f} ms = "
              f"{ratio['ms_per_factorization']:.3f}x, solve "
              f"{c['ms_per_solve']:.3f} / {r['ms_per_solve']:.3f} ms = "
              f"{ratio['ms_per_solve']:.3f}x; flop {ratio['flops']:.3f}x "
              f"(a native complex kernel's: 4x the real flop, so the "
              f"embedding does {ratio['flops'] / 4:.3f}x of that); "
              f"block_length {ratio['bl']:.0f}x, tiles "
              f"{ratio['tiles']:.3f}x")
        out[ordering] = dict(r32=pair["r32"], cr32=pair["cr32"], ratio=ratio)

    # cr64: K1's and K2's (K7's and K6's) and K3's double instances
    h, out["cr64_rcm"], _ = run(label + " with imaginary parts", cplx,
                                "cr64", "rcm", "mega", chain, 1e-12)
    del h

    # the compressed store, saved and loaded
    small = with_imaginary_parts(poisson3d(nx_small))
    h, comp, (aw, b, x) = run(
        f"poisson3d({nx_small}) with imaginary parts", small, "cr32", "nd",
        "panel", lambda h: panel_launches(h._factorizer, solves=3), 1e-10,
        compressed=True)
    comp["panels"] = len(h._factorizer.panel_cols)
    print("complex: save_factor -> load_factor -> gstrs (cr32, compressed)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "complex.npz")
        save_factor(h, path)
        comp["checkpoint_bytes"] = os.path.getsize(path)
        kc.reset_launch_counts()
        h2 = load_factor(path, device=str(dev))
        x2 = gstrs(h2, b)
        comp["reload_launches"] = counts(
            "the reloaded complex factor",
            compressed_launches(h.schedule, solves=3, reloads=1))
    comp["reload_residual"] = residual_norm(aw, x2, b)
    print(f"  complex_embed {h2.complex_embed}; residual "
          f"{comp['reload_residual']:.3e} (< 1e-10)")
    if h2.complex_embed != np.complex64 or x2.dtype != np.complex128:
        fail("the reloaded factor lost its complex type")
    compare("reloaded solution against the first",
            torch.as_tensor(complex_embed_rhs(x2)),
            torch.as_tensor(complex_embed_rhs(x)), *TOL_SOLVE_F32)
    if not comp["reload_residual"] < 1e-10:
        fail("the reloaded complex factor's residual is too large")
    out["cr32_nd_compressed"] = comp
    del h, h2
    torch.cuda.empty_cache()
    return out


def scan_flop(n: int, steps: int, chains: int) -> int:
    """Operations of ``steps`` steps of the TPU probes' scan on ``chains``
    n x n chains: at step k (mod n), a division for each of the n - 1 - k
    rows below and a multiply and a subtract for each entry of the
    trailing block."""
    r = n - 1 - np.arange(steps) % n
    return int(chains * (r + 2 * r * r).sum())


def probe_bound(nbytes: float, flop: float, tc_flop: float,
                tc_peak: float, sms: int) -> tuple:
    """bound() of a probe: bytes over 3.35 TB/s, its operations on the
    CUDA cores (float32) and its products' on the tensor cores at
    tc_peak; and beside it the bound on the ``sms`` SMs its kernel runs
    the work on (P5's products 16 CTAs, a column strip each; P4's one
    cluster; P3 a cluster a member), the same with the operations at
    sms / 132 of those peaks, a computed number kept out of the kernels
    line."""
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = max(flop / FLOP_S[torch.float32], tc_flop / tc_peak) * 1e3
    return (dict(bound_ms=max(tb, tf),
                 bound_by="bytes" if tb >= tf else "operations"),
            max(tb, tf * SMS / min(sms, SMS)))


def run_ranks(dev, cases, reps: int = 1, np_: int = 4,
              mesh: str = "2,2") -> pathlib.Path:
    """Start pangulu_tpu_torch/tools/run_multiprocess.py: ``np_`` ranks on
    a ``mesh`` grid, all on this card, joined by gloo, each running the
    ``cases`` (the kernels built before: the ranks load the library).
    Returns the directory of the ranks' records (the caller removes it);
    fails if a rank failed."""
    import tempfile

    build_dir = ROOT / "pangulu_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dist_", dir=build_dir))
    cmd = [sys.executable, str(ROOT / "pangulu_tpu_torch" / "tools"
                               / "run_multiprocess.py"),
           "-np", str(np_), "--mesh", mesh, "--device", dev.type,
           "--backend", "gloo", "--out", str(tmp), "--reps", str(reps),
           "--timeout", "400"]
    for c in cases:
        cmd += ["--case", c]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=450)
    print(f"  {res.stdout.strip()} ({time.perf_counter() - t0:.1f} s)")
    if res.returncode != 0:
        fail(f"run_multiprocess failed ({res.returncode}):\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    return tmp


def check_ranks(tmp: pathlib.Path, spec: str, np_: int = 4,
                q: int = 2) -> tuple:
    """The records of one case of run_ranks on every rank, checked: K1
    launches and device launches on every rank equal to the distributed
    groups (none for complex tiles, whose diagonal step is kernels_xla's),
    gstrf residuals < 1e-5 (single precision) or 1e-12 (double), refined
    solve residuals < 1e-10 or 1e-12, two factorizations of one rank the
    same bits, every rank the same x and tables' digest, and the
    refactorization on the kept tables.  Returns (its numbers, the
    factors assembled from the shards)."""
    label, dtype = spec.split(":")[0], spec.split(":")[3]
    rk = [dict(np.load(tmp / f"{label}_rank{r}.npz")) for r in range(np_)]
    r0 = rk[0]
    groups = int(r0["groups"])
    f64 = dtype in ("r64", "cr64")
    native = spec.endswith(":native")
    flimit, slimit = (1e-12, 1e-12) if f64 else (1e-5, 1e-10)
    k1 = [(int(r["k1_launches"]), int(r["k1_device_launches"]))
          for r in rk]
    want = (0, 0) if native else (groups, groups)
    print(f"  {label}: {groups} groups, K1 (launches, device launches) "
          f"per rank {k1}")
    if any(v != want for v in k1):
        fail(f"{label}: K1 launches {k1}, expected {want} on every rank")
    for i, r in enumerate(rk):
        for k, lim in (("gstrf_residual", flimit),
                       ("gstrf_residual2", flimit),
                       ("res1", slimit), ("res3", slimit),
                       ("res2", slimit)):
            if not float(r[k]) < lim:
                fail(f"{label} rank {i}: {k} {float(r[k])} not below {lim}")
        if not bool(r["same_bits"]):
            fail(f"{label} rank {i}: two factorizations differ")
        for k in ("x1", "x3", "x2", "digest"):
            if not np.array_equal(r[k], r0[k]):
                fail(f"{label} rank {i}: {k} differs from rank 0's")
        if int(r["dist_reuse"]) != 1:
            fail(f"{label} rank {i}: the refactorization rebuilt the "
                 "tables")
    sh = np.stack([r["shard"] for r in rk])
    nt = int(r0["num_tiles"])
    full = np.zeros((nt,) + sh.shape[2:], sh.dtype)
    full[:] = sh[r0["tile_owner_r"].astype(np.int64) * q
                 + r0["tile_owner_c"], r0["tile_slot"]]
    row = dict(
        groups=groups, k1_launches_per_rank=k1[0][0],
        all_reduces_per_factorization=int(r0["comm_all_reduces"]),
        mib_per_factorization=int(r0["comm_bytes"]) / 2 ** 20,
        ms_per_factorization=float(np.median(
            [np.median(r["factor_ms"]) for r in rk])),
        numeric_ms=float(np.median([np.median(r["numeric_ms"])
                                    for r in rk])),
        ms_per_solve=float(np.median([np.median(r["solve_ms"])
                                      for r in rk])),
        gstrf_residual=float(r0["gstrf_residual"]),
        solve_residual=float(r0["res1"]),
        solve_residual_3rhs=float(r0["res3"]),
        refactor_solve_residual=float(r0["res2"]))
    print(f"  {label}: {row['ms_per_factorization']:.1f} ms per "
          f"factorization (numeric {row['numeric_ms']:.1f}), "
          f"{row['ms_per_solve']:.1f} ms per solve (unrefined), "
          f"{row['all_reduces_per_factorization']} all-reduces and "
          f"{row['mib_per_factorization']:.2f} MiB per factorization a "
          f"rank; residuals gstrf {row['gstrf_residual']:.2e}, solve "
          f"{row['solve_residual']:.2e}")
    return row, full


# the multi-device phase: the case specs of its 2 x 2 run on one card
DIST_CASES = ("p3d32_rcm:poisson3d:32:r32:rcm:128",
              "p3d32_nd:poisson3d:32:r32:nd:128",
              "p3d16_r64_nd:poisson3d:16:r64:nd:128")


def dist_phase(dev, nx: int = 32, nb: int = 128, cases=DIST_CASES,
               reps: int = 1) -> dict:
    """The multi-device engine (pangulu_tpu_torch.parallel) on the card.
    (a) In this process, the collective engine on a 1 x 1 grid
    (force_collective: every all-reduce the identity) on poisson3d(nx),
    nb, r32, rcm and nd: exactly one K1 launch (and device launch) a
    distributed group, the distributed gstrf check (factor_check_vector)
    < 1e-5, an unrefined distributed solve's residual < 1e-5, two
    factorizations the same bits, the factors within the f32 tile
    tolerance of the single-device engines' (K2 rcm, K4 nd), and its wall
    ms per factorization (call to synchronise, median of 5) beside
    theirs.  (b) Four ranks on a 2 x 2 grid, all on this card and joined
    by gloo, through pangulu_tpu_torch/tools/run_multiprocess.py (the
    kernels built before: the ranks load the library): each case
    (``cases``) runs init -> gstrf(check) -> gstrs of 1 and 3 RHS ->
    ``reps`` timed factorizations and solves -> update_values -> gstrf
    -> gstrs on every rank, each rank with its own launch counts zeroed
    before its gstrf and read after: K1 launches and device launches on
    every rank equal to the distributed groups, gstrf residuals < 1e-5
    (r32) or 1e-12 (r64), refined solve residuals < 1e-10 (r32, 2
    rounds) or 1e-12 (r64), two factorizations of one rank the same
    bits, every rank the same x and the same tables' digest; the 2 x 2
    factors, assembled from the shards, within the f32 tile tolerance of
    (a)'s (whether they are the same bits is printed).  Its numbers (ms
    per factorization and per solve, the all-reduces and MiB of one
    factorization, per rank) are four ranks sharing one card over
    host-staged gloo: not a scaling result.  Returns its numbers; any
    failure (any rank's) raises."""
    import shutil

    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.parallel.dist_numeric import DistributedLU
    from pangulu_tpu_torch.parallel.dist_sptrsv import \
        DistributedTriangularSolver
    from pangulu_tpu_torch.parallel.mesh import Grid
    from pangulu_tpu_torch.utils.perf import residual_norm

    out = {"note": "four ranks share one card over host-staged gloo; not "
                   "a scaling result"}

    def wall_ms(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # ---- (a) the collective engine on one rank ---------------------------
    a = poisson3d(nx)
    b = a.to_scipy() @ np.ones(a.n)
    one = {}
    for ordering in ("rcm", "nd"):
        print(f"dist (a): the collective engine on a 1 x 1 grid, "
              f"poisson3d({nx}), nb={nb}, r32, {ordering}, {dev.type}")
        h = init(a, InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                device=str(dev)))
        kc.reset_launch_counts()
        d = DistributedLU(h.blocked, h.schedule, Grid.single(dev),
                          force_collective=True)
        tiles = d.factorize().clone()
        launches = (kc.LAUNCHES["getrf_with_inverses"],
                    kc.DEVICE_LAUNCHES["getrf_with_inverses"])
        print(f"  {d.groups} groups; K1 launches {launches[0]}, device "
              f"launches {launches[1]}")
        if launches != (d.groups, d.groups):
            fail(f"1x1 collective {ordering}: K1 launches {launches}, "
                 f"expected {d.groups} of each")
        if not torch.equal(d.factorize(), tiles):
            fail(f"1x1 collective {ordering}: two factorizations differ")
        w = d.factor_check_vector()
        a1 = np.asarray(h.reordering.reordered.to_scipy() @ np.ones(a.n))
        fres = float(np.linalg.norm(w - a1) / np.linalg.norm(a1))
        dts = DistributedTriangularSolver(h.blocked, h.schedule, d.layout,
                                          d.grid, d.diag)
        x = h.reordering.transform_x(dts.solve(
            tiles, h.reordering.transform_b(b.astype(np.float32))))
        sres = residual_norm(a.to_scipy(), x, b)
        print(f"  gstrf check {fres:.3e} (< 1e-5), unrefined solve "
              f"residual {sres:.3e} (< 1e-5)")
        if not (fres < 1e-5 and sres < 1e-5):
            fail(f"1x1 collective {ordering}: residuals {fres}, {sres}")
        mega = LUFactorizer(h.blocked, h.schedule, device=dev)
        tol = TOL_GROUP_F32 if mega.dispatch == "mega_group" else TOL_F32
        nt = h.blocked.num_tiles
        err = compare(f"1x1 collective against {mega.dispatch}",
                      tiles[:nt], mega.factorize()[:nt], *tol)
        coll_ms = wall_ms(lambda: d.factorize())
        mega_ms = wall_ms(lambda: mega.factorize())
        solve_ms = wall_ms(lambda: dts.solve(
            tiles, h.reordering.transform_b(b.astype(np.float32))))
        print(f"  wall ms per factorization: collective 1x1 {coll_ms:.3f}, "
              f"{mega.dispatch} {mega_ms:.3f}; distributed solve (1x1) "
              f"{solve_ms:.3f}")
        one[ordering] = dict(
            groups=d.groups, k1_launches=launches[0], gstrf_residual=fres,
            solve_residual_unrefined=sres, max_abs_err_vs_single=err,
            single_engine=mega.dispatch, ms_per_factorization=coll_ms,
            single_ms_per_factorization=mega_ms, ms_per_solve=solve_ms,
            tiles=tiles[:nt].cpu().numpy())
        del h, d, dts, mega, tiles
        torch.cuda.empty_cache()

    # ---- (b) four ranks, one card, gloo ----------------------------------
    print("dist (b): 4 ranks on a 2 x 2 grid, all on this card, gloo: "
          + ", ".join(cases))
    t0 = time.perf_counter()
    tmp = run_ranks(dev, cases, reps)
    out["ranks_wall_s"] = time.perf_counter() - t0
    try:
        for spec in cases:
            label, _, _, dtype, ordering = spec.split(":")[:5]
            row, full = check_ranks(tmp, spec)
            if label.startswith(f"p3d{nx}_") and dtype == "r32":
                ref = one[ordering]["tiles"]
                tol = TOL_GROUP_F32 if ordering == "nd" else TOL_F32
                row["max_abs_err_vs_1x1"] = compare(
                    f"{label}: 2x2 factors against the 1x1 collective "
                    "engine's", torch.as_tensor(full), torch.as_tensor(ref),
                    *tol)
                row["bit_identical_to_1x1"] = bool(np.array_equal(full,
                                                                  ref))
                print(f"  {label}: the 2x2 factors are "
                      f"{'' if row['bit_identical_to_1x1'] else 'not '}"
                      "the 1x1 collective engine's bits")
            out[label] = row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for ordering, v in one.items():
        v.pop("tiles")
        out[f"1x1_{ordering}"] = v
    return out


def probes_phase(dev) -> tuple:
    """The TPU probes P5, P4, P3 on the card: (1) each kernel against its
    plain version (true f32; P3's per row, its f64 within 1e-12 per row;
    the 3xTF32 instances within TF32X3_REL) and, with b = 0, the scan
    part of every instance with products bit-equal to the scan alone, at
    the probes' own step counts; P4 and P3 at each cluster size the card
    takes; (2) with the launch counts zeroed before and read after, the
    probes' own path, the three tools' run() at the probes' sizes, which
    print their tables; (3) the plain versions timed at the kernels
    line's sizes.  Returns (details, kernel entries, launches of the
    probes' path)."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import (newton_inputs, newton_mixed_inputs,
                                           probe_inputs)
    from pangulu_tpu_torch.tools import (probe_newton_loop, probe_overlap,
                                         probe_scan_multi)

    eps = torch.finfo(torch.float32).eps
    out, kern = {"true_f32": {}, "tf32x3": {}}, {}
    # max |kernel - plain f32|, and over the scale of plain f64 (its
    # largest entry; for P3 each row's: inverses reach ~1e17)
    err = dict.fromkeys(PROBES, 0.0)
    rel = dict.fromkeys(PROBES, 0.0)

    def true_f32(name, label, got, p32, p64, per_row=False, show=True):
        ek = rel_err(got, p64, per_row)
        ep = rel_err(p32, p64, per_row)
        ok = bool(torch.isfinite(got).all()) and ek <= max(2 * ep, eps)
        if show or not ok:
            print(f"  {label}: kernel {ek:.3e}, plain f32 {ep:.3e} (kernel "
                  f"<= 2x plain) {'ok' if ok else 'FAIL'}")
        out["true_f32"][label] = dict(kernel=ek, plain=ep)
        err[name] = max(err[name],
                        float((got.double() - p32.double()).abs().max()))
        scale = p64.abs().amax(-1, keepdim=True) if per_row else \
            p64.abs().max()
        rel[name] = max(rel[name], float(
            ((got.double() - p32.double()).abs() / scale).max()))
        if not ok:
            fail(f"{label}: less accurate than true f32")

    print("probes (1): P5, P4, P3 against their plain versions (error "
          "against the plain f64 version, relative to its largest entry; "
          "P3: to each row's)")
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    a64, b64 = a.double(), b.double()
    clusters = probe_scan_multi.CLUSTERS
    for steps in (128, 256):
        for mode in kt.OVERLAP_MODES:
            true_f32("scan_overlap", f"P5 {mode} {steps} steps",
                     kc.scan_overlap(a, b, mode, steps),
                     kt.scan_overlap(a, b, mode, steps),
                     kt.scan_overlap(a64, b64, mode, steps))
        for q in kt.SCAN_CHAINS:
            for wd, c in ((False, kc.SCAN_CLUSTER),
                          *((True, c) for c in clusters)):
                true_f32("scan_multi",
                         f"P4 q={q} products={int(wd)}"
                         + (f" C={c}" if wd else "") + f" {steps} steps",
                         kc.scan_multi(a, b, q, wd, steps, cluster=c),
                         kt.scan_multi(a, b, q, wd, steps),
                         kt.scan_multi(a64, b64, q, wd, steps))
    # copies: each its own chains and cluster, on a tile of 100
    a1, b1 = (torch.as_tensor(x, device=dev)
              for x in probe_inputs(seed=1, nb=100))
    many = kc.scan_multi(a1, b1, 8, True, 128, copies=3)
    if many.shape != (3, 100, 100) or not all(torch.equal(m, many[0])
                                              for m in many):
        fail("P4 copies=3, n=100: the copies differ")
    true_f32("scan_multi", "P4 q=8 products=1 copies=3 n=100 128 steps",
             many[0], kt.scan_multi(a1, b1, 8, True, 128),
             kt.scan_multi(a1.double(), b1.double(), 8, True, 128))
    many = kc.scan_overlap(a1, b1, "split", 128, copies=3)
    if many.shape != (3, 100, 100) or not all(torch.equal(m, many[0])
                                              for m in many):
        fail("P5 copies=3, n=100: the copies differ")
    true_f32("scan_overlap", "P5 split copies=3 n=100 128 steps", many[0],
             kt.scan_overlap(a1, b1, "split", 128),
             kt.scan_overlap(a1.double(), b1.double(), "split", 128))
    # the 3xTF32 instances, timed only: a sanity bound, not true f32
    s3 = 128
    for label, got, p64 in (
            *((f"P5 {m}", kc.scan_overlap(a, b, m, s3, products="tf32x3"),
               kt.scan_overlap(a64, b64, m, s3))
              for m in ("dots", "both", "split")),
            *((f"P4 q={q} C={c}", kc.scan_multi(a, b, q, True, s3,
                                                products="tf32x3",
                                                cluster=c),
               kt.scan_multi(a64, b64, q, True, s3))
              for q in kt.SCAN_CHAINS for c in clusters)):
        e = rel_err(got, p64)
        out["tf32x3"][label] = e
        ok = bool(torch.isfinite(got).all()) and e <= TF32X3_REL
        print(f"  {label} 3xTF32 {s3} steps: {e:.3e} of max |plain f64| "
              f"(<= {TF32X3_REL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label} 3xTF32 disagrees with its plain version")
    # with b = 0 the products stay 0: every instance with products returns
    # its scan alone, the same bits as the instance without, at the
    # probes' own step counts (the chains stay finite there)
    zero = torch.zeros_like(b)
    s5, s4 = probe_overlap.STEPS, probe_scan_multi.STEPS
    scan = kc.scan_overlap(a, zero, "scan", s5)
    if not torch.isfinite(scan).all():
        fail(f"P5: the scan chain left float32's range at {s5} steps")
    for m in ("both", "split"):
        for pr in kc.PROBE_PRODUCTS:
            if not torch.equal(kc.scan_overlap(a, zero, m, s5, products=pr),
                               scan):
                fail(f"P5 {m} {pr}: with b = 0, differs from scan")
    print(f"  P5 both and split, f64 and 3xTF32, b = 0, {s5} steps: "
          "bit-equal to scan")
    for q in kt.SCAN_CHAINS:
        alone = kc.scan_multi(a, zero, q, False, s4)
        if not torch.isfinite(alone).all():
            fail(f"P4 q={q}: a chain left float32's range at {s4} steps")
        for pr in kc.PROBE_PRODUCTS:
            for c in clusters:
                if not torch.equal(kc.scan_multi(a, zero, q, True, s4,
                                                 products=pr, cluster=c),
                                   alone):
                    fail(f"P4 q={q} {pr} C={c}: with b = 0, differs from "
                         "the chains alone")
    print(f"  P4 q={kt.SCAN_CHAINS} with products, f64 and 3xTF32, C = "
          f"{clusters}, b = 0, {s4} steps: bit-equal to the chains alone")
    # P3: unit triangles and a batch with a general member, the probe's
    # steps and two truncated counts, at each cluster size; a line for
    # each batch with its worst readings (every failure prints its own)
    for g in (4, 16):
        for nb in (16, 100, 128):
            for mixed in (False, True):
                inputs = newton_mixed_inputs if mixed else newton_inputs
                lm = torch.as_tensor(inputs(g, nb, seed=nb), device=dev)
                kind = "mixed" if mixed else "triangles"
                counts = (kt.newton_steps(nb), 0, 2)
                worst = dict(kernel=0.0, plain=0.0, f64=0.0)
                for st in counts:
                    p64 = kt.newton_loop(lm.double(), st)
                    p32 = kt.newton_loop(lm, st)
                    for c in probe_newton_loop.CLUSTERS:
                        label = f"P3 G={g} nb={nb} {kind} steps={st} C={c}"
                        true_f32("newton_loop", label,
                                 kc.newton_loop(lm, st, blocks=c), p32, p64,
                                 per_row=True, show=False)
                        e64 = rel_err(kc.newton_loop(lm.double(), st,
                                                     blocks=c), p64, True)
                        out["true_f32"][label]["f64"] = e64
                        for k, v in out["true_f32"][label].items():
                            worst[k] = max(worst[k], v)
                        if not e64 <= 1e-12:
                            fail(f"{label}: f64 {e64:.3e} of each row's max "
                                 "|plain f64|, above 1e-12")
                print(f"  P3 G={g} nb={nb} {kind}, steps {counts}, C "
                      f"{probe_newton_loop.CLUSTERS}: worst f32 kernel "
                      f"{worst['kernel']:.3e} (plain f32 up to "
                      f"{worst['plain']:.3e}, kernel <= 2x plain each), "
                      f"f64 {worst['f64']:.3e} (<= 1e-12) of each row's max")

    print("probes (2): the probes' own path at their sizes, timed only")
    kc.reset_launch_counts()
    p5 = probe_overlap.run(reps=3)
    p4 = probe_scan_multi.run(reps=3)
    p3 = probe_newton_loop.run(reps=3)
    torch.cuda.synchronize()
    launches = {k: kc.LAUNCHES[k] for k in PROBES}
    print(f"  launches: {launches}")
    if not all(launches.values()):
        fail(f"a probe kernel was not launched on the probes' path: "
             f"{launches}")
    out.update(overlap=p5, scan_multi=p4, newton_loop=p3)

    print("probes (3): the plain versions at the kernels line's sizes")
    nb = 128
    q4 = max(kt.SCAN_CHAINS)
    g3 = max(probe_newton_loop.GROUPS)
    lm = torch.as_tensor(newton_inputs(g3, nb, seed=g3), device=dev)
    st = kt.newton_steps(nb)
    tile = nb * nb * 4
    row4 = next(r for r in p4["rows"]
                if r["q"] == q4 and r["dot"] and r["products"] == "f64"
                and r["cluster"] == kc.SCAN_CLUSTER)
    row3 = next(r for r in p3["rows"] if r["g"] == g3)
    dmma = TC_FLOP_S[torch.float64]
    # P5's products run on acc's 16 column strips, a CTA (an SM) each
    b5, sm5 = probe_bound(3 * tile, scan_flop(nb, s5, 1), s5 * 2 * nb ** 3,
                          dmma, probe_overlap.STRIPS)
    b4, sm4 = probe_bound(3 * tile, scan_flop(nb, s4, q4), s4 * 2 * nb ** 3,
                          dmma, kc.SCAN_CLUSTER)
    # P3's function: G unit-lower triangle inverses, members in and out
    b3, sm3 = probe_bound(2 * g3 * tile,
                          g3 * unit_triangle_inverse_flop(nb), 0, dmma,
                          g3 * kc.NEWTON_CLUSTER)
    entries = {
        "scan_overlap": dict(
            ms=p5["column_strips"]["both"]["ms"],
            plain_ms=cuda_ms(lambda _: kt.scan_overlap(a, b, "both", s5),
                             reps=1),
            library_ms=None, **b5),
        "scan_multi": dict(
            ms=row4["ms"],
            plain_ms=cuda_ms(lambda _: kt.scan_multi(a, b, q4, True, s4),
                             reps=1),
            library_ms=None, **b4),
        "newton_loop": dict(
            ms=row3[f"cluster{kc.NEWTON_CLUSTER}_us"] / 1e3,
            plain_ms=cuda_ms(lambda _: kt.newton_loop(lm, st), reps=3),
            library_ms=row3["solve_triangular_us"] / 1e3, **b3),
    }
    on_sms = dict(scan_overlap=sm5, scan_multi=sm4, newton_loop=sm3)
    for name, e in entries.items():
        kern[name] = dict(max_abs_err=err[name], max_rel_err=rel[name], **e)
        print(f"  {name}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.3f}"
              f" ms, bound {e['bound_ms']:.3e} ms ({e['bound_by']}), on its "
              f"SMs {on_sms[name]:.3e} ms, library "
              + ("none" if e["library_ms"] is None
                 else f"{e['library_ms']:.4f} ms (solve_triangular)"))
    out["kernels"] = kern
    out["sm_bound_ms"] = on_sms
    return out, kern, launches


WIDE_NBS = (288, 384, 512)
# K1 above 512 on the flow kernel, checked in xla_engines_phase (a)
WIDE_SPLIT_NB = 640


def factor_residual_device(h, tiles) -> float:
    """||L(U 1) - A 1|| / ||A 1|| of the factored tiles of handle h, on
    their device in float64 (utils.perf.factorization_residual without
    the host gather of L and U): w = U·1 and v = L·w over the block
    pattern, then v against A·1 on the host."""
    b = h.blocked
    nb, bl, nt = b.nb, b.block_length, b.num_tiles
    dev = tiles.device
    rows = torch.as_tensor(np.asarray(b.browidx, np.int64), device=dev)
    cols = torch.as_tensor(np.repeat(np.arange(bl), np.diff(b.bcolptr)),
                           device=dev)
    t = tiles[:nt].to(torch.complex128 if tiles.dtype.is_complex
                      else torch.float64)
    up, lo, dg = rows < cols, rows > cols, rows == cols
    w = torch.zeros((bl, nb), dtype=t.dtype, device=dev)
    w.index_add_(0, rows[up], t[up].sum(-1))
    w.index_add_(0, rows[dg], torch.triu(t[dg]).sum(-1))
    v = torch.zeros_like(w)
    v.index_add_(0, rows[lo], (t[lo] @ w[cols[lo]][..., None])[..., 0])
    eye = torch.eye(nb, dtype=t.dtype, device=dev)
    v.index_add_(0, rows[dg], ((torch.tril(t[dg], -1) + eye)
                               @ w[cols[dg]][..., None])[..., 0])
    a3 = h.reordering.reordered.to_scipy()
    a1 = a3 @ np.ones(b.n)
    lu1 = v.reshape(-1)[:b.n].cpu().numpy()
    return float(np.linalg.norm(lu1 - a1) / (np.linalg.norm(a1) or 1.0))


def xla_engines_phase(dev, nx: int = 32, nb: int = 512, nb_mid: int = 384,
                      nx_c: int = 24, nb_c: int = 128,
                      k1_nbs=WIDE_NBS, split_nb=WIDE_SPLIT_NB) -> tuple:
    """The fused and levels engines (numeric.py, sptrsv.py; the JAX
    package's XLA engines) on the card, with K1 for tiles wider than 256
    (csrc/wide_lu.cuh) as their diagonal step:

      (a) the cluster kernel's plan from the C side (plu_wide_plan)
          against kernels_cuda.wide_plan at every nb up to 512, both
          types, and the clusters of the widest that fit at once; K1 at
          each nb of k1_nbs and at split_nb, float and double, batch 1
          and 4, against its plain twin (kernels_torch.k1_wide: the
          blocked step on leaves of kernels_torch.k1_leaf_width, the
          recursion above) at TOL_F32 / TOL_F64 and the rank-1 scan at
          BLOCKED_TOL, and on a tile with zero pivots at 0 and at
          wide_split(nb) (float U^-1 at the flow kernel's widths by
          testing.zero_pivot_uinv_errors: the column at the second
          pivot, its entries scaled by 1/tol, by its residual in
          U·U^-1, the rest at the contract); one K1 launch
          a call, of kernels_cuda.k1_device_launches (1 up to 512, and
          at split_nb the flow kernel's 1 but for float64 batch 4,
          whose tiles do not fit on the card at once: 7); true f32 at
          the widest nb of k1_nbs
          (the f32 kernel's error against the f64 twin at most 2x the
          f32 twin's); per launch device ms (median of 7) beside its
          bound, the twin's ms and torch.linalg.lu_factor_ex(pivot=
          False);
      (b) poisson3d(nx) at nb, r32, rcm and nd: init -> gstrf -> gstrs,
          dispatch "auto": engine fused on backend cuda, exactly one K1
          launch a level (one device launch each) and no other kernel
          launch, gstrf residual (on the card) < 1e-5, solve residual
          after the default refinement < 1e-10; ms per factorization and
          per solve (median of 5); one traced factorization of each (K1's
          device ms and share, the rest: PyTorch's products, gathers and
          scatters);
      (c) the same at r64, rcm: residuals < 1e-12, ms per factorization;
      (d) dispatch "levels" with panel_solve "trsm" on (b)'s rcm store:
          its factor within 1e-5 of (b)'s (relative to the largest
          entry), solve residual < 1e-10; and gstrf at nb_mid, nd
          (residual < 1e-5, one K1 launch a level);
      (e) complex_mode "native", cr32 and cr64, nb_c, nd, on
          poisson3d(nx_c) with imaginary parts: engine fused on backend
          torch, no hand-kernel launch, residuals (A in the working
          precision) < 1e-10 (cr32) and 1e-12 (cr64), the solution within
          1e-6 (cr32) and 1e-9 (cr64) of the real 2x2 embedding's on the
          same inputs; ms per factorization.

    Returns (its numbers, the kernels-line entries of K1 at nb and
    nb_mid, their launches on the path).  Any failure raises."""
    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.sptrsv import TriangularSolver
    from pangulu_tpu_torch.testing import (BLOCKED_TOL, with_imaginary_parts,
                                           wide_tiny_pivot_tile,
                                           zero_pivot_uinv_errors)
    from pangulu_tpu_torch.utils.perf import residual_norm

    out, entries, launches = {"K1": {}}, {}, {}
    rng = np.random.default_rng(18)

    twin = kt.k1_wide

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k1_counts(what, calls, w=nb, batch=1, dt=torch.float32):
        each = kc.k1_device_launches(w, batch, dt, sms)
        got = (kc.LAUNCHES["getrf_with_inverses"],
               kc.DEVICE_LAUNCHES["getrf_with_inverses"])
        if got != (calls, each * calls) or any(
                v for k, v in kc.LAUNCHES.items()
                if k != "getrf_with_inverses"):
            fail(f"{what}: launches {dict(kc.LAUNCHES)}, K1 device "
                 f"launches {got[1]}; expected K1 {calls} ({each} device "
                 "launch(es) each) and no other kernel")

    # ---- (a) K1 for wide tiles against its twin ------------------------
    print("xla engines (a): K1 for nb > 256 (csrc/wide_lu.cuh) against its "
          "plain twin (the blocked step; the recursion on its leaves above "
          "512) and the rank-1 scan")
    lib = kc.library().lib
    plan = (ctypes.c_int * 4)()
    fit = ctypes.c_int()
    out["plan"] = {}
    for dt in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dt).element_size()
        for w in range(1, kt.WIDE_LEAF + 1):
            want = kc.wide_plan(w, dt)
            if lib.plu_wide_plan(w, size, plan) != 0 or tuple(plan) != (
                    want["ctas"], want["rows"], want["smem"],
                    want["stripe"]):
                fail(f"K1's cluster plan at nb={w} {dt}: the C side says "
                     f"{tuple(plan)}, kernels_cuda.wide_plan {want}")
        s = "f32" if dt == torch.float32 else "f64"
        if getattr(lib, f"plu_wide_fit_{s}")(dev.index, kt.WIDE_LEAF,
                                             ctypes.byref(fit)) != 0:
            fail(f"plu_wide_fit_{s} failed")
        out["plan"][str(dt)] = dict(
            **{str(w): kc.wide_plan(w, dt) for w in k1_nbs},
            clusters_that_fit=fit.value)
        print(f"  {dt}: plans agree at nb = 1..{kt.WIDE_LEAF}; at "
              f"{kt.WIDE_LEAF} {kc.wide_plan(kt.WIDE_LEAF, dt)}, "
              f"{fit.value} clusters fit at once")
    for w in (*k1_nbs, split_nb):
        row = {}
        for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
            err = 0.0
            for batch in (1, 4):
                a = torch.as_tensor(rng.standard_normal((batch, w, w))
                                    + w * np.eye(w), dtype=dt, device=dev)
                kc.reset_launch_counts()
                got = kc.getrf_with_inverses(a)
                k1_counts(f"K1 nb={w} {dt} batch {batch}", 1, w, batch, dt)
                for n, g, r in zip(("f", "linv", "uinv"), got, twin(a)):
                    err = max(err, compare(f"{dt} nb={w} batch {batch} {n} "
                                           "(twin)", g, r, *tol))
                for n, g, r, t in zip(("f", "linv", "uinv"), got,
                                      kt.getrf_with_inverses(a),
                                      BLOCKED_TOL[dt]):
                    compare(f"{dt} nb={w} batch {batch} {n} (rank-1)", g, r,
                            *t)
            a = torch.as_tensor(wide_tiny_pivot_tile(w, rng), dtype=dt,
                                device=dev)
            got = kc.getrf_with_inverses(a)
            m1 = kt.wide_split(w)
            tolv = float(torch.tensor(kt.DEFAULT_TOL[dt], dtype=dt))
            if not (float(got[0][0, 0]) == float(got[0][m1, m1]) == tolv):
                fail(f"K1 nb={w} {dt}: the zero pivots at 0 and {m1} did "
                     "not become +tol")
            for n, g, r in zip(("f", "linv", "uinv"), got, twin(a)):
                what = f"{dt} nb={w} zero pivots at 0 and {m1} {n}"
                if n != "uinv" or w <= kt.WIDE_LEAF or dt != torch.float32:
                    compare(what, g, r, *tol)
                    continue
                # at the flow kernel's widths, where no split of the
                # recursion falls on the pivot at m1, float U^-1's column
                # there (entries scaled by 1/tol; the f32 twin is 100%
                # off the f64 one there) is held by its residual in
                # U·U^-1, the rest at the contract (testing.
                # zero_pivot_uinv_errors)
                zp = zero_pivot_uinv_errors(got[0], g, r, tol)
                print(f"  {what}: columns but {m1} {zp['rest']:.3f} of "
                      f"{tol}; column {m1}: its residual "
                      f"{zp['residual']:.2e} of nb·u·|U||U^-1|, against "
                      f"the twin {zp['column']:.3f} of {BLOCKED_TOL[dt][2]}")
                if not all(np.isfinite(zp[x]) and zp[x] <= 1
                           for x in ("rest", "residual")):
                    fail(f"{what}: {zp} (rest and residual must be <= 1)")
            row[str(dt)] = dict(max_abs_err=err)
        out["K1"][w] = row
    w = max(k1_nbs)
    a = torch.as_tensor(rng.standard_normal((4, w, w)) + w * np.eye(w),
                        device=dev)
    ref = twin(a)
    true = {}
    for n, g, p, r in zip(("f", "linv", "uinv"),
                          kc.getrf_with_inverses(a.float()),
                          twin(a.float()), ref):
        ek, ep = rel_err(g, r), rel_err(p, r)
        true[n] = dict(kernel=ek, plain=ep)
        print(f"  true f32 at nb={w}, {n} against the f64 twin: kernel "
              f"{ek:.3e}, f32 twin {ep:.3e} (kernel <= 2x plain) "
              f"{'ok' if ek <= 2 * ep else 'FAIL'}")
        if ek > 2 * ep:
            fail(f"K1 at nb={w}: {n} less accurate than true f32")
    out["K1_true_f32"] = true
    print("  K1 per launch (back-to-back launches, device time, median of "
          "7) beside its bound, its twin and lu_factor_ex(pivot=False)")
    for w in (*k1_nbs, split_nb):
        for dt in (torch.float32, torch.float64):
            for batch in (1, 4):
                a = torch.as_tensor(rng.standard_normal((batch, w, w))
                                    + w * np.eye(w), dtype=dt, device=dev)
                ms = device_ms(lambda: kc.getrf_with_inverses(a), n=20,
                               reps=7)
                lms = device_ms(lambda: torch.linalg.lu_factor_ex(
                    a, pivot=False), n=20, reps=7)
                r = dict(ms=ms, ms_per_tile=ms / batch, library_ms=lms,
                         **k1_bound(w, batch, dt))
                if batch == 1:
                    r["plain_ms"] = cuda_ms(lambda _: twin(a), reps=3)
                print(f"  nb={w} {dt} batch {batch}: kernel {ms:.4f} ms, "
                      f"bound {r['bound_ms']:.3e} ms ({r['bound_by']}), "
                      f"lu_factor_ex {lms:.4f} ms"
                      + (f", twin {r['plain_ms']:.3f} ms" if batch == 1
                         else ""))
                out["K1"][w][f"{dt}_batch{batch}"] = r

    def entry(w):
        one = out["K1"][w]["torch.float32_batch1"]
        return dict(max_abs_err=out["K1"][w]["torch.float32"]["max_abs_err"],
                    ms=one["ms"], plain_ms=one["plain_ms"],
                    library_ms=one["library_ms"], bound_ms=one["bound_ms"],
                    bound_by=one["bound_by"])

    # ---- (b), (c) the fused engine at nb ----------------------------------
    a = poisson3d(nx)
    s = a.to_scipy()
    b = s @ np.ones(a.n)

    def path(dtype, ordering, limit, label, n_solve_ms=True):
        print(f"xla engines {label}: init -> gstrf -> gstrs, poisson3d({nx}) "
              f"nb={nb} {dtype} {ordering}, dispatch auto, {dev}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device=str(dev)))
        kc.reset_launch_counts()
        gstrf(h)
        x = gstrs(h, b)
        bl = h.schedule.block_length
        k1_counts(f"{label} {dtype} {ordering}", bl)
        launched = dict(kc.LAUNCHES)
        k1_dev = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        eng, be = h.perf.kernels["engine"], h.perf.kernels["backend"]
        fres = factor_residual_device(h, h.factor_tiles)
        res = residual_norm(s, x, b)
        print(f"  engine {eng}, backend {be}, solve engine "
              f"{h._trisolver.dispatch}; block_length {bl}, tiles "
              f"{h.blocked.num_tiles}, fused_overhead "
              f"{h.schedule.fused_overhead():.2f}; gstrf residual "
              f"{fres:.3e} (< {limit[0]:g}), solve residual {res:.3e} "
              f"(< {limit[1]:g})")
        if (eng, be, h._trisolver.dispatch) != ("fused", "cuda", "fused"):
            fail(f"{label}: engine {eng} on backend {be}, expected fused "
                 "on cuda")
        if not (fres < limit[0] and res < limit[1]):
            fail(f"{label} {dtype} {ordering}: residual too large")
        if x.shape != (a.n,) or not np.isfinite(x).all():
            fail(f"{label}: solution of shape {x.shape}, not finite")
        fac, ts = h._factorizer, h._trisolver

        def setup():
            return h.blocked.device_tiles(dev)

        def factor(t):
            return fac.factorize(t, sync=False)

        fms = cuda_ms(factor, setup=setup, reps=5)
        xb = ts.blockify_rhs(h.reordering.transform_b(
            b.astype(h.blocked.dtype)))
        num = dict(n=a.n, bl=bl, tiles=h.blocked.num_tiles,
                   fused_overhead=h.schedule.fused_overhead(),
                   flops=h.schedule.flop_estimate(),
                   launches=launched, k1_device_launches=k1_dev,
                   gstrf_residual=fres, residual=res,
                   ms_per_factorization=fms)
        msg = f"  {fms:.3f} ms per factorization"
        if n_solve_ms:
            num["ms_per_solve"] = cuda_ms(
                lambda _: ts.solve_blocked(h.factor_tiles, xb), reps=5)
            msg += f", {num['ms_per_solve']:.3f} ms per solve"
        print(msg + " (CUDA events, median of 5)")
        return h, num, factor, setup

    def traced(num, factor, setup):
        tr = profile(factor, setup=setup)
        k1 = {n: k for n, k in tr["kernels"].items()
              if any(s in n for s in ("lu_cluster_kernel", "getrf_inv_kernel",
                                      "lu_wide_kernel", "lu_flow_kernel",
                                      "wide_gemm_kernel",
                                      "wide_copy_kernel"))}
        k1_ms = sum(k["device_ms"] for k in k1.values())
        rest = tr["busy_ms"] - k1_ms
        num.update(trace=tr, k1_device_ms=k1_ms,
                   k1_share=k1_ms / tr["busy_ms"], other_device_ms=rest)
        print(f"  one factorization traced: wall {tr['wall_ms']:.3f} ms, "
              f"busy {tr['busy_ms']:.3f} ms (idle share "
              f"{tr['idle_share']:.3f}); K1 {k1_ms:.3f} device ms "
              f"({k1_ms / tr['busy_ms']:.1%} of busy, "
              f"{sum(k['launches'] for k in k1.values())} launches); the "
              f"rest (PyTorch's products, gathers, scatters) {rest:.3f}")
        for name, k in sorted(tr["kernels"].items(),
                              key=lambda kv: -kv[1]["device_ms"])[:8]:
            print(f"    {name[:90]}: {k['launches']} launches, "
                  f"{k['device_ms']:.3f} device ms")

    for ordering in ("rcm", "nd"):
        h, num, factor, setup = path("r32", ordering, (1e-5, 1e-10), "(b)")
        traced(num, factor, setup)
        out[f"r32_{ordering}"] = num
        if ordering == "rcm":
            launches[f"getrf_with_inverses@nb={nb}"] = num["launches"][
                "getrf_with_inverses"]
            rcm = h
        else:
            del h
    h64, out["r64_rcm"], _, _ = path("r64", "rcm", (1e-12, 1e-12), "(c)",
                                     n_solve_ms=False)
    del h64

    # ---- (d) levels with trsm panel solves; nb_mid ----------------------
    print(f"xla engines (d): dispatch levels, panel_solve trsm, nb={nb} r32 "
          "rcm, on (b)'s store")
    kc.reset_launch_counts()
    lev = LUFactorizer(rcm.blocked, rcm.schedule, device=dev,
                       panel_solve="trsm")
    tiles = lev.factorize()
    k1_counts("(d) levels", rcm.schedule.block_length)
    if lev.dispatch != "levels":
        fail(f"panel_solve='trsm' took {lev.dispatch}, expected levels")
    nt = rcm.blocked.num_tiles
    dif = rel_err(tiles[:nt], rcm.factor_tiles[:nt].double())
    rcm._factorizer, rcm.factor_tiles = lev, tiles
    rcm._trisolver = TriangularSolver(rcm.blocked, rcm.schedule, device=dev,
                                      dispatch="levels")
    x = gstrs(rcm, b)
    res = residual_norm(s, x, b)
    lms = cuda_ms(lambda t: lev.factorize(t, sync=False),
                  setup=lambda: rcm.blocked.device_tiles(dev), reps=5)
    print(f"  factor against fused: {dif:.3e} (< 1e-5); solve residual "
          f"{res:.3e} (< 1e-10); {lms:.3f} ms per factorization")
    if not (dif < 1e-5 and res < 1e-10):
        fail("levels/trsm disagrees with fused or its residual is too large")
    out["levels_trsm"] = dict(factor_rel_err=dif, residual=res,
                              ms_per_factorization=lms)
    del rcm, lev, tiles
    print(f"xla engines (d): gstrf at nb={nb_mid}, r32, nd")
    torch.cuda.empty_cache()
    h = init(a, InitOptions(nb=nb_mid, dtype="r32", ordering="nd",
                            device=str(dev)))
    kc.reset_launch_counts()
    gstrf(h)
    bl = h.schedule.block_length
    k1_counts(f"nb={nb_mid} nd", bl)
    fres = factor_residual_device(h, h.factor_tiles)
    fms = cuda_ms(lambda t: h._factorizer.factorize(t, sync=False),
                  setup=lambda: h.blocked.device_tiles(dev), reps=5)
    print(f"  engine {h.perf.kernels['engine']}, block_length {bl}, tiles "
          f"{h.blocked.num_tiles}; gstrf residual {fres:.3e} (< 1e-5); "
          f"{fms:.3f} ms per factorization")
    if h.perf.kernels["engine"] != "fused" or not fres < 1e-5:
        fail(f"nb={nb_mid} nd: engine or residual")
    out[f"r32_nd_nb{nb_mid}"] = dict(bl=bl, tiles=h.blocked.num_tiles,
                                     gstrf_residual=fres,
                                     ms_per_factorization=fms)
    launches[f"getrf_with_inverses@nb={nb_mid}"] = bl
    del h

    # ---- (e) native complex ----------------------------------------------
    ca = with_imaginary_parts(poisson3d(nx_c))
    for dtype, limit, agree in (("cr32", 1e-10, 1e-6), ("cr64", 1e-12, 1e-9)):
        print(f"xla engines (e): complex_mode native, poisson3d({nx_c}) with "
              f"imaginary parts, nb={nb_c}, {dtype}, nd")
        torch.cuda.empty_cache()
        cdt = np.complex64 if dtype == "cr32" else np.complex128
        aw = ca.to_scipy().astype(cdt).astype(np.complex128)
        bc = aw @ np.full(ca.n, 1 + 1j)
        kc.reset_launch_counts()
        h = init(ca, InitOptions(nb=nb_c, dtype=dtype, ordering="nd",
                                 device=str(dev), complex_mode="native"))
        gstrf(h)
        x = gstrs(h, bc)
        if any(kc.LAUNCHES.values()):
            fail(f"native {dtype} launched {dict(kc.LAUNCHES)}: no hand "
                 "kernel takes complex tiles")
        eng, be = h.perf.kernels["engine"], h.perf.kernels["backend"]
        res = residual_norm(aw, x, bc)
        he = init(ca, InitOptions(nb=nb_c, dtype=dtype, ordering="nd",
                                  device=str(dev), complex_mode="embed"))
        gstrf(he)
        xe = gstrs(he, bc)
        agr = float(np.abs(x - xe).max() / np.abs(xe).max())
        # host-bound (thousands of small PyTorch launches a level): one
        # timed factorization after the one above
        fms = cuda_ms(lambda t: h._factorizer.factorize(t, sync=False),
                      setup=lambda: h.blocked.device_tiles(dev), reps=1,
                      warmup=0)
        print(f"  engine {eng}, backend {be}; residual {res:.3e} (< "
              f"{limit:g}); against the embedding {agr:.3e} (< {agree:g}); "
              f"{fms:.3f} ms per factorization (CUDA events, one)")
        if (eng, be) != ("fused", "torch") or not (res < limit
                                                   and agr < agree):
            fail(f"native {dtype}: engine {eng}/{be}, residual or agreement")
        out[f"native_{dtype}"] = dict(bl=h.schedule.block_length,
                                      residual=res, against_embed=agr,
                                      ms_per_factorization=fms)
        del h, he
    for w in (nb, nb_mid):
        entries[f"getrf_with_inverses@nb={w}"] = entry(w)
    torch.cuda.empty_cache()
    return out, entries, launches

# the wide and native stores phase: its 2 x 2 ranks on one card (r32 at
# nb=512, K1 for wide tiles on every rank; native cr64 tiles)
WIDE_DIST_CASES = ("p3d32_nb512_rcm:poisson3d:32:r32:rcm:512",
                   "p3d16_cr64n_rcm:poisson3d:16:cr64:rcm:128:native")


def wide_native_stores_phase(dev, nx: int = 32, nb: int = 512,
                             p6_nbs=(288, 384, 512), p2_nbs=(384, 512),
                             nx_c: int = 16, nb_c: int = 128,
                             dist_cases=WIDE_DIST_CASES) -> tuple:
    """The compressed store at nb > 256 and with native complex tiles,
    and the multi-device engine at nb > 256 and with native complex
    tiles, on the card:

      (a) P6 at each nb of p6_nbs, float32, float64, complex64 and
          complex128 slots (its 4-, 8- and 16-byte words), on the widest
          level's update tiles of poisson3d(nx)'s rcm store at that nb,
          random slot values: decompress and compress torch.equal to
          their plain versions; at nb, float32 (the kernels line's) and
          complex128 (the widest word), per launch device ms beside the
          bound, the plain versions and zero_ + scatter_ / gather
          (pangulu_tpu_torch/tools/probe_p6.py measure_batch; every slot
          type: probe_p6.py --wide);
      (b) P2 at each nb of p2_nbs on 64 factored diagonally dominant
          tiles: float64 within 1e-12 and float32 within 1e-5 of its
          plain twin (relative to the largest entry); per launch device
          ms beside the bound, the twin and solve_triangular;
      (c) init -> gstrf -> gstrs with tile_storage="compressed" on
          poisson3d(nx), nb, r32 rcm and nd and r64 rcm (CompressedLU,
          its diagonal step K1 for wide tiles): exact launch counts
          (testing.compressed_launches; one K1 device launch a level),
          gstrf residual on the card < 1e-5 (r64 1e-12), refined solve
          residual < 1e-10 (r64 1e-12), the factors within the tile
          tolerance of the fused engine's on the same matrix, ms per
          factorization and per solve (CUDA events, median of 5), the
          store's bytes against the dense store's, one traced
          factorization of r32 rcm and nd (K1's and P6's device ms and
          share); for r32 rcm save_factor -> load_factor -> gstrs with
          exact counts (one P2 launch);
      (d) complex_mode="native" on the compressed store, cr32 and cr64,
          poisson3d(nx_c) with imaginary parts, nb_c, rcm: exact counts
          (P6 on complex slots; no K1 and no P2: the diagonal step is
          kernels_xla's, a reload inverts by the plain doubling),
          residuals < 1e-10 / 1e-12 (A in the working precision) and
          gstrf residuals < 1e-5 / 1e-12 in complex128, a reload's
          solution, ms of the one factorization (perf's numeric phase)
          and per solve; P6 per launch on the cr64 store's widest level;
      (e) 2 x 2 ranks on this card over gloo (run_ranks, check_ranks):
          dist_cases, poisson3d(nx) nb r32 rcm (K1 for wide tiles once a
          group on every rank) and native cr64 on poisson3d(nx_c) (no
          hand kernel), residuals, the same bits on every rank.

    Returns (its numbers, kernels-line entries, their launches on the
    paths (c) and (d)).  Any failure raises."""
    import os
    import shutil
    import tempfile

    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.compressed import CompressedLU
    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.ops.kernels_torch import Indices
    from pangulu_tpu_torch.testing import (compressed_launches,
                                           with_imaginary_parts)
    from pangulu_tpu_torch.tools.probe_p6 import (SLOT_TYPES, measure_batch,
                                                   p6_batches, p6_in_trace,
                                                   print_batch, random_slots,
                                                   wide_batch)
    from pangulu_tpu_torch.utils.perf import residual_norm

    t_phase = time.perf_counter()
    cs = sys.modules[__name__]
    out, entries, launches = {"p6": {}, "p2": {}}, {}, {}
    rng = np.random.default_rng(20)

    def expect(what, want):
        want = {k: want.get(k, 0) for k in kc.LAUNCHES}
        got = dict(kc.LAUNCHES)
        if got != want:
            fail(f"{what}: launch counts {got}, expected {want}")
        return got

    def step(label):
        print(f"wide stores ({label}) at {time.perf_counter() - t_phase:.1f}"
              " s")

    def p6_entry(m, d, err=0.0):
        return dict(max_abs_err=err, ms=m[f"{d}_ms"],
                    plain_ms=m[f"{d}_plain_ms"],
                    library_ms=m[f"{d}_library_ms"], **m[f"{d}_bound"])

    # ---- (a) P6 at the wide tiles, every slot type ------------------------
    step("a")
    a = poisson3d(nx)
    s = a.to_scipy()
    b = s @ np.ones(a.n)
    for w in p6_nbs:
        clu, st, ids = wide_batch(nx, w, dev)
        cap = int(st.cap.host[ids.host].max())
        print(f"wide stores (a): P6 at nb={w}, poisson3d({nx}) rcm, the "
              f"widest level's {len(ids)} update tiles (largest {cap} "
              f"slots), every slot type")
        for dt in SLOT_TYPES:
            random_slots(st, dt, rng)
            args = (st.values, st.idx, st.off, st.cap, ids)
            got = kc.decompress_tiles(*args, w)
            backs = [torch.full_like(st.values, 5.0) for _ in range(2)]
            kc.compress_tiles(backs[0], st.idx, st.off, st.cap, ids, got)
            kt.compress_tiles(backs[1], st.idx, st.off, st.cap, ids, got)
            torch.cuda.synchronize()
            live = backs[1] != 5.0
            ok = (torch.equal(got, kt.decompress_tiles(*args, w))
                  and torch.equal(backs[0], backs[1])
                  and torch.equal(backs[0][live], st.values[live]))
            print(f"  {dt} ({st.values.element_size()}-byte slots): "
                  f"decompress and compress "
                  f"{'bit-equal' if ok else 'DIFFER'} to the plain versions")
            if not ok:
                fail(f"P6 at nb={w} {dt} disagrees with its plain version")
            out["p6"][f"nb{w}_{dt}"] = dict(tiles=len(ids), largest_cap=cap,
                                            bit_equal=ok)
            if w == nb and dt in (torch.float32, torch.complex128):
                m = measure_batch(cs, st, ids)
                print_batch(f"nb={w} {dt}", m)
                out["p6"][f"nb{w}_{dt}"].update(m)
            del got, backs
        del clu, st
        torch.cuda.empty_cache()
    m = out["p6"][f"nb{nb}_{torch.float32}"]
    for name, d in (("decompress_tiles", "decompress"),
                    ("compress_tiles", "compress")):
        entries[f"{name}@nb={nb}"] = p6_entry(m, d)

    # ---- (b) P2 above nb = 256 ---------------------------------------------
    step("b")
    for w in p2_nbs:
        batch = 64
        print(f"wide stores (b): P2 at nb={w}, {batch} factored tiles, "
              f"{kt.triangle_split(w)}-row halves over 128-wide leaves")
        f64 = kt.getrf_with_inverses(torch.as_tensor(
            rng.standard_normal((batch, w, w)) + w * np.eye(w),
            device=dev))[0]
        row = {}
        for f, lim in ((f64, TOL_F64[0]), (f64.float(), TOL_F32[0])):
            err = 0.0
            for g, r, n in zip(kc.newton_inverses(f),
                               kt.triangle_inverses(f), ("L^-1", "U^-1")):
                e = rel_err(g, r.double())
                err = max(err, float((g - r).abs().max()))
                print(f"  {f.dtype} {n}: {e:.3e} of max |twin| (<= {lim:g})")
                if not e <= lim:
                    fail(f"P2 at nb={w} {f.dtype} disagrees with its twin")
            row[str(f.dtype)] = dict(max_abs_err=err)
        f32 = f64.float().contiguous()
        eye = torch.eye(w, device=dev).expand(2 * batch, w, w)
        dg = torch.diagonal(f32, dim1=-2, dim2=-1)
        tol32 = kt.DEFAULT_TOL[torch.float32]
        safe = torch.where(dg.abs() < tol32, torch.full_like(dg, tol32), dg)
        lower = torch.cat([torch.tril(f32, -1) + eye[:batch],
                           (torch.triu(f32, 1) + torch.diag_embed(safe))
                           .transpose(-1, -2)]).contiguous()
        row.update(
            ms=device_ms(lambda: kc.newton_inverses(f32), n=10),
            plain_ms=cuda_ms(lambda _: kt.triangle_inverses(f32), reps=3),
            library_ms=device_ms(lambda: torch.linalg.solve_triangular(
                lower, eye, upper=False), n=10),
            **p2_bound(w, batch, torch.float32))
        print(f"  per launch (f32, both triangles): {row['ms']:.4f} ms "
              f"(bound {row['bound_ms']:.4f}, {row['bound_by']}), twin "
              f"{row['plain_ms']:.3f}, solve_triangular on the stacked "
              f"triangles {row['library_ms']:.4f}")
        out["p2"][w] = row
        del f64, f32, eye, lower
        if w == nb:     # no path at another width: its numbers stay here
            entries[f"newton_inverses@nb={w}"] = dict(
                max_abs_err=row[str(torch.float32)]["max_abs_err"],
                **{k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")})

    # ---- (c) the compressed store at nb --------------------------------
    def store_dense(st):
        ids = Indices.build(np.arange(st.num_tiles + 1), dev)
        return kt.decompress_tiles(st.values, st.idx, st.off, st.cap, ids,
                                   st.nb)

    step("c")
    for dtype, ordering in (("r32", "rcm"), ("r32", "nd"), ("r64", "rcm")):
        print(f"wide stores (c): init -> gstrf -> gstrs, poisson3d({nx}), "
              f"nb={nb}, {dtype}, {ordering}, tile_storage='compressed'")
        torch.cuda.empty_cache()
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                tile_storage="compressed", device=str(dev)))
        kc.reset_launch_counts()
        gstrf(h)
        x = gstrs(h, b)
        solves = 3 if dtype == "r32" else 1
        sch, st, clu = h.schedule, h.factor_tiles, h._factorizer
        bl = sch.block_length
        got = expect(f"compressed nb={nb} {dtype} {ordering}",
                     compressed_launches(sch, factorizations=1,
                                         solves=solves))
        k1_dev = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        if k1_dev != bl or type(clu) is not CompressedLU:
            fail(f"compressed nb={nb}: K1 device launches {k1_dev} (one a "
                 f"level: {bl}), engine {type(clu).__name__}")
        dense = store_dense(st)
        fres = factor_residual_device(h, dense)
        res = residual_norm(s, x, b)
        limit = (1e-5, 1e-10) if dtype == "r32" else (1e-12, 1e-12)
        fused = LUFactorizer(h.blocked, sch, device=dev)
        ftiles = fused.factorize()
        nt = h.blocked.num_tiles
        tol = TOL_F32 if dtype == "r32" else TOL_F64
        err = compare(f"compressed factors against the fused engine's "
                      f"({fused.dispatch})", dense[:nt], ftiles[:nt], *tol)
        del fused, ftiles
        print(f"  {bl} levels, {nt} tiles; gstrf residual {fres:.3e} (< "
              f"{limit[0]:g}), solve residual {res:.3e} (< {limit[1]:g}); "
              f"store {st.compressed_bytes / 2**20:.1f} MiB against "
              f"{st.dense_bytes / 2**20:.1f} MiB dense "
              f"({st.dense_bytes / st.compressed_bytes:.2f}x)")
        if not (fres < limit[0] and res < limit[1]):
            fail(f"compressed nb={nb} {dtype} {ordering}: residuals")
        if x.shape != (a.n,) or not np.isfinite(x).all():
            fail("the compressed solution has the wrong shape or is not "
                 "finite")
        st.refill(h.reordering.reordered)
        v0 = st.values.clone()
        fms = cuda_ms(lambda _: clu.factorize(),
                      setup=lambda: st.values.copy_(v0), reps=5)
        wdt = np.float32 if dtype == "r32" else np.float64
        xb = torch.zeros((bl + 1, nb, 1), dtype=st.values.dtype, device=dev)
        xb[:bl].view(-1)[:a.n] = torch.as_tensor(
            h.reordering.transform_b(b.astype(wdt)), device=dev)
        sms = cuda_ms(lambda _: clu.solve_blocked(xb), reps=5)
        print(f"  {fms:.3f} ms per factorization, {sms:.3f} ms per solve "
              "(CUDA events, median of 5)")
        row = dict(bl=bl, tiles=nt, launches=got, k1_device_launches=k1_dev,
                   gstrf_residual=fres, solve_residual=res,
                   max_abs_err_vs_fused=err,
                   store_bytes=st.compressed_bytes,
                   dense_bytes=st.dense_bytes, ms_per_factorization=fms,
                   ms_per_solve=sms)
        if dtype == "r32":
            tr = profile(lambda _: clu.factorize(),
                         setup=lambda: st.values.copy_(v0))
            tp6 = p6_in_trace(tr["kernels"])
            k1_ms = sum(k["device_ms"] for n, k in tr["kernels"].items()
                        if "lu_wide_kernel" in n)
            row.update(trace=tr, k1_device_ms=k1_ms, p6_device_ms=tp6[
                "device_ms"], k1_share=k1_ms / tr["busy_ms"],
                p6_share=tp6["device_ms"] / tr["busy_ms"])
            print(f"  one factorization traced: wall {tr['wall_ms']:.3f} ms, "
                  f"busy {tr['busy_ms']:.3f} (idle share "
                  f"{tr['idle_share']:.3f}); K1 {k1_ms:.3f} device ms "
                  f"({row['k1_share']:.1%}), P6 {tp6['device_ms']:.3f} "
                  f"({row['p6_share']:.1%}: decompress "
                  f"{tp6['decompress']['launches']}, compress "
                  f"{tp6['compress']['launches']} launches)")
            for name, k in sorted(tr["kernels"].items(),
                                  key=lambda kv: -kv[1]["device_ms"])[:6]:
                print(f"    {name[:90]}: {k['launches']} launches, "
                      f"{k['device_ms']:.3f} device ms")
        if (dtype, ordering) == ("r32", "rcm"):
            launches.update({f"{n}@nb={nb}": got[n] for n in (
                "decompress_tiles", "compress_tiles")})
            launches[f"getrf_with_inverses@nb={nb} compressed"] = got[
                "getrf_with_inverses"]
            st.values.copy_(v0)
            clu.factorize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "wide.npz")
                save_factor(h, path)
                kc.reset_launch_counts()
                h2 = load_factor(path, device=str(dev))
                x2 = gstrs(h2, b)
                row["reload_launches"] = expect(
                    f"the reloaded nb={nb} store",
                    compressed_launches(sch, solves=3, reloads=1))
            row["reload_solve_residual"] = residual_norm(s, x2, b)
            print(f"  save -> load -> gstrs: {row['reload_launches']}, "
                  f"solve residual {row['reload_solve_residual']:.3e} "
                  "(< 1e-10)")
            if not row["reload_solve_residual"] < 1e-10:
                fail(f"the reloaded nb={nb} store's solve residual")
            launches[f"newton_inverses@nb={nb}"] = row["reload_launches"][
                "newton_inverses"]
            del h2
        out[f"compressed_{dtype}_{ordering}"] = row
        del h, st, clu, dense, v0, xb
        torch.cuda.empty_cache()

    # ---- (d) native complex tiles on the compressed store ---------------
    step("d")
    ca = with_imaginary_parts(poisson3d(nx_c))
    for dtype in ("cr32", "cr64"):
        print(f"wide stores (d): complex_mode native, tile_storage "
              f"compressed, poisson3d({nx_c}) with imaginary parts, "
              f"nb={nb_c}, {dtype}, rcm")
        cdt = np.complex64 if dtype == "cr32" else np.complex128
        aw = ca.to_scipy().astype(cdt).astype(np.complex128)
        bc = aw @ np.full(ca.n, 1 + 1j)
        h = init(ca, InitOptions(nb=nb_c, dtype=dtype, ordering="rcm",
                                 tile_storage="compressed",
                                 complex_mode="native", device=str(dev)))
        kc.reset_launch_counts()
        gstrf(h)
        x = gstrs(h, bc)
        solves = 3 if dtype == "cr32" else 1
        sch, st, clu = h.schedule, h.factor_tiles, h._factorizer
        got = expect(f"native {dtype} compressed", compressed_launches(
            sch, factorizations=1, solves=solves, complex_tiles=True))
        fres = factor_residual_device(h, store_dense(st))
        res = residual_norm(aw, x, bc)
        limit = (1e-5, 1e-10) if dtype == "cr32" else (1e-12, 1e-12)
        print(f"  backend {h.perf.kernels['backend']}; launches {got}; "
              f"gstrf residual {fres:.3e} (< {limit[0]:g}), solve residual "
              f"{res:.3e} (< {limit[1]:g})")
        if h.perf.kernels["backend"] != "torch" or not (
                fres < limit[0] and res < limit[1]):
            fail(f"native {dtype} compressed: backend or residuals")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "native.npz")
            save_factor(h, path)
            kc.reset_launch_counts()
            h2 = load_factor(path, device=str(dev))
            x2 = gstrs(h2, bc)
            reload = expect(f"the reloaded native {dtype} store",
                            compressed_launches(sch, solves=solves,
                                                reloads=1,
                                                complex_tiles=True))
        rres = residual_norm(aw, x2, bc)
        print(f"  save -> load -> gstrs (the plain doubling, no P2): "
              f"{reload}, solve residual {rres:.3e}")
        if not rres < limit[1]:
            fail(f"the reloaded native {dtype} store's solve residual")
        # host-bound (the diagonal step is PyTorch's small launches): the
        # one factorization above, its level loop as perf's numeric phase
        # times it (host clock, the device synced at its end)
        fms = h.perf.phase_time["numeric"] * 1e3
        bl = sch.block_length
        xb = torch.zeros((bl + 1, nb_c, 1), dtype=st.values.dtype,
                         device=dev)
        xb[:bl].view(-1)[:ca.n] = torch.as_tensor(
            h.reordering.transform_b(bc.astype(cdt)), device=dev)
        sms = cuda_ms(lambda _: clu.solve_blocked(xb), reps=3)
        print(f"  {fms:.3f} ms per factorization (the one above, host "
              f"clock), {sms:.3f} ms per solve (CUDA events, median of 3)")
        row = dict(bl=bl, launches=got, reload_launches=reload,
                   gstrf_residual=fres, solve_residual=res,
                   reload_solve_residual=rres, ms_per_factorization=fms,
                   ms_per_solve=sms, store_bytes=st.compressed_bytes,
                   dense_bytes=st.dense_bytes)
        if dtype == "cr64":
            m = measure_batch(cs, st, p6_batches(clu)["c"])
            print_batch(f"nb={nb_c} complex128", m)
            row["p6"] = m
            for name, d in (("decompress_tiles", "decompress"),
                            ("compress_tiles", "compress")):
                n = f"{name}@nb={nb_c},complex128"
                entries[n] = p6_entry(m, d)
                launches[n] = got[name]
        out[f"native_{dtype}"] = row
        del h, h2, st, clu, xb
        torch.cuda.empty_cache()

    # ---- (e) 2 x 2 ranks on this card ---------------------------------
    step("e")
    print("wide stores (e): 4 ranks on a 2 x 2 grid, all on this card, "
          "gloo: " + ", ".join(dist_cases))
    t0 = time.perf_counter()
    tmp = run_ranks(dev, dist_cases)
    out["ranks_wall_s"] = time.perf_counter() - t0
    try:
        for spec in dist_cases:
            out[spec.split(":")[0]] = check_ranks(tmp, spec)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"wide stores: {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out, entries, launches


# K1 at 1088 (extras_phase (d)): one launch of the flow kernel
EXTRAS_SPLIT_NB = 1088
# extras_phase (c): the out-of-core demo under an allocator cap below the
# matrix's dense tile store (1.32 GiB at poisson3d(48), the store 0.60),
# the cross budget set outright: the 4 GiB reserve of
# PanelLU._dense_budget_tiles exceeds the cap and would leave its floor
# of 64 tiles.  poisson3d(48) is the smallest size with room below its
# dense store for the store, the inverses and an update chunk's ~0.4 GiB
# (peak 1.17 GiB at a 64 MiB cross on an H100; 1.09 GiB allocated when a
# 128 MiB cross ran out under a 1.25 GiB cap)
DEMO_NX = 48
DEMO_GIB = 1.3
DEMO_CROSS_GB = "0.0625"


def extras_phase(dev, nx: int = 32, nb: int = 128, demo_nx: int = DEMO_NX,
                 demo_gib: float = DEMO_GIB, demo_cross_gb=DEMO_CROSS_GB,
                 split_nb: int = EXTRAS_SPLIT_NB) -> dict:
    """The last public pieces of the JAX package, on the card:

      (a) profile_dir: gstrf of poisson3d(nx) at nb, nd, r32 without
          and with a torch.profiler trace (plain, traced, traced,
          plain; host clock to a synchronise, ms each), the launch
          counts exact (K1 = number of groups, K4 = 1) in each traced
          run, exactly one Chrome trace file a traced gstrf that parses
          as JSON and holds getrf_inv_kernel and group_schur_kernel
          events (their presence only: the profiler loses kernels of
          some traces), the factors the untraced run's bits;
      (b) the examples (pangulu_tpu_torch/examples) through their
          main(["--device", "cuda"]) at their own sizes, each with its
          asserts and the exact launch counts of its engine (the chain
          or group engine, or CompressedLU for the circuit, whose
          residual must be below 1e-8);
      (c) the out-of-core demo (pangulu_tpu_torch/tools/
          demo_outofcore.py) as a subprocess on poisson3d(demo_nx) under
          --device-gib demo_gib, below its dense store, with
          PANGULU_OOC_CROSS_GB=demo_cross_gb: exit 0, more than one
          panel, peak max_memory_allocated below the cap and the dense
          store's bytes, residual < 1e-4;
      (d) K1 at split_nb (the flow kernel up to W_T), one tile in
          float32 and float64, against kernels_torch.k1_wide at TOL_F32 /
          TOL_F64, one K1 launch of one device launch;
          its device ms per launch (median of 5 runs of 10 back-to-back
          launches) beside its bound, the twin's ms and
          torch.linalg.lu_factor_ex(pivot=False)'s.

    Returns its numbers; any failure raises."""
    import os
    import tempfile

    from pangulu_tpu_torch import InitOptions, gstrf, init
    from pangulu_tpu_torch.examples import (run_circuit_compressed,
                                            run_poisson3d, run_r64,
                                            run_refactorize, run_trefethen)
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import compressed_launches

    out = {}
    t_phase = time.perf_counter()

    def zero_but(**counts):
        return {k: counts.get(k, 0) for k in kc.LAUNCHES}

    def expect(what, want):
        got = dict(kc.LAUNCHES)
        if got != want:
            fail(f"{what}: launch counts {got}, expected {want}")

    # ---- (a) profile_dir -------------------------------------------------
    print(f"extras (a): gstrf with profile_dir, poisson3d({nx}) nb={nb} nd "
          "r32 (plain, traced, traced, plain)")
    h = init(poisson3d(nx), InitOptions(nb=nb, dtype="r32", ordering="nd",
                                        device=dev.type))
    runs = {"plain": [], "traced": []}
    with tempfile.TemporaryDirectory() as tmp:
        # the first gstrf builds the engine's tables: untimed
        for turn, kind in enumerate(("warm-up", "plain", "traced", "traced",
                                     "plain")):
            pdir = os.path.join(tmp, f"t{turn}")
            h.opts.profile_dir = pdir if kind == "traced" else None
            kc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gstrf(h)
            torch.cuda.synchronize()
            if kind != "warm-up":
                runs[kind].append((time.perf_counter() - t0) * 1e3)
            ng = h._factorizer.tables.host["ngroups"]
            expect(f"(a) {kind} gstrf", zero_but(
                getrf_with_inverses=ng, mega_factorize_groups=1))
            if turn == 0:
                ref = h.factor_tiles.clone()
            elif not torch.equal(h.factor_tiles, ref):
                fail(f"(a) the {kind} gstrf changed the factor bits")
            if kind != "traced":
                continue
            files = sorted(pathlib.Path(pdir).glob("*.pt.trace.json"))
            if len(files) != 1:
                fail(f"(a) {len(files)} trace files in {pdir}, expected 1")
            events = json.loads(files[0].read_text())["traceEvents"]
            names = [e.get("name", "") for e in events
                     if e.get("cat") == "kernel"]
            seen = {k: sum(k in n for n in names)
                    for k in ("getrf_inv_kernel", "group_schur_kernel")}
            print(f"  trace {files[0].name}: {files[0].stat().st_size} "
                  f"bytes, {len(names)} kernel events, {seen}")
            if not all(seen.values()):
                fail(f"(a) the trace lacks a kernel: {seen}")
            out.setdefault("trace_kernel_events", []).append(seen)
    h.opts.profile_dir = None
    out["gstrf_ms"] = runs
    print(f"  gstrf host ms (to a synchronise): plain {runs['plain']}, "
          f"traced {runs['traced']}")
    del h, ref
    torch.cuda.empty_cache()

    # ---- (b) the examples ------------------------------------------------
    def engine_counts(h, gstrfs, solves):
        eng = h.perf.kernels["engine"]
        if eng == "mega":
            return zero_but(
                getrf_with_inverses=gstrfs * h.schedule.block_length,
                mega_factorize=gstrfs, mega_solve=solves)
        if eng == "mega_group":
            return zero_but(
                getrf_with_inverses=(gstrfs
                                     * h._factorizer.tables.host["ngroups"]),
                mega_factorize_groups=gstrfs, mega_solve_groups=solves)
        fail(f"(b) unexpected engine {eng}")

    out["examples"] = {}
    for mod, gstrfs, solves in ((run_trefethen, 1, 1),
                                (run_refactorize, run_refactorize.STEPS,
                                 run_refactorize.STEPS),
                                (run_circuit_compressed, 1, 1),
                                # r64: no refinement round; r32: 2
                                (run_r64, 1, 1), (run_poisson3d, 1, 3)):
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"extras (b): {name}.main(['--device', '{dev.type}'])")
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        got = mod.main(["--device", dev.type])
        wall = time.perf_counter() - t0
        h = got["handle"]
        if mod is run_circuit_compressed:
            want = zero_but(**compressed_launches(h.schedule, gstrfs, solves))
            if not got["residual"] < 1e-8:
                fail(f"(b) {name}: residual {got['residual']:.3e}")
        else:
            want = engine_counts(h, gstrfs, solves)
        expect(f"(b) {name}", want)
        res = got["residual"]
        out["examples"][name] = dict(
            engine=h.perf.kernels.get("engine"), wall_s=wall,
            residual=max(res) if isinstance(res, list) else res,
            launches={k: v for k, v in want.items() if v})
        print(f"  engine {out['examples'][name]['engine']}, residual "
              f"{out['examples'][name]['residual']:.3e}, launches "
              f"{out['examples'][name]['launches']}, {wall:.1f} s")
    torch.cuda.empty_cache()

    # ---- (c) the out-of-core demo under a cap ----------------------------
    print(f"extras (c): the out-of-core demo, poisson3d({demo_nx}), "
          f"--device-gib {demo_gib}, PANGULU_OOC_CROSS_GB={demo_cross_gb}")
    cmd = [sys.executable, str(ROOT / "pangulu_tpu_torch" / "tools" /
                               "demo_outofcore.py"),
           "--nx", str(demo_nx), "--device-gib", str(demo_gib)]
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PANGULU_OOC_CROSS_GB=demo_cross_gb)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    wall = time.perf_counter() - t0
    print("\n".join("  " + ln for ln in res.stdout.splitlines()[:-1]))
    if res.returncode != 0:
        fail(f"(c) the demo exited {res.returncode}:\n{res.stdout[-3000:]}"
             f"\n{res.stderr[-3000:]}")
    demo = json.loads(res.stdout.splitlines()[-1])["demo_outofcore"]
    demo["wall_s"] = wall
    cap = demo_gib * 2 ** 30
    peak = demo["peak_allocated_bytes"]
    print(f"  exit 0 in {wall:.1f} s: {demo['panels']} panels, peak "
          f"{peak / 2 ** 30:.3f} GiB against the {demo_gib} GiB cap and the "
          f"{demo['dense_bytes'] / 2 ** 30:.3f} GiB dense store, residual "
          f"{demo['residual']:.3e}")
    if not (demo["panels"] > 1 and peak < cap and peak < demo["dense_bytes"]
            and demo["dense_bytes"] > cap and demo["residual"] < 1e-4):
        fail(f"(c) the demo missed its checks: {demo}")
    out["demo"] = demo

    # ---- (d) K1 above 1024 ----------------------------------------------
    print(f"extras (d): K1 at nb={split_nb} (the flow kernel) against its "
          "plain twin kernels_torch.k1_wide")
    rng = np.random.default_rng(21)
    out["K1"] = {}
    for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        a = torch.as_tensor(rng.standard_normal((1, split_nb, split_nb))
                            + split_nb * np.eye(split_nb), dtype=dt,
                            device=dev)
        kc.reset_launch_counts()
        got = kc.getrf_with_inverses(a)
        torch.cuda.synchronize()
        dl = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        expect(f"(d) K1 nb={split_nb} {dt}",
               zero_but(getrf_with_inverses=1))
        if dl != 1:
            fail(f"(d) K1 nb={split_nb} {dt}: {dl} device launches, "
                 "expected the flow kernel's one")
        err = max(compare(f"{dt} nb={split_nb} {n} (twin)", g, r, *tol)
                  for n, g, r in zip(("f", "linv", "uinv"), got,
                                     kt.k1_wide(a)))
        ms = device_ms(lambda: kc.getrf_with_inverses(a), n=10, reps=5)
        lms = device_ms(lambda: torch.linalg.lu_factor_ex(a, pivot=False),
                        n=10, reps=5)
        row = dict(max_abs_err=err, device_launches=dl, ms=ms,
                   plain_ms=cuda_ms(lambda _: kt.k1_wide(a), reps=3),
                   library_ms=lms, **k1_bound(split_nb, 1, dt))
        print(f"  {dt}: one K1 launch, {dl} device launches; kernel "
              f"{ms:.4f} ms, bound {row['bound_ms']:.3e} ms "
              f"({row['bound_by']}), twin {row['plain_ms']:.3f} ms, "
              f"lu_factor_ex {lms:.4f} ms")
        out["K1"][str(dt)] = row
    out["seconds"] = time.perf_counter() - t_phase
    print(f"extras: {out['seconds']:.1f} s")
    return out


# the superfused phase's tile widths on poisson3d(32) nd r32: one K1
# launch a super-level (25, 15 and 10 of them)
SUPERFUSED_NBS = (128, 256, 512)


def superfused_phase(dev, nx: int = 32, nbs=SUPERFUSED_NBS,
                     nb_r64: int = 256, nx_c: int = 24, nb_c: int = 128,
                     nb_rcm: int = 128) -> tuple:
    """The superfused and segmented engines (numeric.py, dispatch=
    "superfused" / "segmented"; the JAX package's super-level fused and
    segmented engines) on the card:

      (a) poisson3d(nx), r32, nd, at each nb of nbs (backend cuda): on
          one store LUFactorizer(dispatch="superfused"), with the counts
          zeroed before and read after: exactly one K1 launch (one
          device launch) a super-level and no other kernel; its factor
          within 1e-5 of the fused engine's on the same store, relative
          to the largest entry (TOL_GROUP_F32's 2e-4 is not needed); two
          factorizations the same bits; the gstrf residual on the card <
          1e-5, and through gstrs (the solve auto picks, recorded) after
          the default refinement < 1e-10 and its ms per unrefined solve
          (CUDA events, median of 5); ms per factorization (CUDA events,
          median of 5) beside the fused engine's and, at nb <= 256,
          mega_group's (K4); at the largest nb one traced factorization
          of each of superfused and fused (K1's device ms and share, busy
          against wall);
      (b) the same at r64 and nb_r64 (K7's cluster kernel on batches up
          to the widest super-level), residuals < 1e-12, the factor
          within 1e-12 of fused's;
      (c) complex_mode "native", cr32, poisson3d(nx_c) with imaginary
          parts, nb_c, nd (backend torch, no hand kernel): residual <
          1e-10 (A in the working precision), the factor within 1e-5 of
          fused's, ms per factorization beside fused's (one run each:
          fused takes seconds);
      (d) rcm at nb_rcm, r32: one member a super-level, so exactly
          block_length K1 launches, and the fused engine's bits;
      (e) dispatch "segmented" on (a)'s store at nbs[0]: taken as the
          fused engine (unpadded, the JAX package's segments run its
          steps), exactly block_length K1 launches and its bits;
      (f) K1 per launch on the widest super-level's batch of (a) and (b)
          as the path gives it (its inputs taken in a factorization):
          against its plain twin (kernels_torch.k1_wide) at TOL_F32 /
          TOL_F64, device ms (back-to-back, median of 7) beside its
          bound (k1_bound), the twin's ms and
          torch.linalg.lu_factor_ex(pivot=False)'s on the same batch.

    Returns (its numbers, per nb of nbs the K1 launches of (a)).  Any
    failure raises."""
    from pangulu_tpu_torch import InitOptions, gstrs, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import interface
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import with_imaginary_parts
    from pangulu_tpu_torch.utils.perf import residual_norm

    t0 = time.perf_counter()
    out, launches = {}, {}
    a = poisson3d(nx)
    s = a.to_scipy()
    b = s @ np.ones(a.n)

    def k1_only(what, calls):
        got = (kc.LAUNCHES["getrf_with_inverses"],
               kc.DEVICE_LAUNCHES["getrf_with_inverses"])
        if got != (calls, calls) or any(
                v for k, v in kc.LAUNCHES.items()
                if k != "getrf_with_inverses"):
            fail(f"{what}: launches {dict(kc.LAUNCHES)}, K1 device "
                 f"launches {got[1]}; expected K1 {calls} (one device "
                 "launch each) and no other kernel")

    def factor_ms(fac, h, reps=5):
        return cuda_ms(lambda t: fac.factorize(t, sync=False),
                       setup=lambda: h.blocked.device_tiles(dev),
                       reps=reps, warmup=1 if reps > 1 else 0)

    def k1_batch(h, label):
        """(f): the widest super-level's K1 batch as the path gives it."""
        widest = max(len(m) for m in h.schedule.superlevels())
        cuda = interface.get_backend("cuda")
        seen = []

        def grab(x, tol):
            if x.dim() == 3 and x.shape[0] == widest and not seen:
                seen.append(x.clone())
            return cuda.diag_factor_invert(x, tol)

        LUFactorizer(h.blocked, h.schedule, device=dev,
                     dispatch="superfused",
                     backend=dataclasses.replace(
                         cuda, diag_factor_invert=grab)).factorize()
        x = seen[0]
        dt, nb = x.dtype, x.shape[-1]
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        err = 0.0
        for n, g, r in zip(("f", "linv", "uinv"),
                           kc.getrf_with_inverses(x), kt.k1_wide(x)):
            err = max(err, compare(f"{label} K1 batch {widest} {n} (twin)",
                                   g, r, *tol))
        ms = device_ms(lambda: kc.getrf_with_inverses(x), n=20, reps=7)
        lms = device_ms(lambda: torch.linalg.lu_factor_ex(x, pivot=False),
                        n=20, reps=7)
        pms = cuda_ms(lambda _: kt.k1_wide(x), reps=3)
        r = dict(batch=widest, max_abs_err=err, ms=ms, ms_per_tile=ms /
                 widest, plain_ms=pms, library_ms=lms,
                 **k1_bound(nb, widest, dt))
        print(f"  (f) K1 on the widest super-level's {widest} tiles, nb={nb}"
              f" {dt}: {ms:.4f} ms a launch ({ms / widest:.4f} a tile), "
              f"bound {r['bound_ms']:.3e} ms ({r['bound_by']}), twin "
              f"{pms:.3f} ms, lu_factor_ex {lms:.4f} ms")
        return r

    def grouped(nb, dtype, ordering, limits, label, mega=True):
        print(f"superfused {label}: poisson3d({nx}) nb={nb} {dtype} "
              f"{ordering}, {dev}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ti = time.perf_counter()
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device=str(dev)))
        init_s = time.perf_counter() - ti
        sizes = [len(m) for m in h.schedule.superlevels()]
        bl, nt = h.schedule.block_length, h.blocked.num_tiles
        kc.reset_launch_counts()
        sf = LUFactorizer(h.blocked, h.schedule, device=dev,
                          dispatch="superfused", backend="cuda")
        tiles = sf.factorize()
        k1_only(f"{label} superfused", len(sizes))
        launched = dict(kc.LAUNCHES)
        fu = LUFactorizer(h.blocked, h.schedule, device=dev,
                          dispatch="fused", backend="cuda")
        ref = fu.factorize()
        dif = rel_err(tiles[:nt], ref[:nt].double())
        same = torch.equal(sf.factorize(), tiles)
        fres = factor_residual_device(h, tiles)
        h._factorizer, h.factor_tiles, h._trisolver = sf, tiles, None
        x = gstrs(h, b)
        res = residual_norm(s, x, b)
        ts = h._trisolver
        solve, xb = ts.dispatch, ts.blockify_rhs(h.reordering.transform_b(b))
        num = dict(n=a.n, bl=bl, tiles=nt, superlevels=len(sizes),
                   widest=max(sizes), init_s=init_s, launches=launched,
                   against_fused=dif, same_bits=same, gstrf_residual=fres,
                   residual=res, solve_engine=solve,
                   ms_per_solve=cuda_ms(lambda _: ts.solve_blocked(tiles, xb),
                                        reps=5))
        print(f"  {bl} levels -> {len(sizes)} super-levels (widest "
              f"{max(sizes)}), {nt} tiles, init {init_s:.1f} s; K1 "
              f"launches {launched['getrf_with_inverses']}; against fused "
              f"{dif:.3e} (< {limits[0]:g}); two runs the same bits: "
              f"{same}; gstrf residual {fres:.3e} (< {limits[1]:g}); "
              f"solve ({solve}) residual {res:.3e} (< {limits[2]:g}), "
              f"{num['ms_per_solve']:.3f} ms per solve (unrefined, CUDA "
              "events, median of 5)")
        if not (dif < limits[0] and same and fres < limits[1]
                and res < limits[2]):
            fail(f"superfused {label}: agreement, bits or residual")
        if x.shape != (a.n,) or not np.isfinite(x).all():
            fail(f"superfused {label}: solution not finite")
        num["ms_per_factorization"] = factor_ms(sf, h)
        num["fused_ms"] = factor_ms(fu, h)
        msg = (f"  ms per factorization (CUDA events, median of 5): "
               f"superfused {num['ms_per_factorization']:.3f}, fused "
               f"{num['fused_ms']:.3f}")
        if mega and nb <= kt.MAX_NB:
            mg = LUFactorizer(h.blocked, h.schedule, device=dev,
                              dispatch="mega_group")
            num["mega_group_ms"] = factor_ms(mg, h)
            msg += f", mega_group (K4) {num['mega_group_ms']:.3f}"
        print(msg)
        return h, sf, fu, num

    def traced(num, sf, fu, h):
        for name, fac in (("superfused", sf), ("fused", fu)):
            tr = profile(lambda t: fac.factorize(t, sync=False),
                         setup=lambda: h.blocked.device_tiles(dev))
            k1 = {n: k for n, k in tr["kernels"].items()
                  if any(x in n for x in ("lu_cluster_kernel",
                                          "getrf_inv_kernel",
                                          "lu_wide_kernel",
                                          "lu_flow_kernel"))}
            k1_ms = sum(k["device_ms"] for k in k1.values())
            num[f"{name}_trace"] = dict(
                wall_ms=tr["wall_ms"], busy_ms=tr["busy_ms"],
                idle_share=tr["idle_share"], k1_device_ms=k1_ms,
                k1_share=k1_ms / tr["busy_ms"],
                k1_events=sum(k["launches"] for k in k1.values()),
                top={n[:80]: k for n, k in sorted(
                    tr["kernels"].items(),
                    key=lambda kv: -kv[1]["device_ms"])[:6]})
            print(f"  {name} traced: wall {tr['wall_ms']:.3f} ms, busy "
                  f"{tr['busy_ms']:.3f} ms (idle share "
                  f"{tr['idle_share']:.3f}); K1 {k1_ms:.3f} device ms "
                  f"({k1_ms / tr['busy_ms']:.1%} of busy, "
                  f"{num[f'{name}_trace']['k1_events']} events)")

    # ---- (a), (f) r32 nd at each nb ------------------------------------
    for nb in nbs:
        h, sf, fu, num = grouped(nb, "r32", "nd", (1e-5, 1e-5, 1e-10),
                                 f"(a) nb={nb}")
        launches[nb] = num["launches"]["getrf_with_inverses"]
        if nb == max(nbs):
            traced(num, sf, fu, h)
        num["k1_widest"] = k1_batch(h, f"nb={nb}")
        if nb == nbs[0]:
            # ---- (e) segmented on the same store --------------------------
            kc.reset_launch_counts()
            seg = LUFactorizer(h.blocked, h.schedule, device=dev,
                               dispatch="segmented", backend="cuda")
            st = seg.factorize()
            k1_only("(e) segmented", h.schedule.block_length)
            same = torch.equal(st, fu.factorize())
            num["segmented"] = dict(engine=seg.dispatch, fused_bits=same,
                                    ms_per_factorization=factor_ms(seg, h))
            print(f"  (e) segmented: engine {seg.dispatch}, "
                  f"{h.schedule.block_length} K1 launches, the fused bits: "
                  f"{same}; {num['segmented']['ms_per_factorization']:.3f} "
                  "ms per factorization")
            if not same or seg.dispatch != "fused":
                fail("segmented: not the fused engine or not its bits")
        out[f"r32_nd_nb{nb}"] = num
        del h, sf, fu

    # ---- (b) r64 ----------------------------------------------------------
    h, sf, fu, num = grouped(nb_r64, "r64", "nd", (1e-12, 1e-12, 1e-12),
                             f"(b) nb={nb_r64} r64")
    num["k1_widest"] = k1_batch(h, f"nb={nb_r64} r64")
    out[f"r64_nd_nb{nb_r64}"] = num
    del h, sf, fu

    # ---- (d) rcm: one member a super-level ------------------------------
    print(f"superfused (d): poisson3d({nx}) nb={nb_rcm} r32 rcm")
    torch.cuda.empty_cache()
    h = init(a, InitOptions(nb=nb_rcm, dtype="r32", ordering="rcm",
                            device=str(dev)))
    bl = h.schedule.block_length
    kc.reset_launch_counts()
    sf = LUFactorizer(h.blocked, h.schedule, device=dev,
                      dispatch="superfused", backend="cuda")
    tiles = sf.factorize()
    k1_only("(d) rcm superfused", bl)
    fu = LUFactorizer(h.blocked, h.schedule, device=dev, dispatch="fused",
                      backend="cuda")
    same = torch.equal(tiles, fu.factorize())
    out["r32_rcm"] = dict(bl=bl, superlevels=len(sf.supers.diag_ids),
                          fused_bits=same,
                          ms_per_factorization=factor_ms(sf, h),
                          fused_ms=factor_ms(fu, h))
    print(f"  {bl} levels, {len(sf.supers.diag_ids)} super-levels, {bl} K1 "
          f"launches; the fused bits: {same}; superfused "
          f"{out['r32_rcm']['ms_per_factorization']:.3f} ms, fused "
          f"{out['r32_rcm']['fused_ms']:.3f} ms per factorization")
    if not same or len(sf.supers.diag_ids) != bl:
        fail("rcm superfused: not one member a super-level, or not the "
             "fused bits")
    del h, sf, fu, tiles

    # ---- (c) native complex ---------------------------------------------
    print(f"superfused (c): complex_mode native, poisson3d({nx_c}) with "
          f"imaginary parts, nb={nb_c}, cr32, nd")
    torch.cuda.empty_cache()
    ca = with_imaginary_parts(poisson3d(nx_c))
    aw = ca.to_scipy().astype(np.complex64).astype(np.complex128)
    bc = aw @ np.full(ca.n, 1 + 1j)
    h = init(ca, InitOptions(nb=nb_c, dtype="cr32", ordering="nd",
                             device=str(dev), complex_mode="native"))
    kc.reset_launch_counts()
    sf = LUFactorizer(h.blocked, h.schedule, device=dev,
                      dispatch="superfused")
    tiles = sf.factorize()
    fu = LUFactorizer(h.blocked, h.schedule, device=dev, dispatch="fused")
    nt = h.blocked.num_tiles
    dif = rel_err(torch.view_as_real(tiles[:nt]),
                  torch.view_as_real(fu.factorize()[:nt]).double())
    h._factorizer, h.factor_tiles, h._trisolver = sf, tiles, None
    x = gstrs(h, bc)
    if any(kc.LAUNCHES.values()):
        fail(f"native cr32 superfused launched {dict(kc.LAUNCHES)}")
    res = residual_norm(aw, x, bc)
    sms, fms = factor_ms(sf, h, reps=1), factor_ms(fu, h, reps=1)
    out["native_cr32"] = dict(
        bl=h.schedule.block_length, superlevels=len(sf.supers.diag_ids),
        backend=sf.backend.name, against_fused=dif, residual=res,
        ms_per_factorization=sms, fused_ms=fms)
    print(f"  backend {sf.backend.name}, {h.schedule.block_length} levels -> "
          f"{len(sf.supers.diag_ids)} super-levels; against fused {dif:.3e} "
          f"(< 1e-5); residual {res:.3e} (< 1e-10); superfused {sms:.3f} "
          f"ms, fused {fms:.3f} ms (one run each)")
    if not (sf.backend.name == "torch" and dif < 1e-5 and res < 1e-10):
        fail("native cr32 superfused: backend, agreement or residual")
    del h, sf, fu, tiles
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"superfused phase: {out['seconds']:.1f} s")
    return out, launches


# the chain-ahead phase's cases: (label, generator, its size, ordering,
# nb), r32; the first is the one traced and held against the plain
# version, with the nb=256 one
CHAIN_AHEAD_CASES = (
    ("p3d32_nd_nb128", "poisson3d", 32, "nd", 128),
    ("p3d32_nd_nb256", "poisson3d", 32, "nd", 256),
    ("sw90_nd_nb128", "smallworld", 90, "nd", 128),
    ("circuit20000_nd_nb128", "circuit", 20000, "nd", 128),
    ("p3d32_rcm_nb128", "poisson3d", 32, "rcm", 128),
)
K1_KERNELS = ("getrf_inv_kernel", "lu_cluster_kernel")
K2_PRODUCTS = ("panel_kernel", "schur_kernel")


def chain_ahead_phase(dev, cases=CHAIN_AHEAD_CASES,
                      traced_cases=("p3d32_nd_nb128", "p3d32_nd_nb256"),
                      panel_nx: int = 32, panel_nb: int = 128,
                      reps: int = 7) -> tuple:
    """K2's chain-ahead (PANGULU_TPU_SUPERLEVEL=1: the levels in
    dependency-depth order, each same-depth level's diagonal step run
    on a second stream beside the level before it; csrc/lu_kernels.cu
    mega_levels) on the card:

      (a) per case of cases, r32, on one store: LUFactorizer(dispatch=
          "mega") with the switch unset (the level order, the schedule's
          own tables) and set (chain-ahead tables where the schedule has
          levels of equal depth; at rcm none: then the tables must be
          the unset ones), and mega_group (K4).  The switched one with
          the counts zeroed before and read after: exactly K1 = bl (one
          device launch each), K2 = 1 and no other kernel, the diagonal
          steps run ahead (kernels_cuda.AHEAD) = the flagged levels; the
          same tables with the second stream off (ahead=False) the same
          bits in factors and inverses; the factor within 2e-4 of the
          level order's (max |diff| / max |level order|); on poisson3d
          the gstrf residual on the card < 1e-5 and gstrs through the
          handle on the chain-ahead factor and its inverses < 1e-10
          after the default refinement, elsewhere both within 2x the
          level order factor's (smallworld(90)'s solve stalls at
          ~1.2e-8 whatever the engine; the circuit's cond is ~1e16, its
          r32 gstrf residual ~4e-4); ms
          per factorization (CUDA events, median of reps) of the level
          order, chain-ahead, its tables on one stream, and mega_group;
      (b) on the first of traced_cases, K2 on the chain-ahead tables
          against its plain version on the same tables (kernels_torch.
          mega_factorize) at TOL_F32, the plain version's ms (that one
          run, CUDA events): the kernels line's chain-ahead entry of
          K2;
      (c) the panel driver (tile_storage="compressed", PanelLU) on
          poisson3d(panel_nx) nd at panel_nb with the switch set: chain-ahead
          tables in its pass, exact launches (testing.panel_launches),
          the steps run ahead, gstrf residual < 1e-5, solve residual <
          1e-10, the store within 2e-4 of the switch-unset run's, ms per
          factorization of both (the store refilled before each);
      (d) one traced chain-ahead factorization of each of traced_cases:
          per
          kernel launches and device ms, busy (the union of the kernel
          intervals over both streams), idle share, K1's share (the union
          of its intervals), the K1 intervals that overlap a panel or
          Schur kernel's (on one
          stream none can), the time overlapped, and the streams K1 and
          the products ran on; the first must show overlap.

    Returns (its numbers, K2's chain-ahead entry).  Any failure raises."""
    import os

    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch import models
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.outofcore import PanelLU
    from pangulu_tpu_torch.testing import panel_launches
    from pangulu_tpu_torch.utils.perf import residual_norm

    t_phase = time.perf_counter()
    env = "PANGULU_TPU_SUPERLEVEL"
    old = os.environ.pop(env, None)
    out, entry = {}, None

    def zero_but(**counts):
        return {k: counts.get(k, 0) for k in kc.LAUNCHES}

    def traced(label, fac, h):
        """(d): one chain-ahead factorization traced, events kept; taken
        again (up to 3 more times) while it shows no K1 or no product
        kernel."""
        fac.factorize(h.blocked.device_tiles(dev))
        for n in range(1, 5):
            evs = []
            tiles = h.blocked.device_tiles(dev)
            torch.cuda.synchronize()
            wall, spans, kernels = trace_once(
                lambda t: fac.factorize(t, sync=False), tiles, events=evs)
            k1 = [e for e in evs if any(k in e[2] for k in K1_KERNELS)]
            prods = sorted((e[0], e[1]) for e in evs
                           if any(k in e[2] for k in K2_PRODUCTS))
            if k1 and prods:
                break
            print(f"  (the profiler recorded {len(k1)} K1 and {len(prods)} "
                  "product kernels; tracing again)")
            RETRACED[f"chain-ahead {label}"] = n + 1
        over_n, over_us = 0, 0.0
        for lo, hi, _, _ in k1:
            o = union_us([(max(lo, a), min(hi, b)) for a, b in prods
                          if a < hi and b > lo])
            over_n += o > 0
            over_us += o
        busy = union_us(spans)
        # K1 on the main stream may run beside K1 on the second one: its
        # share of busy is the union of its intervals
        k1_us = union_us([(e[0], e[1]) for e in k1])
        r = dict(wall_ms=wall, busy_ms=busy * 1e-3,
                 idle_share=1.0 - busy * 1e-3 / wall,
                 k1_events=len(k1), k1_expected=h.schedule.block_length,
                 k1_device_ms=k1_us * 1e-3,
                 k1_kernel_ms=sum(e[1] - e[0] for e in k1) * 1e-3,
                 k1_share=k1_us / busy, k1_overlapping=over_n,
                 k1_overlapped_ms=over_us * 1e-3,
                 k1_streams=sorted({str(e[3]) for e in k1}),
                 product_streams=sorted({str(e[3]) for e in evs if any(
                     k in e[2] for k in K2_PRODUCTS)}),
                 kernels={n[:80]: k for n, k in kernels.items()})
        print(f"  (d) traced: wall {wall:.3f} ms, busy {r['busy_ms']:.3f} "
              f"ms (union over streams; idle share {r['idle_share']:.3f}); "
              f"K1 {r['k1_device_ms']:.3f} device ms as a union "
              f"({r['k1_share']:.1%} of busy; its kernels' sum "
              f"{r['k1_kernel_ms']:.3f}), {over_n} of {len(k1)} K1 events "
              f"(of {h.schedule.block_length} launched) overlap a "
              f"panel or Schur kernel ({r['k1_overlapped_ms']:.3f} ms "
              f"overlapped); K1 on streams {r['k1_streams']}, products on "
              f"{r['product_streams']}")
        return r

    try:
        for label, gen, size, ordering, nb in cases:
            print(f"chain-ahead (a) {label}: {gen}({size}) nb={nb} r32 "
                  f"{ordering}, {dev}")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            a = getattr(models, gen)(size)
            s = a.to_scipy()
            b = s @ np.ones(a.n)
            ti = time.perf_counter()
            h = init(a, InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                    device=str(dev)))
            init_s = time.perf_counter() - ti
            bl, nt = h.schedule.block_length, h.blocked.num_tiles
            depth = h.schedule.block_depths()
            off = LUFactorizer(h.blocked, h.schedule, device=dev,
                               dispatch="mega")
            os.environ[env] = "1"
            on = LUFactorizer(h.blocked, h.schedule, device=dev,
                              dispatch="mega")
            del os.environ[env]
            grp = LUFactorizer(h.blocked, h.schedule, device=dev,
                               dispatch="mega_group")
            if "flag_tab" in off.tables.host:
                fail(f"{label}: the switch unset took chain-ahead tables")
            flagged = int(on.tables.host.get("flag_tab", np.zeros(1)).sum())
            num = dict(n=a.n, bl=bl, tiles=nt, depths=int(depth.max()) + 1,
                       flagged=flagged, init_s=init_s,
                       groups=int(grp.tables.host["ngroups"]))
            print(f"  {bl} levels, {num['depths']} depths, {flagged} "
                  f"diagonal steps run ahead, {num['groups']} groups; "
                  f"{nt} tiles; init {init_s:.1f} s")
            if ordering == "rcm":
                if "flag_tab" in on.tables.host or any(
                        not np.array_equal(on.tables.host[k],
                                           off.tables.host[k])
                        for k in off.tables.host):
                    fail(f"{label}: a chain schedule's tables changed")
            elif flagged == 0:
                fail(f"{label}: no level runs ahead")
            kc.reset_launch_counts()
            tiles = on.factorize()
            launched = dict(kc.LAUNCHES)
            ahead_n = kc.AHEAD["mega_factorize"]
            dl = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
            print(f"  launches {launched}, K1 device launches {dl}, run "
                  f"ahead {ahead_n}")
            if (launched != zero_but(getrf_with_inverses=bl,
                                     mega_factorize=1)
                    or dl != bl or ahead_n != flagged):
                fail(f"{label}: launches {launched}, device {dl}, ahead "
                     f"{ahead_n}; expected K1 = {bl} (one device launch "
                     f"each), K2 = 1, {flagged} run ahead")
            num.update(launches=launched, ahead_launches=ahead_n)
            t0 = h.blocked.device_tiles(dev)
            kw = dict(nb=nb, tol=kt.DEFAULT_TOL[t0.dtype], bl=bl)
            t1, i1 = kc.mega_factorize(t0.clone(), on.tables, ahead=False,
                                       **kw)
            same = (torch.equal(t1, tiles)
                    and torch.equal(i1, on.inv_tiles))
            ref = off.factorize(h.blocked.device_tiles(dev))
            dif = rel_err(tiles[:nt], ref[:nt].double())
            fres = factor_residual_device(h, tiles)
            fres_ref = factor_residual_device(h, ref)
            res = {}
            for name, fac, t in (("level_order", off, ref),
                                 ("chain_ahead", on, tiles)):
                h._factorizer, h.factor_tiles, h._trisolver = fac, t, None
                x = gstrs(h, b)
                res[name] = residual_norm(s, x, b)
            # poisson3d: the repo's limits; the others miss them whatever
            # the engine (smallworld(90)'s solve stalls at 1.2e-8, the
            # circuit's cond is ~1e16): within 2x the level order's
            p3d = gen == "poisson3d"
            flim = 1e-5 if p3d else 2 * fres_ref
            limit = 1e-10 if p3d else 2 * res["level_order"]
            num.update(same_bits_one_stream=same, against_level_order=dif,
                       gstrf_residual=fres,
                       level_order_gstrf_residual=fres_ref,
                       residual=res["chain_ahead"],
                       level_order_residual=res["level_order"])
            print(f"  second stream off, the same bits: {same}; against "
                  f"the level order {dif:.3e} (< 2e-4); gstrf residual "
                  f"{fres:.3e} (< {flim:.3e}; the level order's "
                  f"{fres_ref:.3e}); solve residual "
                  f"{res['chain_ahead']:.3e} (< {limit:.3e}; the level "
                  f"order's {res['level_order']:.3e})")
            if not (same and dif < 2e-4 and fres < flim):
                fail(f"{label}: bits, agreement or gstrf residual")
            if not res["chain_ahead"] < limit:
                fail(f"{label}: solve residual too large")
            if x.shape != (a.n,) or not np.isfinite(x).all():
                fail(f"{label}: solution not finite")
            if label == traced_cases[0]:
                # (b) against the plain version on the same tables, that
                # run timed
                plain = []
                pms = cuda_ms(lambda t: plain.append(
                    kt.mega_factorize(t, on.tables, **kw)),
                              setup=t0.clone, reps=1, warmup=0)
                tp, ip = plain[0]
                err = max(compare(f"{label} chain-ahead K2 tiles",
                                  tiles[:nt], tp[:nt], *TOL_F32),
                          compare(f"{label} chain-ahead K2 invs",
                                  on.inv_tiles, ip, *TOL_F32))
                del tp, ip, plain
                num["plain"] = dict(max_abs_err=err, plain_ms=pms)
            del t1, i1, ref, t0
            tiles_of = lambda: h.blocked.device_tiles(dev)  # noqa: E731
            ms = {}
            for name, fn in (
                    ("level_order", lambda t: off.factorize(t, sync=False)),
                    ("chain_ahead", lambda t: on.factorize(t, sync=False)),
                    ("chain_ahead_one_stream",
                     lambda t: kc.mega_factorize(t, on.tables, ahead=False,
                                                 **kw)),
                    ("mega_group", lambda t: grp.factorize(t, sync=False))):
                ms[name] = cuda_ms(fn, setup=tiles_of, reps=reps)
            num["ms_per_factorization"] = ms
            print("  ms per factorization (CUDA events, median of "
                  f"{reps}): " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in ms.items()))
            if label in traced_cases:
                num["traced"] = traced(label, on, h)
            if "plain" in num:
                if num["traced"]["k1_overlapping"] == 0:
                    fail(f"{label}: no K1 interval on the second stream "
                         "overlaps a product kernel")
                entry = dict(
                    variant="chain-ahead (PANGULU_TPU_SUPERLEVEL=1)",
                    replaces="pangulu_tpu/ops/kernels_pallas.py:1213",
                    source=SRC + " mega_levels",
                    tables="Schedule.mega_tables(superlevel=True)",
                    case=label, max_abs_err=num["plain"]["max_abs_err"],
                    ms=ms["chain_ahead"], plain_ms=num["plain"]["plain_ms"],
                    launches=launched["mega_factorize"],
                    ahead_launches=ahead_n, library_ms=None,
                    **bound(2 * (nt + bl) * nb * nb * 4,
                            h.schedule.flop_estimate(), torch.float32,
                            TC_FLOP_S))
            out[label] = num
            del h, on, off, grp, tiles, x

        # ---- (c) the panel driver --------------------------------------
        print(f"chain-ahead (c): the panel driver, poisson3d({panel_nx}) "
              f"nd nb={panel_nb} r32 compressed, the switch set and unset")
        torch.cuda.empty_cache()
        a = models.poisson3d(panel_nx)
        s = a.to_scipy()
        b = s @ np.ones(a.n)
        pan = {}
        for turn in ("on", "off"):
            if turn == "on":
                os.environ[env] = "1"
            try:
                h = init(a, InitOptions(nb=panel_nb, dtype="r32",
                                        ordering="nd",
                                        device=str(dev),
                                        tile_storage="compressed",
                                        check=True))
                kc.reset_launch_counts()
                gstrf(h)
                x = gstrs(h, b)
            finally:
                os.environ.pop(env, None)
            plu = h._factorizer
            if not isinstance(plu, PanelLU):
                fail("(c) gstrf did not take the panel driver")
            want = zero_but(**panel_launches(plu, solves=3))
            launched = dict(kc.LAUNCHES)
            flagged = sum(int(plu._pass(*c).tables.host.get(
                "flag_tab", np.zeros(1)).sum()) for c in plu.panel_cols)
            ahead_n = kc.AHEAD["mega_factorize"]
            res = residual_norm(s, x, b)
            fres = h.perf.kernels["gstrf_residual"]
            st = plu.store
            st.refill(h.reordering.reordered)
            v0 = st.values.clone()
            fms = cuda_ms(lambda _: plu.factorize(),
                          setup=lambda: st.values.copy_(v0), reps=reps)
            pan[turn] = dict(panels=len(plu.panel_cols), flagged=flagged,
                             launches=launched, ahead_launches=ahead_n,
                             gstrf_residual=fres, residual=res,
                             ms_per_factorization=fms,
                             dense=torch.as_tensor(st.to_dense()))
            print(f"  switch {turn}: {len(plu.panel_cols)} panels, "
                  f"{flagged} flagged, launches {launched}, run ahead "
                  f"{ahead_n}; gstrf residual {fres:.3e} (< 1e-5), solve "
                  f"residual {res:.3e} (< 1e-10); {fms:.3f} ms per "
                  f"factorization (CUDA events, median of {reps})")
            if (launched != want or ahead_n != (flagged if turn == "on"
                                                else 0)
                    or (turn == "on") != (flagged > 0)
                    or not (fres < 1e-5 and res < 1e-10)):
                fail(f"(c) switch {turn}: launches {launched} (expected "
                     f"{want}), run ahead {ahead_n} of {flagged}, or "
                     "residuals")
            del h, plu, st, v0, x
        nt_p = pan["on"]["dense"].shape[0] - 1
        dif = rel_err(pan["on"]["dense"][:nt_p],
                      pan["off"]["dense"][:nt_p].double())
        for v in pan.values():
            del v["dense"]
        pan["store_against_off"] = dif
        print(f"  store with the switch against without: {dif:.3e} "
              "(< 2e-4)")
        if not dif < 2e-4:
            fail("(c) the panel driver's chain-ahead store disagrees")
        out["panel"] = pan
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"chain-ahead phase: {out['seconds']:.1f} s")
    return out, entry


# K1 on the flow kernel (csrc/wide_lu.cuh lu_flow_kernel) per launch at
# these widths and at W_T; poisson3d(32) at FLOW_PATH_NB through the
# engines that run it (flow_phase)
FLOW_NBS = (640, 768, 1024, 1088)
FLOW_PATH_NB = 1024


def flow_phase(dev, nbs=FLOW_NBS, nb: int = FLOW_PATH_NB) -> tuple:
    """K1 from 512 to W_T on the flow kernel (csrc/wide_lu.cuh
    lu_flow_kernel: one cooperative launch a call, ceil(nb / 32) CTAs of
    32 rows (f32) or twice as many of 16 (f64) a tile, passing the
    panels by ready flags in global memory, where the batch's tiles all
    fit on the card at once; else the recursion on narrower leaves):

      (a) its plan from the C side (plu_flow_plan, plu_flow_max_nb,
          plu_flow_flag_slots) against kernels_cuda's (flow_plan,
          FLOW_MAX_NB, FLOW_FLAGS) at every nb up to W_T, both types,
          and the recursion's leaf width (plu_flow_leaf against
          kernels_torch.k1_leaf_width) at batches 1 to 64;
      (b) K1 through its public wrapper at each nb of nbs and at W_T,
          float32 and float64, batch 1 and 4: one K1 launch of
          kernels_cuda.k1_device_launches device launches (1 where the
          batch fits at once) and no other kernel, against its plain
          twin (kernels_torch.k1_wide) at TOL_F32 / TOL_F64, device ms
          per launch (back-to-back launches, CUDA events, median of 5)
          beside its bound (k1_bound), torch.linalg.lu_factor_ex(pivot=
          False)'s and, at batch 1, the twin's (one run: host-bound);
          and at 512, batch 1, the flow kernel alone (kernels_cuda.
          flow_kernel; on no path there) against its twin and bit for
          bit against the cluster kernel that the path takes at 512,
          beside its ms;
      (c) poisson3d(32) at nb through the fused engine (r32 and r64,
          rcm) and superfused (r32, nd), each by pangulu_tpu_torch/
          tools/probe_k1_wide.py's paths(): exactly one K1 launch a
          level (fused) or super-level (superfused), of
          kernels_cuda.k1_device_launches device launches for its batch,
          and no other kernel; gstrf residual on the card < 1e-5
          (r64 1e-12); the refined solve's residual < 1e-10 (r64
          1e-12); the factor within TOL_F32 (TOL_F64) of the same engine
          with K1's plain twin, relative to its largest entry; ms per
          factorization (CUDA events, median of 5); one traced
          factorization: K1's device ms and share of busy, busy against
          wall, idle share.

    Returns (its numbers, the kernels-line entry of K1 at nb (float32,
    batch 1), the K1 launches of (c)'s fused r32 rcm path).  Any failure
    raises."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.tools.probe_k1_wide import paths

    t_phase = time.perf_counter()
    out = {"K1": {}}
    rng = np.random.default_rng(24)
    lib = kc.library().lib
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ---- (a) the plan ---------------------------------------------------
    print("flow (a): the flow kernel's plan, C side against kernels_cuda")
    plan = (ctypes.c_int * 4)()
    if lib.plu_flow_flag_slots() != kc.FLOW_FLAGS:
        fail(f"flags: C {lib.plu_flow_flag_slots()}, Python {kc.FLOW_FLAGS}")
    out["plan"] = {}
    for dt in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dt).element_size()
        wt = kc.FLOW_MAX_NB[dt]
        if lib.plu_flow_max_nb(size) != wt:
            fail(f"W_T {dt}: C {lib.plu_flow_max_nb(size)}, Python {wt}")
        for w in range(1, wt + 1):
            want = kc.flow_plan(w, dt, sms)
            if lib.plu_flow_plan(w, size, sms, plan) != 0 or tuple(plan) != (
                    want["ctas"], want["rows"], want["smem"], want["sets"]):
                fail(f"the flow plan at nb={w} {dt}: C {tuple(plan)}, "
                     f"kernels_cuda {want}")
        for batch in range(1, 65):
            if lib.plu_flow_leaf(batch, size, sms) != kt.k1_leaf_width(
                    batch, dt, sms):
                fail(f"the leaf width at batch {batch} {dt}: C "
                     f"{lib.plu_flow_leaf(batch, size, sms)}, kernels_torch."
                     f"k1_leaf_width {kt.k1_leaf_width(batch, dt, sms)}")
        out["plan"][str(dt)] = {str(w): kc.flow_plan(w, dt, sms)
                                for w in (*nbs, wt)}
        out["plan"][str(dt)]["leaf_width"] = {
            str(b): kt.k1_leaf_width(b, dt, sms) for b in (1, 2, 3, 4, 8)}
        print(f"  {dt}: plans agree at nb = 1..{wt} (W_T) on {sms} SMs; at "
              f"W_T {kc.flow_plan(wt, dt, sms)}")

    # ---- (b) K1 per launch ----------------------------------------------
    print("flow (b): K1 on the flow kernel against its plain twin, per "
          "launch beside its bound, the twin and lu_factor_ex(pivot=False)")
    for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        for w in (*nbs, kc.FLOW_MAX_NB[dt]):
            for batch in (1, 4):
                a = torch.as_tensor(rng.standard_normal((batch, w, w))
                                    + w * np.eye(w), dtype=dt, device=dev)
                kc.reset_launch_counts()
                got = kc.getrf_with_inverses(a)
                counts = (kc.LAUNCHES["getrf_with_inverses"],
                          kc.DEVICE_LAUNCHES["getrf_with_inverses"])
                each = kc.k1_device_launches(w, batch, dt, sms)
                if counts != (1, each) or sum(kc.LAUNCHES.values()) != 1:
                    fail(f"K1 nb={w} {dt} batch {batch}: launches "
                         f"{dict(kc.LAUNCHES)}, device launches "
                         f"{counts[1]}; expected one K1 launch of {each}")
                err = max(compare(f"{dt} nb={w} batch {batch} {n} (twin)",
                                  g, r, *tol)
                          for n, g, r in zip(("f", "linv", "uinv"), got,
                                             kt.k1_wide(a)))
                row = dict(
                    max_abs_err=err, device_launches=each,
                    ms=device_ms(lambda: kc.getrf_with_inverses(a), n=10,
                                 reps=5),
                    library_ms=device_ms(lambda: torch.linalg.lu_factor_ex(
                        a, pivot=False), n=10, reps=5),
                    **k1_bound(w, batch, dt))
                if batch == 1:  # one run: the twin is host-bound
                    row["plain_ms"] = cuda_ms(lambda _: kt.k1_wide(a),
                                              reps=1, warmup=0)
                print(f"  nb={w} {dt} batch {batch}: kernel {row['ms']:.4f} "
                      f"ms ({each} device launch(es)), bound "
                      f"{row['bound_ms']:.3e} ms "
                      f"({row['bound_by']}), lu_factor_ex "
                      f"{row['library_ms']:.4f} ms" + (
                          f", twin {row['plain_ms']:.3f} ms" if batch == 1
                          else ""))
                out["K1"][f"{w} {str(dt)[6:]} batch {batch}"] = row
        a = torch.as_tensor(rng.standard_normal((1, 512, 512))
                            + 512 * np.eye(512), dtype=dt, device=dev)
        *got, _ = kc.flow_kernel(a)
        err = max(compare(f"{dt} nb=512 flow kernel alone {n} (twin)", g, r,
                          *tol) for n, g, r in zip(
            ("f", "linv", "uinv"), got, kt.getrf_with_inverses_blocked(a)))
        if not all(torch.equal(g, r) for g, r in
                   zip(got, kc.getrf_with_inverses(a))):
            fail(f"nb=512 {dt}: the flow kernel's bits are not the cluster "
                 "kernel's")
        row = dict(max_abs_err=err, ms=device_ms(lambda: kc.flow_kernel(a),
                                                 n=10, reps=5),
                   cluster_ms=device_ms(lambda: kc.getrf_with_inverses(a),
                                        n=10, reps=5))
        print(f"  nb=512 {dt}: the flow kernel alone {row['ms']:.4f} ms, the "
              f"cluster kernel (the path's) {row['cluster_ms']:.4f} ms")
        out["K1"][f"512 {str(dt)[6:]} flow alone"] = row

    # ---- (c) poisson3d(32) at nb through the engines ----------------------
    print(f"flow (c): poisson3d(32) at nb={nb} through the fused engine "
          "(r32, r64 rcm) and superfused (r32 nd)")
    out["paths"] = got = paths(
        dev, nb=nb, trace=lambda fn, setup: profile(fn, setup=setup),
        factor_residual=factor_residual_device)
    for label, row in got.items():
        r64 = "r64" in label
        calls = row["superlevels"] if "superfused" in label else row["bl"]
        launched, want = row["launches"], row["k1_expected_device_launches"]
        if (launched["getrf_with_inverses"], row["k1_device_launches"]) != (
                calls, want) or sum(launched.values()) != calls:
            fail(f"{label}: launches {launched}, K1 device launches "
                 f"{row['k1_device_launches']}; expected K1 {calls} ({want} "
                 "device launches, kernels_cuda.k1_device_launches) and no "
                 "other kernel")
        limits = (1e-12, 1e-12) if r64 else (1e-5, 1e-10)
        if not (row["gstrf_residual"] < limits[0]
                and row["residual"] < limits[1] and row["finite"]):
            fail(f"{label}: residuals {row['gstrf_residual']:.3e}, "
                 f"{row['residual']:.3e} (limits {limits})")
        if not row["rel_err_vs_twin"] < (TOL_F64 if r64 else TOL_F32)[0]:
            fail(f"{label}: {row['rel_err_vs_twin']:.3e} from the same "
                 "engine on K1's plain twin")
        if row["k1_traced_launches"] == 0:
            fail(f"{label}: the trace shows no K1 kernel")
    one = out["K1"][f"{nb} float32 batch 1"]
    entry = dict(max_abs_err=one["max_abs_err"], ms=one["ms"],
                 plain_ms=one["plain_ms"], library_ms=one["library_ms"],
                 bound_ms=one["bound_ms"], bound_by=one["bound_by"])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"flow: {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out, entry, got["fused_r32_rcm"]["launches"]["getrf_with_inverses"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="print the traces of one factorization of the "
                         "rcm and nd paths and add one of an rcm solve")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "pangulu_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: package pangulu_tpu_torch not found beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.models import poisson2d, poisson3d, trefethen
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.sptrsv import TriangularSolver
    from pangulu_tpu_torch.testing import (BLOCKED_TOL,
                                           blocked_tiny_pivot_tile,
                                           tiny_pivot_tile)
    from pangulu_tpu_torch.utils.perf import residual_norm

    # true fp32 everywhere on the f32 path (no TF32 in plain matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    lib = kc.library()
    print(f"kernel build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    ptx = ptxas_by_kernel(lib.log)
    detail = {"card": card, "build_seconds": lib.build_seconds,
              "ptxas": ptx}
    kernels = {}
    dtypes = {"r32": torch.float32, "r64": torch.float64}
    print("ptxas: K1's instances (getrf_inv_kernel<type, nb/32>, "
          "lu_cluster_kernel<type> above nb=128), K3's and K5's sweep "
          "kernels (<type, tile width>)")
    k1_ptx, k5_ptx, prod_ptx = {}, {}, {}
    for name, info in ptx.items():
        lab = kernel_label(name)
        if lab is None:
            continue
        base, ty, arg = lab
        if base == "getrf_inv_kernel":
            label = f"getrf_inv_kernel<{ty}, nb<={32 * arg}>"
            k1_ptx[label] = info
        elif base == "lu_cluster_kernel":
            label = f"lu_cluster_kernel<{ty}>"
            k1_ptx[label] = info
        elif base in ("solve_sweep_kernel", "group_sweep_kernel"):
            label = f"{base}<{ty}, {arg}>"
            if base == "group_sweep_kernel":
                k5_ptx[(ty, arg)] = info
        elif base in PRODUCT_KERNELS:
            prod_ptx[f"{base}<{ty}" + (f", {arg}>" if arg else ">")] = info
            continue
        else:
            continue
        print(f"  {label}: {info.get('registers')} registers, "
              f"{info.get('spill_bytes')} spill bytes")
    if len(k1_ptx) != 8 or any(i.get("spill_bytes") != 0
                               for i in k1_ptx.values()):
        fail(f"K1: expected 8 instances without spills, ptxas says "
             f"{k1_ptx}")
    if k5_ptx.keys() != K5_SPILL_BYTES.keys() or any(
            k5_ptx[k].get("spill_bytes", 1 << 30) > c
            for k, c in K5_SPILL_BYTES.items()):
        fail(f"K5: expected group_sweep_kernel for float and double at "
             f"width 128, spilling at most {K5_SPILL_BYTES} "
             f"bytes; ptxas says {k5_ptx}")
    print("ptxas: K3's and K5's cluster kernels above nb=128 "
          "(solve_cluster_kernel<type, C>, group_cluster_kernel<type, C>)")
    sweep_ptx = {}
    for name, info in ptx.items():
        lab = sweep_label(name)
        if lab:
            label = f"{lab[0]}<{lab[1]}, {lab[2]}>"
            sweep_ptx[label] = dict(info, type=lab[1])
            print(f"  {label}: {info.get('registers')} registers, "
                  f"{info.get('spill_bytes')} spill bytes")
    if len(sweep_ptx) != CLUSTER_SWEEP_INSTANCES or any(
            i.get("spill_bytes", 1 << 30)
            > CLUSTER_SWEEP_SPILL_BYTES[i["type"]]
            for i in sweep_ptx.values()):
        fail(f"K3/K5 cluster kernels: expected {CLUSTER_SWEEP_INSTANCES} "
             f"instances spilling at most {CLUSTER_SWEEP_SPILL_BYTES} bytes; "
             f"ptxas says {sweep_ptx}")
    detail["cluster_sweep_ptxas"] = sweep_ptx
    detail["K1_ptxas"] = k1_ptx
    detail["K5_ptxas"] = {f"{t}<{w}>": i for (t, w), i in k5_ptx.items()}
    print("ptxas: the product kernels of K2 and K4 (tensor cores: 3xTF32 "
          "for float, DMMA for double)")
    for label, info in prod_ptx.items():
        print(f"  {label}: {info.get('registers')} registers, "
              f"{info.get('spill_bytes')} spill bytes")
    f32_ptx = {k: v for k, v in prod_ptx.items() if "<float" in k}
    if len(prod_ptx) != PRODUCT_INSTANCES or any(
            i.get("spill_bytes") != 0 for i in f32_ptx.values()):
        fail(f"products: expected {PRODUCT_INSTANCES} instances, the float "
             f"ones without spills; ptxas says {prod_ptx}")
    detail["product_ptxas"] = prod_ptx
    comp_ptx = {n: i for n, i in ptx.items() if re.search(
        r"plu\d+(triangle_inverses|triangle_products|decompress|compress)"
        r"_kernel", n)}
    print("ptxas: the compressed store's kernels (P6 decompress/compress "
          "<slot word, position type>, P2 triangle_inverses<type, nb/32> "
          "and triangle_products<type>)")
    for name, info in sorted(comp_ptx.items()):
        print(f"  {name}: {info.get('registers')} registers, "
              f"{info.get('spill_bytes')} spill bytes")
    if len(comp_ptx) != COMPRESSED_INSTANCES or any(
            i.get("spill_bytes") != 0 for i in comp_ptx.values()):
        fail(f"compressed store: expected {COMPRESSED_INSTANCES} instances "
             f"without spills; ptxas says {comp_ptx}")
    detail["compressed_ptxas"] = comp_ptx
    probe_ptx = {n: i for n, i in ptx.items() if re.search(
        r"plu\d+(overlap|scan_multi|newton_loop)_kernel", n)}
    print("ptxas: the probes' kernels (P5 overlap<mode>, P4 scan_multi<Q, "
          "products>, P3 newton_loop<type>)")
    for name, info in sorted(probe_ptx.items()):
        print(f"  {name}: {info.get('registers')} registers, "
              f"{info.get('spill_bytes')} spill bytes")
    if len(probe_ptx) != PROBE_INSTANCES or any(
            i.get("spill_bytes") != 0 for i in probe_ptx.values()):
        fail(f"probes: expected {PROBE_INSTANCES} instances without spills; "
             f"ptxas says {probe_ptx}")
    detail["probe_ptxas"] = probe_ptx
    wide_ptx = {n: i for n, i in ptx.items()
                if re.search(r"plu\d+(lu_wide|lu_flow|wide_gemm|wide_copy)"
                             r"_kernel", n)}
    print("ptxas: K1's kernels for nb > 256 (lu_wide<type, rows>, "
          "lu_flow<type, rows>, wide_gemm<type, store op>, wide_copy<type>;"
          " csrc/wide_lu.cuh)")
    for name, info in sorted(wide_ptx.items()):
        print(f"  {name}: {info.get('registers')} registers, "
              f"{info.get('spill_bytes')} spill bytes")
    if len(wide_ptx) != WIDE_INSTANCES or any(
            i.get("spill_bytes") != 0 for n, i in wide_ptx.items()
            if re.search(r"(wide|gemm|copy)_kernelIf|lu_flow_kernel", n)):
        fail(f"K1 for nb > 256: expected {WIDE_INSTANCES} instances, the "
             f"float ones and the flow kernel's without spills; ptxas says "
             f"{wide_ptx}")
    detail["wide_ptxas"] = wide_ptx

    # ---- K1 ------------------------------------------------------------
    print("K1 getrf_with_inverses against its plain version")
    rng = np.random.default_rng(0)
    k1_err = {}
    for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        cases = [(f"nb={nb}", rng.standard_normal((2, nb, nb))
                  + nb * np.eye(nb)) for nb in (10, 16, 64, 128)]
        cases += [(f"nb={nb}, zero pivot at step {k}",
                   tiny_pivot_tile(nb, k, rng)) for nb, k in
                  ((16, 0), (16, 8), (128, 64), (128, 127))]
        err = 0.0
        for label, tile in cases:
            a = torch.as_tensor(tile, dtype=dt, device=dev)
            got = kc.getrf_with_inverses(a)
            ref = kt.getrf_with_inverses(a)
            err = max([err] + [compare(f"{dt} {label} {n}", g, r, *tol)
                               for n, g, r in zip(("f", "linv", "uinv"),
                                                  got, ref)])
        k1_err[dt] = err
    print("K1 at 128 < nb <= 256 (the cluster kernel) against its plain "
          "twin (getrf_with_inverses_blocked, panels of 32) and the rank-1 "
          "plain version; one device launch a K1 launch")
    k1_err256 = {}
    for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        cases = [(f"nb={nb}", rng.standard_normal((2, nb, nb))
                  + nb * np.eye(nb)) for nb in (129, 200, 255, 256)]
        cases += [(f"nb={nb}, zero pivots at steps {k1} and 128+{k2}",
                   blocked_tiny_pivot_tile(nb, k1, k2, rng))
                  for nb, k1, k2 in ((256, 0, 127), (256, 5, 1),
                                     (200, 64, 40))]
        err = 0.0
        for label, tile in cases:
            a = torch.as_tensor(tile, dtype=dt, device=dev)
            kc.reset_launch_counts()
            got = kc.getrf_with_inverses(a)
            if (kc.LAUNCHES["getrf_with_inverses"],
                    kc.DEVICE_LAUNCHES["getrf_with_inverses"]) != (1, 1):
                fail(f"K1 {label}: {kc.LAUNCHES['getrf_with_inverses']} "
                     f"launches, {kc.DEVICE_LAUNCHES} device launches; "
                     "expected one of each")
            for n, g, r in zip(("f", "linv", "uinv"), got,
                               kt.getrf_with_inverses_blocked(a)):
                compare(f"{dt} {label} {n} (twin)", g, r, *tol)
            err = max([err] + [
                compare(f"{dt} {label} {n} (rank-1)", g, r, *t)
                for n, g, r, t in zip(("f", "linv", "uinv"), got,
                                      kt.getrf_with_inverses(a),
                                      BLOCKED_TOL[dt])])
        k1_err256[dt] = err
    # true f32 over the 8 panel updates of 3xTF32 products
    a = torch.as_tensor(rng.standard_normal((4, 256, 256))
                        + 256 * np.eye(256), device=dev)
    ref = kt.getrf_with_inverses_blocked(a)
    true256 = {}
    for n, g, p, r in zip(("f", "linv", "uinv"),
                          kc.getrf_with_inverses(a.float()),
                          kt.getrf_with_inverses_blocked(a.float()), ref):
        ek, ep = rel_err(g, r), rel_err(p, r)
        true256[n] = dict(kernel=ek, plain=ep)
        print(f"  true f32 at nb=256, {n} against the f64 twin: kernel "
              f"{ek:.3e}, f32 twin {ep:.3e} (kernel <= 2x plain) "
              f"{'ok' if ek <= 2 * ep else 'FAIL'}")
        if ek > 2 * ep:
            fail(f"K1 at nb=256: {n} less accurate than true f32")
    detail["K1_nb256_true_f32"] = true256
    print("K1 per launch at nb=128 and nb=256 (back-to-back launches, "
          "device time; one device launch each, the cluster kernel's at "
          "nb=256)")
    k1 = {}
    for nb in (128, 256):
        for dt in (torch.float32, torch.float64):
            for batch in (1, 5, 16, 132):
                a = torch.as_tensor(rng.standard_normal((batch, nb, nb))
                                    + nb * np.eye(nb), dtype=dt, device=dev)
                ms = device_ms(lambda: kc.getrf_with_inverses(a), n=200)
                lms = device_ms(lambda: torch.linalg.lu_factor_ex(
                    a, pivot=False), n=50)
                row = dict(ms=ms, ms_per_tile=ms / batch, library_ms=lms,
                           **k1_bound(nb, batch, dt))
                if batch == 1:
                    # the kernel's own plain counterpart: the panel-32
                    # twin above 128; the rank-1 version beside it
                    row["plain_ms"] = cuda_ms(
                        lambda _: (kt.getrf_with_inverses if nb <= 128 else
                                   kt.getrf_with_inverses_blocked)(a),
                        reps=3)
                    if nb > 128:
                        row["plain_rank1_ms"] = cuda_ms(
                            lambda _: kt.getrf_with_inverses(a), reps=3)
                print(f"  nb={nb} {dt} batch {batch}: kernel {ms:.4f} ms "
                      f"({ms / batch:.4f} ms a tile), bound "
                      f"{row['bound_ms']:.3e} ms ({row['bound_by']}), "
                      f"lu_factor_ex(pivot=False) {lms:.4f} ms"
                      + (f", plain {row['plain_ms']:.3f} ms" if batch == 1
                         else "")
                      + (f" (rank-1 {row['plain_rank1_ms']:.3f} ms)"
                         if "plain_rank1_ms" in row else ""))
                k1[f"{dt}_batch{batch}" if nb == 128
                   else f"{dt}_nb256_batch{batch}"] = row
    detail["K1"] = k1
    for name, one, err in (
            ("getrf_with_inverses", k1["torch.float32_batch1"], k1_err),
            ("getrf_with_inverses@nb=256", k1["torch.float32_nb256_batch1"],
             k1_err256)):
        kernels[name] = dict(
            max_abs_err=err[torch.float32], ms=one["ms"],
            plain_ms=one["plain_ms"], library_ms=one["library_ms"],
            **{k: one[k] for k in ("bound_ms", "bound_by")})

    # ---- K2, K3 (chain) and K4, K5 (groups) ---------------------------
    def hold(label, gen, nb, dtype, ordering, uch=kt.MEGA_UCH,
             timed=True, true_f32=False):
        """Factor and solve with the kernels and the plain versions on
        the same CUDA tensors; return the errors and times.  Two kernel
        factorizations must be bit-identical.  With true_f32, the f32
        kernel's error against the plain f64 factorization of the same
        store must be at most 2x the f32 plain version's, and the f64
        kernel must agree with that reference to TOL_F64."""
        grouped = ordering == "nd"
        print(f"{'K4/K5' if grouped else 'K2/K3'} on {label}, nb={nb}, "
              f"{dtype}, {ordering}, uch={uch}")
        a = gen()
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device="cuda"))
        blk, sch = h.blocked, h.schedule
        nt, bl = blk.num_tiles, sch.block_length
        if grouped:
            ftab = kt.KernelTables.build(
                sch.group_mega_tables(nt, uch=uch), dev)
            stab = kt.KernelTables.build(sch.group_solve_tables(nt), dev)
            if ftab.host["ngroups"] >= bl:
                fail(f"{label}: the nd schedule does not compress")
            fk, fp = kc.mega_factorize_groups, kt.mega_factorize_groups
            sk, sp = kc.mega_solve_groups, kt.mega_solve_groups
        else:
            ftab = kt.KernelTables.build(sch.mega_tables(nt, uch=uch), dev)
            stab = kt.KernelTables.build(sch.mega_solve_tables(nt), dev)
            fk, fp = kc.mega_factorize, kt.mega_factorize
            sk, sp = kc.mega_solve, kt.mega_solve
        f64 = dtype == "r64"
        ftol = TOL_F64 if f64 else (TOL_GROUP_F32 if grouped else TOL_F32)
        stol = TOL_F64 if f64 else TOL_SOLVE_F32
        t0 = blk.device_tiles(dev)
        kw = dict(nb=nb, tol=kt.DEFAULT_TOL[t0.dtype], bl=bl)
        tk, ik = fk(t0.clone(), ftab, **kw)
        tp, ip = fp(t0.clone(), ftab, **kw)
        ef = max(compare("tiles", tk[:nt], tp[:nt], *ftol),
                 compare("invs", ik, ip, *ftol))
        tk2, ik2 = fk(t0.clone(), ftab, **kw)
        if not (torch.equal(tk, tk2) and torch.equal(ik, ik2)):
            fail("two kernel factorizations of the same store differ")
        del tk2, ik2
        f32_vs_f64 = None
        if true_f32:
            # the reference: the plain f64 version (torch.matmul), which
            # shares no code with the kernels; the f64 kernel (DMMA) is
            # held against it here too, at full width
            kw64 = dict(nb=nb, bl=bl, tol=kt.DEFAULT_TOL[torch.float64])
            t64, i64 = fp(t0.double(), ftab, **kw64)
            tk64, ik64 = fk(t0.double(), ftab, **kw64)
            f32_vs_f64 = dict(f64_kernel_max_abs_err=max(
                compare("f64 kernel tiles", tk64[:nt], t64[:nt], *TOL_F64),
                compare("f64 kernel invs", ik64, i64, *TOL_F64)))
            del tk64, ik64
            # the f64 kernel's time (K6, K2's double instance; K4's on
            # nd) beside its bound: every tile read and written once,
            # the inverses written, the products at the DMMA rate
            f64_ms = cuda_ms(lambda t: fk(t, ftab, **kw64), setup=t0.double)
            f64_bound = bound(2 * (nt + bl) * nb * nb * 8,
                              sch.flop_estimate(), torch.float64, TC_FLOP_S)
            f32_vs_f64.update(f64_factor_ms=f64_ms, f64_factor_bound=f64_bound)
            print(f"  f64 kernel factorization: {f64_ms:.3f} ms (CUDA "
                  f"events, median of 5), bound "
                  f"{f64_bound['bound_ms']:.4f} ms "
                  f"({f64_bound['bound_by']}), "
                  f"{f64_bound['bound_ms'] / f64_ms:.2%} of it")
            for part, got, ref, r64 in (("tiles", tk[:nt], tp[:nt], t64[:nt]),
                                        ("invs", ik, ip, i64)):
                ek, ep = rel_err(got, r64), rel_err(ref, r64)
                print(f"  true f32, {part} against the plain f64 version: "
                      f"kernel {ek:.3e}, plain {ep:.3e} (max |err| / max "
                      f"|f64|; kernel <= 2x plain) "
                      f"{'ok' if ek <= 2 * ep else 'FAIL'}")
                f32_vs_f64[part] = dict(kernel=ek, plain=ep)
                if ek > 2 * ep:
                    fail(f"{label}: the f32 kernel's {part} are less "
                         "accurate than true f32")
            del t64, i64
        # right-hand sides b = A·1, 2b, 3b, 4b in the kernels' layout
        x = torch.zeros((4, bl + 1, nb), dtype=t0.dtype, device=dev)
        x[0, :bl].view(-1)[:a.n] = torch.as_tensor(
            a.to_scipy() @ np.ones(a.n), device=dev)
        for r in range(1, 4):
            x[r] = (r + 1) * x[0]
        skw = dict(nb=nb, bl=bl)
        es = 0.0
        for r in (1, 4):
            xr = x[:r].contiguous()
            got = sk(xr, tk, ik, stab, **skw)
            es = max(es, compare(f"solve nrhs={r}", got,
                                 sp(xr, tk, ik, stab, **skw), *stol))
            if not torch.equal(got[:, bl], xr[:, bl]):
                fail("the solve wrote the scratch segment")
            if not torch.equal(got, sk(xr, tk, ik, stab, **skw)):
                fail("two solves of the same input differ")
        # the work as these tables define it: every tile read once, the
        # factors and inverses written once; per solve and RHS, the
        # panel tiles and the 2 bl inverses read once, x read and written
        # (the factorization's products run on tensor cores, so its bound
        # takes their rate; the CUDA-core one is kept beside it)
        esz, tile_b = t0.element_size(), nb * nb * t0.element_size()
        npan = int(stab.host["nl_tab"].sum() + stab.host["nuc_tab"].sum())
        fbytes, flop = 2 * (nt + bl) * tile_b, sch.flop_estimate()
        out = dict(nb=nb, bl=bl, tiles=nt, dtype=dtype, ordering=ordering,
                   uch=uch, factor_max_abs_err=ef, solve_max_abs_err=es,
                   true_f32=f32_vs_f64,
                   factor_bound=bound(fbytes, flop, t0.dtype, TC_FLOP_S),
                   factor_cuda_core_bound=bound(fbytes, flop, t0.dtype),
                   solve_bound=bound((npan + 2 * bl) * tile_b
                                     + 2 * (bl + 1) * nb * esz,
                                     2 * nb * nb * (npan + 2 * bl),
                                     t0.dtype))
        if not grouped:
            # cooperative grid of K3's sweeps at one RHS
            out["solve_items_widest_level"] = int(max(
                1, stab.host["nl_tab"].max(), stab.host["nuc_tab"].max()))
        if grouped:
            out.update(groups=ftab.host["ngroups"],
                       solve_groups=stab.host["ngroups"])
        if timed:
            fms = cuda_ms(lambda t: fk(t, ftab, **kw), setup=t0.clone)
            fpms = cuda_ms(lambda t: fp(t, ftab, **kw), setup=t0.clone,
                           reps=1)
            print(f"  factorization: kernel {fms:.3f} ms, plain "
                  f"{fpms:.3f} ms")
            out.update(factor_ms=fms, factor_plain_ms=fpms)
            for r in (4, 1):
                xr = x[:r].contiguous()
                sms = cuda_ms(lambda _: sk(xr, tk, ik, stab, **skw),
                              reps=10)
                spms = cuda_ms(lambda _: sp(xr, tk, ik, stab, **skw),
                               reps=2)
                print(f"  solve ({r} rhs): kernel {sms:.3f} ms, plain "
                      f"{spms:.3f} ms")
                out.update({f"solve_ms_{r}rhs": sms,
                            f"solve_plain_ms_{r}rhs": spms})
            out.update(solve_ms=sms, solve_plain_ms=spms)
        del h, t0, tk, tp, ik, ip
        torch.cuda.empty_cache()
        return out

    chain = {
        "p2d16_r32": hold("poisson2d(16)", lambda: poisson2d(16), 16,
                          "r32", "rcm"),
        "p2d16_r64": hold("poisson2d(16)", lambda: poisson2d(16), 16,
                          "r64", "rcm"),
        "p3d32_r32": hold("poisson3d(32)", lambda: poisson3d(32), 128,
                          "r32", "rcm", true_f32=True),
    }
    groups = {
        "p2d12_r32": hold("poisson2d(12)", lambda: poisson2d(12), 16,
                          "r32", "nd", timed=False),
        "p2d12_r32_uch8": hold("poisson2d(12)", lambda: poisson2d(12), 16,
                               "r32", "nd", uch=8, timed=False),
        "p2d24_r64": hold("poisson2d(24)", lambda: poisson2d(24), 16,
                          "r64", "nd", timed=False),
        "p2d24_r64_uch8": hold("poisson2d(24)", lambda: poisson2d(24), 16,
                               "r64", "nd", uch=8, timed=False),
        "p3d32_r32": hold("poisson3d(32)", lambda: poisson3d(32), 128,
                          "r32", "nd", true_f32=True),
    }
    detail["chain"], detail["groups"] = chain, groups
    # nb=256: K1's cluster kernel, the 256-wide panel bands, K3 and K5 of
    # tile width 256; r64 on a smaller matrix
    u256 = kt.mega_uch(256)
    nb256 = {
        "p3d32_r32_rcm": hold("poisson3d(32)", lambda: poisson3d(32), 256,
                              "r32", "rcm", uch=u256, true_f32=True),
        "p3d32_r32_nd": hold("poisson3d(32)", lambda: poisson3d(32), 256,
                             "r32", "nd", uch=u256, true_f32=True),
        "p3d16_r64_rcm": hold("poisson3d(16)", lambda: poisson3d(16), 256,
                              "r64", "rcm", uch=u256, timed=False),
        "p3d16_r64_nd": hold("poisson3d(16)", lambda: poisson3d(16), 256,
                             "r64", "nd", uch=u256, timed=False),
    }
    detail["nb256"] = nb256

    # ---- one grid barrier ------------------------------------------------
    print("grid barrier (K3 takes one a level; the first grid is K3's at "
          "poisson3d(32) rcm, 1 rhs): device us per barrier")
    detail["grid_sync_us"] = {}
    for want in (chain["p3d32_r32"]["solve_items_widest_level"], 132,
                 10 ** 6):
        kc.grid_sync_probe(dev, want, 10)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        blocks = kc.grid_sync_probe(dev, want, 2000)
        end.record()
        end.synchronize()
        us = start.elapsed_time(end) * 1e3 / 2000
        print(f"  {blocks} blocks: {us:.3f} us")
        detail["grid_sync_us"][blocks] = us

    for name, res, f_or_s in (("mega_factorize", chain, "factor"),
                              ("mega_solve", chain, "solve"),
                              ("mega_factorize_groups", groups, "factor"),
                              ("mega_solve_groups", groups, "solve")):
        big = res["p3d32_r32"]
        kernels[name] = dict(
            max_abs_err=max(r[f"{f_or_s}_max_abs_err"] for r in res.values()
                            if r["dtype"] == "r32"),
            ms=big[f"{f_or_s}_ms"], plain_ms=big[f"{f_or_s}_plain_ms"],
            library_ms=None, **big[f"{f_or_s}_bound"])
        big = nb256["p3d32_r32_" + ("nd" if res is groups else "rcm")]
        kernels[f"{name}@nb=256"] = dict(
            max_abs_err=big[f"{f_or_s}_max_abs_err"],
            ms=big[f"{f_or_s}_ms"], plain_ms=big[f"{f_or_s}_plain_ms"],
            library_ms=None, **big[f"{f_or_s}_bound"])

    # ---- the paths -------------------------------------------------------
    a = poisson3d(32)
    b = a.to_scipy() @ np.ones(a.n)

    def drive(ordering, expect, nb=128):
        """init -> gstrf -> gstrs with the launch counts zeroed before and
        read after; ``expect(h)`` gives the exact counts."""
        print(f"path: init -> gstrf -> gstrs, poisson3d(32), nb={nb}, r32, "
              f"{ordering}, cuda")
        kc.reset_launch_counts()
        h = init(a, InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                device="cuda", check=True))
        gstrf(h)
        x = gstrs(h, b)
        launches = dict(kc.LAUNCHES)
        engines = (h.perf.kernels["engine"], h.perf.kernels["solve_engine"])
        print(f"  engines: factorization {engines[0]}, solve {engines[1]}")
        print(f"  launches: {launches}")
        if launches != expect(h):
            fail(f"launch counts {launches}, expected {expect(h)}")
        # K1's device launches, as the C entries report them: one a K1
        # launch, the cluster kernel's above nb = 128
        per_k1 = 1
        k1_dev = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        print(f"  K1's device launches: {k1_dev} ({per_k1} a K1 launch)")
        if k1_dev != per_k1 * launches["getrf_with_inverses"]:
            fail(f"K1 made {k1_dev} device launches in "
                 f"{launches['getrf_with_inverses']} launches, expected "
                 f"{per_k1} each")
        fres = h.perf.kernels["gstrf_residual"]
        sres = residual_norm(a.to_scipy(), x, b)
        print(f"  gstrf residual ||L(U1)-A1||/||A1|| = {fres:.3e} (< 1e-5)")
        print(f"  solve residual after refine = {sres:.3e} (< 1e-10)")
        if x.shape != (a.n,) or not np.isfinite(x).all():
            fail("solution has the wrong shape or non-finite values")
        if not fres < 1e-5:
            fail("gstrf residual too large")
        if not sres < 1e-10:
            fail("solve residual too large")
        fac, ts = h._factorizer, h._trisolver
        fms = cuda_ms(lambda t: fac.factorize(t, sync=False),
                      setup=lambda: h.blocked.device_tiles(dev), reps=7)
        xb = ts.blockify_rhs(h.reordering.transform_b(b.astype(np.float32)))
        sms = cuda_ms(lambda _: ts.solve_blocked(h.factor_tiles, xb), reps=7)
        flops = h.schedule.flop_estimate()
        gflops = flops / (fms * 1e-3) / 1e9
        print(f"  {fms:.3f} ms per factorization, {sms:.3f} ms per solve, "
              f"{gflops:.1f} GFLOPS (dense-tile model, {flops:.3e} flop)")
        out = dict(engines=engines, launches=launches,
                   k1_device_launches=k1_dev, gstrf_residual=fres,
                   solve_residual=sres, ms_per_factorization=fms,
                   ms_per_solve=sms, gflops_dense=gflops, flops=flops,
                   tiles=h.blocked.num_tiles, bl=h.schedule.block_length)
        return h, xb, out

    def zero_but(**counts):
        return {k: counts.get(k, 0) for k in kc.LAUNCHES}

    def tiles_of(h):
        return lambda: h.blocked.device_tiles(dev)

    def stages(h, grouped):
        """One factorization traced: its product kernels' device ms (and
        launches) beside the stage yardsticks; returns (trace, stages)."""
        fac = h._factorizer
        p = profile(lambda t: fac.factorize(t, sync=False),
                    setup=tiles_of(h))
        out = {}
        for stage in ("panel", "schur"):
            name = f"::{'group_' if grouped else ''}{stage}_kernel"
            ks = [k for n, k in p["kernels"].items()
                  if n.split("<")[0].endswith(name)]
            out[f"{stage}_kernel_ms"] = sum(k["device_ms"] for k in ks)
            out[f"{stage}_kernel_launches"] = sum(k["launches"] for k in ks)
        out.update(stage_yardsticks(h.factor_tiles, fac.inv_tiles,
                                    fac.tables, grouped))
        for stage in ("panel", "schur"):
            lib = "bmm" if stage == "panel" else "baddbmm"
            print(f"  {stage} stage: kernel {out[f'{stage}_kernel_ms']:.3f} "
                  f"device ms ({out[f'{stage}_kernel_launches']} launches), "
                  f"torch.{lib} per {'group' if grouped else 'level'} "
                  f"{out[f'{stage}_library_ms']:.3f} ms")
        return p, out

    prof = {}
    h, xb, detail["rcm_path"] = drive("rcm", lambda h: zero_but(
        getrf_with_inverses=h.schedule.block_length, mega_factorize=1,
        mega_solve=3))
    if detail["rcm_path"]["engines"] != ("mega", "mega"):
        fail("the rcm path did not take the chain engines")
    rcm_launches = detail["rcm_path"]["launches"]
    prof["rcm gstrf"], detail["rcm_path"]["stages"] = stages(h, False)
    if args.profile:
        fac, ts = h._factorizer, h._trisolver
        prof["rcm gstrs"] = profile(
            lambda _: ts.solve_blocked(h.factor_tiles, xb))
        sweeps = sum(k["launches"] for n, k in
                     prof["rcm gstrs"]["kernels"].items()
                     if "solve_sweep_kernel" in n)
        if sweeps != 2:
            fail(f"one rcm solve made {sweeps} launches of K3's sweep "
                 "kernel, expected 2")
    del h, xb
    torch.cuda.empty_cache()

    h, xb, nd = drive("nd", lambda h: zero_but(
        getrf_with_inverses=h._factorizer.tables.host["ngroups"],
        mega_factorize_groups=1, mega_solve_groups=3))
    if nd["engines"] != ("mega_group", "mega_group"):
        fail("the nd path did not take the grouped engines")
    nd_launches = nd["launches"]
    nd["groups"] = h._factorizer.tables.host["ngroups"]
    nd["solve_groups"] = h._trisolver.tables.host["ngroups"]
    # the chain engines on the same nd schedule: does grouping pay?
    chain_fac = LUFactorizer(h.blocked, h.schedule, device=dev,
                             dispatch="mega")
    chain_ts = TriangularSolver(h.blocked, h.schedule, device=dev,
                                inv_tiles=h._trisolver.inv_tiles,
                                dispatch="mega")
    nd["chain_ms_per_factorization"] = cuda_ms(
        lambda t: chain_fac.factorize(t, sync=False), setup=tiles_of(h),
        reps=7)
    nd["chain_ms_per_solve"] = cuda_ms(
        lambda _: chain_ts.solve_blocked(h.factor_tiles, xb), reps=7)
    print(f"  chain engines forced on the same nd schedule: "
          f"{nd['chain_ms_per_factorization']:.3f} ms per factorization, "
          f"{nd['chain_ms_per_solve']:.3f} ms per solve")
    detail["nd_path"] = nd
    prof["nd gstrf"], nd["stages"] = stages(h, True)
    # one nd solve traced: K5 is one cooperative launch per sweep
    ts = h._trisolver
    prof["nd gstrs"] = profile(
        lambda _: ts.solve_blocked(h.factor_tiles, xb), retry="nd gstrs",
        complete=lambda kernels: sum(
            k["launches"] for n, k in kernels.items()
            if "group_sweep_kernel" in n) >= 2)
    print_profile({"nd gstrs": prof["nd gstrs"]})
    k5 = [(m[0], k["launches"]) for n, k in prof["nd gstrs"]["kernels"]
          .items() if (m := re.search(r"group_(sweep|solve_\w+)_kernel", n))]
    if k5 != [("group_sweep_kernel", 2)]:
        fail(f"one nd solve made the launches {k5}, expected 2 of K5's "
             "group_sweep_kernel and no other")
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.solve_blocked(h.factor_tiles, xb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    nd["gstrs_host_wall_ms"] = statistics.median(walls)
    print(f"  one nd solve without the profiler: host wall "
          f"{nd['gstrs_host_wall_ms']:.3f} ms (call to synchronise, median "
          "of 7)")
    nd["k5_grid"] = dict(kc.GRID["mega_solve_groups"])
    steps, _ = kc.solve_steps_view(ts.tables, nd["bl"], nd["tiles"], dev)
    for sw in ("l", "uc"):
        nd["k5_grid"][f"{sw}_steps"] = len(steps[f"{sw}_step"]) - 1
        nd["k5_grid"][f"{sw}_widest_step"] = steps[f"{sw}_width"]
    g = nd["k5_grid"]
    print(f"  K5 grid (1 rhs): {g['forward']} blocks forward, "
          f"{g['backward']} backward, {g['blocks_per_sm']} blocks per SM "
          f"(occupancy query); steps {g['l_steps']} forward, "
          f"{g['uc_steps']} backward, widest {g['l_widest_step']} and "
          f"{g['uc_widest_step']} items")
    del h, xb, chain_fac, chain_ts, ts
    torch.cuda.empty_cache()
    if args.profile:
        print_profile({k: v for k, v in prof.items() if k != "nd gstrs"})
    detail["profile"] = prof

    # ---- the paths at nb=256 -------------------------------------------
    # one K1 launch is one device launch of the cluster kernel; drive()
    # holds that count exactly (kernels_cuda.DEVICE_LAUNCHES), the traces
    # below give its device ms
    k1_kernels = ("lu_cluster_kernel",)
    launches256 = {}   # K1, K2, K3 from the rcm path, K4, K5 from nd
    for ordering, engine, expect in (
            ("rcm", "mega", lambda h: zero_but(
                getrf_with_inverses=h.schedule.block_length,
                mega_factorize=1, mega_solve=3)),
            ("nd", "mega_group", lambda h: zero_but(
                getrf_with_inverses=h._factorizer.tables.host["ngroups"],
                mega_factorize_groups=1, mega_solve_groups=3))):
        h, xb, res = drive(ordering, expect, nb=256)
        if res["engines"] != (engine, engine):
            fail(f"the nb=256 {ordering} path did not take the {engine} "
                 "engines")
        own = (("getrf_with_inverses", "mega_factorize", "mega_solve")
               if ordering == "rcm" else
               ("mega_factorize_groups", "mega_solve_groups"))
        launches256.update({k: res["launches"][k] for k in own})
        fac, ts = h._factorizer, h._trisolver
        if ordering == "nd":
            res.update(groups=fac.tables.host["ngroups"],
                       solve_groups=ts.tables.host["ngroups"])
        # the sweeps' thread block clusters: the grid of the path's last
        # solve (its last refinement round)
        sweep = "mega_solve" if ordering == "rcm" else "mega_solve_groups"
        res["sweep_grid"] = dict(kc.GRID[sweep])
        g = res["sweep_grid"]
        print(f"  {'K3' if ordering == 'rcm' else 'K5'} at nb=256 (1 rhs): "
              f"clusters of {g['cluster']} CTAs, {g['forward']} CTAs "
              f"forward, {g['backward']} backward, {g['clusters_fit']} "
              "clusters fit on the card")
        if g["cluster"] == 1 or g["forward"] % g["cluster"]:
            fail(f"the nb=256 {ordering} solve did not run on clusters: {g}")
        # the sweeps sum each row in one order: two solves, the same bits
        if not torch.equal(ts.solve_blocked(h.factor_tiles, xb),
                           ts.solve_blocked(h.factor_tiles, xb)):
            fail(f"two nb=256 {ordering} solves of one input differ")
        print("  two solves of one input: the same bits")
        # one factorization and one solve of its factors, traced apart;
        # the solve is 2 launches of the sweep's cluster kernel
        kern = ("solve_cluster_kernel" if ordering == "rcm"
                else "group_cluster_kernel")

        def sweeps_in(kernels):
            return [(n.split("<")[0].split("::")[-1], k["launches"])
                    for n, k in kernels.items() if "_kernel<" in n and (
                        "sweep_kernel" in n or "cluster_kernel" in n)
                    and "lu_cluster" not in n]

        tr = {f"nb=256 {ordering} gstrf": profile(
                  lambda t: fac.factorize(t, sync=False), setup=tiles_of(h)),
              f"nb=256 {ordering} gstrs": profile(
                  lambda _: ts.solve_blocked(h.factor_tiles, xb),
                  retry=f"nb=256 {ordering} gstrs",
                  complete=lambda kernels: sweeps_in(kernels) == [(kern, 2)])}
        print_profile(tr)
        if sweeps_in(tr[f"nb=256 {ordering} gstrs"]["kernels"]) != [(kern,
                                                                       2)]:
            fail(f"one nb=256 {ordering} solve made the sweep launches "
                 f"{sweeps_in(tr[f'nb=256 {ordering} gstrs']['kernels'])}, "
                 f"expected 2 of {kern} and no other")
        fk = tr[f"nb=256 {ordering} gstrf"]["kernels"]
        k1 = {k: [v for n, v in fk.items()
                  if n.split("<")[0].endswith("::" + k)] for k in k1_kernels}
        k1_ms = sum(v["device_ms"] for vs in k1.values() for v in vs)
        all_ms = sum(v["device_ms"] for v in fk.values())
        res.update(trace=tr, k1_trace_launches={
            k: sum(v["launches"] for v in vs) for k, vs in k1.items()},
            k1_device_ms=k1_ms, k1_share=k1_ms / all_ms)
        print(f"  K1's cluster kernel in the trace: {k1_ms:.3f} of "
              f"{all_ms:.3f} device ms ({k1_ms / all_ms:.1%}), launches "
              f"{res['k1_trace_launches']} (counted: "
              f"{res['k1_device_launches']})")
        detail[f"{ordering}256_path"] = res
        del h, xb, fac, ts
        torch.cuda.empty_cache()

    # ---- r64 -------------------------------------------------------------
    for label, gen, nb, ordering, engine in (
            ("trefethen(20)", lambda: trefethen(20), 10, "auto", None),
            ("poisson2d(24)", lambda: poisson2d(24), 16, "nd",
             "mega_group")):
        print(f"r64: {label}, nb={nb}, {ordering}, cuda")
        a = gen()
        b = a.to_scipy() @ np.ones(a.n)
        h = init(a, InitOptions(nb=nb, dtype="r64", ordering=ordering,
                                device="cuda"))
        gstrf(h)
        x = gstrs(h, b)
        rres = residual_norm(a.to_scipy(), x, b)
        print(f"  engine {h.perf.kernels['engine']}, solve residual = "
              f"{rres:.3e} (< 1e-12)")
        if engine and h.perf.kernels["engine"] != engine:
            fail(f"{label} r64 did not take the {engine} engine")
        if not rres < 1e-12:
            fail("r64 residual too large")
        detail[f"r64_{label}_residual"] = rres

    # ---- the rest of the public surface ----------------------------------
    surface = surface_phase(a=poisson3d(32), dev=dev)
    detail["surface"] = surface
    print(json.dumps({"surface": {k: v for k, v in surface.items()
                                  if k != "cli_stdout"}}))

    # ---- the compressed store ------------------------------------------
    comp, comp_kernels, comp_launches, refs = compressed_phase(
        dev, nd, poisson3d(32))
    detail["compressed"] = comp
    kernels.update(comp_kernels)
    print(json.dumps({"compressed": {k: v for k, v in comp.items()
                                     if k != "trace"}}))

    def untraced(d):
        return {k: untraced(v) if isinstance(v, dict) else v
                for k, v in d.items() if k != "trace"}

    # ---- the out-of-core panel driver (the compressed route) ----------
    panel, panel_path = panel_phase(dev, nd, comp, refs)
    del refs
    torch.cuda.empty_cache()
    detail["panel"] = panel
    print(json.dumps({"panel": untraced(panel)}))

    # ---- the complex types, through the real 2x2 embedding ------------
    cplx = complex_phase(dev)
    detail["complex"] = cplx
    print(json.dumps({"complex": untraced(cplx)}))

    # ---- the multi-device engine: 1 x 1, and 2 x 2 ranks on this card ---
    dist_res = dist_phase(dev)
    detail["dist"] = dist_res
    print(json.dumps({"dist": dist_res}))

    # ---- the TPU probes P5, P4, P3 -------------------------------------
    probes, probe_kernels, probe_launches = probes_phase(dev)
    detail["probes"] = probes
    kernels.update(probe_kernels)
    print(json.dumps({"probes": {k: v for k, v in probes.items()
                                 if k != "true_f32"}}))

    # ---- the fused and levels engines, K1 for wide tiles, native complex
    xla, xla_kernels, xla_launches = xla_engines_phase(dev)
    detail["xla_engines"] = xla
    kernels.update(xla_kernels)
    print(json.dumps({"xla_engines": untraced(xla)}))

    # ---- the compressed store and the mesh at nb > 256, native complex
    wide_st, wide_kernels, wide_launches = wide_native_stores_phase(dev)
    detail["wide_native_stores"] = wide_st
    kernels.update(wide_kernels)
    print(json.dumps({"wide_native_stores": untraced(wide_st)}))

    # ---- profile_dir, the examples, the out-of-core demo, K1 above 1024
    extras = extras_phase(dev)
    detail["extras"] = extras
    print(json.dumps({"extras": extras}))

    # ---- the superfused and segmented engines --------------------------
    sup, sup_launches = superfused_phase(dev)
    detail["superfused"] = sup
    print(json.dumps({"superfused": sup}))

    # ---- K2's chain-ahead (PANGULU_TPU_SUPERLEVEL=1) --------------------
    chain, chain_k2 = chain_ahead_phase(dev)
    detail["chain_ahead"] = chain
    kernels["mega_factorize"]["chain_ahead"] = chain_k2
    print(json.dumps({"chain_ahead": untraced(chain)}))

    # ---- K1 above 512 on the flow kernel, and the engines at nb=1024 -----
    flow, flow_entry, flow_launches = flow_phase(dev)
    detail["flow"] = flow
    kernels[f"getrf_with_inverses@nb={FLOW_PATH_NB}"] = flow_entry
    print(json.dumps({"flow": flow}))

    launches = dict(rcm_launches)
    launches["mega_factorize_groups"] = nd_launches["mega_factorize_groups"]
    launches["mega_solve_groups"] = nd_launches["mega_solve_groups"]
    # the nb=256 entries: K1's launches from the rcm path at nb=256, the
    # cluster kernel in lu_kernels.cu
    launches.update({f"{n}@nb=256": v for n, v in launches256.items()})
    launches.update(comp_launches)
    launches.update(probe_launches)
    launches.update(xla_launches)
    launches.update(wide_launches)
    launches[f"getrf_with_inverses@nb={FLOW_PATH_NB}"] = flow_launches
    wide = (*xla_launches, f"getrf_with_inverses@nb={FLOW_PATH_NB}")
    stores = tuple(wide_kernels)

    def source(n):
        base = n.split("@")[0]
        if "@" not in n or base in COMPRESSED:
            return SOURCE.get(base, SRC)
        return SOURCE_WIDE if n in wide else SOURCE_256.get(base, SRC)

    out = {"kernels": [
        dict(name=n, route="cuda", source=source(n),
             replaces=REPLACES[n.split("@")[0]], launches=launches[n],
             **kernels[n])
        for n in (*DENSE, *(f"{r}@nb=256" for r in DENSE), *COMPRESSED,
                  *PROBES, *wide, *stores)]}
    # K1's launches a rank on the multi-device paths (dist_phase (b)),
    # and the panel route's (its main path, panel_phase (a)) beside the
    # kernels it runs
    out["kernels"][0]["dist_launches"] = {
        lab: v["k1_launches_per_rank"] for lab, v in dist_res.items()
        if isinstance(v, dict) and "k1_launches_per_rank" in v}
    for k in out["kernels"]:
        if k["name"] in ("getrf_with_inverses", "mega_factorize",
                         "decompress_tiles", "compress_tiles"):
            k["panel_launches"] = panel_path[k["name"]]
        if k["name"] == "getrf_with_inverses@nb=512":
            # K1's launches on the compressed path at nb=512 as well
            k["compressed_launches"] = launches[
                "getrf_with_inverses@nb=512 compressed"]
        # K1's launches on the superfused path at its nb
        for nb, n in sup_launches.items():
            if k["name"] == ("getrf_with_inverses" if nb == 128
                             else f"getrf_with_inverses@nb={nb}"):
                k["superfused_launches"] = n
    detail["kernels"] = out["kernels"]
    detail["seconds_after_build_start"] = time.perf_counter() - t_start
    od = ROOT / "pangulu_tpu_torch" / "_build"
    od.mkdir(parents=True, exist_ok=True)
    (od / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    detail["retraced"] = RETRACED
    print(json.dumps({"retraced": RETRACED}))
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
