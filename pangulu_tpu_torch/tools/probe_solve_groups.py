#!/usr/bin/env python3
"""Probe of K5's design (csrc/lu_kernels.cu ``group_sweep_kernel``) on
one NVIDIA GPU.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_solve_groups.py [--out F]

Each source variant (VARIANTS: the shipped ``csrc/`` with one textual
edit, all built at once as ``probe_products.py`` builds its own) runs
each of two step schedules: ``bundled`` (the kernel's,
``schedule.group_solve_steps``: one barrier a super-level) and
``two_phase`` (:func:`two_phase_steps`: a group's members, a barrier,
its rows, a barrier).  For each pair, on poisson3d(32)
nb=128 r32 nd with the factors of the shipped K4: K5's device ms per
solve at 1 and 4 right-hand sides (back-to-back calls queued behind a
device sleep, median of ROUNDS rounds taken in turns over all pairs),
its largest error against the plain version, whether its result is the
shipped bundled one bit for bit, the cooperative grid, and from one
traced solve the device busy ms, host wall ms and idle share; and per
variant ptxas's registers and spills of ``group_sweep_kernel``.  It
prints the card's name and power limit, a line per pair, then one JSON
line.  Above nb = 128, K5 runs on thread block clusters: its probe is
``probe_solve_sweeps.py``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# name -> (what the edit does, [(file in csrc/, old text, new text)])
VARIANTS = {
    "shipped": ("the shipped sources", []),
    "no_prefetch": (
        "no L2 prefetch of the next step's tiles and inverses",
        [("lu_kernels.cu", "np = ne + after.x - nxt.x;", "np = 0;")]),
    "unroll1": (
        "the update's column loop not unrolled (fewer loads in flight, "
        "fewer registers)",
        [("lu_kernels.cu",
          "#pragma unroll 4\n  for (int j = lane; j < nb; j += 32) {\n"
          "    const T xj = __ldcg(x + j);",
          "#pragma unroll 1\n  for (int j = lane; j < nb; j += 32) {\n"
          "    const T xj = __ldcg(x + j);")]),
    "threads512": (
        "blocks of 512 threads (16 warps, 8 rows a warp) in place of 1024",
        [("lu_kernels.cu", "constexpr int kSolveThreads = 1024;",
          "constexpr int kSolveThreads = 512;")]),
    "no_updates": (
        "timing only, results wrong: no panel products (the entry loop "
        "runs no entry)",
        [("lu_kernels.cu", "for (int e = d.z; e < d.w; ++e) {",
          "for (int e = d.z; e < d.z; ++e) {")]),
    "no_inverse": (
        "timing only, results wrong: no inverse product",
        [("lu_kernels.cu",
          "    tile_matvec<T, NB, false>(inv, v, xd + (size_t)d.x * nb, nb);\n",
          "")]),
    "barriers_only": (
        "timing only, results wrong: neither products nor inverses, so "
        "left are the steps, their barriers, the prefetches and x's "
        "loads and stores",
        [("lu_kernels.cu", "for (int e = d.z; e < d.w; ++e) {",
          "for (int e = d.z; e < d.z; ++e) {"),
         ("lu_kernels.cu",
          "    tile_matvec<T, NB, false>(inv, v, xd + (size_t)d.x * nb, nb);\n",
          "")]),
    "old_after_sum": (
        "an item's old values of x read after its entries' sum, not "
        "before (no old[] live across the entry loop)",
        [("lu_kernels.cu",
          "      old[q] = lane == 0 && i < nb ? __ldcg(row + i) : T(0);\n",
          ""),
         ("lu_kernels.cu",
          "        const T val = old[q] - warp_sum(acc[q]);",
          "        const T val = (lane == 0 ? __ldcg(row + i) : T(0)) -\n"
          "                      warp_sum(acc[q]);")]),
}
SCHEDULES = ("bundled", "two_phase")
ROUNDS = 5
CALLS = 20   # back-to-back solves a timing


def two_phase_steps(h: dict, sweep: str, bl: int) -> dict:
    """Step tables of one sweep of ``group_solve_tables`` ``h`` in the
    layout of ``schedule.group_solve_steps``, two steps a group: its
    members' inverse items, then its rows' update items."""
    from pangulu_tpu_torch.schedule import group_row_csr
    tab = h["ltab"] if sweep == "l" else h["uctab"]
    csr, kseg = group_row_csr(h, sweep), h["kseg_tab"]
    ng = int(h["ngroups"])
    step, item, ent = [[0, 0]], [], []
    for g in (range(ng) if sweep == "l" else range(ng - 1, -1, -1)):
        mem = [(int(k), 1, []) for k in kseg[g][kseg[g] != bl]]
        rows = []
        for d in range(csr["off"][g], csr["off"][g] + csr["cnt"][g]):
            t = csr["ent"][csr["ptr"][d]:csr["ptr"][d + 1]]
            rows.append((int(csr["key"][d]), 0,
                         np.stack([tab[g, 0, t], kseg[g, tab[g, 2, t]]],
                                  1).tolist()))
        for s in (mem, rows):
            if s:
                for k, inv, e in s:
                    item.append([k, inv, len(ent), len(ent) + len(e)])
                    ent.extend(e)
                step.append([len(item), len(ent)])
    step = np.asarray(step, np.int32)
    return dict(step=step, item=np.asarray(item, np.int32).reshape(-1, 4),
                ent=np.asarray(ent, np.int32).reshape(-1, 2),
                width=int(np.diff(step[:, 0]).max(initial=0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    nb = 128
    names, scheds = tuple(VARIANTS), SCHEDULES
    if not torch.cuda.is_available():
        print("probe_solve_groups: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.tools.probe_products import build_all, use_variant

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    dev = torch.device("cuda", 0)
    dirs = build_all({n: VARIANTS[n] for n in names})
    libs = {name: use_variant(*d) for name, d in dirs.items()}
    use_variant(*dirs["shipped"])
    h = init(poisson3d(32), InitOptions(nb=nb, dtype="r32", ordering="nd",
                                        device="cuda"))
    nt, sch = h.blocked.num_tiles, h.schedule
    bl = sch.block_length
    ftab = kt.KernelTables.build(
        sch.group_mega_tables(nt, uch=kt.mega_uch(nb)), dev)
    tiles, invs = kc.mega_factorize_groups(
        h.blocked.device_tiles(dev), ftab, nb=nb, bl=bl,
        tol=kt.DEFAULT_TOL[torch.float32])
    tabs = {s: kt.KernelTables.build(sch.group_solve_tables(nt), dev)
            for s in scheds}
    # the two-phase steps go where the kernel path caches its own, in
    # the view of kernels_cuda.solve_steps_view
    if "two_phase" in tabs:
        host = {f"{sw}_{k}": v for sw in ("l", "uc") for k, v in
                two_phase_steps(tabs["two_phase"].host, sw, bl).items()}
        tabs["two_phase"].views[f"solve_steps_{bl}_{nt}"] = (host, {
            k: torch.as_tensor(v, device=dev) for k, v in host.items()
            if not k.endswith("_width")})
        if kc.solve_steps_view(tabs["two_phase"], bl, nt, dev)[0] \
                is not host:
            raise RuntimeError("the kernel path does not read the "
                               "two-phase steps")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((4, bl + 1, nb)),
                        dtype=torch.float32, device=dev)
    xs = {1: x[:1].contiguous(), 4: x}
    pairs = [(v, s) for v in names for s in scheds]

    def solve(pair, r):
        return kc.mega_solve_groups(xs[r], tiles, invs, tabs[pair[1]],
                                    nb=nb, bl=bl)

    plain = kt.mega_solve_groups(xs[1], tiles, invs, tabs["bundled"],
                                 nb=nb, bl=bl)
    ref = solve(("shipped", "bundled"), 1)
    res = {p: {} for p in pairs}
    for p in pairs:
        use_variant(*dirs[p[0]])
        got = solve(p, 1)
        res[p].update(
            max_abs_err=float((got.double() - plain.double()).abs().max()),
            same_bits_as_shipped_bundled=bool(torch.equal(got, ref)),
            grid=dict(kc.GRID["mega_solve_groups"]))
        tr = cs.profile(lambda _: solve(p, 1))
        res[p].update(wall_ms=tr["wall_ms"], busy_ms=tr["busy_ms"],
                      idle_share=tr["idle_share"],
                      kernels={n: k for n, k in tr["kernels"].items()
                               if "group_sweep_kernel" in n})
    times = {(p, r): [] for p in pairs for r in xs}
    for _ in range(ROUNDS):
        for p in pairs:
            use_variant(*dirs[p[0]])
            for r in xs:
                times[(p, r)].append(cs.device_ms(lambda: solve(p, r),
                                                  n=CALLS, reps=1))
    out = {}
    for p in pairs:
        for r in xs:
            res[p][f"ms_{r}rhs"] = statistics.median(times[(p, r)])
            res[p][f"ms_{r}rhs_each"] = times[(p, r)]
        # the instances this nb takes
        res[p]["ptxas"] = {}
        for k, i in cs.ptxas_by_kernel(libs[p[0]].log).items():
            lab = cs.kernel_label(k)
            if lab and lab[0] == "group_sweep_kernel" and lab[2] == nb:
                res[p]["ptxas"][lab[1]] = [i.get("registers"),
                                           i.get("spill_bytes")]
        res[p]["edit"] = VARIANTS[p[0]][0]
        res[p]["nb"] = nb
        out[f"{p[0]}/{p[1]}"] = res[p]
        print(f"{p[0]}/{p[1]}: {json.dumps(res[p])}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
