"""The precision scheme of the CUDA kernels' tensor-core products,
emulated on the CPU: TF32 rounding, the three-term (3xTF32) product,
and the plain factorizations run with that product against the JAX
package's Pallas kernels.

The CUDA kernels form every f32 panel and Schur product in 3xTF32 on
tensor cores (``csrc/tile_gemm.cuh``): each operand splits into ``big =
tf32(x)`` and ``small = tf32(x - big)`` and the product sums small·big,
big·small and big·big.  ``kernels_torch.tf32x3_matmul`` forms the same
three terms as f32 matmuls of TF32 values; it emulates the split, not
the tensor core's rounding of its own sums (that is held on the card by
tests/test_torch_gpu.py and chip_smoke.py).

Tolerances are the JAX package's contract (ROADMAP.md "Tolerances"):
chain tiles and inverses 1e-5, grouped 2e-4, gstrf residual
``||L(U·1) - A·1|| / ||A·1||`` below 1e-5.  A one-term TF32 product
(``tf32(a) @ tf32(b)``, what plain TF32 inputs would give) breaks both
at this size: it misses the 1e-5 tile tolerance on 128 x 128 tiles, and
the poisson2d(12) nb=16 factorization's residual is ~4e-4 with it (rcm;
~3e-4 nd) against ~3e-7 with 3xTF32 or f32, so the residual check
below catches plain TF32 as well as the tile check does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu_torch as pt
from pangulu_tpu.api import InitOptions as JOpts, init as jinit
from pangulu_tpu.models import poisson2d as jpoisson2d
from pangulu_tpu.ops import kernels_pallas
from pangulu_tpu_torch.blocks import gather_factor
from pangulu_tpu_torch.models import poisson2d
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.utils.perf import factorization_residual

NB = 16
TOL = {"rcm": dict(rtol=1e-5, atol=1e-5), "nd": dict(rtol=2e-4, atol=2e-4)}


def _one_term(a, b):
    """Plain TF32 inputs: both operands rounded once, one product."""
    return torch.matmul(kt.tf32_round(a), kt.tf32_round(b))


MM = {"f32": torch.matmul, "tf32x3": kt.tf32x3_matmul, "tf32": _one_term}


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("x_bits,want_bits", [
    (0x3F800000, 0x3F800000),   # 1.0 is TF32 already
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),   # the same tie, negative
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3F803000, 0x3F804000),   # a tie above an odd last bit
    (0x3FFFFFFF, 0x40000000),   # 2 - 2^-23: up into the next binade
    (0x3FFFF000, 0x40000000),   # 2 - 2^-12: a tie, up to 2
    (0xC0FFEFFF, 0xC0FFE000),   # negative, below the tie: toward 0
    (0x00001000, 0x00002000),   # a subnormal tie, away from zero
    (0x00000FFF, 0x00000000),   # a subnormal below it: to zero
    (0x7F800000, 0x7F800000),   # +inf
    (0xFF800000, 0xFF800000),   # -inf
])
def test_tf32_round_bit_exact(x_bits, want_bits):
    x = torch.tensor([_f32(x_bits)], dtype=torch.float32)
    got = kt.tf32_round(x).view(torch.int32).numpy().view(np.uint32)[0]
    assert got == want_bits, f"{got:#010x} != {want_bits:#010x}"


def test_tf32_round_nan_passes():
    x = torch.tensor([float("nan"), _f32(0x7F800001)], dtype=torch.float32)
    assert torch.equal(kt.tf32_round(x).view(torch.int32),
                       x.view(torch.int32))


@pytest.mark.parametrize("scheme", ["tf32x3", "tf32"])
def test_tile_product_accuracy(scheme):
    """Seeded 128 x 128 tiles against the f64 product: 3xTF32 within
    4x the error of an f32 matmul; one TF32 term outside the 1e-5 tile
    tolerance."""
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((4, 128, 128)).astype(np.float32)
            for _ in range(2))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    f32_err = np.abs(torch.matmul(ta, tb).numpy() - ref).max()
    got = MM[scheme](ta, tb).numpy()
    err = np.abs(got - ref).max()
    if scheme == "tf32x3":
        assert err <= 4 * f32_err
    else:
        assert err > 4 * f32_err
        assert not np.allclose(got, ref, rtol=1e-5, atol=1e-5)


def _tables(sch, nt, ordering, mod):
    t = (sch.group_mega_tables(nt, gmax=16) if ordering == "nd"
         else sch.mega_tables(nt))
    if mod is jnp:
        return {k: (v if isinstance(v, int) else jnp.asarray(v))
                for k, v in t.items()}
    return kt.KernelTables.build(t, "cpu")


def _pallas(ordering):
    """The JAX Pallas factorization (interpret mode off the TPU) of
    poisson2d(12), nb=16, r32, as tests/test_torch_kernels.py and
    tests/test_torch_group.py run it."""
    hj = jinit(jpoisson2d(12), JOpts(nb=NB, dtype="r32", ordering=ordering))
    t = _tables(hj.schedule, hj.blocked.num_tiles, ordering, jnp)
    bl = hj.schedule.block_length
    if ordering == "nd":
        return kernels_pallas.mega_factorize_groups(
            hj.blocked.device_tiles(), t["gs_tab"], t["nup_tab"],
            t["gdiag_tab"], t["glev_tab"], t["gloff_tab"], t["guoff_tab"],
            t["lid_tab"], t["uid_tab"], t["udst_tab"], t["udl_tab"],
            t["udu_tab"], nb=NB, tol=1e-8, ng=t["ngroups"],
            gmax=t["gmax"], pch=t["pch"], uch=t["uch"], bl=bl)
    return kernels_pallas.mega_factorize(
        hj.blocked.device_tiles(), t["diag_tab"], t["nl_tab"], t["nu_tab"],
        t["nup_tab"], t["lid_tab"], t["uid_tab"], t["udst_tab"],
        t["udl_tab"], t["udu_tab"], nb=NB, tol=1e-8, bl=bl, pch=t["pch"],
        uch=t["uch"])


def _port(ordering, mm):
    """(handle, tiles, invs) of the plain factorization with ``mm``."""
    h = pt.init(poisson2d(12), pt.InitOptions(nb=NB, dtype="r32",
                                              ordering=ordering,
                                              device="cpu"))
    f = kt.mega_factorize_groups if ordering == "nd" else kt.mega_factorize
    tiles, invs = f(h.blocked.device_tiles("cpu"),
                    _tables(h.schedule, h.blocked.num_tiles, ordering, kt),
                    nb=NB, tol=1e-8, bl=h.schedule.block_length, mm=mm)
    return h, tiles, invs


def _residual(h, tiles):
    lmat, umat = gather_factor(h.blocked, tiles.numpy())
    return factorization_residual(h.reordering.reordered.to_scipy(), lmat,
                                  umat)


@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_tf32x3_factorization_vs_pallas(ordering):
    """The chain (rcm) and grouped (nd) plain factorizations with the
    3xTF32 product against the Pallas kernels, and their residual."""
    tj, ij = _pallas(ordering)
    h, tp, ip = _port(ordering, kt.tf32x3_matmul)
    nt = h.blocked.num_tiles
    np.testing.assert_allclose(tp[:nt].numpy(), np.asarray(tj)[:nt],
                               **TOL[ordering])
    np.testing.assert_allclose(ip.numpy(), np.asarray(ij), **TOL[ordering])
    assert _residual(h, tp) < 1e-5


@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_one_term_tf32_breaks_the_residual(ordering):
    """Plain TF32 products: the gstrf residual leaves the 1e-5 limit."""
    h, tp, _ = _port(ordering, _one_term)
    assert _residual(h, tp) > 1e-5
