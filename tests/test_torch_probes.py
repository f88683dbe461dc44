"""The TPU probes P5 (tools/exp_overlap.py), P4 (tools/exp_scan_multi.py)
and P3 (tools/exp_batched_scan.py newton_loop) against the plain
versions of the port (``kernels_torch.scan_overlap``, ``scan_multi``,
``newton_loop``), on the CPU, on the same numpy inputs
(``testing.probe_inputs`` / ``newton_inputs``).

Tolerances (errors are max |port - probe|, relative to max |probe|):
  * P5 and P4 without products: rtol 1e-5 / atol 1e-5.  The plain scan
    rounds its update once (``kernels_torch.fma_f32``), as XLA's CPU
    backend contracts the probe's; so these agree bit for bit here, and
    1e-5 leaves room for another division or contraction;
  * with the chain of products: rtol 1e-4 (torch's and XLA's float32
    matrix products sum in other orders, over up to 256 dependent
    products);
  * P3: 1e-5 (float32 products of the probe's unit lower triangles, and
    of a general member), at the probe's steps and at truncated counts;
  * ``fma_f32`` against exact rational arithmetic: correctly rounded.
The JAX probes run in interpret mode on the CPU: P4 and P5 by
themselves, P3 by a monkeypatched ``pallas_call``.  They read their step
count from a module constant, which is set with monkeypatch, and their
jitted ``run`` is cleared around it (it keeps the count it traced).
P4 and P5 take ``lax.rem`` of their int32 loop index, so they run with
64-bit types off (the suite's conftest turns them on).
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.testing import (newton_inputs, newton_mixed_inputs,
                                       probe_inputs)

SCAN_TOL = (1e-5, 1e-5)   # rtol (of max |probe|), atol
DOT_RTOL = 1e-4
NEWTON_TOL = 1e-5


def _close(got: torch.Tensor, want, rtol: float, atol: float = 0.0):
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.double().numpy() - want).max())
    assert np.isfinite(got.numpy()).all()
    assert err <= atol + rtol * np.abs(want).max(), (err, rtol, atol)


@pytest.fixture
def steps_of(monkeypatch):
    """Set a probe module's STEPS, its jitted run cleared before and
    after."""
    used = []

    def set_steps(module, steps):
        monkeypatch.setattr(module, "STEPS", steps)
        module.run.clear_cache()
        used.append(module)

    yield set_steps
    for module in used:
        module.run.clear_cache()


@pytest.mark.parametrize("steps", [128, 256])
@pytest.mark.parametrize("mode", kt.OVERLAP_MODES)
def test_scan_overlap_matches_tpu_probe(steps_of, mode, steps):
    """P5 in each mode ("split" against the probe's "both": the same
    function)."""
    import tools.exp_overlap as probe

    steps_of(probe, steps)
    a, b = probe_inputs(seed=steps)
    with jax.enable_x64(False):
        want = probe.run(jnp.asarray(a), jnp.asarray(b),
                         "both" if mode == "split" else mode)
    got = kt.scan_overlap(torch.from_numpy(a), torch.from_numpy(b), mode,
                          steps)
    _close(got, want, *((DOT_RTOL, 0.0) if mode != "scan" else SCAN_TOL))


@pytest.mark.parametrize("steps", [128, 256])
@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_scan_multi_matches_tpu_probe(steps_of, q, with_dot, steps):
    import tools.exp_scan_multi as probe

    steps_of(probe, steps)
    a, b = probe_inputs(seed=q)
    with jax.enable_x64(False):
        want = probe.run(jnp.asarray(a), jnp.asarray(b), q, with_dot)
    got = kt.scan_multi(torch.from_numpy(a), torch.from_numpy(b), q,
                        with_dot, steps)
    _close(got, want, *((DOT_RTOL, 0.0) if with_dot else SCAN_TOL))


@pytest.mark.parametrize("g,nb", [(4, 16), (2, 128)])
def test_newton_loop_matches_tpu_probe(monkeypatch, g, nb):
    """P3 on the probe's unit lower triangles, its steps = ceil(log2 nb)
    - 1 (which make the result the inverse)."""
    import tools.exp_batched_scan as probe

    real = probe.pl.pallas_call
    monkeypatch.setattr(probe.pl, "pallas_call", lambda *a, **kw: real(
        *a, **{**kw, "interpret": True}))
    lm = newton_inputs(g, nb, seed=nb)
    steps = kt.newton_steps(nb)
    want = probe.newton_loop(jnp.asarray(lm), g=g, nb=nb, steps=steps)
    got = kt.newton_loop(torch.from_numpy(lm), steps)
    _close(got, want, NEWTON_TOL)
    if nb == 16:
        # the inverse; at nb = 128 these triangles' inverses reach ~1e13
        # and a float64 inverse by another method is ~2e-3 from them
        _close(got, np.linalg.inv(lm.astype(np.float64)), NEWTON_TOL)


@pytest.mark.parametrize("g,nb,steps,mixed", [
    (4, 16, 0, False), (4, 16, 1, False), (4, 16, 2, False),
    (2, 128, 2, False), (4, 16, 2, True), (2, 128, 2, True)])
def test_newton_loop_truncated_matches_tpu_probe(monkeypatch, g, nb, steps,
                                                 mixed):
    """P3 below the steps that make it the inverse (0: X = 2I - L; the
    truncated series), and on a batch whose member 1 is a general matrix
    (testing.newton_mixed_inputs): the function of every steps and every
    member, which the CUDA kernel's triangle skip must not change."""
    import tools.exp_batched_scan as probe

    real = probe.pl.pallas_call
    monkeypatch.setattr(probe.pl, "pallas_call", lambda *a, **kw: real(
        *a, **{**kw, "interpret": True}))
    lm = (newton_mixed_inputs if mixed else newton_inputs)(g, nb, seed=nb)
    want = probe.newton_loop(jnp.asarray(lm), g=g, nb=nb, steps=steps)
    got = kt.newton_loop(torch.from_numpy(lm), steps)
    _close(got, want, NEWTON_TOL)
    if mixed:
        assert np.triu(lm[1], 1).any() and not np.triu(lm[0], 1).any()


def test_fma_f32_rounds_once():
    """fma_f32 is the correctly rounded c + a b on random operands and on
    cases where rounding the product first and the sum next differs."""
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.standard_normal(4000)
                                .astype(np.float32)) for _ in range(3))
    # c = -RN(a b): the exact sum is the product's rounding error
    c[:1000] = -(a[:1000] * b[:1000])
    got = kt.fma_f32(c, a, b)
    assert (got != c + a * b).sum() > 1000
    frac = fractions.Fraction
    for i in range(0, 4000, 7):
        exact = frac(float(c[i])) + frac(float(a[i])) * frac(float(b[i]))
        g = np.float32(got[i])
        err = abs(frac(float(g)) - exact)
        for nxt in (np.nextafter(g, np.float32(-np.inf)),
                    np.nextafter(g, np.float32(np.inf))):
            assert err <= abs(frac(float(nxt)) - exact), i


def test_probe_scan_step_leaves_row_and_column():
    """The scan step updates only rows and columns past k, and a tiny
    pivot becomes +tol."""
    f = torch.from_numpy(probe_inputs(seed=5, nb=16)[0])
    f[3, 3] = -1e-9
    g = kt.probe_scan_step(f, 3)
    assert torch.equal(g[:4], f[:4]) and torch.equal(g[:, :4], f[:, :4])
    want = f[4:, 4:].double() - (f[4:, 3:4].double() / 1e-8) \
        * f[3:4, 4:].double()
    torch.testing.assert_close(g[4:, 4:].double(), want, rtol=1e-6,
                               atol=0)


def test_probe_wrappers_reject_bad_input(monkeypatch):
    """On the card path the wrappers reject what the kernels do not take
    before any launch."""
    monkeypatch.setattr(kernels_cuda, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kernels_cuda, "library",
                        lambda: pytest.fail("reached the kernel launch"))
    a, b = (torch.from_numpy(x) for x in probe_inputs(nb=16))
    ov, sm = kernels_cuda.scan_overlap, kernels_cuda.scan_multi
    with pytest.raises(ValueError, match=r"one shape \[nb, nb\]"):
        ov(a, b[:8], "scan", 4)
    with pytest.raises(ValueError, match=r"one shape \[nb, nb\]"):
        sm(a[None], b[None], 1, False, 4)
    with pytest.raises(TypeError, match="float32"):
        ov(a.double(), b.double(), "scan", 4)
    with pytest.raises(ValueError, match="nb <= 128"):
        ov(torch.eye(130), torch.eye(130), "both", 4)
    with pytest.raises(ValueError, match="mode must be one of"):
        ov(a, b, "interleave", 4)
    with pytest.raises(ValueError, match="q must be one of"):
        sm(a, b, 3, True, 4)
    with pytest.raises(ValueError, match="steps must be >= 0"):
        sm(a, b, 2, True, -1)
    with pytest.raises(ValueError, match="copies must be >= 1"):
        ov(a, b, "dots", 4, copies=0)
    with pytest.raises(ValueError, match="products must be one of"):
        ov(a, b, "dots", 4, products="tf32")
    with pytest.raises(ValueError, match="need the products"):
        ov(a, b, "scan", 4, products="tf32x3")
    with pytest.raises(ValueError, match="need the products"):
        sm(a, b, 2, False, 4, products="tf32x3")
    nl = kernels_cuda.newton_loop
    with pytest.raises(ValueError, match=r"\[G, nb, nb\]"):
        nl(torch.eye(4), 2)
    with pytest.raises(TypeError, match="float32 or float64"):
        nl(torch.eye(4, dtype=torch.float16)[None], 2)
    with pytest.raises(ValueError, match="nb <= 256"):
        nl(torch.eye(512)[None], 2)
    with pytest.raises(ValueError, match="blocks must be >= 1"):
        nl(torch.eye(4)[None], 2, blocks=0)


def test_probe_cluster_sizes_checked(monkeypatch):
    """P4's and P3's cluster sizes: one of CLUSTER_SIZES (a 128 x 128
    matrix in 4 x C / 4 blocks), checked before any launch; P3's blocks
    (its cluster size) at most 16 on either device, and its kernel takes
    nb <= 128 only."""
    a, b = (torch.from_numpy(x) for x in probe_inputs(nb=16))
    lm = torch.from_numpy(newton_inputs(2, 16))
    with pytest.raises(ValueError, match="cluster size must be one of"):
        kernels_cuda.scan_multi(a, b, 2, True, 4, cluster=3)
    with pytest.raises(ValueError, match="must be <= 16"):
        kernels_cuda.newton_loop(lm, 2, blocks=17)
    monkeypatch.setattr(kernels_cuda, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kernels_cuda, "library",
                        lambda: pytest.fail("reached the kernel launch"))
    with pytest.raises(ValueError, match="cluster size must be one of"):
        kernels_cuda.newton_loop(lm, 2, blocks=3)
    with pytest.raises(ValueError, match="nb <= 128"):
        kernels_cuda.newton_loop(torch.eye(200)[None], 2)


@pytest.mark.parametrize("copies", [1, 3])
def test_probe_wrappers_on_cpu_run_the_plain_versions(copies):
    """A CPU tensor goes to the plain version; copies repeat it."""
    a, b = (torch.from_numpy(x) for x in probe_inputs(nb=32))
    want = kt.scan_overlap(a, b, "both", 40)
    got = kernels_cuda.scan_overlap(a, b, "split", 40, copies=copies)
    want_multi = kt.scan_multi(a, b, 2, True, 40)
    got_multi = kernels_cuda.scan_multi(a, b, 2, True, 40, copies=copies,
                                        products="tf32x3")
    if copies == 1:
        assert torch.equal(got, want) and torch.equal(got_multi, want_multi)
    else:
        assert torch.equal(got, want.expand(copies, 32, 32))
        assert torch.equal(got_multi, want_multi.expand(copies, 32, 32))
    lm = torch.from_numpy(newton_inputs(3, 16))
    assert torch.equal(kernels_cuda.newton_loop(lm, 3, blocks=copies),
                       kt.newton_loop(lm, 3))

