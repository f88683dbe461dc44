"""The port's examples (pangulu_tpu_torch/examples) and its out-of-core
demo (pangulu_tpu_torch/tools/demo_outofcore.py) on the CPU, held
against the JAX package.

- Each example's ``main(["--device", "cpu"])`` at the JAX example's own
  size (examples/run_*.py) keeps that example's asserts.  trefethen's
  and refactorize's solutions agree with the JAX package's API on the
  same matrix and options within 1e-12 relative in the 2-norm (r64).
  The circuit case is held by its store bytes, equal to the JAX
  package's, and by its residual, within 10x of the JAX package's: its
  matrices are near singular (cond ~1e16), so x is not compared.
- The demo at --nx 8 --nb 16: its tiles and dense bytes equal
  ``pangulu_tpu.api.analyze``'s for the same matrix and options,
  ``--analyze`` stops before gstrf, and ``--device-gib`` on the CPU
  raises.
"""

import importlib

import numpy as np
import pytest

import pangulu_tpu.api as japi
import pangulu_tpu.models as jm
from pangulu_tpu.io.mmio import generated_rhs as j_rhs
from pangulu_tpu_torch.examples import (run_circuit_compressed,
                                        run_refactorize, run_trefethen)
from pangulu_tpu_torch.utils.perf import residual_norm

demo = importlib.import_module("pangulu_tpu_torch.tools.demo_outofcore")

CPU = ["--device", "cpu"]


def _rel(x, ref) -> float:
    """||x - ref||_2 / ||ref||_2.  By the largest entry instead, the
    refactorize steps differ by up to 1.6e-12 (step 1, cond ~1.7e3),
    where each package lies within 1.0e-12 of scipy's spsolve."""
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def test_trefethen_example_matches_jax(capsys):
    got = run_trefethen.main(CPU)
    assert got["handle"].perf.kernels["engine"] == "mega"
    a = jm.trefethen(20)
    x = japi.Solver(a, japi.InitOptions(nb=10, dtype="r64",
                                        check=True)).solve(j_rhs(a))
    assert got["residual"] < 1e-12
    assert _rel(got["x"], x) <= 1e-12
    assert "||Ax-b||/||b||" in capsys.readouterr().out


def test_refactorize_example_matches_jax():
    """The JAX example's loop (examples/run_refactorize.py) on the JAX
    API: the same perturbations from the same seed, each step's x within
    1e-12 of the port's (relative, 2-norm)."""
    got = run_refactorize.main(CPU)
    a = jm.poisson2d(40)
    s = a.to_scipy()
    h = japi.init(a, japi.InitOptions(nb=32, dtype="r64"))
    rng = np.random.default_rng(0)
    assert len(got["x"]) == run_refactorize.STEPS
    for step, xp in enumerate(got["x"]):
        b = np.asarray(s @ np.ones(a.n))
        japi.gstrf(h)
        x = japi.gstrs(h, b)
        assert got["residual"][step] < 1e-10
        assert _rel(xp, x) <= 1e-12, step
        s = s.copy()
        s.data = s.data * (1.0 + 0.05 * rng.standard_normal(s.nnz))
        japi.update_values(h, s)


def test_circuit_compressed_example_matches_jax():
    got = run_circuit_compressed.main(CPU)
    a = jm.circuit(3000, seed=4)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    h = japi.init(a, japi.InitOptions(nb=32, dtype="r64", ordering="mindeg",
                                      tile_storage="compressed"))
    x = japi.gssv(h, b)
    st = h.factor_tiles
    assert (got["compressed_bytes"], got["dense_bytes"]) == (
        st.compressed_bytes, st.dense_bytes)
    want = residual_norm(a.to_scipy(), x, b)
    assert got["residual"] <= 10 * want


def _jax_analyze(nx, nb):
    return japi.analyze(jm.poisson3d(nx), japi.InitOptions(
        nb=nb, dtype="r32", ordering="nd", tile_storage="compressed"))


@pytest.mark.parametrize("analyze_only", [False, True])
def test_demo_sizes_match_jax_analyze(capsys, monkeypatch, analyze_only):
    """The demo's tiles and dense store bytes are analyze's; with
    --analyze it stops before gstrf (which would raise here), else it
    factors and solves within the JAX demo's gate."""
    if analyze_only:
        def no_gstrf(h):
            raise AssertionError("--analyze ran gstrf")

        monkeypatch.setattr(demo, "gstrf", no_gstrf)
    got = demo.main(["--nx", "8", "--nb", "16", *CPU]
                    + (["--analyze"] if analyze_only else []))
    want = _jax_analyze(8, 16)
    assert (got["tiles"], got["dense_bytes"]) == (want["tiles"],
                                                  want["factor_hbm_bytes"])
    out = capsys.readouterr().out
    assert f"{want['tiles']} tiles, dense store" in out
    assert out.strip().splitlines()[-1].startswith('{"demo_outofcore"')
    if analyze_only:
        assert "residual" not in got and "gstrs" not in out
    else:
        assert got["residual"] < demo.GATE and got["engine"] == "CompressedLU"


def test_demo_device_gib_on_cpu_raises():
    with pytest.raises(ValueError, match="--device-gib"):
        demo.main(["--nx", "4", "--nb", "16", "--device-gib", "1", *CPU])
