"""The port imports without JAX, and never falls back silently.

- Importing every module of pangulu_tpu_torch (the multi-device
  pangulu_tpu_torch.parallel and the examples among them), the probes
  of pangulu_tpu_torch/tools for P3-P5, its multi-process tools
  run_multiprocess and probe_dist and its out-of-core demo
  demo_outofcore, loads no jax module and nothing of
  the JAX package (checked in a fresh interpreter, since this
  test process has JAX loaded by conftest.py), and needs neither triton
  nor nvcc.
- device="cuda" without a GPU raises; a CUDA-tensor kernel call that
  cannot build its library raises; mesh_shape without a process group
  raises ValueError, and profile_dir runs; nb above K2-K5's limit
  raises in their wrappers, and the compressed store and a mesh run at
  nb > 256 and with native complex tiles.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
from pangulu_tpu_torch.models import poisson2d
from pangulu_tpu_torch.ops import build, kernels_cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import pangulu_tpu_torch
for m in pkgutil.walk_packages(pangulu_tpu_torch.__path__,
                               "pangulu_tpu_torch."):
    importlib.import_module(m.name)
# the H100 probes of the TPU probes P3-P5, of K1 for wide tiles and of
# the compressed store's P6 and P2, their variants' builds, and the
# out-of-core demo (tools/ is no package)
for m in ("probe_overlap", "probe_scan_multi", "probe_newton_loop",
          "probe_clusters", "run_multiprocess", "probe_dist",
          "probe_k1_wide", "probe_p6", "probe_p2", "variants",
          "demo_outofcore"):
    importlib.import_module("pangulu_tpu_torch.tools." + m)
for m in ("pangulu_tpu_torch.io.mmio", "pangulu_tpu_torch.cli",
          "pangulu_tpu_torch.__main__", "pangulu_tpu_torch.compressed",
          "pangulu_tpu_torch.outofcore", "pangulu_tpu_torch.parallel.mesh",
          "pangulu_tpu_torch.parallel.multihost",
          "pangulu_tpu_torch.parallel.dist_numeric",
          "pangulu_tpu_torch.parallel.dist_sptrsv",
          "pangulu_tpu_torch.utils.perf",
          "pangulu_tpu_torch.examples.run_trefethen",
          "pangulu_tpu_torch.examples.run_refactorize",
          "pangulu_tpu_torch.examples.run_circuit_compressed"):
    assert m in sys.modules, m
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pangulu_tpu",
                                    "triton"))
print(len([m for m in sys.modules if m.startswith("pangulu_tpu_torch")]))
assert not bad, bad
"""


def test_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20   # every module imported


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(poisson2d(4), InitOptions(nb=4, device="cuda"))


def test_default_device_is_cuda():
    assert InitOptions().device == "cuda"


@pytest.mark.parametrize("engine", ["LUFactorizer", "TriangularSolver",
                                    "CompressedLU", "PanelLU"])
def test_engines_default_to_cuda(monkeypatch, engine):
    """The engines a user may build directly run on the card unless asked
    for the CPU: without device= and without a GPU they raise, naming
    device='cpu'."""
    from pangulu_tpu_torch.compressed import CompressedLU
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.outofcore import PanelLU
    from pangulu_tpu_torch.sptrsv import TriangularSolver

    h = init(poisson2d(4), InitOptions(nb=4, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"LUFactorizer": lambda: LUFactorizer(h.blocked, h.schedule),
            "TriangularSolver": lambda: TriangularSolver(h.blocked,
                                                         h.schedule),
            "CompressedLU": lambda: CompressedLU(
                h.blocked, h.schedule, h.reordering.reordered),
            "PanelLU": lambda: PanelLU(
                h.blocked, h.schedule, h.reordering.reordered)}[engine]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_cuda_call_without_library_raises(monkeypatch, tmp_path):
    """A tensor routed to the kernel with no library and no nvcc must
    raise — never run the plain version instead."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels_cuda, "_library", None)
    monkeypatch.setattr(kernels_cuda, "_on_cuda", lambda t: True)
    a = torch.eye(4, dtype=torch.float32)
    before = dict(kernels_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels_cuda.getrf_with_inverses(a)
    assert kernels_cuda.LAUNCHES == before


def _route_to_kernel_without_launching(monkeypatch):
    """Send CPU tensors down the kernel path, and fail if it reaches
    the library: the checks must reject the input before any launch."""
    monkeypatch.setattr(kernels_cuda, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kernels_cuda, "library",
                        lambda: pytest.fail("reached the kernel launch"))


def test_kernel_path_rejects_out_of_range_tables(monkeypatch):
    from pangulu_tpu_torch.ops.kernels_torch import MEGA_UCH, KernelTables

    _route_to_kernel_without_launching(monkeypatch)
    h = init(poisson2d(8), InitOptions(nb=16, dtype="r32", ordering="rcm",
                                       device="cpu"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    tiles = h.blocked.device_tiles("cpu")
    t = h.schedule.mega_tables(nt, uch=MEGA_UCH)
    t["lid_tab"][0, 0] = nt + 5
    with pytest.raises(ValueError, match="lid_tab has entries outside"):
        kernels_cuda.mega_factorize(tiles, KernelTables.build(t, "cpu"),
                                    nb=16, tol=1e-8, bl=bl)
    s = h.schedule.mega_solve_tables(nt)
    s["lrow_tab"][0, 0] = bl + 1
    x = torch.zeros((1, bl + 1, 16))
    invs = torch.zeros((bl, 2, 16, 16))
    with pytest.raises(ValueError, match="lrow_tab has entries outside"):
        kernels_cuda.mega_solve(x, tiles, invs, KernelTables.build(s, "cpu"),
                                nb=16, bl=bl)


def _break_missing_level(t, bl):
    g = int(np.argmax((t["kseg_tab"] != bl).sum(axis=1) >= 2))
    t["kseg_tab"][g, 1] = t["kseg_tab"][g, 0]      # one level twice
    return "each of the .* levels once"


def _break_row_is_member(t, bl):
    g = int(np.argmax(t["nl_tab"] > 0))
    t["ltab"][g, 1, 0] = t["kseg_tab"][g, 0]
    return "one of its own members"


def _break_row_out_of_range(t, bl):
    t["uctab"][int(np.argmax(t["nuc_tab"] > 0)), 1, 0] = bl + 1
    return r"uctab\[:, 1\] has entries outside"


@pytest.mark.parametrize("breaker", [_break_missing_level,
                                     _break_row_is_member,
                                     _break_row_out_of_range])
def test_kernel_path_rejects_bad_group_solve_tables(monkeypatch, breaker):
    """K5's wrapper refuses, before any launch, tables whose step
    schedule would leave a segment unwritten, race a member with its own
    group's update, or index outside x."""
    from pangulu_tpu_torch.ops.kernels_torch import KernelTables

    _route_to_kernel_without_launching(monkeypatch)
    h = init(poisson2d(12), InitOptions(nb=16, dtype="r32", ordering="nd",
                                        device="cpu"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    t = h.schedule.group_solve_tables(nt)
    match = breaker(t, bl)
    x = torch.zeros((1, bl + 1, 16))
    with pytest.raises(ValueError, match=match):
        kernels_cuda.mega_solve_groups(
            x, h.blocked.device_tiles("cpu"), torch.zeros((bl, 2, 16, 16)),
            KernelTables.build(t, "cpu"), nb=16, bl=bl)


def test_kernel_path_rejects_unsupported_inputs(monkeypatch):
    _route_to_kernel_without_launching(monkeypatch)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels_cuda.getrf_with_inverses(torch.eye(4, dtype=torch.float16))
    # K1 takes nb = 512 (the wide recursion); K2's limit stays at 256
    with pytest.raises(ValueError, match="nb <= 256"):
        kernels_cuda.mega_factorize(torch.zeros((2, 512, 512)), None,
                                    nb=512, tol=1e-8, bl=1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels_cuda.getrf_with_inverses(torch.eye(8)[:, ::2][:4])


def test_other_device_raises():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu"):
        kernels_cuda.getrf_with_inverses(a)


def _runs(opts, engine):
    """init -> gstrf -> gstrs on poisson2d(6) with ``opts`` on the CPU:
    the engine taken, and x = 1 (+1i for a complex dtype) to 1e-5."""
    a = poisson2d(6)
    h = init(a, InitOptions(device="cpu", **opts))
    gstrf(h)
    assert engine is None or h.perf.kernels["engine"] == engine
    x1 = np.ones(a.n) + (1j if opts.get("dtype", "r64")[0] == "c" else 0)
    x = gstrs(h, a.to_scipy() @ x1)
    assert np.abs(x - x1).max() < 1e-5


@pytest.mark.parametrize("opts,exc,item", [
    # multi-device runs need a torch.distributed group of p·q ranks
    (dict(mesh_shape=(2, 2)), ValueError, "no process group|none exists"),
    # native complex tiles run on the compressed store (item 6 closed)
    (dict(dtype="cr32", complex_mode="native", tile_storage="compressed"),
     None, "compressed"),
    # and on a mesh, which needs the process group all the same
    (dict(dtype="cr64", complex_mode="native", mesh_shape=(2, 2)),
     ValueError, "no process group|none exists"),
    # profile_dir writes a trace of gstrf (item 7 closed; "TMP" is the
    # test's directory)
    (dict(profile_dir="TMP"), None, None),
])
def test_unported_options_raise(tmp_path, opts, exc, item):
    """What the port does not run raises, naming why; the options that
    raised until their ROADMAP item closed run (exc None: ``item`` is
    the engine, or None for any)."""
    if exc is None:
        if opts.get("profile_dir") == "TMP":
            opts = dict(opts, profile_dir=str(tmp_path))
        _runs(dict(nb=4, **opts), item)
        if "profile_dir" in opts:
            assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
        return
    with pytest.raises(exc, match=item):
        init(poisson2d(4), InitOptions(nb=4, device="cpu", **opts))


@pytest.mark.parametrize("opts", [dict(tile_storage="compressed"),
                                  dict(mesh_shape=(2, 2))])
def test_nb_above_limit_raises(opts):
    """nb > 256 runs on every store since ROADMAP Queue 1 item 5 closed:
    the compressed store factors and solves at nb = 512 (K1 for wide
    tiles as its diagonal step on the card); a mesh at nb = 512 raises
    only for want of a process group, as at any nb."""
    if "mesh_shape" in opts:
        with pytest.raises(ValueError, match="no process group|none exists"):
            init(poisson2d(4), InitOptions(nb=512, device="cpu", **opts))
        return
    _runs(dict(nb=512, **opts), "compressed")


@pytest.mark.parametrize("dtype", ["r32", "r64"])
def test_nb512_initialises_and_routes_to_fused(dtype):
    """nb = 512 initialises, and gstrf takes the fused engine (the mega
    engines stop at 256), with K1's plain version on the CPU."""
    h = init(poisson2d(30), InitOptions(nb=512, dtype=dtype, device="cpu",
                                        check=True))
    gstrf(h)
    assert h.perf.kernels["engine"] == "fused"
    assert h.perf.kernels["backend"] == "torch"
    assert h.perf.kernels["gstrf_residual"] < 1e-5


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_native_complex_initialises(dtype):
    """complex_mode="native" keeps complex tiles and solves on the fused
    engine with the torch backend."""
    a = poisson2d(6)
    h = init(a, InitOptions(nb=8, dtype=dtype, device="cpu",
                            complex_mode="native"))
    assert h.complex_embed is None and h.blocked.dtype.kind == "c"
    gstrf(h)
    assert h.perf.kernels["engine"] == "fused"
    b = a.to_scipy() @ (np.ones(a.n) + 1j)
    x = gstrs(h, b)
    assert np.abs(x - (1 + 1j)).max() < 1e-5


def test_native_rebuild_is_keyed_by_source(monkeypatch, tmp_path):
    """Without a loadable shipped library the host source is rebuilt
    into the build directory (never into native/), under a name that
    changes with the source, so an edited source never loads a stale
    build."""
    from pangulu_tpu_torch import native

    src = tmp_path / "pangulu_host.cpp"
    src.write_bytes((ROOT / "native" / "pangulu_host.cpp").read_bytes())
    monkeypatch.setattr(native, "_SHIPPED", tmp_path / "missing.so")
    monkeypatch.setattr(native, "_SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    path = native._rebuilt_path()
    assert native.get_lib() is not None
    assert sorted((tmp_path / "build").iterdir()) == [path]
    src.write_text(src.read_text() + "\n// edited\n")
    assert native._rebuilt_path() not in (path, None)


def test_cpu_wrapper_runs_plain_version():
    """On a CPU tensor the wrapper IS the plain version (and counts no
    launch)."""
    from pangulu_tpu_torch.ops import kernels_torch as kt

    before = dict(kernels_cuda.LAUNCHES)
    dev_before = dict(kernels_cuda.DEVICE_LAUNCHES)
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((8, 8)) + 8 * np.eye(8))
    for g, r in zip(kernels_cuda.getrf_with_inverses(a),
                    kt.getrf_with_inverses(a)):
        assert torch.equal(g, r)
    assert kernels_cuda.LAUNCHES == before
    assert kernels_cuda.DEVICE_LAUNCHES == dev_before


def test_reset_launch_counts_zeroes_both_counters(monkeypatch):
    """reset_launch_counts zeroes the per-kernel launches and K1's
    device launches alike (chip_smoke.py reads both after a path)."""
    monkeypatch.setitem(kernels_cuda.LAUNCHES, "mega_solve", 3)
    monkeypatch.setitem(kernels_cuda.DEVICE_LAUNCHES,
                        "getrf_with_inverses", 10)
    kernels_cuda.reset_launch_counts()
    assert set(kernels_cuda.LAUNCHES.values()) == {0}
    assert kernels_cuda.DEVICE_LAUNCHES == {"getrf_with_inverses": 0}
