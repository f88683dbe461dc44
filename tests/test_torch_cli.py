"""The port's file-driven CLI (``python -m pangulu_tpu_torch``) with
``--device cpu``, against the JAX package's (tests/test_cli.py,
tests/test_io_and_blocks.py:205): the same files, the same flags, the
same exit codes, and residuals at the reference's acceptance bounds.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pangulu_tpu import cli as jcli
from pangulu_tpu_torch import cli
from pangulu_tpu_torch.io.mmio import write_matrix
from pangulu_tpu_torch.models import poisson2d

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _write_fixture(tmp_path):
    a = poisson2d(7)
    mtx = tmp_path / "a.mtx"
    write_matrix(mtx, a)
    rhs = tmp_path / "b.txt"
    np.savetxt(rhs, np.asarray(a.to_scipy() @ np.arange(1.0, a.n + 1)))
    return a, str(mtx), str(rhs)


def _residual(out: str) -> float:
    line = [ln for ln in out.splitlines() if "solve residual" in ln][-1]
    return float(line.split("=")[1])


@pytest.mark.parametrize("dtype", ["r64", "r32"])
def test_cli_solve_with_rhs(tmp_path, capsys, dtype):
    """tests/test_cli.py:19, and the same residual class as JAX's CLI."""
    a, mtx, rhs = _write_fixture(tmp_path)
    args = ["-f", mtx, "-nb", "16", "-r", rhs, "--dtype", dtype, "--check"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    res = _residual(capsys.readouterr().out)
    assert jcli.main(args + ["--platform", "cpu"]) == 0
    res_j = _residual(capsys.readouterr().out)
    assert res < 1e-12 and res_j < 1e-12


def test_cli_save_load_factor(tmp_path, capsys):
    """tests/test_cli.py:28; a factor the port saved is loaded by the
    JAX CLI too."""
    a, mtx, rhs = _write_fixture(tmp_path)
    fpath = str(tmp_path / "f.npz")
    assert cli.main(["-f", mtx, "-nb", "16", "--dtype", "r64",
                     "--save-factor", fpath, "--device", "cpu"]) == 0
    assert cli.main(["--load-factor", fpath, "-r", rhs, "--dtype", "r64",
                     "--device", "cpu"]) == 0
    assert _residual(capsys.readouterr().out) < 1e-12
    assert jcli.main(["--load-factor", fpath, "-r", rhs]) == 0


def test_cli_requires_input():
    """tests/test_cli.py:37."""
    with pytest.raises(SystemExit):
        cli.main(["-nb", "16", "--device", "cpu"])


def test_cli_load_factor_uses_checkpoint_dtype(tmp_path, capsys):
    """tests/test_cli.py:44: --load-factor takes the rhs dtype from the
    checkpoint, not from the --dtype default (r64)."""
    a, mtx, rhs = _write_fixture(tmp_path)
    fpath = str(tmp_path / "f32.npz")
    assert cli.main(["-f", mtx, "-nb", "16", "--dtype", "r32",
                     "--save-factor", fpath, "--device", "cpu"]) == 0
    assert cli.main(["--load-factor", fpath, "-r", rhs,
                     "--device", "cpu"]) == 0
    assert "solve residual" in capsys.readouterr().out


def test_cli_solves_lid_same_as_mtx(tmp_path, capsys):
    """tests/test_io_and_blocks.py:205: a .lid matrix solves as its .mtx
    twin (the reference example reads both)."""
    a = poisson2d(8)
    write_matrix(tmp_path / "m.mtx", a)
    write_matrix(tmp_path / "m.lid", a)
    for ext in ("mtx", "lid"):
        assert cli.main(["-f", str(tmp_path / f"m.{ext}"), "-nb", "16",
                         "--dtype", "r64", "--device", "cpu"]) == 0
        assert _residual(capsys.readouterr().out) < 1e-12


def test_cli_bad_file_exits_2(tmp_path, capsys):
    (tmp_path / "bad.mtx").write_text("not a matrix\n")
    for path in (tmp_path / "missing.mtx", tmp_path / "bad.mtx"):
        assert cli.main(["-f", str(path), "--device", "cpu"]) == 2
        assert "error reading matrix" in capsys.readouterr().err


@pytest.mark.parametrize("flags,words", [
    # --mesh runs under a launcher only (tests/test_torch_dist.py runs it
    # under one)
    (["--mesh", "2,2"], ("torch.distributed.run", "--nproc-per-node")),
    # --profile-dir runs since ROADMAP Queue 1 item 7 closed: words None
    (["--profile-dir", "prof"], None),
])
def test_cli_unported_flags_name_their_item(tmp_path, capsys, monkeypatch,
                                            flags, words):
    """--mesh outside a launcher exits 2 naming the launcher, before any
    file is read; --profile-dir, which exited 2 until its ROADMAP.md
    item closed, solves and writes one Chrome trace into the directory
    (relative to the working directory, here the test's)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    if words is None:
        monkeypatch.chdir(tmp_path)
        write_matrix(tmp_path / "m.mtx", poisson2d(8))
        assert cli.main(["-f", str(tmp_path / "m.mtx"), "-nb", "16",
                         "--device", "cpu"] + flags) == 0
        assert _residual(capsys.readouterr().out) < 1e-12
        files = list((tmp_path / flags[1]).glob("*.pt.trace.json"))
        assert len(files) == 1 and "traceEvents" in json.loads(
            files[0].read_text())
        return
    rc = cli.main(["-f", str(tmp_path / "never_read.mtx"), "--device",
                   "cpu"] + flags)
    assert rc == 2
    err = capsys.readouterr().err
    assert all(w in err for w in words)


@pytest.mark.parametrize("dtype,limit", [("cr32", 1e-6), ("cr64", 1e-12)])
def test_cli_complex_dtype_solves(tmp_path, capsys, dtype, limit):
    """--dtype cr32|cr64 solves the complex system through its real 2x2
    embedding, its rhs read from a text file of complex values and the
    printed residual the complex system's; the JAX CLI solves the same
    system (its rhs from .npy: its text reader takes real values only).
    The rhs is read in the working type, so cr32's x is complex64 and its
    residual ~1e-7 in both packages."""
    from pangulu_tpu_torch.testing import with_imaginary_parts

    a = with_imaginary_parts(poisson2d(7))
    mtx = tmp_path / "c.mtx"
    write_matrix(mtx, a)
    b = np.asarray(a.to_scipy() @ (1.0 + 1j * np.arange(a.n)))
    np.savetxt(tmp_path / "c.txt", b)
    np.save(tmp_path / "c.npy", b)
    args = ["-f", str(mtx), "-nb", "16", "--dtype", dtype, "--check"]
    assert cli.main(args + ["-r", str(tmp_path / "c.txt"), "--device",
                            "cpu"]) == 0
    res = _residual(capsys.readouterr().out)
    assert jcli.main(args + ["-r", str(tmp_path / "c.npy"), "--platform",
                             "cpu"]) == 0
    res_j = _residual(capsys.readouterr().out)
    assert res < limit and res_j < limit


def test_python_m_runs_the_cli(tmp_path):
    """``python -m pangulu_tpu_torch`` is the CLI, in a fresh interpreter
    that loads no JAX."""
    _, mtx, _ = _write_fixture(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "pangulu_tpu_torch",
         "-f", mtx, "-nb", "16", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert _residual(res.stdout) < 1e-12
    imported = [ln.split("|")[-1].strip() for ln in res.stderr.splitlines()
                if ln.startswith("import time:")]
    assert "pangulu_tpu_torch.cli" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "pangulu_tpu")]
