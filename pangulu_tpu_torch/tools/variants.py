"""Textual variants of the port's CUDA sources, built side by side: the
probes' ``--variants`` modes (``probe_k1_wide.py``, ``probe_p6.py``) keep a
kernel's losing designs runnable as edits of the shipped file.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def build_variants(edits: dict, source: str, probe: str) -> tuple:
    """One nvcc a variant of ``edits`` (name: [(old text, new text)]), all
    at once, each a copy of ``csrc/`` with its edits of the file
    ``source`` made (an edit that does not match once raises), into
    ``pangulu_tpu_torch/_build/<probe>/<variant>/``; (dirs: name ->
    (csrc, build dir), ptxas logs: name -> nvcc's output)."""
    from pangulu_tpu_torch.ops import build

    base = ROOT / "pangulu_tpu_torch" / "_build" / probe
    shipped = build.CSRC_DIR
    src = (shipped / source).read_text()
    dirs, jobs = {}, {}
    t0 = time.perf_counter()
    for name, changes in edits.items():
        d = base / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(shipped, d / "csrc")
        text = src
        for old, new in changes:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit does not match "
                                   f"once: {old[:60]!r}")
            text = text.replace(old, new)
        (d / "csrc" / source).write_text(text)
        bdir = d / "_build"
        bdir.mkdir(parents=True, exist_ok=True)
        build.CSRC_DIR = d / "csrc"
        out = bdir / f"liblu_kernels_{build.source_hash()}.so"
        dirs[name] = (d / "csrc", bdir)
        jobs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(d / "csrc" / "lu_kernels.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    build.CSRC_DIR = shipped
    logs = {}
    for name, p in jobs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n"
                               f"{logs[name][-3000:]}")
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f} s")
    return dirs, logs
