#!/usr/bin/env python3
"""The kernel library's SASS, function by function, against another
tree's, on a machine with the CUDA toolkit:

    python3 pangulu_tpu_torch/tools/probe_sass.py OTHER_ROOT [--out F]

It builds the kernel library of this checkout and of OTHER_ROOT (an
older tree unpacked with ``git archive``), each with its own
``pangulu_tpu_torch/ops/build.py`` into its own ``_build/``, disassembles
both with ``cuobjdump -sass`` and compares each function's instructions.
It prints how many functions are identical, the names of those that
differ and of those only one library has, then one JSON line
{"probe_sass": ...} (also written to F).  A change to one kernel's
source should leave every other function's instructions as they were.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def library_of(root: pathlib.Path) -> str:
    """Build (if needed) the kernel library of the tree at ``root``, in a
    process of its own, and return its path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pangulu_tpu_torch.ops import build; "
            "print(build.build()[0])")
    res = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[-1]


def sass_by_function(cuobjdump: str, lib: str) -> dict:
    """Per function of the library, its SASS lines (whitespace
    trimmed)."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m[1], [])
            continue
        if cur is not None and ln.strip():
            cur.append(ln.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the tree to compare with")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        print("probe_sass: cuobjdump not found", file=sys.stderr)
        return 2
    libs = {"this": library_of(ROOT),
            "other": library_of(pathlib.Path(args.other).resolve())}
    sass = {k: sass_by_function(cuobjdump, v) for k, v in libs.items()}
    this, other = sass["this"], sass["other"]
    both = sorted(set(this) & set(other))
    same = [f for f in both if this[f] == other[f]]
    differ = [f for f in both if this[f] != other[f]]
    out = dict(libraries=libs, identical=len(same), differ=differ,
               only_this=sorted(set(this) - set(other)),
               only_other=sorted(set(other) - set(this)))
    print(f"probe_sass: {len(both)} functions in both libraries, "
          f"{len(same)} identical; differ: {differ}; only in this one: "
          f"{out['only_this']}; only in the other: {out['only_other']}")
    line = json.dumps({"probe_sass": out})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
