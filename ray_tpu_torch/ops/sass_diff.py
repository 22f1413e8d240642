"""Compare the machine code (SASS) of two builds of the kernel libraries,
kernel by kernel.

    python3 -m ray_tpu_torch.ops.sass_diff BUILD_A BUILD_B [LINES]

BUILD_A and BUILD_B are ``ray_tpu_torch/_build`` directories of two trees
(``_build.build_all()`` fills them), or two library files, compared as one
pair. For each of ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` (or
the one pair) it disassembles both libraries with
``cuobjdump -sass`` and prints how many kernels the two share, how many of
those are identical, and the names of the differing ones and of those only
one build has, with the registers of each of those (``cuobjdump
-res-usage``), and for each differing kernel its first LINES (default 0)
differing lines. The anonymous namespace's per-build hashes in the mangled
names (``_GLOBAL__N__<8 hex>_<n>_<file>_cu_<8 hex>``) are normalised away,
so builds of a source from two paths compare too. Needs the CUDA
toolkit (``$CUDA_HOME/bin/cuobjdump``, else ``/usr/local/cuda``).
"""

import difflib
import glob
import os
import re
import subprocess
import sys
from typing import Dict

SOURCES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu_)[0-9a-f]{8}")
_ANON_TO = r"_GLOBAL__N__X_\1X"


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "cuobjdump")


def kernels(lib: str) -> Dict[str, str]:
    """{mangled kernel name: its SASS} of one library."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    out = _ANON.sub(_ANON_TO, out)
    res, name, buf = {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                res[name] = "\n".join(buf)
            name, buf = m.group(1), []
        elif name:
            buf.append(line)
    if name:
        res[name] = "\n".join(buf)
    return res


def registers(lib: str) -> Dict[str, str]:
    """{mangled kernel name: its register count} of one library ("?" where
    the report has none)."""
    out = subprocess.run([_cuobjdump(), "-res-usage", lib],
                         capture_output=True, text=True, check=True).stdout
    res, name = {}, None
    for line in _ANON.sub(_ANON_TO, out).splitlines():
        m = re.search(r"Function (\S+?):?$", line.strip())
        if m:
            name = m.group(1)
            res[name] = "?"
            continue
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            res[name] = m.group(1)
            name = None
    return res


def _short(name: str) -> str:
    return re.sub(r".*_cu_X", "", name)[:70]


def _pairs(a: str, b: str):
    """[(label, library A, library B)]: the two files, or each source's
    library in the two build directories."""
    if os.path.isfile(a) and os.path.isfile(b):
        return [(os.path.basename(a), a, b)]
    return [(src, glob.glob(os.path.join(a, f"{src}-*.so"))[0],
             glob.glob(os.path.join(b, f"{src}-*.so"))[0])
            for src in SOURCES]


def main(a_dir: str, b_dir: str, lines: int = 0) -> int:
    for src, a_lib, b_lib in _pairs(a_dir, b_dir):
        a, b = kernels(a_lib), kernels(b_lib)
        a_reg, b_reg = registers(a_lib), registers(b_lib)
        shared = sorted(set(a) & set(b))
        diff = [n for n in shared if a[n] != b[n]]
        only_a = [(_short(n), a_reg.get(n, "?"))
                  for n in sorted(set(a) - set(b))]
        only_b = [(_short(n), b_reg.get(n, "?"))
                  for n in sorted(set(b) - set(a))]
        print(f"SASS {src}: A {len(a)} kernels, B {len(b)}, shared "
              f"{len(shared)} ({len(shared) - len(diff)} identical), "
              f"differing {[_short(n) for n in diff]}; only in A {only_a}; "
              f"only in B {only_b} (kernel, registers)")
        for n in diff:
            print(f"  {_short(n)}: {a[n].count(chr(10))} against "
                  f"{b[n].count(chr(10))} lines, {a_reg.get(n, '?')} "
                  f"against {b_reg.get(n, '?')} registers")
            changed = [d for d in difflib.unified_diff(
                b[n].splitlines(), a[n].splitlines(), "B", "A", n=0,
                lineterm="") if d[:1] in "+-@" and d[:3] not in ("+++",
                                                               "---")]
            for d in changed[:lines]:
                print(f"    {d.strip()}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2],
                  int(sys.argv[3]) if len(sys.argv) == 4 else 0))
