#!/usr/bin/env python3
"""Compare the machine code (SASS) of the kernels of two checkouts of the
PyTorch port, kernel by kernel, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_diff.py TREE_A TREE_B [--match REGEX]

Each tree's kernels are built in a process of its own that imports the
port from that tree (``ops/_build.py``, into the tree's build directory);
``cuobjdump -sass`` then lists each kernel instance's instructions, whose
names ``cu++filt`` demangles (the anonymous namespace of each source
reads alike in both trees). Addresses and encodings are dropped, so two
instances compare equal when their instructions are. Prints, for every
instance whose demangled name matches ``--match`` (default: every one),
whether it is identical, differs (with the instruction counts) or is
missing in one tree, and a count of each; exits 1 if any matched instance
differs or is missing.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

PKG = "parallel_finite_difference_computation_tpu_torch"
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         f"import {PKG}.ops._build as b; print(b.library()._name)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    if os.path.exists(path):
        return path
    raise SystemExit(f"{name} not found (on PATH or under CUDA_HOME)")


def kernels(tree: str) -> dict:
    """{demangled instance name: [instructions]} of the tree's library."""
    lib = subprocess.run([sys.executable, "-c", BUILD, tree], check=True,
                         capture_output=True, text=True).stdout.split()[-1]
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    names = subprocess.run([_tool("cu++filt")], input=sass, check=True,
                           capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in names.splitlines():
        m = re.match(r"\s*Function : (.+)$", line)
        if m:
            cur = out.setdefault(m.group(1).strip(), [])
            continue
        if re.match(r"\s*=+\s*$", line):
            cur = None     # a section's header (arch, code version) follows
            continue
        code = re.sub(r"/\*[0-9a-f]+\*/|/\* 0x[0-9a-f]+ \*/", "", line)
        code = code.strip()
        if cur is not None and code and not code.startswith(("..", "Fatbin",
                                                              "code for")):
            cur.append(code)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    a, b = (kernels(t) for t in args.trees)
    pick = re.compile(args.match)
    seen = collections.Counter()
    for name in sorted(set(a) | set(b)):
        if not pick.search(name):
            continue
        if name not in a or name not in b:
            state = "missing in " + (args.trees[0] if name not in a
                                     else args.trees[1])
        elif a[name] == b[name]:
            state = "identical"
        else:
            state = f"differs ({len(a[name])} / {len(b[name])} instructions)"
        seen[state.split(" (")[0]] += 1
        print(f"{state}: {name[:160]}")
    print(dict(seen))
    return 0 if set(seen) <= {"identical"} else 1


if __name__ == "__main__":
    sys.exit(main())
