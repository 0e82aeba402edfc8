#!/usr/bin/env python3
"""Check that a change to the port's CUDA sources kept the machine code of
every kernel an earlier checkout built: each function of the earlier
build must have its SASS, with the kernel parameters' constant-bank
offsets masked, among the functions of the later one.  A kernel that
gained a template flag (a ``BATCH`` instance beside the single-product
one) or a parameter at the end keeps its old body under a new name, so
bodies are compared as a multiset, not by name.

Run from the root of a checkout, on a machine with the CUDA toolkit
(``nvcc``, ``cuobjdump``):

    python3 sass_compare.py OLD_ROOT [NEW_ROOT]

Each root's kernels are built by its own ``ops/_build.py`` (into that
checkout's ``build/``) and disassembled with ``cuobjdump -sass``.  Prints
one JSON line (the functions of each build, how many of the old ones the
new build holds, the names of those it lacks) and exits 1 when any is
missing.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

# A kernel parameter's address in constant bank 0; the instruction
# encodings (the /* 0x... */ columns) carry it too and are dropped.
PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def build(root):
    """The path of ``root``'s kernel library, built by its own code."""
    code = ("from sparse_dot_tpu_torch.ops import _build; "
            "print(_build.library()._name)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def functions(library):
    """{mangled name: masked SASS body} of a library's sm_90a code."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            bodies[name] = []
            continue
        found = INSTRUCTION.search(line)
        if name is not None and found:
            bodies[name].append(PARAM.sub("c[0x0][P]", found.group(1)))
    return {key: "\n".join(body) for key, body in bodies.items()}


def main():
    old_root = Path(sys.argv[1]).resolve()
    new_root = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
    old, new = functions(build(old_root)), functions(build(new_root))
    held = collections.Counter(new.values())
    missing = []
    for name, body in sorted(old.items()):
        if held[body]:
            held[body] -= 1
        else:
            missing.append(name)
    print(json.dumps({"old_functions": len(old), "new_functions": len(new),
                      "old_bodies_held": len(old) - len(missing),
                      "missing": missing}), flush=True)
    sys.exit(1 if missing else 0)


if __name__ == "__main__":
    main()
