"""What nvcc made of the package's kernels: registers, spills and SASS
instruction counts per kernel.

    python -m cbet_raytracing_3d_tpu_torch.scripts.sass_report [--csrc DIR]
        [--match TEXT] [--dump DIR]

Compiles every ``*.cu`` of ``DIR`` (default: the package's ``csrc/``) with
the package's flags plus ``-Xptxas -v`` into objects under ``_build/``, all
at once, and prints for each kernel whose demangled name contains ``TEXT``
(default: all) its registers, spills and shared memory, the number of SASS
instructions (``cuobjdump -sass``) and the most frequent opcodes.  With
``--dump`` each kernel's SASS is written there as one text file.  Run it on
two directories (say, an older revision unpacked with ``git archive``) to
compare two builds of one kernel.  Needs nvcc and cuobjdump, no card.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import subprocess
import sys

from ..utils import cuda_build


def compile_all(csrc: str) -> dict:
    """{source name: (object path, ptxas output)}."""
    nvcc = cuda_build.find_nvcc()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for src in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        obj = os.path.join(cuda_build.BUILD_DIR, "sass_report_%d_%s.o"
                           % (os.getpid(), os.path.basename(src)))
        procs[os.path.basename(src)] = (obj, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (obj, proc) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        out[name] = (obj, text)
    return out


def resources(ptxas: str) -> dict:
    """{mangled kernel name: its spill and register lines, joined}."""
    found, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            found[name] = ""
        elif name and ("spill" in line or "Used" in line):
            found[name] += line.replace("ptxas info    :", "").strip() + "; "
    return found


def kernels(obj: str, tool: str) -> dict:
    """{mangled kernel name: [SASS instruction lines]}."""
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True, timeout=900).stdout
    found, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            name = m.group(1)
            found[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            found[name].append(line.strip())
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=cuda_build.CSRC)
    ap.add_argument("--match", default="")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    filt = os.path.join(os.path.dirname(tool), "cu++filt")
    objs = compile_all(args.csrc)
    try:
        for src, (obj, ptxas) in objs.items():
            res = resources(ptxas)
            for name, sass in kernels(obj, tool).items():
                plain = subprocess.run([filt, name], capture_output=True,
                                       text=True).stdout.strip() or name
                plain = re.sub(r"\(anonymous namespace\)::", "", plain)
                if args.match not in plain:
                    continue
                ops = collections.Counter(
                    re.sub(r"^(@!?U?P\d+\s+)?", "", re.sub(
                        r"^/\*[0-9a-f]{4}\*/\s*", "", l)).split()[0]
                    .rstrip(";") for l in sass)
                top = ", ".join(f"{o} {c}" for o, c in ops.most_common(12))
                # without the argument list (template arguments may hold
                # parentheses of their own)
                short = (plain[:plain.rindex(">(") + 1] if ">(" in plain
                         else plain.split("(")[0])
                print(f"{src}: {short}: {len(sass)} instructions; "
                      f"{res.get(name, 'no ptxas line; ')}{top}", flush=True)
                if args.dump:
                    os.makedirs(args.dump, exist_ok=True)
                    with open(os.path.join(args.dump, f"{src}.{name}.sass"),
                              "w") as f:
                        f.write("\n".join(sass) + "\n")
    finally:
        for obj, _ in objs.values():
            if os.path.exists(obj):
                os.remove(obj)
    return 0


if __name__ == "__main__":
    sys.exit(main())
