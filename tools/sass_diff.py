#!/usr/bin/env python
"""Compare the SASS of the port's CUDA kernels built from two source trees.

Usage:
    python tools/sass_diff.py OLD_CSRC NEW_CSRC NAME [NAME ...] [--out DIR]

Builds ``NAME.cu`` from each ``csrc`` directory with the port's own nvcc
flags (``deeplearning4j_tpu_torch/ops/_kernels.py``), all builds started
together, dumps each library with ``cuobjdump -sass`` and holds every
kernel of the old library against the kernel of the same name in the new
one, instruction by instruction. Instruction addresses and encodings are
dropped, and the kernel parameters' constant-bank offsets and branch
targets are masked, so a kernel whose parameter list grew at its end, or
whose code moved within the library, compares equal when its
instructions are.

Prints one line a library (old kernels, matched, identical, and the
names that differ) and, with ``--out``, writes each side's masked SASS
there. Needs nvcc and cuobjdump: it runs where the kernels build.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deeplearning4j_tpu_torch.ops import _kernels  # noqa: E402

_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.M)
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")
_CBANK = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
_BRANCH = re.compile(r"\b(BRA|BRX|BSSY|CALL\.\S+|JMP|JMX|RET\.\S+|WARPSYNC)"
                     r"\b([^;]*)")


def _tool(name: str) -> str:
    return str(Path(_kernels._nvcc()).parent / name)


def build(csrc: Path, name: str, out_dir: Path) -> Path:
    out = out_dir / f"lib{name}.so"
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out),
           str(csrc / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    return out


def _demangle(names):
    proc = subprocess.run(["c++filt"], input="\n".join(names),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return list(names)
    return proc.stdout.splitlines()


def kernels(lib: Path) -> dict:
    """{demangled name without its parameter list: masked SASS lines}."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    parts = _FUNCTION.split(sass)
    mangled, bodies = parts[1::2], parts[2::2]
    out = {}
    for name, body in zip(_demangle(mangled), bodies):
        lines = []
        for line in body.splitlines():
            line = _ENCODING.sub("", _ADDR.sub("", line)).strip()
            if not line or line.startswith(("..", "/*")):
                continue
            line = _CBANK.sub("c[0x0][P]", line)
            line = _BRANCH.sub(lambda m: m.group(1) + re.sub(
                r"0x[0-9a-f]+", "T", m.group(2)), line)
            lines.append(line)
        name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::",
                                                   "")
        out[name.split("(")[0].strip()] = lines
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_csrc", type=Path)
    ap.add_argument("new_csrc", type=Path)
    ap.add_argument("names", nargs="+")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for side, csrc in (("old", args.old_csrc), ("new", args.new_csrc)):
            for name in args.names:
                d = Path(tmp) / side
                d.mkdir(exist_ok=True)
                jobs.append((side, name, csrc, d))
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(zip(((s, n) for s, n, _, _ in jobs), pool.map(
                lambda j: build(j[2], j[1], j[3]), jobs)))
        same_all = True
        for name in args.names:
            old, new = kernels(libs[("old", name)]), kernels(
                libs[("new", name)])
            matched = {k: new.get(k) for k in old}
            differ = sorted(k for k, v in matched.items()
                            if v is not None and v != old[k])
            missing = sorted(k for k, v in matched.items() if v is None)
            same = sum(v is not None and v == old[k]
                       for k, v in matched.items())
            same_all &= not differ and not missing
            print(f"{name}: {len(old)} old kernels, "
                  f"{len(old) - len(missing)} matched, {same} identical "
                  f"instruction for instruction; {len(new)} new kernels"
                  + (f"; differ: {differ}" if differ else "")
                  + (f"; unmatched: {missing}" if missing else ""))
            if args.out:
                args.out.mkdir(parents=True, exist_ok=True)
                for side, table in (("old", old), ("new", new)):
                    with open(args.out / f"{name}.{side}.sass", "w") as f:
                        for k in sorted(table):
                            f.write(f"== {k}\n" + "\n".join(table[k]) + "\n")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
