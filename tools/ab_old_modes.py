#!/usr/bin/env python
"""Time the flash kernels' old modes in two checkouts, in turns, on one card.

Usage:
    python tools/ab_old_modes.py PARENT_DIR CHANGE_DIR [--rounds N]

Runs, in fresh processes, PARENT, CHANGE, CHANGE, PARENT (``--rounds``
times), each with its checkout as the working directory and import path,
and prints one JSON line a run: ``chip_smoke.k3f_old_modes()`` and
``chip_smoke.bwd_old_modes()`` (attention over one sequence: Tq == Tk, no
shift) from THIS tree's ``chip_smoke.py``, loaded by path, against the
checkout's package. Those functions call nothing the older commits lack,
so the same measurement runs on both sides. Each process builds its
checkout's kernels at first use. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
PROGRAM = f"""
import importlib.util, json, torch
torch.backends.cuda.matmul.allow_tf32 = False
spec = importlib.util.spec_from_file_location("chip_smoke", {str(SMOKE)!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(json.dumps({{**cs.k3f_old_modes(), **cs.bwd_old_modes()}}))
"""


def run(checkout: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=checkout,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            times = run(getattr(args, side).resolve())
            print(json.dumps({"side": side, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
