"""``python -m deeplearning4j_tpu_torch.tune`` — run the roofline-guided
config search over one or more seams, write the auditable decisions dir,
and (``--store``) publish the winners into the tuning cache consumed by
the ``tuned=`` seams. JAX's flags, plus ``--device {cuda,cpu}`` (default
``cuda``, as the port's CLI takes it).

Examples::

    python -m deeplearning4j_tpu_torch.tune --seam lm --seam serve \
        --out tuning_out --store
    python -m deeplearning4j_tpu_torch.tune --seam flash_attention --fast \
        --device cpu

Audit a run afterwards with ``tools/tune_report.py tuning_out`` (winner
table, pruned/measured counts, rank correlation).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

_SEAMS = ("flash_attention", "lm", "serve")


def _harness(name: str, fast: bool, device: str):
    from deeplearning4j_tpu_torch.tune import seams
    if name == "flash_attention":
        return seams.flash_seam(seq_len=512 if fast else 1024,
                                device=device)
    if name == "lm":
        return seams.lm_seam(seq_len=128 if fast else 256,
                             n_layers=1 if fast else 2, device=device)
    if name == "serve":
        return seams.serve_seam(n_prompts=3 if fast else 6,
                                max_new_tokens=4 if fast else 8,
                                device=device)
    raise ValueError(f"unknown seam {name!r}; options: {', '.join(_SEAMS)}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.tune",
        description="Roofline-guided autotuner: profile one call of every "
                    "candidate, prune by dominance, measure the Pareto "
                    "frontier, cache the winner.")
    ap.add_argument("--seam", action="append", choices=_SEAMS,
                    help="seam(s) to search (repeatable; default: all)")
    ap.add_argument("--out", default="tuning_out",
                    help="decisions directory (default: tuning_out)")
    ap.add_argument("--cache", default=None,
                    help="tuning-cache path (default: ./TUNE_CACHE.json "
                         "or DL4J_TPU_TUNE_CACHE)")
    ap.add_argument("--store", action="store_true",
                    help="publish winners into the tuning cache")
    ap.add_argument("--repeats", type=int, default=5,
                    help="paired timing repeats per frontier config")
    ap.add_argument("--fast", action="store_true",
                    help="small shapes (smoke/CI)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON summary on stdout")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the seams run (default: cuda)")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.tune.cache import TuningCache
    from deeplearning4j_tpu_torch.tune.search import search
    from deeplearning4j_tpu_torch.tune.space import get_space

    cache = TuningCache(args.cache) if (args.store or args.cache) else None
    summaries = []
    for name in (args.seam or list(_SEAMS)):
        h = _harness(name, args.fast, args.device)
        space = get_space(h.seam)
        result = search(space, h.context, h.default_config, h.compile_fn,
                        h.measure_fn, h.outputs_match,
                        repeats=args.repeats, out_dir=args.out)
        stored_key = None
        if args.store and cache is not None:
            stored_key = cache.store(
                h.seam, h.context, result.winner_config,
                meta={"tuned_vs_default": result.tuned_vs_default,
                      "label": h.label})
        summaries.append({
            "seam": h.seam, "label": h.label,
            "default": result.default_config,
            "winner": result.winner_config,
            "tuned_vs_default": result.tuned_vs_default,
            "counts": result.counts,
            "rank_correlation": result.rank_correlation,
            "stored_key": stored_key,
        })
        if not args.json:
            c = result.counts
            print(f"[{h.label}] winner {result.winner_config} "
                  f"({result.tuned_vs_default:.3f}x vs default "
                  f"{result.default_config}; {c['total']} candidates, "
                  f"{c['invalid']} invalid, {c['pruned']} pruned, "
                  f"{c['measured']} measured)"
                  + (f"; cached as {stored_key}" if stored_key else ""))
    if args.json:
        print(json.dumps({"out_dir": args.out, "seams": summaries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
