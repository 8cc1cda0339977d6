"""Counterpart of ``deeplearning4j_tpu/scaleout/parallelization.py``, copied (no framework
in it).

Local thread-pool map (ref: parallel/Parallelization.java:35-130)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def iterate(items: Iterable[T], fn: Callable[[T], R],
            num_threads: Optional[int] = None) -> List[R]:
    """Apply fn to every item on a thread pool (ref: Parallelization.iterateInParallel)."""
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        return list(pool.map(fn, items))


def run_in_parallel(tasks: Iterable[Callable[[], R]],
                    num_threads: Optional[int] = None) -> List[R]:
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        futures = [pool.submit(t) for t in tasks]
        return [f.result() for f in futures]
