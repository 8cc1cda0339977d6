"""Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``: iteration
listeners (ref: optimize/api/IterationListener.java, optimize/listeners/
ScoreIterationListener, ComposableIterationListener), called from the
host side of a training loop with the model, the iteration and the score.

Every training loop routes its callbacks through ``dispatch_listeners``,
so one raising listener is logged and skipped and never kills the run,
and closes the chain through ``close_listeners`` from a ``finally``.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Iterable, List, Optional, Sequence

log = logging.getLogger(__name__)

# listener(model, iteration, score)
IterationListener = Callable[[object, int, float], None]

_STEP_LOG_SLICE = "ROADMAP slice 9 (telemetry/step_log.py)"


def dispatch_listeners(listeners: Sequence[IterationListener], model,
                       iteration: int, score: float) -> None:
    """Call every listener, logging (not raising) per-listener failures."""
    for listener in listeners:
        try:
            listener(model, iteration, score)
        except Exception:
            log.exception("iteration listener %r failed at iteration %d; "
                          "continuing", listener, iteration)


def close_listeners(listeners: Sequence) -> None:
    """Best-effort ``close()`` on every listener that has one. Safe to
    call repeatedly; exceptions are logged, never raised: this runs from
    ``finally`` blocks."""
    for listener in listeners:
        close = getattr(listener, "close", None)
        if callable(close):
            try:
                close()
            except Exception:
                log.exception("listener %r close() failed", listener)


class ScoreIterationListener:
    """Log the score every N iterations (ref: ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def __call__(self, model, iteration: int, score: float) -> None:
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, score)


class ComposableIterationListener:
    def __init__(self, listeners: Iterable[IterationListener]):
        self._listeners: List[IterationListener] = list(listeners)

    def __call__(self, model, iteration: int, score: float) -> None:
        for listener in self._listeners:
            listener(model, iteration, score)

    def close(self) -> None:
        close_listeners(self._listeners)


class CollectScoresListener:
    """Records (iteration, score) pairs."""

    def __init__(self):
        self.scores: List[tuple] = []

    def __call__(self, model, iteration: int, score: float) -> None:
        self.scores.append((iteration, score))


class TimingIterationListener:
    """Wall-clock time between iterations (ref: the YARN worker's
    StopWatch fields, impl/multilayer/WorkerNode.java). The first callback
    only arms the clock, so set-up before iteration 0 is not counted; each
    later callback records the gap.

    ``tracker=``: anything with ``increment(name, value)`` (the JAX
    package's scaleout StateTracker) gets each gap added to its
    ``job_ms_total``; ``registry=`` (``telemetry.registry
    .MetricsRegistry``) observes it into an ``iteration_ms`` histogram.
    """

    def __init__(self, print_iterations: int = 50, tracker=None,
                 registry=None):
        self._last: Optional[float] = None
        self.print_iterations = max(1, print_iterations)
        self.timings_ms: List[float] = []
        self.tracker = tracker
        self.registry = registry

    def __call__(self, model, iteration: int, score: float) -> None:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return
        ms = (now - self._last) * 1000.0
        self._last = now
        self.timings_ms.append(ms)
        if self.tracker is not None:
            self.tracker.increment("job_ms_total", ms)
        if self.registry is not None:
            self.registry.histogram("iteration_ms").observe(ms)
        if iteration % self.print_iterations == 0:
            log.info("Iteration %d took %.2f ms (score %s)", iteration, ms,
                     score)

    def total_ms(self) -> float:
        return sum(self.timings_ms)

    def mean_ms(self) -> float:
        return self.total_ms() / max(len(self.timings_ms), 1)

    def _percentile_ms(self, q: float) -> float:
        """Nearest-rank percentile over the recorded gaps (0 when empty)."""
        if not self.timings_ms:
            return 0.0
        s = sorted(self.timings_ms)
        rank = max(1, math.ceil(q / 100.0 * len(s)))
        return s[rank - 1]

    def p50_ms(self) -> float:
        return self._percentile_ms(50.0)

    def p95_ms(self) -> float:
        return self._percentile_ms(95.0)


class MetricsIterationListener:
    """The listener chain into the port's metrics registry: each callback
    sets gauge ``<prefix>_score``, bumps ``<prefix>_iterations_total`` and
    observes the gap since the last callback into the
    ``<prefix>_iteration_ms`` histogram. The JSONL step log
    (``step_log_path=``) comes with ROADMAP slice 9 and raises until
    then."""

    def __init__(self, registry=None, step_log_path: Optional[str] = None,
                 prefix: str = "train"):
        from deeplearning4j_tpu_torch.telemetry.registry import (
            MetricsRegistry,
            default_registry,
        )

        if step_log_path:
            raise NotImplementedError(
                f"MetricsIterationListener(step_log_path=) needs the JSONL "
                f"step log, which comes with {_STEP_LOG_SLICE}")
        self.registry = (registry if registry is not None
                         else default_registry())
        if not isinstance(self.registry, MetricsRegistry):
            raise TypeError(f"registry must be a MetricsRegistry, got "
                            f"{type(self.registry).__name__}")
        self.prefix = prefix
        self._last: Optional[float] = None

    def __call__(self, model, iteration: int, score: float) -> None:
        now = time.perf_counter()
        wall_ms = None if self._last is None else (now - self._last) * 1000.0
        self._last = now
        reg, p = self.registry, self.prefix
        reg.counter(f"{p}_iterations_total").inc()
        reg.gauge(f"{p}_score").set(float(score))
        if wall_ms is not None:
            reg.histogram(f"{p}_iteration_ms").observe(wall_ms)
