"""Counterpart of ``deeplearning4j_tpu/scaleout/aggregator.py``, copied (no framework
in it).

Job aggregation — combining worker results into the master update.

Parity with ref: scaleout/aggregator/ (JobAggregator, WorkAccumulator) and
the Akka INDArrayAggregator (sum ÷ n parameter averaging).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.scaleout.job import Job


class JobAggregator:
    """ref: scaleout/aggregator/JobAggregator.java — accumulate(Job), aggregate()."""

    def accumulate(self, job: Job) -> None:
        raise NotImplementedError

    def aggregate(self):
        raise NotImplementedError


class ParameterAveragingAggregator(JobAggregator):
    """Running sum of flat param vectors, averaged on aggregate()
    (ref: aggregator/INDArrayAggregator.java)."""

    def __init__(self):
        self._sum: Optional[np.ndarray] = None
        self._count = 0

    def accumulate(self, job: Job) -> None:
        if job.result is None:
            return
        vec = np.asarray(job.result, dtype=np.float32)
        self._sum = vec.copy() if self._sum is None else self._sum + vec
        self._count += 1

    def aggregate(self) -> Optional[np.ndarray]:
        if self._sum is None or self._count == 0:
            return None
        return self._sum / self._count

    def reset(self) -> None:
        self._sum = None
        self._count = 0
