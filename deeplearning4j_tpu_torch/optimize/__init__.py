"""Counterpart of ``deeplearning4j_tpu/optimize``: the updater, the
solvers and the guardrails with the divergence watchdog."""

from deeplearning4j_tpu_torch.optimize.updater import UpdaterState, init_updater_state, apply_updater  # noqa: F401
from deeplearning4j_tpu_torch.optimize.solver import Solver  # noqa: F401
from deeplearning4j_tpu_torch.optimize.guardrails import (  # noqa: F401
    DivergenceWatchdog,
    GuardConfig,
    guarded_sgd_update,
)
