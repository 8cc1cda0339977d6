"""Counterpart of ``deeplearning4j_tpu/optimize``: the updater, the
solvers and the guardrails. The divergence watchdog comes with ROADMAP
slice 8."""

from deeplearning4j_tpu_torch.optimize.updater import UpdaterState, init_updater_state, apply_updater  # noqa: F401
from deeplearning4j_tpu_torch.optimize.solver import Solver  # noqa: F401
from deeplearning4j_tpu_torch.optimize.guardrails import (  # noqa: F401
    GuardConfig,
    guarded_sgd_update,
)
