"""Counterpart of ``deeplearning4j_tpu/ops/dtypes.py``: the dtype policy.

Params are kept in float32 (master weights); compute may run in bfloat16.
The train step casts params and input to ``compute_dtype`` inside the loss
and keeps master params, updater state and the loss in float32, exactly as
the JAX step does (an explicit cast, not autocast).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


DEFAULT = Policy()
BF16_COMPUTE = Policy(compute_dtype=torch.bfloat16)


def cast_in(policy: Policy, x: torch.Tensor) -> torch.Tensor:
    return x.to(policy.compute_dtype)


def cast_out(policy: Policy, x: torch.Tensor) -> torch.Tensor:
    return x.to(policy.output_dtype)
