"""Counterpart of ``deeplearning4j_tpu/ops/losses.py``: the loss functions
of ND4J's LossFunctions enum, by the same names (strings or enum members)
so JSON configs round-trip.

All losses are mean-per-example scalars; ``per_example_loss`` and
``per_example_loss_from_logits`` expose the values before the mean.
"""

from __future__ import annotations

import enum

import torch

_EPS = 1e-7


class LossFunction(str, enum.Enum):
    MSE = "MSE"
    EXPLL = "EXPLL"
    XENT = "XENT"
    MCXENT = "MCXENT"
    RMSE_XENT = "RMSE_XENT"
    SQUARED_LOSS = "SQUARED_LOSS"
    RECONSTRUCTION_CROSSENTROPY = "RECONSTRUCTION_CROSSENTROPY"
    NEGATIVELOGLIKELIHOOD = "NEGATIVELOGLIKELIHOOD"

    @classmethod
    def coerce(cls, v: "LossFunction | str") -> "LossFunction":
        if isinstance(v, LossFunction):
            return v
        return cls(str(v))


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def per_example_loss(kind: "LossFunction | str", labels: torch.Tensor,
                     output: torch.Tensor) -> torch.Tensor:
    """Per-example pre-reduction loss values, shape ``labels.shape[:-1]``;
    the scalar loss is ``finalize_loss(kind, mean(per_example))``."""
    kind = LossFunction.coerce(kind)
    if kind == LossFunction.MSE:
        return ((labels - output) ** 2).sum(-1) / 2.0
    if kind == LossFunction.SQUARED_LOSS:
        return ((labels - output) ** 2).sum(-1)
    if kind == LossFunction.RMSE_XENT:
        return (-(labels * torch.log(_clip(output)))).sum(-1)
    if kind in (LossFunction.XENT, LossFunction.RECONSTRUCTION_CROSSENTROPY):
        p = _clip(output)
        return -(labels * torch.log(p)
                 + (1.0 - labels) * torch.log(1.0 - p)).sum(-1)
    if kind in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        return -(labels * torch.log(_clip(output))).sum(-1)
    if kind == LossFunction.EXPLL:
        return (output - labels * torch.log(_clip(output))).sum(-1)
    raise ValueError(f"Unhandled loss function {kind}")


def per_example_loss_from_logits(kind: "LossFunction | str",
                                 labels: torch.Tensor,
                                 logits: torch.Tensor) -> torch.Tensor:
    """Per-example values for the fused softmax/sigmoid + cross-entropy
    path."""
    kind = LossFunction.coerce(kind)
    if kind in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)
    if kind in (LossFunction.XENT, LossFunction.RECONSTRUCTION_CROSSENTROPY):
        # sigmoid cross entropy on logits: max(x,0) - x*z + log(1+exp(-|x|))
        x, z = logits, labels
        per = torch.clamp_min(x, 0) - x * z + torch.log1p(torch.exp(-x.abs()))
        return per.sum(-1)
    raise ValueError(f"No fused-logits path for {kind}")


def finalize_loss(kind: "LossFunction | str",
                  mean_value: torch.Tensor) -> torch.Tensor:
    """Post-reduction transform: identity except RMSE_XENT's sqrt."""
    if LossFunction.coerce(kind) == LossFunction.RMSE_XENT:
        return torch.sqrt(mean_value + _EPS)
    return mean_value


def loss(kind: "LossFunction | str", labels: torch.Tensor,
         output: torch.Tensor) -> torch.Tensor:
    """Scalar loss. ``output`` is the network's activated output."""
    return finalize_loss(kind, per_example_loss(kind, labels, output).mean())


def loss_from_logits(kind: "LossFunction | str", labels: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """Stable fused softmax/sigmoid + cross-entropy path for the hot
    losses, used by the OUTPUT layer when the activation/loss pair allows it
    (softmax+MCXENT, sigmoid+XENT)."""
    return finalize_loss(
        kind, per_example_loss_from_logits(kind, labels, logits).mean())


FUSABLE = {
    ("softmax", LossFunction.MCXENT),
    ("softmax", LossFunction.NEGATIVELOGLIKELIHOOD),
    ("sigmoid", LossFunction.XENT),
    ("sigmoid", LossFunction.RECONSTRUCTION_CROSSENTROPY),
}
