"""Counterpart of ``deeplearning4j_tpu/parallel/moe.py``.

Ported so far: ``_routing``, which the single-device ``dense_moe`` of the
transformer LM uses, and the training step's ``load_balance_loss`` and
``router_load_fraction``. Expert-parallel dispatch (replicated, all-to-all)
comes with the composed-parallelism slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.activations import softmax


def _top_k_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index first (``jax.lax.top_k``'s order): a stable descending
    sort, where ``torch.topk`` documents no tie order."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]


def _routing(logits: torch.Tensor, top_k: int):
    """(N, E) logits → (idx (N,k), gates (N,k)). Gates are softmax probs of
    the chosen experts, renormalized to sum to 1 when k > 1 (GShard)."""
    probs = softmax(logits)
    idx = _top_k_indices(logits, top_k)
    g = torch.gather(probs, 1, idx)
    if top_k > 1:
        g = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
    return idx, g


def load_balance_loss(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer auxiliary load-balancing loss: E · Σ_e f_e · P_e
    with f_e the fraction of tokens whose TOP-1 choice is e (no gradient
    through the argmax, as in JAX; ``torch.argmax`` and ``jnp.argmax`` both
    take the first maximal index) and P_e the mean router probability."""
    logits = x @ router_w
    probs = softmax(logits)
    n_experts = router_w.shape[1]
    f = F.one_hot(logits.argmax(-1), n_experts).to(
        torch.promote_types(logits.dtype, torch.float32)).mean(0)
    return n_experts * torch.sum(f * probs.mean(0))


def router_load_fraction(router_w: torch.Tensor, x: torch.Tensor,
                         top_k: int = 1) -> torch.Tensor:
    """(E,) fraction of (token, choice) routes landing on each expert; sums
    to 1 (each of the N·k routes counts once). Differentiation-free."""
    idx, _ = _routing(x @ router_w, top_k)
    n_experts = router_w.shape[1]
    return F.one_hot(idx, n_experts).to(torch.float32).mean((0, 1))
