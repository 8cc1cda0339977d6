"""Counterpart of ``deeplearning4j_tpu/parallel/moe.py``: grouped
multi-expert capacity MoE with its dispatches over the "expert" axis.

Experts live on the "expert" mesh axis in GROUPS: ``n_experts = G ×
axis size``; the rank at index d holds the contiguous group [d·G,
(d+1)·G) (``shard_expert_params``), and ``expert_fn(params, x)`` applies a
group: params with a leading (G, ...) expert axis, x (G, C, d) → (G, C, d)
(what ``jax.vmap`` of the JAX package's one-expert function computes).

One process per rank. ``moe_apply`` takes this rank's tokens (N_local, d),
its shard over ``token_axes``, replicated over the expert axis, and returns
the MoE output of the same tokens, replicated over the expert axis. The
dispatches, behind the same seam as the JAX package's (per-call ``impl=``
> ``set_moe_impl`` > ``DL4J_TPU_MOE_IMPL`` > auto):

- ``"alltoall"`` (GShard): each rank routes its own contiguous 1/ep of the
  tokens, ranks its routes in position order by the cumsum of their
  one-hot (capacity C per (expert, sub-shard), overflow parked in a dump
  row and dropped), exchanges the (ep, G, C, d) buffer with an all-to-all,
  runs its experts on what it received, returns the results with the
  inverse all-to-all, and the outputs are all-gathered over the axis.
- ``"alltoall_2d"``: the same exchange factorized into two grouped
  all-to-alls over the (outer, inner) grid of the axis
  (``factor_expert_axis``); the values are bit-identical to the flat one.
- ``"replicated"``: every rank routes every token, takes the first C routed
  to each of its experts, and the outputs are summed over the axis.

Gradients: the dispatch sits inside the differentiated region, so each
collective carries its transpose (``parallel.mesh``'s autograd
collectives): the split's backward gathers dx, the gather's backward takes
this rank's slice of the replicated cotangent, the all-to-alls transpose to
themselves, and the router's gradient (and the replicated dispatch's dx)
is summed over the expert axis. Expert grads cover this rank's token
shard; the caller sums them, like every grad, over ``token_axes`` (the
composed step does).

``load_balance_loss`` (the Switch auxiliary), ``router_load_fraction``,
``dropped_route_fraction``, ``expert_load``, ``expected_dropped`` and
``moe_reference`` are local functions of the tokens they are given.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ops.activations import softmax
from deeplearning4j_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    all_to_all_ad,
    gather_rows_ad,
    split_rows_ad,
    sum_forward_ad,
    sum_grads_ad,
)

# dispatch-impl seam (the attention core's precedence chain):
# per-call impl= > set_moe_impl > DL4J_TPU_MOE_IMPL env > auto
MOE_IMPL_ENV = "DL4J_TPU_MOE_IMPL"
_IMPLS = ("alltoall", "alltoall_2d", "replicated")
_impl_override: Optional[str] = None


def set_moe_impl(impl: Optional[str]) -> None:
    """Force the MoE dispatch: "alltoall", "alltoall_2d", "replicated", or
    None for auto."""
    if impl not in (None,) + _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; "
                         "options: alltoall, alltoall_2d, replicated, None")
    global _impl_override
    _impl_override = impl


def get_moe_impl() -> Optional[str]:
    """The effective global override: set_moe_impl's value, else the
    ``DL4J_TPU_MOE_IMPL`` environment variable, else None (auto)."""
    if _impl_override is not None:
        return _impl_override
    env = os.environ.get(MOE_IMPL_ENV)
    if env:
        if env not in _IMPLS:
            raise ValueError(
                f"{MOE_IMPL_ENV}={env!r}; options: " + ", ".join(_IMPLS))
        return env
    return None


def resolve_moe_impl(n_tokens: Optional[int] = None,
                     n_shards_alltoall: Optional[int] = None,
                     impl: Optional[str] = None) -> Optional[str]:
    """Collapse the precedence chain to the dispatch that will run:
    per-call > override > env var > (given the GLOBAL token count and the
    alltoall shard count) alltoall where the tokens subdivide evenly,
    replicated otherwise."""
    impl = impl or get_moe_impl()
    if impl is None and n_tokens is not None and n_shards_alltoall:
        impl = ("alltoall" if n_tokens % n_shards_alltoall == 0
                else "replicated")
    return impl


def _rows(mesh, token_axes: tuple) -> int:
    return math.prod(mesh.shape[a] for a in token_axes) if token_axes else 1


def route_shards(mesh, token_axes: tuple = (), axis: str = EXPERT_AXIS,
                 n_tokens: Optional[int] = None,
                 impl: Optional[str] = None) -> int:
    """Number of token sub-shards that route independently (the unit
    capacity applies per) under the RESOLVED impl, for the GLOBAL token
    count ``n_tokens``: the token rows for "replicated", rows × the
    expert-axis size for the all-to-alls."""
    rows = _rows(mesh, token_axes)
    n_dev = mesh.shape[axis]
    eff = resolve_moe_impl(n_tokens, rows * n_dev, impl)
    return rows * n_dev if (eff or "").startswith("alltoall") else rows


def factor_expert_axis(n_dev: int) -> tuple:
    """The balanced ``(outer, inner)`` grid of a p-rank expert axis:
    ``inner`` is the largest divisor of p with inner² ≤ p. A prime (or
    < 4) axis size has no grid with both factors >= 2 and raises."""
    n_dev = int(n_dev)
    inner = 0
    for d in range(2, int(math.isqrt(n_dev)) + 1):
        if n_dev % d == 0:
            inner = d
    if n_dev < 4 or inner == 0:
        raise ValueError(
            f"expert axis size {n_dev} is not factorizable into an "
            "(outer, inner) grid with both factors >= 2 — alltoall_2d "
            "needs a composite axis size; use impl='alltoall' instead")
    return n_dev // inner, inner


def _a2a_hierarchical(x: torch.Tensor, mesh, axis: str, outer: int,
                      inner: int) -> torch.Tensor:
    """The two-phase all-to-all of an ``(n_dev, ...)`` buffer (``x[dst]``
    for the rank at index ``dst``; returns ``y[src]`` from the rank at
    ``src``), the same values as the flat ``Mesh.all_to_all``. Rank d sits
    at (o, i) = (d // inner, d % inner): phase 1 exchanges within its run
    of ``inner`` consecutive ranks, phase 2 across the ``outer`` ranks at
    stride ``inner``."""
    intra, inter = mesh.factor_group(axis, outer, inner)
    s = x.reshape((outer, inner) + tuple(x.shape[1:])).transpose(0, 1)
    s = all_to_all_ad(mesh, s, axis, intra).transpose(0, 1)
    s = all_to_all_ad(mesh, s, axis, inter)
    return s.reshape(x.shape)


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


# ------------------------------------------------------ replicated dispatch ----

def _dispatch_replicated(local_params, router_w, x, capacity: int, mesh,
                         axis: str, expert_fn: Callable, top_k: int,
                         group: int):
    """Every rank routes all of x (n, d), gathers the first ``capacity``
    tokens routed to each of its G experts in position order, and the
    outputs are summed over the expert axis."""
    my = mesh.axis_index(axis)
    n, d = x.shape
    idx, gates = _routing(x @ router_w, top_k)
    eids = my * group + torch.arange(group, device=x.device)
    mine_k = idx[None] == eids[:, None, None]                 # (G, n, k)
    mine = mine_k.any(-1)                                     # (G, n)
    gate_here = torch.sum(gates[None] * mine_k, dim=-1)       # (G, n)
    pos = torch.arange(n, device=x.device)
    # mine-in-order first: rank tokens by (not mine, position)
    order = torch.argsort(torch.where(mine, pos, n + pos), dim=1)
    slots = order[:, :capacity]                               # (G, C)
    valid = torch.gather(mine, 1, slots)
    tokens = x[slots] * valid[..., None].to(x.dtype)          # (G, C, d)
    y = expert_fn(local_params, tokens)
    g = torch.gather(gate_here, 1, slots) * valid
    y = y * g[..., None].to(y.dtype)
    out = torch.zeros((n, d), dtype=y.dtype, device=x.device).index_add(
        0, slots.reshape(-1), y.reshape(-1, d))
    # combine expert shards; a top-2 token sums its two experts' outputs
    return sum_forward_ad(mesh, out, axis)


# -------------------------------------------------------- alltoall dispatch ----

def _dispatch_alltoall(local_params, router_w, x, capacity: int, mesh,
                       axis: str, expert_fn: Callable, top_k: int,
                       group: int, n_dev: int, split: Optional[tuple] = None):
    """This rank's own sub-shard x (n, d): GShard's cumsum-of-one-hot
    ranking (rank r of a route = how many earlier routes chose the same
    expert; r >= C drops), the (n_dev, G, C, d) capacity buffer exchanged
    by all-to-all (``split``: the two-phase form), the local experts on
    what arrived, and the results back by the inverse exchange."""
    n, d = x.shape
    n_experts = n_dev * group
    idx, gates = _routing(x @ router_w, top_k)
    flat_e = idx.reshape(-1)                          # (n·k,) position order
    onehot = F.one_hot(flat_e, n_experts)
    rank = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=1) - 1
    keep = rank < capacity
    # slot in the (E, C) dispatch buffer; dropped routes park in a dump row
    slot = torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(rank, n_experts * capacity))
    tok_ids = torch.arange(n, device=x.device).repeat_interleave(top_k)
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype,
                      device=x.device).index_add(0, slot, x[tok_ids])
    send = buf[:n_experts * capacity].reshape(n_dev, group, capacity, d)
    if split is not None:
        recv = _a2a_hierarchical(send, mesh, axis, *split)
    else:
        recv = all_to_all_ad(mesh, send, axis)
    # recv[s, g]: source rank s's capacity slab for my local expert g
    toks = recv.transpose(0, 1).reshape(group, n_dev * capacity, d)
    y = expert_fn(local_params, toks)
    y = y.reshape(group, n_dev, capacity, d).transpose(0, 1)
    if split is not None:
        back = _a2a_hierarchical(y, mesh, axis, *split)
    else:
        back = all_to_all_ad(mesh, y, axis)
    # back reshaped (E·C, d) lines up with `slot`; the dump row gives zeros
    ybuf = torch.cat([back.reshape(n_experts * capacity, d),
                      back.new_zeros((1, d))])
    route_y = ybuf[slot]
    w = gates.reshape(-1) * keep
    return torch.zeros((n, d), dtype=route_y.dtype,
                       device=x.device).index_add(
        0, tok_ids, route_y * w[:, None].to(route_y.dtype))


def moe_apply(router_w: torch.Tensor, expert_params, x: torch.Tensor, mesh,
              expert_fn: Callable, capacity: int, axis: str = EXPERT_AXIS,
              top_k: int = 1, token_axes: tuple = (),
              impl: Optional[str] = None) -> torch.Tensor:
    """Top-k (k ∈ {1, 2}) MoE over grouped experts sharded on ``axis``.

    router_w: (d, E) replicated; expert_params: this rank's group, leaves
    with a leading (G, ...) axis, G = E / axis size (``shard_expert_params``);
    x: (N_local, d), this rank's tokens over ``token_axes`` (replicated
    over ``axis``). Returns (N_local, d), replicated over ``axis``; routes
    beyond an expert's per-sub-shard capacity contribute zeros (count them
    with ``expected_dropped`` / ``dropped_route_fraction``). ``impl``
    selects the dispatch for THIS call, else the set_moe_impl/env/auto
    chain decides on the global token count (module docstring). Every
    rank of the mesh calls it. Expert grads cover this rank's token shard:
    the caller sums them over ``token_axes``."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    if impl is not None and impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; "
                         "options: " + ", ".join(_IMPLS))
    n_dev = mesh.shape[axis]
    n_experts = router_w.shape[1]
    if n_experts % n_dev:
        raise ValueError(
            f"router_w has {n_experts} experts but mesh axis {axis!r} has "
            f"{n_dev} devices — grouped dispatch needs n_experts to be a "
            "multiple of the axis size (G experts per device)")
    group = n_experts // n_dev
    if top_k > n_experts:
        raise ValueError(f"top_k={top_k} > {n_experts} experts")
    for leaf in tree_leaves(expert_params):
        if leaf.shape[0] != group:
            raise ValueError(
                f"expert param leading dim {leaf.shape[0]} != {group}, this "
                f"rank's group of the {n_experts} experts over {n_dev} "
                f"devices of {axis!r} (shard_expert_params gives it)")

    rows = _rows(mesh, token_axes)
    n_tokens = x.shape[0] * rows
    eff = resolve_moe_impl(n_tokens, rows * n_dev, impl)
    # the router (and the replicated dispatch's tokens) feed routes that
    # differ from rank to rank: their grads sum over the axis
    rw, = sum_grads_ad(mesh, [router_w], axis)
    if eff in ("alltoall", "alltoall_2d"):
        if n_tokens % (rows * n_dev):
            raise ValueError(
                f"{eff} dispatch needs the token dim ({n_tokens}) to "
                f"divide over token_axes × {axis!r} ({rows}×{n_dev}); pass "
                "impl='replicated' or pad the token stream")
        split = factor_expert_axis(n_dev) if eff == "alltoall_2d" else None
        mine = split_rows_ad(mesh, x, axis)
        out = _dispatch_alltoall(expert_params, rw, mine, capacity, mesh,
                                 axis, expert_fn, top_k, group, n_dev,
                                 split=split)
        return gather_rows_ad(mesh, out, axis)
    x, = sum_grads_ad(mesh, [x], axis)
    return _dispatch_replicated(expert_params, rw, x, capacity, mesh, axis,
                                expert_fn, top_k, group)


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


def _shard_counts(router_w, x, top_k: int, n_shards: int) -> torch.Tensor:
    """(n_shards, E) routes per expert in each contiguous sub-shard."""
    with torch.no_grad():
        idx, _ = _routing(x @ router_w, top_k)
        onehot = F.one_hot(idx, router_w.shape[1]).to(torch.float32)
        per = x.shape[0] // n_shards
        return onehot.reshape(n_shards, per, top_k, -1).sum((1, 2))


def _dropped_routes(router_w: torch.Tensor, x: torch.Tensor, capacity: int,
                   top_k: int = 1, n_shards: int = 1) -> torch.Tensor:
    """f32 count of (token, choice) routes over the per-(expert,
    sub-shard) capacity, x split into ``n_shards`` contiguous sub-shards.
    Differentiation-free."""
    counts = _shard_counts(router_w, x, top_k, n_shards)
    return torch.sum(torch.clamp_min(counts - capacity, 0.0))


def dropped_route_fraction(router_w: torch.Tensor, x: torch.Tensor,
                           capacity: int, top_k: int = 1,
                           n_shards: int = 1) -> torch.Tensor:
    """Fraction of (token, choice) routes that overflow the per-(expert,
    sub-shard) capacity (``moe_dropped_frac``); ``n_shards`` is the
    routing sub-shard count of the active dispatch (``route_shards``).
    Differentiation-free."""
    return _dropped_routes(router_w, x, capacity, top_k, n_shards) / (
        x.shape[0] * top_k)


def expert_load(router_w: torch.Tensor, x: torch.Tensor,
                top_k: int = 1) -> torch.Tensor:
    """(E,) count of tokens routed to each expert (any of their k
    choices)."""
    with torch.no_grad():
        idx, _ = _routing(x @ router_w, top_k)
    return torch.bincount(idx.reshape(-1), minlength=router_w.shape[1])


def expected_dropped(router_w: torch.Tensor, x: torch.Tensor, capacity: int,
                     top_k: int = 1, n_shards: int = 1) -> int:
    """How many (token, expert) routes overflow an expert's capacity under
    ``n_shards`` independent routing sub-shards (1 = the replicated path
    on an unsharded token stream)."""
    n = x.shape[0]
    per = n // n_shards
    total = 0
    for s in range(n_shards):
        counts = expert_load(router_w, x[s * per:(s + 1) * per], top_k)
        total += int(torch.sum(torch.clamp_min(counts - capacity, 0)))
    return total


def _one_expert(expert_fn: Callable, params, x: torch.Tensor):
    """``expert_fn`` (a group's) on ONE expert's params and tokens."""
    stacked = tree_map(lambda _, a: torch.as_tensor(a)[None], params)
    return expert_fn(stacked, x[None])[0]


def moe_reference(router_w, expert_params_list, x, expert_fn: Callable,
                  capacity: int, top_k: int = 1,
                  n_token_shards: int = 1) -> torch.Tensor:
    """Dense single-process reference with the same routing and capacity
    semantics (for tests): x splits into ``n_token_shards`` contiguous
    chunks, each routing independently with its own per-expert capacity,
    and the first ``capacity`` tokens routed to an expert (position order)
    are kept. ``expert_params_list`` holds one expert's params each."""
    x = torch.as_tensor(x)
    router_w = torch.as_tensor(router_w)
    n = x.shape[0]
    per = n // n_token_shards
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        for s in range(n_token_shards):
            xs = x[s * per:(s + 1) * per]
            idx, gates = _routing(xs @ router_w, top_k)
            for e, params in enumerate(expert_params_list):
                routed_here = idx == e                   # (per, k)
                tok = torch.nonzero(routed_here.any(-1))[:, 0][:capacity]
                if tok.numel() == 0:
                    continue
                y = _one_expert(expert_fn, params, xs[tok])
                g = (gates[tok] * routed_here[tok]).sum(-1)
                out[s * per + tok] += (y * g[:, None]).float()
    return out


def stack_expert_params(per_expert: list):
    """[{k: tensor}, ...] → {k: (E, ...) tensor} for moe_apply."""
    from deeplearning4j_tpu_torch.parallel.sharding import \
        stack_along_leading_axis

    return stack_along_leading_axis(per_expert)


def shard_expert_params(stacked, mesh, axis: str = EXPERT_AXIS):
    """This rank's contiguous group of G = E / axis size experts of the
    stacked (E, ...) params (E must be a multiple of the axis size)."""
    from deeplearning4j_tpu_torch.parallel.sharding import shard_leading_axis

    return shard_leading_axis(stacked, mesh, axis)

