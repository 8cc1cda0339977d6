"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/redistribution.py``:
live redistribution of a tree already on the ranks' devices, as an
explicit program of collective steps (arXiv:2112.01075).

``reshard.restore_sharded`` assembles a rank's chunk on the host from a
checkpoint's files. When the source is a tree already resident on the
ranks (a trainer's sharded params adopted by a server, a re-placement onto
another mesh), this module moves it rank to rank instead.

The plans are JAX's, copied as pure spec logic. A same-mesh respec
(``plan_redistribution``) is at most three steps, each one sharding
transition:

    ``all_gather``   drop the mesh axes ``src`` splits over that ``dst``
                     does not
    ``all_to_all``   move axes that split DIFFERENT dims in ``src`` and
                     ``dst``
    ``slice``        add the axes ``dst`` splits over that ``src`` did not
                     (a local slice, no wire bytes)

in that order. A respec across two meshes over the same ranks
(``plan_cross_mesh``) is one step: ``ppermute`` when the per-dim shard
structure is unchanged (a permutation of the ranks' chunks), else
``all_to_all``. A ``rebind`` moves a leaf between one rank and a mesh.

A port tensor carries no sharding, so a leaf's placement is a
``Placement(mesh, spec)`` (``mesh`` None: the whole leaf on one rank,
``root``). ``apply_plan`` runs the steps on this rank's chunk with the
mesh's collectives (``parallel.mesh``): every rank of the mesh calls it.
Each step computes which saved rectangle of which rank covers the
rectangle a rank needs, so a step of any kind moves exactly the planned
bytes; ``parallel.mesh.COLLECTIVES`` counts one call a step: an
``all_gather`` step one all-gather, an ``all_to_all`` step one
all-to-all, ``ppermute`` one point-to-point exchange (``send_recv``) on
the ranks whose chunk moves, ``slice`` nothing (one all-to-all where a
dim's axes only change their order), a ``rebind`` one broadcast (onto the
mesh) or one all-gather (off it). Never a host assembly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from itertools import product
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Placement",
    "PlanStep",
    "placements",
    "RedistributionPlan",
    "apply_plan",
    "plan_cross_mesh",
    "plan_redistribution",
    "redistribute",
    "redistribute_tree",
]


def _norm_spec(spec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """A spec (tuple of entries) → per-dim tuples of mesh-axis names,
    padded with replicated dims to ``ndim``."""
    entries = tuple(spec) if spec is not None else ()
    out: List[Tuple[str, ...]] = []
    for e in entries:
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    while len(out) < ndim:
        out.append(())
    if len(out) > ndim:
        raise ValueError(
            f"spec {spec} names {len(out)} dims but the array has {ndim}")
    return tuple(out)


def _axis_dims(norm) -> dict:
    """{mesh axis name: tensor dim it shards} of a normalized spec."""
    out = {}
    for dim, axes in enumerate(norm):
        for a in axes:
            if a in out:
                raise ValueError(f"axis {a!r} appears twice in spec {norm}")
            out[a] = dim
    return out


def _to_spec(norm) -> tuple:
    """A normalized spec → ``parallel.sharding``'s tuple of entries."""
    return tuple(None if not axes else axes[0] if len(axes) == 1
                 else tuple(axes) for axes in norm)


@dataclass(frozen=True)
class PlanStep:
    """One collective step: after executing it the array carries ``spec``
    (a normalized per-dim tuple; None for the ``rebind`` step)."""

    kind: str  # all_gather | all_to_all | slice | ppermute | rebind | noop
    spec: Optional[tuple]
    note: str = ""

    def partition_spec(self) -> tuple:
        if self.spec is None:
            raise ValueError(f"{self.kind} step has no partition spec")
        return _to_spec(self.spec)


@dataclass
class RedistributionPlan:
    """The explicit collective program moving an array from ``src_spec``
    to ``dst_spec`` on ``mesh``. ``kinds()`` is the introspection handle
    tests and reports use."""

    mesh: object
    src_spec: tuple
    dst_spec: tuple
    steps: List[PlanStep] = field(default_factory=list)
    src_mesh: object = None

    def kinds(self) -> List[str]:
        return [s.kind for s in self.steps]


@dataclass(frozen=True)
class Placement:
    """Where a leaf lives: its chunks on ``mesh`` under ``spec`` (the
    ``NamedSharding`` of a port tensor), or with ``mesh`` None the whole
    leaf on rank ``root``."""

    mesh: object = None
    spec: tuple = ()
    root: int = 0


def plan_redistribution(src_spec, dst_spec, mesh,
                        ndim: Optional[int] = None) -> RedistributionPlan:
    """Derive the explicit same-mesh collective program from ``src_spec``
    to ``dst_spec`` (specs on ``mesh``): gather the axes ``dst`` drops,
    all-to-all the axes that change tensor dim, slice in the axes ``dst``
    adds — each step one sharding transition, at most three steps, empty
    for ``src == dst``. ``ndim`` bounds the per-dim normalization
    (default: as many dims as the longer spec names)."""
    if ndim is None:
        ndim = max(len(tuple(src_spec) if src_spec else ()),
                   len(tuple(dst_spec) if dst_spec else ()))
    src = _norm_spec(src_spec, ndim)
    dst = _norm_spec(dst_spec, ndim)
    for a in set(_axis_dims(src)) | set(_axis_dims(dst)):
        if a not in mesh.axis_names:
            raise ValueError(
                f"spec axis {a!r} is not on the mesh {mesh.axis_names}")
    plan = RedistributionPlan(mesh=mesh, src_spec=src, dst_spec=dst)
    if src == dst:
        return plan
    src_dims, dst_dims = _axis_dims(src), _axis_dims(dst)
    removed = {a for a in src_dims if a not in dst_dims}
    moved = {a for a in src_dims
             if a in dst_dims and dst_dims[a] != src_dims[a]}

    cur = src
    if removed:
        nxt = tuple(tuple(a for a in axes if a not in removed)
                    for axes in cur)
        if nxt != cur:
            plan.steps.append(PlanStep(
                "all_gather", nxt,
                note=f"gather axes {sorted(removed)} (dst drops them)"))
            cur = nxt
    if moved:
        kept = set(_axis_dims(cur))
        nxt = tuple(tuple(a for a in axes if a in kept) for axes in dst)
        if nxt != cur:
            plan.steps.append(PlanStep(
                "all_to_all", nxt,
                note=f"relocate axes {sorted(moved)} to their dst dims"))
            cur = nxt
    if cur != dst:
        plan.steps.append(PlanStep(
            "slice", dst, note="shard in the axes dst adds (local slice)"))
    return plan


def _shard_structure(placement: Placement, ndim: int):
    """Per-dim shard counts: equal structures across meshes make a respec
    a pure permutation of the ranks' chunks (the ppermute case)."""
    norm = _norm_spec(placement.spec, ndim)
    return tuple(math.prod(placement.mesh.shape[a] for a in axes)
                 for axes in norm)


def plan_cross_mesh(src: Placement, dst: Placement,
                    ndim: int) -> RedistributionPlan:
    """One-step plan for a respec across two meshes over the SAME ranks:
    ``ppermute`` when the per-dim shard structure is unchanged (only the
    ranks' order differs), else ``all_to_all``."""
    plan = RedistributionPlan(
        mesh=dst.mesh, src_mesh=src.mesh,
        src_spec=_norm_spec(src.spec, ndim),
        dst_spec=_norm_spec(dst.spec, ndim))
    if _shard_structure(src, ndim) == _shard_structure(dst, ndim):
        kind, note = "ppermute", ("rank-order permutation — same per-dim "
                                  "shard structure on a different mesh")
    else:
        kind, note = "all_to_all", ("cross-mesh respec — one all-to-all "
                                    "of the overlapping rectangles")
    plan.steps.append(PlanStep(kind, plan.dst_spec, note=note))
    return plan


# ------------------------------------------------------------ execution ----

def _rect(shape, spec, mesh, rank: int) -> Tuple[tuple, tuple]:
    from deeplearning4j_tpu_torch.parallel.sharding import local_region, \
        rank_coords

    return local_region(shape, _to_spec(spec), mesh.shape,
                        rank_coords(mesh, rank))


def _overlap(a, b):
    """The intersection of two (starts, sizes) rectangles, or None."""
    lo = [max(x, y) for x, y in zip(a[0], b[0])]
    hi = [min(x + n, y + m) for x, n, y, m in zip(a[0], a[1], b[0], b[1])]
    if any(l >= h for l, h in zip(lo, hi)):
        return None
    return tuple(lo), tuple(h - l for l, h in zip(lo, hi))


def _take(t: torch.Tensor, rect, region) -> torch.Tensor:
    """The part of ``t`` (holding ``rect``) that covers ``region``."""
    idx = tuple(slice(s - r, s - r + n)
                for s, n, r in zip(region[0], region[1], rect[0]))
    return t[idx]


def _put(out: torch.Tensor, rect, region, data: torch.Tensor) -> None:
    out[tuple(slice(s - r, s - r + n)
              for s, n, r in zip(region[0], region[1], rect[0]))] = \
        data.reshape(region[1])


def _line(mesh, axes, rank: int) -> List[int]:
    """The ranks that share ``rank``'s coordinates off ``axes``, in the
    order of ``Mesh.all_gather`` over ``axes`` (row-major in mesh
    order)."""
    from deeplearning4j_tpu_torch.parallel.sharding import rank_coords

    coords = rank_coords(mesh, rank)
    axes = [a for a in mesh.axis_names if a in axes]
    out = []
    for idx in product(*(range(int(mesh.shape[a])) for a in axes)):
        c = dict(coords, **dict(zip(axes, idx)))
        r = 0
        for a in mesh.axis_names:
            r = r * int(mesh.shape[a]) + c[a]
        out.append(r)
    return out


def _count(kind: str) -> None:
    from deeplearning4j_tpu_torch.parallel.mesh import COLLECTIVES

    COLLECTIVES[kind] += 1


def _covered(regions) -> int:
    return sum(math.prod(r[1]) for r in regions if r is not None)


def _step_gather(local, shape, cur, nxt, mesh):
    """One all-gather over the axes ``cur`` drops (over the whole mesh
    where those ranks' chunks do not cover the ``nxt`` rectangle: a
    dropped axis that was the major one of a dim); keep the ``nxt``
    rectangle."""
    axes = set(_axis_dims(cur)) - set(_axis_dims(nxt))
    me = mesh.rank
    want = _rect(shape, nxt, mesh, me)
    peers = _line(mesh, axes, me)
    if _covered([_overlap(_rect(shape, cur, mesh, q), want)
                 for q in peers]) != math.prod(want[1]):
        axes, peers = set(mesh.axis_names), list(range(mesh.size))
    if not axes:   # the chunk already holds the whole rectangle
        return _take(local, _rect(shape, cur, mesh, me), want).contiguous()
    flat = mesh.all_gather(local.reshape(1, -1).contiguous(), tuple(axes))
    out = local.new_empty(want[1])
    for i, q in enumerate(peers):
        have = _rect(shape, cur, mesh, q)
        region = _overlap(have, want)
        if region is not None:
            _put(out, want, region,
                 _take(flat[i].reshape(have[1]), have, region))
    return out


def _step_slice(local, shape, cur, nxt, mesh):
    """The ``nxt`` rectangle out of this rank's chunk; where it is not
    inside the chunk (axes reordered within a dim), one all-to-all."""
    have = _rect(shape, cur, mesh, mesh.rank)
    want = _rect(shape, nxt, mesh, mesh.rank)
    if _overlap(have, want) == want:
        return _take(local, have, want).contiguous()
    return _step_all_to_all(local, shape, mesh, cur, mesh, nxt)


def _step_all_to_all(local, shape, src_mesh, cur, dst_mesh, nxt):
    """One all-to-all over the mesh: each rank sends every rank the part
    of its ``cur`` rectangle that lies in that rank's ``nxt`` rectangle
    (nothing where they do not meet); pieces of unequal size go as split
    sizes."""
    mesh = dst_mesh
    me = mesh.rank
    have = _rect(shape, cur, src_mesh, me)
    want = _rect(shape, nxt, mesh, me)
    send, send_sizes, recv_sizes, regions = [], [], [], []
    for q in range(mesh.size):
        out_region = _overlap(have, _rect(shape, nxt, mesh, q))
        piece = _take(local, have, out_region).reshape(-1) \
            if out_region is not None else local.new_empty(0)
        send.append(piece)
        send_sizes.append(piece.numel())
        in_region = _overlap(_rect(shape, cur, src_mesh, q), want)
        regions.append(in_region)
        recv_sizes.append(0 if in_region is None
                          else math.prod(in_region[1]))
    inp = torch.cat(send)
    got = local.new_empty(sum(recv_sizes))
    if mesh.grouped:
        dist.all_to_all_single(got, inp, recv_sizes, send_sizes)
        _count("all_to_all")
    else:
        got = inp
    out = local.new_empty(want[1])
    at = 0
    for region, n in zip(regions, recv_sizes):
        if region is not None:
            _put(out, want, region, got[at:at + n])
        at += n
    return out


def _step_ppermute(local, shape, src_mesh, cur, dst_mesh, nxt):
    """Every rank takes its ``nxt`` rectangle from a rank that holds it
    under ``cur`` (itself where it can, else the lowest such rank, the
    same choice on every rank): one point-to-point exchange on the ranks
    whose chunk moves, nothing on the others."""
    n = dst_mesh.size
    held = [_rect(shape, cur, src_mesh, q) for q in range(n)]
    source = {}
    for r in range(n):
        want_r = _rect(shape, nxt, dst_mesh, r)
        holders = [q for q in range(n) if held[q] == want_r]
        source[r] = r if r in holders else holders[0]
    me = dst_mesh.rank
    ops = [dist.P2POp(dist.isend, local.contiguous(), r)
           for r in range(n) if source[r] == me and r != me]
    out = local
    if source[me] != me:
        out = local.new_empty(_rect(shape, nxt, dst_mesh, me)[1])
        ops.append(dist.P2POp(dist.irecv, out, source[me]))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        _count("send_recv")
    return out.clone() if out is local else out


def apply_plan(plan: RedistributionPlan, local: torch.Tensor,
               shape=None) -> torch.Tensor:
    """Run ``plan`` on this rank's chunk ``local`` of a leaf of global
    ``shape`` (default: ``local``'s shape times its split counts under
    the source spec); returns the rank's chunk under the plan's
    ``dst_spec``. Every rank of the mesh calls it."""
    src_mesh = plan.src_mesh if plan.src_mesh is not None else plan.mesh
    if shape is None:
        shape = _whole_shape(local, Placement(src_mesh, plan.src_spec))
    shape = tuple(int(d) for d in shape)
    cur, cur_mesh = plan.src_spec, src_mesh
    for step in plan.steps:
        if step.kind == "all_gather":
            local = _step_gather(local, shape, cur, step.spec, plan.mesh)
        elif step.kind == "slice":
            local = _step_slice(local, shape, cur, step.spec, plan.mesh)
        elif step.kind == "all_to_all":
            local = _step_all_to_all(local, shape, cur_mesh, cur,
                                     plan.mesh, step.spec)
        elif step.kind == "ppermute":
            local = _step_ppermute(local, shape, cur_mesh, cur, plan.mesh,
                                   step.spec)
        else:
            raise ValueError(f"unknown plan step {step.kind!r}")
        cur, cur_mesh = step.spec, plan.mesh
    return local


def _same_mesh(a, b) -> bool:
    return a is b or (tuple(a.axis_names) == tuple(b.axis_names)
                      and dict(a.shape) == dict(b.shape))


def redistribute(local: torch.Tensor, dst: Placement,
                 src: Placement = Placement(), shape=None) -> torch.Tensor:
    """Move one leaf from ``src`` to ``dst`` rank to rank, never through
    a host assembly: ``local`` is this rank's chunk under ``src``, the
    result its chunk under ``dst``. Every rank of the mesh calls it.

    - already there → returned as it is;
    - same mesh → the ``plan_redistribution`` program;
    - another mesh over the same ranks → the one-step ``plan_cross_mesh``;
    - between one rank and a mesh (``mesh`` None on one side) → a
      ``rebind``: a broadcast from ``src.root`` then this rank's slice
      (onto the mesh), or one all-gather of the chunks (off it: every
      rank then holds the whole leaf, ``dst.root`` among them).
    """
    if src == dst:
        return local
    if src.mesh is not None and dst.mesh is not None:
        shape = _whole_shape(local, src) if shape is None else shape
        ndim = len(shape)
        if _same_mesh(src.mesh, dst.mesh):
            plan = plan_redistribution(src.spec, dst.spec, dst.mesh, ndim)
        else:
            plan = plan_cross_mesh(src, dst, ndim)
        return apply_plan(plan, local, shape)
    if src.mesh is None and dst.mesh is None:
        return local
    if src.mesh is None:
        mesh = dst.mesh
        if mesh.grouped:
            # into a copy: the caller's tensor is not written
            local = local.clone(memory_format=torch.contiguous_format)
            dist.broadcast(local, src=src.root)
            _count("broadcast")
        from deeplearning4j_tpu_torch.parallel.sharding import local_chunk

        return local_chunk(local, dst.spec, mesh)
    shape = _whole_shape(local, src)
    ndim = len(shape)
    return _step_gather(local, shape, _norm_spec(src.spec, ndim),
                        _norm_spec((), ndim), src.mesh)


def _whole_shape(local: torch.Tensor, src: Placement) -> tuple:
    """A leaf's global shape from this rank's chunk under ``src``."""
    from deeplearning4j_tpu_torch.parallel.sharding import global_shape

    return global_shape(local.shape, src.spec, src.mesh.shape)


def redistribute_tree(tree, dst_shardings, src_shardings=None):
    """Tree twin of ``redistribute``: ``dst_shardings`` and
    ``src_shardings`` mirror ``tree`` with ``Placement`` leaves (a None
    entry of ``dst_shardings`` leaves the leaf untouched; ``src_shardings``
    None: every leaf whole on rank 0). The live path of the serving cold
    start from a trainer's tree; ``reshard.restore_sharded`` stays the
    disk path."""
    from deeplearning4j_tpu_torch._device import tree_leaves, \
        tree_unflatten

    leaves = tree_leaves(tree)
    dsts = _placements(dst_shardings, tree)
    srcs = [Placement()] * len(leaves) if src_shardings is None else \
        _placements(src_shardings, tree)
    return tree_unflatten(tree, [
        leaf if d is None else redistribute(leaf, d, s)
        for leaf, d, s in zip(leaves, dsts, srcs)])


def _placements(shardings, tree) -> list:
    """The ``Placement`` at every leaf of ``tree`` (a Placement stands
    for a whole subtree)."""
    if isinstance(shardings, Placement) or shardings is None:
        from deeplearning4j_tpu_torch._device import tree_leaves

        return [shardings] * len(tree_leaves(tree))
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _placements(shardings.get(k), tree[k])]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _placements(shardings[i], v)]
    return [shardings]


def placements(specs, tree, mesh):
    """A ``Placement`` tree mirroring ``tree``: each leaf's spec from
    ``specs`` (``parallel.sharding``'s spec trees; None or a missing
    entry: replicated) on ``mesh``."""
    from deeplearning4j_tpu_torch._device import tree_unflatten
    from deeplearning4j_tpu_torch.parallel.sharding import spec_leaves

    return tree_unflatten(tree, [Placement(mesh, tuple(s or ()))
                                 for s in spec_leaves(specs, tree)])
