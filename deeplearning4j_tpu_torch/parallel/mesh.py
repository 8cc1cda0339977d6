"""Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``: the device mesh
over ``torch.distributed`` ranks.

The JAX package runs one controller over a mesh of devices. Here, as is
PyTorch's idiom, there is one process per device: a mesh's devices are the
ranks of the default process group, one device per rank — ``cuda:<local
rank>`` under NCCL, the CPU under gloo. With no group initialised a mesh
has one rank and its collectives are the identity; a group of one rank
runs them through the backend.

Axis names used throughout the framework:
- "data"   — data parallelism (the reference's only axis)
- "model"  — tensor parallelism (parallel/tensor_parallel.py)
- "sp"     — sequence parallelism (ring and Ulysses attention)
- "expert" — expert parallelism (the MoE dispatch)
- "pipe"   — pipeline stages

A multi-axis mesh lays the ranks out row-major over its axes. Each set of
axes has its sub-groups: the ranks that share every OTHER coordinate (for
one axis, a line of the mesh along it). ``__init__`` creates every such
group on every rank, in one order, as ``torch.distributed.new_group``
requires; a set of axes that spans the whole group uses the default group.
The axis-scoped collectives (``all_reduce(t, axes=)``, ``all_gather(t,
axis=)``, ``all_to_all(t, axis)``, ``exchange`` and ``ring_shift``) run in
this rank's sub-group. ``COLLECTIVES`` counts the calls they make to
``torch.distributed``, as the kernel wrappers count launches in
``ops._kernels.LAUNCHES``: a run can show that a synchronous step made
exactly one all-reduce. With no process group every collective is the
identity; a group of one rank still issues them. Each call is also
recorded, with its payload bytes and group size, into an active step
profile (``telemetry.xprofile``), which turns it into wire bytes.
"""

from __future__ import annotations

from itertools import combinations, product
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple, Union

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import _capture

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "sp"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                               "all_to_all": 0, "send_recv": 0,
                               "broadcast": 0}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _group_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _rank_device() -> Optional[torch.device]:
    """This rank's device: ``cuda:<local rank>`` under NCCL, the CPU under
    gloo, None with no group (the caller's device then stands)."""
    if not dist.is_initialized():
        return None
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


Axes = Union[None, str, Sequence[str]]


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis name to size (``jax.sharding.Mesh.shape``),
    ``size`` is their product, ``rank`` this process's rank and ``device``
    its device (None with no group). ``coords`` is this rank's index on
    each axis, ranks laid out row-major over the axes."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s)
                                      for a, s in zip(self.axis_names, sizes)}
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        size = 1
        for s in self.shape.values():
            size *= s
        world = _group_size()
        if size != world:
            raise ValueError(
                f"a mesh of shape {tuple(self.shape.values())} needs {size} "
                f"ranks, and the process group has world size {world}: a "
                "mesh spans every rank of the group, one device each")
        self.size = size
        # with a group, even of one rank, collectives go to it
        self.grouped = dist.is_initialized()
        self.rank = _group_rank()
        self.device = _rank_device()
        self.strides: Dict[str, int] = {}
        stride = 1
        for a in reversed(self.axis_names):
            self.strides[a] = stride
            stride *= self.shape[a]
        self.coords = {a: (self.rank // self.strides[a]) % self.shape[a]
                       for a in self.axis_names}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._factor_groups: Dict[tuple, tuple] = {}
        if self.grouped:
            self._make_groups()

    # ------------------------------------------------------------ groups --

    def _line(self, axes: Tuple[str, ...], coords: Dict[str, int]) -> list:
        """The ranks that share ``coords`` on every axis outside ``axes``,
        in row-major order over ``axes``."""
        base = sum(coords[a] * self.strides[a] for a in self.axis_names
                   if a not in axes)
        return [base + sum(i * self.strides[a] for a, i in zip(axes, idx))
                for idx in product(*(range(self.shape[a]) for a in axes))]

    def _make_groups(self) -> None:
        """One process group per line of every proper subset of the axes,
        created on every rank in the same order (subsets by size, then
        axis order; lines row-major over the other axes)."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in combinations(names, k):
                others = [a for a in names if a not in axes]
                if all(self.shape[a] == 1 for a in others):
                    self._groups[axes] = None   # spans the group
                    continue
                for idx in product(*(range(self.shape[a]) for a in others)):
                    ranks = self._line(axes, dict(zip(others, idx)))
                    g = dist.new_group(ranks=ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple in mesh order (None: every axis)."""
        if axes is None:
            return self.axis_names
        if isinstance(axes, str):
            axes = (axes,)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not on the mesh "
                                 f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Axes = None):
        """This rank's process group over ``axes`` (None: the default
        group)."""
        axes = self._axes(axes)
        return self._groups.get(axes) if axes != self.axis_names else None

    def axis_size(self, axis: str) -> int:
        """``lax.psum(1, axis)``."""
        return self.shape[self._axes(axis)[0]]

    def axis_index(self, axis: str) -> int:
        """``lax.axis_index(axis)``: this rank's coordinate on ``axis``."""
        return self.coords[self._axes(axis)[0]]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` on ``axis`` with this rank's other
        coordinates."""
        return self.rank + (index - self.coords[axis]) * self.strides[axis]

    # ------------------------------------------------------- collectives --

    def all_reduce(self, t: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        """Sum ``t`` over the ranks of ``axes`` (default: the whole mesh),
        in place (``lax.psum``); the identity with no process group or
        an empty ``axes``."""
        if axes is not None and not self._axes(axes):
            return t
        if self.grouped:
            group = self.group(axes)
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            COLLECTIVES["all_reduce"] += 1
            if _capture._active is not None:
                _capture.collective("all_reduce", _nbytes(t),
                                    dist.get_world_size(group))
        return t

    def all_gather(self, t: torch.Tensor, axis: Axes = None) -> torch.Tensor:
        """Every rank's ``t`` over ``axis`` (default: the whole mesh)
        stacked along dim 0 in axis order (``lax.all_gather(...,
        tiled=True)``); ``t`` itself with no process group."""
        if not self.grouped:
            return t
        n = 1
        for a in self._axes(axis):
            n *= self.shape[a]
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(),
                                    group=self.group(axis))
        COLLECTIVES["all_gather"] += 1
        if _capture._active is not None:
            _capture.collective("all_gather", _nbytes(out), n)
        return out

    def all_to_all(self, t: torch.Tensor, axis: Axes,
                   group=None) -> torch.Tensor:
        """``lax.all_to_all(t, axis, 0, 0, tiled=True)``: dim 0 splits into
        one chunk per rank of ``axis`` (of ``group``, an explicit sub-group
        of it, ``factor_group``'s); chunk j goes to the rank at index j,
        and the result holds, at chunk i, what the rank at index i sent
        here. ``t`` itself with no process group."""
        if not self.grouped:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        group = group or self.group(axis)
        dist.all_to_all_single(out, t, group=group)
        COLLECTIVES["all_to_all"] += 1
        if _capture._active is not None:
            _capture.collective("all_to_all", _nbytes(t),
                                dist.get_world_size(group))
        return out

    def factor_group(self, axis: str, outer: int, inner: int) -> tuple:
        """(intra, inter): this rank's groups of the (outer, inner) grid
        that ``axis`` folds into, index ``o·inner + i``: the ``inner``
        consecutive ranks of its run and the ``outer`` ranks at stride
        ``inner``. Created at the first call for a grid, which every rank
        of the mesh makes in the same order."""
        key = (axis, outer, inner)
        if key not in self._factor_groups:
            mine = {}
            others = [a for a in self.axis_names if a != axis]
            for idx in product(*(range(self.shape[a]) for a in others)):
                line = self._line((axis,), dict(zip(others, idx)))
                runs = {"intra": [[line[o * inner + i] for i in range(inner)]
                                  for o in range(outer)],
                        "inter": [[line[o * inner + i] for o in range(outer)]
                                  for i in range(inner)]}
                for kind in ("intra", "inter"):
                    for ranks in runs[kind]:
                        g = dist.new_group(ranks=ranks)
                        if self.rank in ranks:
                            mine[kind] = g
            self._factor_groups[key] = (mine["intra"], mine["inter"])
        return self._factor_groups[key]

    def broadcast(self, t: torch.Tensor, axis: str, index: int
                  ) -> torch.Tensor:
        """The value of ``t`` at ``index`` on ``axis``, in place on every
        rank of the line."""
        if self.grouped:
            dist.broadcast(t, src=self.peer(axis, index),
                           group=self.group(axis))
            COLLECTIVES["broadcast"] += 1
            if _capture._active is not None:
                _capture.collective("broadcast", _nbytes(t),
                                    self.shape[axis])
        return t

    def exchange(self, axis: str, send: Iterable[torch.Tensor] = (),
                 recv: Iterable[torch.Tensor] = (), step: int = 1,
                 wrap: bool = False) -> Callable[[], List[torch.Tensor]]:
        """Start one point-to-point exchange along ``axis``: ``send`` goes
        to the rank ``step`` ahead, ``recv`` (buffers) fill from the rank
        ``step`` behind, all in ONE ``batch_isend_irecv`` so no rank
        blocks on an unmatched send. Without ``wrap`` the ends of the line
        skip what has no peer. Returns ``wait() -> recv``."""
        send, recv = list(send), list(recv)
        n, i = self.shape[axis], self.coords[axis]
        to, frm = i + step, i - step
        if wrap:
            to, frm = to % n, frm % n
        ops = []
        if 0 <= to < n:
            ops += [dist.P2POp(dist.isend, t.contiguous(),
                               self.peer(axis, to), tag=k)
                    for k, t in enumerate(send)]
        if 0 <= frm < n:
            ops += [dist.P2POp(dist.irecv, t, self.peer(axis, frm), tag=k)
                    for k, t in enumerate(recv)]
        if not ops or not self.grouped:
            return lambda: recv
        works = dist.batch_isend_irecv(ops)
        COLLECTIVES["send_recv"] += 1
        if _capture._active is not None:
            # one hop of the buffer each rank holds (JAX's permute result)
            _capture.collective(
                "send_recv", max(sum(_nbytes(t) for t in send),
                                 sum(_nbytes(t) for t in recv)), n)

        def wait():
            for w in works:
                w.wait()
            return recv

        return wait

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str
                   ) -> Callable[[], List[torch.Tensor]]:
        """Start the ring rotation ``i → i+1`` of ``tensors`` over ``axis``
        (``lax.ppermute`` with that permutation); ``wait()`` returns what
        the rank behind sent. On an axis of one rank the tensors stay."""
        if self.shape[axis] == 1:
            tensors = list(tensors)
            return lambda: tensors
        return self.exchange(axis, tensors,
                             [torch.empty_like(
                                 t, memory_format=torch.contiguous_format)
                              for t in tensors], wrap=True)

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier()


def flat_all_reduce(mesh: Mesh, tensors: list, axes: Axes = None) -> list:
    """Sum every tensor of ``tensors`` over the ranks of ``axes`` (default:
    the whole mesh) in ONE all-reduce of their concatenation, returned in
    their own shapes and dtypes. The buffer takes the widest floating
    dtype among them (f32 at least), so an f64 network's sums keep their
    precision."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    if axes is None:
        mesh.all_reduce(flat)
    else:
        mesh.all_reduce(flat, axes)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).to(t.dtype))
        at += n
    return out


class LeafShards:
    """Which mesh axes each leaf of a parameter tree is split over:
    ``axes_of(path) -> tuple`` (``()``: replicated). Where JAX's GSPMD
    reduces a sharded leaf's norm over its whole global array, a rank holds
    only its shard: ``sumsq`` sums each leaf's squares locally, then over
    the axes its leaf is split on, one all-reduce per distinct set of
    axes."""

    def __init__(self, mesh: Mesh, axes_of: Callable[[tuple], tuple]):
        self.mesh = mesh
        self.axes_of = axes_of

    def leaf_axes(self, tree) -> List[tuple]:
        """Each leaf's axes, in ``tree_leaves`` order."""
        from deeplearning4j_tpu_torch._device import tree_paths

        return [tuple(self.axes_of(p)) for p in tree_paths(tree)]

    def reduce(self, parts: Sequence[Tuple[tuple, torch.Tensor]]
               ) -> torch.Tensor:
        """Σ of ``(axes, partial)`` pairs: the partials of one set of axes
        summed over those axes in one all-reduce, the rest added as
        they are."""
        groups: Dict[tuple, torch.Tensor] = {}
        for axes, x in parts:
            axes = tuple(a for a in self.mesh.axis_names if a in axes)
            groups[axes] = groups.get(axes, 0.0) + x
        total = 0.0
        for axes, x in groups.items():
            if axes:
                x = self.mesh.all_reduce(torch.as_tensor(x).clone(), axes)
            total = total + x
        return torch.as_tensor(total)

    def sumsq(self, tree, extra: tuple = ()) -> torch.Tensor:
        """Σx² over every leaf of ``tree`` (f32 accumulate) across the
        ranks that hold its shards; ``extra`` axes split every leaf (a
        ZeRO row's)."""
        from deeplearning4j_tpu_torch._device import tree_leaves

        return self.reduce([
            (axes + tuple(extra), torch.sum(torch.square(x.float())))
            for axes, x in zip(self.leaf_axes(tree), tree_leaves(tree))])


# ------------------------------------------ collectives under autograd ----
#
# Inside a differentiated region a collective needs its transpose written
# by hand. The mesh's replicated compute makes the right transpose the
# per-group one: a value replicated over an axis carries ONE cotangent,
# held identically by every rank of the axis, so it is never summed over
# that axis (``torch.distributed.nn``'s all_gather backward sums, counting
# every cotangent once per rank).

class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all`` (``group``: over that explicit sub-group); its
    transpose is itself."""

    @staticmethod
    def forward(ctx, t, mesh, axis, group):
        ctx.args = (mesh, axis, group)
        return mesh.all_to_all(t, axis, group)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, group = ctx.args
        return mesh.all_to_all(g, axis, group), None, None, None


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows over ``axis``; backward: this rank's
    rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, t.shape[0]
        return mesh.all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


class _SplitRows(torch.autograd.Function):
    """Forward: this rank's contiguous chunk of dim 0 over ``axis``;
    backward: every rank's chunk gradient, gathered."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        rows = t.shape[0] // n
        return t[i * rows:(i + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axis), None, None


class _SumForward(torch.autograd.Function):
    """Forward: the sum over ``axes``; backward: the identity (the sum is
    replicated over ``axes``)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh.all_reduce(t.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrads(torch.autograd.Function):
    """Forward: the identity on several tensors; backward: their gradients
    summed over ``axes`` in ONE flat all-reduce."""

    @staticmethod
    def forward(ctx, mesh, axes, *ts):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(flat_all_reduce(ctx.mesh, list(gs),
                                                    ctx.axes))


def sum_grads_ad(mesh: Mesh, tensors: Sequence[torch.Tensor], axes: Axes
                 ) -> list:
    """The identity on ``tensors`` whose gradients are summed over
    ``axes`` in one all-reduce: replicated inputs whose uses differ from
    rank to rank (a router that routes this rank's tokens, params used on
    this rank's rows only), so that autograd gives every rank the whole
    gradient."""
    return list(_SumGrads.apply(mesh, axes, *tensors))


def all_to_all_ad(mesh: Mesh, t: torch.Tensor, axis: str,
                  group=None) -> torch.Tensor:
    """``Mesh.all_to_all`` under autograd (``group``: over an explicit
    sub-group of ``axis``, ``Mesh.factor_group``'s)."""
    return _AllToAll.apply(t, mesh, axis, group)


def gather_rows_ad(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``Mesh.all_gather`` over ``axis`` under autograd (backward: this
    rank's rows)."""
    return _GatherRows.apply(t, mesh, axis)


def split_rows_ad(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """This rank's chunk of dim 0 over ``axis`` under autograd (backward:
    the gathered gradient)."""
    return _SplitRows.apply(t, mesh, axis)


def sum_forward_ad(mesh: Mesh, t: torch.Tensor, axes: Axes) -> torch.Tensor:
    """``Mesh.all_reduce`` under autograd, replicated result."""
    return _SumForward.apply(t, mesh, axes)


def gather_dim(mesh: Mesh, t: torch.Tensor, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Every rank's ``t`` over ``axes`` concatenated along ``dim``, in the
    order of a spec entry naming ``axes`` (the first axis the major one):
    one all-gather per axis, the minor one first. No autograd."""
    for a in reversed(tuple(axes)):
        t = mesh.all_gather(t.movedim(dim, 0), a).movedim(0, dim)
    return t.contiguous()


def gather_cols_ad(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's ``t`` over ``axis`` concatenated along the LAST dim,
    under autograd (backward: this rank's columns of the replicated
    cotangent): Megatron's gather of a column-sharded activation."""
    return gather_rows_ad(mesh, t.movedim(-1, 0), axis).movedim(0, -1)


def split_cols_ad(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """This rank's block of the LAST dim over ``axis`` under autograd
    (forward: a slice, no wire bytes; backward: the gathered gradient)."""
    return split_rows_ad(mesh, t.movedim(-1, 0), axis).movedim(0, -1)


def data_parallel_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over every rank of the process group: pure DP.
    ``n_devices`` must equal the group's world size (1 with no group)."""
    n = _group_size() if n_devices is None else int(n_devices)
    return Mesh((DATA_AXIS,), (n,))


def mesh_2d(dp: int, tp: int) -> Mesh:
    """dp×tp mesh: batch over "data", hidden dims over "model"."""
    return Mesh((DATA_AXIS, MODEL_AXIS), (dp, tp))


def local_device_count() -> int:
    """Devices this host offers the mesh: its CUDA cards, else 1 (the
    CPU)."""
    return max(torch.cuda.device_count(), 1)
