"""Tensor parallelism over the "model" mesh axis for ``MultiLayerNetwork``:
the train step on params placed by ``parallel.sharding.apply_shardings``.

The JAX package has no such module: it places the params with
``parallel/sharding.apply_shardings`` and runs the unchanged
``nn/functional.make_train_step``, and GSPMD inserts the collectives. The
port runs one process per rank, so every collective is explicit, and each
rank's product over its own columns or rows is a single-device product
that runs the same kernel (K1, ``ops.pallas_kernels.fused_dense``) the
single-device layer would.

Each layer follows the layout ``param_shardings`` gave it (Megatron):

- column-parallel DENSE/OUTPUT (``W (None, "model")``, ``b ("model",)``):
  the full activation goes through *f* (identity forward, an all-reduce
  over "model" backward), each rank computes ``act(x @ W_r + b_r)`` and
  the activation leaves sharded by columns;
- row-parallel (``W ("model", None)``, ``b ()``): each rank multiplies its
  columns of the activation (a full one is split, no wire bytes) by its
  rows of W, *g* sums the partials over "model" (all-reduce forward,
  identity backward), then ``b`` and the activation are applied;
- a column-sharded activation that reaches a layer needing the whole one
  (a replicated layer, an ATTENTION block, the loss) is all-gathered under
  autograd (backward: the rank's columns);
- ATTENTION with split heads: layernorm replicated, ``wq``/``wk``/``wv``
  column-parallel behind *f* (the rank holds ``n_heads / tp`` heads and
  runs ``attention_core`` on them: K3f forward, K3k and K3q backward at
  T >= 1024), ``wo`` row-parallel with *g*, then the residual; the decoder
  column-parallel when it divides, its logits gathered for the loss.

The per-rank math is in functions of a rank's local shards
(``column_dense``, ``row_dense_partial``, ``attention_heads_partial``,
``decoder_columns``); a ``Comm`` applies the collectives between them:
``MeshComm`` those of one rank of a process group, ``InProcessComm`` every
"model" rank's work in one process, sums and concatenations standing where
the collectives would (so one card can run and check every coordinate's
kernel work).

Dropout and drop-connect masks on a sharded operand are drawn at the
global shape (the whole batch over "data", all columns) and sliced, so
the step with a key equals the single-device step with the same key.
"""

from __future__ import annotations

from functools import reduce
from typing import List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn import layers as layer_ops
from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration, \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.functional import _maybe_preprocess, \
    _raw_train_step, check_head, head_per_example_loss
from deeplearning4j_tpu_torch.nn.layers import dense
from deeplearning4j_tpu_torch.nn.layers.attention import LN_BIAS_KEY, \
    LN_GAIN_KEY, Q_KEY, _dense_core, _layernorm, attend_heads
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, DECODER_BIAS_KEY, \
    DECODER_WEIGHT_KEY, WEIGHT_KEY
from deeplearning4j_tpu_torch.ops.activations import activation
from deeplearning4j_tpu_torch.ops.losses import LossFunction, finalize_loss
from deeplearning4j_tpu_torch.ops.pallas_kernels import _FUSABLE, \
    fused_dense, use_fused_dense
from deeplearning4j_tpu_torch.ops.rng import split
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, \
    LeafShards, flat_all_reduce, gather_cols_ad, split_cols_ad, \
    sum_forward_ad, sum_grads_ad
from deeplearning4j_tpu_torch.parallel.sharding import param_shardings

COLUMN, ROW, HEADS, REPLICATED = "column", "row", "heads", "replicated"


# ---------------------------------------------------------- collectives ----

class MeshComm:
    """One rank of a process group's ``Mesh``: each list holds this rank's
    value, and the collectives run over "model"."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.tp = int(mesh.shape.get(MODEL_AXIS, 1))
        self.ranks = (int(mesh.coords.get(MODEL_AXIS, 0)),)

    def fan_out(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Megatron's f: identity forward, all-reduce backward."""
        return [sum_grads_ad(self.mesh, [x], MODEL_AXIS)[0]]

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Megatron's g: all-reduce forward, identity backward."""
        return sum_forward_ad(self.mesh, parts[0], MODEL_AXIS)

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return gather_cols_ad(self.mesh, parts[0], MODEL_AXIS)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [split_cols_ad(self.mesh, x, MODEL_AXIS)]


class InProcessComm:
    """Every rank of a "model" axis of ``tp`` in this process: each list
    holds every rank's value, in rank order. A shared input's gradients
    sum over its uses (f's all-reduce), a sum of the partials is g, a
    concatenation the gather."""

    def __init__(self, tp: int):
        self.tp = int(tp)
        self.ranks = tuple(range(self.tp))

    def fan_out(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] * self.tp

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return reduce(torch.add, parts)

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(parts), dim=-1)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        n = x.shape[-1] // self.tp
        return [x[..., r * n:(r + 1) * n] for r in self.ranks]


# ------------------------------------------------------ per-rank layers ----

def _k1_eligible(conf: NeuralNetConfiguration, x: torch.Tensor,
                 masked: bool) -> bool:
    """Where the single-device dense layer takes K1
    (``nn/layers/dense.forward``): 2-D input, no drop-connect, an
    activation the kernel fuses, the kernel switched on."""
    return (x.dim() == 2 and not masked
            and conf.activation_function in _FUSABLE and use_fused_dense())


def column_dense(conf: NeuralNetConfiguration, w: torch.Tensor,
                 b: torch.Tensor, x: torch.Tensor, *, kernel: bool = True,
                 apply_activation: bool = True) -> torch.Tensor:
    """A column-parallel rank's ``act(x @ W_r + b_r)``: its columns of the
    layer's output. K1 (with bias and activation) where ``kernel``; the
    plain product else, and without the activation for a head's logits."""
    if kernel:
        return fused_dense(x, w, b, conf.activation_function)
    pre = x @ w + b
    return activation(conf.activation_function)(pre) if apply_activation \
        else pre


def row_dense_partial(w: torch.Tensor, x: torch.Tensor, *,
                      kernel: bool = True) -> torch.Tensor:
    """A row-parallel rank's partial sum ``x_r @ W_r`` over its columns of
    the input: K1 with the "linear" activation and a zero bias where
    ``kernel``, the plain product else."""
    if kernel:
        return fused_dense(x, w, w.new_zeros(w.shape[1]), "linear")
    return x @ w


def attention_heads_partial(conf: NeuralNetConfiguration, p: dict,
                            xn: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A rank's attention over its ``n_heads`` heads: the layernormed input
    through its columns of ``wq``/``wk``/``wv``, ``attention_core``, and
    its rows of ``wo``: its partial sum of the block's output."""
    return attend_heads(p, xn, n_heads, _dense_core(conf))


def decoder_columns(p: dict, h: torch.Tensor) -> torch.Tensor:
    """A rank's columns of the decoder's logits (bias added after the
    gather)."""
    return h @ p[DECODER_WEIGHT_KEY]


# ---------------------------------------------------------- the network ----

class _Ctx:
    """One forward's layout: the comm, every rank's params, the specs,
    and where this shard's rows sit in the global batch."""

    def __init__(self, conf, params_per_rank, specs, comm, train, row0,
                 global_rows):
        self.conf = conf
        self.params = params_per_rank
        self.specs = specs
        self.comm = comm
        self.train = train
        self.row0 = row0
        self.global_rows = global_rows

    def layer(self, i: int) -> list:
        """Layer ``i``'s local params of every rank the comm runs, in
        rank order."""
        return [p[i] for p in self.params]

    def kind(self, i: int) -> str:
        spec = self.specs[i]
        w = tuple(spec.get(WEIGHT_KEY, ()))
        if w == (None, MODEL_AXIS):
            return COLUMN
        if w == (MODEL_AXIS, None):
            return ROW
        if Q_KEY in spec:
            return HEADS
        return REPLICATED

    def mask(self, key, keep: float, x: torch.Tensor, col0: int,
             cols: int) -> torch.Tensor:
        """The mask a single-device draw of ``keep`` at the GLOBAL shape
        (every row of the batch, ``cols`` columns) puts on this operand's
        rows and its columns from ``col0``."""
        like = x.new_empty((self.global_rows,) + tuple(x.shape[1:-1])
                           + (cols,))
        m = dense._bernoulli(key, keep, like)
        return m[self.row0:self.row0 + x.shape[0]][
            ..., col0:col0 + x.shape[-1]]

    def dropout(self, x, rate, key, col0=0, cols=None):
        if not self.train or rate <= 0.0 or key is None:
            return x
        keep = 1.0 - rate
        m = self.mask(key, keep, x, col0, x.shape[-1] if cols is None
                      else cols)
        return torch.where(m, x / keep, 0.0)

    def weight(self, w, key, kind: str, r: int):
        """Drop-connect's mask drawn at W's global shape, sliced to the
        rank's chunk."""
        if not (self.conf.use_drop_connect and self.train
                and key is not None):
            return w
        rows, cols = w.shape
        tp = self.comm.tp
        g_rows, g_cols = rows * (tp if kind == ROW else 1), \
            cols * (tp if kind == COLUMN else 1)
        u = dense._bernoulli(key, dense._DROP_CONNECT_KEEP,
                             w.new_empty((g_rows, g_cols)))
        r0 = r * rows if kind == ROW else 0
        c0 = r * cols if kind == COLUMN else 0
        m = u[r0:r0 + rows, c0:c0 + cols]
        return torch.where(m, w / dense._DROP_CONNECT_KEEP, 0.0)


def _full(ctx: _Ctx, state) -> torch.Tensor:
    kind, v = state
    return ctx.comm.gather(v) if kind == "cols" else v


def _dense_family(ctx: _Ctx, i: int, state, key, head: bool):
    """A DENSE or OUTPUT layer in its layout; a head returns its logits
    (the output layer's ``pre_output``), any other layer its state."""
    conf = ctx.conf.conf(i)
    kind = ctx.kind(i)
    comm, ps = ctx.comm, ctx.layer(i)
    kdrop = kdc = None
    if key is not None:
        kdrop, kdc = split(key)
    masked = ctx.conf.use_drop_connect and ctx.train
    fusable = not head and conf.layer_type == LayerType.DENSE
    act = activation(conf.activation_function)
    if kind == ROW:
        xs = state[1] if state[0] == "cols" else comm.split(state[1])
        cols = xs[0].shape[-1] * comm.tp
        partials = []
        for p, r, x in zip(ps, comm.ranks, xs):
            x = ctx.dropout(x, conf.dropout, kdrop, r * x.shape[-1], cols)
            w = ctx.weight(p[WEIGHT_KEY], kdc, ROW, r)
            kernel = fusable and _k1_eligible(conf, x, masked)
            partials.append(row_dense_partial(w, x, kernel=kernel))
        pre = comm.reduce(partials) + ps[0][BIAS_KEY]
        return pre if head else ("full", act(pre))
    x = ctx.dropout(_full(ctx, state), conf.dropout, kdrop)
    kernel = fusable and _k1_eligible(conf, x, masked)
    if kind == COLUMN:
        outs = []
        for p, r, xr in zip(ps, comm.ranks, comm.fan_out(x)):
            w = ctx.weight(p[WEIGHT_KEY], kdc, COLUMN, r)
            outs.append(column_dense(conf, w, p[BIAS_KEY], xr,
                                     kernel=kernel,
                                     apply_activation=not head))
        return comm.gather(outs) if head else ("cols", outs)
    p = ps[0]
    w = ctx.weight(p[WEIGHT_KEY], kdc, REPLICATED, 0)
    if kernel:
        out = fused_dense(x, w, p[BIAS_KEY], conf.activation_function)
        return ("full", out)
    pre = x @ w + p[BIAS_KEY]
    return pre if head else ("full", act(pre))


def _attention(ctx: _Ctx, i: int, state) -> torch.Tensor:
    """The ATTENTION block and its decoder over split heads: the
    per-timestep logits (batch, time, n_out)."""
    conf = ctx.conf.conf(i)
    comm, ps = ctx.comm, ctx.layer(i)
    x = _full(ctx, state)
    if x.dim() == 2:
        x = x[None]
    p0 = ps[0]
    xn = _layernorm(x, p0[LN_GAIN_KEY], p0[LN_BIAS_KEY])
    heads = conf.n_heads // comm.tp
    partials = [attention_heads_partial(conf, p, xr, heads)
                for p, xr in zip(ps, comm.fan_out(xn))]
    h = x + comm.reduce(partials)
    if DECODER_WEIGHT_KEY in ctx.specs[i]:
        logits = comm.gather([decoder_columns(p, hr)
                              for p, hr in zip(ps, comm.fan_out(h))])
    else:
        logits = h @ p0[DECODER_WEIGHT_KEY]
    return logits + p0[DECODER_BIAS_KEY]


def _layer(ctx: _Ctx, i: int, state, key, head: bool):
    """Layer ``i`` in its layout: the next state, or a head's logits."""
    conf = ctx.conf.conf(i)
    if ctx.conf.preprocessor_for(i):
        state = ("full", _maybe_preprocess(ctx.conf, i, _full(ctx, state)))
    if conf.layer_type in (LayerType.DENSE, LayerType.OUTPUT):
        return _dense_family(ctx, i, state, key, head)
    if ctx.kind(i) == HEADS:
        logits = _attention(ctx, i, state)
        return logits if head else ("full", logits)
    out = layer_ops.forward(conf, ctx.layer(i)[0], _full(ctx, state),
                            train=ctx.train, key=key,
                            drop_connect=ctx.conf.use_drop_connect)
    return out if head else ("full", out)


def tp_per_example_loss(conf: MultiLayerConfiguration, params_per_rank,
                        x: torch.Tensor, labels: torch.Tensor, comm, *,
                        specs=None, train: bool = False,
                        key: Optional[int] = None, row0: int = 0,
                        global_rows: Optional[int] = None) -> torch.Tensor:
    """``nn.functional.network_per_example_loss`` with the layers in their
    tensor-parallel layouts: (rows,) per-example losses of this shard's
    rows ``x``, replicated over "model". ``params_per_rank``: the local
    params of each rank ``comm`` runs (one for ``MeshComm``); ``specs``:
    ``param_shardings``; ``row0``/``global_rows``: where the rows sit in
    the global batch (the dropout masks' shape)."""
    n = conf.n_layers
    if specs is None:
        raise ValueError("tp_per_example_loss needs the layers' specs")
    ctx = _Ctx(conf, [tuple(p) for p in params_per_rank], tuple(specs),
               comm, train, row0,
               x.shape[0] if global_rows is None else global_rows)
    keys = split(key, n) if key is not None else [None] * n
    state = ("full", x)
    for i in range(n - 1):
        state = _layer(ctx, i, state, keys[i], head=False)
    head = conf.conf(n - 1)
    check_head(head)
    logits = _layer(ctx, n - 1, state, keys[n - 1], head=True)
    return head_per_example_loss(head, logits, labels)


def tp_loss_in_process(conf: MultiLayerConfiguration, params_per_rank,
                       x: torch.Tensor, labels: torch.Tensor, *,
                       train: bool = True, key: Optional[int] = None
                       ) -> torch.Tensor:
    """The network loss with every "model" rank's kernel work run in this
    process (``InProcessComm``): ``params_per_rank`` are the local params
    ``apply_shardings`` gives each coordinate of a ("data", "model")
    mesh of (1, len(params_per_rank)). Differentiating it gives each
    rank's grads of its own shards (replicated leaves: rank 0's copy);
    ``network_loss`` of the whole params is its single-device twin."""
    tp = len(params_per_rank)
    specs = param_shardings(conf, _MeshShape(tp))
    per = tp_per_example_loss(conf, params_per_rank, x, labels,
                              InProcessComm(tp), specs=specs, train=train,
                              key=key)
    return finalize_loss(conf.conf(conf.n_layers - 1).loss_function,
                         per.mean())


class _MeshShape:
    """A mesh description for the specs alone: ("data", "model")."""

    def __init__(self, tp: int, dp: int = 1):
        self.axis_names = (DATA_AXIS, MODEL_AXIS)
        self.shape = {DATA_AXIS: dp, MODEL_AXIS: tp}


def _layer_sumsq(mesh, specs: dict):
    """The unit-norm constraint's Σu² over a layer whose leaves split
    over "model" (None where none does: the local sum is the whole)."""
    if not any(MODEL_AXIS in tuple(s) for s in specs.values()):
        return None
    shards = LeafShards(mesh, lambda path: (
        (MODEL_AXIS,) if MODEL_AXIS in tuple(specs.get(path[0], ()))
        else ()))
    return shards.sumsq


def make_tp_train_step(conf: MultiLayerConfiguration, mesh,
                       donate: bool = False, policy=None):
    """``nn.functional.make_train_step`` over a ("data", "model") mesh:

    step(local_params, local_states, iteration, x, labels, key)
      -> (new_local_params, new_local_states, score)

    ``local_params`` are this rank's chunks (``apply_shardings`` of
    ``param_shardings(conf, mesh)``), ``local_states`` the updater state
    shaped like them (``nn.functional.init_train_state`` of the local
    params). ``x`` and ``labels`` are the GLOBAL batch, the same on every
    rank (rows a multiple of "data"); the rank takes its rows over
    "data". The loss is replicated over "model" and averaged over "data";
    every grad is summed over "data" alone (the "model" ranks' replicated
    leaves come out equal through f and g). The unit-norm constraint
    takes each layer's global norm (sharded leaves' squares summed over
    "model"). ``donate`` and ``policy`` as in ``make_train_step``.

    K1 launches where the single-device layer's would: twice a step on
    each rank for the MNIST MLP (its two DENSE layers: the column layer
    with its epilogue, the row layer's partial product "linear" with a
    zero bias); none for the attention char-LM, whose DENSE layer takes
    3-D input. K3f, K3k and K3q once a step on each rank's heads at
    T >= 1024."""
    specs = param_shardings(conf, mesh)
    comm = MeshComm(mesh)
    dp = int(mesh.shape.get(DATA_AXIS, 1))
    d = int(mesh.coords.get(DATA_AXIS, 0))
    head = conf.conf(conf.n_layers - 1)
    rmse = LossFunction.coerce(head.loss_function) == LossFunction.RMSE_XENT

    def loss(ps, x, labels, key):
        n = x.shape[0]
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"{dp} ranks of {DATA_AXIS!r}")
        rows = n // dp
        per = tp_per_example_loss(
            conf, [ps], x[d * rows:(d + 1) * rows],
            labels[d * rows:(d + 1) * rows], comm, specs=specs, train=True,
            key=key, row0=d * rows, global_rows=n)
        mean = per.mean()
        # a sqrt head over several shards: differentiate the mean and
        # apply the chain rule after the sum over "data"
        return mean if (rmse and dp > 1) else \
            finalize_loss(head.loss_function, mean)

    def reduce_grads(grads, score):
        if dp == 1:
            return grads, score
        *grads, total = flat_all_reduce(mesh, grads + [score], DATA_AXIS)
        score = finalize_loss(head.loss_function, total / dp)
        chain = (0.5 / score / dp) if rmse else 1.0 / dp
        return [g * chain for g in grads], score

    return _raw_train_step(
        conf, policy, donate, loss=loss, reduce_grads=reduce_grads,
        sumsqs=[_layer_sumsq(mesh, specs[i]) for i in range(conf.n_layers)])
