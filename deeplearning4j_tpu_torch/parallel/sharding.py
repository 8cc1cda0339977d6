"""Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``: which dim
of each network param splits over the "model" axis.

The JAX package returns ``NamedSharding``s; here a sharding is its spec, a
tuple naming the mesh axis each dim of a leaf splits over (None:
unsplit; ``()``: replicated), equal to the JAX spec's entries. Dense and
Output weights alternate Megatron-style, column-parallel then
row-parallel; attention splits heads. One process per rank: "placing" a
stacked leaf over an axis is taking this rank's contiguous chunk of its
leading dim (``shard_leading_axis``: the expert and stage layouts).
Placing tensors over a "model" axis (``shard_leading_axis`` on it,
``apply_shardings``) is tensor parallelism, ROADMAP item 20b, and raises
until then.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, \
    DECODER_WEIGHT_KEY, WEIGHT_KEY
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS

_TP_ITEM = ("placing tensors over a 'model' mesh axis is tensor "
            "parallelism, ROADMAP item 20b")


def replicated(mesh) -> tuple:
    """The replicated spec (``P()``)."""
    return ()


def param_shardings(conf: MultiLayerConfiguration, mesh) -> Tuple[dict, ...]:
    """Per-layer {param_name: spec}. If the mesh has no "model" axis (pure
    DP), everything is replicated (no entry). ``mesh`` needs only
    ``axis_names`` and ``shape``."""
    has_tp = MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1
    out = []
    col_parallel = True  # alternate column/row parallel across dense layers
    for i in range(conf.n_layers):
        layer_conf = conf.conf(i)
        shardings = {}
        if has_tp and layer_conf.layer_type in (LayerType.DENSE,
                                                LayerType.OUTPUT):
            tp = mesh.shape[MODEL_AXIS]
            if col_parallel and layer_conf.n_out % tp == 0:
                shardings[WEIGHT_KEY] = (None, MODEL_AXIS)
                shardings[BIAS_KEY] = (MODEL_AXIS,)
                col_parallel = False
            elif not col_parallel and layer_conf.n_in % tp == 0:
                shardings[WEIGHT_KEY] = (MODEL_AXIS, None)
                shardings[BIAS_KEY] = ()
                col_parallel = True
        elif has_tp and layer_conf.layer_type == LayerType.ATTENTION:
            # Megatron MHA: qkv column-parallel (heads split across the
            # model axis), output projection row-parallel; the decoder
            # column-parallel when divisible. Heads must divide tp.
            tp = mesh.shape[MODEL_AXIS]
            if layer_conf.n_heads % tp == 0 and layer_conf.n_in % tp == 0:
                col = (None, MODEL_AXIS)
                for k in ("wq", "wk", "wv"):
                    shardings[k] = col
                shardings["wo"] = (MODEL_AXIS, None)
                if layer_conf.n_out % tp == 0:
                    shardings[DECODER_WEIGHT_KEY] = col
        # everything not explicitly sharded is replicated
        out.append(shardings)
    return tuple(out)


def stack_along_leading_axis(per_item: list):
    """[{k: tensor}, ...] → {k: (N, ...) tensor} — the stage-stacked
    (pipeline) and expert-stacked (moe) param layouts."""
    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten

    columns = zip(*(tree_leaves(item) for item in per_item))
    return tree_unflatten(per_item[0],
                          [torch.stack(list(xs)) for xs in columns])


def shard_leading_axis(stacked, mesh, axis: str):
    """This rank's contiguous chunk, over ``axis``, of the leading dim of
    every leaf of ``stacked`` (``P(axis)``'s local shard): rows [i·n/P,
    (i+1)·n/P) at the rank's index i of P. A leading dim that does not
    split over the axis raises, as ``jax.device_put`` does."""
    if axis == MODEL_AXIS:
        raise NotImplementedError(_TP_ITEM)
    from deeplearning4j_tpu_torch._device import tree_map

    p, i = int(mesh.shape[axis]), int(mesh.coords[axis])

    def one(_path, leaf):
        n = leaf.shape[0]
        if n % p:
            raise ValueError(f"a leading dim of {n} does not split over "
                             f"the {p} ranks of the {axis!r} axis")
        return leaf[i * (n // p):(i + 1) * (n // p)]

    return tree_map(one, stacked)


def apply_shardings(params, shardings_per_layer, mesh):
    raise NotImplementedError(_TP_ITEM)
