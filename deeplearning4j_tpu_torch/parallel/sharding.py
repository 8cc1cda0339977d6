"""Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``: which dim
of each network param splits over the "model" axis, and this rank's
chunk of a leaf under a spec.

The JAX package returns ``NamedSharding``s; here a sharding is its spec, a
tuple naming the mesh axis each dim of a leaf splits over (None:
unsplit; ``()``: replicated; a tuple of axes: split over their product,
the first the major one), equal to the JAX spec's entries. Dense and
Output weights alternate Megatron-style, column-parallel then
row-parallel; attention splits heads. One process per rank: "placing" a
leaf is taking this rank's contiguous chunk of each split dim, the
rectangle JAX's ``addressable_shards`` puts on the device with the same
mesh coordinates (``local_chunk``; ``apply_shardings`` for a network's
params, ``shard_leading_axis`` for the expert and stage layouts), and
``gather_shardings`` all-gathers the chunks back into whole leaves. A mesh
here needs only ``axis_names``, ``shape`` and ``coords`` to place, so one
process can place every coordinate's chunk; the gather needs the
process group's ``Mesh``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, \
    DECODER_WEIGHT_KEY, WEIGHT_KEY
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS


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


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (None: none)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def local_region(shape, spec, mesh_shape: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[tuple, tuple]:
    """``(starts, sizes)`` of the rectangle of a leaf of ``shape`` that
    the rank at ``coords`` holds under ``spec``: on each split dim the
    contiguous block at the rank's index over the dim's axes (row-major,
    the first axis the major one). A dim that does not split evenly
    raises, as ``jax.device_put`` does."""
    shape = tuple(int(d) for d in shape)
    spec = tuple(spec or ())
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} names {len(spec)} dims but the leaf "
                         f"has {len(shape)}")
    starts, sizes = [], []
    for dim, n in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        parts, index = 1, 0
        for a in axes:
            parts *= int(mesh_shape[a])
            index = index * int(mesh_shape[a]) + int(coords[a])
        if n % parts:
            raise ValueError(f"a dim of {n} does not split over the "
                             f"{parts} ranks of {axes}")
        starts.append(index * (n // parts))
        sizes.append(n // parts)
    return tuple(starts), tuple(sizes)


def global_shape(local_shape, spec, mesh_shape: Dict[str, int]) -> tuple:
    """The whole leaf's shape from a rank's chunk of ``local_shape`` under
    ``spec``: each split dim times its axes' sizes."""
    spec = tuple(spec or ())
    if len(spec) > len(local_shape):
        raise ValueError(f"spec {spec} names {len(spec)} dims but the leaf "
                         f"has {len(local_shape)}")
    return tuple(int(n) * math.prod(
        int(mesh_shape[a]) for a in (spec_axes(spec[dim])
                                     if dim < len(spec) else ()))
                 for dim, n in enumerate(local_shape))


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinates on ``mesh`` (row-major over its axes,
    the first the major one)."""
    coords = {}
    for a in reversed(tuple(mesh.axis_names)):
        n = int(mesh.shape[a])
        coords[a] = rank % n
        rank //= n
    return coords


def local_chunk(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's chunk of ``leaf`` under ``spec`` (``mesh``: anything
    with ``shape`` and ``coords``), as a new contiguous tensor."""
    starts, sizes = local_region(leaf.shape, spec, mesh.shape, mesh.coords)
    for dim, (s, n) in enumerate(zip(starts, sizes)):
        if n != leaf.shape[dim]:
            leaf = leaf.narrow(dim, s, n)
    return leaf.clone(memory_format=torch.contiguous_format)


def shard_leading_axis(stacked, mesh, axis: str):
    """This rank's contiguous chunk, over ``axis``, of the leading dim of
    every leaf of ``stacked`` (``P(axis)``'s local shard): rows [i·n/P,
    (i+1)·n/P) at the rank's index i of P. A leading dim that does not
    split over the axis raises, as ``jax.device_put`` does."""
    from deeplearning4j_tpu_torch._device import tree_map

    p, i = int(mesh.shape[axis]), int(mesh.coords[axis])

    def one(_path, leaf):
        n = leaf.shape[0]
        if n % p:
            raise ValueError(f"a leading dim of {n} does not split over "
                             f"the {p} ranks of the {axis!r} axis")
        return leaf[i * (n // p):(i + 1) * (n // p)]

    return tree_map(one, stacked)


def layer_specs(params, shardings_per_layer) -> Tuple[dict, ...]:
    """Every leaf's spec, per layer: ``param_shardings``' entries, ``()``
    (replicated) for the params it does not name."""
    return tuple({k: tuple(shardings.get(k, ())) for k in layer}
                 for layer, shardings in zip(params, shardings_per_layer))


def state_specs(params, shardings_per_layer) -> Tuple[dict, ...]:
    """The specs of ``nn.functional.init_train_state``'s updater state
    (per layer ``{"hist": params, "v": params}``): each leaf as its
    param's."""
    specs = layer_specs(params, shardings_per_layer)
    return tuple({"hist": dict(s), "v": dict(s)} for s in specs)


def shard_tree(tree, specs, mesh):
    """``local_chunk`` of every leaf of ``tree`` under the spec at the
    same path of ``specs`` (a tree of spec tuples, None or ``()`` for a
    whole leaf)."""
    from deeplearning4j_tpu_torch._device import tree_leaves, \
        tree_unflatten

    return tree_unflatten(tree, [
        local_chunk(x, s, mesh)
        for x, s in zip(tree_leaves(tree), spec_leaves(specs, tree))])


def spec_leaves(specs, tree) -> list:
    """The spec at every leaf of ``tree``, in ``tree_leaves`` order:
    ``specs`` mirrors ``tree`` (dicts and sequences) down to the leaves,
    where it holds a spec tuple; a missing key or a None subtree is
    replicated (None)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(
            None if specs is None else specs.get(k), tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for i, v in enumerate(tree) for s in spec_leaves(
            None if specs is None else specs[i], v)]
    return [specs]


def apply_shardings(params, shardings_per_layer, mesh):
    """This rank's chunk of every param by ``param_shardings``' spec (a
    missing entry: the whole leaf): ``(None, "model")`` the rank's
    contiguous columns, ``("model", None)`` its rows, ``("model",)`` its
    slice of a bias. The chunks equal the ``addressable_shards`` JAX's
    ``apply_shardings`` puts on the device with the rank's coordinates.
    ``mesh`` needs only ``shape`` and ``coords``."""
    return shard_tree(tuple(params), layer_specs(params,
                                                 shardings_per_layer), mesh)


def gather_leaf(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``local`` chunk under ``spec``:
    one all-gather over each split dim's axes (``mesh``: the process
    group's ``Mesh``)."""
    from deeplearning4j_tpu_torch.parallel.mesh import gather_dim

    spec = tuple(spec or ())
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            local = gather_dim(mesh, local, axes, dim)
    return local


def gather_tree(local_tree, specs, mesh):
    """``gather_leaf`` of every leaf of ``local_tree`` under ``specs``."""
    from deeplearning4j_tpu_torch._device import tree_leaves, \
        tree_unflatten

    return tree_unflatten(local_tree, [
        gather_leaf(x, s, mesh)
        for x, s in zip(tree_leaves(local_tree),
                        spec_leaves(specs, local_tree))])


def gather_shardings(local_params, shardings_per_layer, mesh):
    """The inverse of ``apply_shardings``: every rank's chunks of each
    param all-gathered over "model" into the whole leaf."""
    return gather_tree(tuple(local_params),
                       layer_specs(local_params, shardings_per_layer), mesh)
