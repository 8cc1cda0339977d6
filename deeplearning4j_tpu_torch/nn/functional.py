"""Counterpart of ``deeplearning4j_tpu/nn/functional.py``: the functional
network core that the ``MultiLayerNetwork`` facade wraps (ref:
nn/multilayer/MultiLayerNetwork.java:495-525 feedForward, :959-1010
doBackWard). Backprop is autograd of the composed loss.

Params are a tuple of per-layer dicts of tensors; keys are ``ops.rng``
ints. Nothing in a train step waits for the card: the batch is copied
without a stream sync, the iteration is made on the device, the score
stays a device tensor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch._device import DeviceLike, commit, \
    resolve_device, tree_leaves, tree_map, tree_unflatten, tree_zip_map
from deeplearning4j_tpu_torch.nn import layers as layer_ops
from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import output as output_layer
from deeplearning4j_tpu_torch.nn.layers.preprocessor import preprocessor
from deeplearning4j_tpu_torch.nn.params import init_layer_params
from deeplearning4j_tpu_torch.ops.losses import LossFunction, finalize_loss, \
    per_example_loss, per_example_loss_from_logits
from deeplearning4j_tpu_torch.ops.rng import fold_in, split
from deeplearning4j_tpu_torch.optimize.updater import apply_updater, \
    init_updater_state

NetParams = Tuple[dict, ...]

# losses a sequence head scores from its logits (softmax or sigmoid fused)
_CE_FAMILY = (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD,
              LossFunction.XENT, LossFunction.RECONSTRUCTION_CROSSENTROPY)


def init_params(conf: MultiLayerConfiguration, key: int,
                device: DeviceLike = None) -> NetParams:
    """Fresh params for every layer, on ``device`` (CUDA unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    keys = split(key, max(conf.n_layers, 1))
    return tuple(init_layer_params(keys[i], conf.conf(i), dev)
                 for i in range(conf.n_layers))


def to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` (array or tensor) on ``device``. A host array is copied
    without the stream sync of a blocking copy (the copy from pageable
    memory is staged before this returns, so the array may be freed)."""
    return torch.as_tensor(a).to(device, non_blocking=True)


def _maybe_preprocess(conf: MultiLayerConfiguration, i: int,
                      x: torch.Tensor) -> torch.Tensor:
    name = conf.preprocessor_for(i)
    return preprocessor(name)(x) if name else x


def _layer_keys(key: Optional[int], n: int) -> list:
    return split(key, n) if key is not None else [None] * n


def feed_forward(conf: MultiLayerConfiguration, params: NetParams,
                 x: torch.Tensor, *, train: bool = False,
                 key: Optional[int] = None) -> List[torch.Tensor]:
    """Activations per layer, input first (ref:
    MultiLayerNetwork.java:495-525)."""
    acts = [x]
    keys = _layer_keys(key, conf.n_layers)
    for i in range(conf.n_layers):
        x = _maybe_preprocess(conf, i, x)
        x = layer_ops.forward(conf.conf(i), params[i], x, train=train,
                              key=keys[i], drop_connect=conf.use_drop_connect)
        acts.append(x)
    return acts


def output(conf: MultiLayerConfiguration, params: NetParams,
           x: torch.Tensor) -> torch.Tensor:
    """Final network output (ref: MultiLayerNetwork.output :1184)."""
    return feed_forward(conf, params, x)[-1]


def hidden_activation(conf: MultiLayerConfiguration, params: NetParams,
                      x: torch.Tensor, upto: int, *, train: bool = False,
                      key: Optional[int] = None) -> torch.Tensor:
    """Forward through layers [0, upto) — pretraining input for layer
    ``upto`` (ref: MultiLayerNetwork.activationFromPrevLayer :479)."""
    keys = _layer_keys(key, max(upto, 1))
    for i in range(upto):
        x = _maybe_preprocess(conf, i, x)
        x = layer_ops.forward(conf.conf(i), params[i], x, train=train,
                              key=keys[i])
    return x


def network_loss(conf: MultiLayerConfiguration, params: NetParams,
                 x: torch.Tensor, labels: torch.Tensor, *,
                 train: bool = False,
                 key: Optional[int] = None) -> torch.Tensor:
    """Loss through the whole stack; the head uses the fused-logits
    path."""
    per = network_per_example_loss(conf, params, x, labels, train=train,
                                   key=key)
    head = conf.conf(conf.n_layers - 1)
    return finalize_loss(head.loss_function, per.mean())


def network_per_example_loss(conf: MultiLayerConfiguration,
                             params: NetParams, x: torch.Tensor,
                             labels: torch.Tensor, *, train: bool = False,
                             key: Optional[int] = None) -> torch.Tensor:
    """Per-example pre-reduction losses, shape (batch,); ``network_loss``
    is ``finalize_loss(head.loss_function, mean(per_example))``.

    Head layers:
    - OUTPUT: fused-logits classifier head. 3-D labels (batch, time,
      classes) are scored per timestep and averaged over time.
    - LSTM, ATTENTION: the layer's own decoder projection provides
      per-timestep logits (ref: nn/layers/recurrent/LSTM.java:54-160 trains
      through its decoder with per-timestep softmax); labels are (batch,
      time, vocab). Logits and labels are scored in f32."""
    n = conf.n_layers
    head = conf.conf(n - 1)
    check_head(head)
    keys = _layer_keys(key, n)
    for i in range(n - 1):
        x = _maybe_preprocess(conf, i, x)
        x = layer_ops.forward(conf.conf(i), params[i], x, train=train,
                              key=keys[i], drop_connect=conf.use_drop_connect)
    x = _maybe_preprocess(conf, n - 1, x)
    if head.layer_type == LayerType.OUTPUT:
        logits = output_layer.output_logits(
            head, params[n - 1], x, train=train, key=keys[n - 1],
            drop_connect=conf.use_drop_connect)
    else:
        # sequence heads own a decoder producing per-timestep logits
        logits = layer_ops.forward(head, params[n - 1], x, train=train,
                                   key=keys[n - 1])
    return head_per_example_loss(head, logits, labels)


def check_head(head) -> None:
    """``network_per_example_loss``'s head contract."""
    if head.layer_type not in (LayerType.OUTPUT, LayerType.LSTM,
                               LayerType.ATTENTION):
        raise ValueError("network_per_example_loss requires an OUTPUT, "
                         "LSTM, or ATTENTION head layer")


def head_per_example_loss(head, logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """The head layer's (batch,) losses from its logits, in f32: an OUTPUT
    head as ``output.logits_per_example_loss``; a sequence head (LSTM,
    ATTENTION) from its per-timestep logits (softmax or sigmoid fused for
    the cross-entropy family); per-timestep losses averaged over time."""
    if head.layer_type == LayerType.OUTPUT:
        per = output_layer.logits_per_example_loss(head, logits, labels)
    else:
        logits, labels = logits.float(), labels.float()
        if LossFunction.coerce(head.loss_function) in _CE_FAMILY:
            per = per_example_loss_from_logits(head.loss_function, labels,
                                               logits)
        else:
            per = per_example_loss(head.loss_function, labels, logits)
    if per.dim() > 1:  # sequence head: average the per-timestep losses
        per = per.mean(dim=tuple(range(1, per.dim())))
    return per


def _raw_train_step(conf: MultiLayerConfiguration, policy=None,
                    donate: bool = False, *, loss=None, reduce_grads=None,
                    sumsqs=None):
    """The step body shared by make_train_step / make_train_epoch and the
    tensor-parallel step (``parallel.tensor_parallel``).
    ``loss(params, x, labels, key)`` is the scalar differentiated
    (default: ``network_loss`` in training mode); ``reduce_grads(grads,
    score)`` -> ``(grads, score)`` runs on the flat grads and the detached
    loss before the updater; ``sumsqs[i]`` is layer i's
    ``apply_updater(sumsq=)``."""
    if loss is None:
        def loss(ps, x, labels, key):
            return network_loss(conf, ps, x, labels, train=True, key=key)
    if sumsqs is None:
        sumsqs = [None] * conf.n_layers

    def step(params, states, iteration, x, labels, key):
        dev = tree_leaves(params)[0].device
        x, labels = to_device(x, dev), to_device(labels, dev)
        if not isinstance(iteration, torch.Tensor):
            # a fill kernel: no host-to-device copy, no sync
            iteration = torch.full((), int(iteration), dtype=torch.int64,
                                   device=dev)
        kdrop = None if key is None else split(key)[0]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            ps = tree_unflatten(params, leaves)
            xin = x
            if policy is not None:
                ps = tree_map(lambda _, a: a.to(policy.compute_dtype), ps)
                xin = x.to(policy.compute_dtype)
            score = loss(ps, xin, labels, kdrop)
            # a leaf the loss does not reach (a pretraining layer's
            # visible bias) gets a zero grad, as jax.grad gives it
            grads = list(torch.autograd.grad(
                score, leaves, allow_unused=True, materialize_grads=True))
        score = score.detach()
        if reduce_grads is not None:
            grads, score = reduce_grads(grads, score)
        grads = tree_unflatten(params, grads)
        new_params, new_states = [], []
        with torch.no_grad():
            for i in range(conf.n_layers):
                upd, st = apply_updater(conf.conf(i), iteration, grads[i],
                                        params[i], states[i], sumsqs[i])
                if donate:
                    for p, u in zip(tree_leaves(params[i]),
                                    tree_leaves(upd)):
                        p.sub_(u)
                    new_params.append(params[i])
                else:
                    new_params.append(
                        tree_zip_map(lambda p, u: p - u, params[i], upd))
                new_states.append(commit(states[i], st, donate))
        return tuple(new_params), tuple(new_states), score

    return step


def make_train_step(conf: MultiLayerConfiguration, donate: bool = False,
                    policy=None):
    """The full-network training step (ref: MultiLayerNetwork.java:976-1002
    doBackWard's per-iteration body):

    step(params, states, iteration, x, labels, key)
      -> (new_params, new_states, score)

    Forward, backward (autograd), per-layer updater. ``x`` and ``labels``
    (arrays or tensors) go to the params' device; ``iteration`` is an int
    or a tensor there; ``key`` an ``ops.rng`` int (or None: no dropout).

    ``donate=True`` updates the params and updater state in place and
    returns them; only safe when the caller owns them exclusively (the
    epoch loop, benches). MultiLayerNetwork keeps False, since a clone
    shares its params tree.

    ``policy`` (ops.dtypes.Policy) enables mixed precision: params and
    input are cast to ``policy.compute_dtype`` inside the loss; master
    params, updater state and the loss stay float32.
    """
    return _raw_train_step(conf, policy, donate)


def make_train_epoch(conf: MultiLayerConfiguration, n_steps: int,
                     donate: bool = True, policy=None):
    """``n_steps`` steps over stacked batches, one call:

    epoch(params, states, iteration0, xs, ys, key)
      -> (new_params, new_states, scores)

    xs: (n_steps, batch, features), ys: (n_steps, batch, classes); scores
    (n_steps,) f32. A plain loop of the step over ``xs[i]``, ``ys[i]`` with
    the key of step i folded from ``i``, as the JAX scan folds it (the
    JAX package's one-program ``lax.scan``; a CUDA-graph replay of the
    chunk is later work)."""
    step = _raw_train_step(conf, policy, donate)

    def epoch(params, states, iteration0, xs, ys, key):
        dev = tree_leaves(params)[0].device
        start = (iteration0 if isinstance(iteration0, torch.Tensor)
                 else int(iteration0))
        its = torch.arange(n_steps, device=dev) + start
        scores = []
        for i in range(n_steps):
            sub = None if key is None else fold_in(key, i)
            params, states, score = step(params, states, its[i], xs[i],
                                         ys[i], sub)
            scores.append(score)
        return params, states, torch.stack(scores)

    return epoch


def init_train_state(conf: MultiLayerConfiguration, params: NetParams):
    return tuple(init_updater_state(params[i]) for i in range(conf.n_layers))


def score(conf: MultiLayerConfiguration, params: NetParams,
          x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return network_loss(conf, params, x, labels, train=False)
