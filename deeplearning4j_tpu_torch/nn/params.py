"""Counterpart of ``deeplearning4j_tpu/nn/params.py``: named-parameter
initialization per layer type, with the same parameter keys (ref:
nn/params/*.java), so flat parameter vectors and checkpoints line up
between the two packages.

DENSE, OUTPUT, LSTM and ATTENTION are ported; the other layer types come
with their slices (ROADMAP Queue 1) and raise ``NotImplementedError``
naming it.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.rng import split

# canonical parameter keys (ref: nn/params/*.java)
WEIGHT_KEY = "W"
BIAS_KEY = "b"
VISIBLE_BIAS_KEY = "vb"
CONV_WEIGHT_KEY = "convweights"
CONV_BIAS_KEY = "convbias"
RECURRENT_WEIGHT_KEY = "recurrentweights"
DECODER_WEIGHT_KEY = "decoderweights"
DECODER_BIAS_KEY = "decoderbias"

# the ROADMAP slice that ports each layer type not ported yet
UNPORTED_LAYERS = {
    LayerType.RBM: "slice 5, item 13 (pretraining)",
    LayerType.AUTOENCODER: "slice 5, item 13 (pretraining)",
    LayerType.RECURSIVE_AUTOENCODER: "slice 5, item 13 (pretraining)",
    LayerType.CONVOLUTION: "slice 5, item 12 (LeNet)",
    LayerType.SUBSAMPLING: "slice 5, item 12 (LeNet)",
}


def unported(layer_type: LayerType, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} for layer type {layer_type.value} is not ported yet: it "
        f"comes with ROADMAP {UNPORTED_LAYERS[layer_type]}")


def _dense_params(key: int, conf: NeuralNetConfiguration,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    wkey, _ = split(key)
    return {
        WEIGHT_KEY: init_weights(wkey, (conf.n_in, conf.n_out),
                                 conf.weight_init, conf.dist, device=dev),
        BIAS_KEY: torch.zeros((conf.n_out,), device=dev),
    }


def _lstm_params(key: int, conf: NeuralNetConfiguration,
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    # Karpathy-style fused-gate LSTM (ref: nn/layers/recurrent/LSTM.java:54-160,
    # nn/params/LSTMParamInitializer.java:39-41): one recurrent matrix maps
    # [1, x_t, h_{t-1}] -> 4*hidden (i,f,o,g fused), plus a decoder to n_out.
    hidden = conf.n_out
    in_dim = 1 + conf.n_in + hidden
    k1, k2, _ = split(key, 3)
    return {
        RECURRENT_WEIGHT_KEY: init_weights(k1, (in_dim, 4 * hidden),
                                           conf.weight_init, conf.dist,
                                           device=dev),
        DECODER_WEIGHT_KEY: init_weights(k2, (hidden, conf.n_out),
                                         conf.weight_init, conf.dist,
                                         device=dev),
        DECODER_BIAS_KEY: torch.zeros((conf.n_out,), device=dev),
    }


def _attention_params(key: int, conf: NeuralNetConfiguration,
                      dev: torch.device) -> Dict[str, torch.Tensor]:
    # Pre-LN multi-head self-attention block + decoder (the head contract
    # mirrors the LSTM's decoder, nn/params/LSTMParamInitializer.java:39-41).
    d = conf.n_in
    if conf.n_heads < 1 or d % conf.n_heads != 0:
        raise ValueError(
            f"attention n_in ({d}) must be divisible by n_heads "
            f"({conf.n_heads}); n_heads must be >= 1"
        )
    kq, kk, kv, ko, kd = split(key, 5)
    dd = (d, d)

    def w(k, shape):
        return init_weights(k, shape, conf.weight_init, conf.dist, device=dev)

    return {
        "ln_g": torch.ones((d,), device=dev),
        "ln_b": torch.zeros((d,), device=dev),
        "wq": w(kq, dd),
        "wk": w(kk, dd),
        "wv": w(kv, dd),
        "wo": w(ko, dd),
        DECODER_WEIGHT_KEY: w(kd, (d, conf.n_out)),
        DECODER_BIAS_KEY: torch.zeros((conf.n_out,), device=dev),
    }


def init_layer_params(key: int, conf: NeuralNetConfiguration,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """conf → named params on ``device`` (CUDA unless ``device="cpu"``);
    dispatch replaces ref LayerFactories.getFactory."""
    t = conf.layer_type
    if t in (LayerType.DENSE, LayerType.OUTPUT):
        return _dense_params(key, conf, resolve_device(device))
    if t == LayerType.LSTM:
        return _lstm_params(key, conf, resolve_device(device))
    if t == LayerType.ATTENTION:
        return _attention_params(key, conf, resolve_device(device))
    if t in UNPORTED_LAYERS:
        raise unported(t, "param init")
    raise ValueError(f"No param initializer for layer type {t}")
