"""Counterpart of ``deeplearning4j_tpu/nn/params.py``: named-parameter
initialization per layer type, with the same parameter keys (ref:
nn/params/*.java), so flat parameter vectors and checkpoints line up
between the two packages.

Every layer type of the JAX package is ported: DENSE, OUTPUT, the
pretraining layers (RBM, AUTOENCODER, RECURSIVE_AUTOENCODER), CONVOLUTION,
SUBSAMPLING, LSTM and ATTENTION.
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

def _dense_params(key: int, conf: NeuralNetConfiguration,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    wkey, _ = split(key)
    return {
        WEIGHT_KEY: init_weights(wkey, (conf.n_in, conf.n_out),
                                 conf.weight_init, conf.dist, device=dev),
        BIAS_KEY: torch.zeros((conf.n_out,), device=dev),
    }


def _pretrain_params(key: int, conf: NeuralNetConfiguration,
                     dev: torch.device) -> Dict[str, torch.Tensor]:
    p = _dense_params(key, conf, dev)
    p[VISIBLE_BIAS_KEY] = torch.zeros((conf.n_in,), device=dev)
    return p


def _recursive_ae_params(key: int, conf: NeuralNetConfiguration,
                         dev: torch.device) -> Dict[str, torch.Tensor]:
    # combine matrix maps [x_i; parent] (n_in + n_out) -> n_out, decoded with
    # the transpose (ref: RecursiveAutoEncoder.java / RecursiveParamInitializer)
    in_dim = conf.n_in + conf.n_out
    wkey, _ = split(key)
    return {
        WEIGHT_KEY: init_weights(wkey, (in_dim, conf.n_out),
                                 conf.weight_init, conf.dist, device=dev),
        BIAS_KEY: torch.zeros((conf.n_out,), device=dev),
        VISIBLE_BIAS_KEY: torch.zeros((in_dim,), device=dev),
    }


def _conv_params(key: int, conf: NeuralNetConfiguration,
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    # OIHW filters: (out_channels, in_channels, kh, kw); one batched conv
    # where the reference loops convn over feature maps (ref:
    # ConvolutionLayer.java:115-128)
    kh, kw = conf.filter_size[-2], conf.filter_size[-1]
    wkey, _ = split(key)
    return {
        CONV_WEIGHT_KEY: init_weights(wkey, (conf.n_out, conf.n_in, kh, kw),
                                      conf.weight_init, conf.dist,
                                      device=dev),
        CONV_BIAS_KEY: torch.zeros((conf.n_out,), device=dev),
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
    dev = resolve_device(device)
    if t in (LayerType.DENSE, LayerType.OUTPUT):
        return _dense_params(key, conf, dev)
    if t in (LayerType.RBM, LayerType.AUTOENCODER):
        return _pretrain_params(key, conf, dev)
    if t == LayerType.RECURSIVE_AUTOENCODER:
        return _recursive_ae_params(key, conf, dev)
    if t == LayerType.CONVOLUTION:
        return _conv_params(key, conf, dev)
    if t == LayerType.SUBSAMPLING:
        return {}  # pooling has no params (ref: SubsampleParamInitializer)
    if t == LayerType.LSTM:
        return _lstm_params(key, conf, dev)
    if t == LayerType.ATTENTION:
        return _attention_params(key, conf, dev)
    raise ValueError(f"No param initializer for layer type {t}")
