"""Counterpart of ``deeplearning4j_tpu/nn/api.py``: the core API enums,
copied (they are plain data).

Parity with the reference's ``nn/api`` package:
- ``Model``/``Layer``/``Classifier`` contracts (ref: nn/api/Model.java:36,
  nn/api/Layer.java:37) — realized here as the stateful facade
  ``MultiLayerNetwork`` over pure torch functions.
- ``OptimizationAlgorithm`` enum (ref: nn/api/OptimizationAlgorithm.java).
- ``LayerType`` replaces the reference's layer-class + LayerFactory dispatch
  (ref: nn/layers/factory/LayerFactories.java).
"""

from __future__ import annotations

import enum


class OptimizationAlgorithm(str, enum.Enum):
    GRADIENT_DESCENT = "GRADIENT_DESCENT"
    CONJUGATE_GRADIENT = "CONJUGATE_GRADIENT"
    HESSIAN_FREE = "HESSIAN_FREE"
    LBFGS = "LBFGS"
    ITERATION_GRADIENT_DESCENT = "ITERATION_GRADIENT_DESCENT"

    @classmethod
    def coerce(cls, v) -> "OptimizationAlgorithm":
        return v if isinstance(v, cls) else cls(str(v))


class LayerType(str, enum.Enum):
    """Which layer implementation a NeuralNetConfiguration instantiates."""

    DENSE = "DENSE"
    OUTPUT = "OUTPUT"
    RBM = "RBM"
    AUTOENCODER = "AUTOENCODER"
    RECURSIVE_AUTOENCODER = "RECURSIVE_AUTOENCODER"
    CONVOLUTION = "CONVOLUTION"
    SUBSAMPLING = "SUBSAMPLING"
    LSTM = "LSTM"
    ATTENTION = "ATTENTION"

    @classmethod
    def coerce(cls, v) -> "LayerType":
        return v if isinstance(v, cls) else cls(str(v).upper())


class VisibleUnit(str, enum.Enum):
    """RBM visible unit types (ref: nn/layers/feedforward/rbm/RBM.java)."""

    BINARY = "BINARY"
    GAUSSIAN = "GAUSSIAN"
    SOFTMAX = "SOFTMAX"
    LINEAR = "LINEAR"

    @classmethod
    def coerce(cls, v) -> "VisibleUnit":
        return v if isinstance(v, cls) else cls(str(v).upper())


class HiddenUnit(str, enum.Enum):
    """RBM hidden unit types (ref: RBM.java:217 sampleHiddenGivenVisible)."""

    BINARY = "BINARY"
    GAUSSIAN = "GAUSSIAN"
    SOFTMAX = "SOFTMAX"
    RECTIFIED = "RECTIFIED"

    @classmethod
    def coerce(cls, v) -> "HiddenUnit":
        return v if isinstance(v, cls) else cls(str(v).upper())


class ConvolutionType(str, enum.Enum):
    """Subsampling pooling type (ref: ConvolutionLayer.ConvolutionType)."""

    MAX = "MAX"
    SUM = "SUM"
    AVG = "AVG"
    NONE = "NONE"

    @classmethod
    def coerce(cls, v) -> "ConvolutionType":
        return v if isinstance(v, cls) else cls(str(v).upper())
