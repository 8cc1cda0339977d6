"""The port's serving stack: the decode engine and the serve_dtype seam."""

from deeplearning4j_tpu_torch.serve.engine import DecodeEngine, ServeRequest
from deeplearning4j_tpu_torch.serve.quant import (
    QuantTensor,
    activation_dtype,
    dequantize_tree,
    params_nbytes,
    prepare_serve_params,
)

__all__ = ["DecodeEngine", "ServeRequest", "QuantTensor",
           "activation_dtype", "dequantize_tree", "params_nbytes",
           "prepare_serve_params"]
