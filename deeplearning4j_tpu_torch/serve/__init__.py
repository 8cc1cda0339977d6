"""The port's serving stack: the decode engine, its fast path (prefix
cache, speculative decoding), the open-loop load generator, the
serve_dtype seam, and the fleet (replicas and the router over the remote
tracker)."""

from deeplearning4j_tpu_torch.serve.engine import DecodeEngine, ServeRequest
from deeplearning4j_tpu_torch.serve.fleet import FleetReplica, replica_main
from deeplearning4j_tpu_torch.serve.loadgen import (
    LoadReport,
    arrival_schedule,
    run_open_loop,
    run_open_loop_http,
)
from deeplearning4j_tpu_torch.serve.prefix_cache import PrefixPageCache
from deeplearning4j_tpu_torch.serve.router import (
    FleetRequest,
    FleetRouter,
    pick_replica,
)
from deeplearning4j_tpu_torch.serve.quant import (
    QuantTensor,
    activation_dtype,
    dequantize_tree,
    params_nbytes,
    prepare_serve_params,
)
from deeplearning4j_tpu_torch.serve.speculative import (
    SpeculativeConfig,
    accept_longest_prefix,
    resolve_speculative,
)

__all__ = [
    "DecodeEngine",
    "ServeRequest",
    "FleetReplica",
    "FleetRequest",
    "FleetRouter",
    "pick_replica",
    "replica_main",
    "LoadReport",
    "arrival_schedule",
    "run_open_loop",
    "run_open_loop_http",
    "PrefixPageCache",
    "QuantTensor",
    "SpeculativeConfig",
    "accept_longest_prefix",
    "activation_dtype",
    "dequantize_tree",
    "params_nbytes",
    "prepare_serve_params",
    "resolve_speculative",
]
