"""The port's package-level exports held against the JAX package's: for
each subpackage, the public names (``__all__`` where the package has one,
else its non-module attributes without a leading underscore) equal JAX's,
less the names of slices still to be ported and plus the few names only
the port has, both listed here with the ROADMAP item that brings them.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import importlib
import types

import pytest

# names of unported slices, by subpackage (ROADMAP Queue 1, empty since
# item 21d)
UNPORTED = {}

# names only the port exports
PORT_ONLY = {
    "serve": {"activation_dtype"},  # the serve_dtype seam's activation dtype
    "models": {"Glove", "ParagraphVectors", "RNTN", "RNTNEval",
               "Word2Vec"},
}

SUBPACKAGES = ["", "cli", "clustering", "datasets", "eval", "models",
               "native", "nn", "ops", "optimize", "parallel", "plot",
               "scaleout", "serve", "telemetry", "text", "text.corpora",
               "tune", "ui", "utils"]


def _public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {name for name, value in vars(mod).items()
            if not name.startswith("_")
            and not isinstance(value, types.ModuleType)}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "root")
def test_public_names_equal_jax_less_unported(sub):
    suffix = "." + sub if sub else ""
    jmod = importlib.import_module("deeplearning4j_tpu" + suffix)
    tmod = importlib.import_module("deeplearning4j_tpu_torch" + suffix)
    unported = UNPORTED.get(sub, set())
    assert unported <= _public(jmod), "listed as unported but not in JAX"
    want = (_public(jmod) - unported) | PORT_ONLY.get(sub, set())
    assert _public(tmod) == want
    for name in _public(tmod):
        # every export resolves, and never to the JAX package's object
        owner = getattr(getattr(tmod, name), "__module__", None) or ""
        assert owner.split(".")[0] != "deeplearning4j_tpu", (name, owner)


def test_repaired_exports_are_present():
    import deeplearning4j_tpu_torch as pkg
    from deeplearning4j_tpu_torch import ops, optimize, scaleout, telemetry, \
        utils

    for mod, names in [
            (pkg, ["NeuralNetConfiguration", "MultiLayerConfiguration",
                   "MultiLayerNetwork"]),
            (ops, ["activation", "activation_names", "LossFunction", "loss"]),
            (optimize, ["UpdaterState", "init_updater_state",
                        "apply_updater", "Solver", "GuardConfig",
                        "guarded_sgd_update"]),
            (utils, ["MovingWindowMatrix"]),
            (scaleout, ["CheckpointIterationListener"]),
            (telemetry, ["global_norm", "MetricsRegistry", "Tracer",
                         "maybe_span"])]:
        for name in names:
            assert hasattr(mod, name), (mod.__name__, name)
    from deeplearning4j_tpu_torch import serve

    assert "fleet" in serve.__doc__ and "slice 4c" not in serve.__doc__
    for name in ("FleetReplica", "FleetRequest", "FleetRouter",
                 "pick_replica", "replica_main"):
        assert getattr(serve, name).__module__.startswith(
            "deeplearning4j_tpu_torch.serve."), name
    for name in ("ClusterAggregator", "MetricsPusher", "merge_snapshots"):
        assert getattr(telemetry, name).__module__ == \
            "deeplearning4j_tpu_torch.telemetry.federation", name


@pytest.mark.parametrize("sub,names", [
    ("text.corpora", ["PosTagger", "SWN3", "ConstituencyTree",
                      "HeadWordFinder", "PennTreeReader", "TreeIterator",
                      "TreeParser", "TreeVectorizer", "binarize",
                      "collapse_unaries", "to_rntn_tree"]),
    ("models", ["RNTN", "RNTNEval"]),
    ("parallel", ["data_parallel_mesh", "mesh_2d",
                  "ParameterAveragingTrainer"]),
])
def test_slice_7_exports_resolve_in_the_port(sub, names):
    """RNTN, trees and corpora, and the data-parallel trainer: each name
    resolves to the port's own object."""
    mod = importlib.import_module("deeplearning4j_tpu_torch." + sub)
    for name in names:
        owner = getattr(mod, name).__module__
        assert owner.startswith("deeplearning4j_tpu_torch."), (name, owner)
