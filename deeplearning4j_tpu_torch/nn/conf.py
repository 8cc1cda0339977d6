"""Counterpart of ``deeplearning4j_tpu/nn/conf.py``: network configuration
with JSON round-trip, ported whole (it is data).

Parity with the reference's ``NeuralNetConfiguration`` (field set at ref:
nn/conf/NeuralNetConfiguration.java:53-121, fluent Builder at :854-1065,
Jackson mapper at :840-851) and ``MultiLayerConfiguration``
(ref: nn/conf/MultiLayerConfiguration.java:36-50, toJson/fromJson at :166-191).

The field set, defaults and field order are the JAX package's, so a JSON
written by either package loads in the other and re-serialises to the same
text. Configs are frozen, hashable dataclasses; layer classes are named by
the ``LayerType`` enum; the per-layer RNG is a single integer ``seed``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional, Tuple

from deeplearning4j_tpu_torch.nn.api import (
    ConvolutionType,
    HiddenUnit,
    LayerType,
    OptimizationAlgorithm,
    VisibleUnit,
)
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.ops.losses import LossFunction


def _freeze_schedule(sched) -> Tuple[Tuple[int, float], ...]:
    """Normalise {iteration: value} schedules to sorted tuples (hashable)."""
    if sched is None:
        return ()
    if isinstance(sched, Mapping):
        return tuple(sorted((int(k), float(v)) for k, v in sched.items()))
    return tuple((int(k), float(v)) for k, v in sched)


@dataclasses.dataclass(frozen=True)
class NeuralNetConfiguration:
    """Per-layer hyperparameter configuration (one per layer in a network)."""

    # architecture
    layer_type: LayerType = LayerType.DENSE
    n_in: int = 0
    n_out: int = 0
    activation_function: str = "sigmoid"
    # optimisation
    lr: float = 1e-1
    use_ada_grad: bool = True
    momentum: float = 0.5
    momentum_after: Tuple[Tuple[int, float], ...] = ()
    reset_ada_grad_iterations: int = -1
    num_iterations: int = 1000
    num_line_search_iterations: int = 5
    optimization_algo: OptimizationAlgorithm = OptimizationAlgorithm.GRADIENT_DESCENT
    minimize: bool = True
    step_function: str = "default"
    # regularisation
    l1: float = 0.0
    l2: float = 0.0
    use_regularization: bool = False
    dropout: float = 0.0
    constrain_gradient_to_unit_norm: bool = False
    sparsity: float = 0.0
    apply_sparsity: bool = False
    # loss / init
    loss_function: LossFunction = LossFunction.RECONSTRUCTION_CROSSENTROPY
    weight_init: WeightInit = WeightInit.VI
    dist: Optional[Tuple[str, float, float]] = None
    seed: int = 123
    # pretraining (RBM / AutoEncoder)
    corruption_level: float = 0.3
    k: int = 1
    visible_unit: VisibleUnit = VisibleUnit.BINARY
    hidden_unit: HiddenUnit = HiddenUnit.BINARY
    # convolutional
    filter_size: Tuple[int, ...] = (2, 2)
    stride: Tuple[int, ...] = (2, 2)
    feature_map_size: Tuple[int, ...] = (9, 9)
    convolution_type: ConvolutionType = ConvolutionType.MAX
    # attention (beyond-reference long-context layer)
    n_heads: int = 1
    causal: bool = True
    # batching
    batch_size: int = 10

    def __post_init__(self):
        # Coerce loosely-typed JSON values into enums/tuples so fromJson and
        # hand-built configs behave identically.
        object.__setattr__(self, "layer_type", LayerType.coerce(self.layer_type))
        object.__setattr__(
            self, "optimization_algo", OptimizationAlgorithm.coerce(self.optimization_algo)
        )
        object.__setattr__(self, "loss_function", LossFunction.coerce(self.loss_function))
        object.__setattr__(self, "weight_init", WeightInit.coerce(self.weight_init))
        object.__setattr__(self, "visible_unit", VisibleUnit.coerce(self.visible_unit))
        object.__setattr__(self, "hidden_unit", HiddenUnit.coerce(self.hidden_unit))
        object.__setattr__(
            self, "convolution_type", ConvolutionType.coerce(self.convolution_type)
        )
        object.__setattr__(self, "momentum_after", _freeze_schedule(self.momentum_after))
        for f in ("filter_size", "stride", "feature_map_size"):
            object.__setattr__(self, f, tuple(int(x) for x in getattr(self, f)))
        # fail at conf time, not first trace: a typo'd activation or step
        # function should raise here with the list of known names
        from deeplearning4j_tpu_torch.ops.activations import activation as _act
        _act(self.activation_function)
        from deeplearning4j_tpu_torch.optimize.stepfunctions import (
            step_function as _sf,
        )
        _sf(self.step_function)
        if self.dist is not None:
            k, a, b = self.dist
            object.__setattr__(self, "dist", (str(k), float(a), float(b)))

    # ---- momentum schedule ----
    def momentum_at(self, iteration: int) -> float:
        """Momentum honouring the momentumAfter schedule (ref:
        GradientAdjustment.java:85-92, which uses only the first entry)."""
        m = self.momentum
        for it, val in self.momentum_after:
            if iteration >= it:
                m = val
        return m

    # ---- serialization ----
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for key, val in list(d.items()):
            if isinstance(val, tuple):
                d[key] = list(val)
        d["momentum_after"] = [[i, v] for i, v in self.momentum_after]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NeuralNetConfiguration":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if kwargs.get("dist") is not None:
            kwargs["dist"] = tuple(kwargs["dist"])
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "NeuralNetConfiguration":
        return cls.from_dict(json.loads(s))

    # ---- fluent builder (API parity with ref Builder at :854-1065) ----
    class Builder:
        def __init__(self):
            self._kw: Dict[str, Any] = {}

        def __getattr__(self, name):
            def setter(value):
                self._kw[name] = value
                return self

            return setter

        def layer(self, layer_type):
            self._kw["layer_type"] = layer_type
            return self

        def list(self, n_layers: int) -> "ListBuilder":
            return ListBuilder(NeuralNetConfiguration(**self._kw), n_layers)

        def build(self) -> "NeuralNetConfiguration":
            return NeuralNetConfiguration(**self._kw)


@dataclasses.dataclass(frozen=True)
class MultiLayerConfiguration:
    """Whole-network configuration: ordered per-layer confs + global flags.

    Parity with ref: nn/conf/MultiLayerConfiguration.java:36-50 (confs,
    hiddenLayerSizes, pretrain/backward flags, input preprocessors).
    Preprocessors are named by string key per layer index; see
    nn/layers/preprocessor.py for the registry (ref: nn/conf/preprocessor/).
    """

    confs: Tuple[NeuralNetConfiguration, ...] = ()
    hidden_layer_sizes: Tuple[int, ...] = ()
    pretrain: bool = True
    backward: bool = False
    use_drop_connect: bool = False
    input_preprocessors: Tuple[Tuple[int, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "confs", tuple(self.confs))
        object.__setattr__(
            self, "hidden_layer_sizes", tuple(int(x) for x in self.hidden_layer_sizes)
        )
        object.__setattr__(
            self,
            "input_preprocessors",
            tuple(sorted((int(i), str(p)) for i, p in self.input_preprocessors)),
        )

    def conf(self, i: int) -> NeuralNetConfiguration:
        return self.confs[i]

    @property
    def n_layers(self) -> int:
        return len(self.confs)

    def preprocessor_for(self, i: int) -> Optional[str]:
        for idx, name in self.input_preprocessors:
            if idx == i:
                return name
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "confs": [c.to_dict() for c in self.confs],
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "pretrain": self.pretrain,
            "backward": self.backward,
            "use_drop_connect": self.use_drop_connect,
            "input_preprocessors": [[i, p] for i, p in self.input_preprocessors],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MultiLayerConfiguration":
        return cls(
            confs=tuple(NeuralNetConfiguration.from_dict(c) for c in d.get("confs", ())),
            hidden_layer_sizes=tuple(d.get("hidden_layer_sizes", ())),
            pretrain=bool(d.get("pretrain", True)),
            backward=bool(d.get("backward", False)),
            use_drop_connect=bool(d.get("use_drop_connect", False)),
            input_preprocessors=tuple(
                (int(i), str(p)) for i, p in d.get("input_preprocessors", ())
            ),
        )

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfiguration":
        return cls.from_dict(json.loads(s))


class ListBuilder:
    """Builder for MultiLayerConfiguration via per-layer overrides.

    Parity with the reference's ``NeuralNetConfiguration.ListBuilder`` +
    ``ConfOverride`` mechanism (ref: nn/conf/NeuralNetConfiguration.java,
    nn/conf/override/ConfOverride.java): start from a base conf replicated
    across layers, then override individual layers.
    """

    def __init__(self, base: NeuralNetConfiguration, n_layers: int):
        self._base = base
        self._n = n_layers
        self._overrides: Dict[int, Dict[str, Any]] = {}
        self._hidden_sizes: Tuple[int, ...] = ()
        self._pretrain = True
        self._backward = False
        self._use_drop_connect = False
        self._preprocessors: Dict[int, str] = {}

    def hidden_layer_sizes(self, *sizes: int) -> "ListBuilder":
        self._hidden_sizes = tuple(sizes)
        return self

    def override(self, layer: int, **kwargs) -> "ListBuilder":
        self._overrides.setdefault(layer, {}).update(kwargs)
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backward(self, flag: bool) -> "ListBuilder":
        self._backward = flag
        return self

    def use_drop_connect(self, flag: bool) -> "ListBuilder":
        self._use_drop_connect = flag
        return self

    def input_preprocessor(self, layer: int, name: str) -> "ListBuilder":
        self._preprocessors[layer] = name
        return self

    def build(self) -> MultiLayerConfiguration:
        confs = []
        for i in range(self._n):
            kw = dataclasses.asdict(self._base)
            # asdict loses enum identity; re-coercion happens in __post_init__
            kw.update(self._overrides.get(i, {}))
            confs.append(NeuralNetConfiguration(**kw))
        return MultiLayerConfiguration(
            confs=tuple(confs),
            hidden_layer_sizes=self._hidden_sizes,
            pretrain=self._pretrain,
            backward=self._backward,
            use_drop_connect=self._use_drop_connect,
            input_preprocessors=tuple(self._preprocessors.items()),
        )
