"""Counterpart of ``deeplearning4j_tpu/tune/``: the roofline-guided
autotuner.

Turns the step profile (``telemetry/xprofile.profile_compiled``: one
counted call) into a config search engine:

- ``space.py``  — declarative per-seam search spaces (knob names, candidate
  values, validity predicates) with a version stamp per space; JAX's four.
- ``search.py`` — two-phase searcher: profile one call of every valid
  candidate, prune by roofline position + peak/wire-byte dominance, then
  wall-clock-measure only the Pareto frontier with paired medians.
- ``cache.py``  — persistent tuning cache (``TUNE_CACHE.json``, JAX's
  schema) keyed by (seam, model-shape fingerprint incl. mesh + device
  type, knob-space version), consulted through the ``tuned=`` seam on the
  LM's step factories, the pipeline step and ``DecodeEngine``.
- ``seams.py``  — the concrete harnesses (context, default config,
  compile_fn, measure_fn) per tunable seam, shared by the CLI
  (``python -m deeplearning4j_tpu_torch.tune``) and ``chip_smoke.py``.

On the card the ``flash_attention`` knobs (``block_q``/``block_k``) select
K3f's key split (``ops.flash_attention.key_split_for``). Tuning changes
speed, never tokens or losses: the searcher gates every candidate on its
outputs matching the default config's, and tests/test_torch_tune.py pins
each cache adoption to its default twin and to JAX's.
"""

from deeplearning4j_tpu_torch.tune.cache import (  # noqa: F401
    TuningCache,
    default_cache_path,
    fingerprint,
    resolve_tuned,
)
from deeplearning4j_tpu_torch.tune.search import SearchResult, search  # noqa: F401
from deeplearning4j_tpu_torch.tune.space import (  # noqa: F401
    Knob,
    SearchSpace,
    get_space,
    register_space,
    space_names,
    space_version,
)
