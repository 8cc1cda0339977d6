"""JAX's random draws put into the port's Word2Vec draw points.

Threefry and torch's generators never draw the same numbers, so the parity
tests of ``deeplearning4j_tpu_torch.models.word2vec`` (and of
ParagraphVectors over it) replay JAX's key splits instead: the ``rng``
module the port's code splits keys with is replaced by one that splits JAX
keys (an int key becomes ``PRNGKey(int)``, as the JAX package seeds its
fits), and the three draw points (``_keep_uniforms``, ``_window_draws``,
``_neg_slots``) draw with ``jax.random`` at the JAX package's shapes and
bounds. Every draw then equals the one the JAX package makes at the same
place.
"""

import types

import jax
import numpy as np
import torch

from deeplearning4j_tpu_torch.models import word2vec as tw2v


def _jkey(key):
    return jax.random.PRNGKey(key) if isinstance(key, int) else key


def _split(key, num: int = 2):
    return list(jax.random.split(_jkey(key), num))


JAX_RNG = types.SimpleNamespace(split=_split)


def _to(a, dtype, device):
    return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)


def keep_uniforms(key, n, device):
    return _to(jax.random.uniform(key, (n,)), np.float32, device)


def window_draws(key, n, window, device):
    return _to(jax.random.randint(key, (n,), 1, window + 1), np.int64, device)


def neg_slots(key, shape, slots, device):
    return _to(jax.random.randint(key, shape, 0, slots), np.int64, device)


def inject_jax_draws(monkeypatch, *modules) -> None:
    """Replace the draw points of ``word2vec`` and the ``rng`` of it and of
    ``modules`` (e.g. ``paragraph_vectors``) for the test's duration."""
    for mod in (tw2v,) + modules:
        monkeypatch.setattr(mod, "rng", JAX_RNG)
    monkeypatch.setattr(tw2v, "_keep_uniforms", keep_uniforms)
    monkeypatch.setattr(tw2v, "_window_draws", window_draws)
    monkeypatch.setattr(tw2v, "_neg_slots", neg_slots)
