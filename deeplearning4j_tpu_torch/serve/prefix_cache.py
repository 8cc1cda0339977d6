"""Counterpart of ``deeplearning4j_tpu/serve/prefix_cache.py``: shared-prefix
KV page reuse for the decode engine.

The engine's paged cache gives every slot a private (L, H, T_max, Dh) page;
without this module admission re-prefills the whole prompt even when many
requests share a system prompt. The page table here is hash-prefixed over
fixed ``page_tokens``-sized token pages:

- **Chain keys.** Page m of a prompt is keyed by
  ``blake2b(parent_key || tokens[m·P:(m+1)·P])``: the key commits to the
  ENTIRE token prefix through its parent chain, so two prompts share a node
  iff they share the full prefix up to that page. Lookup walks the chain
  greedily and returns the longest cached page-aligned prefix.
- **Copy-on-write at the divergence page.** Insertion never mutates an
  existing node: a prompt diverging inside page m leaves the shared nodes
  0..m-1 untouched and creates a sibling node for its own page m.
- **Pages own their memory.** The engine inserts views of a slot's cache
  rows, which later decode, verify and chunk steps and the slot's next
  occupant overwrite in place (JAX hands over immutable arrays). So
  ``insert`` stores a ``.clone()`` of each page, and seeding copies page
  content into the slot's rows (``seed_slot_pages``): neither side ever
  aliases the other. The table's device memory is ``pages × 2 × L × H × P
  × Dh × itemsize``: 64 KiB a page for the bf16 flagship (2 layers, 4
  heads of 128, P = 16).
- **Refcounts + LRU.** A node's refcount is its CHILD count (a parent
  outlives its children); only refcount-0 leaves are evictable, oldest
  ``last_use`` first, cascading parent decrements as a chain tail is
  peeled. Capacity is a page budget, not a prompt budget.

The K/V stored per page is a function of the token prefix alone (position
``j``'s K/V depends only on tokens ``0..j``), which is what makes reuse
exact. Only PROMPT pages are inserted.

Thread-safety: all table state sits behind one lock (the
``serve.prefix_cache`` lockwatch seam), taken strictly after the engine's scheduler lock on engine paths. Metrics land
in the engine's registry under ``serve_prefix_cache_*``.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.lockwatch import make_lock


_ROOT_KEY = b"root"


def seed_slot_pages(ck: torch.Tensor, cv: torch.Tensor, pk: torch.Tensor,
                    pv: torch.Tensor, slot: int) -> None:
    """Copy a cached prefix, ``pk``/``pv`` (L, H, plen, Dh), into slot
    ``slot``'s cache rows at positions [0, plen), in place (JAX's jitted
    donate-and-rebind)."""
    plen = pk.shape[2]
    ck[:, slot, :, :plen].copy_(pk)
    cv[:, slot, :, :plen].copy_(pv)


class _PageNode:
    __slots__ = ("key", "parent", "tokens", "k", "v", "refcount",
                 "last_use", "depth")

    def __init__(self, key: bytes, parent: Optional[bytes],
                 tokens: Tuple[int, ...], k, v, depth: int):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.k = k                      # (L, H, P, Dh), owns its memory
        self.v = v
        self.refcount = 0               # number of child nodes
        self.last_use = 0
        self.depth = depth              # page index within its prefix


def _chain_key(parent: bytes, tokens: Tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PrefixPageCache:
    """The page table (module docstring). ``capacity_pages`` bounds
    resident pages; ``page_tokens`` is the sharing granularity (a prefix
    is reusable in whole-page units only)."""

    def __init__(self, page_tokens: int = 16, capacity_pages: int = 256,
                 registry=None):
        if page_tokens < 1:
            raise ValueError(
                f"page_tokens must be >= 1, got {page_tokens}")
        if capacity_pages < 1:
            raise ValueError(
                f"capacity_pages must be >= 1, got {capacity_pages}")
        from deeplearning4j_tpu_torch.telemetry.registry import (
            default_registry,
        )

        self.page_tokens = int(page_tokens)
        self.capacity_pages = int(capacity_pages)
        self.registry = registry if registry is not None else \
            default_registry()
        self._lock = make_lock("serve.prefix_cache")  # lockwatch seam
        # counters/pages exist (at 0) from construction so metrics_record
        # renders them; the hit_rate gauge stays unborn until the first
        # lookup ("no lookups yet" reads as no data, not as 0.0)
        for name in ("serve_prefix_cache_hits_total",
                     "serve_prefix_cache_misses_total",
                     "serve_prefix_cache_tokens_reused_total",
                     "serve_prefix_cache_evictions_total"):
            self.registry.counter(name)
        self.registry.gauge("serve_prefix_cache_pages").set(0.0)
        self._nodes: Dict[bytes, _PageNode] = {}
        self._clock = itertools.count(1)
        self.lookups = 0
        self.hits = 0                  # lookups with >= 1 cached page
        self.tokens_reused = 0
        self.evictions = 0

    # ------------------------------------------------------------- lookup ----
    def lookup(self, prompt) -> Tuple[int, list, list]:
        """Longest cached page-aligned prefix of ``prompt``: returns
        ``(plen, k_pages, v_pages)``: ``plen`` matched tokens (a multiple
        of ``page_tokens``) and the per-page (L, H, P, Dh) tensors in
        order. The tensors stay alive through the caller's references
        even if their nodes are evicted meanwhile; callers copy them and
        never write them."""
        P = self.page_tokens
        k_pages: List = []
        v_pages: List = []
        with self._lock:
            self.lookups += 1
            parent = _ROOT_KEY
            now = next(self._clock)
            for m in range(len(prompt) // P):
                page = tuple(int(t) for t in prompt[m * P:(m + 1) * P])
                key = _chain_key(parent, page)
                node = self._nodes.get(key)
                if node is None:
                    break
                node.last_use = now
                k_pages.append(node.k)
                v_pages.append(node.v)
                parent = key
            plen = len(k_pages) * P
            if plen:
                self.hits += 1
                self.tokens_reused += plen
                self.registry.counter(
                    "serve_prefix_cache_hits_total").inc()
                self.registry.counter(
                    "serve_prefix_cache_tokens_reused_total").inc(plen)
            else:
                self.registry.counter(
                    "serve_prefix_cache_misses_total").inc()
            self.registry.gauge("serve_prefix_cache_hit_rate").set(
                self.hits / self.lookups)
        return plen, k_pages, v_pages

    # ------------------------------------------------------------- insert ----
    def insert(self, prompt, k_prefix: torch.Tensor,
               v_prefix: torch.Tensor) -> int:
        """Insert every full page of ``prompt`` whose K/V ``k_prefix``/
        ``v_prefix`` (L, H, n_avail, Dh) covers: called by the engine after
        a cold, chunked or suffix prefill, when the slot's cache rows hold
        the prompt's exact K/V. A new node stores a clone of its page, so
        the caller may pass views of memory it overwrites later. Existing
        nodes are left untouched (copy-on-write). Returns the number of
        NEW pages stored."""
        P = self.page_tokens
        n_pages = min(len(prompt), int(k_prefix.shape[2])) // P
        created = 0
        with self._lock:
            parent = _ROOT_KEY
            now = next(self._clock)
            for m in range(n_pages):
                page = tuple(int(t) for t in prompt[m * P:(m + 1) * P])
                key = _chain_key(parent, page)
                node = self._nodes.get(key)
                if node is None:
                    node = _PageNode(
                        key, None if parent == _ROOT_KEY else parent,
                        page,
                        k_prefix[:, :, m * P:(m + 1) * P, :].clone(),
                        v_prefix[:, :, m * P:(m + 1) * P, :].clone(),
                        depth=m)
                    self._nodes[key] = node
                    if node.parent is not None:
                        self._nodes[node.parent].refcount += 1
                    created += 1
                node.last_use = now
                parent = key
            self._evict_to_capacity()
            self.registry.gauge("serve_prefix_cache_pages").set(
                float(len(self._nodes)))
        return created

    # ----------------------------------------------------------- eviction ----
    def _evict_to_capacity(self) -> None:
        # called under self._lock
        while len(self._nodes) > self.capacity_pages:
            victims = [n for n in self._nodes.values() if n.refcount == 0]
            if not victims:
                return  # every node is an interior parent; nothing safe
            victim = min(victims, key=lambda n: n.last_use)
            del self._nodes[victim.key]
            if victim.parent is not None:
                self._nodes[victim.parent].refcount -= 1
            self.evictions += 1
            self.registry.counter(
                "serve_prefix_cache_evictions_total").inc()

    # -------------------------------------------------------------- stats ----
    def stats(self) -> dict:
        with self._lock:
            return {
                "pages": len(self._nodes),
                "capacity_pages": self.capacity_pages,
                "page_tokens": self.page_tokens,
                "lookups": self.lookups,
                "hits": self.hits,
                "hit_rate": (self.hits / self.lookups
                             if self.lookups else 0.0),
                "tokens_reused": self.tokens_reused,
                "evictions": self.evictions,
            }

    def check_invariants(self) -> None:
        """Structural invariants for the concurrency tests: refcount ==
        live child count, every parent resident, depth consistent."""
        with self._lock:
            children: Dict[bytes, int] = {}
            for node in self._nodes.values():
                if node.parent is not None:
                    assert node.parent in self._nodes, \
                        "child outlived its parent page"
                    children[node.parent] = children.get(node.parent,
                                                         0) + 1
                    assert self._nodes[node.parent].depth == \
                        node.depth - 1
            for node in self._nodes.values():
                assert node.refcount == children.get(node.key, 0), \
                    (f"refcount {node.refcount} != live children "
                     f"{children.get(node.key, 0)}")
