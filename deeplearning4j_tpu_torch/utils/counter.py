"""Counterpart of ``deeplearning4j_tpu/utils/counter.py``, copied (no framework
in it).

Counter / CounterMap.

Parity with ref berkeley/Counter.java (643 LoC) and CounterMap.java (509):
float-valued counts with argmax/normalize/sorted-keys surface, and a nested
key→Counter map. Backed by dict; the normalize path returns numpy weights.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Generic, Hashable, Iterator, List, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
K2 = TypeVar("K2", bound=Hashable)


class Counter(Generic[K]):
    def __init__(self):
        self._counts: Dict[K, float] = {}

    def increment_count(self, key: K, amount: float = 1.0) -> None:
        self._counts[key] = self._counts.get(key, 0.0) + amount

    def set_count(self, key: K, value: float) -> None:
        self._counts[key] = value

    def get_count(self, key: K) -> float:
        return self._counts.get(key, 0.0)

    def remove(self, key: K) -> None:
        self._counts.pop(key, None)

    def contains(self, key: K) -> bool:
        return key in self._counts

    def key_set(self) -> List[K]:
        return list(self._counts.keys())

    def total_count(self) -> float:
        return sum(self._counts.values())

    def arg_max(self) -> K:
        if not self._counts:
            raise ValueError("empty counter")
        return max(self._counts, key=self._counts.get)

    def max_count(self) -> float:
        return self._counts[self.arg_max()]

    def normalize(self) -> None:
        total = self.total_count()
        if total:
            for k in self._counts:
                self._counts[k] /= total

    def sorted_keys(self, descending: bool = True) -> List[K]:
        return sorted(self._counts, key=self._counts.get, reverse=descending)

    def __len__(self) -> int:
        return len(self._counts)

    def __iter__(self) -> Iterator[K]:
        return iter(self._counts)

    def items(self) -> Iterator[Tuple[K, float]]:
        return iter(self._counts.items())

    def __repr__(self) -> str:
        top = ", ".join(f"{k}:{v:g}" for k, v in
                        sorted(self._counts.items(),
                               key=lambda kv: -kv[1])[:10])
        return f"Counter[{top}]"


class CounterMap(Generic[K, K2]):
    def __init__(self):
        self._map: Dict[K, Counter[K2]] = defaultdict(Counter)

    def increment_count(self, key: K, sub_key: K2, amount: float = 1.0) -> None:
        self._map[key].increment_count(sub_key, amount)

    def set_count(self, key: K, sub_key: K2, value: float) -> None:
        self._map[key].set_count(sub_key, value)

    def get_count(self, key: K, sub_key: K2) -> float:
        return self._map[key].get_count(sub_key) if key in self._map else 0.0

    def get_counter(self, key: K) -> Counter:
        return self._map[key]

    def key_set(self) -> List[K]:
        return list(self._map.keys())

    def total_count(self) -> float:
        return sum(c.total_count() for c in self._map.values())

    def total_size(self) -> int:
        return sum(len(c) for c in self._map.values())

    def normalize(self) -> None:
        for c in self._map.values():
            c.normalize()

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: K) -> bool:
        return key in self._map
