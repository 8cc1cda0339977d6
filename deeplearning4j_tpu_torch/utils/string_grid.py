"""Counterpart of ``deeplearning4j_tpu/utils/string_grid.py``
(a copy: host code).

String-table dedup utilities.

Parity with ref: util/StringGrid.java (a List<List<String>> with CSV IO,
column ops, similarity clustering and dedup) and util/FingerPrintKeyer.java
(OpenRefine-style normalization key: lowercase, strip punctuation, unique
sorted tokens). The reference uses these for cleaning record data before
vectorization; same role here ahead of the records pipeline.
"""

from __future__ import annotations

import re
import unicodedata
from collections import defaultdict
from typing import Collection, Dict, Iterable, List, Optional

NONE = "NONE"  # ref: StringGrid.NONE missing-value marker


class FingerPrintKeyer:
    """Normalization key for near-duplicate detection
    (ref: util/FingerPrintKeyer.key)."""

    _PUNCT = re.compile(r"[^\w\s]")

    def key(self, s: str) -> str:
        s = s.strip().lower()
        s = unicodedata.normalize("NFKD", s)
        s = "".join(ch for ch in s if not unicodedata.combining(ch))
        s = self._PUNCT.sub("", s)
        frags = sorted(set(s.split()))
        return " ".join(frags)


def _similarity(a: str, b: str) -> float:
    """Token-set Jaccard similarity in [0,1] (the reference scores pairs with
    an MDL/ngram heuristic; Jaccard over fingerprint tokens serves the same
    thresholding role deterministically)."""
    ta = set(FingerPrintKeyer().key(a).split())
    tb = set(FingerPrintKeyer().key(b).split())
    if not ta and not tb:
        return 1.0
    if not ta or not tb:
        return 0.0
    return len(ta & tb) / len(ta | tb)


class StringGrid(List[List[str]]):
    """Rows of string columns with dedup/cleanup ops
    (ref: util/StringGrid.java)."""

    def __init__(self, sep: str = ",", num_columns: Optional[int] = None,
                 data: Optional[Iterable[str]] = None):
        super().__init__()
        self.sep = sep
        self.num_columns = num_columns
        if data is not None:
            for line in data:
                self.append_line(line)

    # ---- construction ----
    @classmethod
    def from_file(cls, path: str, sep: str = ",") -> "StringGrid":
        with open(path) as f:
            return cls(sep=sep, data=[l.rstrip("\n") for l in f if l.strip()])

    def append_line(self, line: str) -> None:
        row = line.split(self.sep)
        if self.num_columns is None:
            self.num_columns = len(row)
        elif len(row) != self.num_columns:
            raise ValueError(
                f"row has {len(row)} columns, grid has {self.num_columns}")
        self.append(row)

    # ---- column ops ----
    def get_column(self, column: int) -> List[str]:
        return [row[column] for row in self]

    def get_num_columns(self) -> int:
        return self.num_columns or 0

    def remove_columns(self, *columns: int) -> None:
        keep = [i for i in range(self.get_num_columns()) if i not in set(columns)]
        for i, row in enumerate(self):
            self[i] = [row[j] for j in keep]
        self.num_columns = len(keep)

    def remove_rows_with_empty_column(self, column: int,
                                      missing_value: str = "") -> None:
        self[:] = [r for r in self if r[column] != missing_value]

    def filter_rows_by_column(self, column: int,
                              values: Collection[str]) -> List[int]:
        return [i for i, r in enumerate(self) if r[column] in values]

    def get_rows_with_column_values(self, values: Collection[str],
                                    column: int) -> List[List[str]]:
        return [r for r in self if r[column] in values]

    def select(self, column: int, value: str) -> "StringGrid":
        out = StringGrid(sep=self.sep, num_columns=self.num_columns)
        for r in self:
            if r[column] == value:
                out.append(list(r))
        return out

    def sort_by(self, column: int) -> None:
        self.sort(key=lambda r: r[column])

    def swap(self, column1: int, column2: int) -> None:
        for r in self:
            r[column1], r[column2] = r[column2], r[column1]

    def merge(self, column1: int, column2: int) -> None:
        """Join column2 into column1 with a space; drop column2."""
        for r in self:
            r[column1] = (r[column1] + " " + r[column2]).strip()
        self.remove_columns(column2)

    def fill_down(self, value: str, column: int) -> None:
        for r in self:
            r[column] = value

    def split(self, column: int, sep_by: str) -> None:
        """Split a column in place into multiple columns."""
        width = max(len(r[column].split(sep_by)) for r in self) if self else 0
        for i, r in enumerate(self):
            parts = r[column].split(sep_by)
            parts += [""] * (width - len(parts))
            self[i] = r[:column] + parts + r[column + 1:]
        self.num_columns = (self.num_columns or 1) - 1 + width

    def head(self, num: int) -> "StringGrid":
        out = StringGrid(sep=self.sep, num_columns=self.num_columns)
        for r in self[:num]:
            out.append(list(r))
        return out

    # ---- similarity / dedup (ref: clusterColumn/dedupeByCluster) ----
    def cluster_column(self, column: int) -> Dict[str, List[int]]:
        """Fingerprint-key clusters: key → row indices."""
        keyer = FingerPrintKeyer()
        clusters: Dict[str, List[int]] = defaultdict(list)
        for i, r in enumerate(self):
            clusters[keyer.key(r[column])].append(i)
        return dict(clusters)

    def dedupe_by_cluster(self, column: int) -> None:
        """Keep the first row of every fingerprint cluster."""
        seen = set()
        keep = []
        keyer = FingerPrintKeyer()
        for r in self:
            k = keyer.key(r[column])
            if k not in seen:
                seen.add(k)
                keep.append(r)
        self[:] = keep

    def dedupe_by_cluster_all(self) -> None:
        for c in range(self.get_num_columns()):
            self.dedupe_by_cluster(c)

    def get_all_with_similarity(self, threshold: float, first_column: int,
                                second_column: int) -> "StringGrid":
        out = StringGrid(sep=self.sep, num_columns=self.num_columns)
        for r in self:
            if _similarity(r[first_column], r[second_column]) >= threshold:
                out.append(list(r))
        return out

    def filter_by_similarity(self, threshold: float, first_column: int,
                             second_column: int) -> None:
        self[:] = [r for r in self
                   if _similarity(r[first_column], r[second_column]) < threshold]

    # ---- output ----
    def to_lines(self) -> List[str]:
        return [self.sep.join(r) for r in self]

    def write_lines_to(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.to_lines()) + "\n")
