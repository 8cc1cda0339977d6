"""Counterpart of ``deeplearning4j_tpu/native/lib.py``: build and bind the
repo's native host library (``native/dataloader.cpp``: the CSV parser, the
prefetching batch loader and the buffer pool; ``native/text.cpp``: the
corpus tokenize, count and index behind Word2Vec's vocab fast path).

The library is compiled at first use by ``g++`` with ``native/Makefile``'s
flags into ``deeplearning4j_tpu_torch/_build/libdl4j_native_<digest>.so``;
the digest covers both sources and the flags, so an edited source is
rebuilt and a built one is reused. The compiler writes a temporary file
that is then renamed into place, so parallel processes never load a half
written library. Nothing is built at import, nothing is written into
``native/``, and a failed build raises with the compiler's output: there
is no silent pure-Python stand-in for the library itself. The one
fallback kept is JAX's, on content: ``corpus_index`` returns ``None`` for
non-ASCII text, whose byte-wise split would differ from ``str.split``.

``CALLS`` counts the calls that ran native code, one integer per path, so
a run can show that it went through the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("dataloader.cpp", "text.cpp")
# native/Makefile's CXXFLAGS plus -shared
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

CALLS: Dict[str, int] = {"load_csv": 0, "corpus_index": 0,
                         "loader_batch": 0, "pool_acquire": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dl4j_last_error.restype = ctypes.c_char_p
    lib.dl4j_csv_load.restype = ctypes.POINTER(ctypes.c_float)
    lib.dl4j_csv_load.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dl4j_free.argtypes = [ctypes.c_void_p]
    lib.dl4j_pool_create.restype = ctypes.c_void_p
    lib.dl4j_pool_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
    lib.dl4j_pool_acquire.restype = ctypes.c_void_p
    lib.dl4j_pool_acquire.argtypes = [ctypes.c_void_p]
    lib.dl4j_pool_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dl4j_pool_available.restype = ctypes.c_int
    lib.dl4j_pool_available.argtypes = [ctypes.c_void_p]
    lib.dl4j_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.dl4j_loader_open.restype = ctypes.c_void_p
    lib.dl4j_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.dl4j_loader_cols.restype = ctypes.c_int64
    lib.dl4j_loader_cols.argtypes = [ctypes.c_void_p]
    lib.dl4j_loader_rows.restype = ctypes.c_int64
    lib.dl4j_loader_rows.argtypes = [ctypes.c_void_p]
    lib.dl4j_loader_next.restype = ctypes.c_int64
    lib.dl4j_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.dl4j_loader_close.argtypes = [ctypes.c_void_p]
    lib.dl4j_corpus_index.restype = ctypes.c_void_p
    lib.dl4j_corpus_index.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.dl4j_corpus_vocab_size.restype = ctypes.c_int64
    lib.dl4j_corpus_vocab_size.argtypes = [ctypes.c_void_p]
    lib.dl4j_corpus_words_bytes.restype = ctypes.c_int64
    lib.dl4j_corpus_words_bytes.argtypes = [ctypes.c_void_p]
    lib.dl4j_corpus_export_vocab.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dl4j_corpus_n_tokens.restype = ctypes.c_int64
    lib.dl4j_corpus_n_tokens.argtypes = [ctypes.c_void_p]
    lib.dl4j_corpus_n_sentences.restype = ctypes.c_int64
    lib.dl4j_corpus_n_sentences.argtypes = [ctypes.c_void_p]
    lib.dl4j_corpus_export_index.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dl4j_corpus_free.argtypes = [ctypes.c_void_p]
    return lib


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the native "
                           "library builds from native/*.cpp with g++")
    return found


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode() + b"\0"
                      + (NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libdl4j_native_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/*.cpp`` unless the digest-named library exists;
    returns its path. Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed "
                           f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib() -> ctypes.CDLL:
    """The bound library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def native_available() -> bool:
    """True once the library is built and bound; a failed build raises."""
    return _get_lib() is not None


def load_csv(path: str, delimiter: str = ",", skip_lines: int = 0) -> np.ndarray:
    """Parse a numeric CSV to a (rows, cols) float32 array with the native
    mmap parser."""
    lib = _get_lib()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = lib.dl4j_csv_load(path.encode(), delimiter.encode(), skip_lines,
                            ctypes.byref(rows), ctypes.byref(cols))
    CALLS["load_csv"] += 1
    if not ptr:
        raise ValueError(
            f"native csv parse failed for {path!r}: "
            f"{lib.dl4j_last_error().decode()}"
        )
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.dl4j_free(ptr)
    return arr.reshape(rows.value, cols.value)


def corpus_index(text: bytes, min_count: int = 1
                 ) -> Optional[Tuple[list, np.ndarray, np.ndarray, np.ndarray]]:
    """Native corpus tokenize+count+index (native/text.cpp).

    ``text``: newline-separated ASCII sentences. Returns
    (words, counts int64, flat int32, sentence_ids int32) with the exact
    semantics of VocabCache.finish + word2vec build_vocab indexing
    (vocab by (-count, word); sentences with <2 kept tokens dropped),
    or None when the input is not ASCII (byte-wise tokenizing would
    diverge from Python str.split on unicode whitespace — the caller keeps
    its Python path)."""
    lib = _get_lib()
    if not text.isascii():
        return None
    handle = lib.dl4j_corpus_index(text, len(text), min_count)
    if not handle:
        return None
    CALLS["corpus_index"] += 1
    try:
        n_vocab = lib.dl4j_corpus_vocab_size(handle)
        counts = np.zeros(n_vocab, np.int64)
        words_buf = ctypes.create_string_buffer(
            int(lib.dl4j_corpus_words_bytes(handle)))
        if n_vocab:
            lib.dl4j_corpus_export_vocab(
                handle, words_buf,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        words = words_buf.raw.decode("ascii").split("\n")[:-1] if n_vocab else []
        n_tok = lib.dl4j_corpus_n_tokens(handle)
        flat = np.zeros(n_tok, np.int32)
        sids = np.zeros(n_tok, np.int32)
        if n_tok:
            lib.dl4j_corpus_export_index(
                handle,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                sids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return words, counts, flat, sids
    finally:
        lib.dl4j_corpus_free(handle)


class PooledBuffer:
    """float32 view over one pooled native buffer. ``array`` is the usable
    view."""

    __slots__ = ("array", "_ptr")

    def __init__(self, array: np.ndarray, ptr=None):
        self.array = array
        self._ptr = ptr


class BufferPool:
    """Reusable page-aligned host staging buffers."""

    def __init__(self, buffer_bytes: int, count: int):
        self.buffer_bytes = buffer_bytes
        self.count = count
        self._lib = _get_lib()
        self._handle = self._lib.dl4j_pool_create(buffer_bytes, count)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def acquire(self) -> Optional[PooledBuffer]:
        """A pooled buffer, or None when the pool is exhausted."""
        if self._handle is None:
            raise RuntimeError("the buffer pool is closed")
        ptr = self._lib.dl4j_pool_acquire(self._handle)
        if not ptr:
            return None
        CALLS["pool_acquire"] += 1
        arr = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)),
            shape=(self.buffer_bytes // 4,),
        )
        return PooledBuffer(arr, ptr)

    def release(self, buf: PooledBuffer) -> None:
        if self._handle is not None and buf._ptr is not None:
            self._lib.dl4j_pool_release(self._handle, buf._ptr)
            buf._ptr = None

    def available(self) -> int:
        if self._handle is None:
            raise RuntimeError("the buffer pool is closed")
        return self._lib.dl4j_pool_available(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dl4j_pool_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeCSVLoader:
    """Background-prefetching batch loader over a numeric CSV.

    Iterates (batch_rows, cols) float32 arrays; the native producer thread
    stays `queue_capacity` batches ahead.
    """

    def __init__(self, path: str, batch: int, delimiter: str = ",",
                 skip_lines: int = 0, queue_capacity: int = 4,
                 drop_last: bool = False, shuffle_seed: int = 0):
        self.path = path
        self.batch = batch
        self.delimiter = delimiter
        self.skip_lines = skip_lines
        self.queue_capacity = queue_capacity
        self.drop_last = drop_last
        self.shuffle_seed = shuffle_seed
        self._lib = _get_lib()
        self._handle = self._lib.dl4j_loader_open(
            self.path.encode(), self.delimiter.encode(), self.skip_lines,
            self.batch, self.queue_capacity, int(self.drop_last),
            self.shuffle_seed,
        )
        if not self._handle:
            raise ValueError(
                f"native loader failed for {self.path!r}: "
                f"{self._lib.dl4j_last_error().decode()}"
            )
        self.rows = self._lib.dl4j_loader_rows(self._handle)
        self.cols = self._lib.dl4j_loader_cols(self._handle)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __iter__(self):
        if self._handle is None:
            raise RuntimeError(f"the loader over {self.path!r} is closed")
        buf = np.empty(self.batch * self.cols, np.float32)
        while True:
            n = self._lib.dl4j_loader_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                buf.size,
            )
            if n == 0:  # clean end-of-epoch
                return
            if n < 0:  # error (e.g. out_capacity too small) — never EOF
                raise RuntimeError(
                    f"native loader error for {self.path!r}: "
                    f"{self._lib.dl4j_last_error().decode()}"
                )
            CALLS["loader_batch"] += 1
            yield buf[: n * self.cols].reshape(n, self.cols).copy()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dl4j_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
