"""Counterpart of ``deeplearning4j_tpu/native``: ctypes bindings for the
repo's native host library (``native/dataloader.cpp``, ``native/text.cpp``).

The shared library is built on first use by ``g++`` into the package's
``_build/`` directory; a failed build raises with the compiler's output
(see ``native.lib``).
"""

from deeplearning4j_tpu_torch.native.lib import (
    NativeCSVLoader,
    BufferPool,
    load_csv,
    native_available,
)

__all__ = ["NativeCSVLoader", "BufferPool", "load_csv", "native_available"]
