"""The build key of the port's CUDA kernels (deeplearning4j_tpu_torch/ops/
_kernels.py): a kernel's library name carries a digest of its ``.cu`` and
of every ``csrc`` header it pulls in with a quoted ``#include``, so that an
edited shared header (``csrc/hopper_mma.cuh``) rebuilds every kernel that
uses it instead of loading a stale library from ``_build/``.

No nvcc is needed: the digest and the include scan run on the host.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import re

import pytest

from deeplearning4j_tpu_torch.ops import _kernels

# what the sources may include with angle brackets: the CUDA toolkit's own
# headers and the C++ standard library's, nothing from another project
SYSTEM_HEADERS = {"cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h",
                  "cstddef", "cstdint", "climits", "cmath", "type_traits"}
_ANGLE = re.compile(r'^\s*#\s*include\s*<([^>]+)>', re.M)
_QUOTED = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    """A csrc with k.cu -> a.cuh -> b.cuh, and an unrelated c.cuh."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "a.cuh"\nint k;\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a;\n')
    (csrc / "b.cuh").write_text('#pragma once\nint b;\n')
    (csrc / "c.cuh").write_text('#pragma once\nint c;\n')
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    return csrc


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("c.cuh", False)])
def test_library_path_follows_source_and_included_headers(fake_csrc, edited,
                                                          rebuilds):
    before = _kernels._library_path("k")
    assert before.parent == _kernels.BUILD_DIR
    assert before.name.startswith("libk_") and before.suffix == ".so"
    path = fake_csrc / edited
    path.write_text(path.read_text() + "int edited;\n")
    assert (_kernels._library_path("k") != before) is rebuilds


def test_source_files_are_transitive_and_listed_once(fake_csrc):
    (fake_csrc / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    names = [p.name for p in _kernels.source_files("k")]
    assert names == ["k.cu", "a.cuh", "b.cuh"]


def test_library_path_is_stable(fake_csrc):
    assert _kernels._library_path("k") == _kernels._library_path("k")


def test_sources_are_the_kernels_and_the_wide_twins():
    """Every counted kernel has a source, and the extra sources are the
    three flash kernels' wide twins (head dims above 128), whose launches
    count as their kernel's."""
    extra = set(_kernels.SOURCES) - set(_kernels.LAUNCHES)
    assert set(_kernels.LAUNCHES) <= set(_kernels.SOURCES)
    assert extra == {f"{n}_wide" for n in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")}
    for name in _kernels.SOURCES:
        assert (_kernels.CSRC / f"{name}.cu").is_file()
        assert list(_kernels._SIGNATURES[name]) == [f"dl4j_{name}"] or \
            name.startswith("lstm_gates")


@pytest.mark.parametrize("name", sorted(_kernels.SOURCES))
def test_real_sources_include_only_system_or_csrc_headers(name):
    """Every kernel source builds with one plain nvcc call and no include
    path: its angle includes are CUDA or C++ system headers, and its quoted
    includes are files in csrc/ (followed through, as the digest does)."""
    files = _kernels.source_files(name)
    assert files[0] == _kernels.CSRC / f"{name}.cu"
    for path in files:
        text = path.read_text()
        assert set(_ANGLE.findall(text)) <= SYSTEM_HEADERS, path.name
        for inc in _QUOTED.findall(text):
            assert (_kernels.CSRC / inc).is_file(), (path.name, inc)
            assert "/" not in inc, (path.name, inc)


TENSOR_CORE_KERNELS = ["flash_attention_fwd", "flash_attention_bwd_dkv",
                       "flash_attention_bwd_dq", "fused_dense",
                       "flash_attention_fwd_wide",
                       "flash_attention_bwd_dkv_wide",
                       "flash_attention_bwd_dq_wide"]


def _kernel_text(name):
    """The kernel's own code: its .cu and the csrc headers it includes
    (the backward pair shares flash_tiles.cuh), hopper_mma.cuh left out."""
    return "".join(p.read_text() for p in _kernels.source_files(name)
                   if p.name != "hopper_mma.cuh")


@pytest.mark.parametrize("name", TENSOR_CORE_KERNELS)
def test_tensor_core_kernels_share_the_mma_header(name):
    """K3f, K3k, K3q and K1 run mma.sync through csrc/hopper_mma.cuh, so
    the header is part of their build key."""
    names = [p.name for p in _kernels.source_files(name)]
    assert "hopper_mma.cuh" in names
    text = _kernel_text(name)
    assert "mma_bf16_16816" in text and "mma_3xtf32" in text


def test_mma_header_has_no_single_pass_tf32_product():
    """The f32 paths go through the 3xTF32 split: mma_tf32_1688 is called
    only inside mma_3xtf32 (three products), never alone by a kernel."""
    for name in TENSOR_CORE_KERNELS:
        assert "mma_tf32_1688" not in _kernel_text(name), name
    header = (_kernels.CSRC / "hopper_mma.cuh").read_text()
    body = header[header.index("void mma_3xtf32"):]
    body = body[:body.index("\n}\n")]
    assert body.count("mma_tf32_1688(") == 3
