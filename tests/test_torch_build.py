"""Where the port's kernel builds live: ``_build.library_path``.

A build is named by a hash of its source, every ``csrc`` header the source
includes (followed through headers) and the nvcc flags, so editing a shared
header rebuilds every library that includes it, and nothing else. Runs on
the CPU: it hashes files in a temporary copy of ``csrc`` and builds nothing.
"""
import hashlib
import os
import shutil

import pytest

from paddle_tpu_torch.ops.kernels import _build

SIMT_SOURCES = ["flash_attention_fwd", "flash_attention_bwd", "fused_update"]
SM90_SOURCES = ["flash_attention_fwd_sm90", "flash_attention_bwd_dkv_sm90",
                "flash_attention_bwd_dq_sm90"]
# the 3xTF32 sources, which include tf32x3.cuh (and through it sm90_common.cuh)
TF32_SOURCES = ["flash_attention_fwd_tf32", "flash_attention_bwd_tf32"]
# every source that includes sm90_common.cuh (TMA maps, mbarriers)
TMA_SOURCES = SM90_SOURCES + TF32_SOURCES


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    monkeypatch.setattr(_build, "CSRC", str(d))
    return d


def _touch(path):
    path.write_bytes(path.read_bytes() + b"\n// edited\n")


@pytest.mark.parametrize("name", SIMT_SOURCES)
def test_a_source_without_local_headers_hashes_its_own_bytes_and_the_flags(csrc, name):
    data = (csrc / (name + ".cu")).read_bytes()
    digest = hashlib.sha256(data + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    path = _build.library_path(name)
    assert path == os.path.join(_build.BUILD_DIR, f"{name}-{digest[:16]}.so")
    _touch(csrc / "sm90_common.cuh")  # a header it does not include
    assert _build.library_path(name) == path
    _touch(csrc / (name + ".cu"))
    assert _build.library_path(name) != path


@pytest.mark.parametrize("name", TMA_SOURCES)
def test_editing_an_included_header_moves_the_library(csrc, name):
    before = {n: _build.library_path(n) for n in TMA_SOURCES + SIMT_SOURCES}
    _touch(csrc / "sm90_common.cuh")
    assert _build.library_path(name) != before[name]
    for other in SIMT_SOURCES:
        assert _build.library_path(other) == before[other]


def test_headers_are_followed_through_headers_each_once(csrc):
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n#include <cuda_runtime.h>\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    (csrc / "c.cuh").write_text("// included by nothing\n")
    assert _build._sources("k") == [(csrc / f).read_bytes() for f in ("k.cu", "a.cuh", "b.cuh")]
    path = _build.library_path("k")
    _touch(csrc / "c.cuh")
    assert _build.library_path("k") == path
    _touch(csrc / "b.cuh")
    assert _build.library_path("k") != path


def test_the_flags_are_part_of_every_path(csrc, monkeypatch):
    before = {n: _build.library_path(n) for n in TMA_SOURCES + SIMT_SOURCES}
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    for name, path in before.items():
        assert _build.library_path(name) != path


def test_the_sm90_sources_include_the_common_header():
    header = os.path.join(_build.CSRC, "sm90_common.cuh")
    with open(header, "rb") as f:
        data = f.read()
    for name in TMA_SOURCES:
        assert data in _build._sources(name)
    for name in SIMT_SOURCES:
        assert len(_build._sources(name)) == 1


def test_editing_the_tf32x3_header_moves_exactly_the_tf32_libraries(csrc):
    header = os.path.join(_build.CSRC, "tf32x3.cuh")
    with open(header, "rb") as f:
        data = f.read()
    for name in TF32_SOURCES:
        assert data in _build._sources(name)
    before = {n: _build.library_path(n) for n in TMA_SOURCES + SIMT_SOURCES}
    _touch(csrc / "tf32x3.cuh")
    for name, path in before.items():
        assert (_build.library_path(name) != path) == (name in TF32_SOURCES), name
