"""Build host C++ with g++ at first use and load it over the C ABI (ctypes).

The port's copy of ``paddle_tpu/utils/cpp_extension.py`` (reference:
python/paddle/utils/cpp_extension/): ``load`` compiles the sources to
``lib<name>.<hash>.so``, where the hash covers the sources, the headers
named in ``depends``, the flags and, under ``-march=native``, the host's
ISA, so an edited source or another CPU builds anew. A build goes to a
per-process temporary file renamed into place, so processes racing on a
cold cache never load a half-written library.

The default build directory is ``paddle_tpu_torch/_build/``, beside the
CUDA kernels' builds. The port's libraries are built from the port's own
sources and never loaded from the JAX package's build directory; each is
opened with ctypes' default ``RTLD_LOCAL``, so a process that loads the
JAX package's copy of the same C++ keeps the two apart.

CUDA kernels are built by ``ops/kernels/_build.py`` with nvcc, not here.
Not ported yet (ROADMAP, open items, queue 1 item 14): ``load(ops=...)``
(the custom elementwise op ABI of ``utils/custom_op.py``) and the
setuptools entry points ``CppExtension``, ``CUDAExtension`` and ``setup``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Sequence

__all__ = ["load", "get_build_directory"]

_DEFAULT_CFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def get_build_directory() -> str:
    """``paddle_tpu_torch/_build/``, made if missing."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return _BUILD_DIR


def _host_isa_tag() -> str:
    """A fingerprint of this host's ISA features: ``-march=native`` bakes
    them into the library, so a cached build moved to an older CPU would
    die of SIGILL unless the cache key changes with the CPU."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform

    return platform.machine()


def _source_digest(sources: Sequence[str], cflags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cflags).encode())
    if any("-march=native" in c for c in cflags):
        h.update(_host_isa_tag().encode())
    return h.hexdigest()[:16]


def load(
    name: str,
    sources: Sequence[str],
    extra_cflags: Optional[List[str]] = None,
    extra_ldflags: Optional[List[str]] = None,
    build_directory: Optional[str] = None,
    verbose: bool = False,
    ops: Optional[Sequence[str]] = None,
    depends: Optional[Sequence[str]] = None,
) -> ctypes.CDLL:
    """Compile C++ ``sources`` to ``lib<name>.<hash>.so`` (cached by content)
    and load it. ``depends`` (headers) enter the hash but not the compile
    line. Returns the ``ctypes.CDLL``; a failed build raises."""
    if ops is not None:
        raise NotImplementedError(
            "cpp_extension.load(ops=...) needs utils/custom_op.py, which is not ported "
            "yet (ROADMAP, open items, queue 1 item 14); load the library and bind its "
            "C functions with ctypes"
        )
    build_dir = build_directory or get_build_directory()
    os.makedirs(build_dir, exist_ok=True)
    cflags = _DEFAULT_CFLAGS + (extra_cflags or [])
    ldflags = ["-lpthread"] + (extra_ldflags or [])
    digest = _source_digest(list(sources) + list(depends or []), cflags + ldflags)
    so_path = os.path.join(build_dir, f"lib{name}.{digest}.so")
    if not os.path.exists(so_path):
        tmp_path = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", *cflags, *sources, "-o", tmp_path, *ldflags]
        if verbose:
            print("cpp_extension:", " ".join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=not verbose, text=True)
            os.rename(tmp_path, so_path)
        except (subprocess.CalledProcessError, OSError) as e:
            stderr = getattr(e, "stderr", None)
            raise RuntimeError(f"building extension '{name}' failed:\n{stderr or e}") from e
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return ctypes.CDLL(so_path)
