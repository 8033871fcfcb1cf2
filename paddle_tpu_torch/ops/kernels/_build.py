"""Build the port's CUDA sources into shared libraries and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``paddle_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the
source, every ``csrc`` header it includes (``#include "x.cuh"``, followed
through the headers) and the compiler flags, so an edited source or header
builds anew and an unchanged one is loaded from the earlier build. Nothing is built on import:
the first CUDA call of a kernel builds it. A build that fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels are built from source at first use"
        )
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str):
    """The bytes of ``csrc/<name>.cu``, then of each ``csrc`` header it
    includes, in the order first included, each once."""
    seen, order = set(), []
    todo = [name + ".cu"]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.add(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            data = f.read()
        order.append(data)
        todo.extend(m.decode() for m in _LOCAL_INCLUDE.findall(data))
    return order


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives. A source that includes no
    ``csrc`` header hashes its own bytes and the flags only."""
    digest = hashlib.sha256(b"".join(_sources(name)) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source not built yet, one nvcc each, all at once.

    Returns {name: compiler log}; a log is empty for a library already built.
    Raises RuntimeError naming the source and its log if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiler = None
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            logs[name] = ""
            continue
        compiler = compiler or nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(f"csrc/{n}.cu" for n in failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
