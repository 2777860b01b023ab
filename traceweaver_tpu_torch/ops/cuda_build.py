"""Build a CUDA source of ``ops/csrc`` into a shared library with nvcc.

The JAX package has no counterpart: its Pallas kernels are compiled by
JAX itself. Each source builds alone, for ``sm_90a``, into
``traceweaver_tpu_torch/_build/`` (ignored by git) under a name that
holds a digest of the source and the flags, so a changed source builds
anew and an unchanged one is built once. The libraries have a plain C
interface and are loaded with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: sources this process compiled with nvcc, in order (a library found built
#: is not listed): the port's counterpart of the JAX package's compile
#: counters, read by a serve replica's ``/api/v1/stats``
BUILT: List[str] = []
_built_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on the card's "
                           "machine (CUDA toolkit under /usr/local/cuda)")
    return path


def build(source: str, stem: str, verbose: bool = False) -> str:
    """Compile ``csrc/<source>`` (once per source content) into
    ``_build/lib<stem>_<digest>.so`` and return its path. ``verbose``
    adds ``-Xptxas -v`` and returns nvcc's report instead of the path."""
    path = os.path.join(CSRC_DIR, source)
    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(lib) and not verbose:
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    with _built_lock:
        BUILT.append(source)
    return proc.stderr if verbose else lib
