"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` at the repo
root, at first use, from the sources in the checkout only.  The library
name carries a hash of the source and flags, so an edited source is never
served a stale build.  Libraries load with ``ctypes``; nothing here runs at
import time, and nothing falls back: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report (``-Xptxas -v``) of each source built in this process
ptxas_reports: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def _target(name: str) -> tuple:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source not yet built, all ``nvcc`` processes
    started together; returns {name: library path}.  Raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        ptxas_reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
