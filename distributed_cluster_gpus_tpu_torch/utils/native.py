"""Build and load the port's native CSV writer (``csrc/csv_writer.cpp``).

Counterpart of ``distributed_cluster_gpus_tpu/utils/native.py``, with the
port's own copy of the source.  The writer is host code: ``g++ -O2 -shared
-fPIC`` builds it at first use into ``build/torch_kernels/`` at the repo
root (beside the CUDA kernels, ``kernels/build.py``), under a name that
carries a digest of the source and the flags, so an edited source is never
served a stale build.  It loads with ``ctypes``.  Nothing falls back: a
missing compiler or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..kernels.build import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "csv_writer.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _target() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libcsv_writer_{digest.hexdigest()[:12]}.so")


def build_csv_writer() -> str:
    """Compile the writer unless this source's build exists; returns the
    library's path.  Raises with the compiler's output on failure."""
    lib = _target()
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the native CSV writer needs a C++ compiler: no "
                           "g++ on PATH (or $CXX)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native CSV writer build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def csv_writer_lib() -> ctypes.CDLL:
    """The writer's ctypes handle, built on first use; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_csv_writer(), use_errno=True)
            lib.write_cluster_rows.restype = ctypes.c_int64
            lib.write_cluster_rows.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64]
            lib.write_job_rows.restype = ctypes.c_int64
            lib.write_job_rows.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]
            _lib = lib
        return _lib
