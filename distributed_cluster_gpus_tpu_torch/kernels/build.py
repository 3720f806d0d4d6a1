"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` at the repo
root, at first use, from the sources in the checkout only.  The library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is never served a stale build.  Libraries load with ``ctypes``; nothing here runs at
import time, and nothing falls back: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
#: (source, entry point) pairs whose ctypes signature is set
_bound = set()
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    # a source that includes another (csrc/event_scan64.cu) hashes it too
    with open(src) as f:
        included = re.findall(r'^#include "([^"]+\.cu)"', f.read(), re.M)
    for path in ([src] + [os.path.join(CSRC_DIR, c) for c in included]
                 + [os.path.join(CSRC_DIR, h) for h in headers]):
        with open(path, "rb") as f:
            digest.update(f.read())
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


def bind(name: str, fn: str, argtypes) -> "ctypes._CFuncPtr":
    """The entry point ``fn`` of ``csrc/<name>.cu`` (built on first use),
    its argument types set once; it returns an int status."""
    lib = load(name)
    f = getattr(lib, fn)
    if (name, fn) not in _bound:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _bound.add((name, fn))
    return f


def on_card(op: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one (the wrapper then runs
    its plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {t.device}")
    return True


def launch_failed(op: str, rc: int) -> RuntimeError:
    """The error of a failed launch: -1 is a shape the kernel does not take,
    -2 and -3 a TMA descriptor libcuda could not give, anything else a
    cudaError_t."""
    why = {-1: "a shape the kernel does not take",
           -2: "libcuda's tensor-map encoder was not found",
           -3: "libcuda refused a tensor map"}.get(rc, f"cudaError {rc}")
    return RuntimeError(f"{op} kernel launch failed: {why}")


def check(op: str, name: str, t, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape``, where given): the launch checks the wrappers share."""
    if not hasattr(t, "dtype") or t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be a {dtype} tensor")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


#: zeroed uint32 arrival counts a kernel whose tree spans several blocks
#: keeps per column group (the backward kernels over more than one row
#: tile, the heads' backward); the last block to arrive resets its count,
#: so launches queue no memset.  One buffer per device, allocated once (a
#: captured CUDA graph keeps its address).  Every such launch on a device
#: indexes it by its column group, so they must run in order on one
#: stream, as the port's update does: two in flight at once (two streams,
#: two agents' updates overlapping) would mix their arrivals.  Each launch
#: checks that its column groups fit (``rd::kMaxCounters``,
#: ``csrc/reduce.cuh``).
N_COUNTERS = 8192
_counters: Dict[object, object] = {}


def counters(device):
    """The device's zeroed counter buffer (int32 [N_COUNTERS])."""
    import torch

    c = _counters.get(device)
    if c is None:
        c = _counters[device] = torch.zeros(N_COUNTERS, dtype=torch.int32,
                                            device=device)
    return c


def stream_of(device) -> int:
    """The current CUDA stream of ``device`` as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
