"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds a kernel and a plain C launcher.  At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``gennbv_tpu_torch/_build/`` (listed in ``.gitignore``) and
loaded with ``ctypes``.  The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt.  A missing ``nvcc``
is an error: there is no prebuilt fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills (kept in BUILD_LOG)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# H100 shared memory (CUDA's limits for compute capability 9.0): an SM has
# 228 KB, a CTA may take up to 227 KB of it, and each resident CTA costs
# 1 KB more
SHARED_PER_SM = 233_472
SHARED_PER_CTA = 232_448
SHARED_RESERVED_PER_CTA = 1_024
# the shared memory a CTA may take so that two of them share an SM
SHARED_TWO_PER_SM = SHARED_PER_SM // 2 - SHARED_RESERVED_PER_CTA
# the largest portable thread-block cluster
MAX_CLUSTER = 8
# what nvcc printed building csrc/<name>.cu in this process, by name
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME or "
        "/usr/local/cuda): the port's CUDA kernels are built from "
        "gennbv_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu lives, keyed by source + flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its build is missing, then dlopen it."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent or
        # interrupted build never leaves a partial library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                   str(CSRC / f"{name}.cu")],
                                  check=True, capture_output=True, text=True)
            BUILD_LOG[name] = done.stdout + done.stderr
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(so))


def launch(index: int, fn, *args) -> int:
    """Calls the C launcher ``fn(*args, stream)`` with PyTorch's current
    stream on CUDA device `index` (``tensor.get_device()``) and returns
    its error code.  A kernel launches on the calling thread's current
    device, so that device is made current for the call, and only where
    it is not current already: entering ``torch.cuda.device`` costs more
    host time than a small kernel's whole launch."""
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
