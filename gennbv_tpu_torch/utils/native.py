"""ctypes bindings of the native C++ mesh voxelizer (``native/voxelizer.cpp``)
and voxel mesher (``native/mesher.cpp``): the port's own copy of
``gennbv_tpu/utils/native.py``.

At first use each source is compiled with ``g++`` into a shared library
under ``gennbv_tpu_torch/_build/`` (listed in ``.gitignore``), whose file
name carries a hash of the source and the flags; ``native/`` is only read.
The voxelizer serves dataset conversion
(``gennbv_tpu_torch/tools/convert_dataset.py``), the mesher
``train/play.py --obj``; neither is on the training or eval path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gennbv_tpu_torch.ops._cuda import BUILD_DIR

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_MESHER_SRC = _NATIVE_DIR / "mesher.cpp"
_VOXELIZER_SRC = _NATIVE_DIR / "voxelizer.cpp"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# The JAX package builds the voxelizer with -march=native, under which g++
# contracts its double a * b + c into fused multiply-adds wherever the host
# has them, and a contraction can move a boundary voxel.  -mfma contracts
# alike on any x86-64 host with FMA (aarch64 has it in its base ISA), so the
# port voxelizes as the JAX tool does without a build tied to one CPU.
_VOXELIZER_FLAGS = _GXX_FLAGS + (
    ("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ())
# the voxelizer's C interface this binding was written against
VOXELIZER_ABI = 1


def build(src: Path, flags: tuple = _GXX_FLAGS) -> Path:
    """Compile src with g++ and flags into BUILD_DIR if its build is
    missing; return the library's path."""
    digest = hashlib.sha256(src.read_bytes()
                            + repr(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent or
        # interrupted build never leaves a partial library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, "-o", tmp, str(src)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed on {src}:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


@functools.cache
def load_mesher() -> ctypes.CDLL:
    """Compile native/mesher.cpp if its build is missing, then dlopen it."""
    lib = ctypes.CDLL(str(build(_MESHER_SRC)))
    lib.mesh_voxels_to_obj.restype = ctypes.c_int64
    lib.mesh_voxels_to_obj.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,
    ]
    return lib


@functools.cache
def load_voxelizer() -> ctypes.CDLL:
    """Compile native/voxelizer.cpp if its build is missing, dlopen it and
    check its ABI version."""
    lib = ctypes.CDLL(str(build(_VOXELIZER_SRC, _VOXELIZER_FLAGS)))
    lib.voxelizer_abi_version.restype = ctypes.c_int
    abi = lib.voxelizer_abi_version()
    if abi != VOXELIZER_ABI:
        raise RuntimeError(f"{_VOXELIZER_SRC} has ABI version {abi}; this "
                           f"binding expects {VOXELIZER_ABI}")
    lib.voxelize_obj.restype = ctypes.c_int
    lib.voxelize_obj.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    return lib


def mesh_voxels_to_obj(grid: np.ndarray, origin, vsize, path: str) -> int:
    """Write a [G, G, G] {0,1} voxel grid as a quad-mesh OBJ whose voxel
    (0, 0, 0) has its lower corner at origin [3] and size vsize [3].
    Returns the quad count."""
    g = np.ascontiguousarray(np.asarray(grid) > 0.5).astype(np.uint8)
    if g.ndim != 3 or not g.shape[0] == g.shape[1] == g.shape[2]:
        raise ValueError(f"expected a cubic [G, G, G] grid, got {g.shape}")
    n = load_mesher().mesh_voxels_to_obj(
        g.reshape(-1), np.int32(g.shape[0]),
        np.asarray(origin, np.float64).copy(),
        np.asarray(vsize, np.float64).copy(),
        path.encode(),
    )
    if n < 0:
        raise RuntimeError(f"mesh_voxels_to_obj failed writing {path}")
    return int(n)


def voxelize_obj(
    path: str,
    res: int,
    scale: float = 1.0,
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    box: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    solid: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Voxelize an OBJ mesh into a res^3 grid over `box` (lo, hi), or over
    the mesh's padded bounds when box is None.  Returns (occ [res, res,
    res] uint8, box_lo [3] float32, box_hi [3] float32)."""
    if box is None:
        box_lo = np.zeros(3, np.float64)
        box_hi = np.zeros(3, np.float64)
    else:
        box_lo = np.asarray(box[0], np.float64).copy()
        box_hi = np.asarray(box[1], np.float64).copy()
    occ = np.zeros(res ** 3, np.uint8)
    rc = load_voxelizer().voxelize_obj(
        path.encode(), res, float(scale), np.asarray(offset, np.float64),
        box_lo, box_hi, 1 if solid else 0, occ,
    )
    if rc != 0:
        raise RuntimeError(f"voxelize_obj failed with code {rc} for {path}")
    return (occ.reshape(res, res, res), box_lo.astype(np.float32),
            box_hi.astype(np.float32))
