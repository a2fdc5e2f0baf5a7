"""ctypes binding of the native C++ voxel mesher (``native/mesher.cpp``),
the port's own copy of the mesher half of ``gennbv_tpu/utils/native.py``.

At first use the source is compiled with ``g++`` into a shared library
under ``gennbv_tpu_torch/_build/`` (listed in ``.gitignore``), whose file
name carries a hash of the source and the flags; ``native/`` is only read.
Used by ``train/play.py --obj``, never on the training or eval path.  The
voxelizer half comes with dataset conversion (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from gennbv_tpu_torch.ops._cuda import BUILD_DIR

_MESHER_SRC = Path(__file__).resolve().parents[2] / "native" / "mesher.cpp"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")


@functools.cache
def load_mesher() -> ctypes.CDLL:
    """Compile native/mesher.cpp if its build is missing, then dlopen it."""
    digest = hashlib.sha256(_MESHER_SRC.read_bytes()
                            + repr(_GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libmesher_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent or
        # interrupted build never leaves a partial library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, str(_MESHER_SRC)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed on {_MESHER_SRC}:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(so))
    lib.mesh_voxels_to_obj.restype = ctypes.c_int64
    lib.mesh_voxels_to_obj.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,
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
