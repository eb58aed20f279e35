"""ctypes bindings for the native marching-cubes core (cpp/mc.cpp).

Port of ``sgnn_tpu/meshing/native.py``. The library is built with g++ at
first use into ``build/mc-<hash>/`` (``utils/native_build.py``). A failed
build raises: the numpy path is taken only when a caller asks for it
(``marching_cubes.run_marching_cubes(impl="numpy")``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from sgnn_tpu_torch.utils.native_build import BUILD_ROOT, build_library

SOURCE = Path(__file__).resolve().parent / "cpp" / "mc.cpp"
# the JAX package's flags (sgnn_tpu/meshing/cpp/Makefile), so both cores
# round alike and write the same bytes
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


class _Native:
    def __init__(self, lib):
        self.lib = lib
        self.lib.mc_extract.restype = ctypes.c_int64
        self.lib.mc_extract.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # tsdf
            ctypes.POINTER(ctypes.c_uint8),   # colors (nullable)
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # Z, Y, X
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # iso, trunc, thr
            ctypes.POINTER(ctypes.c_int32),   # edge table
            ctypes.POINTER(ctypes.c_int32),   # tri table
            ctypes.POINTER(ctypes.c_float),   # out verts
            ctypes.POINTER(ctypes.c_uint8),   # out colors
            ctypes.c_int64,                   # max tris
        ]

    def run(self, tsdf, colors, isovalue, truncation, thresh):
        """Triangle soup (tri_verts [T,3,3] f32 xyz, tri_colors [T,3,3]
        uint8), as run_marching_cubes_numpy returns it."""
        from sgnn_tpu_torch.meshing.tables import EDGE_TABLE, TRI_TABLE

        tsdf = np.ascontiguousarray(tsdf, np.float32)
        Z, Y, X = tsdf.shape
        col_ptr = None
        col_arr = None
        if colors is not None:
            col_arr = np.ascontiguousarray(colors, np.uint8)
            if col_arr.shape != (Z, Y, X, 3):
                raise ValueError(f"colors {col_arr.shape}, expected "
                                 f"{(Z, Y, X, 3)}")
            col_ptr = col_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        et = np.ascontiguousarray(EDGE_TABLE, np.int32)
        tt = np.ascontiguousarray(TRI_TABLE, np.int32)
        max_tris = max(4096, Z * Y * X // 8)
        while True:
            out_v = np.empty((max_tris, 3, 3), np.float32)
            out_c = np.empty((max_tris, 3, 3), np.uint8)
            n = self.lib.mc_extract(
                tsdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                col_ptr, Z, Y, X,
                ctypes.c_float(isovalue), ctypes.c_float(truncation),
                ctypes.c_float(thresh),
                et.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                tt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                max_tris,
            )
            if n >= 0:
                return out_v[:n].copy(), out_c[:n].copy()
            max_tris = -n  # retry with the exact size


def build() -> Path:
    """Compile cpp/mc.cpp into the keyed build directory (once per hash)
    and return the library path. Raises RuntimeError if g++ fails."""
    return build_library("mc", SOURCE, CXX_FLAGS, "native marching cubes",
                         BUILD_ROOT)


def get_native() -> _Native:
    """The loaded native core, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _Native(ctypes.CDLL(str(build())))
        return _LIB
