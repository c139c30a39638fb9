"""The native mesh extractor (``csrc/mesh_extract.cpp``, a copy of the JAX
package's native/mesh_extract.cpp): multithreaded marching tetrahedra over
a dense scalar field, with exact shared-vertex welding, bound with ctypes
(the JAX package's utils/native.py).

g++ builds it into ``_build/`` at first use (``utils/cuda_build.py``, the
JAX package's flags). A failed build or load raises with the compiler's
output: there is no silent fallback to the numpy extractor, which stays in
``utils/marching_cubes.py`` as the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from avatarcraft_tpu_torch.utils.cuda_build import load_library

LIB = "mesh_extract"


@functools.cache
def get_mesh_extract_lib() -> ctypes.CDLL:
    """The extractor's library, built first if needed, its ctypes signature
    declared; raises RuntimeError (with g++'s output) or OSError."""
    lib = load_library(LIB)
    lib.mesh_extract_run.restype = ctypes.c_int
    lib.mesh_extract_run.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mesh_extract_free.restype = None
    lib.mesh_extract_free.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def native_marching_cubes(field: np.ndarray, iso: float = 0.0, n_threads: int = 0):
    """(vertices [V,3] f32 in index coordinates, triangles [F,3] int32) of
    the iso-surface of ``field`` [X, Y, Z], by the native extractor on
    ``n_threads`` threads (0: one per core). The same geometry as the numpy
    ``marching_cubes(..., prefer_native=False)``, its vertices in another
    order."""
    f = np.ascontiguousarray(field, np.float32)
    if f.ndim != 3:
        raise ValueError(f"the extractor takes a 3-D field, got shape {f.shape}")
    lib = get_mesh_extract_lib()
    X, Y, Z = f.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.mesh_extract_run(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        X, Y, Z, ctypes.c_float(iso), n_threads,
        ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(tris_p), ctypes.byref(nt),
    )
    try:
        if rc != 0:
            raise MemoryError(f"mesh_extract_run returned {rc}: the output buffers could not be allocated")
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tris_p, shape=(nt.value, 3)).copy()
    finally:
        lib.mesh_extract_free(verts_p, tris_p)
    return verts, tris
