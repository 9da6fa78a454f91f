"""ctypes bindings for the native runtime (C++ SAH BVH builder, OBJ parser).

The native library is optional: every caller has a pure-numpy fallback, so
a missing/unbuilt .so never breaks the framework.  Build with
``make -C sycl_ray_tracing/native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libsrt_native.so")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """Load (once) and return the native library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bvh_flatten.restype = ctypes.c_int32
        lib.bvh_flatten.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.obj_parse.restype = ctypes.c_int32
        lib.obj_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.obj_fetch.restype = ctypes.c_int32
        lib.obj_fetch.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
        ]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def sah_build(triangles: np.ndarray, leaf_size: int = 4):
    """Binned-SAH build.  Returns (nodes_box [M,8] f32, nodes_meta [M,4]
    i32, slot_order [num_leaves*leaf_size] i32) or None if the native lib
    is unavailable."""
    lib = load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(triangles, np.float32).reshape(-1, 9)
    n = tris.shape[0]
    num_nodes = ctypes.c_int32(0)
    num_leaves = ctypes.c_int32(0)
    rc = lib.bvh_build(
        _fptr(tris), n, leaf_size,
        ctypes.byref(num_nodes), ctypes.byref(num_leaves),
    )
    if rc != 0:
        return None
    m, k = num_nodes.value, num_leaves.value
    nodes_box = np.zeros((m, 8), np.float32)
    nodes_meta = np.zeros((m, 4), np.int32)
    slot_order = np.zeros((k * leaf_size,), np.int32)
    rc = lib.bvh_flatten(_fptr(nodes_box), _iptr(nodes_meta), _iptr(slot_order))
    if rc != 0:
        return None
    return nodes_box, nodes_meta, slot_order


def parse_obj_geometry(path: str):
    """Fast OBJ geometry parse.  Returns (triangles [N,3,3] f32,
    material_slot [N] i32, slot_names list[str]) or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    n_tris = ctypes.c_int32(0)
    n_names = ctypes.c_int32(0)
    names_bytes = ctypes.c_int32(0)
    rc = lib.obj_parse(
        path.encode(), ctypes.byref(n_tris), ctypes.byref(n_names),
        ctypes.byref(names_bytes),
    )
    if rc != 0:
        return None
    n = n_tris.value
    tris = np.zeros((n, 9), np.float32)
    mats = np.zeros((n,), np.int32)
    names_buf = ctypes.create_string_buffer(max(1, names_bytes.value))
    rc = lib.obj_fetch(_fptr(tris), _iptr(mats), names_buf)
    if rc != 0:
        return None
    raw = names_buf.raw[: names_bytes.value]
    names = [s.decode("utf-8", "replace") for s in raw.split(b"\0") if s]
    return tris.reshape(n, 3, 3), mats, names
