"""ctypes bindings for the native (C++) runtime components.

Builds ``build/libpts_native.so`` from src/pts_native.cpp with g++ on
first use (no pybind11 needed; the build directory is not tracked) and
exposes:

* ``load_obj_native(path)``   — fast OBJ parse -> utils.obj_loader.ObjMesh
* ``build_bvh_native(...)``   — binned-SAH flat skip-link BVH

Both have pure-Python fallbacks (utils/obj_loader.py, ops/bvh.py); set
``PTS_NATIVE=0`` to force them. ``available()`` reports whether the library
loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "pts_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libpts_native.so")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_tried = False


def _warn(msg: str) -> None:
    print(f"pathtracing_spectrum_tpu.native: {msg}; using the Python "
          "fallbacks", file=sys.stderr)


def _compile() -> bool:
    """Build the library for the generic x86-64/aarch64 target (no
    ``-march=native``), so a build left in the checkout runs on the next
    host too. Builds to a private name and renames, so concurrent first
    uses (test workers) never load a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        _warn(f"could not build {_LIB_PATH} ({type(e).__name__}: {e})")
        return False
    if res.returncode != 0 or not os.path.exists(tmp):
        err = res.stderr.decode(errors="replace").strip().splitlines()
        _warn(f"building {_LIB_PATH} failed"
              + (f" ({err[-1]})" if err else ""))
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load() -> "ctypes.CDLL | None":
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PTS_NATIVE", "1") == "0":
            return None
        src_mtime = os.path.getmtime(_SRC) if os.path.exists(_SRC) else 0
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < src_mtime):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _warn(f"could not load {_LIB_PATH} ({e})")
            return None

        c_i32 = ctypes.c_int32
        c_i64 = ctypes.c_int64
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_u32 = ctypes.POINTER(ctypes.c_uint32)
        p_i64 = ctypes.POINTER(ctypes.c_int64)

        lib.pts_obj_load.restype = ctypes.c_void_p
        lib.pts_obj_load.argtypes = [ctypes.c_char_p]
        lib.pts_obj_counts.argtypes = [ctypes.c_void_p, p_i32, p_i32, p_i32,
                                       p_i32]
        lib.pts_obj_copy_attribs.argtypes = [ctypes.c_void_p, p_f32, p_f32,
                                             p_f32]
        lib.pts_obj_shape_faces.restype = c_i32
        lib.pts_obj_shape_faces.argtypes = [ctypes.c_void_p, c_i32]
        lib.pts_obj_shape_name.restype = c_i32
        lib.pts_obj_shape_name.argtypes = [ctypes.c_void_p, c_i32,
                                           ctypes.c_char_p, c_i32]
        lib.pts_obj_shape_indices.argtypes = [ctypes.c_void_p, c_i32, p_i32,
                                              p_i32, p_i32, p_u32]
        lib.pts_obj_free.argtypes = [ctypes.c_void_p]

        lib.pts_bvh_build.restype = ctypes.c_void_p
        lib.pts_bvh_build.argtypes = [p_f32, p_f32, c_i64, c_i32]
        lib.pts_bvh_node_count.restype = c_i32
        lib.pts_bvh_node_count.argtypes = [ctypes.c_void_p]
        lib.pts_bvh_export.argtypes = [ctypes.c_void_p, p_f32, p_f32, p_i32,
                                       p_i32, p_i32, p_i64]
        lib.pts_bvh_free.argtypes = [ctypes.c_void_p]
        lib.pts_export_spectrum.restype = c_i32
        lib.pts_export_spectrum.argtypes = [ctypes.c_char_p, p_f32, c_i32,
                                            c_i32, c_i32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str):
    """Parse an OBJ with the native parser; None if unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.pts_obj_load(path.encode())
    if not handle:
        return None
    try:
        from ..utils.obj_loader import ObjMesh, ObjShape

        nv = ctypes.c_int32()
        nt = ctypes.c_int32()
        nn = ctypes.c_int32()
        ns = ctypes.c_int32()
        lib.pts_obj_counts(handle, ctypes.byref(nv), ctypes.byref(nt),
                           ctypes.byref(nn), ctypes.byref(ns))
        vertices = np.zeros((nv.value, 3), np.float32)
        texcoords = np.zeros((nt.value, 2), np.float32)
        normals = np.zeros((nn.value, 3), np.float32)
        lib.pts_obj_copy_attribs(handle, _fptr(vertices), _fptr(texcoords),
                                 _fptr(normals))
        shapes = []
        name_buf = ctypes.create_string_buffer(4096)
        for s in range(ns.value):
            f = lib.pts_obj_shape_faces(handle, s)
            lib.pts_obj_shape_name(handle, s, name_buf, 4096)
            v_idx = np.zeros((f, 3), np.int32)
            vt_idx = np.zeros((f, 3), np.int32)
            vn_idx = np.zeros((f, 3), np.int32)
            smoothing = np.zeros((f,), np.uint32)
            lib.pts_obj_shape_indices(
                handle, s, _iptr(v_idx), _iptr(vt_idx), _iptr(vn_idx),
                smoothing.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            shapes.append(ObjShape(name=name_buf.value.decode(errors="replace"),
                                   v_idx=v_idx, vt_idx=vt_idx, vn_idx=vn_idx,
                                   smoothing=smoothing))
        return ObjMesh(vertices=vertices, texcoords=texcoords,
                       normals=normals, shapes=shapes)
    finally:
        lib.pts_obj_free(handle)


def build_bvh_native(tri_min: np.ndarray, tri_max: np.ndarray,
                     leaf_size: int = 4):
    """Binned-SAH flat BVH; returns ops.bvh.FlatBVH or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    t = tri_min.shape[0]
    handle = lib.pts_bvh_build(_fptr(tri_min), _fptr(tri_max),
                               ctypes.c_int64(t), ctypes.c_int32(leaf_size))
    if not handle:
        return None
    try:
        from ..ops.bvh import FlatBVH

        nn = lib.pts_bvh_node_count(handle)
        node_min = np.zeros((nn, 3), np.float32)
        node_max = np.zeros((nn, 3), np.float32)
        skip = np.zeros((nn,), np.int32)
        first = np.zeros((nn,), np.int32)
        count = np.zeros((nn,), np.int32)
        order = np.zeros((t,), np.int64)
        lib.pts_bvh_export(handle, _fptr(node_min), _fptr(node_max),
                           _iptr(skip), _iptr(first), _iptr(count),
                           order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return FlatBVH(node_min=node_min, node_max=node_max, node_skip=skip,
                       node_first=first, node_count=count, tri_order=order)
    finally:
        lib.pts_bvh_free(handle)


def export_spectrum_native(path: str, image) -> bool:
    """Write a [H, W, nw] f32 spectral image as the reference's ASCII
    export (byte-identical to the Python writer); False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(np.asarray(image, np.float32))
    h, w, nw = img.shape
    return lib.pts_export_spectrum(path.encode(), _fptr(img), h, w, nw) == 0
