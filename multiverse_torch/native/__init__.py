"""Native (C++) host-side batch packing.

The port's own copy of the JAX package's ``native`` module: the per-batch
scene-table remap (``remap_first_seen``) and row gather
(``gather_rows``) that run on the thread feeding the device. The
extension is built on demand with g++ into ``multiverse_torch/_build/
native/`` (never shared with the JAX package's build) and bound via
ctypes; every entry point has a pure numpy fallback, so the package
works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "packing.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build", "native")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_BUILD_LOCK = threading.Lock()


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _BUILD_LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            _LIB = _load(_compile())
        except Exception:
            _LIB = None
        return _LIB


def _compile() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_BUILD_DIR, "libpacking.so")
    if (not os.path.exists(lib_path)
            or os.path.getmtime(lib_path) < os.path.getmtime(_SRC)):
        # compile to a private name, then rename: two processes
        # cold-starting together must not interleave writes into the
        # cached path; os.replace is atomic
        tmp = "%s.%d.tmp" % (lib_path, os.getpid())
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    return lib_path


def _load(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    lib.remap_first_seen.restype = ctypes.c_int64
    lib.remap_first_seen.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.gather_rows_u8.restype = None
    lib.gather_rows_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def have_native() -> bool:
    return _build_and_load() is not None


def _as_i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def remap_first_seen(
    ids: np.ndarray, capacity: int, max_id: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Remap ids to first-seen-order [0, n_unique) ids.

    Returns (remapped ids same shape, table [n_unique] of old ids,
    n_unique). Raises ValueError when unique ids exceed capacity or an
    id lies outside [0, max_id].
    """
    flat = np.ascontiguousarray(ids, np.int32).reshape(-1)
    out = np.empty_like(flat)
    if max_id is None:
        max_id = int(flat.max()) if flat.size else 0
    if flat.size:
        # the C kernel indexes a (max_id+1)-entry scratch with raw ids:
        # out-of-range values would read/write out of bounds
        mn, mx = int(flat.min()), int(flat.max())
        if mn < 0 or mx > max_id:
            raise ValueError(
                f"ids out of range [0, {max_id}]: found [{mn}, {mx}] "
                f"(corrupt obs_scene index?)")
    lib = _build_and_load()
    if lib is not None:
        seen = np.full(max_id + 1, -1, np.int32)
        table = np.empty(max(capacity, 1), np.int32)
        n = lib.remap_first_seen(
            _as_i32_ptr(flat), flat.size, _as_i32_ptr(out),
            _as_i32_ptr(seen), _as_i32_ptr(table), capacity)
        if n < 0:
            raise ValueError("scene table overflow: capacity %d" % capacity)
        return out.reshape(ids.shape), table[:n].copy(), int(n)

    # numpy fallback (same first-seen semantics)
    old2new: dict = {}
    table_list = []
    for i, old in enumerate(flat.tolist()):
        new = old2new.get(old)
        if new is None:
            if len(old2new) >= capacity:
                raise ValueError("scene table overflow: capacity %d"
                                 % capacity)
            new = len(old2new)
            old2new[old] = new
            table_list.append(old)
        out[i] = new
    return (out.reshape(ids.shape),
            np.asarray(table_list, np.int32), len(table_list))


def gather_rows(rows: np.ndarray, table: np.ndarray,
                out_rows: int) -> np.ndarray:
    """out[i] = rows[table[i]], zero-padded to out_rows rows."""
    table = np.ascontiguousarray(table, np.int32)
    if len(table) > out_rows:
        raise ValueError(
            f"table has {len(table)} rows > out_rows {out_rows}")
    if table.size and (int(table.min()) < 0
                       or int(table.max()) >= len(rows)):
        raise ValueError(
            f"table indexes outside rows[0, {len(rows)})")
    out = np.zeros((out_rows,) + rows.shape[1:], rows.dtype)
    lib = _build_and_load()
    if lib is not None and rows.dtype == np.uint8:
        rows_c = np.ascontiguousarray(rows)
        row_bytes = int(np.prod(rows.shape[1:]))
        lib.gather_rows_u8(
            rows_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _as_i32_ptr(table), len(table), row_bytes,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    out[:len(table)] = rows[table]
    return out
