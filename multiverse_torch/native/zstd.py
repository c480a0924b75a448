"""Zstandard decompression with the port's own decoder.

``zstd_decode.cpp`` is a frame decoder written from RFC 8878; it reads
the zarr chunks and OCDBT nodes of the JAX package's orbax checkpoints
(``multiverse_torch/train/ocdbt.py``, ``orbax_reader.py``) with no zstd
package. It is built with g++ into ``multiverse_torch/_build/native/``
at first use, as ``packing.cpp`` is, and bound with ctypes, which
releases the interpreter lock for the call. There is no fallback: where
the build fails, :func:`decompress` raises an error that names the
command and its output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Union

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "zstd_decode.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmvt_zstd.so")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_ERR_LEN = 256
# the most a frame that carries no content size may decode to where the
# caller gives no size either (an OCDBT node, whose frame may omit it)
MAX_UNSIZED_BYTES = 1 << 30


def _build() -> str:
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: two processes cold-starting
    # together must not interleave writes into the cached path
    tmp = "%s.%d.tmp" % (_LIB_PATH, os.getpid())
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError("building the zstd decoder failed: %s: %s"
                             % (" ".join(cmd), e)) from e
    if done.returncode != 0:
        raise RuntimeError(
            "building the zstd decoder failed (exit %d): %s\n%s"
            % (done.returncode, " ".join(cmd), done.stderr))
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load() -> ctypes.CDLL:
    """The decoder's library, built on the first call."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            args = [ctypes.c_void_p, ctypes.c_size_t]
            err = [ctypes.c_char_p, ctypes.c_size_t]
            lib.mvt_zstd_content_size.restype = ctypes.c_int64
            lib.mvt_zstd_content_size.argtypes = args + err
            lib.mvt_zstd_decompress.restype = ctypes.c_int64
            lib.mvt_zstd_decompress.argtypes = (
                args + [ctypes.c_void_p, ctypes.c_size_t] + err)
            _lib = lib
        return _lib


def _decode_into(lib, src: np.ndarray, size: int):
    """Decode ``src`` into a ``size``-byte buffer: (buffer, bytes
    written), or (None, -2) where the output does not fit."""
    err = ctypes.create_string_buffer(_ERR_LEN)
    out = bytearray(size)
    dst = (ctypes.c_char * size).from_buffer(out) if size else None
    got = lib.mvt_zstd_decompress(src.ctypes.data, src.size, dst, size, err,
                                  _ERR_LEN)
    if got == -2:
        return None, got
    if got < 0:
        raise ValueError("malformed zstd data: %s"
                         % err.value.decode(errors="replace"))
    return out, got


def decompress(data: Union[bytes, bytearray, memoryview],
               size: Optional[int] = None) -> bytes:
    """The content of every zstd frame in ``data``, concatenated.

    ``size`` is the expected output size. Where it is None, the frames'
    own content sizes give it; where a frame carries none, the output is
    decoded into a buffer that doubles until it fits, up to
    ``MAX_UNSIZED_BYTES``. Raises ``ValueError`` on a malformed frame, a
    failed checksum, a frame that names a dictionary, or output that
    differs from ``size`` or exceeds that bound.
    """
    lib = load()
    src = np.frombuffer(data, np.uint8)
    if size is None:
        err = ctypes.create_string_buffer(_ERR_LEN)
        known = lib.mvt_zstd_content_size(src.ctypes.data, src.size, err,
                                          _ERR_LEN)
        if known == -2:
            raise ValueError("malformed zstd data: %s"
                             % err.value.decode(errors="replace"))
        if known < 0:
            cap = min(MAX_UNSIZED_BYTES, max(1 << 16, 4 * src.size))
            while True:
                out, got = _decode_into(lib, src, cap)
                if out is not None:
                    return bytes(out[:got])
                if cap >= MAX_UNSIZED_BYTES:
                    raise ValueError("zstd data decodes to more than %d "
                                     "bytes" % MAX_UNSIZED_BYTES)
                cap = min(MAX_UNSIZED_BYTES, 2 * cap)
        size = known
    if size < 0:
        raise ValueError("negative expected size %d" % size)
    out, got = _decode_into(lib, src, size)
    if out is None:
        raise ValueError("zstd data decodes to more than the expected %d "
                         "bytes" % size)
    if got != size:
        raise ValueError("zstd data decodes to %d bytes, expected %d"
                         % (got, size))
    return bytes(out)
