"""Build the CUDA sources under ``multiverse_torch/csrc`` and load them.

The sources are compiled at first use with ``nvcc`` for ``sm_90a``
(Hopper), one ``nvcc -c`` per ``.cu`` file, all started together, and
linked into one shared library with a plain C interface, which is
loaded with ctypes. The library goes to ``multiverse_torch/_build/``
under a name keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree loads the existing file. Only sources in
the package are compiled: nothing outside the checkout is needed but
the CUDA toolkit. The kernel wrappers call every entry point through
:func:`launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# ptxas's report (registers, shared memory, spills per kernel) of the
# last build in this process, empty when the library was already built
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of each C entry point (all return a cudaError_t)
_SIGNATURES = {
    "mv_gnn_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mv_gate_lstm": [_P] * 11 + [_I] * 5 + [ctypes.c_float, _P],
    "mv_class_readout": [_P, _P, _I, _P, _I, _I, _I, _I, _P],
    "mv_gnn_attention_h2q": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mv_gnn_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mv_gnn_attention_q8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mv_gate_lstm_q8": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
    "mv_patch_max": [_P, _P, _I, _I, _I, _P],
    "mv_gate_lstm_q8dyn": [_P] * 13 + [_I] * 5 + [ctypes.c_float, _P],
    "mv_gnn_dense_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mv_gnn_dense_bwd": [_P] * 8 + [_I] * 5 + [_P],
    "mv_rcp_rn_mismatches": [ctypes.c_uint, ctypes.c_uint, _P, _P],
}


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmultiverse_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels of multiverse_torch are built from "
            "multiverse_torch/csrc at first use and need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append("nvcc failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), logs[-1]))
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(f"{tag}.tmp.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr))
        # atomic: two processes building at once both succeed
        os.replace(tmp, out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_log = "".join(logs)
    return out


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mv_error_string.argtypes = [ctypes.c_int]
            lib.mv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args, device) -> None:
    """Call the entry point ``mv_<name>`` with ``args`` and the current
    stream of ``device`` last, loading the library at first use; a
    ``cudaError_t`` other than success raises a ``RuntimeError`` that
    names the launch."""
    lib = load_library()
    err = getattr(lib, "mv_" + name)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("CUDA launch of %s failed: %s (%d)" % (
            name, lib.mv_error_string(err).decode(), err))
