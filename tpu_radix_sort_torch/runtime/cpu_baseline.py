"""Native CPU baseline sorter (ctypes binding to ``native/sort.cc``).

Counterpart of ``tpu_radix_sort/runtime/cpu_baseline.py``: the host-side
yardstick that the demos and ``benchmarks/crossover.py`` time the card
against, a stable 8-bit LSD radix sort in C++, compiled with g++ at first
use and loaded with ctypes. Without a compiler it falls back to NumPy's
stable sort, which gives the same bytes; :func:`sort_kind` names the sort
that runs, and every printed CPU time carries that name.

The library is built into the port's own ``build/native/`` (gitignored),
named by a hash of the source, so an edited source is rebuilt. g++ writes
a per-process temporary file that ``os.replace`` moves into place, so two
processes that build at once never load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "sort.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the compiled library lives: ``build/native/libtrs_torch_sort-<hash>.so``."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtrs_torch_sort-{tag}.so"


def _build_and_load():
    """Compile sort.cc once into the build directory and dlopen it."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", str(tmp),
                            str(SRC)], check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.trs_radix_sort_u32.argtypes = [u32p, u32p, ctypes.c_size_t]
    lib.trs_radix_sort_u32.restype = None
    lib.trs_disorder_count_u32.argtypes = [u32p, ctypes.c_size_t]
    lib.trs_disorder_count_u32.restype = ctypes.c_size_t
    return lib


def _get_lib():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _build_and_load()
            except (OSError, subprocess.CalledProcessError):
                _lib = None
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def sort_kind() -> str:
    """The sort that :func:`cpu_sort` runs: 'native radix' or 'numpy'."""
    return "native radix" if native_available() else "numpy"


def cpu_sort(keys: np.ndarray, values: np.ndarray | None = None):
    """Stable ascending sort of uint32 keys (and optional uint32 values) on
    the CPU: the native radix sort when it is available, NumPy's stable sort
    otherwise. Returns new arrays; the inputs are untouched."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    lib = _get_lib()
    if lib is None:
        order = np.argsort(keys, kind="stable")
        return (keys[order], values[order]) if values is not None else keys[order]
    k = keys.copy()
    kp = k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    if values is not None:
        v = np.ascontiguousarray(values, dtype=np.uint32).copy()
        lib.trs_radix_sort_u32(kp, v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), k.size)
        return k, v
    lib.trs_radix_sort_u32(kp, None, k.size)
    return k


def cpu_disorder_count(keys: np.ndarray) -> int:
    """Adjacent descents of uint32 keys (0 when sorted)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    lib = _get_lib()
    if lib is None:
        return int(np.sum(keys[:-1] > keys[1:])) if keys.size > 1 else 0
    return int(lib.trs_disorder_count_u32(keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                                          keys.size))
