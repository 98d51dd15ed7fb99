"""Builds the CUDA sources under ``csrc/`` and binds their C entry points.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, under ``build/``
(named by a hash of the source, so an edited source is rebuilt). The sources
are compiled in parallel, one ``nvcc`` each. Libraries are loaded with
``ctypes``; nothing here runs when the module is imported.

Every kernel entry point is a :class:`Kernel`: it returns the CUDA error of
its launch (raised here as ``RuntimeError``) and keeps a plain count of its
launches, which ``chip_smoke.py`` reads to show that a path went through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = SRC_DIR / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{tag}.so", BUILD_DIR / f"{name}-{tag}.log"


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, in
    parallel. Returns each source's compiler log (``-Xptxas -v`` output)."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        src, so, log = _paths(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    logs = {name: _paths(name)[2] for name in names}
    return {name: p.read_text() if p.exists() else "" for name, p in logs.items()}


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        lib.trs_error_string.argtypes = [ctypes.c_int]
        lib.trs_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


class Kernel:
    """One C entry point of a ``csrc`` library, with its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn, self._lib = fn, lib
        err = self._fn(*args)
        if err != 0:
            msg = self._lib.trs_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} ({msg})")
        self.launches += 1


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_U32P = ctypes.POINTER(ctypes.c_uint)

BITONIC_TILE = Kernel(
    "bitonic_tile_kernel", "bitonic", "trs_bitonic_tile",
    [_P, _I64, _I32, _I32, _I64, _U32P, _U32P, _U32P, _I32, _P],
)
BITONIC_GLOBAL_STAGE = Kernel(
    "bitonic_global_stage_kernel", "bitonic", "trs_bitonic_global_stage",
    [_P, _I64, _I32, _I32, _I64, _I64, _P],
)
DISORDER = Kernel(
    "disorder_kernel", "disorder", "trs_disorder_count", [_P, _I64, _P, _P],
)
DISORDER_COLS = Kernel(
    "disorder_cols_kernel", "disorder", "trs_disorder_count_cols", [_P, _P, _I64, _P, _P],
)
SCAN = Kernel("scan_kernel", "scan", "trs_scan", [_P, _I64, _P, _I32, _P, _P])
DIGIT_HISTOGRAM = Kernel(
    "digit_histogram_kernel", "radix", "trs_digit_histogram",
    [_P, _I64, _I32, _I32, _I64, _P, _P],
)
REORDER = Kernel(
    "reorder_kernel", "radix", "trs_reorder",
    [_P, _P, _I64, _I32, _I32, _I32, _I64, _P, _P],
)
# The probes of ``tpu_radix_sort_torch/benchmarks`` (P1-P9): no sort
# launches them.
EXPLORE_CE = Kernel(
    "explore_ce_kernel", "explore_ce", "trs_explore_ce", [_P, _P, _I64, _I32, _I32, _I32, _P],
)
BLOCKSORT_CE = Kernel(
    "blocksort_ce_kernel", "explore_blocksort", "trs_blocksort_ce", [_P, _P, _I64, _I32, _P],
)
BLOCKSORT_STAGES = Kernel(
    "blocksort_stages_kernel", "explore_blocksort", "trs_blocksort_stages",
    [_P, _P, _I64, _I32, _P],
)
BLOCKSORT_STAGES_SPLIT = Kernel(
    "blocksort_stages_split_kernel", "explore_blocksort", "trs_blocksort_stages_split",
    [_P, _P, _I64, _I32, _I32, _P],
)
KEYS16_STAGE = Kernel(
    "keys16_stage_kernel", "explore_keys16", "trs_keys16_stage", [_P, _P, _I64, _I32, _I32, _P],
)
# The scan probes P4-P7 and the running max P8 (``explore_scan``,
# ``explore_keys16``).
BLOCKSUM = Kernel(
    "blocksum_kernel", "explore_scan", "trs_blocksum", [_P, _I64, _I64, _P, _P],
)
ADDBACK = Kernel(
    "addback_kernel", "explore_scan", "trs_addback", [_P, _P, _I64, _I64, _P, _P],
)
GRID_COPY = Kernel("grid_copy_kernel", "explore_scan", "trs_grid_copy", [_P, _P, _I64, _P])
CHAINED_SCAN = Kernel(
    "chained_scan_kernel", "explore_scan", "trs_chained_scan", [_P, _I64, _P, _P, _P],
)
CUMMAX = Kernel("cummax_kernel", "explore_scan", "trs_cummax", [_P, _I64, _P, _P, _P])
SORT_KERNELS = (BITONIC_TILE, BITONIC_GLOBAL_STAGE, DISORDER, DISORDER_COLS, SCAN,
                DIGIT_HISTOGRAM, REORDER)
PROBE_KERNELS = (EXPLORE_CE, BLOCKSORT_CE, BLOCKSORT_STAGES, BLOCKSORT_STAGES_SPLIT,
                 KEYS16_STAGE, BLOCKSUM, ADDBACK, GRID_COPY, CHAINED_SCAN, CUMMAX)
KERNELS = SORT_KERNELS + PROBE_KERNELS
# An empty kernel, a measuring instrument and no port of a TPU kernel: the
# card's cost of one launch (``explore_blocksort.launch_floor_ms``).
LAUNCH_FLOOR = Kernel("launch_floor_kernel", "explore_blocksort", "trs_launch_floor", [_I32, _P])


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
