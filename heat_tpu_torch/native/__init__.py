"""ctypes bindings for the native (C++/OpenMP) host helpers.

A copy of ``heat_tpu/native/__init__.py`` with its two sources
(``click_parser.cc``, ``metrics_kernels.cc``, verbatim), apart from where
the library goes: it is built with ``g++`` at first use into
``build/heat_tpu_torch/`` at the repository root (not next to the
sources), written under a temporary name and moved into place, and built
again when a source is newer. These are host code: the click-file parser
behind ``ClickDataset.from_file`` and the (U, k) hit matrix behind the
host metrics. Each caller falls back to its numpy path when the toolchain
or the build is missing, and records the path it took in ``PATHS``
(``"native"`` or ``"numpy"``, by function), with the build's error in
``BUILD_ERROR``, so that a run can require the native path: the fallback
must not hide a broken build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "heat_tpu_torch"
_SO = BUILD_DIR / "_heat_native.so"
_SRCS = [_DIR / "click_parser.cc", _DIR / "metrics_kernels.cc"]
_LOCK = threading.Lock()
_LIB = None
# The path each caller took last ("native" or "numpy"), and why the build
# failed, if it did.
PATHS: dict[str, str] = {}
BUILD_ERROR: Optional[str] = None


def _build() -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-fopenmp",
        "-shared",
        "-fPIC",
        "-std=c++17",
        *map(str, _SRCS),
        "-o",
        tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


def _lib() -> ctypes.CDLL:
    global _LIB, BUILD_ERROR
    with _LOCK:
        if _LIB is None:
            try:
                if not _SO.exists() or _SO.stat().st_mtime < max(
                    s.stat().st_mtime for s in _SRCS
                ):
                    _build()
            except Exception as err:
                stderr = getattr(err, "stderr", b"") or b""
                BUILD_ERROR = f"{err!r} {stderr.decode(errors='replace')}"
                raise
            lib = ctypes.CDLL(str(_SO))
            lib.parse_click_file.restype = ctypes.c_void_p
            lib.parse_click_file.argtypes = [ctypes.c_char_p, ctypes.c_char]
            for fn in ("parsed_num_users", "parsed_num_items", "parsed_num_pairs"):
                getattr(lib, fn).restype = ctypes.c_int64
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.parsed_fill.restype = None
            lib.parsed_fill.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.parsed_free.restype = None
            lib.parsed_free.argtypes = [ctypes.c_void_p]
            lib.hits_matrix.restype = None
            lib.hits_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
            ]
            _LIB = lib
    return _LIB


def hits_matrix(top: np.ndarray, true_items) -> np.ndarray:
    """(U, k) 0/1 hit matrix via the native OpenMP kernel.

    top: (U, k) ranked item ids; true_items: per-user truth lists.
    """
    lib = _lib()
    top = np.ascontiguousarray(top, np.int32)
    u, k = top.shape
    offsets = np.zeros(u + 1, np.int64)
    for i, t in enumerate(true_items):
        offsets[i + 1] = offsets[i] + len(t)
    truth = np.empty(max(int(offsets[-1]), 1), np.int32)
    for i, t in enumerate(true_items):
        if len(t):
            truth[offsets[i] : offsets[i + 1]] = np.sort(
                np.asarray(t, np.int32)
            )
    out = np.empty((u, k), np.float64)
    lib.hits_matrix(
        top.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        u,
        k,
        truth.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def parse_click_file(path: str, separator: str = " ") -> list[np.ndarray]:
    """Parse a click file natively; returns per-user item arrays.

    Matches heat_tpu_torch.data.datasets._parse_lines_numpy semantics (last
    line wins for duplicate users; absent user ids get empty lists).
    """
    lib = _lib()
    sep = separator.encode() if separator else b" "
    handle = lib.parse_click_file(path.encode(), sep[0:1])
    if not handle:
        raise OSError(f"native parser failed to open {path}")
    try:
        num_users = lib.parsed_num_users(handle)
        num_pairs = lib.parsed_num_pairs(handle)
        offsets = np.empty(num_users + 1, np.int64)
        items = np.empty(max(num_pairs, 1), np.int32)
        lib.parsed_fill(
            handle,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        lib.parsed_free(handle)
    return [
        items[offsets[u] : offsets[u + 1]] for u in range(num_users)
    ]
