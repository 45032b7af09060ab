"""ctypes bindings for the native (C++/OpenMP) host helpers.

A copy of ``heat_tpu/native/__init__.py`` with its two sources
(``click_parser.cc``, ``metrics_kernels.cc``, verbatim), apart from where
the library goes: it is built with ``g++`` at first use into
``build/heat_tpu_torch/`` at the repository root (not next to the
sources), written under a temporary name and moved into place. Its file
name carries a key, a hash of the sources, the compiler flags and the
host's CPU (``-march=native`` compiles for the CPU that builds), so a
library built from other sources, with other flags or on another machine
is never loaded: a copy of the tree that brings one along builds its own.
These are host code: the click-file parser
behind ``ClickDataset.from_file`` and the (U, k) hit matrix behind the
host metrics. Each caller falls back to its numpy path when the toolchain
or the build is missing, and records the path it took in ``PATHS``
(``"native"`` or ``"numpy"``, by function), with the build's error in
``BUILD_ERROR``, so that a run can require the native path: the fallback
must not hide a broken build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "heat_tpu_torch"
_SRCS = [_DIR / "click_parser.cc", _DIR / "metrics_kernels.cc"]
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_CPUINFO = Path("/proc/cpuinfo")
_LOCK = threading.Lock()
_LIB = None
# The path each caller took last ("native" or "numpy"), and why the build
# failed, if it did.
PATHS: dict[str, str] = {}
BUILD_ERROR: Optional[str] = None


def host_cpu() -> str:
    """The CPU that ``-march=native`` compiles for: the model name and flags
    of the first processor in ``/proc/cpuinfo``, or ``platform.machine()``
    and ``platform.processor()`` where that file says neither."""
    fields = {}
    try:
        text = _CPUINFO.read_text()
    except OSError:
        text = ""
    for line in text.splitlines():
        if not line.strip():
            if fields:
                break  # the first processor's block ends at a blank line
            continue
        key, _, value = line.partition(":")
        if key.strip() in ("model name", "flags"):
            fields[key.strip()] = " ".join(value.split())
    if fields:
        return f"{fields.get('model name', '')}; {fields.get('flags', '')}"
    return f"{platform.machine()}; {platform.processor()}"


def library_path() -> Path:
    """The library's file under ``BUILD_DIR``, named by a hash of the
    sources, the flags and :func:`host_cpu`."""
    h = hashlib.sha256()
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(host_cpu().encode())
    return BUILD_DIR / f"_heat_native_{h.hexdigest()[:16]}.so"


# The library this process loads (``_lib`` names it again at the build).
_SO = library_path()


def _build(so: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, *map(str, _SRCS), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB, _SO, BUILD_ERROR
    with _LOCK:
        if _LIB is None:
            _SO = library_path()
            try:
                if not _SO.exists():
                    _build(_SO)
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
