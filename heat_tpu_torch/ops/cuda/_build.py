"""Build the package's CUDA sources into one shared library and load it.

The sources under ``heat_tpu_torch/csrc/`` have a plain C interface, so
they are compiled by ``nvcc`` alone (no PyTorch headers, a few seconds)
into ``build/heat_tpu_torch/`` at the repository root and bound with
``ctypes``. The library's file name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
The build happens at the first kernel launch, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "heat_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry point -> argtypes. Pointers and the stream are c_void_p: a plain
# Python int would be passed as a 32-bit int and cut the pointer.
SIGNATURES = {
    # table, n_rows, d, ids, m, out, stream
    "heat_gather_rows_f32": (_P, _I64, _I32, _P, _I64, _P, _P),
    # table, n_rows, d, his_ids, lens, batch, his, out, stream
    "heat_history_mean_f32": (_P, _I64, _I32, _P, _P, _I64, _I32, _P, _P),
    # table, n_rows, d, ids, deltas, m, stream
    "heat_scatter_add_rows_f32": (_P, _I64, _I32, _P, _P, _I64, _P),
    # table, n_rows, d, ids, rows, m, stream
    "heat_scatter_set_rows_f32": (_P, _I64, _I32, _P, _P, _I64, _P),
    # sim, rows, n_cols, widx, kw, w, out, stream
    "heat_window_extract_f32": (_P, _I64, _I64, _P, _I32, _I32, _P, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of heat_tpu_torch need the CUDA toolkit to build"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libheat_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their current text is
    missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
