"""Build the package's CUDA sources into one shared library and load it.

The sources under ``heat_tpu_torch/csrc/`` have a plain C interface, so
they are compiled by ``nvcc`` alone (no PyTorch headers, a few seconds;
one ``nvcc -c`` per source, all started together, then one link) into
``build/heat_tpu_torch/`` at the repository root and bound with
``ctypes``. The library's file name carries a hash of the sources (headers
included) and the flags, so an edited source is rebuilt and a stale library
is never loaded. The build happens at the first kernel launch, never at
import.

The launch path is kept short, since for kernels of a few microseconds it
is what a caller pays. :func:`library` resolves every C entry point once
into ``FUNCS`` (bound ctypes functions with their argument types); a
launch is one dictionary lookup and one foreign call. Every entry point
takes, after its own arguments, the index of the tensors' device and the
raw handle of PyTorch's current stream of that device. The device guard
lives on the C side (``csrc/launch.cuh``: ``cudaGetDevice``, and
``cudaSetDevice`` and back only where the device differs), not in a Python
context manager. The stream handle comes from
``torch._C._cuda_getCurrentRawStream`` (no ``Stream`` object is built;
``torch.cuda.current_stream(index).cuda_stream`` where a PyTorch lacks it)
and is read at every launch, never cached: under ``torch.cuda.graph`` the
current stream is the capture stream, and a launch on any other stream
would fall outside the graph.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "heat_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C entry point -> argtypes of its own arguments; every entry point takes
# (device index, stream) after them. Pointers and the stream are c_void_p:
# a plain Python int would be passed as a 32-bit int and cut the pointer.
# One symbol per element type of the table: heat_<kernel>_{f32,bf16}.
_BY_DTYPE = {
    # table, n_rows, d, ids, m, out
    "heat_gather_rows": (_P, _I64, _I32, _P, _I64, _P),
    # table, n_blocks, block_elems, ids, m, out
    "heat_gather_blocks": (_P, _I64, _I64, _P, _I64, _P),
    # table, n_rows, d, his_ids, lens, rows (or null), n_users, batch, his,
    # out, out_bf16, split
    "heat_history_mean": (_P, _I64, _I32, _P, _P, _P, _I64, _I64, _I32, _P,
                          _I32, _I32),
    # table, n_rows, d, ids, deltas, m
    "heat_scatter_add_rows": (_P, _I64, _I32, _P, _P, _I64),
    # table, n_rows, d, ids, grads, grads_bf16, rows, rows_bf16, m, lr, clip,
    # l2, clip_first
    "heat_scatter_add_update": (_P, _I64, _I32, _P, _P, _I32, _P, _I32, _I64,
                                _P, _F32, _F32, _I32),
    # table, n_rows, d, ids, rows, rows_bf16, m
    "heat_scatter_set_rows": (_P, _I64, _I32, _P, _P, _I32, _I64),
    # table, n_rows, d, ids, base, base_bf16, summed, m, lr, clip, l2
    "heat_scatter_set_update": (_P, _I64, _I32, _P, _P, _I32, _P, _I64, _P,
                                _F32, _F32),
}
SIGNATURES = {
    f"{name}_{suffix}": argtypes
    for name, argtypes in _BY_DTYPE.items()
    for suffix in ("f32", "bf16")
}
# sim, rows, n_cols, widx, kw, w, out
SIGNATURES["heat_window_extract_f32"] = (_P, _I64, _I64, _P, _I32, _I32, _P)
# segments: a host array of 8 int64 fields a segment (table, n_rows, d,
# table_bf16, ids, m, out, out_bf16), n_segments
SIGNATURES["heat_gather_rows_multi"] = (_P, _I32)

# C entry point -> bound function, filled by library().
FUNCS: dict[str, Callable[..., int]] = {}
_raw_stream: Callable[[int], int] | None = None


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
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for obj, src in zip(objects, sources())
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        results = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in zip(compiles, procs)]
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]
        for cmd, text, rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(lib, out)  # atomic: a concurrent build sees all or none
    return out


def _stream_reader() -> Callable[[int], int]:
    """device index -> raw handle of PyTorch's current stream there."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream


def library() -> dict[str, Callable[..., int]]:
    """``FUNCS``, after building and loading the library at first use."""
    global _raw_stream
    if not FUNCS:
        lib = ctypes.CDLL(str(build()))
        _raw_stream = _stream_reader()
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*argtypes, _I32, _P]
            fn.restype = ctypes.c_int
            FUNCS[name] = fn
    return FUNCS


def launch(symbol: str, name: str, index: int, *args) -> None:
    """Call the C entry point ``symbol`` with ``args``, the device index
    ``index`` of its tensors and PyTorch's current stream of that device;
    raise on a non-zero cudaError_t."""
    fn = FUNCS.get(symbol) or library()[symbol]
    rc = fn(*args, index, _raw_stream(index))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
