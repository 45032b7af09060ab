"""Duplicate-safe in-place row scatter-add (K3).

The counterpart of ``heat_tpu/ops/pallas/scatter.py``. After checking the
kernel's contract, :func:`scatter_add_rows` runs the plain PyTorch version
(:func:`scatter_add_rows_ref`) on the CPU, and on a CUDA device launches
the hand-written kernel of ``heat_tpu_torch/csrc/scatter.cu`` or raises.

Unlike the Pallas kernel, ids may repeat: the kernel adds with f32
atomics, which is what the dense gradient accumulator of
``train/scatter.py`` needs. The sentinel id == N (and any id outside
[0, N)) is skipped, the ``mode="drop"`` of the JAX scatter it replaces.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.ops.cuda import _build
from heat_tpu_torch.ops.cuda.gather import _check, _stream

LAUNCHES = {"scatter_add_rows": 0}


def scatter_add_rows_ref(
    table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows`. ``index_add_`` raises on
    an out-of-range id where JAX's ``mode="drop"`` drops it, so the
    sentinel rows are masked out explicitly first."""
    keep = (ids >= 0) & (ids < table.shape[0])
    return table.index_add_(0, ids[keep].long(), deltas[keep])


def scatter_add_rows(
    table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] += deltas[k], in place; returns ``table``.

    table: (N, d) f32; ids: (M,) int32, repeats allowed, ids outside
    [0, N) skipped; deltas: (M, d) f32.
    """
    on_card = _check("scatter_add_rows", table, ids)
    n, d = table.shape
    m = ids.shape[0]
    if ids.dim() != 1 or deltas.shape != (m, d):
        raise ValueError(
            f"scatter_add_rows: ids must be (M,) and deltas (M, {d}), got "
            f"{tuple(ids.shape)} and {tuple(deltas.shape)}"
        )
    if deltas.dtype != torch.float32 or not deltas.is_contiguous():
        raise ValueError("scatter_add_rows: deltas must be contiguous f32")
    if deltas.device != table.device:
        raise ValueError(f"scatter_add_rows: deltas must be on {table.device}")
    if not on_card:
        return scatter_add_rows_ref(table, ids, deltas)
    if m == 0:
        return table
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.heat_scatter_add_rows_f32(
            table.data_ptr(), n, d, ids.data_ptr(), deltas.data_ptr(), m,
            _stream(table),
        )
    _build.check(rc, "scatter_add_rows")
    LAUNCHES["scatter_add_rows"] += 1
    return table
