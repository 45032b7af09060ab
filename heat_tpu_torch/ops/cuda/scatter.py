"""In-place row scatters: the duplicate-safe scatter-add (K3) and the
scatter-set (S1).

K3 is the counterpart of ``heat_tpu/ops/pallas/scatter.py``, S1 of
``scripts/profile_scatter_pallas.py`` ``pallas_scatter_set``. After
checking the kernel's contract, each wrapper runs its plain PyTorch
version (``*_ref``) on the CPU, and on a CUDA device launches the
hand-written kernel of ``heat_tpu_torch/csrc/scatter.cu`` or raises.

Unlike the Pallas kernel, K3's ids may repeat: the kernel adds with f32
atomics, which is what the dense gradient accumulator of
``train/scatter.py`` needs. S1 writes rows: callers pass unique ids, or
repeats whose rows are identical. For both, the sentinel id == N (and any
id outside [0, N)) is skipped, the ``mode="drop"`` of the JAX scatters
they replace.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.ops.cuda import _build
from heat_tpu_torch.ops.cuda.gather import _check, _stream

LAUNCHES = {"scatter_add_rows": 0, "scatter_set_rows": 0}


def _in_range(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return (ids >= 0) & (ids < table.shape[0])


def scatter_add_rows_ref(
    table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows`. ``index_add_`` raises on
    an out-of-range id where JAX's ``mode="drop"`` drops it, so the
    sentinel rows are masked out explicitly first."""
    keep = _in_range(table, ids)
    return table.index_add_(0, ids[keep].long(), deltas[keep])


def scatter_set_rows_ref(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`scatter_set_rows`: ``index_copy_`` of the
    rows whose ids lie in [0, N) (the mask syncs the host; the kernel
    does not)."""
    keep = _in_range(table, ids)
    return table.index_copy_(0, ids[keep].long(), rows[keep])


def _check_rows(name: str, table: torch.Tensor, ids: torch.Tensor,
                rows: torch.Tensor, what: str) -> bool:
    on_card = _check(name, table, ids)
    d = table.shape[1]
    m = ids.shape[0]
    if ids.dim() != 1 or rows.shape != (m, d):
        raise ValueError(
            f"{name}: ids must be (M,) and {what} (M, {d}), got "
            f"{tuple(ids.shape)} and {tuple(rows.shape)}"
        )
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous f32")
    if rows.device != table.device:
        raise ValueError(f"{name}: {what} must be on {table.device}")
    return on_card


def _launch(fn: str, counter: str, table, ids, rows) -> torch.Tensor:
    if ids.shape[0] == 0:
        return table
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, fn)(
            table.data_ptr(), table.shape[0], table.shape[1], ids.data_ptr(),
            rows.data_ptr(), ids.shape[0], _stream(table),
        )
    _build.check(rc, counter)
    LAUNCHES[counter] += 1
    return table


def scatter_add_rows(
    table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] += deltas[k], in place; returns ``table``.

    table: (N, d) f32; ids: (M,) int32, repeats allowed, ids outside
    [0, N) skipped; deltas: (M, d) f32.
    """
    if not _check_rows("scatter_add_rows", table, ids, deltas, "deltas"):
        return scatter_add_rows_ref(table, ids, deltas)
    return _launch("heat_scatter_add_rows_f32", "scatter_add_rows",
                   table, ids, deltas)


def scatter_set_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] = rows[k], in place; returns ``table``.

    table: (N, d) f32; ids: (M,) int32, ids outside [0, N) skipped;
    rows: (M, d) f32. A repeated id must carry identical rows (otherwise
    each element comes from one of them).
    """
    if not _check_rows("scatter_set_rows", table, ids, rows, "rows"):
        return scatter_set_rows_ref(table, ids, rows)
    return _launch("heat_scatter_set_rows_f32", "scatter_set_rows",
                   table, ids, rows)
