"""In-place row scatters: the duplicate-safe scatter-add (K3) and the
scatter-set (S1).

K3 is the counterpart of ``heat_tpu/ops/pallas/scatter.py``, S1 of
``scripts/profile_scatter_pallas.py`` ``pallas_scatter_set``. After
checking the kernel's contract, each wrapper runs its plain PyTorch
version (``*_ref``) on the CPU, and on a CUDA device launches the
hand-written kernel of ``heat_tpu_torch/csrc/scatter.cu`` or raises.

Tables are f32 or bf16 (one kernel instance per type); the rows to add or
write have the table's type. Unlike the Pallas kernel, K3's ids may
repeat: the kernel adds with atomics, which is what the dense gradient
accumulator of ``train/scatter.py`` and the per-occurrence ``direct``
update need. A bf16 add rounds every time, so over a repeated id the
result depends on the order of the adds (within occurrences x one bf16 ulp
of the largest partial sum); on unique ids it is deterministic. S1 writes rows: callers pass unique ids, or
repeats whose rows are identical. For both, the sentinel id == N (and any
id outside [0, N)) is skipped, the ``mode="drop"`` of the JAX scatters
they replace.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.ops.cuda import _build
from heat_tpu_torch.ops.cuda.gather import SUFFIX, _check, count_launch

# As gather.LAUNCHES: every launch under the wrapper's name, the bf16
# instance's also under name + "_bf16".
LAUNCHES = {
    name + suffix: 0
    for name in ("scatter_add_rows", "scatter_set_rows")
    for suffix in ("", "_bf16")
}


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
    if rows.dtype != table.dtype or not rows.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be contiguous f32 or bf16, of the table's "
            f"type {table.dtype}; got {rows.dtype}"
        )
    if rows.device != table.device:
        raise ValueError(f"{name}: {what} must be on {table.device}")
    return on_card


def _launch(fn: str, counter: str, table, ids, rows) -> torch.Tensor:
    if ids.shape[0] == 0:
        return table
    _build.launch(
        f"{fn}_{SUFFIX[table.dtype]}", counter, table.device,
        table.data_ptr(), table.shape[0], table.shape[1], ids.data_ptr(),
        rows.data_ptr(), ids.shape[0],
    )
    count_launch(LAUNCHES, counter, table)
    return table


def scatter_add_rows(
    table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] += deltas[k], in place; returns ``table``.

    table: (N, d) f32 or bf16; ids: (M,) int32, repeats allowed, ids
    outside [0, N) skipped; deltas: (M, d) of the table's type.
    """
    if not _check_rows("scatter_add_rows", table, ids, deltas, "deltas"):
        return scatter_add_rows_ref(table, ids, deltas)
    return _launch("heat_scatter_add_rows", "scatter_add_rows",
                   table, ids, deltas)


def scatter_set_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] = rows[k], in place; returns ``table``.

    table: (N, d) f32 or bf16; ids: (M,) int32, ids outside [0, N)
    skipped; rows: (M, d) of the table's type. A repeated id must carry
    identical rows (otherwise each element comes from one of them).
    """
    if not _check_rows("scatter_set_rows", table, ids, rows, "rows"):
        return scatter_set_rows_ref(table, ids, rows)
    return _launch("heat_scatter_set_rows", "scatter_set_rows",
                   table, ids, rows)
