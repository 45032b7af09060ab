"""Duplicate-safe sparse row updates for embedding tables (batch-mode SGD).

Counterpart of the dense-accumulator path of ``heat_tpu/train/scatter.py``
(``apply_row_updates`` for tables up to DENSE_ROWS_THRESHOLD rows):

    acc = zeros(table.shape); acc[ids] += grads      (kernel K3, duplicates add)
    table = table - lr * clip(acc, -clip_val, clip_val)

Untouched rows see clip(0) == 0 and are unchanged. Ids equal to the table
size mark weight-0 padding and are dropped, as JAX's ``mode="drop"``
does. The sort-dedup path for larger tables, the accumulating (``accum``)
mode, l2 and the moment optimizers are not ported yet; the engine refuses
their configurations.
"""

from __future__ import annotations

from typing import Optional

import torch

from heat_tpu_torch.ops.cuda.scatter import scatter_add_rows

# Tables at or below this row count use the dense-accumulator path.
DENSE_ROWS_THRESHOLD = 4 * 1024 * 1024


def write_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """A copy of ``table`` with ``table[ids[k]] = rows[k]``; ids equal to
    the table size are dropped.

    The dropped entries are redirected to one extra sink row that is cut
    off afterwards, which masks them without a host sync. A repeated id
    gets one of its rows; callers write identical rows for repeats.
    """
    n, d = table.shape
    ext = torch.cat([table, table.new_empty((1, d))])
    ext.index_copy_(0, ids.long().clamp(0, n), rows.to(table.dtype))
    return ext[:n]


def apply_row_updates(
    table: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr: torch.Tensor,
    clip_val: float,
    writeback: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SGD row update with an elementwise clip on the per-row sum:

        g = clip(sum_per_unique(grads)); row -= lr * g

    writeback: optional (M, d) rows written to ``table[ids]`` BEFORE the
    update (the user table's aggregated-embedding write-back). Duplicate
    ids write identical rows, because every read of a batched step sees
    the batch-start tables.

    ids: (M,) int32, ids == table.shape[0] are padding and are dropped.
    Returns a new table.
    """
    if table.shape[0] > DENSE_ROWS_THRESHOLD:
        raise NotImplementedError(
            "tables above DENSE_ROWS_THRESHOLD rows need the sort-dedup "
            "update path (ROADMAP item 4)"
        )
    if writeback is not None:
        table = write_rows(table, ids, writeback)
    acc = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    scatter_add_rows(acc, ids, grads.float().contiguous())
    g = torch.clamp(acc, -clip_val, clip_val)
    return table - (lr * g).to(table.dtype)
