"""In-place row scatters: the duplicate-safe scatter-add (K3) and the
scatter-set (S1), each with a second entry that computes the SGD update's
rows inside the kernel.

K3 is the counterpart of ``heat_tpu/ops/pallas/scatter.py``, S1 of
``scripts/profile_scatter_pallas.py`` ``pallas_scatter_set``. After
checking the kernel's contract, each wrapper runs its plain PyTorch
version (``*_ref``) on the CPU, and on a CUDA device launches the
hand-written kernel of ``heat_tpu_torch/csrc/scatter.cu`` or raises.

Four entries, each for f32 and bf16 tables (one kernel instance per type):

* :func:`scatter_add_rows`: ``table[ids[k]] += deltas[k]``, the deltas of
  the table's type. Unlike the Pallas kernel its ids may repeat: the
  kernel adds with reductions in L2 (16-byte vector ``red`` where the rows
  allow it), which is what the dense gradient accumulator, the segment
  sums and the per-occurrence ``direct`` update need.
* :func:`scatter_add_update`: the same add with the increment computed in
  registers from raw gradient rows: ``-lr * clip(g)`` with the l2 term
  before or after the clip. The JAX package has both orders and so has
  this entry, under ``clip_first``: the ``direct`` update clips each
  occurrence's gradient and then adds l2 against the forward-pass rows
  (``heat_tpu/train/scatter.py:161-167``); the sort-dedup batch update adds
  l2 against the table's own row, in the table's type, and then clips
  (``:395-401``). They differ wherever the clip binds.
* :func:`scatter_set_rows`: ``table[ids[k]] = rows[k]``; the rows may be
  f32 or bf16 whatever the table's type (converted in registers as a cast
  would, so no cast pass runs before it).
* :func:`scatter_set_update`: the sort-dedup path's fused write-back and
  update (``heat_tpu/train/scatter.py:380-390``):
  ``table[ids[k]] = base[k] - lr * clip(summed[k] + l2 * base[k])``.

What bounds them on the card is bytes (microseconds at a training step's
shapes), so what the caller pays is launches; the update entries replace
three to five elementwise launches and the scatter by one. ``lr`` is a
0-d tensor on the table's device and is read by the kernel: no wrapper
waits for the host. The arithmetic is f32 with one rounding to the table's
type, without FMA contraction: on unique ids each update entry is bit-equal
to its plain version.

A bf16 add rounds every time, so over a repeated id the result depends on
the order of the adds (within occurrences x half a bf16 ulp of the largest
partial sum); on unique ids it is deterministic. S1 writes rows: callers
pass unique ids, or repeats whose rows are identical. For all entries the
sentinel id == N (and any id outside [0, N)) is skipped, the
``mode="drop"`` of the JAX scatters they replace.
"""

from __future__ import annotations

from typing import Optional

import torch

from heat_tpu_torch.models.aggregator import scalar_in
from heat_tpu_torch.ops.cuda import _build
from heat_tpu_torch.ops.cuda.gather import SUFFIX, _check, count_launch, symbols

# As gather.LAUNCHES: every launch under the wrapper's name, the bf16
# instance's also under name + "_bf16".
LAUNCHES = {
    name + suffix: 0
    for name in ("scatter_add_rows", "scatter_set_rows", "scatter_add_update",
                 "scatter_set_update")
    for suffix in ("", "_bf16")
}

_ADD_ROWS = symbols("scatter_add_rows")
_SET_ROWS = symbols("scatter_set_rows")
_ADD_UPDATE = symbols("scatter_add_update")
_SET_UPDATE = symbols("scatter_set_update")


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
    rows, cast to the table's type, whose ids lie in [0, N) (the mask
    syncs the host; the kernel does not)."""
    keep = _in_range(table, ids)
    return table.index_copy_(0, ids[keep].long(), rows[keep].to(table.dtype))


def scatter_add_update_ref(
    table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor, *,
    lr: torch.Tensor, clip_val: float, l2: float = 0.0,
    rows: Optional[torch.Tensor] = None, clip_first: bool,
) -> torch.Tensor:
    """Plain version of :func:`scatter_add_update`: the elementwise passes
    of the two SGD updates as they stand in the JAX package, then
    :func:`scatter_add_rows_ref`."""
    g = grads.float()
    if clip_first:
        g = torch.clamp(g, -clip_val, clip_val)
        if l2:
            g = g + l2 * rows.float()
    else:
        if l2:
            own = table.index_select(0, ids.clamp(0, table.shape[0] - 1).long())
            valid = _in_range(table, ids).to(own.dtype)[:, None]
            g = g + scalar_in(l2, own.dtype) * own * valid
        g = torch.clamp(g, -clip_val, clip_val)
    return scatter_add_rows_ref(table, ids, (g * -lr).to(table.dtype))


def scatter_set_update_ref(
    table: torch.Tensor, ids: torch.Tensor, base: torch.Tensor,
    summed: torch.Tensor, *, lr: torch.Tensor, clip_val: float,
    l2: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`scatter_set_update`."""
    base = base.float()
    g = summed
    if l2:
        g = g + l2 * base
    g = torch.clamp(g, -clip_val, clip_val)
    return scatter_set_rows_ref(table, ids, (base - lr * g).to(table.dtype))


def _check_rows(name: str, table: torch.Tensor, ids: torch.Tensor,
                rows: torch.Tensor, what: str, own_type: bool = False) -> None:
    """``rows`` is a contiguous (M, d) f32 or bf16 array (of the table's
    type when ``own_type``) on the table's device, M being ``ids``'s
    length."""
    if ids.dim() != 1 or rows.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(
            f"{name}: ids must be (M,) and {what} (M, {table.shape[1]}), got "
            f"{tuple(ids.shape)} and {tuple(rows.shape)}"
        )
    dtype = rows.dtype
    if (dtype != table.dtype if own_type else dtype not in SUFFIX) \
            or not rows.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be contiguous f32 or bf16"
            + (f", of the table's type {table.dtype}" if own_type else "")
            + f"; got {dtype}"
        )
    if rows.device != table.device:
        raise ValueError(f"{name}: {what} must be on {table.device}")


def _check_lr(name: str, table: torch.Tensor, lr) -> None:
    """The kernel reads lr through a pointer: a one-element f32 tensor on
    the table's device."""
    if not isinstance(lr, torch.Tensor):
        raise TypeError(f"{name}: lr must be a tensor, got {type(lr).__name__}")
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(
            f"{name}: lr must hold one f32 value, got {lr.dtype} "
            f"{tuple(lr.shape)}"
        )
    if lr.device != table.device:
        raise ValueError(f"{name}: lr must be on {table.device}")


def scatter_add_rows(
    table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] += deltas[k], in place; returns ``table``.

    table: (N, d) f32 or bf16; ids: (M,) int32, repeats allowed, ids
    outside [0, N) skipped; deltas: (M, d) of the table's type.
    """
    on_card = _check("scatter_add_rows", table, ids)
    _check_rows("scatter_add_rows", table, ids, deltas, "deltas", own_type=True)
    if not on_card:
        return scatter_add_rows_ref(table, ids, deltas)
    m = ids.shape[0]
    if m == 0:
        return table
    n, d = table.shape
    _build.launch(
        _ADD_ROWS[table.dtype], "scatter_add_rows", table.device.index,
        table.data_ptr(), n, d, ids.data_ptr(), deltas.data_ptr(), m,
    )
    count_launch(LAUNCHES, "scatter_add_rows", table)
    return table


def scatter_add_update(
    table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor, *,
    lr: torch.Tensor, clip_val: float, l2: float = 0.0,
    rows: Optional[torch.Tensor] = None, clip_first: bool,
) -> torch.Tensor:
    """The SGD step of raw gradient rows, added in place; returns ``table``.

    clip_first (the per-occurrence ``direct`` update):
        table[ids[k]] += T(-lr * (clip(g[k]) + l2 * float(rows[k])))
    otherwise (the sort-dedup batch update; ids unique when l2 != 0):
        table[ids[k]] += T(-lr * clip(g[k] + T(l2) * table[ids[k]]))
    with T the table's type, every other step in f32 and clip the
    elementwise clamp to [-clip_val, clip_val].

    table: (N, d) f32 or bf16; ids: (M,) int32, repeats allowed, ids outside
    [0, N) skipped; grads: (M, d) f32 or bf16; lr: one f32 value on the
    table's device; rows: (M, d) f32 or bf16 forward-pass rows, needed when
    clip_first and l2 != 0 and refused otherwise.
    """
    name = "scatter_add_update"
    on_card = _check(name, table, ids)
    _check_rows(name, table, ids, grads, "grads")
    _check_lr(name, table, lr)
    if clip_first and l2:
        if rows is None:
            raise ValueError(f"{name}: l2 after the clip needs rows")
        _check_rows(name, table, ids, rows, "rows")
    elif rows is not None:
        raise ValueError(
            f"{name}: rows are read only when clip_first and l2 != 0"
        )
    if not on_card:
        return scatter_add_update_ref(
            table, ids, grads, lr=lr, clip_val=clip_val, l2=l2, rows=rows,
            clip_first=clip_first,
        )
    m = ids.shape[0]
    if m == 0:
        return table
    n, d = table.shape
    if rows is None:
        rows_ptr, rows_bf16 = None, 0
    else:
        rows_ptr, rows_bf16 = rows.data_ptr(), int(rows.dtype == torch.bfloat16)
    _build.launch(
        _ADD_UPDATE[table.dtype], name, table.device.index,
        table.data_ptr(), n, d, ids.data_ptr(), grads.data_ptr(),
        int(grads.dtype == torch.bfloat16), rows_ptr, rows_bf16, m,
        lr.data_ptr(), clip_val,
        l2 if clip_first else scalar_in(l2, table.dtype), int(clip_first),
    )
    count_launch(LAUNCHES, name, table)
    return table


def scatter_set_rows(
    table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """table[ids[k]] = rows[k], in place; returns ``table``.

    table: (N, d) f32 or bf16; ids: (M,) int32, ids outside [0, N)
    skipped; rows: (M, d) f32 or bf16, cast to the table's type on the way.
    A repeated id must carry identical rows (otherwise each 16-byte vector
    comes from one of them).
    """
    on_card = _check("scatter_set_rows", table, ids)
    _check_rows("scatter_set_rows", table, ids, rows, "rows")
    if not on_card:
        return scatter_set_rows_ref(table, ids, rows)
    m = ids.shape[0]
    if m == 0:
        return table
    n, d = table.shape
    _build.launch(
        _SET_ROWS[table.dtype], "scatter_set_rows", table.device.index,
        table.data_ptr(), n, d, ids.data_ptr(), rows.data_ptr(),
        int(rows.dtype == torch.bfloat16), m,
    )
    count_launch(LAUNCHES, "scatter_set_rows", table)
    return table


def scatter_set_update(
    table: torch.Tensor, ids: torch.Tensor, base: torch.Tensor,
    summed: torch.Tensor, *, lr: torch.Tensor, clip_val: float,
    l2: float = 0.0,
) -> torch.Tensor:
    """The fused write-back and SGD step, in place; returns ``table``:
        table[ids[k]] = T(base[k] - lr * clip(summed[k] + l2 * base[k]))
    in f32 with one rounding to the table's type T.

    table: (N, d) f32 or bf16; ids: (M,) int32, unique apart from ids
    outside [0, N), which are skipped; base: (M, d) f32 or bf16, the rows
    written back; summed: (M, d) f32 combined gradients; lr: one f32 value
    on the table's device.
    """
    name = "scatter_set_update"
    on_card = _check(name, table, ids)
    _check_rows(name, table, ids, base, "base")
    _check_rows(name, table, ids, summed, "summed")
    if summed.dtype != torch.float32:
        raise ValueError(f"{name}: summed must be f32, got {summed.dtype}")
    _check_lr(name, table, lr)
    if not on_card:
        return scatter_set_update_ref(
            table, ids, base, summed, lr=lr, clip_val=clip_val, l2=l2
        )
    m = ids.shape[0]
    if m == 0:
        return table
    n, d = table.shape
    _build.launch(
        _SET_UPDATE[table.dtype], name, table.device.index,
        table.data_ptr(), n, d, ids.data_ptr(), base.data_ptr(),
        int(base.dtype == torch.bfloat16), summed.data_ptr(), m,
        lr.data_ptr(), clip_val, l2,
    )
    count_launch(LAUNCHES, name, table)
    return table
