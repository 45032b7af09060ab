"""Duplicate-safe sparse row updates for embedding tables.

Counterpart of ``heat_tpu/train/scatter.py``. A batch holds repeated ids,
so gradients are combined per unique row before the clip. Two
implementations, picked per table by its row count
(``table.shape[0] <= DENSE_ROWS_THRESHOLD``, read at call time):

* dense accumulator: scatter-add every occurrence's gradient into a zeroed
  table-shaped f32 accumulator (kernel K3; duplicates add), then one dense
  elementwise update. Untouched rows see clip(0) == 0 and are unchanged.
* sort-dedup, for huge tables where an O(rows) pass per step is too much:
  stable-sort the ids, sum each run of equal ids into one of M segments
  (K3 into an (M, d) buffer) and update one representative row per run.
  Batch-mode SGD is one launch from the segment sums on: K3's update entry
  (``scatter_add_update``: l2, clip, ``-lr`` and the rounding inside the
  kernel) or, with the user write-back fused in, S1's
  (``scatter_set_update``). The optimizer slots and the accum rows are
  written with the plain row scatter-set S1. It is shape-static like the
  JAX version: M segments, and the unused tail has ``rep_ids ==
  num_rows``, which every scatter drops.

On a mesh the row count is the shard's, the rows one card holds, since
the dense accumulator's cost is that card's memory and time; the JAX
package picks by the global table's rows (``table.shape[0]`` under GSPMD),
so a shard at or below the threshold of a table above it takes the dense
path here and the sort-dedup path there. The two paths compute the same
update in another order of sums. A shard whose rows take gradients from
every rank of its group is updated by :func:`apply_row_updates_reduced`
(dense: one all-reduce of a shard-sized buffer) or
:func:`apply_row_updates_sorted_reduced` (sort-dedup: one all-gather of
the occurrences, the update on the group's first rank, its rows shared).

Besides: the per-occurrence ``direct`` update, row-sparse Adagrad and lazy
Adam (``apply_row_updates_opt``), ``dense_opt_update`` for ``w0``, the l2
term on touched rows and the accum mode's persistent gradient rows.

In-place contract: every function here updates ``table``, ``gacc`` and
the optimizer slot tables IN PLACE and returns them (the JAX package
donates them to its step program instead). A caller that needs the old
values clones them first. The dense path's accumulator is table-sized, as
in JAX (a shard's on a mesh); the sorted and direct paths allocate only
(M, d) buffers and never copy a table. On the card nothing here waits for
the host: no ``torch.unique``, no boolean-mask indexing, no ``.item()``.

Ids equal to the table size mark weight-0 padding and are dropped, as
JAX's ``mode="drop"`` does.

Tables (and the accum mode's gradient rows) are f32 or bf16; gradients,
segment sums, the dense accumulator and the optimizer slots are always
f32. A bf16 table is rounded to where the JAX package rounds: the step
``lr * g`` (or the new row ``base - lr * g``) is computed in f32, cast to
the table's type, and then added (or written) in that type. Gradient rows
may arrive in the compute type (bf16): they are widened where they are
first read (exactly), never by a pass of their own on the ``direct`` path.
"""

from __future__ import annotations

from typing import Optional

import torch

from heat_tpu_torch.models.aggregator import scalar_in
from heat_tpu_torch.ops.cuda.gather import gather_rows
from heat_tpu_torch.ops.cuda.scatter import (
    scatter_add_rows,
    scatter_add_update,
    scatter_set_rows,
    scatter_set_update,
)

# Tables at or below this row count use the dense-accumulator path; above
# it, the sort-dedup path (dense cost is O(rows * dim) per step).
DENSE_ROWS_THRESHOLD = 4 * 1024 * 1024


# --- sort-dedup --------------------------------------------------------


def _sort_segments(ids: torch.Tensor, num_rows: int):
    """(order, seg, rep_ids) of a stable sort of ``ids``: the sort order,
    the segment of each sorted occurrence (int64) and each segment's id
    (``num_rows`` for the unused tail)."""
    m = ids.shape[0]
    sid, order = torch.sort(ids, stable=True)
    starts = torch.ones(m, dtype=torch.bool, device=ids.device)
    starts[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(starts, 0) - 1
    rep_ids = torch.full_like(ids, num_rows).scatter_(0, seg, sid)
    return order, seg, rep_ids


def _segment_sum(order, seg, values: torch.Tensor) -> torch.Tensor:
    """(M, d) per-segment sums of ``values`` (rows in input order), by K3
    over each occurrence's segment: the sorted copy is never built."""
    seg_of = torch.empty(
        seg.shape, dtype=torch.int32, device=seg.device
    ).scatter_(0, order, seg.to(torch.int32))
    summed = torch.zeros(values.shape, dtype=torch.float32, device=values.device)
    return scatter_add_rows(summed, seg_of, values.float().contiguous())


def segment_sum_by_id(
    ids: torch.Tensor, values: torch.Tensor, num_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine rows of ``values`` that share an id.

    Args:
      ids: (M,) int32 row ids; ids == num_rows mark padding to drop.
      values: (M, d) per-occurrence values.
      num_rows: table size (the drop sentinel).

    Returns:
      (rep_ids, summed), both of length M: ``summed[s]`` is the total for
      unique id ``rep_ids[s]``; unused trailing segments have rep_ids ==
      num_rows and summed == 0.
    """
    order, seg, rep_ids = _sort_segments(ids, num_rows)
    return rep_ids, _segment_sum(order, seg, values)


def _sorted_dedup_with_base(ids, grads, num_rows, writeback):
    """Sorted dedup that also picks each unique id's write-back row (the
    first occurrence in sorted order). Returns (rep_ids, summed, base),
    ``base`` in the write-back's type."""
    m = ids.shape[0]
    order, seg, rep_ids = _sort_segments(ids, num_rows)
    summed = _segment_sum(order, seg, grads)
    first_pos = torch.full(
        (m,), m - 1, dtype=torch.int64, device=ids.device
    ).scatter_reduce_(
        0, seg, torch.arange(m, device=ids.device), "amin"
    )
    base = writeback.index_select(0, order[first_pos])
    return rep_ids, summed, base


def _valid(rep_ids: torch.Tensor, num_rows: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (rep_ids < num_rows).to(dtype)[:, None]


def _read(table: torch.Tensor, rep_ids: torch.Tensor) -> torch.Tensor:
    """Rows table[min(rep_ids, N - 1)] (K2), in the table's type: the
    sentinel slots read the last row, and their results are masked or
    dropped."""
    return gather_rows(table, rep_ids.clamp(max=table.shape[0] - 1))


def _apply_row_updates_sorted(
    table, ids, grads, *, lr, clip_val, gacc, decay, l2, writeback=None
):
    """Sort-dedup path for huge tables: O(M log M), no O(rows) pass."""
    num_rows = table.shape[0]
    if writeback is not None:
        # Fused write-back + update, l2 against the written-back rows: one
        # launch of S1's update entry in all.
        rep_ids, summed, base = _sorted_dedup_with_base(
            ids, grads, num_rows, writeback
        )
        scatter_set_update(table, rep_ids, base, summed, lr=lr,
                           clip_val=clip_val, l2=l2)
        return table, None
    rep_ids, summed = segment_sum_by_id(ids, grads, num_rows)
    if gacc is None:
        # l2 against the table's own rows (in the table's type), then the
        # clip: K3's update entry reads each representative row itself.
        scatter_add_update(table, rep_ids, summed, lr=lr, clip_val=clip_val,
                           l2=l2, clip_first=False)
        return table, None
    if l2:
        rows = _read(table, rep_ids)
        summed = summed + (
            scalar_in(l2, rows.dtype) * rows * _valid(rep_ids, num_rows, rows.dtype)
        )
    acc_rows = _read(gacc, rep_ids) * _valid(rep_ids, num_rows, gacc.dtype)
    acc_new = torch.clamp(
        scalar_in(decay, gacc.dtype) * acc_rows + summed, -clip_val, clip_val
    )
    scatter_add_rows(table, rep_ids, (-lr * acc_new).to(table.dtype))
    scatter_set_rows(gacc, rep_ids, acc_new)
    return table, gacc


def _write_rows(table, rep_ids, upd, lr, base) -> None:
    """table[rep] -= lr * upd (K3), or table[rep] = base - lr * upd when
    the write-back is fused (S1)."""
    if base is None:
        scatter_add_rows(table, rep_ids, (-lr * upd).to(table.dtype))
    else:
        scatter_set_rows(table, rep_ids, base - lr * upd)


def _apply_row_updates_opt_sorted(
    table, ids, grads, *, lr, clip_val, step, m, v, beta1, beta2, eps, l2,
    writeback=None,
):
    num_rows = table.shape[0]
    if writeback is None:
        rep_ids, summed = segment_sum_by_id(ids, grads, num_rows)
        base = None
    else:
        rep_ids, summed, base = _sorted_dedup_with_base(
            ids, grads, num_rows, writeback
        )
    valid = _valid(rep_ids, num_rows)
    if base is not None:
        base = base.float()
    if l2:
        rows = base if base is not None else _read(table, rep_ids).float()
        summed = summed + l2 * rows * valid
    g = torch.clamp(summed, -clip_val, clip_val) * valid
    if m is None:  # adagrad
        new_v_rows = _read(v, rep_ids) + g * g
        _write_rows(table, rep_ids, g / (torch.sqrt(new_v_rows) + eps), lr, base)
        scatter_set_rows(v, rep_ids, new_v_rows)
        return table, None, v
    t = step.to(torch.float32)
    new_m_rows = beta1 * _read(m, rep_ids) + (1.0 - beta1) * g
    new_v_rows = beta2 * _read(v, rep_ids) + (1.0 - beta2) * g * g
    m_hat = new_m_rows / (1.0 - beta1**t)
    v_hat = new_v_rows / (1.0 - beta2**t)
    upd = m_hat / (torch.sqrt(v_hat) + eps) * valid
    _write_rows(table, rep_ids, upd, lr, base)
    scatter_set_rows(m, rep_ids, new_m_rows)
    scatter_set_rows(v, rep_ids, new_v_rows)
    return table, m, v


# --- dense accumulator -------------------------------------------------


def _dense_acc(table, ids, grads) -> torch.Tensor:
    acc = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    return scatter_add_rows(acc, ids, grads.float().contiguous())


def _touched(table, ids) -> torch.Tensor:
    """(N, 1) f32: how many times ``ids`` names each row (the passes
    clamp it to 1)."""
    touched = torch.zeros(
        (table.shape[0], 1), dtype=torch.float32, device=table.device
    )
    ones = torch.ones((ids.shape[0], 1), dtype=torch.float32, device=ids.device)
    return scatter_add_rows(touched, ids, ones)


def _apply_row_updates_dense(table, ids, grads, *, lr, clip_val, gacc, decay, l2):
    """Dense-accumulator path: no sort; duplicates combine in K3."""
    acc = _dense_acc(table, ids, grads)
    touched = _touched(table, ids) if l2 or gacc is not None else None
    return _dense_update(table, acc, touched, lr=lr, clip_val=clip_val,
                         gacc=gacc, decay=decay, l2=l2)


def _dense_update(table, acc, touched, *, lr, clip_val, gacc, decay, l2):
    """The dense SGD pass from the combined row gradients ``acc`` (N, d)
    f32 and the (N, 1) touched counts (needed under l2 and accum),
    in place; ``acc`` is consumed."""
    if touched is not None:
        touched = touched.clamp_(max=1.0)
    if l2:
        acc += l2 * table.float() * touched
    if gacc is None:
        table.sub_((lr * acc.clamp_(-clip_val, clip_val)).to(table.dtype))
        return table, None
    new_acc = torch.clamp(
        scalar_in(decay, gacc.dtype) * gacc + acc, -clip_val, clip_val
    )
    gacc.copy_(torch.where(touched > 0, new_acc, gacc))
    table.sub_((lr * new_acc * touched).to(table.dtype))
    return table, gacc


def apply_row_updates_reduced(
    table: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr: torch.Tensor,
    clip_val: float,
    l2: float,
    reduce,
    extra: torch.Tensor,
    gacc: Optional[torch.Tensor] = None,
    decay: float = 1.0,
    opt: Optional[dict] = None,
) -> torch.Tensor:
    """The dense update of one shard of a table whose rows take gradients
    from every rank of a group (the item table on a mesh), with one
    collective in it, in place: batch-mode SGD, accum mode (``gacc``,
    ``decay``) or, with ``opt`` (the keywords of
    :func:`apply_row_updates_opt` but the table's: ``step``, ``m``, ``v``,
    ``beta1``, ``beta2``, ``eps``), Adagrad / Adam.

    The rank's gradient rows go into a shard-sized f32 accumulator (K3;
    ids outside the shard are out of range and dropped), the touched-row
    counts after it (K3 again; under l2, accum and the slots, whose
    passes read them), and ``extra`` (a flat f32 tensor of other sums the
    group reduces, such as ``w0``'s gradient) after those, all in one
    buffer; ``reduce(buf)`` sums the buffer in place over the group, so
    every replica then holds the combined row gradient of the whole batch
    and every row some rank touched counts as touched on every replica
    (a rank-local mask would leave Adam's moments, and the accum rows,
    apart between replicas). The single-rank dense pass of the rule
    follows, on equal inputs on every replica, which end bit-equal.
    Returns the reduced ``extra``."""
    n, d = table.shape
    e = extra.numel()
    counts = bool(l2) or gacc is not None or opt is not None
    size = n * d + (n if counts else 0) + e
    buf = torch.zeros(size, dtype=torch.float32, device=table.device)
    acc = buf[: n * d].view(n, d)
    scatter_add_rows(acc, ids, grads.float().contiguous())
    touched = None
    if counts:
        touched = buf[n * d: n * d + n].view(n, 1)
        ones = torch.ones((ids.shape[0], 1), dtype=torch.float32,
                          device=ids.device)
        scatter_add_rows(touched, ids, ones)
    buf[size - e:].copy_(extra.reshape(-1))
    reduce(buf)
    if opt is not None:
        _opt_dense_update(table, acc, touched, lr=lr, clip_val=clip_val,
                          l2=l2, **opt)
    else:
        _dense_update(table, acc, touched, lr=lr, clip_val=clip_val,
                      gacc=gacc, decay=decay, l2=l2)
    return buf[size - e:]


def apply_row_updates_sorted_reduced(
    table: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr: torch.Tensor,
    clip_val: float,
    l2: float,
    gather,
    share,
    first: bool,
    extra: torch.Tensor,
    tile_ids: Optional[torch.Tensor] = None,
    tile_grads: Optional[torch.Tensor] = None,
    compute: torch.dtype = torch.float32,
    gacc: Optional[torch.Tensor] = None,
    decay: float = 1.0,
    opt: Optional[dict] = None,
) -> torch.Tensor:
    """The sort-dedup counterpart of :func:`apply_row_updates_reduced`, for
    a shard above DENSE_ROWS_THRESHOLD rows whose replicas (a group of
    ranks) take occurrences from every rank of the group, in place: batch
    mode, accum mode or, with ``opt``, Adagrad / Adam. No table-sized
    buffer.

    Each rank packs its occurrences (``ids`` (M,) int32 shard-local, the
    table size for the dropped ones; ``grads`` (M, d), widened to f32),
    its part of the tile's (T, d) f32 gradient (``tile_grads``, for the T
    slots ``tile_ids`` every rank shares) and ``extra`` into one byte
    buffer, ``4 * ((M + T) * d + e + M)`` bytes, which one all-gather
    over the group sends to every rank (``gather(buf)``: every rank's
    buffer in index order). The tiles' parts and the extras are summed in
    that order on every rank (bit-equal sums everywhere; the tile's
    rounded once to ``compute``, as one rank's gradient is). The group's
    first rank (``first``) then sorts the group's occurrences and the
    tile slots, sums each id's run (K3 into (n M + T, d) f32) and
    updates one row per id, the clip on the combined row of the whole
    group's batch (:func:`_apply_row_updates_sorted`,
    :func:`_apply_row_updates_opt_sorted`); ``share(tables, ids)`` then
    makes those rows of the table, and of its accum rows or slots, on
    every other rank the first rank's: every rank sorts the gathered ids
    and sends the first min(n M + T, rows) distinct ids, in which every
    touched row lies. K3 adds repeated ids in no fixed
    order on the card, so replicas that each applied the update could
    part; after the share they are bit-equal by construction. Returns the
    summed ``extra``.

    The dense path sums every occurrence into a table-sized accumulator
    in K3's order; this path sums each id's run in the order of the
    sorted occurrences: the same update up to the order of its sums."""
    m, d = grads.shape
    t = 0 if tile_ids is None else tile_ids.shape[0]
    e = extra.numel()
    nf = (m + t) * d + e
    buf = torch.empty(4 * (nf + m), dtype=torch.uint8, device=table.device)
    floats = buf[: 4 * nf].view(torch.float32)
    floats[: m * d].view(m, d).copy_(grads)
    if t:
        floats[m * d: (m + t) * d].view(t, d).copy_(tile_grads)
    floats[(m + t) * d:].copy_(extra.reshape(-1))
    buf[4 * nf:].view(torch.int32).copy_(ids)
    parts = gather(buf)
    sums = parts[0][4 * m * d: 4 * nf].view(torch.float32).clone()
    for p in parts[1:]:
        sums += p[4 * m * d: 4 * nf].view(torch.float32)
    all_ids = torch.cat([p[4 * nf:].view(torch.int32) for p in parts]
                        + ([tile_ids] if t else []))
    if first:
        all_grads = [p[: 4 * m * d].view(torch.float32).view(m, d)
                     for p in parts]
        if t:
            all_grads.append(sums[: t * d].view(t, d).to(compute))
        all_grads = torch.cat(all_grads)
        if opt is not None:
            _apply_row_updates_opt_sorted(table, all_ids, all_grads, lr=lr,
                                          clip_val=clip_val, l2=l2, **opt)
        else:
            _apply_row_updates_sorted(table, all_ids, all_grads, lr=lr,
                                      clip_val=clip_val, gacc=gacc,
                                      decay=decay, l2=l2)
    # The touched rows: every distinct id, within the first min(ids, rows)
    # entries of the sorted ids' representatives (the sentinel's last).
    rep_ids = _sort_segments(all_ids, table.shape[0])[2]
    slots = [] if opt is None else [opt["v"], opt.get("m")]
    share([table, gacc, *slots],
          rep_ids[: min(rep_ids.shape[0], table.shape[0])])
    return sums[t * d:]


def _apply_row_updates_opt_dense(
    table, ids, grads, *, lr, clip_val, step, m, v, beta1, beta2, eps, l2
):
    return _opt_dense_update(
        table, _dense_acc(table, ids, grads), _touched(table, ids), lr=lr,
        clip_val=clip_val, step=step, m=m, v=v, beta1=beta1, beta2=beta2,
        eps=eps, l2=l2)


def _opt_dense_update(table, acc, touched, *, lr, clip_val, step, m, v,
                      beta1, beta2, eps, l2):
    """The dense Adagrad / Adam pass from the combined row gradients
    ``acc`` and the (N, 1) touched counts, in place; ``acc`` is
    consumed."""
    touched = touched.clamp_(max=1.0)
    if l2:
        acc += l2 * table.float() * touched
    g = acc.clamp_(-clip_val, clip_val)
    if m is None:  # adagrad: untouched rows have g == 0, v unchanged
        v += g * g
        table.sub_((lr * (g / (torch.sqrt(v) + eps) * touched)).to(table.dtype))
        return table, None, v
    t = step.to(torch.float32)
    hit = touched > 0
    m.copy_(torch.where(hit, beta1 * m + (1.0 - beta1) * g, m))
    v.copy_(torch.where(hit, beta2 * v + (1.0 - beta2) * g * g, v))
    m_hat = m / (1.0 - beta1**t)
    v_hat = v / (1.0 - beta2**t)
    upd = m_hat / (torch.sqrt(v_hat) + eps) * touched
    table.sub_((lr * upd).to(table.dtype))
    return table, m, v


# --- public updates ----------------------------------------------------


def apply_row_updates(
    table: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr: torch.Tensor,
    clip_val: float,
    gacc: Optional[torch.Tensor] = None,
    decay: float = 1.0,
    l2: float = 0.0,
    writeback: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SGD row update with an elementwise clip, in place.

    Batch mode (gacc is None):
        g = clip(sum_per_unique(grads) [+ l2 * row]);  row -= lr * g
    Accum mode (the reference's persistent gradient rows):
        acc_new = clip(decay * acc + sum_per_unique(grads));
        row -= lr * acc_new;  acc stored clipped.
    ``decay`` is gamma for the user table, 1.0 for the item table.

    writeback: optional (M, d) rows written to ``table[ids]`` BEFORE
    the update (the user table's aggregated-row write-back). Repeated ids
    carry identical rows: every read of a batched step sees the
    batch-start tables. On the sorted path it fuses with the update into
    one scatter-set. Batch mode only.

    ids: (M,) int32; ids == table.shape[0] are padding and are dropped.
    Returns (table, gacc), both updated in place.
    """
    if writeback is not None and gacc is not None:
        raise ValueError("writeback fusion is batch-mode only (gacc=None)")
    if table.shape[0] <= DENSE_ROWS_THRESHOLD:
        if writeback is not None:
            scatter_set_rows(table, ids, writeback)
        return _apply_row_updates_dense(
            table, ids, grads, lr=lr, clip_val=clip_val, gacc=gacc,
            decay=decay, l2=l2,
        )
    return _apply_row_updates_sorted(
        table, ids, grads, lr=lr, clip_val=clip_val, gacc=gacc,
        decay=decay, l2=l2, writeback=writeback,
    )


def apply_row_updates_direct(
    table: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr: torch.Tensor,
    clip_val: float,
    l2: float = 0.0,
    rows: Optional[torch.Tensor] = None,
    writeback: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-occurrence SGD (``update_mode: direct``), in place: the
    write-back (S1), then one launch of K3's update entry that adds every
    occurrence's ``-lr * (clip(g) [+ l2 * row])``. The two stay two
    launches: every write-back of a row must land before any add to it,
    and the blocks of one kernel run in no order. The clip binds per
    occurrence, not on the combined row; l2 reads the forward-pass
    ``rows`` (the aggregated rows for the user table). Returns
    ``table``."""
    if l2 and rows is None:
        raise ValueError("l2 under update_mode='direct' needs rows")
    if writeback is not None:
        scatter_set_rows(table, ids, writeback)
    return scatter_add_update(
        table, ids, grads.contiguous(), lr=lr, clip_val=clip_val, l2=l2,
        rows=rows.contiguous() if l2 else None, clip_first=True,
    )


def dense_opt_update(
    param: torch.Tensor,
    g: torch.Tensor,
    slots: dict,
    name: str,
    *,
    lr: torch.Tensor,
    step: torch.Tensor,
    beta1: float,
    beta2: float,
    eps: float,
) -> tuple[torch.Tensor, dict]:
    """Adagrad/Adam update of a dense parameter like ``w0``.

    ``slots`` holds "{name}_v" (and "{name}_m" for Adam); returns the new
    parameter and a new slot dict (nothing is updated in place: the
    caller gates the result on the batch holding real samples). ``step``
    is the 1-based step of Adam's bias correction.
    """
    g = g.float()
    new_slots = dict(slots)
    if f"{name}_m" in slots:  # adam
        t = step.to(torch.float32)
        m = beta1 * slots[f"{name}_m"] + (1.0 - beta1) * g
        v = beta2 * slots[f"{name}_v"] + (1.0 - beta2) * g * g
        m_hat = m / (1.0 - beta1**t)
        v_hat = v / (1.0 - beta2**t)
        upd = m_hat / (torch.sqrt(v_hat) + eps)
        new_slots[f"{name}_m"] = m
    else:  # adagrad
        v = slots[f"{name}_v"] + g * g
        upd = g / (torch.sqrt(v) + eps)
    new_slots[f"{name}_v"] = v
    return param - lr * upd, new_slots


def apply_row_updates_opt(
    table: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr: torch.Tensor,
    clip_val: float,
    step: torch.Tensor,
    m: Optional[torch.Tensor],
    v: torch.Tensor,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    l2: float = 0.0,
    writeback: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Row-sparse Adagrad (m is None) / lazy Adam row update, in place.

    The duplicate-combine and clip of :func:`apply_row_updates`, feeding a
    moment-based transform. The moments are lazy: only touched rows update
    (untouched rows neither decay nor bias-correct); Adam's bias
    correction uses the 1-based global ``step``. ``writeback`` replaces
    ``table[ids]`` before the update (fused on the sorted path).

    Returns (table, m, v), updated in place.
    """
    kw = dict(lr=lr, clip_val=clip_val, step=step, m=m, v=v, beta1=beta1,
              beta2=beta2, eps=eps, l2=l2)
    if table.shape[0] <= DENSE_ROWS_THRESHOLD:
        if writeback is not None:
            scatter_set_rows(table, ids, writeback)
        return _apply_row_updates_opt_dense(table, ids, grads, **kw)
    return _apply_row_updates_opt_sorted(
        table, ids, grads, writeback=writeback, **kw
    )
