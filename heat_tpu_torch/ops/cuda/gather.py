"""Row gather (K2, with its multi-table entry), fused history-mean gather
(K1) and block gather (S2).

The counterparts of ``heat_tpu/ops/pallas/gather.py`` and of
``gather_blocks`` in ``scripts/profile_exact_ceiling.py``, for f32 and
bf16 tables (one kernel instance per type). Each public
function checks the kernel's contract (dtypes, shapes, contiguity, one
device) and then dispatches on where its tensors lie: on the CPU it runs
the plain PyTorch version beside it (``*_ref``); on a CUDA device it
launches the hand-written kernel of ``heat_tpu_torch/csrc/gather.cu`` (K1,
K2) or ``csrc/blocks.cu`` (S2) or raises. There is no fallback from a CUDA
tensor to the plain version.

``LAUNCHES`` counts kernel launches per function, so a run can show that
its main path went through the kernels: ``LAUNCHES[name]`` counts every
launch of the wrapper ``name`` and ``LAUNCHES[name + "_bf16"]`` those of
them that ran the bf16 instance (for ``gather_rows_multi``: a launch with
at least one bf16 table).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from heat_tpu_torch.ops.cuda import _build

LAUNCHES = {
    name + suffix: 0
    for name in ("gather_rows", "gather_rows_multi", "history_mean_gather",
                 "gather_blocks")
    for suffix in ("", "_bf16")
}

# The most (table, ids) pairs one launch of gather_rows_multi takes, and the
# int64 fields a pair is passed to the C entry point as.
MAX_SEGMENTS = 8
_SEGMENT_FIELDS = 8

# Table dtype -> suffix of the C entry points (heat_<kernel>_<suffix>).
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def symbols(kernel: str) -> dict:
    """Table dtype -> C entry point of ``kernel``, made once per wrapper so
    that a launch formats no string."""
    return {dtype: f"heat_{kernel}_{suffix}" for dtype, suffix in SUFFIX.items()}


_GATHER_ROWS = symbols("gather_rows")
_GATHER_BLOCKS = symbols("gather_blocks")
_HISTORY_MEAN = symbols("history_mean")


def _inside(ids: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids clamped into [0, n), whether each id was inside) as int64: the
    kernels' contract reads no id outside the table."""
    idx = ids.long()
    inside = (idx >= 0) & (idx < n)
    return idx.clamp(0, max(n - 1, 0)), inside


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: out[j] = table[ids[j]], and
    zeros for an id outside [0, N) (the kernel's contract)."""
    n = table.shape[0]
    if n == 0:
        return table.new_zeros((ids.shape[0], table.shape[1]))
    idx, inside = _inside(ids, n)
    return table.index_select(0, idx).masked_fill_(~inside[:, None], 0)


def gather_rows_multi_ref(
    segments: Sequence[tuple[torch.Tensor, torch.Tensor]],
    out_dtype: torch.dtype | None = None,
) -> list[torch.Tensor]:
    """Plain version of :func:`gather_rows_multi`: one
    :func:`gather_rows_ref` and one cast per (table, ids) pair."""
    return [
        gather_rows_ref(table, ids).to(table.dtype if out_dtype is None else out_dtype)
        for table, ids in segments
    ]


def history_mean_gather_ref(
    table: torch.Tensor, his_ids: torch.Tensor, lens: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`history_mean_gather`.

    With ``rows`` it first selects ``his_ids[rows]`` and ``lens[rows]`` (a
    row outside the history table gets length 0). Then it materializes the
    (B, H, d) gather cast to ``out_dtype``, masks positions h >= lens[b],
    sums in f32, divides once by max(lens, 1) and rounds once to
    ``out_dtype``; empty histories give 0. An id outside the table is
    left out of the sum, which still divides by the whole length.
    """
    out_dtype = table.dtype if out_dtype is None else out_dtype
    if rows is not None:
        u = his_ids.shape[0]
        idx = rows.long()
        if u == 0:
            return torch.zeros((idx.shape[0], table.shape[1]), dtype=out_dtype,
                               device=table.device)
        inside = (idx >= 0) & (idx < u)
        idx = idx.clamp(0, u - 1)
        his_ids = his_ids.index_select(0, idx)
        lens = torch.where(inside, lens.index_select(0, idx), 0)
    b, h = his_ids.shape
    # An id outside the table is left out of the sum (the kernel's
    # contract); the mean still divides by the whole length.
    gathered = gather_rows_ref(table, his_ids.reshape(-1))
    gathered = gathered.reshape(b, h, table.shape[1])
    valid = torch.arange(h, device=lens.device)[None, :] < lens[:, None]
    total = (gathered.to(out_dtype).float() * valid[:, :, None]).sum(1)
    denom = torch.clamp(lens.float(), min=1.0)
    return (total / denom[:, None]).to(out_dtype)


def gather_blocks_ref(
    table: torch.Tensor, block_ids: torch.Tensor, r: int
) -> torch.Tensor:
    """Plain version of :func:`gather_blocks`: ``index_select`` on the
    (N / r, r * d) view of the table, zeros for a block id outside it."""
    n, d = table.shape
    blocks = gather_rows_ref(table.view(n // r, r * d), block_ids)
    return blocks.view(-1, d)


def count_launch(launches: dict, name: str, table: torch.Tensor) -> None:
    """One launch of wrapper ``name`` on ``table``'s kernel instance."""
    launches[name] += 1
    if table.dtype == torch.bfloat16:
        launches[name + "_bf16"] += 1


def _check(name: str, table: torch.Tensor, *int_tensors: torch.Tensor) -> bool:
    """Validate the kernel contract on either device, so that the CPU tests
    catch what the card would refuse. Returns True for CUDA tensors, False
    for CPU tensors; raises for mixed or other devices."""
    device = table.device
    kind = device.type
    if kind != "cuda" and kind != "cpu":
        raise ValueError(f"{name}: needs CUDA or CPU tensors, got {device}")
    if table.dtype not in SUFFIX:
        raise ValueError(
            f"{name}: needs an f32 or bf16 table, got {table.dtype}"
        )
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous (N, d) table")
    for t in int_tensors:
        if t.device != device:
            raise ValueError(f"{name}: all tensors must be on {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: ids must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: ids must be contiguous")
    return kind == "cuda"


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[j] = table[ids[j]]. table: (N, d) f32 or bf16; ids: (M,) int32
    in [0, N). Returns a new (M, d) tensor of the table's type."""
    on_card = _check("gather_rows", table, ids)
    if ids.dim() != 1:
        raise ValueError("gather_rows: ids must be 1-D")
    if not on_card:
        return gather_rows_ref(table, ids)
    n, d = table.shape
    m = ids.shape[0]
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if m == 0:
        return out
    _build.launch(
        _GATHER_ROWS[table.dtype], "gather_rows", table.device.index,
        table.data_ptr(), n, d, ids.data_ptr(), m, out.data_ptr(),
    )
    count_launch(LAUNCHES, "gather_rows", table)
    return out


_SegmentArray = ctypes.c_int64 * (MAX_SEGMENTS * _SEGMENT_FIELDS)


def gather_rows_multi(
    segments: Sequence[tuple[torch.Tensor, torch.Tensor]],
    out_dtype: torch.dtype | None = None,
    outs: Sequence[torch.Tensor | None] | None = None,
) -> list[torch.Tensor]:
    """The row gathers of up to ``MAX_SEGMENTS`` (table, ids) pairs in one
    launch: ``out[i][j] = table_i[ids_i[j]]`` cast to ``out_dtype``.

    Each table is (N_i, d_i) f32 or bf16 and each ids (M_i,) int32, all on
    one device; tables may repeat and differ in type and width. ``out_dtype``
    is f32, bf16 or None for each table's own type; the cast happens inside
    the kernel (bf16 to f32 exact, f32 to bf16 round to nearest even), so
    every output is bit-equal to ``gather_rows(table, ids).to(out_dtype)``.
    An id outside [0, N_i) writes zeros. ``outs``: optional tensors to
    write into, one a segment (None for a new one), each a contiguous
    (M_i, d_i) tensor of the output type on the device. Returns the
    (M_i, d_i) outputs in the order of ``segments``.
    """
    name = "gather_rows_multi"
    segments = list(segments)
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(
            f"{name}: at most {MAX_SEGMENTS} segments a launch, got {len(segments)}"
        )
    if out_dtype is not None and out_dtype not in SUFFIX:
        raise ValueError(f"{name}: out_dtype must be f32 or bf16, got {out_dtype}")
    if not segments:
        return []
    device = segments[0][0].device
    on_card = False
    for table, ids in segments:
        if table.device != device:
            raise ValueError(f"{name}: all tensors must be on {device}")
        on_card = _check(name, table, ids)
        if ids.dim() != 1:
            raise ValueError(f"{name}: ids must be 1-D")
    given = [None] * len(segments) if outs is None else list(outs)
    if len(given) != len(segments):
        raise ValueError(f"{name}: {len(given)} outs for {len(segments)} segments")
    for (table, ids), out in zip(segments, given):
        if out is None:
            continue
        dtype = table.dtype if out_dtype is None else out_dtype
        if (out.device != device or out.dtype != dtype or not out.is_contiguous()
                or out.shape != (ids.shape[0], table.shape[1])):
            raise ValueError(
                f"{name}: an out must be a contiguous ({ids.shape[0]}, "
                f"{table.shape[1]}) {dtype} tensor on {device}")
    if not on_card:
        return [res if out is None else out.copy_(res) for res, out in
                zip(gather_rows_multi_ref(segments, out_dtype), given)]
    outs, fields, any_bf16 = [], [], False
    for (table, ids), out in zip(segments, given):
        n, d = table.shape
        m = ids.shape[0]
        dtype = table.dtype if out_dtype is None else out_dtype
        if out is None:
            out = torch.empty((m, d), dtype=dtype, device=device)
        outs.append(out)
        bf16 = table.dtype == torch.bfloat16
        any_bf16 |= bf16
        fields += (table.data_ptr(), n, d, int(bf16), ids.data_ptr(), m,
                   out.data_ptr(), int(dtype == torch.bfloat16))
    if not any(out.numel() for out in outs):
        return outs
    _build.launch(
        "heat_gather_rows_multi", name, device.index,
        _SegmentArray(*fields), len(segments),
    )
    LAUNCHES[name] += 1
    if any_bf16:
        LAUNCHES[name + "_bf16"] += 1
    return outs


def gather_blocks(
    table: torch.Tensor, block_ids: torch.Tensor, r: int
) -> torch.Tensor:
    """``r`` contiguous rows per id:
    ``out[k*r:(k+1)*r] = table[ids[k]*r:(ids[k]+1)*r]``.

    table: (N, d) f32 or bf16 with N % r == 0; block_ids: (M,) int32 in
    [0, N / r). Returns a new (M * r, d) tensor of the table's type.
    """
    on_card = _check("gather_blocks", table, block_ids)
    if block_ids.dim() != 1:
        raise ValueError("gather_blocks: block_ids must be 1-D")
    n, d = table.shape
    if r < 1 or n % r:
        raise ValueError(
            f"gather_blocks: the table's {n} rows are not a multiple of r = {r}"
        )
    if not on_card:
        return gather_blocks_ref(table, block_ids, r)
    m = block_ids.shape[0]
    out = torch.empty((m * r, d), dtype=table.dtype, device=table.device)
    if m == 0:
        return out
    _build.launch(
        _GATHER_BLOCKS[table.dtype], "gather_blocks", table.device.index,
        table.data_ptr(), n // r, r * d, block_ids.data_ptr(), m, out.data_ptr(),
    )
    count_launch(LAUNCHES, "gather_blocks", table)
    return out


# The history splits the kernel has instances for; 0 lets the C side choose
# from the work (csrc/gather.cu, pick_split).
SPLITS = (0, 1, 2, 4)


def history_mean_gather(
    table: torch.Tensor, his_ids: torch.Tensor, lens: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    *,
    rows: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    split: int = 0,
) -> torch.Tensor:
    """Masked mean of table[his_ids[b, :lens[b]]] rows, fused with the
    gather. table: (N, d) f32 or bf16; his_ids: (U, H) int32; lens: (U,)
    int32; out_dtype: f32 or bf16 (the type of ``out``, else the table's,
    when None). The rows are cast to ``out_dtype``, summed in f32 and
    rounded once: (B, d) means (zero where lens == 0), matching
    ``models.aggregator.history_mean_fused``.

    rows: optional (B,) int32: sample ``b`` pools the history
      ``his_ids[rows[b]]``, ``lens[rows[b]]``, read inside the kernel (a row
      outside [0, U) pools to zero). None pools every history: B = U.
    out: optional contiguous (B, d) tensor of the output type on the
      table's device to write into; returned.
    split: over how many lane groups of a warp a history is split on the
      card (``SPLITS``; 0 picks from the work). The order of the f32 sum depends on the valid
      length and the split only: one split gives one user's mean the same
      bits at any position of any batch; two splits agree to the rounding
      of an f32 sum (at most H * 2^-24 * sum|x| / len before the final
      rounding). The plain version ignores it.
    """
    name = "history_mean_gather"
    ints = (his_ids, lens) if rows is None else (his_ids, lens, rows)
    on_card = _check(name, table, *ints)
    if out_dtype is None:
        out_dtype = table.dtype if out is None else out.dtype
    if out_dtype not in SUFFIX:
        raise ValueError(f"{name}: out_dtype must be f32 or bf16, got {out_dtype}")
    if his_ids.dim() != 2 or lens.shape != (his_ids.shape[0],):
        raise ValueError(
            f"{name}: his_ids must be (U, H) and lens (U,), got "
            f"{tuple(his_ids.shape)} and {tuple(lens.shape)}"
        )
    if rows is not None and rows.dim() != 1:
        raise ValueError(f"{name}: rows must be 1-D")
    if split not in SPLITS:
        raise ValueError(f"{name}: split must be one of {SPLITS}, got {split}")
    n, d = table.shape
    u, h = his_ids.shape
    b = u if rows is None else rows.shape[0]
    if out is not None:
        if out.device != table.device:
            raise ValueError(f"{name}: all tensors must be on {table.device}")
        if out.dtype != out_dtype:
            raise ValueError(
                f"{name}: out is {out.dtype}, but out_dtype is {out_dtype}"
            )
        if out.shape != (b, d) or not out.is_contiguous():
            raise ValueError(
                f"{name}: out must be a contiguous ({b}, {d}) tensor, got "
                f"shape {tuple(out.shape)}"
            )
    if not on_card:
        means = history_mean_gather_ref(table, his_ids, lens, out_dtype, rows)
        return means if out is None else out.copy_(means)
    if out is None:
        out = torch.empty((b, d), dtype=out_dtype, device=table.device)
    if b == 0:
        return out
    _build.launch(
        _HISTORY_MEAN[table.dtype], name, table.device.index,
        table.data_ptr(), n, d, his_ids.data_ptr(), lens.data_ptr(),
        None if rows is None else rows.data_ptr(), u, b, h,
        out.data_ptr(), int(out_dtype == torch.bfloat16), split,
    )
    count_launch(LAUNCHES, name, table)
    return out
