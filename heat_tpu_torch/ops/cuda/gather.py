"""Row gather (K2), fused history-mean gather (K1) and block gather (S2).

The counterparts of ``heat_tpu/ops/pallas/gather.py`` and of
``gather_blocks`` in ``scripts/profile_exact_ceiling.py``, for f32 and
bf16 tables (one kernel instance per type). Each public
function checks the kernel's contract (dtypes, shapes, contiguity, one
device) and then dispatches on where its tensors lie: on the CPU it runs
the plain PyTorch version beside it (``*_ref``); on a CUDA device it
launches the hand-written kernel of ``heat_tpu_torch/csrc/gather.cu`` or
raises. There is no fallback from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches per function, so a run can show that
its main path went through the kernels: ``LAUNCHES[name]`` counts every
launch of the wrapper ``name`` and ``LAUNCHES[name + "_bf16"]`` those of
them that ran the bf16 instance.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.ops.cuda import _build

LAUNCHES = {
    name + suffix: 0
    for name in ("gather_rows", "history_mean_gather", "gather_blocks")
    for suffix in ("", "_bf16")
}

# Table dtype -> suffix of the C entry points (heat_<kernel>_<suffix>).
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def symbols(kernel: str) -> dict:
    """Table dtype -> C entry point of ``kernel``, made once per wrapper so
    that a launch formats no string."""
    return {dtype: f"heat_{kernel}_{suffix}" for dtype, suffix in SUFFIX.items()}


_GATHER_ROWS = symbols("gather_rows")
_GATHER_BLOCKS = symbols("gather_blocks")
_HISTORY_MEAN = symbols("history_mean")


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: out[j] = table[ids[j]]."""
    return table.index_select(0, ids.long())


def history_mean_gather_ref(
    table: torch.Tensor, his_ids: torch.Tensor, lens: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of :func:`history_mean_gather`.

    Materializes the (B, H, d) gather cast to ``out_dtype``, masks
    positions h >= lens[b], sums in f32, divides once by max(lens, 1) and
    rounds once to ``out_dtype``; empty histories give 0.
    """
    out_dtype = table.dtype if out_dtype is None else out_dtype
    b, h = his_ids.shape
    rows = table.index_select(0, his_ids.reshape(-1).long()).reshape(b, h, -1)
    valid = torch.arange(h, device=lens.device)[None, :] < lens[:, None]
    total = (rows.to(out_dtype).float() * valid[:, :, None]).sum(1)
    denom = torch.clamp(lens.float(), min=1.0)
    return (total / denom[:, None]).to(out_dtype)


def gather_blocks_ref(
    table: torch.Tensor, block_ids: torch.Tensor, r: int
) -> torch.Tensor:
    """Plain version of :func:`gather_blocks`: ``index_select`` on the
    (N / r, r * d) view of the table."""
    n, d = table.shape
    blocks = table.view(n // r, r * d).index_select(0, block_ids.long())
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


def history_mean_gather(
    table: torch.Tensor, his_ids: torch.Tensor, lens: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Masked mean of table[his_ids[b, :lens[b]]] rows, fused with the
    gather. table: (N, d) f32 or bf16; his_ids: (B, H) int32; lens: (B,)
    int32; out_dtype: f32 or bf16 (the table's type when None). The rows
    are cast to ``out_dtype``, summed in f32 and rounded once: (B, d) means
    (zero where lens == 0), matching
    ``models.aggregator.history_mean_fused``."""
    on_card = _check("history_mean_gather", table, his_ids, lens)
    out_dtype = table.dtype if out_dtype is None else out_dtype
    if out_dtype not in SUFFIX:
        raise ValueError(
            f"history_mean_gather: out_dtype must be f32 or bf16, got {out_dtype}"
        )
    if his_ids.dim() != 2 or lens.shape != (his_ids.shape[0],):
        raise ValueError(
            "history_mean_gather: his_ids must be (B, H) and lens (B,), got "
            f"{tuple(his_ids.shape)} and {tuple(lens.shape)}"
        )
    if not on_card:
        return history_mean_gather_ref(table, his_ids, lens, out_dtype)
    n, d = table.shape
    b, h = his_ids.shape
    out = torch.empty((b, d), dtype=out_dtype, device=table.device)
    if b == 0:
        return out
    _build.launch(
        _HISTORY_MEAN[table.dtype], "history_mean_gather", table.device.index,
        table.data_ptr(), n, d, his_ids.data_ptr(), lens.data_ptr(), b, h,
        out.data_ptr(), int(out_dtype == torch.bfloat16),
    )
    count_launch(LAUNCHES, "history_mean_gather", table)
    return out
