"""Row gather (K2) and fused history-mean gather (K1).

The counterparts of ``heat_tpu/ops/pallas/gather.py``. Each public
function checks the kernel's contract (dtypes, shapes, contiguity, one
device) and then dispatches on where its tensors lie: on the CPU it runs
the plain PyTorch version beside it (``*_ref``); on a CUDA device it
launches the hand-written kernel of ``heat_tpu_torch/csrc/gather.cu`` or
raises. There is no fallback from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches per function, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.ops.cuda import _build

LAUNCHES = {"gather_rows": 0, "history_mean_gather": 0}


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: out[j] = table[ids[j]]."""
    return table.index_select(0, ids.long())


def history_mean_gather_ref(
    table: torch.Tensor, his_ids: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`history_mean_gather`.

    Materializes the (B, H, d) gather, masks positions h >= lens[b], sums
    in f32 and divides once by max(lens, 1); empty histories give 0.
    """
    b, h = his_ids.shape
    rows = table.index_select(0, his_ids.reshape(-1).long()).reshape(b, h, -1)
    valid = torch.arange(h, device=lens.device)[None, :] < lens[:, None]
    total = (rows.float() * valid[:, :, None]).sum(1)
    denom = torch.clamp(lens.float(), min=1.0)
    return total / denom[:, None]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, table: torch.Tensor, *int_tensors: torch.Tensor) -> bool:
    """Validate the kernel contract on either device, so that the CPU tests
    catch what the card would refuse. Returns True for CUDA tensors, False
    for CPU tensors; raises for mixed or other devices."""
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: needs CUDA or CPU tensors, got {table.device}")
    if table.dtype != torch.float32:
        raise ValueError(f"{name}: needs an f32 table, got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous (N, d) table")
    for t in int_tensors:
        if t.device != table.device:
            raise ValueError(f"{name}: all tensors must be on {table.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: ids must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: ids must be contiguous")
    return table.device.type == "cuda"


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[j] = table[ids[j]]. table: (N, d) f32; ids: (M,) int32 in
    [0, N). Returns a new (M, d) tensor."""
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
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.heat_gather_rows_f32(
            table.data_ptr(), n, d, ids.data_ptr(), m, out.data_ptr(),
            _stream(table),
        )
    _build.check(rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def history_mean_gather(
    table: torch.Tensor, his_ids: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """Masked mean of table[his_ids[b, :lens[b]]] rows, fused with the
    gather. table: (N, d) f32; his_ids: (B, H) int32; lens: (B,) int32.
    Returns (B, d) f32 means (zero where lens == 0), matching
    ``models.aggregator.history_mean``."""
    on_card = _check("history_mean_gather", table, his_ids, lens)
    if his_ids.dim() != 2 or lens.shape != (his_ids.shape[0],):
        raise ValueError(
            "history_mean_gather: his_ids must be (B, H) and lens (B,), got "
            f"{tuple(his_ids.shape)} and {tuple(lens.shape)}"
        )
    if not on_card:
        return history_mean_gather_ref(table, his_ids, lens)
    n, d = table.shape
    b, h = his_ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.heat_history_mean_f32(
            table.data_ptr(), n, d, his_ids.data_ptr(), lens.data_ptr(),
            b, h, out.data_ptr(), _stream(table),
        )
    _build.check(rc, "history_mean_gather")
    LAUNCHES["history_mean_gather"] += 1
    return out
