"""Top-k window extraction (K4), phase 2 of the two-phase exact top-k.

The counterpart of the Pallas kernels ``pallas_extract`` and
``pallas_extract_slices`` (``scripts/profile_eval.py:264`` and ``:361``)
and of the one-hot einsum in ``heat_tpu/evaluation/evaluator.py``
``exact_topk_2phase``: for each row of a score matrix, copy out the
``w``-wide windows that phase 1 selected. After checking the kernel's
contract, :func:`window_extract` runs the plain PyTorch version
(:func:`window_extract_ref`) on the CPU, and on a CUDA device launches the
hand-written kernel of ``heat_tpu_torch/csrc/topk.cu`` or raises.

The output is an exact copy of the selected scores, so on the card the
kernel and its plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.ops.cuda import _build
from heat_tpu_torch.ops.cuda.gather import _check

LAUNCHES = {"window_extract": 0}

NEG_INF = torch.finfo(torch.float32).min


def window_extract_ref(
    sim: torch.Tensor, widx: torch.Tensor, w: int
) -> torch.Tensor:
    """Plain version of :func:`window_extract`: advanced indexing of
    ``sim.view(R, nw, w)``; out-of-range window ids give NEG_INF rows."""
    rows, n_cols = sim.shape
    nw = n_cols // w
    valid = (widx >= 0) & (widx < nw)
    if nw == 0:
        return sim.new_full((rows, widx.shape[1], w), NEG_INF)
    safe = torch.where(valid, widx, 0).long()
    r = torch.arange(rows, device=sim.device)[:, None]
    out = sim.view(rows, nw, w)[r, safe]
    return out.masked_fill(~valid[:, :, None], NEG_INF)


def window_extract(sim: torch.Tensor, widx: torch.Tensor, w: int) -> torch.Tensor:
    """out[r, j, :] = sim[r, widx[r, j] * w : (widx[r, j] + 1) * w].

    sim: (R, n_cols) f32 with n_cols % w == 0; widx: (R, kw) int32. A
    window id outside [0, n_cols // w) gives a row of finfo(f32).min.
    Returns a new (R, kw, w) f32 tensor.
    """
    on_card = _check("window_extract", sim, widx)
    if sim.dtype != torch.float32:  # the kernel has no bf16 instance
        raise ValueError(f"window_extract: sim must be float32, got {sim.dtype}")
    rows, n_cols = sim.shape
    if w <= 0 or n_cols % w:
        raise ValueError(
            f"window_extract: n_cols ({n_cols}) must be a multiple of w ({w})"
        )
    if widx.dim() != 2 or widx.shape[0] != rows:
        raise ValueError(
            f"window_extract: widx must be ({rows}, kw), got {tuple(widx.shape)}"
        )
    if not on_card:
        return window_extract_ref(sim, widx, w)
    kw = widx.shape[1]
    out = torch.empty((rows, kw, w), dtype=torch.float32, device=sim.device)
    if rows * kw == 0:
        return out
    _build.launch(
        "heat_window_extract_f32", "window_extract", sim.device,
        sim.data_ptr(), rows, n_cols, widx.data_ptr(), kw, w, out.data_ptr(),
    )
    LAUNCHES["window_extract"] += 1
    return out
