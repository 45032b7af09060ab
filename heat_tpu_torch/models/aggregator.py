"""SimpleX behaviour aggregation (mean pooling with the w0/gamma blend).

Counterpart of ``heat_tpu/models/aggregator.py``:

    u_agg = gamma * u + (1 - gamma) * (mean(history rows) @ w0)

The mean covers the first ``mask[b]`` history rows of each sample and is 0
for an empty history. No gradient flows into the history rows: the mean
is computed outside autograd (the kernel K1 is not differentiable, and
the step never asks it to be).

The aggregator is a plain function, not an ``nn.Module`` holding ``w0``:
``w0`` is one of the leaf tensors the step differentiates alongside the
gathered rows, and it is updated by hand with the tables (``train_step``),
so a module would add a parameter container that nothing else uses.
"""

from __future__ import annotations

import functools

import torch

from heat_tpu_torch.ops.cuda.gather import history_mean_gather


def history_mean(his_embs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the first ``mask`` history rows.

    Args:
      his_embs: (B, H, d) gathered history item embeddings.
      mask: (B,) int — valid history length per user.

    Returns:
      (B, d) means, summed in f32 and rounded once.
    """
    h = his_embs.shape[1]
    pos = torch.arange(h, device=mask.device)[None, :]
    valid = (pos < mask[:, None]).to(torch.float32)
    total = (his_embs.float() * valid[:, :, None]).sum(1)
    denom = torch.clamp(mask.float(), min=1.0)
    return (total / denom[:, None]).to(his_embs.dtype)


def history_mean_fused(
    item_emb: torch.Tensor,
    his_ids: torch.Tensor,
    mask: torch.Tensor,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Masked history mean fused with its own gather (kernel K1).

    Args:
      item_emb: (I, d) f32 or bf16 table.
      his_ids: (B, H) int32 history ids.
      mask: (B,) int32 valid history length per sample.
      compute_dtype: the type the rows are cast to and the result has; the
        table's type when None.

    Returns:
      (B, d) means in ``compute_dtype`` (empty histories pool to zero),
      summed in f32 and rounded once. On the card the (B, H, d) gather
      never reaches device memory and masked slots are never read.
    """
    return history_mean_gather(item_emb, his_ids, mask, compute_dtype)


def require_mean_aggregator(kind: str) -> None:
    """Raise for an aggregator other than the mean: the attention kinds
    are not ported yet, any other name is unknown."""
    if kind in ("self_attention", "user_attention"):
        raise NotImplementedError(
            f"aggregator {kind!r} is not ported to heat_tpu_torch "
            "(ROADMAP.md, modules still to port, item 12)"
        )
    if kind != "mean":
        raise ValueError(f"unknown aggregator {kind!r}")


def pool_history(
    his_embs: torch.Tensor, mask: torch.Tensor, kind: str = "mean"
) -> torch.Tensor:
    """History pooling over gathered (B, H, d) rows: ``kind="mean"`` is the
    masked mean. The attention kinds raise ``NotImplementedError``."""
    require_mean_aggregator(kind)
    return history_mean(his_embs, mask)


def user_pools_impl(
    item_emb: torch.Tensor,
    his_items: torch.Tensor,
    his_masks: torch.Tensor,
    aggregator: str = "mean",
    chunk: int = 4096,
) -> torch.Tensor:
    """(U, d) pooled history of every user, ``chunk`` users at a time; the
    mean runs each chunk through kernel K1, so no (chunk, H, d) gather is
    ever materialized.

    Args:
      item_emb: (I, d) f32 or bf16 table; the pools have its type.
      his_items: (U, H) int32 history ids (the JAX package's flat (U*H,)
        layout is TPU lane machinery and is not taken).
      his_masks: (U,) int32 valid history lengths.
      aggregator: "mean" (the attention aggregators raise
        ``NotImplementedError``).
      chunk: users per K1 launch.
    """
    require_mean_aggregator(aggregator)
    if his_items.dim() != 2:
        raise ValueError(
            f"his_items must be (U, H), got shape {tuple(his_items.shape)}"
        )
    u = his_items.shape[0]
    out = torch.empty((u, item_emb.shape[1]), dtype=item_emb.dtype,
                      device=item_emb.device)
    for lo in range(0, u, chunk):
        out[lo : lo + chunk] = history_mean_fused(
            item_emb, his_items[lo : lo + chunk], his_masks[lo : lo + chunk]
        )
    return out


def aggregate_history(
    u: torch.Tensor, means: torch.Tensor, w0: torch.Tensor, gamma: float
) -> torch.Tensor:
    """u_agg = gamma * u + (1 - gamma) * means @ w0.

    The (B, d) x (d, d) product is a plain matmul in the type of ``means``
    (``w0`` is cast to it, as the JAX step casts it to the compute type);
    in f32 it is full f32 on the card only with TF32 off, which the engine
    sets and checks. In bf16 the product and each of the three elementwise
    operations round to bf16, as they do in the JAX package, where the two
    scalar weights are rounded to bf16 as well before they multiply.
    """
    f_c0 = means @ w0.to(means.dtype)
    return scalar_in(gamma, u.dtype) * u + scalar_in(1.0 - gamma, f_c0.dtype) * f_c0


@functools.lru_cache(maxsize=None)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float. JAX casts a
    Python scalar to the array's type before an elementwise operation;
    PyTorch keeps it in f32. Rounding it here first gives bf16 arithmetic
    the JAX package's result (for f32 both agree already). Made on the
    host, once per value: nothing waits for the device."""
    if dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=dtype))
