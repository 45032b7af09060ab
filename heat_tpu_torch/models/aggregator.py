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
    item_emb: torch.Tensor, his_ids: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked history mean fused with its own gather (kernel K1).

    Args:
      item_emb: (I, d) f32 table.
      his_ids: (B, H) int32 history ids.
      mask: (B,) int32 valid history length per sample.

    Returns:
      (B, d) f32 means (empty histories pool to zero). On the card the
      (B, H, d) gather never reaches device memory and masked slots are
      never read.
    """
    return history_mean_gather(item_emb, his_ids, mask)


def aggregate_history(
    u: torch.Tensor, means: torch.Tensor, w0: torch.Tensor, gamma: float
) -> torch.Tensor:
    """u_agg = gamma * u + (1 - gamma) * means @ w0.

    The (B, d) x (d, d) product is a plain matmul; it is full f32 on the
    card only with TF32 off, which the engine sets and checks.
    """
    return gamma * u + (1.0 - gamma) * (means @ w0)
