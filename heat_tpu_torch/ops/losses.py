"""Contrastive ranking losses over (positive, negatives) scores.

Counterpart of ``heat_tpu/ops/losses.py``: the reference's pairwise
logistic loss log(1 + sum_k exp((s_un_k - s_up) * score_mul)), the SimpleX
cosine contrastive loss, and a per-negative sigmoid pairwise loss.
Gradients come from autograd.
"""

from __future__ import annotations

import torch

from heat_tpu_torch.config import CFConfig


def pairwise_logistic_loss(
    s_up: torch.Tensor, s_un: torch.Tensor, score_mul: float
) -> torch.Tensor:
    """log(1 + sum_k exp((s_un_k - s_up) * score_mul)), stable. Returns (B,)."""
    scores = (s_un - s_up[:, None]) * score_mul  # (B, K)
    lse = torch.logsumexp(scores, dim=-1)
    # logsumexp over {0} ∪ scores.
    return torch.logaddexp(torch.zeros_like(lse), lse)


def cosine_contrastive_loss(
    s_up: torch.Tensor,
    s_un: torch.Tensor,
    margin: float,
    neg_weight: float,
) -> torch.Tensor:
    """SimpleX CCL: (1 - s_up) + (w/K) * sum_k relu(s_un_k - margin)."""
    num_negs = s_un.shape[-1]
    neg_term = torch.relu(s_un - margin).sum(-1) * (neg_weight / num_negs)
    return (1.0 - s_up) + neg_term


def sigmoid_pairwise_loss(
    s_up: torch.Tensor, s_un: torch.Tensor, score_mul: float
) -> torch.Tensor:
    """Mean per-negative softplus((s_un_k - s_up) * score_mul)."""
    scores = (s_un - s_up[:, None]) * score_mul
    return torch.logaddexp(scores, torch.zeros_like(scores)).mean(-1)


def sample_losses(
    s_up: torch.Tensor, s_un: torch.Tensor, cfg: CFConfig
) -> torch.Tensor:
    """Dispatch on cfg.loss. Returns per-sample losses (B,)."""
    if cfg.loss == "PairwiseLogisticLoss":
        return pairwise_logistic_loss(s_up, s_un, cfg.score_mul)
    if cfg.loss == "CosineContrastiveLoss":
        return cosine_contrastive_loss(
            s_up, s_un, cfg.ccl_margin, cfg.ccl_neg_weight
        )
    if cfg.loss == "SigmoidPairwiseLoss":
        return sigmoid_pairwise_loss(s_up, s_un, cfg.score_mul)
    raise ValueError(f"unknown loss {cfg.loss!r}")
