"""Contrastive ranking losses over (positive, negatives) scores.

Counterpart of ``heat_tpu/ops/losses.py``: the reference's pairwise
logistic loss log(1 + sum_k exp((s_un_k - s_up) * score_mul)), the SimpleX
cosine contrastive loss, and a per-negative sigmoid pairwise loss, each
over gathered (B, K) negative scores (``sample_losses``) or over a whole
tile's (B, T) scores weighted by the draws' multiplicities
(``sample_losses_weighted``). Gradients come from autograd.
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


def sample_losses_weighted(
    s_up: torch.Tensor,
    S: torch.Tensor,
    counts: torch.Tensor,
    num_negs: int,
    cfg: CFConfig,
) -> torch.Tensor:
    """Losses over tile scores with sampled multiplicities.

    Every supported loss depends on the negatives only through a sum of
    elementwise terms, so a batch row's K sampled negative scores, a
    multiset of tile scores, can be evaluated as the full (B, T) tile
    score matrix weighted by ``counts[b, t]`` (how many of row b's K draws
    hit tile slot t; sum_t counts[b, t] == K): the same multiset as
    gathering the sampled scores, with no per-draw gather or scatter.

    Args:
      s_up: (B,) positive scores.
      S: (B, T) user x tile scores (``ops/similarity.py`` ``tile_scores``).
      counts: (B, T) draw multiplicities, float.
      num_negs: K (per-negative means divide by K, not by T).
    """
    if cfg.loss == "PairwiseLogisticLoss":
        sc = (S - s_up[:, None]) * cfg.score_mul
        # logsumexp over {0} and the sampled multiset, weighted by counts.
        m = sc.masked_fill(counts <= 0, float("-inf")).amax(dim=1)
        m = torch.clamp(m, min=0.0)
        sumexp = (counts * torch.exp(sc - m[:, None])).sum(1)
        return m + torch.log(torch.exp(-m) + sumexp)
    if cfg.loss == "CosineContrastiveLoss":
        neg = (counts * torch.relu(S - cfg.ccl_margin)).sum(1)
        return (1.0 - s_up) + neg * (cfg.ccl_neg_weight / num_negs)
    if cfg.loss == "SigmoidPairwiseLoss":
        sc = (S - s_up[:, None]) * cfg.score_mul
        softplus = torch.logaddexp(sc, torch.zeros_like(sc))
        return (counts * softplus).sum(1) / num_negs
    raise ValueError(f"unknown loss {cfg.loss!r}")
