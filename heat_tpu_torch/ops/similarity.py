"""Similarity scoring between users, positives and negatives.

Counterpart of ``heat_tpu/ops/similarity.py`` ``pair_scores``: batched
cosine (or dot) scores with the reference's 1e-8 floor on squared norms.
Gradients come from autograd of this forward. Every product here is an
elementwise multiply and a sum, so the scores are full f32 whatever the
TF32 settings.
"""

from __future__ import annotations

import torch

EPS = 1e-8  # floor on squared norms, i.e. sqrt(1e-8) on norms


def _safe_rnorm(sq: torch.Tensor) -> torch.Tensor:
    """1/sqrt(max(sq, EPS)) — the clamped norm reciprocal."""
    return torch.rsqrt(torch.clamp(sq, min=EPS))


def pair_scores(
    u: torch.Tensor,
    p: torch.Tensor,
    n: torch.Tensor,
    *,
    similarity: str = "cosine",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score (user, positive) and (user, negatives) pairs.

    Args:
      u: (B, d) aggregated user embeddings.
      p: (B, d) positive item embeddings.
      n: (B, K, d) negative item embeddings.
      similarity: "cosine" (reference behaviour) or "dot".

    Returns:
      (s_up, s_un): (B,) and (B, K) similarity scores.
    """
    u, p, n = u.float(), p.float(), n.float()
    up = (u * p).sum(-1)
    un = (n * u[:, None, :]).sum(-1)
    if similarity == "dot":
        return up, un
    r_u = _safe_rnorm((u * u).sum(-1))
    s_up = up * r_u * _safe_rnorm((p * p).sum(-1))
    s_un = un * r_u[:, None] * _safe_rnorm((n * n).sum(-1))
    return s_up, s_un
