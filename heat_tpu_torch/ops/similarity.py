"""Similarity scoring between users, positives and negatives.

Counterpart of ``heat_tpu/ops/similarity.py``: batched cosine (or dot)
scores with the reference's 1e-8 floor on squared norms, per (sample,
negative) pair (``pair_scores``) or of every user against a whole negative
tile (``tile_scores``). Inputs of any float type are promoted to f32
first, so bf16 rows are scored exactly. Gradients come from autograd of
this forward. ``pair_scores`` is elementwise multiplies and sums, full f32
whatever the TF32 settings; ``tile_scores`` holds one matrix product,
which is full f32 only with TF32 off (the engine sets and checks that).
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


def tile_scores(
    u: torch.Tensor,
    p: torch.Tensor,
    tile_rows: torch.Tensor,
    *,
    similarity: str = "cosine",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score (user, positive) pairs and users against a whole negative tile.

    The tile sampler draws all of a batch's negatives from one small tile
    (T rows), so instead of gathering a (B, K, d) tensor of sampled rows
    every user is scored against every tile row with one (B, d) x (d, T)
    matrix product; the per-sample negative scores are then the (B, T)
    matrix read through the sampled multiplicities
    (``ops/losses.py`` ``sample_losses_weighted``). The same dots and
    clamped norms as ``pair_scores`` over the gathered rows, and the tile's
    gradient is the transposed product.

    Args:
      u: (B, d) aggregated user embeddings.
      p: (B, d) positive item embeddings.
      tile_rows: (T, d) the tile's item embeddings.

    Returns:
      (s_up, S): (B,) positive scores and (B, T) user x tile scores, f32.
    """
    u, p, t = u.float(), p.float(), tile_rows.float()
    up = (u * p).sum(-1)
    S = torch.matmul(u, t.T)
    if similarity == "dot":
        return up, S
    r_u = _safe_rnorm((u * u).sum(-1))
    r_t = _safe_rnorm((t * t).sum(-1))
    s_up = up * r_u * _safe_rnorm((p * p).sum(-1))
    return s_up, S * r_u[:, None] * r_t[None, :]
