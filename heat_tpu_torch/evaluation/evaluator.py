"""Tiled exact top-k evaluation on the engine's device.

Counterpart of the exact path of ``heat_tpu/evaluation/evaluator.py``
``TiledEvaluator``: for each tile of ``user_tile`` users,

    sim   = U_tile @ I^T                 (torch.matmul, full f32: TF32 off)
    sim[train pairs] = NEG_INF           (packed bitmask, unpacked per tile)
    top_k = torch.topk(sim, k)           (exact, sorted)

The train mask is a packed (U, ceil(I/32)) bitmap built once on the host
and kept on the device; only (U, k) ids leave the loop. Scoring uses the
raw dot product, as the reference's evaluation does.

``torch.topk`` orders tied scores in an unspecified way, as the JAX
package's ``exact_topk_2phase`` does differently from ``lax.top_k``; the
tests compare top-k results tie-aware.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min

# Packed train-mask bitmaps are used when they fit this budget.
MASK_BITS_MAX_BYTES = 1 << 30


def pad_bits_words(lo: int, hi: int, words: int) -> np.ndarray:
    """(words,) u32 word row with bits [lo, hi) set — the pad-region mask
    (item ids at/above the real item count are hard-masked)."""
    row = np.zeros((words,), np.uint32)
    if hi > lo:
        ids = np.arange(lo, hi)
        np.bitwise_or.at(
            row, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32)
        )
    return row


def pack_train_bits(
    train_pairs: np.ndarray | None,
    num_rows: int,
    num_items: int,
    pad_items: int | None = None,
) -> np.ndarray:
    """Pack (user, item) pairs into a (num_rows, ceil(pad_items/32)) u32
    bitmap; bits for item ids in [num_items, pad_items) are pre-set so the
    pad region is hard-masked. Row ids index rows directly."""
    if pad_items is None:
        pad_items = num_items
    words = -(-pad_items // 32)
    bits = np.zeros((num_rows, words), np.uint32)
    if train_pairs is not None and len(train_pairs):
        np.bitwise_or.at(
            bits,
            (train_pairs[:, 0], train_pairs[:, 1] >> 5),
            np.uint32(1) << (train_pairs[:, 1] & 31).astype(np.uint32),
        )
    if pad_items > num_items:
        bits |= pad_bits_words(num_items, pad_items, words)[None, :]
    return bits


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 packed words -> (R, W * 32) bool, bit j of word w at
    column 32 * w + j."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((bits[:, :, None] >> shifts) & 1).bool().reshape(bits.shape[0], -1)


def masked_topk(
    sim: torch.Tensor, bits: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (R, I) scores with the packed-mask bits set to
    NEG_INF. bits: (R, W) int32 with W * 32 >= I."""
    mask = unpack_bits(bits)[:, : sim.shape[1]]
    return torch.topk(sim.masked_fill(mask, NEG_INF), k, dim=1)


class TiledEvaluator:
    """Tiled exact top-k with the train-pair bitmask cached on ``device``.

    Args:
      train_pairs: (N, 2) (user, item) pairs to mask, or None.
      num_users: rows of the user table to rank for.
      user_tile: users per tile.
      num_items: item-space size (inferred from the pairs when None).
      device: where the bitmask lives and ranking runs.
    """

    def __init__(
        self,
        train_pairs: np.ndarray | None,
        num_users: int,
        user_tile: int = 512,
        *,
        num_items: int | None = None,
        device="cpu",
    ):
        self.num_users = num_users
        self.user_tile = user_tile
        self.num_tiles = -(-num_users // user_tile)
        if train_pairs is None:
            train_pairs = np.zeros((0, 2), np.int32)
        train_pairs = np.asarray(train_pairs)
        if num_items is None:
            num_items = (
                int(train_pairs[:, 1].max()) + 1 if len(train_pairs) else 1
            )
        self.num_items = num_items
        words = -(-num_items // 32)
        bits_bytes = self.num_tiles * user_tile * words * 4
        if bits_bytes > MASK_BITS_MAX_BYTES:
            raise NotImplementedError(
                f"the train bitmask would take {bits_bytes} bytes > "
                f"MASK_BITS_MAX_BYTES; per-pair scatter masking is not "
                "ported yet (ROADMAP.md, modules still to port, item 7)"
            )
        bits = pack_train_bits(
            train_pairs, num_users, num_items, pad_items=words * 32
        )
        self.mask_bits = torch.as_tensor(bits.view(np.int32), device=device)

    def topk(
        self, user_emb: torch.Tensor, item_emb: torch.Tensor, k: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Ranked top-k (scores, ids) per user, each (num_users, k), train
        items masked. Stays on the tables' device."""
        if item_emb.shape[0] != self.num_items:
            raise ValueError(
                f"item table has {item_emb.shape[0]} rows, the mask "
                f"{self.num_items}"
            )
        user_emb = user_emb.float()
        item_t = item_emb.float().T
        scores, ids = [], []
        for t in range(self.num_tiles):
            lo = t * self.user_tile
            hi = min(lo + self.user_tile, self.num_users)
            sim = torch.matmul(user_emb[lo:hi], item_t)
            s, i = masked_topk(sim, self.mask_bits[lo:hi], k)
            scores.append(s)
            ids.append(i)
        return torch.cat(scores), torch.cat(ids).to(torch.int32)
