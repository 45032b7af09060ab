"""Tiled exact top-k evaluation on the engine's device.

Counterpart of ``heat_tpu/evaluation/evaluator.py``: for each tile of
``user_tile`` users,

    sim   = U_tile @ I_pad^T          (torch.matmul, full f32: TF32 off)
    sim[train pairs] = NEG_INF        (packed bitmask, or per-pair scatter)
    top_k = masked_topk(sim, k)       (two-phase exact top-k, kernel K4)

The item axis is padded once to a multiple of 128 (zero embedding rows,
their mask bits set), so every tile's score matrix splits into 128-wide
windows without a copy. The train mask is a packed (tiles, user_tile,
I_pad/32) bitmap built once on the host and kept on the device; above
``MASK_BITS_MAX_BYTES`` the train pairs are kept per tile instead and
scattered into each tile's scores. Only (U, k) results leave the loop.
Scoring uses the raw dot product, as the reference's evaluation does.

``masked_topk`` is the selection step shared with serving's request path.
Tied scores may come out in another order than the JAX package's (which
itself differs from ``lax.top_k``); the tests compare top-k results
tie-aware.
"""

from __future__ import annotations

import numpy as np
import torch

from heat_tpu_torch.ops.cuda.topk import window_extract

NEG_INF = torch.finfo(torch.float32).min

# Window width for the two-phase exact top-k.
_TOPK_WINDOW = 128
# Below this many items a single torch.topk is used instead of two phases.
_TOPK_2PHASE_MIN_ITEMS = 4 * 1024

# Packed train-mask bitmaps are used when they fit this budget; above it
# the evaluator keeps the train pairs per tile and scatters them.
MASK_BITS_MAX_BYTES = 1 << 30


def masked_topk(
    sim: torch.Tensor,
    bits: torch.Tensor | None,
    k: int,
    *,
    exact: bool = True,
    recall_target: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-bitmask masking + top-k selection, shared by the tiled
    evaluator and serving's request path.

    bits: (B, W) int32 packed mask (set bits score NEG_INF; ``sim`` must be
    (B, W * 32)), or None for pre-masked scores. Selection is the two-phase
    exact top-k from ``_TOPK_2PHASE_MIN_ITEMS`` columns up, ``torch.topk``
    below. Returns (scores, ids), both (B, k), ids int64, descending.

    ``exact=False`` is the JAX package's ``approx_max_k`` at
    ``recall_target``, which approximates only on a TPU and elsewhere
    sorts and slices, an exact selection whatever the target: here the
    same selection as ``exact=True``, the target checked as
    ``approx_max_k`` checks it (:func:`check_recall_target`).
    """
    check_recall_target(exact, recall_target)
    if bits is not None:
        if sim.shape[1] != bits.shape[1] * 32:
            raise ValueError(
                f"masked_topk: {sim.shape[1]} score columns, "
                f"{bits.shape[1]} mask words"
            )
        sim = sim.masked_fill(unpack_bits(bits), NEG_INF)
    if sim.shape[1] >= _TOPK_2PHASE_MIN_ITEMS:
        return exact_topk_2phase(sim, k)
    return torch.topk(sim, k, dim=1)


def check_recall_target(exact: bool, recall_target: float) -> None:
    """Raise ValueError where ``approx_max_k`` refuses its target: with
    ``exact=False``, a ``recall_target`` outside (0, 1] (NaN included)."""
    if not exact and not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")


def exact_topk_2phase(
    sim: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via window-max pre-selection: one reduction pass and two
    narrow top-ks instead of one top-k over the full row.

    Exactness: let tau be the k-th largest element of a row. Every window
    holding a top-k element has max >= tau, and at most k windows have
    max >= tau (each holds an element >= tau), so the k windows with the
    largest maxima hold every top-k element; an exact top-k over their
    k * 128 scores finishes the job. Phase 2 copies those windows out with
    kernel K4 (``ops/cuda/topk.py``). With duplicates equal to tau the
    returned set is a valid top-k whose ties may resolve differently from
    ``torch.topk``'s.

    Args:
      sim: (B, I) scores (rows independent). A width that is not a multiple
        of 128 is padded with NEG_INF.
      k: ranks to return.

    Returns:
      (scores, ids): both (B, k), sorted descending; ids int64.
    """
    b, n = sim.shape
    w = _TOPK_WINDOW
    nw = -(-n // w)
    pad = nw * w - n
    if pad:
        sim = torch.cat([sim, sim.new_full((b, pad), NEG_INF)], dim=1)
    sim = sim.contiguous()
    wmax = sim.view(b, nw, w).amax(dim=2)  # (B, nw)
    kw = min(k, nw)
    if nw >= _TOPK_2PHASE_MIN_ITEMS:
        # At millions of items (6M -> 47k windows) the window-max top-k is
        # itself wide; recurse. Exactness is inductive.
        _, widx = exact_topk_2phase(wmax, kw)
    else:
        _, widx = torch.topk(wmax, kw, dim=1)  # (B, kw)
    cand = window_extract(sim, widx.to(torch.int32), w)  # (B, kw, w)
    scores, local = torch.topk(cand.view(b, kw * w), k, dim=1)
    ids = torch.gather(widx, 1, local // w) * w + local % w
    return scores, ids


def _pairs_by_tile(
    train_pairs: np.ndarray, num_users: int, tile: int
) -> list[np.ndarray]:
    """Group (user, item) pairs by user tile, users made tile-local."""
    num_tiles = -(-num_users // tile)
    buckets: list[list[np.ndarray]] = [[] for _ in range(num_tiles)]
    if len(train_pairs):
        t = train_pairs[:, 0] // tile
        order = np.argsort(t, kind="stable")
        sorted_pairs = train_pairs[order]
        tile_ids = t[order]
        bounds = np.searchsorted(tile_ids, np.arange(num_tiles + 1))
        for ti in range(num_tiles):
            buckets[ti].append(sorted_pairs[bounds[ti] : bounds[ti + 1]])
    return [
        np.concatenate(b, axis=0) if b else np.zeros((0, 2), np.int32)
        for b in buckets
    ]


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


def _padded_width(num_items: int) -> int:
    return -(-num_items // _TOPK_WINDOW) * _TOPK_WINDOW


class TiledEvaluator:
    """Tiled exact top-k with the train-pair mask cached on ``device``.

    The mask is a packed (num_tiles, user_tile, I_pad / 32) bitmap when it
    fits ``MASK_BITS_MAX_BYTES`` (``mask_bits``); above it the pairs are
    bucketed by tile into (num_tiles, P) tile-local user rows ``mask_u``
    (padding slots hold ``user_tile``) and item ids ``mask_i``.

    Args:
      train_pairs: (N, 2) (user, item) pairs to mask, or None.
      num_users: rows of the user table to rank for.
      user_tile: users per tile.
      num_items: item-space size (inferred from the pairs when None; a
        wider item table at ``topk`` time is handled).
      device: where the mask lives and ranking runs: "cuda" (the default;
        fails without a card) or "cpu".
    """

    def __init__(
        self,
        train_pairs: np.ndarray | None,
        num_users: int,
        user_tile: int = 512,
        *,
        num_items: int | None = None,
        device="cuda",
    ):
        self.num_users = num_users
        self.user_tile = user_tile
        self.num_tiles = -(-num_users // user_tile)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (pass device='cpu' to rank on the CPU)"
            )
        if train_pairs is None:
            train_pairs = np.zeros((0, 2), np.int32)
        train_pairs = np.asarray(train_pairs)
        if num_items is None:
            num_items = (
                int(train_pairs[:, 1].max()) + 1 if len(train_pairs) else 1
            )
        self._mask_items = num_items
        self._pad_items = _padded_width(num_items)
        words = self._pad_items // 32
        bits_bytes = self.num_tiles * user_tile * words * 4
        self.mask_u = self.mask_i = None
        if bits_bytes <= MASK_BITS_MAX_BYTES:
            bits = pack_train_bits(
                train_pairs,
                self.num_tiles * user_tile,
                num_items,
                pad_items=self._pad_items,
            )
            self.mask_bits = self._upload_bits(bits)
            return
        self.mask_bits = None
        buckets = _pairs_by_tile(train_pairs, num_users, user_tile)
        self._pair_counts = [len(b) for b in buckets]
        self._pair_item_end = (
            int(train_pairs[:, 1].max()) + 1 if len(train_pairs) else 0
        )
        pmax = max(1, max(self._pair_counts))
        mask_u = np.full((self.num_tiles, pmax), user_tile, np.int64)
        mask_i = np.zeros((self.num_tiles, pmax), np.int64)
        for ti, pairs in enumerate(buckets):
            mask_u[ti, : len(pairs)] = pairs[:, 0] % user_tile
            mask_i[ti, : len(pairs)] = pairs[:, 1]
        self.mask_u = torch.as_tensor(mask_u, device=self.device)
        self.mask_i = torch.as_tensor(mask_i, device=self.device)

    def _upload_bits(self, bits: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            bits.view(np.int32).reshape(self.num_tiles, self.user_tile, -1),
            device=self.device,
        )

    def _widen_items(self, num_items: int) -> None:
        """Re-mask the bitmap for an item table of ``num_items`` rows, wider
        than the pairs implied: the old pad bits (set) may now cover real
        items and the new pad tail needs setting. Host-side, cached."""
        if num_items < self._mask_items:
            raise ValueError(
                f"item table has {num_items} rows; the mask covers "
                f"{self._mask_items} items"
            )
        bits = self.mask_bits.cpu().numpy().view(np.uint32)
        bits = bits.reshape(self.num_tiles * self.user_tile, -1)
        old_words = bits.shape[1]
        bits = bits & ~pad_bits_words(
            self._mask_items, old_words * 32, old_words
        )[None, :]
        pad_items = _padded_width(num_items)
        words = pad_items // 32
        if words > old_words:
            bits = np.concatenate(
                [bits, np.zeros((bits.shape[0], words - old_words), np.uint32)],
                axis=1,
            )
        bits |= pad_bits_words(num_items, pad_items, words)[None, :]
        self._mask_items = num_items
        self._pad_items = pad_items
        self.mask_bits = self._upload_bits(bits)

    def topk(
        self,
        user_emb: torch.Tensor,
        item_emb: torch.Tensor,
        k: int,
        *,
        exact: bool = True,
        return_scores: bool = False,
        recall_target: float = 0.95,
    ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """Ranked top-k per user, train items masked: (scores, ids), each
        (num_users, k), ids int32; scores is None unless
        ``return_scores``. Stays on the tables' device. ``exact`` and
        ``recall_target`` select as :func:`masked_topk` does."""
        num_items = int(item_emb.shape[0])
        if self.mask_bits is not None:
            if num_items != self._mask_items:
                self._widen_items(num_items)
        elif self._pair_item_end > num_items:
            raise ValueError(
                f"item table has {num_items} rows; the train pairs reach "
                f"item {self._pair_item_end - 1}"
            )
        pad_items = _padded_width(num_items)
        item = item_emb.float()
        if pad_items > num_items:
            item = torch.cat(
                [item, item.new_zeros((pad_items - num_items, item.shape[1]))]
            )
        item_t = item.T
        user_emb = user_emb.float()
        scores, ids = [], []
        for t in range(self.num_tiles):
            lo = t * self.user_tile
            hi = min(lo + self.user_tile, self.num_users)
            sim = torch.matmul(user_emb[lo:hi], item_t)
            if self.mask_bits is not None:
                bits = self.mask_bits[t, : hi - lo]
            else:
                bits = None
                n = self._pair_counts[t]
                if n:
                    sim[self.mask_u[t, :n], self.mask_i[t, :n]] = NEG_INF
                if num_items < pad_items:
                    # Zero-embedding pad items score 0; hard-mask the tail.
                    sim[:, num_items:] = NEG_INF
            s, i = masked_topk(sim, bits, k, exact=exact,
                               recall_target=recall_target)
            scores.append(s)
            ids.append(i)
        ids = torch.cat(ids).to(torch.int32)
        return (torch.cat(scores) if return_scores else None), ids


def topk_scores(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    *,
    train_pairs: np.ndarray | None = None,
    user_tile: int = 512,
    exact: bool = True,
    recall_target: float = 0.95,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot wrapper over TiledEvaluator (the item count is inferred
    from the pairs and widened to the table). Returns (scores (U, k) f32,
    ids (U, k) int32) as numpy arrays."""
    ev = TiledEvaluator(
        train_pairs,
        int(user_emb.shape[0]),
        user_tile=user_tile,
        device=user_emb.device,
    )
    scores, ids = ev.topk(user_emb, item_emb, k, exact=exact,
                          return_scores=True, recall_target=recall_target)
    return scores.cpu().numpy(), ids.cpu().numpy()


def full_sim_matrix(user_emb: torch.Tensor, item_emb: torch.Tensor) -> np.ndarray:
    """The reference ``evaluate0`` API (engine.cpp:388-400): the dense
    user x item dot-product matrix, an f32 product (TF32 off) brought to
    the host. Only for small problems and parity tests; production
    evaluation uses :func:`topk_scores`."""
    return (user_emb.float() @ item_emb.float().T).cpu().numpy()
