"""Inference/serving: top-k recommendations from a trained model.

Counterpart of ``heat_tpu/serving.py``: load exported embeddings (or take
a live engine's state), optionally apply behaviour aggregation to the user
rows, and serve batched top-k item recommendations with already-seen items
masked, on the state's device. The tables are f32 or bf16; scores are
always f32. A request's user rows come through kernel K2, aggregated
histories through K1 (the mean) or through K2's history rows pooled in
plain torch (self- and user-attention, ``models/aggregator.py``
``pool_history``), and every selection through the two-phase exact top-k
(``evaluation.evaluator.masked_topk``, kernel K4). ``exact=False`` selects
the same way: the JAX package's ``approx_max_k`` is an exact selection off
a TPU.

A request takes one of three routes, fixed when the ``Recommender`` is
built:

* one-shot: one (B, I) GEMM, the packed seen-mask rows, one top-k;
* chunked, for item tables from ``_CHUNKED_REQUEST_MIN_ITEMS`` rows: the
  item axis in chunks with a running top-k merge;
* retrieve-and-filter, when the packed seen-mask would exceed
  ``evaluator.MASK_BITS_MAX_BYTES``: the chunked scan retrieves the top
  (k + cap) unmasked, cap being the largest seen count among the requested
  users, and the seen items are dropped on the host. Exact: at most cap of
  the retrieved ids can be seen.

Ids come back as numpy int32 arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.evaluation.evaluator import (
    NEG_INF,
    TiledEvaluator,
    check_recall_target,
    masked_topk,
    pad_bits_words,
)
from heat_tpu_torch.models.aggregator import (
    aggregate_history,
    history_mean_fused,
    pool_history,
    scalar_in,
)
from heat_tpu_torch.models.state import TrainState
from heat_tpu_torch.ops.cuda.gather import gather_rows
from heat_tpu_torch.train.engine import compute_user_pools


def _topk_request(
    user_rows: torch.Tensor,
    item_pad: torch.Tensor,
    bits_rows: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Rank one request batch: (B, d) user rows against the padded item
    table with per-row packed seen-masks. Returns (B, k) int64 ids."""
    sim = torch.matmul(user_rows.float(), item_pad.float().T)
    _, ids = masked_topk(sim, bits_rows, k)
    return ids


# From this many (padded) item rows a request scans the item axis in
# chunks (_topk_request_chunked) instead of scoring it in one piece.
_CHUNKED_REQUEST_MIN_ITEMS = 262_144
# Chunk-pad multiple: the item table and mask width are padded once (at
# construction) to a multiple of this, so every power-of-two chunk size
# <= it divides the padded item count evenly.
_REQUEST_PAD_MULTIPLE = 262_144


def _topk_request_chunked(
    user_rows: torch.Tensor,
    item_pad: torch.Tensor,
    bits_rows: torch.Tensor,
    k: int,
    chunk: int,
) -> torch.Tensor:
    """Huge-item-table request ranking: the item axis in ``chunk``-row
    slices, each scored and mask-selected like the one-shot route, with a
    running (B, k) best merged per chunk. Exact: a global top-k element is
    necessarily a top-k element of its chunk. ``item_pad`` rows and
    ``bits_rows`` width must be padded to a multiple of ``chunk`` with the
    pad bits set, so pad rows never rank. Returns (B, k) int64 ids."""
    b = user_rows.shape[0]
    n_chunks = item_pad.shape[0] // chunk
    w = chunk // 32
    rows32 = user_rows.float()
    best_v = torch.full((b, k), NEG_INF, device=user_rows.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=user_rows.device)
    for c in range(n_chunks):
        off = c * chunk
        sim = torch.matmul(rows32, item_pad[off : off + chunk].float().T)
        v, i = masked_topk(sim, bits_rows[:, c * w : (c + 1) * w], k)
        cv = torch.cat([best_v, v], dim=1)
        ci = torch.cat([best_i, i + off], dim=1)
        best_v, pos = torch.topk(cv, k, dim=1)
        best_i = torch.gather(ci, 1, pos)
    return best_i


def _int32_on(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


class Recommender:
    """Batched top-k recommendation over a trained model.

    Args:
      state: trained TrainState (``engine.state``, or
        ``state_from_numpy`` of ``export.load_embeddings``); the tables'
        device is where requests run.
      cfg: the training config (gamma, aggregator; under self_attention
        the state carries ``attn_q``).
      seen_pairs: (N, 2) user-item interactions to exclude from results
        (typically the training clicks), or None.
      his_items / his_masks: (U, H) user histories and (U,) lengths;
        required only for ``aggregate_users=True``.
      user_tile: users per tile of ``recommend_all``.
    """

    def __init__(
        self,
        state: TrainState,
        cfg: CFConfig,
        seen_pairs: Optional[np.ndarray] = None,
        his_items=None,
        his_masks=None,
        user_tile: int = 512,
    ):
        self.state = state
        self.cfg = cfg
        device = state.user_emb.device
        num_users = int(state.user_emb.shape[0])
        n_real = int(state.item_emb.shape[0])
        self._evaluator = TiledEvaluator(
            seen_pairs,
            num_users,
            user_tile=user_tile,
            # Pin the true item count: inferred from seen_pairs it would be
            # narrower than the table whenever the highest seen id sits
            # below the table's row count.
            num_items=n_real,
            device=device,
        )
        # Request-path caches: the packed seen-mask as a flat per-user-row
        # bitmap and the item table padded to the mask width (zero rows;
        # their bits are set) — built once, so a request moves only (B,)
        # ids in and (B, k) ids out.
        ev = self._evaluator
        self._bits_flat = (
            None
            if ev.mask_bits is None
            else ev.mask_bits.reshape(-1, ev.mask_bits.shape[2])
        )
        self._item_pad = self._zero_pad_rows(state.item_emb, ev._pad_items)
        self._chunked_request = (
            int(self._item_pad.shape[0]) >= _CHUNKED_REQUEST_MIN_ITEMS
        )
        self._pad_bits_row = None
        self._seen_indptr = self._seen_keys = None
        if self._chunked_request:
            # Chunk-pad the request arrays once so the chunked scan divides
            # evenly: zero rows with their mask bits SET never rank.
            i0 = int(self._item_pad.shape[0])
            ic = -(-i0 // _REQUEST_PAD_MULTIPLE) * _REQUEST_PAD_MULTIPLE
            self._item_pad = self._zero_pad_rows(self._item_pad, ic)
            if self._bits_flat is not None and ic > i0:
                self._bits_flat = torch.cat(
                    [
                        self._bits_flat,
                        self._bits_flat.new_full(
                            (self._bits_flat.shape[0], (ic - i0) // 32), -1
                        ),
                    ],
                    dim=1,
                )
            if self._bits_flat is None:
                # No per-user bitmap: requests retrieve unmasked and filter
                # on the host. The pad bits are the same for every row.
                w = ic // 32
                self._pad_bits_row = torch.as_tensor(
                    pad_bits_words(n_real, w * 32, w).view(np.int32),
                    device=device,
                )
                if seen_pairs is not None and len(seen_pairs):
                    sp = np.asarray(seen_pairs, np.int64)
                    su = np.sort(sp[:, 0])
                    # Per-user seen counts (the retrieve-depth cap) and
                    # sorted (u, i) keys (the vectorized filter).
                    self._seen_indptr = np.searchsorted(
                        su, np.arange(num_users + 1)
                    )
                    kmul = np.int64(self._item_pad.shape[0])
                    self._seen_keys = np.sort(sp[:, 0] * kmul + sp[:, 1])
        # Device copies of the histories, uploaded once.
        self._his_dev = None if his_items is None else _int32_on(his_items, device)
        self._masks_dev = None if his_masks is None else _int32_on(his_masks, device)

    @staticmethod
    def _zero_pad_rows(table: torch.Tensor, rows: int) -> torch.Tensor:
        pad = rows - int(table.shape[0])
        if pad <= 0:
            return table
        return torch.cat([table, table.new_zeros((pad, table.shape[1]))])

    @classmethod
    def from_engine(
        cls,
        engine,
        seen_pairs: Optional[np.ndarray] = None,
        his_items=None,
        his_masks=None,
        user_tile: int = 512,
    ) -> "Recommender":
        """Serve from a live single-process engine: a snapshot of its
        unpadded state, and by default its train pairs as the seen pairs
        and its histories. The engine's steps update its tables in place,
        so the tables and ``w0`` are copied here: further training does
        not change what this Recommender serves (``attn_q`` too). (The JAX package also
        gathers multi-host table shards here; that waits for the port's
        multi-device slice, ROADMAP item 15.)"""
        if seen_pairs is None:
            seen_pairs = np.asarray(engine.train_data.pairs)
        if his_items is None:
            his_items, his_masks = engine.his_items, engine.his_masks
        live = engine.unpadded_state()
        snapshot = TrainState(
            user_emb=live.user_emb.clone(),
            item_emb=live.item_emb.clone(),
            w0=live.w0.clone(),
            lr=live.lr.clone(),
            step=live.step.clone(),
            attn_q=None if live.attn_q is None else live.attn_q.clone(),
        )
        return cls(
            snapshot,
            engine.cfg,
            seen_pairs=seen_pairs,
            his_items=his_items,
            his_masks=his_masks,
            user_tile=user_tile,
        )

    def _require_history(self) -> None:
        if self._his_dev is None or self._masks_dev is None:
            raise ValueError("aggregate_users requires history arrays")

    def _user_embeddings(self, aggregate_users: bool) -> torch.Tensor:
        """The user table, or every user freshly aggregated over the pools
        of the whole table (``compute_user_pools``: under self-attention
        with bf16 tables that raises ``TypeError``, as the JAX package
        does, the f32 query pooling in f32)."""
        user_emb = self.state.user_emb
        if not aggregate_users:
            return user_emb
        self._require_history()
        pooled = compute_user_pools(
            self.state.item_emb, self._his_dev, self._masks_dev,
            user_emb=(user_emb if self.cfg.aggregator == "user_attention"
                      else None),
            attn_q=self.state.attn_q, aggregator=self.cfg.aggregator,
        )
        return aggregate_history(user_emb, pooled, self.state.w0, self.cfg.gamma)

    def recommend_all(self, k: int, aggregate_users: bool = False) -> np.ndarray:
        """(U, k) top item ids for every user."""
        _, ids = self._evaluator.topk(
            self._user_embeddings(aggregate_users), self.state.item_emb, k
        )
        return ids.cpu().numpy()

    def _user_rows(self, uids: torch.Tensor, aggregate_users: bool) -> torch.Tensor:
        """(B, d) embeddings of the requested users only (kernel K2). With
        ``aggregate_users`` their histories are pooled with the numerics of
        the whole-table path (``compute_user_pools``), so a request's
        ranking matches ``recommend_all``'s: the mean by kernel K1; the
        attention kinds over their (B, H) history rows read by K2, with the
        f32 ``attn_q`` as it is (bf16 rows then pool in f32, as in the JAX
        package) or the requested user rows as queries."""
        u = gather_rows(self.state.user_emb, uids)
        if not aggregate_users:
            return u
        self._require_history()
        item_emb = self.state.item_emb
        if self.cfg.aggregator == "mean":
            pooled = history_mean_fused(
                item_emb, self._his_dev, self._masks_dev, rows=uids
            )
        else:
            ids = self._his_dev.index_select(0, uids)
            rows = gather_rows(item_emb, ids.view(-1)).view(
                *ids.shape, item_emb.shape[1])
            pooled = pool_history(
                rows, self._masks_dev.index_select(0, uids), u=u,
                attn_q=self.state.attn_q, kind=self.cfg.aggregator,
            )
        return aggregate_history(u, pooled, self.state.w0, self.cfg.gamma)

    def recommend(
        self,
        user_ids: Sequence[int],
        k: int,
        aggregate_users: bool = False,
        exact: bool = True,
        recall_target: float = 0.95,
    ) -> np.ndarray:
        """(len(user_ids), k) top item ids for the requested users.

        Scores only the requested rows, on the route fixed at construction
        (module docstring); request batches are padded to power-of-two
        buckets (at least 8). A table without a packed seen-mask on the
        one-shot route, a request covering most of the users, and a
        retrieve depth above 4096 rank the whole table instead.
        ``exact=False`` checks ``recall_target`` on the three routes, where
        the JAX package's ``approx_max_k`` checks it, and selects exactly as
        ``approx_max_k`` does off a TPU; the whole-table fallbacks ignore
        the target, as the JAX package's do.
        """
        uids_np = np.asarray(user_ids, np.int64)
        if uids_np.size == 0:
            return np.zeros((0, k), np.int32)
        num_users = int(self.state.user_emb.shape[0])
        if uids_np.min() < 0 or uids_np.max() >= num_users:
            raise IndexError(
                f"user ids must be in [0, {num_users}); got range "
                f"[{uids_np.min()}, {uids_np.max()}]"
            )
        b = int(uids_np.size)
        bpad = max(8, 1 << (b - 1).bit_length())
        k2 = 0
        if self._bits_flat is None:
            # Routing guards before the row gather: each of these discards
            # the request rows.
            if not self._chunked_request or 2 * bpad >= num_users:
                # No bitmap on a small table, or a request covering most
                # users: the tiled whole-table ranking.
                return self.recommend_all(k, aggregate_users)[uids_np]
            cap = 0
            if self._seen_indptr is not None:
                counts = (
                    self._seen_indptr[uids_np + 1] - self._seen_indptr[uids_np]
                )
                cap = int(counts.max())
            # Round the retrieve depth to a multiple of 64.
            k2 = -(-(k + cap) // 64) * 64
            if k2 > 4096:
                # A requested user has thousands of seen items: rank the
                # whole table (correct, slower).
                return self.recommend_all(k, aggregate_users)[uids_np]
        check_recall_target(exact, recall_target)
        uids = torch.as_tensor(
            uids_np.astype(np.int32), device=self.state.user_emb.device
        )
        rows = self._zero_pad_rows(self._user_rows(uids, aggregate_users), bpad)
        if self._bits_flat is not None:
            bits = self._bits_flat.index_select(0, uids.long())
            bits = torch.cat([bits, bits.new_zeros((bpad - b, bits.shape[1]))])
            if self._chunked_request:
                ids = _topk_request_chunked(
                    rows, self._item_pad, bits, k, self._request_chunk(bpad)
                )
            else:
                ids = _topk_request(rows, self._item_pad, bits, k)
            return ids[:b].cpu().numpy().astype(np.int32)
        bits = self._pad_bits_row[None, :].expand(bpad, -1)
        ids2 = _topk_request_chunked(
            rows, self._item_pad, bits, k2, self._request_chunk(bpad)
        )
        ids2 = ids2[:b].cpu().numpy()
        # Drop pad ids (possible only when fewer than k2 real items remain)
        # and seen ids, keeping rank order: a stable argsort of the drop
        # flag puts the first k kept ids in front.
        drop = ids2 >= int(self.state.item_emb.shape[0])
        if self._seen_keys is not None:
            keys = uids_np[:, None] * np.int64(self._item_pad.shape[0]) + ids2
            pos = np.searchsorted(self._seen_keys, keys)
            last = len(self._seen_keys) - 1
            drop |= self._seen_keys[np.minimum(pos, last)] == keys
        order = np.argsort(drop, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(ids2, order, axis=1).astype(np.int32)

    @staticmethod
    def _request_chunk(bpad: int) -> int:
        """Item-axis chunk for _topk_request_chunked: starts at the pad
        multiple and halves until the (B, chunk) score buffer is about
        256 MB, floored at 32768 rows (always divides the chunk-padded
        item count: both are powers of two times the multiple)."""
        chunk = _REQUEST_PAD_MULTIPLE
        while chunk * bpad > (1 << 26) and chunk > 32_768:
            chunk //= 2
        return chunk

    def recommend_cold(
        self,
        histories: Sequence[Sequence[int]],
        k: int,
        exclude_history: bool = True,
    ) -> np.ndarray:
        """(len(histories), k) top item ids for users without a trained row.

        The user vector is the aggregation without its ``gamma * u`` term,
        ``u = (1 - gamma) * pool(history rows) @ w0``, scored by cosine
        against the item table. The pool follows ``cfg.aggregator``: the
        mean through kernel K1; self-attention with ``attn_q`` cast to the
        table's type; user-attention with the history mean as its query,
        there being no user row to attend with (the JAX package's rule);
        the attention kinds over history rows read by K2. The given history
        is masked out (finfo(f32).min) when ``exclude_history``.
        """
        n = len(histories)
        if n == 0:
            return np.zeros((0, k), np.int32)
        item_emb = self.state.item_emb
        num_items = int(item_emb.shape[0])
        h = max(1, max(len(hist) for hist in histories))
        ids = np.zeros((n, h), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, hist in enumerate(histories):
            hist = np.asarray(hist, np.int64)
            if hist.size and (hist.min() < 0 or hist.max() >= num_items):
                raise IndexError(
                    f"history item ids must be in [0, {num_items})"
                )
            ids[i, : len(hist)] = hist
            lens[i] = len(hist)
        device = item_emb.device
        ids_dev = torch.as_tensor(ids, device=device)
        lens_dev = torch.as_tensor(lens, device=device)
        compute = item_emb.dtype
        pooled = None  # the mean, and user-attention's query
        if self.cfg.aggregator != "self_attention":
            pooled = history_mean_fused(item_emb, ids_dev, lens_dev)
        if self.cfg.aggregator != "mean":
            rows = gather_rows(item_emb, ids_dev.view(-1)).view(
                n, h, item_emb.shape[1])
            attn_q = self.state.attn_q
            pooled = pool_history(
                rows, lens_dev, u=pooled,
                attn_q=None if attn_q is None else attn_q.to(compute),
                kind=self.cfg.aggregator,
            )
        # In the item table's type, with f32 norms and f32 scores, as the
        # JAX package computes them (a bf16 table serves in bf16).
        # JAX rounds the Python scalar to the operand's type first.
        u = scalar_in(1.0 - self.cfg.gamma, compute) * (
            pooled @ self.state.w0.to(compute))
        u = u / torch.linalg.vector_norm(
            u.float(), dim=1, keepdim=True
        ).clamp(min=1e-12).to(compute)
        it = item_emb / torch.linalg.vector_norm(
            item_emb.float(), dim=1, keepdim=True
        ).clamp(min=1e-12).to(compute)
        sims = (u @ it.T).float()  # (n, I)
        if exclude_history:
            r, p = np.nonzero(np.arange(h)[None, :] < lens[:, None])
            # finfo.min, not -inf: masked scores stay finite.
            sims[
                torch.as_tensor(r, device=device),
                torch.as_tensor(ids[r, p].astype(np.int64), device=device),
            ] = NEG_INF
        _, top = masked_topk(sims, None, k)
        return top.cpu().numpy().astype(np.int32)
