"""One training step: gather -> history mean -> score -> loss -> grad ->
duplicate-safe row update.

Counterpart of the mean-aggregator branches of
``heat_tpu/train/train_step.py`` ``train_step``:

1. gather the user and positive rows and the negatives' rows (kernel K2),
   cast to ``cfg.compute_dtype``: with the tile sampler in batch mode the
   T rows of the tile, once, and the draws enter only as per-(sample,
   slot) multiplicities; otherwise the (B, K) sampled rows;
2. the pooled history of each sample's user, outside autograd (history
   rows never receive a gradient): the cached pool rows
   ``user_means[users]`` (K2) under ``his_refresh: subepoch``; with the
   engine's dedup maps the masked mean once per distinct user (kernel K1
   over (Bu, H) ids) read back per sample (K2); else the masked mean per
   sample (K1);
3. aggregation, cosine (or dot) scores and the loss, differentiated by
   autograd with respect to the gathered rows and ``w0`` only (leaf
   tensors made from the gathered rows, never the whole tables); the
   tile path scores with one (B, d) x (d, T) product, and its (T, d)
   gradient holds one row per tile slot;
4. under ``sgd_mode: accum``, the stale accumulated user rows' term of the
   ``w0`` gradient;
5. the user table takes the aggregated rows (write-back) and then its
   update, the item table its update, each by ``cfg.update_mode`` and
   ``cfg.optimizer``: combined-row SGD (batch or accum mode, with the
   write-back fused on the sorted path), per-occurrence SGD (``direct``),
   or row-sparse Adagrad / lazy Adam; each optionally with l2
   (``train/scatter.py`` picks the dense or sort-dedup path per table);
   the item update covers B + T rows on the tile path, B * (1 + K)
   otherwise; gradients are cast to f32 first;
6. ``w0`` by SGD, or by Adagrad/Adam gated on the batch holding real
   samples.

Padding entries carry weight 0: their losses and gradients vanish and
their ids are redirected to the drop sentinel (the table size), so neither
the write-back nor the update touches a real row through them. The
1-based ``step`` counts batches with real samples; an all-padding batch is
not an optimizer step.

With bf16 tables or compute the step rounds where the JAX step does: at
the casts of the gathered rows, at the end of K1, at the aggregation's
product and its three elementwise operations, at the casts of the
gradients back to the rows' type, and at every table write. Scores and
losses are f32.

The step reads the tables once at batch start. It updates the tables, the
gradient rows and the table slots in place and returns a new TrainState
holding them; nothing in it waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.aggregator import (
    aggregate_history,
    history_mean_fused,
)
from heat_tpu_torch.models.state import TrainState, torch_dtype
from heat_tpu_torch.ops.cuda.gather import gather_rows
from heat_tpu_torch.ops.cuda.scatter import scatter_set_rows
from heat_tpu_torch.ops.losses import sample_losses, sample_losses_weighted
from heat_tpu_torch.ops.similarity import pair_scores, tile_scores
from heat_tpu_torch.train.samplers import SamplerState, sample_negatives
from heat_tpu_torch.train.scatter import (
    apply_row_updates,
    apply_row_updates_direct,
    apply_row_updates_opt,
    dense_opt_update,
)


class Batch(NamedTuple):
    users: torch.Tensor   # (B,) int32
    pos: torch.Tensor     # (B,) int32
    weight: torch.Tensor  # (B,) f32 — 1 for real samples, 0 for padding


def train_step(
    state: TrainState,
    sampler_state: SamplerState,
    generator: torch.Generator,
    batch: Batch,
    his_items: torch.Tensor,
    his_masks: torch.Tensor,
    cfg: CFConfig,
    user_means: Optional[torch.Tensor] = None,
    uniq_users: Optional[torch.Tensor] = None,
    uniq_inverse: Optional[torch.Tensor] = None,
) -> tuple[TrainState, SamplerState, torch.Tensor]:
    """One minibatch step. Returns (state', sampler_state', loss_sum) with
    loss_sum a 0-d tensor on the step's device.

    user_means: optional precomputed (U, d) pooled-history table
      (cfg.his_refresh == "subepoch"); None recomputes the means from the
      live item table every step.
    uniq_users / uniq_inverse: optional history-gather dedup
      (his_refresh == "step" only): uniq_users (Bu,) int32 lists the
      batch's distinct user ids (padded by repetition), uniq_inverse (B,)
      int32 maps each sample to its slot. Every read of a step sees the
      batch-start tables, so repeated users have identical means: pooling
      once per distinct user is an exact rewrite. The engine computes the
      maps per fixed batch stream (``Engine._history_dedup``).
    """
    users, pos, weight = batch
    real = weight.sum().to(torch.int32)
    sample, sampler_state = sample_negatives(
        generator, sampler_state, pos, cfg, real=real
    )
    negs = sample.ids
    b, k = negs.shape
    user_emb, item_emb, w0 = state.user_emb, state.item_emb, state.w0
    d = item_emb.shape[1]
    compute = torch_dtype(cfg.compute_dtype)
    # Whole-tile scoring is batch-mode only: accum mode treats every
    # updated id as touched, so folding gradients onto all T tile rows
    # would re-apply accumulated rows that got no fresh gradient. It falls
    # back to the gathered tile[idx] rows.
    tiled = sample.tile is not None and state.item_gacc is None

    u_rows = gather_rows(user_emb, users).to(compute)
    p_rows = gather_rows(item_emb, pos).to(compute)
    if tiled:
        tile_ids = sample.tile
        n_rows = gather_rows(item_emb, tile_ids).to(compute)  # (T, d)
        # counts[b, t]: how many of sample b's K draws hit tile slot t.
        # Exact small integers, so the order of the adds does not matter.
        counts = torch.zeros(
            (b, tile_ids.shape[0]), dtype=torch.float32, device=negs.device
        ).scatter_add_(
            1, sample.tile_idx.long(),
            torch.ones((b, k), dtype=torch.float32, device=negs.device),
        )
    else:
        n_rows = gather_rows(item_emb, negs.reshape(-1)).view(b, k, d).to(compute)
    with torch.no_grad():
        if user_means is not None:
            means = gather_rows(user_means, users).to(compute)
        elif uniq_users is not None:
            idx = uniq_users.long()
            means_u = history_mean_fused(
                item_emb, his_items.index_select(0, idx),
                his_masks.index_select(0, idx), compute,
            )
            means = gather_rows(means_u, uniq_inverse)
        else:
            idx = users.long()
            means = history_mean_fused(
                item_emb, his_items.index_select(0, idx),
                his_masks.index_select(0, idx), compute,
            )

    u_l, p_l, n_l, w0_l = (
        t.detach().requires_grad_() for t in (u_rows, p_rows, n_rows, w0)
    )
    u_agg = aggregate_history(u_l, means, w0_l, cfg.gamma)
    if tiled:
        s_up, S = tile_scores(u_agg, p_l, n_l, similarity=cfg.similarity)
        losses = sample_losses_weighted(s_up, S, counts, cfg.num_negs, cfg)
    else:
        s_up, s_un = pair_scores(u_agg, p_l, n_l, similarity=cfg.similarity)
        losses = sample_losses(s_up, s_un, cfg)
    loss_sum = (losses * weight).sum()
    # The row gradients stay in the compute type: the updates widen them
    # where they first read them (bf16 to f32 is exact).
    g_u, g_p, g_n, g_w0 = torch.autograd.grad(loss_sum, (u_l, p_l, n_l, w0_l))

    if state.user_gacc is not None:
        # Accum mode: the reference's aggregator backward works on the
        # persistent user-grad row, so the w0 gradient also holds the stale
        # accumulated rows' term (f32 GEMM; the engine turns TF32 off).
        prev_acc = gather_rows(state.user_gacc, users).float()
        g_w0 = g_w0 + (1.0 - cfg.gamma) * (
            (means.float() * weight[:, None]).T @ prev_acc
        )

    num_users, num_items = user_emb.shape[0], item_emb.shape[0]
    valid = weight > 0
    users_w = torch.where(valid, users, num_users)
    pos_w = torch.where(valid, pos, num_items)
    u_agg = u_agg.detach()
    l2 = cfg.l2 if cfg.l2_enabled else 0.0
    step1 = state.step + (real > 0).to(state.step.dtype)
    moments = dict(lr=state.lr, step=step1, beta1=cfg.adam_beta1,
                   beta2=cfg.adam_beta2, eps=cfg.opt_eps)
    opt = dict(clip_val=cfg.clip_val, l2=l2, **moments)
    sgd = dict(lr=state.lr, clip_val=cfg.clip_val, l2=l2)
    opt_slots = None if state.opt_slots is None else dict(state.opt_slots)

    # User table: the aggregated rows replace the rows, then the update.
    # In batch mode the write-back rides the update's own scatter; accum
    # mode writes it first (its update reads the persistent grad rows).
    user_gacc = item_gacc = None
    if state.user_gacc is not None:
        scatter_set_rows(user_emb, users_w, u_agg)
        u_writeback = None
    else:
        u_writeback = u_agg
    if cfg.update_mode == "direct":
        # Config validation guarantees batch-mode SGD here.
        user_emb = apply_row_updates_direct(
            user_emb, users_w, g_u, rows=u_agg if l2 else None,
            writeback=u_writeback, **sgd,
        )
    elif cfg.optimizer == "sgd":
        user_emb, user_gacc = apply_row_updates(
            user_emb, users_w, g_u, gacc=state.user_gacc, decay=cfg.gamma,
            writeback=u_writeback, **sgd,
        )
    else:
        # The slot tables are updated in place.
        apply_row_updates_opt(
            user_emb, users_w, g_u, m=opt_slots.get("user_m"),
            v=opt_slots["user_v"], writeback=u_writeback, **opt,
        )

    # Item table: positives and negatives in one deduplicated update. On
    # the tile path g_n already is the per-tile-row gradient (T, d): the
    # update touches B + T rows, not B * (1 + K), and each slot of the tile
    # (repeated ids included) is one occurrence. Weight-0 samples put no
    # gradient into the tile rows, so only their positives need the
    # sentinel.
    if tiled:
        neg_ids = tile_ids
    else:
        neg_ids = torch.where(valid[:, None], negs, num_items).reshape(-1)
    item_ids = torch.cat([pos_w, neg_ids])
    item_grads = torch.cat([g_p, g_n.reshape(-1, d)])
    del g_n  # 134 MB at B = 32,768, K = 16: freed before the update's buffers
    if cfg.update_mode == "direct":
        item_rows = torch.cat([p_rows, n_rows.reshape(-1, d)]) if l2 else None
        item_emb = apply_row_updates_direct(
            item_emb, item_ids, item_grads, rows=item_rows, **sgd
        )
    elif cfg.optimizer == "sgd":
        item_emb, item_gacc = apply_row_updates(
            item_emb, item_ids, item_grads, gacc=state.item_gacc, **sgd
        )
    else:
        apply_row_updates_opt(
            item_emb, item_ids, item_grads, m=opt_slots.get("item_m"),
            v=opt_slots["item_v"], **opt,
        )

    # w0: B / aggr_minibatch reference updates collapsed into one.
    if cfg.optimizer == "sgd":
        w0 = w0 - state.lr * g_w0 / cfg.aggr_minibatch
    else:
        # Dense moment updates are not no-ops at zero gradient (Adam
        # decays its moments, Adagrad divides by sqrt(v)), so an
        # all-padding batch must leave w0 and its slots untouched.
        has_real = real > 0
        w0_new, slots_new = dense_opt_update(
            w0, g_w0 / cfg.aggr_minibatch, opt_slots, "w0", **moments
        )
        for key in ("w0_m", "w0_v"):
            if key in slots_new:
                opt_slots[key] = torch.where(
                    has_real, slots_new[key], opt_slots[key]
                )
        w0 = torch.where(has_real, w0_new, w0)

    state = TrainState(
        user_emb=user_emb,
        item_emb=item_emb,
        w0=w0,
        lr=state.lr,
        step=step1,
        user_gacc=user_gacc,
        item_gacc=item_gacc,
        opt_slots=opt_slots,
    )
    return state, sampler_state, loss_sum.detach()
