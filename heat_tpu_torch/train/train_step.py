"""One training step: gather -> history mean -> score -> loss -> grad ->
duplicate-safe row update.

Counterpart of the uniform-sampler / mean-aggregator branches of
``heat_tpu/train/train_step.py`` ``train_step``:

1. gather the user, positive and negative rows (kernel K2);
2. the masked history mean of each sample's user (kernel K1), outside
   autograd: history rows never receive a gradient;
3. aggregation, cosine (or dot) scores and the loss, differentiated by
   autograd with respect to the gathered rows and ``w0`` only (leaf
   tensors made from the gathered rows, never the whole tables);
4. under ``sgd_mode: accum``, the stale accumulated user rows' term of the
   ``w0`` gradient;
5. the user table takes the aggregated rows (write-back) and then its
   update, the item table its update, each by ``cfg.update_mode`` and
   ``cfg.optimizer``: combined-row SGD (batch or accum mode, with the
   write-back fused on the sorted path), per-occurrence SGD (``direct``),
   or row-sparse Adagrad / lazy Adam; each optionally with l2
   (``train/scatter.py`` picks the dense or sort-dedup path per table);
6. ``w0`` by SGD, or by Adagrad/Adam gated on the batch holding real
   samples.

Padding entries carry weight 0: their losses and gradients vanish and
their ids are redirected to the drop sentinel (the table size), so neither
the write-back nor the update touches a real row through them. The
1-based ``step`` counts batches with real samples; an all-padding batch is
not an optimizer step.

The step reads the tables once at batch start. It updates the tables, the
gradient rows and the table slots in place and returns a new TrainState
holding them; nothing in it waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.aggregator import (
    aggregate_history,
    history_mean_fused,
)
from heat_tpu_torch.models.state import TrainState
from heat_tpu_torch.ops.cuda.gather import gather_rows
from heat_tpu_torch.ops.cuda.scatter import scatter_set_rows
from heat_tpu_torch.ops.losses import sample_losses
from heat_tpu_torch.ops.similarity import pair_scores
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
) -> tuple[TrainState, SamplerState, torch.Tensor]:
    """One minibatch step. Returns (state', sampler_state', loss_sum) with
    loss_sum a 0-d tensor on the step's device."""
    users, pos, weight = batch
    real = weight.sum().to(torch.int32)
    sample, sampler_state = sample_negatives(
        generator, sampler_state, pos, cfg, real=real
    )
    negs = sample.ids
    b, k = negs.shape
    user_emb, item_emb, w0 = state.user_emb, state.item_emb, state.w0
    d = item_emb.shape[1]

    u_rows = gather_rows(user_emb, users)
    p_rows = gather_rows(item_emb, pos)
    n_rows = gather_rows(item_emb, negs.reshape(-1)).view(b, k, d)
    with torch.no_grad():
        his_ids = his_items.index_select(0, users.long())
        means = history_mean_fused(
            item_emb, his_ids, his_masks.index_select(0, users.long())
        )

    u_l, p_l, n_l, w0_l = (
        t.detach().requires_grad_() for t in (u_rows, p_rows, n_rows, w0)
    )
    u_agg = aggregate_history(u_l, means, w0_l, cfg.gamma)
    s_up, s_un = pair_scores(u_agg, p_l, n_l, similarity=cfg.similarity)
    loss_sum = (sample_losses(s_up, s_un, cfg) * weight).sum()
    g_u, g_p, g_n, g_w0 = torch.autograd.grad(loss_sum, (u_l, p_l, n_l, w0_l))

    if state.user_gacc is not None:
        # Accum mode: the reference's aggregator backward works on the
        # persistent user-grad row, so the w0 gradient also holds the stale
        # accumulated rows' term (f32 GEMM; the engine turns TF32 off).
        prev_acc = gather_rows(state.user_gacc, users)
        g_w0 = g_w0 + (1.0 - cfg.gamma) * (
            (means * weight[:, None]).T @ prev_acc
        )

    num_users, num_items = user_emb.shape[0], item_emb.shape[0]
    valid = weight > 0
    users_w = torch.where(valid, users, num_users)
    pos_w = torch.where(valid, pos, num_items)
    negs_w = torch.where(valid[:, None], negs, num_items)
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

    # Item table: positives and negatives in one deduplicated update.
    item_ids = torch.cat([pos_w, negs_w.reshape(-1)])
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
