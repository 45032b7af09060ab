"""One training step: gather -> history mean -> score -> loss -> grad ->
duplicate-safe row update.

Counterpart of the uniform-sampler / mean-aggregator / batch-mode SGD
branch of ``heat_tpu/train/train_step.py`` ``train_step``:

1. gather the user, positive and negative rows (kernel K2);
2. the masked history mean of each sample's user (kernel K1), outside
   autograd: history rows never receive a gradient;
3. aggregation, cosine (or dot) scores and the loss, differentiated by
   autograd with respect to the gathered rows and ``w0`` only (leaf
   tensors made from the gathered rows, never the whole tables);
4. the user table takes the aggregated rows (write-back) and then its SGD
   update, the item table its SGD update; both accumulate duplicate ids
   with kernel K3 before the clip (``train/scatter.py``);
5. ``w0 -= lr * grad_w0 / aggr_minibatch``.

Padding entries carry weight 0: their losses and gradients vanish and
their ids are redirected to the drop sentinel (the table size), so neither
the write-back nor the update touches a real row through them.

The step reads the tables once at batch start and returns new tensors;
nothing in it waits for the device.
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
from heat_tpu_torch.ops.losses import sample_losses
from heat_tpu_torch.ops.similarity import pair_scores
from heat_tpu_torch.train.samplers import SamplerState, sample_negatives
from heat_tpu_torch.train.scatter import apply_row_updates


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

    num_users, num_items = user_emb.shape[0], item_emb.shape[0]
    valid = weight > 0
    users_w = torch.where(valid, users, num_users)
    pos_w = torch.where(valid, pos, num_items)
    negs_w = torch.where(valid[:, None], negs, num_items)

    user_emb = apply_row_updates(
        user_emb, users_w, g_u, lr=state.lr, clip_val=cfg.clip_val,
        writeback=u_agg.detach(),
    )
    item_ids = torch.cat([pos_w, negs_w.reshape(-1)])
    item_grads = torch.cat([g_p, g_n.reshape(-1, d)])
    item_emb = apply_row_updates(
        item_emb, item_ids, item_grads, lr=state.lr, clip_val=cfg.clip_val
    )
    # B / aggr_minibatch reference updates of w0 collapsed into one.
    w0 = w0 - state.lr * g_w0 / cfg.aggr_minibatch

    state = TrainState(
        user_emb=user_emb,
        item_emb=item_emb,
        w0=w0,
        lr=state.lr,
        step=state.step + (real > 0).to(state.step.dtype),
    )
    return state, sampler_state, loss_sum.detach()
