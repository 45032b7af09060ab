"""One training step: gather -> history pooling -> score -> loss -> grad
-> duplicate-safe row update.

Counterpart of ``heat_tpu/train/train_step.py`` ``train_step``:

1. under a sub-epoch's negative pool (``neg_candidates``), remap the tile
   on the tile path, the draws otherwise, through it (``pool[id % size]``;
   the sampler keeps the raw tile); gather the
   user and positive rows and the negatives' rows, cast to
   ``cfg.compute_dtype``, in one launch of kernel K2's multi-table entry:
   with the tile sampler in batch mode the T rows of the tile, once, and
   the draws enter only as per-(sample, slot) multiplicities; otherwise the
   (B, K) sampled rows; under ``his_refresh: subepoch`` the same launch
   reads the cached pool rows ``user_means[users]``; under the attention
   aggregators with ``his_refresh: step`` it reads the (B, H) history rows
   (the (Bu, H) rows of the distinct users with the dedup maps);
2. the pooled history of each sample's user (history rows never receive a
   gradient): those pool rows; for the mean, outside autograd, with the
   engine's dedup maps the masked mean once per distinct user (kernel K1,
   which reads the (Bu,) users' histories out of the whole history table
   itself) read back per sample (K2), else the masked mean per sample (K1
   over the (B,) users); for self- and user-attention, inside the loss
   (``models/aggregator.py`` ``pool_history``), so that the query, a leaf
   of ``attn_q`` or the user row itself, gets its gradient; with the dedup
   maps once per distinct user, the user-attention query sliced from the
   user's first occurrence (``uniq_first``), then read back per sample;
3. aggregation, cosine (or dot) scores and the loss, differentiated by
   autograd with respect to the gathered rows, ``w0`` and ``attn_q`` only
   (leaf tensors made from the gathered rows, never the whole tables); the
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
   otherwise; the gradients stay in the compute type, and the updates
   widen them where they first read them;
6. ``w0`` and ``attn_q`` by SGD, or by Adagrad/Adam gated on the batch
   holding real samples.

Padding entries carry weight 0: their losses and gradients vanish and
their ids are redirected to the drop sentinel (the table size), so neither
the write-back nor the update touches a real row through them. The
1-based ``step`` counts batches with real samples; an all-padding batch is
not an optimizer step.

With bf16 tables or compute the step rounds where the JAX step does: at
the casts of the gathered rows, at the end of K1, at each operation of the
attention pooling's forward, at the aggregation's product and its three
elementwise operations, at the casts of the gradients back to the rows'
type, and at every table write. Scores and losses are f32.

The step reads the tables once at batch start. It updates every tensor of
the state in place (the tables, the gradient rows, the table slots, ``w0``,
``attn_q``, their slots and ``step``; the sampler's ``iterations`` and
``tile`` in ``sample_negatives``) and returns the same TrainState and SamplerState
objects; nothing in it waits for the device or copies from the host. So
one step can be captured into a CUDA graph and replayed against the same
addresses: :func:`make_epoch_fn` runs an epoch of such replays.

The step's regions carry the reference's phase names as
``torch.profiler.record_function`` labels, the names the JAX step gives its
``jax.named_scope`` labels: ``data`` (the draws), ``read_emb`` (the row
reads), ``read_his`` and ``aggr_f`` (the history and its pooling), ``grad``
(the forward and backward, with ``his_mm``, ``dot`` and ``loss`` inside),
``write_emb`` (the table updates) and ``aggr_b`` (``w0`` and ``attn_q``).
They run in Python: a profiler trace shows them around eager steps and the
capture's warm-up step; a replayed step runs no Python, and its trace shows
the graph's kernels by name without them.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Optional

import torch
from torch.profiler import record_function

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.aggregator import (
    aggregate_history,
    history_mean_fused,
    pool_history,
)
from heat_tpu_torch.models.state import TrainState, torch_dtype
from heat_tpu_torch.ops.cuda.gather import (
    gather_rows,
    gather_rows_multi,
    history_mean_gather,
)
from heat_tpu_torch.ops.cuda.scatter import scatter_set_rows
from heat_tpu_torch.ops.losses import sample_losses, sample_losses_weighted
from heat_tpu_torch.ops.similarity import pair_scores, tile_scores
from heat_tpu_torch.train.samplers import (
    SamplerState,
    sample_negatives,
    uniform_negatives,
)
from heat_tpu_torch.train.scatter import (
    apply_row_updates,
    apply_row_updates_direct,
    apply_row_updates_opt,
    apply_row_updates_reduced,
    dense_opt_update,
)


if TYPE_CHECKING:
    from heat_tpu_torch.parallel.mesh import TableShards


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
    neg_candidates: Optional[torch.Tensor] = None,
    neg_candidates_size: Optional[torch.Tensor] = None,
    uniq_first: Optional[torch.Tensor] = None,
    shards: Optional["TableShards"] = None,
) -> tuple[TrainState, SamplerState, torch.Tensor]:
    """One minibatch step. Returns (state', sampler_state', loss_sum) with
    loss_sum a 0-d tensor on the step's device.

    shards: the rank's table layout on a mesh (``parallel.mesh``): the
      step then runs :func:`train_step_sharded` on the rank's rows of the
      batch, and ``loss_sum`` is the whole batch's.

    neg_candidates: optional (C,) int32 item-id pool the negatives are
      drawn from (a sub-epoch's partition complement, the reference's
      engine.cpp:222-237); None draws from the whole item space. The draws
      are read as indices into the pool, ``pool[draw % size]``: on the
      tile path the T tile ids are remapped (the sampler keeps the raw
      tile), otherwise the (B, K) draws.
    neg_candidates_size: optional 0-d int32 tensor, the pool's valid
      prefix (the engine pads every sub-epoch's pool to one width, so pad
      entries are never drawn); None takes the pool's length.

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
    uniq_first: (Bu,) int32 index of each distinct user's first occurrence
      in the batch, required with the dedup maps under "user_attention":
      the per-user query is sliced from that occurrence of the
      differentiable user rows (repeated users read identical batch-start
      rows), so the query's gradient reaches the user update unchanged.
      Unused by the other aggregators.
    """
    if shards is not None:
        return train_step_sharded(state, sampler_state, generator, batch,
                                  his_items, his_masks, cfg, shards)
    users, pos, weight = batch
    user_emb, item_emb, w0 = state.user_emb, state.item_emb, state.w0
    d = item_emb.shape[1]
    compute = torch_dtype(cfg.compute_dtype)
    # The record_function labels are the reference's phase names, which the
    # JAX step gives its jax.named_scope's (utils/profiling.py).
    with record_function("data"):
        real = weight.sum().to(torch.int32)
        sample, sampler_state = sample_negatives(
            generator, sampler_state, pos, cfg, real=real
        )
        negs = sample.ids
        b, k = negs.shape
        # Whole-tile scoring is batch-mode only: accum mode treats every
        # updated id as touched, so folding gradients onto all T tile rows
        # would re-apply accumulated rows that got no fresh gradient. It
        # falls back to the gathered tile[idx] rows.
        tiled = sample.tile is not None and state.item_gacc is None
        tile_ids = sample.tile
        if neg_candidates is not None:
            size = (neg_candidates.shape[0] if neg_candidates_size is None
                    else neg_candidates_size)
            # Remapping the tile gives the ids remapping every draw would
            # (pool[tile % size][idx] == pool[tile[idx] % size]) at T reads.
            if tiled:
                tile_ids = neg_candidates.index_select(
                    0, torch.remainder(tile_ids, size))
            else:
                negs = neg_candidates.index_select(
                    0, torch.remainder(negs, size).view(-1)).view(b, k)

    # One launch reads every row the step needs from the batch-start tables,
    # cast to the compute type inside the kernel.
    segments = [(user_emb, users), (item_emb, pos)]
    if tiled:
        segments.append((item_emb, tile_ids))  # (T, d)
        # counts[b, t]: how many of sample b's K draws hit tile slot t.
        # Exact small integers, so the order of the adds does not matter.
        with record_function("read_emb"):
            counts = torch.zeros(
                (b, tile_ids.shape[0]), dtype=torch.float32,
                device=negs.device,
            ).scatter_add_(
                1, sample.tile_idx.long(),
                torch.ones((b, k), dtype=torch.float32, device=negs.device),
            )
    else:
        segments.append((item_emb, negs.reshape(-1)))
    if user_means is not None:
        segments.append((user_means, users))
    # The attention kinds pool inside the loss over the (B, H, d) history
    # rows (per distinct user with the dedup maps), one more segment of the
    # launch; they take no gradient.
    attention = cfg.aggregator != "mean" and user_means is None
    if attention:
        if (uniq_users is not None and cfg.aggregator == "user_attention"
                and uniq_first is None):
            raise ValueError(
                "user_attention history dedup requires uniq_first (the "
                "per-user query is sliced from the first occurrence of the "
                "differentiable user rows)")
        his_users = users if uniq_users is None else uniq_users
        with record_function("read_his"):
            segments.append(
                (item_emb, his_items.index_select(0, his_users).view(-1)))
    with record_function("read_emb"):
        u_rows, p_rows, n_rows, *extra_rows = gather_rows_multi(
            segments, compute)
    if not tiled:
        n_rows = n_rows.view(b, k, d)
    if user_means is not None:
        means = extra_rows[0]
    elif attention:
        his_embs = extra_rows[0].view(his_users.shape[0], -1, d)
        his_mask = his_masks.index_select(0, his_users)
    else:
        with torch.no_grad():
            if uniq_users is not None:
                with record_function("read_his"):
                    means_u = history_mean_fused(
                        item_emb, his_items, his_masks, compute,
                        rows=uniq_users,
                    )
                with record_function("aggr_f"):
                    means = gather_rows(means_u, uniq_inverse)
            else:
                with record_function("read_his"), record_function("aggr_f"):
                    means = history_mean_fused(
                        item_emb, his_items, his_masks, compute, rows=users
                    )

    with record_function("grad"):
        u_l, p_l, n_l, w0_l = (
            t.detach().requires_grad_() for t in (u_rows, p_rows, n_rows, w0)
        )
        leaves = [u_l, p_l, n_l, w0_l]
        if attention:
            q = None
            if cfg.aggregator == "self_attention":
                # The f32 query, cast to the compute type inside the loss.
                q_l = state.attn_q.detach().requires_grad_()
                leaves.append(q_l)
                q = q_l.to(compute)
            with record_function("aggr_f"):
                if uniq_users is None:
                    means = pool_history(his_embs, his_mask, u=u_l,
                                         attn_q=q, kind=cfg.aggregator)
                else:
                    u_first = (u_l.index_select(0, uniq_first)
                               if cfg.aggregator == "user_attention"
                               else None)
                    means = pool_history(his_embs, his_mask, u=u_first,
                                         attn_q=q, kind=cfg.aggregator
                                         ).index_select(0, uniq_inverse)
        with record_function("his_mm"):
            u_agg = aggregate_history(u_l, means, w0_l, cfg.gamma)
        with record_function("dot"):
            if tiled:
                s_up, S = tile_scores(u_agg, p_l, n_l,
                                      similarity=cfg.similarity)
            else:
                s_up, s_un = pair_scores(u_agg, p_l, n_l,
                                         similarity=cfg.similarity)
        with record_function("loss"):
            if tiled:
                losses = sample_losses_weighted(s_up, S, counts,
                                                cfg.num_negs, cfg)
            else:
                losses = sample_losses(s_up, s_un, cfg)
            loss_sum = (losses * weight).sum()
        # The row gradients stay in the compute type: the updates widen
        # them where they first read them (bf16 to f32 is exact).
        g_u, g_p, g_n, g_w0, *g_q = torch.autograd.grad(loss_sum, leaves)
    means = means.detach()

    if state.user_gacc is not None:
        # Accum mode: the reference's aggregator backward works on the
        # persistent user-grad row, so the w0 gradient also holds the stale
        # accumulated rows' term (f32 GEMM; the engine turns TF32 off).
        with record_function("aggr_b"):
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
    state.step.add_((real > 0).to(state.step.dtype))  # 1-based from here on
    moments = dict(lr=state.lr, step=state.step, beta1=cfg.adam_beta1,
                   beta2=cfg.adam_beta2, eps=cfg.opt_eps)
    opt = dict(clip_val=cfg.clip_val, l2=l2, **moments)
    sgd = dict(lr=state.lr, clip_val=cfg.clip_val, l2=l2)
    opt_slots = state.opt_slots

    with record_function("write_emb"):
        # User table: the aggregated rows replace the rows, then the update.
        # In batch mode the write-back rides the update's own scatter; accum
        # mode writes it first (its update reads the persistent grad rows).
        # Every update below works in place on the state's tensors.
        if state.user_gacc is not None:
            scatter_set_rows(user_emb, users_w, u_agg)
            u_writeback = None
        else:
            u_writeback = u_agg
        if cfg.update_mode == "direct":
            # Config validation guarantees batch-mode SGD here.
            apply_row_updates_direct(
                user_emb, users_w, g_u, rows=u_agg if l2 else None,
                writeback=u_writeback, **sgd,
            )
        elif cfg.optimizer == "sgd":
            apply_row_updates(
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
        # On the tile path g_n already is the per-tile-row gradient (T, d):
        # the update touches B + T rows, not B * (1 + K), and each slot of
        # the tile (repeated ids included) is one occurrence. Weight-0 samples put no
        # gradient into the tile rows, so only their positives need the
        # sentinel.
        if tiled:
            neg_ids = tile_ids
        else:
            neg_ids = torch.where(valid[:, None], negs, num_items).reshape(-1)
        item_ids = torch.cat([pos_w, neg_ids])
        item_grads = torch.cat([g_p, g_n.reshape(-1, d)])
        # 134 MB at B = 32,768, K = 16: freed before the update's buffers.
        del g_n
        if cfg.update_mode == "direct":
            item_rows = (torch.cat([p_rows, n_rows.reshape(-1, d)])
                         if l2 else None)
            apply_row_updates_direct(
                item_emb, item_ids, item_grads, rows=item_rows, **sgd
            )
        elif cfg.optimizer == "sgd":
            apply_row_updates(
                item_emb, item_ids, item_grads, gacc=state.item_gacc, **sgd
            )
        else:
            apply_row_updates_opt(
                item_emb, item_ids, item_grads, m=opt_slots.get("item_m"),
                v=opt_slots["item_v"], **opt,
            )

    with record_function("aggr_b"):
        # w0 (and attn_q): B / aggr_minibatch reference updates collapsed into
        # one.
        dense = [("w0", w0, g_w0)]
        if g_q:
            dense.append(("attn_q", state.attn_q, g_q[0]))
        if cfg.optimizer == "sgd":
            for _, param, g in dense:
                param.sub_(state.lr * g / cfg.aggr_minibatch)
        else:
            # Dense moment updates are not no-ops at zero gradient (Adam
            # decays its moments, Adagrad divides by sqrt(v)), so an
            # all-padding batch must leave w0, attn_q and their slots
            # untouched.
            has_real = real > 0
            for name, param, g in dense:
                new, slots_new = dense_opt_update(
                    param, g / cfg.aggr_minibatch, opt_slots, name, **moments
                )
                for key in (name + "_m", name + "_v"):
                    if key in slots_new:
                        opt_slots[key].copy_(torch.where(
                            has_real, slots_new[key], opt_slots[key]))
                param.copy_(torch.where(has_real, new, param))
    return state, sampler_state, loss_sum.detach()


def train_step_sharded(
    state: TrainState,
    sampler_state: SamplerState,
    generator: torch.Generator,
    batch: Batch,
    his_items: torch.Tensor,
    his_masks: torch.Tensor,
    cfg: CFConfig,
    shards: "TableShards",
) -> tuple[TrainState, SamplerState, torch.Tensor]:
    """One step on a ("data", "model") mesh: the counterpart of the JAX
    step under GSPMD, with its collectives written out. The slice of
    ROADMAP item 15a: uniform negatives, the history mean recomputed every
    step, the mean aggregator, batch-mode SGD with the combined-row clip
    over dense accumulators, f32 (the engine refuses the rest).

    ``batch`` holds this rank's rows of the global batch (data index d
    holds rows ``[d * b, (d + 1) * b)``, b = its width); user and item ids
    are global. ``state`` is the rank's shard (``parallel.mesh``: its user
    rows, its rows of the padded item table, replicated ``w0``);
    ``his_items`` holds its users' histories with item ids already made
    local to its item rows (ids of other shards fall outside them), and
    ``his_masks`` their lengths.

    1. The negatives of the whole global batch are drawn from the engine's
       generator, which every rank holds in step, and the rank keeps its
       rows: the draws are those of one rank stepping the global batch.
    2. One K2 launch reads the user rows (local) and the positives' and
       negatives' rows of the rank's item shard (ids rebased to it; ids of
       other shards read zeros); K1 pools the users' histories over the
       shard, leaving other shards' items out of the sum and dividing by
       the whole length: a partial mean. Item rows and means sit in one
       buffer, summed over the model group by one ``all_reduce``: whole
       rows (one nonzero term each, exact) and whole means (summed in
       another order than on one rank).
    3. Forward and backward as :func:`train_step` (its mean path).
    4. The user rows: the write-back and the dense update (S1, K3) on the
       rank's users. The model group's ranks compute them from equal
       inputs, but K3 adds repeated rows in no fixed order, so replicas
       would drift: the group's first rank then reads the batch's rows
       (K2) and ``broadcast``s them, and the others write them (S1), so
       that user replicas stay bit-equal by construction.
    5. The item rows: :func:`scatter.apply_row_updates_reduced`, whose one
       ``all_reduce`` over the data group also sums ``w0``'s gradient, the
       loss and the count of real samples; every replica then updates from
       equal sums.
    6. ``w0`` by SGD on the summed gradient; ``step`` and the sampler's
       ``iterations`` advance by the global count.
    """
    mesh = shards.mesh
    users, pos, weight = batch
    user_emb, item_emb, w0 = state.user_emb, state.item_emb, state.w0
    b, d, k = users.shape[0], item_emb.shape[1], cfg.num_negs
    f32 = torch.float32
    with record_function("data"):
        lo = mesh.data_index * b
        negs = uniform_negatives(
            generator, b * mesh.shape[0], k, cfg.num_items, pos,
            cfg.ignore_pos, rows=(lo, lo + b))
    u_loc = users - shards.user_lo
    item_ids = torch.cat([pos, negs.view(-1)]) - shards.item_lo
    # [positive rows | negative rows | means]: summed in one collective.
    buf = torch.empty((b * (k + 2), d), dtype=f32, device=item_emb.device)
    with record_function("read_emb"):
        u_rows, _ = gather_rows_multi(
            [(user_emb, u_loc), (item_emb, item_ids)], f32,
            outs=[None, buf[: b * (k + 1)]])
    with record_function("read_his"), record_function("aggr_f"):
        history_mean_gather(item_emb, his_items, his_masks, f32, rows=u_loc,
                            out=buf[b * (k + 1):])
    mesh.all_reduce(buf, "model")
    p_rows = buf[:b]
    n_rows = buf[b: b * (k + 1)].view(b, k, d)
    means = buf[b * (k + 1):]

    with record_function("grad"):
        u_l, p_l, n_l, w0_l = (
            t.detach().requires_grad_() for t in (u_rows, p_rows, n_rows, w0)
        )
        with record_function("his_mm"):
            u_agg = aggregate_history(u_l, means, w0_l, cfg.gamma)
        with record_function("dot"):
            s_up, s_un = pair_scores(u_agg, p_l, n_l,
                                     similarity=cfg.similarity)
        with record_function("loss"):
            loss_sum = (sample_losses(s_up, s_un, cfg) * weight).sum()
        g_u, g_p, g_n, g_w0 = torch.autograd.grad(loss_sum, [u_l, p_l, n_l, w0_l])

    valid = weight > 0
    n_users, n_items = user_emb.shape[0], item_emb.shape[0]
    users_w = torch.where(valid, u_loc, n_users)
    # item_ids is [positives (b) | negatives (b, k) row-major].
    item_valid = torch.cat([valid, valid[:, None].expand(b, k).reshape(-1)])
    item_w = torch.where(item_valid, item_ids, n_items)
    l2 = cfg.l2 if cfg.l2_enabled else 0.0
    sgd = dict(lr=state.lr, clip_val=cfg.clip_val, l2=l2)
    with record_function("write_emb"):
        apply_row_updates(user_emb, users_w, g_u, writeback=u_agg.detach(), **sgd)
        if mesh.shape[1] > 1:
            rows = (gather_rows(user_emb, users_w) if mesh.model_index == 0
                    else torch.empty((b, d), dtype=user_emb.dtype,
                                     device=user_emb.device))
            mesh.broadcast(rows, "model", 0)
            if mesh.model_index != 0:
                scatter_set_rows(user_emb, users_w, rows)
        extra = torch.cat([g_w0.reshape(-1), loss_sum.detach().reshape(1),
                           weight.sum().reshape(1)])
        extra = apply_row_updates_reduced(
            item_emb, item_w, torch.cat([g_p, g_n.reshape(-1, d)]),
            reduce=lambda t: mesh.all_reduce(t, "data"), extra=extra, **sgd)
    with record_function("aggr_b"):
        real = extra[d * d + 1].to(torch.int32)
        w0.sub_(state.lr * extra[: d * d].view(d, d) / cfg.aggr_minibatch)
        state.step.add_((real > 0).to(state.step.dtype))
        sampler_state.iterations.add_(real)
    return state, sampler_state, extra[d * d].clone()


_CAPTURE_STREAMS: dict = {}  # device index: the side stream of every capture


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for every warm-up and capture: PyTorch
    keeps a cuBLAS workspace for each stream a product ran on, for the
    life of the process, so a new stream per capture would hold one more
    workspace each time."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def _key(tensors) -> tuple:
    """What a captured graph reads: the address, type and shape of each
    tensor (None for an absent input)."""
    return tuple(
        None if t is None else (t.data_ptr(), t.dtype, tuple(t.shape))
        for t in tensors
    )


class EpochFn:
    """Steps of :func:`train_step` over an epoch's (nb, B) batch stream: the
    counterpart of the JAX package's ``make_epoch_fn`` (a jitted
    ``lax.scan`` over the batches), without the pool refresh, which the
    engine runs before it.

    ``fn(state, sampler_state, generator, users, pos, weight, his_items,
    his_masks, user_means=None, uniq_users=None, uniq_inverse=None,
    neg_candidates=None, neg_candidates_size=None, uniq_first=None, first=0,
    count=None)`` runs steps ``first`` to ``first + count - 1`` of the stream
    (users, pos, weight: (nb, B); the dedup maps (nb, Bu), (nb, B) and
    (nb, Bu); the negative pool
    and its 0-d size as :func:`train_step` takes them), the rest of the
    stream when ``count`` is None, and returns
    ``(state, sampler_state, loss_sum)``: the state and the sampler state
    passed, advanced in place, and a new 0-d f32 tensor, the steps' loss sum,
    on the step's device. Nothing waits for the device.

    ``capture=False`` runs the steps one by one: the CPU, the eager
    oracle on the card, and the steps on a mesh (``shards``, each step
    :func:`train_step_sharded`). ``capture=True`` (CUDA tensors only) runs each step
    as one replay of a CUDA graph of: batch ``index`` of the stream buffers
    (``index_select`` on a device step index) -> ``train_step`` -> the loss
    into a device accumulator -> index + 1. The graph reads every input at
    the address it was captured at, so it is keyed on the address, type and
    shape of each tensor it reads (the state's, ``attn_q`` and its slots
    included, the sampler's, the stream buffers, the pools, the dedup maps,
    the negative pool and its size, and the histories) and captured again when one of them changes, for
    example when a caller assigns a new state or the pools come back at
    another address; new values written into the same tensors (each
    sub-epoch's stream and negative pool) are replayed over. It holds no reference
    to them between calls: the caller keeps them alive. The capture is
    preceded by its warm-up, which is the first of the steps asked for, run
    eagerly on the capture stream (autograd, cuBLAS and the allocator set
    themselves up there): it trains exactly what the epoch trains, needs no
    copy of the tables (a copy would cost a table-sized buffer at the
    16M x 6M geometry) and leaves the generator where the next step expects
    it. The capture itself runs nothing. ``captures`` counts the captures.

    The engine's generator is registered with the graph
    (``CUDAGraph.register_generator_state``), so every replay draws what
    an eager step would draw from the same generator state, and eager draws
    between replays (the epoch shuffle) stay in the same stream; a PyTorch
    without that call raises. The kernel wrappers count their launches
    where they launch: in the warm-up, and once in the capture, which
    records the launch into the graph. A replay runs the graph's kernels
    without a wrapper call, so a device trace counts those
    (``bench_large.profile_steps``). Capture and replay errors propagate;
    there is no fallback to the eager steps.
    """

    def __init__(self, cfg, capture: bool, shards=None):
        if capture and shards is not None:
            raise NotImplementedError(
                "a captured step on a mesh (NCCL inside the CUDA graph) is "
                "not ported (ROADMAP.md, item 15b)")
        self.cfg = cfg
        self.capture = capture
        self.shards = shards
        self.captures = 0
        self._graph = None
        self._key = None
        self._index = None  # (1,) int64 device step index
        self._loss = None  # 0-d f32 device loss accumulator
        self._inputs = None  # the call's inputs, while a capture reads them
        # The bytes of the capture's private memory pool (the step's
        # temporaries, kept for the replays), from the allocator's segments.
        self.graph_pool_bytes = None

    def _release(self) -> None:
        """Free the captured graph and its memory pool."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._key = None

    def _step(self) -> None:
        """The captured body: one step on batch ``index``, its loss into the
        accumulator, index + 1."""
        (state, sampler_state, generator, users, pos, weight, his_items,
         his_masks, user_means, uniq_users, uniq_inverse, uniq_first,
         neg_candidates, neg_candidates_size) = self._inputs
        i = self._index

        def row(t):
            return None if t is None else t.index_select(0, i)[0]

        _, _, loss = train_step(
            state, sampler_state, generator,
            Batch(row(users), row(pos), row(weight)), his_items, his_masks,
            self.cfg, user_means=user_means, uniq_users=row(uniq_users),
            uniq_inverse=row(uniq_inverse), uniq_first=row(uniq_first),
            neg_candidates=neg_candidates,
            neg_candidates_size=neg_candidates_size,
        )
        self._loss += loss
        i += 1

    def _capture(self, generator, stream) -> None:
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._step()  # the warm-up: the first step asked for, eagerly
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=stream):
            self._step()
        self._graph = graph
        self.captures += 1
        pool = tuple(graph.pool())
        self.graph_pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
            if tuple(seg["segment_pool_id"]) == pool
        )

    def __call__(
        self,
        state: TrainState,
        sampler_state: SamplerState,
        generator: torch.Generator,
        users: torch.Tensor,
        pos: torch.Tensor,
        weight: torch.Tensor,
        his_items: torch.Tensor,
        his_masks: torch.Tensor,
        user_means: Optional[torch.Tensor] = None,
        uniq_users: Optional[torch.Tensor] = None,
        uniq_inverse: Optional[torch.Tensor] = None,
        neg_candidates: Optional[torch.Tensor] = None,
        neg_candidates_size: Optional[torch.Tensor] = None,
        uniq_first: Optional[torch.Tensor] = None,
        *,
        first: int = 0,
        count: Optional[int] = None,
    ) -> tuple[TrainState, SamplerState, torch.Tensor]:
        nb = users.shape[0]
        count = nb - first if count is None else count
        if first < 0 or count < 0 or first + count > nb:
            raise ValueError(
                f"steps {first}..{first + count - 1} outside the stream's {nb}"
            )
        device = users.device
        if not self.capture:
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(first, first + count):
                state, sampler_state, loss = train_step(
                    state, sampler_state, generator,
                    Batch(users[i], pos[i], weight[i]), his_items, his_masks,
                    self.cfg, user_means=user_means,
                    uniq_users=None if uniq_users is None else uniq_users[i],
                    uniq_inverse=None if uniq_inverse is None else uniq_inverse[i],
                    uniq_first=None if uniq_first is None else uniq_first[i],
                    neg_candidates=neg_candidates,
                    neg_candidates_size=neg_candidates_size,
                    shards=self.shards,
                )
                loss_sum += loss
            return state, sampler_state, loss_sum
        if device.type != "cuda":
            raise ValueError(f"a captured epoch needs CUDA tensors, got {device}")
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch has no CUDAGraph.register_generator_state: a "
                "captured step could not draw from the engine's generator"
            )
        if self._index is None:
            self._index = torch.zeros(1, dtype=torch.int64, device=device)
            self._loss = torch.zeros((), dtype=torch.float32, device=device)
        self._index.fill_(first)
        self._loss.zero_()
        if count == 0:
            return state, sampler_state, self._loss.clone()
        slots = [] if state.opt_slots is None else [
            state.opt_slots[k] for k in sorted(state.opt_slots)]
        key = (generator, self.cfg) + _key((
            state.user_emb, state.item_emb, state.w0, state.attn_q, state.lr,
            state.step, state.user_gacc, state.item_gacc, *slots,
            sampler_state.iterations, sampler_state.tile, users, pos, weight,
            his_items, his_masks, user_means, uniq_users, uniq_inverse,
            uniq_first, neg_candidates, neg_candidates_size,
        ))
        replays = count
        if key != self._key:
            self._release()
            self._inputs = (state, sampler_state, generator, users, pos,
                            weight, his_items, his_masks, user_means,
                            uniq_users, uniq_inverse, uniq_first,
                            neg_candidates, neg_candidates_size)
            try:
                self._capture(generator, _capture_stream(device))
            finally:
                self._inputs = None
            self._key = key
            replays -= 1
        for _ in range(replays):
            self._graph.replay()
        return state, sampler_state, self._loss.clone()


def make_epoch_fn(cfg: CFConfig, capture: bool, shards=None) -> EpochFn:
    """The epoch function of ``cfg`` (see :class:`EpochFn`): one CUDA
    graph replay a step when ``capture``, the eager steps otherwise; on a
    mesh (``shards``, the rank's table layout) the eager sharded steps."""
    return EpochFn(cfg, capture, shards)
