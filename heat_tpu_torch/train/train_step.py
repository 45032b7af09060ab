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
    sample_negatives_rows,
)
from heat_tpu_torch.train import scatter
from heat_tpu_torch.train.scatter import (
    apply_row_updates,
    apply_row_updates_direct,
    apply_row_updates_opt,
    apply_row_updates_reduced,
    apply_row_updates_sorted_reduced,
    dense_opt_update,
)


if TYPE_CHECKING:
    from heat_tpu_torch.parallel.mesh import TableShards


class Batch(NamedTuple):
    users: torch.Tensor   # (B,) int32
    pos: torch.Tensor     # (B,) int32
    weight: torch.Tensor  # (B,) f32 — 1 for real samples, 0 for padding


def _check_dedup_query(cfg: CFConfig, uniq_users, uniq_first) -> None:
    if (uniq_users is not None and cfg.aggregator == "user_attention"
            and uniq_first is None):
        raise ValueError(
            "user_attention history dedup requires uniq_first (the "
            "per-user query is sliced from the first occurrence of the "
            "differentiable user rows)")


def _pool_attention(state, cfg, leaves, his_embs, his_mask, uniq_inverse,
                    uniq_first) -> torch.Tensor:
    """The attention kinds' pooled history of every sample, inside
    autograd: under self-attention the f32 ``attn_q`` becomes a leaf
    (appended to ``leaves``), cast to the rows' compute type; under
    user-attention the query is the user rows' leaf ``leaves[0]``. With
    the dedup maps the (Bu, H) rows are pooled once per distinct user (the
    user-attention query sliced from the user's first occurrence) and read
    back per sample."""
    q = None
    if cfg.aggregator == "self_attention":
        q_l = state.attn_q.detach().requires_grad_()
        leaves.append(q_l)
        q = q_l.to(his_embs.dtype)
    u_l = leaves[0]
    with record_function("aggr_f"):
        if uniq_inverse is None:
            return pool_history(his_embs, his_mask, u=u_l, attn_q=q,
                                kind=cfg.aggregator)
        u_first = (u_l.index_select(0, uniq_first)
                   if cfg.aggregator == "user_attention" else None)
        return pool_history(his_embs, his_mask, u=u_first, attn_q=q,
                            kind=cfg.aggregator).index_select(0, uniq_inverse)


def _update_args(state: TrainState, cfg: CFConfig, l2: float):
    """The keywords of the SGD updates and of the Adagrad / Adam ones
    (``step`` already advanced: Adam's bias correction reads it)."""
    sgd = dict(lr=state.lr, clip_val=cfg.clip_val, l2=l2)
    opt = dict(sgd, step=state.step, beta1=cfg.adam_beta1,
               beta2=cfg.adam_beta2, eps=cfg.opt_eps)
    return sgd, opt


def _update_user_rows(state, cfg, users_w, g_u, u_agg, sgd, opt) -> None:
    """The user table's write-back of the aggregated rows ``u_agg`` and
    its update by ``cfg.update_mode`` and ``cfg.optimizer``, in place (the
    gradient rows and the slot tables too). In batch mode the write-back
    rides the update's own scatter; accum mode writes it first (its update
    reads the persistent grad rows)."""
    user_emb = state.user_emb
    writeback = u_agg
    if state.user_gacc is not None:
        scatter_set_rows(user_emb, users_w, u_agg)
        writeback = None
    if cfg.update_mode == "direct":
        # Config validation guarantees batch-mode SGD here.
        apply_row_updates_direct(
            user_emb, users_w, g_u, rows=u_agg if sgd["l2"] else None,
            writeback=writeback, **sgd)
    elif cfg.optimizer == "sgd":
        apply_row_updates(
            user_emb, users_w, g_u, gacc=state.user_gacc, decay=cfg.gamma,
            writeback=writeback, **sgd)
    else:
        apply_row_updates_opt(
            user_emb, users_w, g_u, m=state.opt_slots.get("user_m"),
            v=state.opt_slots["user_v"], writeback=writeback, **opt)


def stale_w0_term(user_gacc, users, means, weight, gamma: float):
    """Accum mode's stale term of ``w0``'s gradient: the reference's
    aggregator backward works on the persistent user-grad rows, so the
    gradient also holds ``(1 - gamma) * (means * weight)^T @ user_gacc[users]``
    (an f32 GEMM; the engine turns TF32 off), read before the step's
    updates. On a mesh each data rank computes it over its rows of the
    batch, and the data group sums the parts."""
    prev_acc = gather_rows(user_gacc, users).float()
    return (1.0 - gamma) * ((means.float() * weight[:, None]).T @ prev_acc)


def _update_dense(state: TrainState, cfg: CFConfig, dense, real) -> None:
    """``w0`` (and ``attn_q``) from their batch gradients, ``dense`` a list
    of (slot name, parameter, gradient): B / aggr_minibatch reference
    updates collapsed into one, in place. Under Adagrad / Adam the moment
    updates are not no-ops at zero gradient (Adam decays its moments,
    Adagrad divides by sqrt(v)), so a batch without a real sample
    (``real``, 0-d) leaves the parameters and their slots untouched."""
    if cfg.optimizer == "sgd":
        for _, param, g in dense:
            param.sub_(state.lr * g / cfg.aggr_minibatch)
        return
    slots = state.opt_slots
    has_real = real > 0
    for name, param, g in dense:
        new, slots_new = dense_opt_update(
            param, g / cfg.aggr_minibatch, slots, name, lr=state.lr,
            step=state.step, beta1=cfg.adam_beta1, beta2=cfg.adam_beta2,
            eps=cfg.opt_eps)
        for key in (name + "_m", name + "_v"):
            if key in slots_new:
                slots[key].copy_(torch.where(has_real, slots_new[key], slots[key]))
        param.copy_(torch.where(has_real, new, param))


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
        return train_step_sharded(
            state, sampler_state, generator, batch, his_items, his_masks, cfg,
            shards, user_means=user_means, uniq_users=uniq_users,
            uniq_inverse=uniq_inverse, neg_candidates=neg_candidates,
            neg_candidates_size=neg_candidates_size, uniq_first=uniq_first)
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
        _check_dedup_query(cfg, uniq_users, uniq_first)
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
            means = _pool_attention(state, cfg, leaves, his_embs, his_mask,
                                    uniq_inverse, uniq_first)
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
        with record_function("aggr_b"):
            g_w0 = g_w0 + stale_w0_term(state.user_gacc, users, means,
                                        weight, cfg.gamma)

    num_users, num_items = user_emb.shape[0], item_emb.shape[0]
    valid = weight > 0
    users_w = torch.where(valid, users, num_users)
    pos_w = torch.where(valid, pos, num_items)
    u_agg = u_agg.detach()
    l2 = cfg.l2 if cfg.l2_enabled else 0.0
    state.step.add_((real > 0).to(state.step.dtype))  # 1-based from here on
    sgd, opt = _update_args(state, cfg, l2)
    opt_slots = state.opt_slots

    with record_function("write_emb"):
        _update_user_rows(state, cfg, users_w, g_u, u_agg, sgd, opt)

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
        dense = [("w0", w0, g_w0)]
        if g_q:
            dense.append(("attn_q", state.attn_q, g_q[0]))
        _update_dense(state, cfg, dense, real)
    return state, sampler_state, loss_sum.detach()


def _replicas_equal(mesh, axis: str, tables, ids: torch.Tensor) -> None:
    """Make the rows ``t[ids]`` of every table ``t`` of ``tables`` (None
    entries left out) on every replica along ``axis`` those of the group's
    first rank: it reads them (K2; several tables in one launch of its
    multi entry, into one byte buffer, a table's rows after the other's),
    one ``broadcast`` sends them, and the others write them (S1). Replicas
    that updated from equal inputs still differ where K3 added repeated
    rows in another order; after this they are bit-equal by
    construction."""
    if mesh.axis_size(axis) == 1:
        return
    first = mesh.index(axis) == 0
    tables = [t for t in tables if t is not None]
    m = ids.shape[0]
    if len(tables) == 1:
        (table,) = tables
        rows = (gather_rows(table, ids) if first else torch.empty(
            (m, table.shape[1]), dtype=table.dtype, device=table.device))
        mesh.broadcast(rows, axis, 0)
        if not first:
            scatter_set_rows(table, ids, rows)
        return
    # The widest elements first, so that every view starts aligned.
    tables.sort(key=lambda t: -t.element_size())
    sizes = [m * t.shape[1] * t.element_size() for t in tables]
    packed = torch.empty(sum(sizes), dtype=torch.uint8, device=ids.device)
    views, lo = [], 0
    for t, n in zip(tables, sizes):
        views.append(packed[lo: lo + n].view(t.dtype).view(m, t.shape[1]))
        lo += n
    if first:
        gather_rows_multi([(t, ids) for t in tables], outs=views)
    mesh.broadcast(packed, axis, 0)
    if not first:
        for t, rows in zip(tables, views):
            scatter_set_rows(t, ids, rows)


def _direct_items_sharded(mesh, item_emb, occ_ids, occ_grads, tile_ids,
                          tile_grads, extra, compute, sgd) -> torch.Tensor:
    """``update_mode: direct`` for a shard of the item table whose replicas
    (its data group) take occurrences from every data rank: each
    occurrence's gradient clipped on its own, the tile's slots on the
    gradient summed over the whole global batch.

    One f32 buffer goes through one ``all_reduce`` over the data group:
    every data rank's occurrences (``occ_ids`` shard-local, the sentinel
    for the dropped and the outside ones, and ``occ_grads``) at its own
    slot, a sum of one nonzero term (exact; the ids below 2^24, as every
    shard is, exact in f32 too), ``tile_grads`` summed over the ranks and
    rounded once to ``compute``, and ``extra``. The group's first rank
    then applies every occurrence (K3's update entry; l2 against the
    rows it reads from its shard at batch start, the forward's rows) and
    broadcasts the touched rows, which the others write (S1): K3 adds
    repeated ids in no fixed order, and this keeps the replicas bit-equal.
    Returns the reduced ``extra``."""
    n_data, di = mesh.shape[0], mesh.data_index
    m, d = occ_grads.shape
    t = 0 if tile_ids is None else tile_ids.shape[0]
    e = extra.numel()
    size = n_data * m * (d + 1) + t * d + e
    buf = torch.zeros(size, dtype=torch.float32, device=item_emb.device)
    grads_all = buf[: n_data * m * d].view(n_data, m, d)
    ids_all = buf[n_data * m * d: n_data * m * (d + 1)].view(n_data, m)
    grads_all[di].copy_(occ_grads)
    ids_all[di].copy_(occ_ids)
    tile_all = buf[n_data * m * (d + 1): size - e].view(t, d)
    if t:
        tile_all.copy_(tile_grads)
    buf[size - e:].copy_(extra.reshape(-1))
    mesh.all_reduce(buf, "data")
    parts = [ids_all.view(-1).to(torch.int32)]
    grads = [grads_all.view(-1, d)]
    if t:
        parts.append(tile_ids)
        grads.append(tile_all)
    ids = torch.cat(parts)
    if di == 0:
        grads = torch.cat(grads).to(compute)
        rows = gather_rows(item_emb, ids).to(compute) if sgd["l2"] else None
        apply_row_updates_direct(item_emb, ids, grads, rows=rows, **sgd)
    _replicas_equal(mesh, "data", [item_emb], ids)
    return buf[size - e:]


def train_step_sharded(
    state: TrainState,
    sampler_state: SamplerState,
    generator: torch.Generator,
    batch: Batch,
    his_items: torch.Tensor,
    his_masks: torch.Tensor,
    cfg: CFConfig,
    shards: "TableShards",
    user_means: Optional[torch.Tensor] = None,
    uniq_users: Optional[torch.Tensor] = None,
    uniq_inverse: Optional[torch.Tensor] = None,
    neg_candidates: Optional[torch.Tensor] = None,
    neg_candidates_size: Optional[torch.Tensor] = None,
    uniq_first: Optional[torch.Tensor] = None,
) -> tuple[TrainState, SamplerState, torch.Tensor]:
    """One step on a ("data", "model") mesh: the counterpart of the JAX
    step under GSPMD, with its collectives written out. Every setting
    :func:`train_step` runs: the three aggregators, SGD in batch or accum
    mode (the combined-row clip) or ``direct`` mode, Adagrad and Adam,
    uniform or tile negatives, the history pooled every step (with the
    dedup maps, once per distinct user) or the cached pools, f32 or bf16
    tables and compute.

    ``batch`` holds this rank's rows of the global batch (data index d
    holds rows ``[d * b, (d + 1) * b)``, b = its width); user and item ids
    are global. ``state`` is the rank's shard (``parallel.mesh``: its user
    rows, its rows of the padded item table, with their accum rows and
    slots; replicated ``w0``, ``attn_q`` and their slots); ``his_items``
    holds its users' histories with item ids already made local to its
    item rows (ids of other shards fall outside them), and ``his_masks``
    their lengths; ``user_means`` (his_refresh: subepoch) the pools of its
    users, whole (the refresh pools whole rows); ``uniq_users`` /
    ``uniq_inverse`` / ``uniq_first`` the dedup maps of its rows (global
    user ids; indices into them; indices into its rows); ``neg_candidates``
    a sub-epoch's negative pool, the same on every rank.

    1. The global batch's count of real samples is summed over the data
       group. The negatives of the whole global batch are drawn from the
       engine's generator, which every rank holds in step, and the rank
       keeps its rows (``samplers.sample_negatives_rows``): the draws of
       one rank stepping the global batch, the tile and its refresh
       cadence included; a negative pool remaps the tile or the draws.
    2. One K2 launch reads the user rows (local) and the positives' and
       the negatives' rows (the T tile rows, once, or the (b, K) draws) of
       the rank's item shard (ids rebased to it; ids of other shards read
       zeros), with the pools' rows; under the attention kinds it reads
       the (b, H) history rows (the (Bu, H) rows of the distinct users) of
       the shard too. For the mean K1 pools the users' (or the distinct
       users') histories over the shard, leaving other shards' items out
       of the sum and dividing by the whole length: a partial mean. Item
       rows, history rows and partial means sit in one f32 buffer, summed
       over the model group by one ``all_reduce``: whole rows (one nonzero
       term each, exact in any type) and whole means (summed in another
       order than on one rank), each rounded once to the compute type
       after the sum. On a (., 1) mesh K1 writes the compute type itself.
    3. Forward and backward as :func:`train_step` (the attention kinds
       pool the whole rows inside autograd): whole-tile scoring with the
       draws' (b, T) multiplicities of the rank's rows, or the pairs. The
       tile's (T, d) gradient holds the rank's part of each slot's
       gradient, in f32 (the tile's rows enter the f32 scoring as f32
       tensors of the compute type's values); each slot is one occurrence
       whose gradient is the whole global batch's sum, so it is summed
       over the data group before any clip binds, as the JAX step clips
       the global sum, and rounded to the compute type once after the sum
       (``direct``; the dense update's f32 accumulator takes it
       unrounded). The ranks of a model group compute the
       same ``w0`` and ``attn_q`` gradients from the same rows, so those
       are summed over the data group only (with accum mode's stale term
       of ``w0``).
    4. ``step`` advances by the global count (before the updates: Adam's
       bias correction reads it). The user rows: the write-back and the
       update (S1, K3; ``direct``: K3's update entry) on the rank's users,
       with their accum rows or slots; then the model group's first rank
       broadcasts the batch's rows of the table and of those, one packed
       buffer, and the others write them, so that user replicas stay
       bit-equal (K3 adds repeated rows in no fixed order).
    5. The item rows: batch or accum mode, Adagrad or Adam; for a shard
       at or below ``scatter.DENSE_ROWS_THRESHOLD`` rows (read at call
       time) by :func:`scatter.apply_row_updates_reduced`, whose one
       ``all_reduce`` over the data group also sums the touched rows, the
       dense gradients and the loss, every replica then updating from
       equal sums; above it by
       :func:`scatter.apply_row_updates_sorted_reduced`, whose one
       ``all_gather`` over the data group brings every data rank's
       occurrences (shard-local ids, f32 rows), its part of the tile's
       gradient, the dense gradients and the loss to every rank, the data
       group's first rank applying the sort-dedup update and broadcasting
       the touched rows with their accum rows or slots
       (:func:`_replicas_equal`); in ``direct`` mode
       :func:`_direct_items_sharded`. Every sum across ranks is of f32
       buffers. The user rows take the dense or the sort-dedup path by
       the user shard's rows (:func:`scatter.apply_row_updates`).
    6. ``w0`` and ``attn_q`` by SGD, or Adagrad / Adam gated on the global
       count, on the summed gradients (each rank's part of them in f32,
       rounded once to the compute type after the sum, as one rank's
       product gives them); the sampler's ``iterations`` advance by the
       global count.
    """
    mesh = shards.mesh
    users, pos, weight = batch
    user_emb, item_emb, w0 = state.user_emb, state.item_emb, state.w0
    b, d = users.shape[0], item_emb.shape[1]
    f32 = torch.float32
    compute = torch_dtype(cfg.compute_dtype)
    n_items = item_emb.shape[0]
    with record_function("data"):
        real = mesh.all_reduce(weight.sum().reshape(1), "data")[0].to(torch.int32)
        lo = mesh.data_index * b
        sample, sampler_state = sample_negatives_rows(
            generator, sampler_state, pos, cfg, b * mesh.shape[0],
            (lo, lo + b), real)
        # Whole-tile scoring is batch-mode only, as in train_step.
        tiled = sample.tile is not None and state.item_gacc is None
        neg_ids = sample.tile if tiled else sample.ids.reshape(-1)
        if neg_candidates is not None:
            size = (neg_candidates.shape[0] if neg_candidates_size is None
                    else neg_candidates_size)
            neg_ids = neg_candidates.index_select(
                0, torch.remainder(neg_ids, size))
    u_loc = users - shards.user_lo
    item_loc = torch.cat([pos, neg_ids]) - shards.item_lo
    m = item_loc.shape[0]
    model_sum = mesh.shape[1] > 1
    attention = cfg.aggregator != "mean" and user_means is None
    # Per-step pools: of the samples, or of the distinct users (dedup).
    his_rows = None
    if user_means is None:
        his_rows = u_loc if uniq_users is None else uniq_users - shards.user_lo
    if attention:
        _check_dedup_query(cfg, uniq_users, uniq_first)
        extra_rows = his_rows.shape[0] * his_items.shape[1]
    else:
        partial = his_rows is not None and model_sum
        extra_rows = his_rows.shape[0] if partial else 0
    # [positive rows | negative or tile rows | history rows or partial
    # means]: one sum.
    buf = torch.empty((m + extra_rows, d), dtype=f32, device=item_emb.device)
    segments = [(user_emb, u_loc), (item_emb, item_loc)]
    outs = [None, buf[:m]]
    if user_means is not None:
        segments.append((user_means, u_loc))
        outs.append(None)
    if attention:
        with record_function("read_his"):
            segments.append(
                (item_emb, his_items.index_select(0, his_rows).view(-1)))
            outs.append(buf[m:])
    with record_function("read_emb"):
        rows = gather_rows_multi(segments, f32, outs=outs)
    if his_rows is not None and not attention:
        with record_function("read_his"), record_function("aggr_f"):
            means = history_mean_gather(
                item_emb, his_items, his_masks, f32 if partial else compute,
                rows=his_rows, out=buf[m:] if partial else None)
    mesh.all_reduce(buf, "model")
    u_rows = rows[0].to(compute)
    p_rows = buf[:b].to(compute)
    n_rows = buf[b:m].to(compute)
    if user_means is not None:
        means = rows[2].to(compute)
    elif attention:
        his_embs = buf[m:].view(his_rows.shape[0], -1, d).to(compute)
        his_mask = his_masks.index_select(0, his_rows)
    else:
        means = means.to(compute)
        if uniq_users is not None:
            with record_function("aggr_f"):
                means = gather_rows(means, uniq_inverse)
    if tiled:
        # tile_scores scores in f32 whatever the rows' type: the same
        # scores from f32 rows that hold the compute type's values, and
        # the rank's part of the tile's gradient stays f32 (no rounding
        # before the sum over the data group).
        n_rows = n_rows.float()
    else:
        n_rows = n_rows.view(b, cfg.num_negs, d)

    with record_function("grad"):
        u_l, p_l, n_l, w0_l = (
            t.detach().requires_grad_() for t in (u_rows, p_rows, n_rows, w0)
        )
        leaves = [u_l, p_l, n_l, w0_l]
        if attention:
            means = _pool_attention(state, cfg, leaves, his_embs, his_mask,
                                    uniq_inverse, uniq_first)
        with record_function("his_mm"):
            u_agg = aggregate_history(u_l, means, w0_l, cfg.gamma,
                                      f32_weight_grad=True)
        with record_function("dot"):
            if tiled:
                s_up, s_all = tile_scores(u_agg, p_l, n_l,
                                          similarity=cfg.similarity)
            else:
                s_up, s_un = pair_scores(u_agg, p_l, n_l,
                                         similarity=cfg.similarity)
        with record_function("loss"):
            if tiled:
                # counts[b, t]: how many of sample b's K draws hit slot t.
                counts = torch.zeros(
                    (b, neg_ids.shape[0]), dtype=f32, device=users.device,
                ).scatter_add_(1, sample.tile_idx.long(), torch.ones(
                    sample.tile_idx.shape, dtype=f32, device=users.device))
                losses = sample_losses_weighted(s_up, s_all, counts,
                                                cfg.num_negs, cfg)
            else:
                losses = sample_losses(s_up, s_un, cfg)
            loss_sum = (losses * weight).sum()
        g_u, g_p, g_n, g_w0, *g_q = torch.autograd.grad(loss_sum, leaves)
    means = means.detach()

    # What the data group sums beside the item rows: [w0's gradient |
    # accum mode's stale term of it | attn_q's gradient | the loss].
    extra = [g_w0.reshape(-1)]
    if state.user_gacc is not None:
        # The rank's part of the stale term, summed over the data group.
        with record_function("aggr_b"):
            extra.append(stale_w0_term(state.user_gacc, u_loc, means, weight,
                                       cfg.gamma).reshape(-1))
    extra += [g.reshape(-1) for g in g_q]
    extra = torch.cat(extra + [loss_sum.detach().reshape(1)])
    valid = weight > 0
    n_users = user_emb.shape[0]
    users_w = torch.where(valid, u_loc, n_users)
    # Shard-local item ids, the sentinel for weight-0 samples' and for
    # other shards' rows; the tile's slots carry no sentinel (a weight-0
    # sample puts no gradient into them).
    inside = (item_loc >= 0) & (item_loc < n_items)
    occ_valid = valid if tiled else torch.cat(
        [valid, valid.repeat_interleave(cfg.num_negs)])
    item_w = torch.where(inside, item_loc, n_items)
    occ_w = torch.where(occ_valid, item_w[: occ_valid.shape[0]], n_items)
    tile_w = item_w[b:] if tiled else None
    l2 = cfg.l2 if cfg.l2_enabled else 0.0
    state.step.add_((real > 0).to(state.step.dtype))  # 1-based from here on
    sgd, opt = _update_args(state, cfg, l2)
    slots = state.opt_slots or {}
    u_agg = u_agg.detach()
    with record_function("write_emb"):
        _update_user_rows(state, cfg, users_w, g_u, u_agg, sgd, opt)
        _replicas_equal(mesh, "model", [user_emb, state.user_gacc,
                                        slots.get("user_v"), slots.get("user_m")],
                        users_w)
        if cfg.update_mode == "direct":
            g_occ = g_p if tiled else torch.cat([g_p, g_n.reshape(-1, d)])
            extra = _direct_items_sharded(
                mesh, item_emb, occ_w, g_occ, tile_w,
                g_n if tiled else None, extra, compute, sgd)
        else:
            item_opt = None
            if cfg.optimizer != "sgd":
                item_opt = {k: opt[k] for k in ("step", "beta1", "beta2", "eps")}
                item_opt.update(m=slots.get("item_m"), v=slots["item_v"])
            if n_items > scatter.DENSE_ROWS_THRESHOLD:
                extra = apply_row_updates_sorted_reduced(
                    item_emb, occ_w,
                    g_p if tiled else torch.cat([g_p, g_n.reshape(-1, d)]),
                    gather=lambda t: mesh.all_gather(t, "data"),
                    share=lambda tables, ids: _replicas_equal(
                        mesh, "data", tables, ids),
                    first=mesh.data_index == 0, extra=extra,
                    tile_ids=tile_w, tile_grads=g_n if tiled else None,
                    compute=compute, gacc=state.item_gacc, opt=item_opt,
                    **sgd)
            else:
                ids = occ_w if not tiled else torch.cat([occ_w, tile_w])
                extra = apply_row_updates_reduced(
                    item_emb, ids, torch.cat([g_p, g_n.reshape(-1, d)]),
                    reduce=lambda t: mesh.all_reduce(t, "data"), extra=extra,
                    gacc=state.item_gacc, opt=item_opt, **sgd)
    if g_q and uniq_inverse is not None and model_sum:
        # The dedup's read-back adds a distinct user's samples' gradients
        # in no fixed order on the card (index_select's backward), so the
        # ranks of a model group may compute attn_q's gradient apart: the
        # replicated w0 and attn_q take model index 0's sums.
        mesh.broadcast(extra, "model", 0)
    with record_function("aggr_b"):
        # The gradients in the compute type, as one rank's are, rounded
        # once; the stale term is f32, as train_step adds it.
        g_w0 = extra[: d * d].view(d, d).to(compute).float()
        at = d * d
        if state.user_gacc is not None:
            g_w0 = g_w0 + extra[at: at + d * d].view(d, d)
            at += d * d
        dense = [("w0", w0, g_w0)]
        if g_q:
            dense.append(("attn_q", state.attn_q,
                          extra[at: at + d].to(compute).float()))
            at += d
        _update_dense(state, cfg, dense, real)
    return state, sampler_state, extra[at].clone()


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

    On a mesh (``shards``) each step is :func:`train_step_sharded`.
    ``capture=False`` runs the steps one by one: the CPU, the eager
    oracle on the card, and a mesh whose collectives cannot be captured
    (gloo). ``capture=True`` (CUDA tensors only) runs each step
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
    On a mesh over NCCL the graph holds the step's collectives: the
    warm-up step has run each of them on its process group first, so
    every communicator exists before the capture (NCCL creates them at a
    group's first collective, which a capture cannot hold).

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
            neg_candidates_size=neg_candidates_size, shards=self.shards,
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
    mesh (``shards``, the rank's table layout) the sharded steps."""
    return EpochFn(cfg, capture, shards)
