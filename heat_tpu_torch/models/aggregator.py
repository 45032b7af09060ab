"""SimpleX behaviour aggregation: history pooling and the w0/gamma blend.

Counterpart of ``heat_tpu/models/aggregator.py``:

    u_agg = gamma * u + (1 - gamma) * (pool(history rows) @ w0)

The pool is the masked mean of the first ``mask[b]`` history rows of each
sample (kernel K1), or one of the two attention kinds of the paper's ACCL
configurations (:func:`pool_history`: the history rows read by kernel K2,
the logits, softmax and weighted sum in plain torch, as the JAX package
leaves them to XLA); it is 0 for an empty history. No gradient flows into
the history rows: the mean is computed outside autograd (the kernel K1 is
not differentiable, and the step never asks it to be), and the attention
kinds pool rows read outside autograd, differentiated only with respect to
their query.

The aggregator is a plain function, not an ``nn.Module`` holding ``w0``:
``w0`` is one of the leaf tensors the step differentiates alongside the
gathered rows, and it is updated by hand with the tables (``train_step``),
so a module would add a parameter container that nothing else uses.
"""

from __future__ import annotations

import functools

import torch

from heat_tpu_torch.ops.cuda.gather import gather_rows, history_mean_gather


def history_mean(his_embs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the first ``mask`` history rows.

    Args:
      his_embs: (B, H, d) gathered history item embeddings.
      mask: (B,) int — valid history length per user.

    Returns:
      (B, d) means, summed in f32 and rounded once.
    """
    h = his_embs.shape[1]
    pos = torch.arange(h, device=mask.device)[None, :]
    valid = (pos < mask[:, None]).to(torch.float32)
    total = (his_embs.float() * valid[:, :, None]).sum(1)
    denom = torch.clamp(mask.float(), min=1.0)
    return (total / denom[:, None]).to(his_embs.dtype)


def history_mean_fused(
    item_emb: torch.Tensor,
    his_ids: torch.Tensor,
    mask: torch.Tensor,
    compute_dtype: torch.dtype | None = None,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked history mean fused with its own gather (kernel K1).

    Args:
      item_emb: (I, d) f32 or bf16 table.
      his_ids: (U, H) int32 history ids.
      mask: (U,) int32 valid history length per history.
      compute_dtype: the type the rows are cast to and the result has; the
        table's type when None.
      rows: optional (B,) int32 users: sample b pools history ``rows[b]``
        of the (U, H) table, which the kernel reads itself. None pools
        every history (B = U).

    Returns:
      (B, d) means in ``compute_dtype`` (empty histories pool to zero),
      summed in f32 and rounded once. On the card the (B, H, d) gather
      never reaches device memory and masked slots are never read.
    """
    return history_mean_gather(item_emb, his_ids, mask, compute_dtype, rows=rows)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, operation by operation as
    ``jax.nn.softmax`` computes it: the maximum, ``exp(x - max)`` and the
    quotient each in the logits' type, the sum accumulated in f32 and
    rounded to that type (``torch.softmax`` on bf16 rounds once at the end
    instead). Identical to it in f32 up to the order of the sum."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True, dtype=torch.float32).to(e.dtype)


def pool_history(
    his_embs: torch.Tensor,
    mask: torch.Tensor,
    u: torch.Tensor | None = None,
    attn_q: torch.Tensor | None = None,
    kind: str = "mean",
) -> torch.Tensor:
    """History pooling over gathered (B, H, d) rows, the three kinds of the
    reference's menu (behavior_aggregators.cpp:27):

    * ``mean``: the masked mean (:func:`history_mean`);
    * ``self_attention``: a_h = softmax_h(rows_h . attn_q / sqrt(d)) with a
      learned (d,) query, pooled = sum_h a_h rows_h;
    * ``user_attention``: the same with the user's own (B, d) row ``u`` as
      the query.

    The attention kinds port ``heat_tpu/models/aggregator.py``
    ``pool_history`` exactly: the logits are scaled by d^-0.5 rounded to
    the rows' type; slot 0 is never masked, so that the softmax never sees
    only masked slots (no NaN, whose cotangent would reach the query);
    masked slots take the logit -1e9; the softmax (:func:`_softmax`) runs
    over H; an empty history (``mask`` 0) pools to zero through a final
    ``where``, since its slot 0 holds a real row. The operands are promoted
    to a common type as ``jnp.einsum`` promotes them (bf16 rows against an
    f32 query pool in f32). Autograd differentiates the result with respect
    to ``attn_q`` and ``u``; callers pass history rows that take no
    gradient (the reference's backward stops at the history).
    """
    if kind == "mean":
        return history_mean(his_embs, mask)
    if kind == "self_attention":
        if attn_q is None:
            raise ValueError("self_attention requires attn_q")
        query = attn_q
    elif kind == "user_attention":
        if u is None:
            raise ValueError("user_attention requires the user embeddings")
        query = u
    else:
        raise ValueError(f"unknown aggregator {kind!r}")
    h, d = his_embs.shape[1], his_embs.shape[2]
    dtype = torch.promote_types(his_embs.dtype, query.dtype)
    rows, query = his_embs.to(dtype), query.to(dtype)
    if query.dim() == 1:
        logits = rows @ query
    else:
        logits = (rows @ query[:, :, None])[:, :, 0]
    logits = logits * scalar_in(d ** -0.5, his_embs.dtype)
    pos = torch.arange(h, device=mask.device)[None, :]
    never_empty = (pos < mask[:, None]) | (pos == 0)
    logits = torch.where(never_empty, logits, -1e9)
    attn = _softmax(logits)
    pooled = (attn[:, None, :] @ rows)[:, 0, :]
    return torch.where(mask[:, None] > 0, pooled, 0.0)


# Bytes of (chunk, H, d) history rows the attention pools hold at a time.
POOL_CHUNK_BYTES = 1 << 27


def user_pools_impl(
    item_emb: torch.Tensor,
    his_items: torch.Tensor,
    his_masks: torch.Tensor,
    user_emb: torch.Tensor | None = None,
    attn_q: torch.Tensor | None = None,
    aggregator: str = "mean",
    chunk: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """(U, d) pooled history of every user, in the item table's type.

    The mean goes through kernel K1: on the card one launch writes the
    whole table of pools in place, and the kernel never materializes a
    (U, H, d) gather; on the CPU its plain version does, ``chunk`` users at
    a time. The attention kinds (:func:`pool_history`, with the query of
    the pools' refresh time: ``attn_q``, or the rows of ``user_emb``) run
    ``chunk`` users at a time on both devices: each chunk's H history rows
    a user are read by kernel K2 (``gather_rows``; its plain version on the
    CPU), pooled in plain torch and written into their rows of ``out``.
    The default chunk holds POOL_CHUNK_BYTES of rows (128 MiB: 10,485 users
    at H = 100, d = 64 in f32, 104,857 at H = 10 in bf16); the logits,
    weights and pooled rows beside them are (chunk, H) and (chunk, d), so
    no (U, H, d) tensor ever exists.

    Where the pooled rows come out of another type than the table's, as
    bf16 rows against an f32 ``attn_q`` pool in f32, this raises
    ``TypeError`` as the JAX function does (its ``dynamic_update_slice``
    into the table-typed result refuses them).

    Args:
      item_emb: (I, d) f32 or bf16 table; the pools have its type.
      his_items: (U, H) int32 history ids (the JAX package's flat (U*H,)
        layout is TPU lane machinery and is not taken).
      his_masks: (U,) int32 valid history lengths.
      user_emb: (U, d) user table, the query under "user_attention".
      attn_q: (d,) query under "self_attention".
      aggregator: "mean", "self_attention" or "user_attention".
      chunk: users a chunk (None: POOL_CHUNK_BYTES of rows); the mean uses
        it only on the CPU.
      out: optional contiguous (U, d) tensor of the table's type on its
        device, written and returned (the engine refreshes one buffer every
        epoch, whose address its captured step reads); a new one when None.
    """
    if aggregator not in ("mean", "self_attention", "user_attention"):
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if his_items.dim() != 2:
        raise ValueError(
            f"his_items must be (U, H), got shape {tuple(his_items.shape)}"
        )
    u, h = his_items.shape
    d = item_emb.shape[1]
    if out is None:
        out = torch.empty((u, d), dtype=item_emb.dtype, device=item_emb.device)
    elif (out.shape != (u, d) or out.dtype != item_emb.dtype
          or out.device != item_emb.device or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous ({u}, {d}) "
            f"{item_emb.dtype} tensor on {item_emb.device}, got "
            f"{tuple(out.shape)} {out.dtype} on {out.device}"
        )
    if aggregator == "mean" and out.is_cuda:
        return history_mean_gather(item_emb, his_items, his_masks, out=out)
    if chunk is None:
        row_bytes = max(1, h * d * item_emb.element_size())
        chunk = max(1, POOL_CHUNK_BYTES // row_bytes)
    if aggregator == "self_attention":
        if attn_q is None:
            raise ValueError("self_attention requires attn_q")
        pooled_type = torch.promote_types(item_emb.dtype, attn_q.dtype)
        if pooled_type != item_emb.dtype:
            raise TypeError(
                f"self_attention pools of a {item_emb.dtype} item table with "
                f"a {attn_q.dtype} attn_q come out {pooled_type}, not the "
                "table's type (the JAX package's user_pools_impl refuses them "
                "the same way)")
    if aggregator == "user_attention" and user_emb is None:
        raise ValueError("user_attention requires the user embeddings")
    with torch.no_grad():
        for lo in range(0, u, chunk):
            ids, lens = his_items[lo : lo + chunk], his_masks[lo : lo + chunk]
            if aggregator == "mean":
                out[lo : lo + chunk] = history_mean_fused(item_emb, ids, lens)
                continue
            rows = gather_rows(item_emb, ids.reshape(-1)).view(-1, h, d)
            out[lo : lo + chunk] = pool_history(
                rows, lens,
                u=None if user_emb is None else user_emb[lo : lo + chunk],
                attn_q=attn_q, kind=aggregator,
            )
    return out


def aggregate_history(
    u: torch.Tensor, means: torch.Tensor, w0: torch.Tensor, gamma: float
) -> torch.Tensor:
    """u_agg = gamma * u + (1 - gamma) * means @ w0.

    The (B, d) x (d, d) product is a plain matmul in the type of ``means``
    (``w0`` is cast to it, as the JAX step casts it to the compute type);
    in f32 it is full f32 on the card only with TF32 off, which the engine
    sets and checks. In bf16 the product and each of the three elementwise
    operations round to bf16, as they do in the JAX package, where the two
    scalar weights are rounded to bf16 as well before they multiply.
    """
    f_c0 = means @ w0.to(means.dtype)
    return scalar_in(gamma, u.dtype) * u + scalar_in(1.0 - gamma, f_c0.dtype) * f_c0


@functools.lru_cache(maxsize=None)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float. JAX casts a
    Python scalar to the array's type before an elementwise operation;
    PyTorch keeps it in f32. Rounding it here first gives bf16 arithmetic
    the JAX package's result (for f32 both agree already). Made on the
    host, once per value: nothing waits for the device."""
    if dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=dtype))
