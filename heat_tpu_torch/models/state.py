"""Training state: embedding tables and aggregator weights as tensors.

Counterpart of ``heat_tpu/models/state.py``. The tables are plain tensors,
not ``nn.Parameter``s: they are updated by a manual, duplicate-safe sparse
row update (``train/scatter.py``), and autograd runs only over the rows a
step gathers and ``w0`` (``train/train_step.py``).

Initialization: user/item embeddings, ``w0`` and, under
``aggregator: self_attention``, the attention query ``attn_q`` ~
N(0, INIT_STD^2), drawn in f32 from an explicit ``torch.Generator`` in that
order; the tables are then cast to ``cfg.param_dtype`` (``w0``, ``attn_q``
and the optimizer slots stay f32). A table of more than INIT_BLOCK_ROWS
rows is drawn in blocks of that many rows, in order; on a mesh every rank
draws every block and keeps the rows of its shard, so that no rank holds a
global table and the generators stay in step. The accum mode's gradient
rows and the optimizer slots start at zero, a shard's on a mesh.
``state_from_numpy`` / ``state_to_numpy`` carry the state across from and
to the JAX package (or any numpy source), which is how the parity tests
start both packages from one state. numpy has no bfloat16 of its own, so a
bf16 table crosses as f32 (exact both ways) and ``state_from_numpy`` takes
the tables' dtype as an argument.

The step updates the tables, gradient rows and table slots in place
(``train/scatter.py``): a caller that keeps an old state clones it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from heat_tpu_torch.config import CFConfig, SGD_MODE_ACCUM

INIT_STD = 1e-2  # reference nn.init.normal_(w, std=1e-2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Tables of more rows are drawn in blocks of this many (at d = 128 in f32
# a block is 2 GB). At least the dense update's threshold
# (``train/scatter.py`` DENSE_ROWS_THRESHOLD), so every table of the
# dense path draws in one call.
INIT_BLOCK_ROWS = 4 * 1024 * 1024


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``cfg.param_dtype`` / ``cfg.compute_dtype``
    name."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype must be one of {sorted(DTYPES)}, got {name!r}"
        ) from None


@dataclasses.dataclass
class TrainState:
    """All mutable training state.

    Attributes:
      user_emb: (U, d) user embedding table, f32 or bf16
        (cfg.param_dtype).
      item_emb: (I, d) item embedding table, of the same type.
      w0: (d, d) f32 behaviour-aggregator weights.
      lr: 0-d f32 tensor, the current learning rate (set per epoch).
      step: 0-d int32 tensor, the count of batches with real samples.
      user_gacc / item_gacc: persistent per-row gradient accumulators,
        shaped and typed like their tables, present only in
        sgd_mode="accum"; None otherwise.
      opt_slots: optimizer moment tables for cfg.optimizer "adagrad" or
        "adam", a dict keyed "{user,item,w0,attn_q}_{m,v}" ("_m" for Adam
        only, "attn_q_*" only with ``attn_q``), each f32 and shaped like
        its parameter; None for SGD.
      attn_q: (d,) f32 learned attention query, present only under
        cfg.aggregator "self_attention"; None otherwise.
    """

    user_emb: torch.Tensor
    item_emb: torch.Tensor
    w0: torch.Tensor
    lr: torch.Tensor
    step: torch.Tensor
    user_gacc: Optional[torch.Tensor] = None
    item_gacc: Optional[torch.Tensor] = None
    opt_slots: Optional[dict] = None
    attn_q: Optional[torch.Tensor] = None


def init_train_state(
    cfg: CFConfig, generator: torch.Generator, device, shards=None
) -> TrainState:
    """Normal(0, INIT_STD) tables, w0 and (self_attention) attn_q, drawn
    in f32 on ``device`` from ``generator`` (which must live on that
    device), the tables cast to ``cfg.param_dtype``; zero gradient rows
    (accum, the tables' type) and f32 optimizer slots (adagrad, adam).

    shards: a rank's ``parallel.mesh.TableShards``: the rank's shard of the
      global state is returned, its user rows and its rows of the
      zero-padded item table (``parallel.mesh.shard_train_state``'s
      layout). A table of at most INIT_BLOCK_ROWS rows is drawn whole and
      cut; a larger one block by block, each block drawn on every rank and
      only its rows of the shard kept, so the peak is one block and the
      global state is the mesh-less engine's of the same seed."""
    d = cfg.emb_dim
    dtype = torch_dtype(cfg.param_dtype)

    def normal(*shape):
        # Scaled in place: a block of 4M rows at d = 128 is 2 GB in f32.
        return torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        ).mul_(INIT_STD)

    def table(rows: int, lo: int, keep: int) -> torch.Tensor:
        """Rows [lo, lo + keep) of a (rows, d) table, zero past its end."""
        out = None
        if rows <= INIT_BLOCK_ROWS:
            out = normal(rows, d).to(dtype)
            if (lo, keep) == (0, rows):
                return out
        part = torch.zeros((keep, d), dtype=dtype, device=device)
        for start in range(0, rows, INIT_BLOCK_ROWS):
            n = min(INIT_BLOCK_ROWS, rows - start)
            block = out if out is not None else normal(n, d)
            a, b = max(start, lo), min(start + n, lo + keep)
            if b > a:
                part[a - lo: b - lo].copy_(block[a - start: b - start])
            del block  # freed before the next block is drawn
        return part

    users = (0, cfg.num_users) if shards is None else (
        shards.user_lo, shards.user_rows)
    items = (0, cfg.num_items) if shards is None else (
        shards.item_lo, shards.item_rows)
    params = {
        "user": table(cfg.num_users, *users),
        "item": table(cfg.num_items, *items),
        "w0": normal(d, d),
    }
    if cfg.aggregator == "self_attention":
        params["attn_q"] = normal(d)
    opt_slots = None
    if cfg.optimizer in ("adagrad", "adam"):
        kinds = ("v", "m") if cfg.optimizer == "adam" else ("v",)
        opt_slots = {
            f"{name}_{kind}": torch.zeros_like(p, dtype=torch.float32)
            for kind in kinds
            for name, p in params.items()
        }
    accum = cfg.sgd_mode == SGD_MODE_ACCUM
    return TrainState(
        user_emb=params["user"],
        item_emb=params["item"],
        w0=params["w0"],
        lr=torch.tensor(cfg.l_r, dtype=torch.float32, device=device),
        step=torch.tensor(0, dtype=torch.int32, device=device),
        user_gacc=torch.zeros_like(params["user"]) if accum else None,
        item_gacc=torch.zeros_like(params["item"]) if accum else None,
        opt_slots=opt_slots,
        attn_q=params.get("attn_q"),
    )


def zero_grad_accumulators(state: TrainState) -> TrainState:
    """The reference's zero_grad at sub-epoch boundaries (engine.cpp:
    344-347): zero the accum mode's gradient rows in place."""
    for gacc in (state.user_gacc, state.item_gacc):
        if gacc is not None:
            gacc.zero_()
    return state


def state_from_numpy(
    user_emb, item_emb, w0, *, lr: float, step: int, device,
    user_gacc=None, item_gacc=None, opt_slots: Optional[dict] = None,
    param_dtype: torch.dtype = torch.float32, attn_q=None, shards=None,
) -> TrainState:
    """A TrainState on ``device`` from array-likes (for example the JAX
    TrainState's arrays through ``np.asarray``). Copies the data.
    ``opt_slots`` maps slot names to array-likes. Every array crosses as
    f32 (exact for an ``ml_dtypes`` bfloat16 source); the tables and the
    gradient rows are then cast to ``param_dtype``, which is exact again
    when the source held that type. ``w0``, ``attn_q`` and the slots stay
    f32. ``shards`` (a rank's ``parallel.mesh.TableShards``, the
    ``Engine.shards`` of a mesh engine): the arrays are the global state,
    and the rank's shard of it is returned
    (``parallel.mesh.shard_train_state``)."""

    def f32(x, dtype=torch.float32):
        if x is None:
            return None
        return torch.tensor(np.asarray(x, np.float32), device=device).to(dtype)

    state = TrainState(
        user_emb=f32(user_emb, param_dtype),
        item_emb=f32(item_emb, param_dtype),
        w0=f32(w0),
        lr=torch.tensor(float(lr), dtype=torch.float32, device=device),
        step=torch.tensor(int(step), dtype=torch.int32, device=device),
        user_gacc=f32(user_gacc, param_dtype),
        item_gacc=f32(item_gacc, param_dtype),
        opt_slots=(
            None if opt_slots is None
            else {k: f32(v) for k, v in opt_slots.items()}
        ),
        attn_q=f32(attn_q),
    )
    if shards is not None:
        from heat_tpu_torch.parallel.mesh import shard_train_state

        state = shard_train_state(state, shards)
    return state


def state_to_numpy(state: TrainState, shards=None) -> dict:
    """The state's arrays on the host: user_emb, item_emb, w0, lr, step,
    and user_gacc / item_gacc / opt_slots (a dict of arrays) / attn_q where
    present. bf16 tensors come out as f32 (exact): numpy has no bfloat16.
    With ``shards`` (a mesh engine's ``Engine.shards``), ``state`` is the
    rank's shard and the global arrays are returned (gathered from every
    rank: collective, every rank calls it)."""
    if shards is not None:
        from heat_tpu_torch.parallel.mesh import gather_train_state

        state = gather_train_state(state, shards)

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            out[f.name] = {k: host(v) for k, v in value.items()}
        elif value is not None:
            out[f.name] = host(value)
    return out
