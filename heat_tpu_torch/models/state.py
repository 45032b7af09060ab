"""Training state: embedding tables and aggregator weights as tensors.

Counterpart of ``heat_tpu/models/state.py``. The tables are plain tensors,
not ``nn.Parameter``s: they are updated by a manual, duplicate-safe sparse
row update (``train/scatter.py``), and autograd runs only over the rows a
step gathers and ``w0`` (``train/train_step.py``).

Initialization: user/item embeddings and ``w0`` ~ N(0, INIT_STD^2), drawn
from an explicit ``torch.Generator``; the accum mode's gradient rows and
the optimizer slots start at zero. ``state_from_numpy`` /
``state_to_numpy`` carry the state across from and to the JAX package (or
any numpy source), which is how the parity tests start both packages from
one state.

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


@dataclasses.dataclass
class TrainState:
    """All mutable training state.

    Attributes:
      user_emb: (U, d) f32 user embedding table.
      item_emb: (I, d) f32 item embedding table.
      w0: (d, d) f32 behaviour-aggregator weights.
      lr: 0-d f32 tensor, the current learning rate (set per epoch).
      step: 0-d int32 tensor, the count of batches with real samples.
      user_gacc / item_gacc: persistent per-row gradient accumulators,
        shaped like their tables, present only in sgd_mode="accum";
        None otherwise.
      opt_slots: optimizer moment tables for cfg.optimizer "adagrad" or
        "adam", a dict keyed "{user,item,w0}_{m,v}" ("_m" for Adam only),
        each f32 and shaped like its parameter; None for SGD.
    """

    user_emb: torch.Tensor
    item_emb: torch.Tensor
    w0: torch.Tensor
    lr: torch.Tensor
    step: torch.Tensor
    user_gacc: Optional[torch.Tensor] = None
    item_gacc: Optional[torch.Tensor] = None
    opt_slots: Optional[dict] = None


def init_train_state(
    cfg: CFConfig, generator: torch.Generator, device
) -> TrainState:
    """Normal(0, INIT_STD) tables and w0, drawn on ``device`` from
    ``generator`` (which must live on that device); zero gradient rows
    (accum) and optimizer slots (adagrad, adam)."""
    d = cfg.emb_dim

    def normal(*shape):
        # Scaled in place: a 16M-row table is 4 GB.
        return torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        ).mul_(INIT_STD)

    params = {
        "user": normal(cfg.num_users, d),
        "item": normal(cfg.num_items, d),
        "w0": normal(d, d),
    }
    opt_slots = None
    if cfg.optimizer in ("adagrad", "adam"):
        kinds = ("v", "m") if cfg.optimizer == "adam" else ("v",)
        opt_slots = {
            f"{name}_{kind}": torch.zeros_like(p)
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
) -> TrainState:
    """A TrainState on ``device`` from array-likes (for example the JAX
    TrainState's arrays through ``np.asarray``). Copies the data.
    ``opt_slots`` maps slot names to array-likes."""

    def f32(x):
        if x is None:
            return None
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return TrainState(
        user_emb=f32(user_emb),
        item_emb=f32(item_emb),
        w0=f32(w0),
        lr=torch.tensor(float(lr), dtype=torch.float32, device=device),
        step=torch.tensor(int(step), dtype=torch.int32, device=device),
        user_gacc=f32(user_gacc),
        item_gacc=f32(item_gacc),
        opt_slots=(
            None if opt_slots is None
            else {k: f32(v) for k, v in opt_slots.items()}
        ),
    )


def state_to_numpy(state: TrainState) -> dict:
    """The state's arrays on the host: user_emb, item_emb, w0, lr, step,
    and user_gacc / item_gacc / opt_slots (a dict of arrays) where
    present."""

    def host(t):
        return t.detach().cpu().numpy()

    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            out[f.name] = {k: host(v) for k, v in value.items()}
        elif value is not None:
            out[f.name] = host(value)
    return out
