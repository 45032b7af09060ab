"""Training state: embedding tables and aggregator weights as tensors.

Counterpart of ``heat_tpu/models/state.py``. The tables are plain tensors,
not ``nn.Parameter``s: they are updated by a manual, duplicate-safe sparse
row update (``train/scatter.py``), and autograd runs only over the rows a
step gathers and ``w0`` (``train/train_step.py``).

Initialization: user/item embeddings and ``w0`` ~ N(0, INIT_STD^2), drawn
from an explicit ``torch.Generator``. ``state_from_numpy`` /
``state_to_numpy`` carry weights across from and to the JAX package (or
any numpy source), which is how the parity tests start both packages from
one state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from heat_tpu_torch.config import CFConfig

INIT_STD = 1e-2  # reference nn.init.normal_(w, std=1e-2)


@dataclasses.dataclass
class TrainState:
    """All mutable training state of the slice (batch-mode SGD).

    Attributes:
      user_emb: (U, d) f32 user embedding table.
      item_emb: (I, d) f32 item embedding table.
      w0: (d, d) f32 behaviour-aggregator weights.
      lr: 0-d f32 tensor, the current learning rate (set per epoch).
      step: 0-d int32 tensor, the count of batches with real samples.
    """

    user_emb: torch.Tensor
    item_emb: torch.Tensor
    w0: torch.Tensor
    lr: torch.Tensor
    step: torch.Tensor


def init_train_state(
    cfg: CFConfig, generator: torch.Generator, device
) -> TrainState:
    """Normal(0, INIT_STD) tables and w0, drawn on ``device`` from
    ``generator`` (which must live on that device)."""
    d = cfg.emb_dim

    def normal(*shape):
        return (
            torch.randn(
                shape, generator=generator, device=device, dtype=torch.float32
            )
            * INIT_STD
        )

    return TrainState(
        user_emb=normal(cfg.num_users, d),
        item_emb=normal(cfg.num_items, d),
        w0=normal(d, d),
        lr=torch.tensor(cfg.l_r, dtype=torch.float32, device=device),
        step=torch.tensor(0, dtype=torch.int32, device=device),
    )


def state_from_numpy(
    user_emb, item_emb, w0, *, lr: float, step: int, device
) -> TrainState:
    """A TrainState on ``device`` from array-likes (for example the JAX
    TrainState's arrays through ``np.asarray``). Copies the data."""

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return TrainState(
        user_emb=f32(user_emb),
        item_emb=f32(item_emb),
        w0=f32(w0),
        lr=torch.tensor(float(lr), dtype=torch.float32, device=device),
        step=torch.tensor(int(step), dtype=torch.int32, device=device),
    )


def state_to_numpy(state: TrainState) -> dict[str, np.ndarray]:
    """The state's arrays on the host: user_emb, item_emb, w0, lr, step."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }
