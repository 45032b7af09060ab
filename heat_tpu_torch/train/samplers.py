"""Negative samplers, on device (the uniform sampler of this slice).

Counterpart of ``heat_tpu/train/samplers.py``: uniform item ids, with the
``ignore_pos`` variant redrawing once every slot that hit the positive.
Draws come from an explicit ``torch.Generator``; they match the JAX
sampler in distribution, not bit for bit (tests pin the draws instead).
The tile sampler is not ported yet (the engine refuses it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from heat_tpu_torch.config import CFConfig, NEG_SAMPLER_UNIFORM


class NegSample(NamedTuple):
    """ids: (B, K) int32 negative item ids."""

    ids: torch.Tensor


@dataclasses.dataclass
class SamplerState:
    """iterations: 0-d int32 tensor, the count of real samples drawn so
    far (the pinned-draw tests index their draw tables with it)."""

    iterations: torch.Tensor


def init_sampler_state(cfg: CFConfig, device) -> SamplerState:
    if cfg.neg_sampler != NEG_SAMPLER_UNIFORM:
        raise NotImplementedError(
            "only the uniform negative sampler is ported (tile sampler: "
            "ROADMAP item 10)"
        )
    return SamplerState(
        iterations=torch.tensor(0, dtype=torch.int32, device=device)
    )


def _uniform_negatives(
    generator: torch.Generator,
    batch: int,
    num_negs: int,
    num_items: int,
    pos_ids: torch.Tensor,
    ignore_pos: bool,
) -> torch.Tensor:
    def draw():
        return torch.randint(
            0, num_items, (batch, num_negs), generator=generator,
            device=pos_ids.device, dtype=torch.int32,
        )

    negs = draw()
    if ignore_pos:
        # Redraw slots that hit the positive; a double collision has
        # probability (1/num_items)^2 and is accepted.
        negs = torch.where(negs == pos_ids[:, None], draw(), negs)
    return negs


def sample_negatives(
    generator: torch.Generator,
    state: SamplerState,
    pos_ids: torch.Tensor,
    cfg: CFConfig,
    real: Optional[torch.Tensor] = None,
) -> tuple[NegSample, SamplerState]:
    """Draw (B, num_negs) negatives for one batch. ``real``: optional
    0-d count of real (weight > 0) samples; the iteration counter advances
    by it (by the batch width when None)."""
    batch = pos_ids.shape[0]
    negs = _uniform_negatives(
        generator, batch, cfg.num_negs, cfg.num_items, pos_ids, cfg.ignore_pos
    )
    adv = batch if real is None else real.to(torch.int32)
    return NegSample(ids=negs), SamplerState(iterations=state.iterations + adv)
