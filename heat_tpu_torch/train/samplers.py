"""Negative samplers, on device.

Counterpart of ``heat_tpu/train/samplers.py``:

* uniform item ids, with the ``ignore_pos`` variant redrawing once every
  slot that hit the positive;
* HEAT's tile sampler: a tile of ``tile_size`` random item ids refreshed
  every ``refresh_interval`` samples, and per-sample draws that index into
  the tile. The train step scores every user against the whole tile
  (``ops/similarity.py`` ``tile_scores``), so the negatives' reads and
  gradient rows stay inside a T-row working set.

Draws come from an explicit ``torch.Generator``; they match the JAX
samplers in distribution, not bit for bit (tests pin the draws instead).
The state (tile and sample counter) lives on the device, and nothing here
waits for it: the refresh is a ``torch.where`` on a device condition. A
draw advances the state in place (the counter and the tile keep their
tensors), so a step that draws can be captured into a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from heat_tpu_torch.config import CFConfig, NEG_SAMPLER_TILE


class NegSample(NamedTuple):
    """A batch of negatives, with tile structure when available.

    ids: (B, K) int32 negative item ids.
    tile: (T,) int32 item ids of the tile, or None for the uniform sampler.
    tile_idx: (B, K) int32 indices into the tile, or None.
    """

    ids: torch.Tensor
    tile: Optional[torch.Tensor] = None
    tile_idx: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SamplerState:
    """iterations: 0-d int32 tensor, the count of real samples drawn so
    far (the pinned-draw tests index their draw tables with it).
    tile: (tile_size,) int32 current negative tile (tile sampler only; None
    for the uniform sampler)."""

    iterations: torch.Tensor
    tile: Optional[torch.Tensor] = None


# Alpha/beta working-set split of HEAT's tile-tuning algorithm (paper
# Alg. 1): beta of the budget goes to the negative tile, alpha is reserved
# for the streaming data.
TILE_TUNE_ALPHA = 0.15
TILE_TUNE_BETA = 0.85
# Per-step budget for the (B, T) score and count matrices the tile path
# materializes. The JAX package's value, kept so that "auto" derives the
# same tile on both: 32 MB gives the reference's shipped tile_size = 512 at
# the AmazonBooks config (B = 8192, f32 scores + counts).
TILE_SCORE_BUDGET_BYTES = 32 * 1024 * 1024
# Expected draws landing on each tile slot before a refresh; ties
# refresh_interval to tile_size the way the reference configs do
# (tile 512 x 16 = refresh 8192 in AmazonBooks's config0.yaml).
TILE_DRAWS_PER_SLOT = 16


def derive_tile_params(
    cfg: CFConfig, budget_bytes: int = TILE_SCORE_BUDGET_BYTES
) -> tuple[int, int]:
    """(tile_size, refresh_interval) for ``cfg.tile_size <= 0`` ("auto"):
    HEAT paper Alg. 1 as the JAX package applies it. The tile is sized so
    that the step's (B, tile) score and count matrices (two f32 buffers)
    take beta x budget, rounded to the nearest power of two, at least 128
    and at most the largest power of two within the item count. The
    refresh gives each slot an expected TILE_DRAWS_PER_SLOT draws, floored
    at one batch (the sampler refreshes at most once per batch). Explicit
    settings are never overridden."""
    per_elem = 2 * 4  # scores and counts, f32
    t = TILE_TUNE_BETA * budget_bytes / (per_elem * max(1, cfg.batch_size))
    t = 1 << max(7, round(math.log2(max(2.0, t))))  # nearest power of two
    if cfg.num_items:
        t = min(t, max(128, 1 << int(math.log2(max(128, cfg.num_items)))))
    refresh = max(cfg.batch_size, t * TILE_DRAWS_PER_SLOT)
    return t, refresh


def init_sampler_state(
    cfg: CFConfig, device, generator: Optional[torch.Generator] = None
) -> SamplerState:
    """The sampler's initial state. The tile sampler draws its first tile
    from ``generator`` (which must live on ``device``)."""
    tile = None
    if cfg.neg_sampler == NEG_SAMPLER_TILE:
        tile = torch.randint(
            0, cfg.num_items, (cfg.tile_size,), generator=generator,
            device=device, dtype=torch.int32,
        )
    return SamplerState(
        iterations=torch.tensor(0, dtype=torch.int32, device=device),
        tile=tile,
    )


def uniform_negatives(
    generator: torch.Generator,
    batch: int,
    num_negs: int,
    num_items: int,
    pos_ids: torch.Tensor,
    ignore_pos: bool,
    rows: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """(batch, num_negs) uniform draws; under ``ignore_pos`` the slots that
    hit their sample's positive are drawn again. ``rows=(lo, hi)`` draws
    for the whole batch and keeps its rows [lo, hi), whose positives
    ``pos_ids`` holds: the rows a rank of a mesh keeps of the global
    batch's draws."""
    lo, hi = (0, batch) if rows is None else rows

    def draw():
        return torch.randint(
            0, num_items, (batch, num_negs), generator=generator,
            device=pos_ids.device, dtype=torch.int32,
        )[lo:hi]

    negs = draw()
    if ignore_pos:
        # Redraw slots that hit the positive; a double collision has
        # probability (1/num_items)^2 and is accepted.
        negs = torch.where(negs == pos_ids[:, None], draw(), negs)
    return negs


def _tile_draws(
    generator: torch.Generator, device, batch: int, num_negs: int,
    num_items: int, tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(fresh (T,) tile ids, (B, K) indices into the tile): one step's
    random draws. A function of its own so that tests can pin them."""
    fresh = torch.randint(
        0, num_items, (tile_size,), generator=generator, device=device,
        dtype=torch.int32,
    )
    idx = torch.randint(
        0, tile_size, (batch, num_negs), generator=generator, device=device,
        dtype=torch.int32,
    )
    return fresh, idx


def _tile_negatives(
    generator: torch.Generator,
    state: SamplerState,
    batch: int,
    num_negs: int,
    num_items: int,
    tile_size: int,
    refresh_interval: int,
    real: Optional[torch.Tensor] = None,
) -> tuple[NegSample, SamplerState]:
    """Tile sampler for one batch of ``batch`` samples.

    The reference refreshes when iterations % refresh_interval == 0, once
    per sample. A batch advances the counter by its REAL (weight > 0)
    sample count (``real``; the full batch width when None), and the tile
    is refreshed when those samples cross a refresh boundary: at most one
    refresh per batch, exact when batch <= refresh_interval. An all-padding
    batch is a no-op: counter unchanged, no refresh. A fresh tile is drawn
    every step and selected with ``torch.where``, so the host never reads
    the condition.
    """
    it = state.iterations
    device = it.device
    # A fill, not a copy from the host: the step stays capturable either way.
    adv = it.new_full((), batch) if real is None else real.to(torch.int32)
    # Refresh iff some sample j in [it, it + adv) has
    # j % refresh_interval == 0 (the reference's per-sample condition).
    phase = it % refresh_interval
    needs_refresh = (adv > 0) & ((phase == 0) | (phase + adv > refresh_interval))
    fresh, idx = _tile_draws(
        generator, device, batch, num_negs, num_items, tile_size
    )
    tile = state.tile.copy_(torch.where(needs_refresh, fresh, state.tile))
    ids = tile.index_select(0, idx.reshape(-1).long()).view(batch, num_negs)
    it.add_(adv)
    return NegSample(ids=ids, tile=tile, tile_idx=idx), state


def sample_negatives(
    generator: torch.Generator,
    state: SamplerState,
    pos_ids: torch.Tensor,
    cfg: CFConfig,
    real: Optional[torch.Tensor] = None,
) -> tuple[NegSample, SamplerState]:
    """Draw (B, num_negs) negatives for one batch. Tile mode follows the
    reference tile sampler (no positive-avoidance); uniform mode redraws
    positives when ``cfg.ignore_pos``. ``real``: optional 0-d count of real
    (weight > 0) samples; the iteration counter, and with it the tile's
    refresh cadence, advances by it (by the batch width when None). Returns
    the sample and ``state``, advanced in place."""
    batch = pos_ids.shape[0]
    if cfg.neg_sampler == NEG_SAMPLER_TILE:
        return _tile_negatives(
            generator, state, batch, cfg.num_negs, cfg.num_items,
            cfg.tile_size, cfg.refresh_interval, real=real,
        )
    negs = uniform_negatives(
        generator, batch, cfg.num_negs, cfg.num_items, pos_ids, cfg.ignore_pos
    )
    state.iterations.add_(batch if real is None else real.to(torch.int32))
    return NegSample(ids=negs), state


def sample_negatives_rows(
    generator: torch.Generator,
    state: SamplerState,
    pos_ids: torch.Tensor,
    cfg: CFConfig,
    batch: int,
    rows: tuple[int, int],
    real: torch.Tensor,
) -> tuple[NegSample, SamplerState]:
    """The negatives of rows ``rows = (lo, hi)`` of a global batch of
    ``batch`` samples, whose positives ``pos_ids`` holds: what a rank of a
    mesh keeps of the draws of one rank sampling the whole batch. Every
    rank draws them all from its generator, which is in step on every
    rank, so the tile, the draws and the sampler's state are the same
    everywhere. ``real``: the global batch's count of real samples (0-d),
    by which the counter advances, so the tile's refresh cadence is the
    global one. Returns the rows' sample (the tile whole, ``tile_idx`` of
    the rows) and ``state``, advanced in place."""
    lo, hi = rows
    if cfg.neg_sampler == NEG_SAMPLER_TILE:
        sample, state = _tile_negatives(
            generator, state, batch, cfg.num_negs, cfg.num_items,
            cfg.tile_size, cfg.refresh_interval, real=real,
        )
        return NegSample(sample.ids[lo:hi], sample.tile,
                         sample.tile_idx[lo:hi]), state
    negs = uniform_negatives(
        generator, batch, cfg.num_negs, cfg.num_items, pos_ids,
        cfg.ignore_pos, rows=rows,
    )
    state.iterations.add_(real.to(torch.int32))
    return NegSample(ids=negs), state
