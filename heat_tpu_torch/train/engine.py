"""Training engine: the epoch loop and evaluation.

Counterpart of ``heat_tpu/train/engine.py`` for the single-device slice:
``Engine.__init__``, batch packing with weight-0 padding
(``_make_batches`` / ``_shuffle_or_pack``, modes "epoch", "once" and
"none"), ``train_one_epoch`` with the LR milestones, ``evaluate`` and
``evaluate0``. Where the JAX epoch is one ``lax.scan`` program, here it is
a Python loop over batches; the epoch's loss sum stays on the device and
is read once per epoch.

Configurations outside the slice raise ``NotImplementedError`` naming the
ROADMAP item that will add them; nothing falls back silently. The JAX
engine's history dedup (active under ``shuffle_mode: none``) is an exact
rewrite of the per-sample means, so this engine computes the per-sample
means and gets the same values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from heat_tpu_torch.config import (
    CFConfig,
    NEG_SAMPLER_UNIFORM,
    SGD_MODE_BATCH,
)
from heat_tpu_torch.data.datasets import ClickDataset
from heat_tpu_torch.evaluation.evaluator import TiledEvaluator
from heat_tpu_torch.evaluation.metrics import (
    evaluate_metrics_device,
    pad_truth,
    parse_metric,
)
from heat_tpu_torch.models.aggregator import user_pools_impl
from heat_tpu_torch.models.state import TrainState, init_train_state
from heat_tpu_torch.train.optimizer import scheduled_lr
from heat_tpu_torch.train.samplers import init_sampler_state
from heat_tpu_torch.train.scatter import DENSE_ROWS_THRESHOLD
from heat_tpu_torch.train.train_step import Batch, train_step


# Chunked whole-table pooling; the implementation lives next to the pooling
# math in models/aggregator.py (the JAX package jits it here).
compute_user_pools = user_pools_impl


def check_slice(cfg: CFConfig) -> None:
    """Raise NotImplementedError for any setting this port does not run
    yet, naming where ROADMAP.md ("Modules still to port") places it."""
    off_slice = [
        (cfg.neg_sampler != NEG_SAMPLER_UNIFORM, "the tile sampler", "item 10"),
        (cfg.his_refresh != "step", "his_refresh: subepoch", "item 10"),
        (cfg.aggregator != "mean", f"aggregator: {cfg.aggregator}", "item 12"),
        (cfg.optimizer != "sgd", f"optimizer: {cfg.optimizer}", "item 12"),
        (cfg.sgd_mode != SGD_MODE_BATCH, f"sgd_mode: {cfg.sgd_mode}", "item 12"),
        (cfg.update_mode != "dedup", f"update_mode: {cfg.update_mode}", "item 4"),
        (cfg.l2_enabled, "l2_enabled", "item 4"),
        (cfg.num_subepochs > 1, "num_subepochs > 1", "item 11"),
        (cfg.param_dtype != "float32", f"param_dtype: {cfg.param_dtype}", "item 10"),
        (
            cfg.compute_dtype != "float32",
            f"compute_dtype: {cfg.compute_dtype}",
            "item 10",
        ),
        (cfg.visit_order != "file", f"visit_order: {cfg.visit_order}", "item 10"),
        (bool(cfg.emb_pad), "emb_pad (TPU lane padding)", "the do-not-port list"),
        (
            max(cfg.num_users, cfg.num_items) > DENSE_ROWS_THRESHOLD,
            "tables above DENSE_ROWS_THRESHOLD rows (sort-dedup update)",
            "item 4",
        ),
    ]
    for bad, what, where in off_slice:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to heat_tpu_torch "
                f"(ROADMAP.md, modules still to port, {where})"
            )


def set_f32_matmul_precision() -> None:
    """Keep every f32 product on the card full f32 (no TF32), and check
    that the settings took: ranking and scores depend on it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError("could not turn TF32 off for f32 matmuls")


class Engine:
    """Drives training and evaluation for one model on one device.

    Args:
      cfg: hyperparameters (num_users/num_items/train_size are taken from
        ``train_data``).
      train_data: parsed click data.
      test_data: held-out clicks for ranking metrics (optional).
      seed: seeds the engine's generator (cfg.seed when None), which draws
        the initial state, the epoch shuffles and the negatives.
      device: "cuda" (the default; fails without a card) or "cpu".
      mesh: multi-device layouts are not ported; anything but None raises.
    """

    def __init__(
        self,
        cfg: CFConfig,
        train_data: ClickDataset,
        test_data: Optional[ClickDataset] = None,
        seed: Optional[int] = None,
        device="cuda",
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported to heat_tpu_torch (ROADMAP.md, "
                "modules still to port, item 15)"
            )
        cfg.num_users = train_data.num_users
        cfg.num_items = train_data.num_items
        cfg.train_size = train_data.train_size
        check_slice(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (pass --device cpu to run on the CPU)"
            )
        set_f32_matmul_precision()
        self.cfg = cfg
        self.train_data = train_data
        self.test_data = test_data
        self.epoch = 0

        seed = cfg.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state: TrainState = init_train_state(
            cfg, self.generator, self.device
        )
        self.sampler_state = init_sampler_state(cfg, self.device)
        self.pairs = torch.as_tensor(
            np.asarray(train_data.pairs, np.int32), device=self.device
        )
        self.his_items = torch.as_tensor(
            np.asarray(train_data.his_items, np.int32), device=self.device
        )
        self.his_masks = torch.as_tensor(
            np.asarray(train_data.masks, np.int32), device=self.device
        )
        self._evaluator = None  # lazy TiledEvaluator (mask tensors cached)
        self._batch_cache = None  # shuffle_mode == "once" packed stream

    # ------------------------------------------------------------------
    def unpadded_state(self) -> TrainState:
        """The train state for serving and export. The JAX engine slices
        mesh-divisibility padding rows off here; this engine pads nothing
        and holds no optimizer state, so its state is already the tables
        and ``w0``."""
        return self.state

    # ------------------------------------------------------------------
    def _shuffle_or_pack(self, pairs, num_batches: int, batch: int):
        """(users, pos, weight), each (num_batches, batch): pairs in a
        shuffled ("epoch"; "once" shuffles once and reuses the stream) or
        file ("none") order, the tail padded by repeating the stream with
        weight 0."""
        mode = self.cfg.shuffle_mode
        if mode == "once" and self._batch_cache is not None:
            return self._batch_cache
        n = pairs.shape[0]
        total = num_batches * batch
        if mode != "none":
            perm = torch.randperm(n, generator=self.generator, device=self.device)
            pairs = pairs[perm]
        if total > n:
            pairs = pairs.repeat(-(-total // n), 1)[:total]
        weight = (torch.arange(total, device=self.device) < n).to(torch.float32)
        # Contiguous per-batch rows: the kernels take contiguous ids.
        out = (
            pairs[:, 0].contiguous().reshape(num_batches, batch),
            pairs[:, 1].contiguous().reshape(num_batches, batch),
            weight.reshape(num_batches, batch),
        )
        if mode == "once":
            self._batch_cache = out
        return out

    def _make_batches(self, pairs: torch.Tensor):
        n = int(pairs.shape[0])
        batch = min(self.cfg.batch_size, max(1, n))
        num_batches = -(-n // batch)
        return self._shuffle_or_pack(pairs, num_batches, batch)

    def train_one_epoch(self) -> float:
        """Run one epoch; returns the mean per-sample loss."""
        cfg = self.cfg
        lr = scheduled_lr(cfg.l_r, self.epoch, cfg.milestones, cfg.lr_gamma)
        self.state.lr = torch.tensor(lr, dtype=torch.float32, device=self.device)
        if int(self.pairs.shape[0]) == 0:
            self.epoch += 1
            return 0.0
        users, pos, weight = self._make_batches(self.pairs)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(users.shape[0]):
            self.state, self.sampler_state, loss = train_step(
                self.state,
                self.sampler_state,
                self.generator,
                Batch(users[i], pos[i], weight[i]),
                self.his_items,
                self.his_masks,
                cfg,
            )
            loss_sum += loss
        self.epoch += 1
        return float(loss_sum) / max(1, cfg.train_size)

    # ------------------------------------------------------------------
    def _ensure_evaluator(self, user_tile: int) -> None:
        if self._evaluator is None or self._evaluator.user_tile != user_tile:
            self._evaluator = TiledEvaluator(
                self.train_data.pairs,
                self.cfg.num_users,
                user_tile=user_tile,
                num_items=self.cfg.num_items,
                device=self.device,
            )
            truth, truth_len = pad_truth(self.test_data.user_items)
            self._truth_dev = (
                torch.as_tensor(truth, device=self.device),
                torch.as_tensor(truth_len, device=self.device),
            )

    def evaluate(
        self,
        metrics: Optional[Sequence[str]] = None,
        user_tile: int = 512,
    ) -> dict[str, float]:
        """Exact tiled top-k over all items (train items masked) and the
        metric library, on the engine's device. Scores the raw user table,
        whose rows were aggregated during training by the write-back."""
        if self.test_data is None:
            raise ValueError("no test_data provided")
        metrics = list(metrics if metrics is not None else self.cfg.metrics)
        max_k = max(parse_metric(m)[1] for m in metrics)
        self._ensure_evaluator(user_tile)
        _, top_ids = self._evaluator.topk(
            self.state.user_emb, self.state.item_emb, max_k
        )
        return evaluate_metrics_device(metrics, top_ids, *self._truth_dev)

    def evaluate0(self) -> np.ndarray:
        """Dense user x item dot-product matrix on the host (small problems
        and parity tests only)."""
        return (self.state.user_emb @ self.state.item_emb.T).cpu().numpy()
