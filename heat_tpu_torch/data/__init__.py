"""Data layer: click-file parsing, user-range sharding, synthetic data.

Copies of ``heat_tpu/data`` (numpy only; no torch or jax inside).
"""

from heat_tpu_torch.data.datasets import (
    ClickDataset,
    shard_by_user_range,
    user_range_bounds,
)
from heat_tpu_torch.data.synthetic import synthetic_click_dataset

__all__ = [
    "ClickDataset",
    "shard_by_user_range",
    "user_range_bounds",
    "synthetic_click_dataset",
]
