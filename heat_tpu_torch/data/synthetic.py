"""Synthetic planted-cluster click data for benchmarks and tests.

The reference has no data generator — its de-facto integration tests are
the real AmazonBooks/Yelp18/Gowalla downloads (SURVEY.md section 4). This
generator produces a learnable collaborative-filtering problem of any
geometry: users and items are partitioned into matching clusters, and each
user's clicks are drawn mostly from their own cluster's item block, so a
working MF+CCL trainer must recover the block structure (recall at k well
above the random baseline), while a broken one cannot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from heat_tpu_torch.data.datasets import ClickDataset


def synthetic_click_dataset(
    num_users: int,
    num_items: int,
    clicks_per_user: Optional[int] = None,
    max_his: int = 10,
    num_clusters: Optional[int] = None,
    in_cluster_prob: float = 0.9,
    test_fraction: float = 0.25,
    seed: int = 0,
) -> Tuple[ClickDataset, ClickDataset]:
    """Generate (train, test) ClickDatasets with planted clusters.

    Every user gets ``clicks_per_user`` distinct items — a fraction
    ``in_cluster_prob`` from the user's own item block, the rest uniform
    noise — split into disjoint train/test sets with at least one test item
    per user. Defaults auto-scale the cluster count and click budget to the
    problem geometry.
    """
    rng = np.random.default_rng(seed)
    if num_clusters is None:
        # Enough clusters that blocks are discriminative, few enough that
        # each block has many co-clicking users.
        num_clusters = int(np.clip(round(np.sqrt(num_items) / 2), 2, 64))
    if clicks_per_user is None:
        block = max(2, num_items // num_clusters)
        clicks_per_user = int(np.clip(block // 2, 8, 48))
    clicks_per_user = max(2, clicks_per_user)

    bounds = np.linspace(0, num_items, num_clusters + 1).astype(np.int64)
    clusters = rng.integers(0, num_clusters, num_users)

    train_lists: list[np.ndarray] = []
    test_lists: list[np.ndarray] = []
    for u in range(num_users):
        lo, hi = bounds[clusters[u]], bounds[clusters[u] + 1]
        block = np.arange(lo, hi, dtype=np.int64)
        n_in = min(
            int(round(clicks_per_user * in_cluster_prob)), len(block)
        )
        chosen_in = rng.choice(block, size=n_in, replace=False)
        n_out = clicks_per_user - n_in
        noise = rng.integers(0, num_items, max(n_out, 0) * 2 + 1)
        items = np.unique(np.concatenate([chosen_in, noise]))[
            : clicks_per_user
        ]
        items = rng.permutation(items)
        n_test = max(1, int(round(len(items) * test_fraction)))
        n_test = min(n_test, len(items) - 1)  # keep train non-empty
        test_lists.append(items[:n_test].astype(np.int32))
        train_lists.append(items[n_test:].astype(np.int32))

    sub = rng.integers(0, 2**31 - 1, 2)
    train = ClickDataset.from_user_items(
        train_lists, max_his, num_items=num_items, seed=int(sub[0])
    )
    test = ClickDataset.from_user_items(
        test_lists, max_his, num_items=num_items, seed=int(sub[1])
    )
    return train, test
