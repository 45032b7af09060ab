"""Click datasets: parsing, history construction, user-range sharding.

A copy of ``heat_tpu/data/datasets.py`` (that package cannot be imported
without jax, see ``heat_tpu/__init__.py``), kept verbatim apart from its
imports and one cut: only the pure-Python parser is carried over; the
native OpenMP parser of ``heat_tpu/native`` is not ported yet.

TPU-native counterpart of the reference data frontend (cf/datasets.py:14-216):

* same text format — ``user item1 item2 ...`` lines (LightGCN style), one
  line per user, duplicate user lines resolved last-wins (the reference's
  dict-overwrite semantics, cf/datasets.py:45);
* same history-matrix semantics (cf/datasets.py:47-61): a user with
  ``n >= max_his`` clicks gets a random ``max_his``-subset sampled without
  replacement; ``0 < n < max_his`` pads by repeating the last item;
  ``n == 0`` is all zeros with mask 0; the mask is the true history length
  (capped at ``max_his``);
* same user-range shard arithmetic as the MPI dataset scatter
  (cf/main.py:51-57): ``num_users`` split into ``nproc`` contiguous ranges,
  the first ``num_users % nproc`` ranges one user larger — but realized as
  deterministic local slicing per process instead of pickled MPI sends;
* packed int32 numpy arrays (clicks N x 2, his_items U x max_his, masks U)
  ready to feed the jitted epoch — int32 ids are validated sufficient up to
  the 100M-row synthetic config (tests/test_large_scale.py);
* an ``.npz`` binary cache (CSR user->items layout) so large datasets parse
  once.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence

import numpy as np


def _parse_lines_numpy(path: str, separator: str = " ") -> List[np.ndarray]:
    """Pure-Python parser: per-user item arrays indexed by user id.

    Returns a list of length ``max_user_id + 1``; user ids absent from the
    file get empty arrays; duplicate user lines resolve last-wins. Tolerates
    CRLF line endings, empty lines, trailing separators, and non-numeric
    tokens (skipped), matching the native parser
    (heat_tpu/native/click_parser.cc).
    """
    per_user: dict[int, np.ndarray] = {}
    max_user = -1
    with open(path, "r") as f:
        for line in f:
            if separator != " ":
                line = line.replace(separator, " ")
            nums = [int(t) for t in line.split() if t.isdigit()]
            if not nums:
                continue
            u = nums[0]
            per_user[u] = np.asarray(nums[1:], np.int32)
            if u > max_user:
                max_user = u
    empty = np.empty(0, np.int32)
    return [per_user.get(u, empty) for u in range(max_user + 1)]


@dataclasses.dataclass
class ClickDataset:
    """Packed click data for one process.

    Attributes:
      pairs: (N, 2) int32 — (user_id, item_id) training interactions in
        file order (the reference's click-pair list, cf/datasets.py:31-44).
      his_items: (U, max_his) int32 — per-user history matrix.
      masks: (U,) int32 — true history length per user (cf/datasets.py:62).
      num_users / num_items: id-space sizes (max id + 1, global for items).
      max_his: history matrix width.
      user_items: per-user item id sequences (ragged); used as ranking
        ground truth when this is a test split, and for train-item masking.
    """

    pairs: np.ndarray
    his_items: np.ndarray
    masks: np.ndarray
    num_users: int
    num_items: int
    max_his: int
    user_items: List[np.ndarray]

    @property
    def train_size(self) -> int:
        return int(self.pairs.shape[0])

    # ------------------------------------------------------------------
    @classmethod
    def from_user_items(
        cls,
        user_items: Sequence[Sequence[int]],
        max_his: int,
        num_items: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> "ClickDataset":
        """Build packed arrays from per-user item sequences.

        ``num_items`` overrides the inferred item-space size — used for test
        splits, which inherit the train split's global item space
        (cf/datasets.py:159).
        """
        items_per_user = [np.asarray(it, np.int32) for it in user_items]
        num_users = len(items_per_user)
        gaps = sum(1 for it in items_per_user if len(it) == 0)
        if gaps:
            # Reference parity: cf/datasets.py:95-99 warns when user ids
            # are not contiguous (absent ids get empty rows here).
            logging.getLogger("heat_tpu_torch").warning(
                "user id space is not contiguous: %d of %d ids have no "
                "interactions (empty history rows)", gaps, num_users,
            )
        counts = np.asarray([len(it) for it in items_per_user], np.int64)
        total = int(counts.sum())
        if total:
            users = np.repeat(
                np.arange(num_users, dtype=np.int32), counts
            )
            stream = np.concatenate(
                [it for it in items_per_user if len(it)]
            ).astype(np.int32)
            pairs = np.stack([users, stream], axis=1)
        else:
            pairs = np.empty((0, 2), np.int32)
        if num_items is None:
            num_items = int(pairs[:, 1].max()) + 1 if total else 1

        his = np.zeros((num_users, max_his), np.int32)
        masks = np.zeros((num_users,), np.int32)
        rng = np.random.default_rng(seed)
        for u, it in enumerate(items_per_user):
            n = len(it)
            if n == 0:
                continue  # zeros + mask 0 (cf/datasets.py:56-60)
            if n >= max_his:
                # sample without replacement if long (cf/datasets.py:47-50)
                his[u] = (
                    it
                    if n == max_his
                    else rng.choice(it, size=max_his, replace=False)
                )
                masks[u] = max_his
            else:
                # pad by repeating the last item (cf/datasets.py:51-55)
                his[u, :n] = it
                his[u, n:] = it[-1]
                masks[u] = n
        return cls(
            pairs=pairs,
            his_items=his,
            masks=masks,
            num_users=num_users,
            num_items=int(num_items),
            max_his=max_his,
            user_items=items_per_user,
        )

    @classmethod
    def from_file(
        cls,
        path: str,
        max_his: int,
        separator: str = " ",
        num_items: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> "ClickDataset":
        """Parse a click text file (pure-Python parser) into a packed
        dataset."""
        user_items = _parse_lines_numpy(path, separator)
        return cls.from_user_items(
            user_items, max_his, num_items=num_items, seed=seed
        )

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Binary cache: one compressed .npz with a CSR user->items layout
        (parse the text file once, reload in milliseconds)."""
        counts = np.asarray([len(t) for t in self.user_items], np.int64)
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        stream = (
            np.concatenate(
                [np.asarray(t, np.int32) for t in self.user_items if len(t)]
            )
            if counts.sum()
            else np.empty(0, np.int32)
        )
        np.savez_compressed(
            path,
            pairs=self.pairs,
            his_items=self.his_items,
            masks=self.masks,
            meta=np.asarray(
                [self.num_users, self.num_items, self.max_his], np.int64
            ),
            ui_offsets=offsets,
            ui_stream=stream,
        )

    @classmethod
    def load(cls, path: str) -> "ClickDataset":
        with np.load(path) as z:
            meta = z["meta"]
            offsets = z["ui_offsets"]
            stream = z["ui_stream"]
            user_items = [
                stream[offsets[u] : offsets[u + 1]]
                for u in range(len(offsets) - 1)
            ]
            return cls(
                pairs=z["pairs"],
                his_items=z["his_items"],
                masks=z["masks"],
                num_users=int(meta[0]),
                num_items=int(meta[1]),
                max_his=int(meta[2]),
                user_items=user_items,
            )


def load_with_cache(
    path: str,
    max_his: int,
    separator: str = " ",
    num_items: Optional[int] = None,
    seed: Optional[int] = None,
    cache: bool = True,
) -> "ClickDataset":
    """``ClickDataset.from_file`` with a transparent ``.npz`` sidecar cache.

    The cache file lives next to the source
    (``<path>.heat-<max_his>-<seed>-<num_items>.npz``) and is rebuilt
    whenever the source is newer — so large datasets parse once, then
    reload in milliseconds. The parametrization is part of the file name
    because history sampling depends on (max_his, seed) and test splits
    inherit the train split's item space.
    """
    if not cache:
        return ClickDataset.from_file(
            path, max_his, separator=separator, num_items=num_items, seed=seed
        )
    tag = f"heat-{max_his}-{seed}-{num_items}"
    cache_path = f"{path}.{tag}.npz"
    if os.path.exists(cache_path) and os.path.getmtime(
        cache_path
    ) >= os.path.getmtime(path):
        try:
            return ClickDataset.load(cache_path)
        except Exception:
            pass  # corrupt/stale cache: fall through and rebuild
    ds = ClickDataset.from_file(
        path, max_his, separator=separator, num_items=num_items, seed=seed
    )
    try:
        ds.save(cache_path)
    except OSError:
        pass  # read-only data dir: just skip caching
    return ds


def user_range_bounds(num_users: int, nproc: int, rank: int) -> tuple:
    """[start, end) of rank's contiguous user range (cf/main.py:51-57:
    the first ``num_users % nproc`` ranks get one extra user)."""
    base, rem = divmod(num_users, nproc)
    start = rank * base + min(rank, rem)
    end = start + base + (1 if rank < rem else 0)
    return start, end


def shard_by_user_range(
    ds: ClickDataset, nproc: int, rank: int, rebase: bool = True
) -> ClickDataset:
    """This rank's user-range slice of a dataset.

    The TPU-native replacement for the reference's pickled MPI dataset
    scatter (cf/main.py:47-70): every process calls this locally and
    deterministically gets the same shard the reference would have sent it.

    rebase=True re-bases user ids to the shard (the reference
    SubClickDataset semantics, cf/datasets.py:120-122) — used for local
    evaluation. rebase=False keeps GLOBAL user ids and the global
    ``num_users`` so the shards feed one global row-sharded user table
    (multi-host training); ``his_items``/``masks`` are still this rank's
    rows only (exactly its addressable slice of the global (U, H) table).
    Items are always the global space (cf/datasets.py:159).
    """
    start, end = user_range_bounds(ds.num_users, nproc, rank)
    sel = (ds.pairs[:, 0] >= start) & (ds.pairs[:, 0] < end)
    pairs = ds.pairs[sel].copy()
    if rebase:
        pairs[:, 0] -= start
    empty = np.empty(0, np.int32)
    user_items = [
        ds.user_items[u] if u < len(ds.user_items) else empty
        for u in range(start, end)
    ]
    return ClickDataset(
        pairs=pairs,
        his_items=ds.his_items[start:end],
        masks=ds.masks[start:end],
        num_users=(end - start) if rebase else ds.num_users,
        num_items=ds.num_items,
        max_his=ds.max_his,
        user_items=user_items,
    )
