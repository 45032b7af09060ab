"""Ranking-quality metrics.

The host formulas below are a copy of ``heat_tpu/evaluation/metrics.py``
(that package cannot be imported without jax), verbatim apart from their
imports (``evaluate_sim_matrix``, the dense host oracle, included); the
native hits kernel is the port's copy, ``heat_tpu_torch.native``. ``evaluate_metrics_device`` is
the torch counterpart of the JAX on-device metrics: the same formulas on
the engine's device, so only len(metrics) scalars reach the host.

The full metric library of the reference (cf/metrics.py:39-158): Recall,
NormalizedRecall, Precision, F1, DCG, NDCG, MRR, HitRate, MAP — identical
formulas, including the reference's idiosyncrasies:

* DCG uses natural log: sum over hit ranks i (0-based) of 1/ln(2+i)
  (metrics.py:99);
* MRR *sums* reciprocal ranks over all hits rather than taking the first
  (metrics.py:122-128);
* the 1e-12 epsilon denominators.

String specs like ``'Recall(k=20)'`` are parsed with a strict regex rather
than the reference's ``eval`` (metrics.py:15).

Unlike the reference — which zips full sim-matrix rows against
test-users-only truth lists and silently misaligns when a user has no test
items — metrics here are computed exactly over the users that have at least
one test item.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import numpy as np
import torch

from heat_tpu_torch import native

_METRIC_RE = re.compile(r"^(\w+)\(k=(\d+)\)$")


def parse_metric(spec: str) -> tuple[str, int]:
    """'Recall(k=20)' -> ('Recall', 20)."""
    m = _METRIC_RE.match(spec.strip())
    if not m or m.group(1) not in _METRIC_FNS:
        raise NotImplementedError(f"metrics={spec} not implemented.")
    return m.group(1), int(m.group(2))


def _dcg_from_hits(hits: np.ndarray) -> np.ndarray:
    """hits: (U, k) 0/1. Returns (U,) sum of 1/ln(2+i) at hit ranks."""
    k = hits.shape[1]
    discounts = 1.0 / np.log(2.0 + np.arange(k))
    return hits @ discounts


def _recall(hits, num_true, k):
    return hits[:, :k].sum(1) / (num_true + 1e-12)


def _normalized_recall(hits, num_true, k):
    return hits[:, :k].sum(1) / np.minimum(k, num_true + 1e-12)


def _precision(hits, num_true, k):
    return hits[:, :k].sum(1) / (k + 1e-12)


def _f1(hits, num_true, k):
    p = _precision(hits, num_true, k)
    r = _recall(hits, num_true, k)
    return 2 * p * r / (p + r + 1e-12)


def _dcg(hits, num_true, k):
    return _dcg_from_hits(hits[:, :k])


def _ndcg(hits, num_true, k):
    dcg = _dcg_from_hits(hits[:, :k])
    # Ideal DCG: all of the first min(k, |true|) ranks hit (metrics.py:110-112).
    n_ideal = np.minimum(k, num_true).astype(np.int64)
    discounts = np.concatenate(
        [[0.0], np.cumsum(1.0 / np.log(2.0 + np.arange(k)))]
    )
    idcg = discounts[n_ideal]
    return dcg / (idcg + 1e-12)


def _mrr(hits, num_true, k):
    h = hits[:, :k]
    recip = 1.0 / (1.0 + np.arange(k))
    return h @ recip


def _hit_rate(hits, num_true, k):
    return (hits[:, :k].sum(1) > 0).astype(np.float64)


def _map(hits, num_true, k):
    h = hits[:, :k]
    pos = np.cumsum(h, axis=1)
    prec = (pos * h) / (1.0 + np.arange(k))
    return prec.sum(1) / (pos[:, -1] + 1e-12)


_METRIC_FNS: dict[str, Callable] = {
    "Recall": _recall,
    "NormalizedRecall": _normalized_recall,
    "Precision": _precision,
    "F1": _f1,
    "DCG": _dcg,
    "NDCG": _ndcg,
    "MRR": _mrr,
    "HitRate": _hit_rate,
    "MAP": _map,
}


def _hits_matrix(
    top_k_items: np.ndarray, true_items: Sequence[Sequence[int]]
) -> np.ndarray:
    """(U, k) 0/1 membership of each ranked item in the user's true set.

    Uses the native OpenMP kernel (heat_tpu_torch/native/metrics_kernels.cc)
    when available; numpy per-user searchsorted is the fallback/oracle. The
    path taken is recorded in ``heat_tpu_torch.native.PATHS``."""
    try:
        hits = native.hits_matrix(np.asarray(top_k_items), true_items)
        native.PATHS["hits_matrix"] = "native"
        return hits
    except Exception:
        pass
    native.PATHS["hits_matrix"] = "numpy"
    u, k = top_k_items.shape
    hits = np.zeros((u, k), np.float64)
    for row, true in enumerate(true_items):
        if len(true):
            t = np.sort(np.asarray(true))
            idx = np.searchsorted(t, top_k_items[row])
            idx = np.minimum(idx, len(t) - 1)
            hits[row] = t[idx] == top_k_items[row]
    return hits


def evaluate_metrics(
    metrics: Sequence[str],
    top_k_items: np.ndarray,
    true_items: Sequence[Sequence[int]],
) -> dict[str, float]:
    """Average each metric over users with at least one test item.

    Args:
      metrics: specs like 'Recall(k=20)'.
      top_k_items: (U, >=max_k) ranked item ids (train items pre-masked —
        the evaluator handles masking on device).
      true_items: per-user test item lists aligned with top_k_items rows.

    Returns: {spec: value}.
    """
    parsed = [parse_metric(m) for m in metrics]
    max_k = max(k for _, k in parsed)
    if top_k_items.shape[1] < max_k:
        raise ValueError(
            f"top_k_items has {top_k_items.shape[1]} ranks < max k {max_k}"
        )
    keep = np.asarray([len(t) > 0 for t in true_items], bool)
    top = np.asarray(top_k_items)[keep, :max_k]
    truth = [t for t in true_items if len(t)]
    num_true = np.asarray([len(t) for t in truth], np.float64)
    hits = _hits_matrix(top, truth)
    out: dict[str, float] = {}
    for spec, (name, k) in zip(metrics, parsed):
        out[spec] = float(np.mean(_METRIC_FNS[name](hits, num_true, k)))
    return out


def pad_truth(
    true_items: Sequence[Sequence[int]],
) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged truth lists into a (U, L) int32 tensor padded with -1,
    plus (U,) lengths — the device-resident form for on-device metrics
    (uploaded once per dataset, like the evaluator's train-mask tensors)."""
    lengths = np.asarray([len(t) for t in true_items], np.int32)
    pad = max(1, int(lengths.max()) if len(lengths) else 1)
    truth = np.full((len(true_items), pad), -1, np.int32)
    for u, t in enumerate(true_items):
        if len(t):
            truth[u, : len(t)] = np.asarray(t, np.int32)
    return truth, lengths


def _device_metric_values(name: str, k: int, hits, num_true):
    """torch mirror of the host metric formulas (same idiosyncrasies)."""
    h = hits[:, :k]
    ranks = torch.arange(k, dtype=torch.float32, device=hits.device)
    if name == "Recall":
        return h.sum(1) / (num_true + 1e-12)
    if name == "NormalizedRecall":
        return h.sum(1) / torch.clamp(num_true + 1e-12, max=float(k))
    if name == "Precision":
        return h.sum(1) / (k + 1e-12)
    if name == "F1":
        p = h.sum(1) / (k + 1e-12)
        r = h.sum(1) / (num_true + 1e-12)
        return 2 * p * r / (p + r + 1e-12)
    discounts = 1.0 / torch.log(2.0 + ranks)
    if name == "DCG":
        return (h * discounts).sum(1)
    if name == "NDCG":
        dcg = (h * discounts).sum(1)
        n_ideal = torch.clamp(num_true, max=float(k)).long()
        cum = torch.cat([discounts.new_zeros(1), torch.cumsum(discounts, 0)])
        return dcg / (cum[n_ideal] + 1e-12)
    if name == "MRR":
        return (h * (1.0 / (1.0 + ranks))).sum(1)
    if name == "HitRate":
        return (h.sum(1) > 0).float()
    if name == "MAP":
        pos = torch.cumsum(h, 1)
        prec = (pos * h) / (1.0 + ranks)
        return prec.sum(1) / (pos[:, -1] + 1e-12)
    raise NotImplementedError(name)


def evaluate_metrics_device(
    metrics: Sequence[str],
    top_k_items: torch.Tensor,
    truth: torch.Tensor,
    truth_len: torch.Tensor,
) -> dict[str, float]:
    """Metrics averaged over users with at least one test item: the sums
    of :func:`device_metric_sums`, computed on the tensors' device (only
    len(metrics) + 1 scalars reach the host), over the count of users.

    Args:
      top_k_items: (U, >=max_k) ranked ids (train items masked).
      truth / truth_len: :func:`pad_truth` outputs as tensors.
    """
    sums = device_metric_sums(metrics, top_k_items, truth, truth_len)
    denom = max(sums[-1], np.float32(1.0))
    return {m: float(v / denom) for m, v in zip(metrics, sums[:-1])}


def device_metric_sums(
    metrics: Sequence[str],
    top_k_items: torch.Tensor,
    truth: torch.Tensor,
    truth_len: torch.Tensor,
    mesh=None,
) -> np.ndarray:
    """Per-metric sums over the users with at least one test item, and the
    count of those users last: the form of :func:`evaluate_metrics_device`
    that adds up across ranks. With a ``mesh`` (the rank's users' rows in,
    ``parallel.mesh.Mesh``) the sums are summed over its data group, so
    every rank holds the global sums; the averages are ``sums[:-1] /
    sums[-1]``."""
    parsed = [parse_metric(m) for m in metrics]
    max_k = max(k for _, k in parsed)
    if top_k_items.shape[1] < max_k:
        raise ValueError(
            f"top_k_items has {top_k_items.shape[1]} ranks < max k {max_k}"
        )
    top = top_k_items[:, :max_k].to(truth.dtype)
    hits = (top[:, :, None] == truth[:, None, :]).any(2).float()
    num_true = truth_len.float()
    valid = num_true > 0
    sums = torch.stack(
        [torch.where(valid, _device_metric_values(n, k, hits, num_true),
                     0.0).sum() for n, k in parsed]
        + [valid.float().sum()])
    if mesh is not None:
        mesh.all_reduce(sums, "data")
    return sums.cpu().numpy()


def evaluate_sim_matrix(
    metrics: Sequence[str],
    sim_matrix: np.ndarray,
    train_items: Sequence[Sequence[int]],
    true_items: Sequence[Sequence[int]],
) -> dict[str, float]:
    """Reference-compatible path (metrics.py:5-36): mask train items to
    -inf in a dense sim matrix, top-k on host, then score. Used as the
    oracle in tests against the tiled on-device evaluator."""
    sim = np.array(sim_matrix, np.float32, copy=True)
    for u, items in enumerate(train_items):
        if len(items):
            sim[u, np.asarray(items)] = -np.inf
    parsed = [parse_metric(m) for m in metrics]
    max_k = max(k for _, k in parsed)
    idx = np.argpartition(-sim, max_k)[:, :max_k]
    part = np.take_along_axis(sim, idx, axis=1)
    order = np.argsort(-part, axis=1)
    top_k_items = np.take_along_axis(idx, order, axis=1)
    return evaluate_metrics(metrics, top_k_items, true_items)
