"""The full-scale Recall@20 gate against the JAX package.

The JAX package's half (``scripts/torch_parity_gate.py``, on the CPU)
trains AmazonBooks config0 and the configurations ``chip_smoke.py`` trains
(``BANDS``) on the synthetic 52,643 x 91,599 planted-cluster data and
records the final metrics, with a SHA-256 of the data's train and test
pairs, in ``PARITY_TORCH.json`` at the root of the repository; and config0
again at two other engine seeds, whose spread it records beside the bands
(:func:`seed_spread`). The card's half (``chip_smoke.py``) generates the
same data with ``heat_tpu_torch.data.synthetic`` (a verbatim copy of the
JAX package's generator), checks its checksum against the file, and holds
its own final metrics to the recorded ones with :func:`gate`. The run on
a (4, 1) mesh (``config0_mesh41``, on 52,644 users: the JAX engine needs
the data axis to divide them) records its own geometry and checksums
(:func:`check_run_data`). This module reads the file; it needs no JAX.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

PARITY_FILE = Path(__file__).resolve().parent.parent / "PARITY_TORCH.json"
# The gated metrics and the bands: the paper's ±0.0003 on the f32 runs,
# and on the bf16 runs the band the headline is held to against config0
# (bf16 tables round every update, and the streams of negatives differ
# between the packages, so a band, not a trajectory).
GATED_METRICS = ("Recall(k=20)", "NDCG(k=50)")
CONFIG0_BAND = 0.0003
HEADLINE_BAND = 0.0015
# Complement scope collapses at full scale in both packages (Recall@20
# about 0.001), so HEADLINE_BAND would pass an untrained engine: the
# collapsed run is held to less than half of its JAX metrics instead.
COLLAPSED_BAND = 0.0005
# Every gated run (``scripts/torch_parity_gate.py`` RUNS) and its band,
# set before the runs were first compared on the card (COLLAPSED_BAND
# after, in place of HEADLINE_BAND: tighter, never wider).
BANDS = {
    "config0": CONFIG0_BAND,
    "headline": HEADLINE_BAND,
    "default_shape": HEADLINE_BAND,
    "config0_self_attention": CONFIG0_BAND,
    "accl_user_s": HEADLINE_BAND,
    "accl_self_s": HEADLINE_BAND,
    "headline_ccl": HEADLINE_BAND,
    "complement": COLLAPSED_BAND,
    "config0_mesh41": CONFIG0_BAND,
}


def pairs_sha256(pairs) -> str:
    """SHA-256 of an (N, 2) pair array as int32, row-major: the checksum
    both halves of the gate record for the train and the test pairs."""
    arr = np.ascontiguousarray(np.asarray(pairs), dtype="<i4")
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"pairs must be (N, 2), got {arr.shape}")
    return hashlib.sha256(arr.tobytes()).hexdigest()


def data_fingerprint(train, test) -> dict:
    """Pair counts and checksums of a (train, test) pair of ClickDatasets,
    in the file's keys."""
    return {
        "train_pairs": int(train.pairs.shape[0]),
        "test_pairs": int(test.pairs.shape[0]),
        "sha256": {"train": pairs_sha256(train.pairs),
                   "test": pairs_sha256(test.pairs)},
    }


def load_parity(path=None) -> dict:
    """The gate's record (``PARITY_TORCH.json`` by default)."""
    with open(path or PARITY_FILE) as f:
        return json.load(f)


def check_data(record: dict, train, test) -> dict:
    """Raise AssertionError unless the data's pair counts and checksums
    equal the record's; returns the fingerprint."""
    got = data_fingerprint(train, test)
    want = {k: record[k] for k in got}
    if got != want:
        raise AssertionError(
            f"the data differs from the gate's record: {got} against {want}")
    return got


def check_run_data(record: dict, run: str, train, test) -> dict:
    """:func:`check_data` against the data of one run: a run on a mesh
    (``config0_mesh41``) records its own geometry and checksums beside
    its metrics; the other runs share the record's."""
    entry = record["runs"][run]
    return check_data(entry if "sha256" in entry else record, train, test)


def seed_spread(record: dict) -> dict:
    """The JAX package's spread over engine seeds: config0 (at the config's
    seed) and the runs of the record that repeat it at another
    ``engine_seed``, and per gated metric the least and most value and the
    range between them."""
    run = "config0"
    names = [run] + sorted(n for n, r in record["runs"].items()
                           if r.get("repeats") == run)
    out = {"run": run, "runs": names,
           "engine_seeds": [record["runs"][n].get("engine_seed",
                                                  record["synthetic"]["seed"])
                            for n in names]}
    for m in GATED_METRICS:
        vals = [record["runs"][n]["final_metrics"][m] for n in names]
        out[m] = {"min": min(vals), "max": max(vals),
                  "range": max(vals) - min(vals)}
    return out


def gate(record: dict, run: str, metrics: dict, band: float) -> dict:
    """The gaps of ``metrics`` (a run's final metrics) to the JAX run
    ``run`` of the record in every gated metric; raise AssertionError when
    one is more than ``band`` away."""
    want = record["runs"][run]["final_metrics"]
    gaps = {m: metrics[m] - want[m] for m in GATED_METRICS}
    out = {"run": run, "band": band,
           "jax": {m: want[m] for m in GATED_METRICS},
           "port": {m: metrics[m] for m in GATED_METRICS}, "gap": gaps}
    bad = {m: g for m, g in gaps.items() if not abs(g) <= band}
    if bad:
        raise AssertionError(
            f"{run}: final metrics beyond {band} of the JAX package's: {out}")
    return out
