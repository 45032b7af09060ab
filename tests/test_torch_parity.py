"""The full-scale gate's record (``PARITY_TORCH.json``, written by
``scripts/torch_parity_gate.py`` with the JAX package on the CPU) and the
port's helpers that read it (``heat_tpu_torch.parity``): the record's
fields, the checksum of the data it was made on against the port's own
synthetic data, and the band checks ``chip_smoke.py`` applies."""

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from heat_tpu_torch import parity
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def record():
    return parity.load_parity()


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_record_has_every_field(record):
    assert parity.PARITY_FILE == ROOT / "PARITY_TORCH.json"
    assert record["made_by"].endswith("scripts/torch_parity_gate.py")
    assert record["platform"] == "cpu" and record["jax_version"]
    assert record["config"] == "benchmarks/AmazonBooks/config0.yaml"
    assert record["synthetic"] == {"num_users": 52643, "num_items": 91599,
                                   "max_his": 100, "seed": 2022}
    assert record["train_pairs"] > 0 and record["test_pairs"] > 0
    for split in ("train", "test"):
        assert len(record["sha256"][split]) == 64
    gate = _module("scripts/torch_parity_gate.py", "torch_parity_gate")
    smoke = _module("chip_smoke.py", "chip_smoke")
    assert set(record["runs"]) == set(gate.RUNS)
    assert record["runs"]["headline"]["overrides"] == smoke.HEADLINE
    assert record["runs"]["config0"]["overrides"] == []
    for run in record["runs"].values():
        assert run["seconds"] > 0
        for metrics in [run["final_metrics"]] + (
                [run["torch_cpu"]["final_metrics"]] if "torch_cpu" in run else []):
            for m in parity.GATED_METRICS:
                assert 0.0 < metrics[m] < 1.0


def test_the_record_was_made_on_the_ports_synthetic_data(record):
    """The card regenerates the data with the port's copy of the
    generator: its pair counts and checksums are the record's."""
    train, test = tsynthetic(**record["synthetic"])
    assert parity.check_data(record, train, test) == {
        k: record[k] for k in ("train_pairs", "test_pairs", "sha256")}


def test_pairs_checksum():
    pairs = np.asarray([[0, 1], [2, 3], [70000, 5]], np.int64)
    want = hashlib.sha256(
        np.asarray(pairs, np.int32).tobytes(order="C")).hexdigest()
    assert parity.pairs_sha256(pairs) == want
    assert parity.pairs_sha256(np.asfortranarray(pairs.astype(np.int32))) == want
    assert parity.pairs_sha256(pairs[::-1]) != want
    with pytest.raises(ValueError):
        parity.pairs_sha256(pairs[:, :1])


def test_check_data_refuses_other_data(record):
    train, test = tsynthetic(200, 400, max_his=8, seed=1)
    with pytest.raises(AssertionError, match="differs"):
        parity.check_data(record, train, test)


@pytest.mark.parametrize("run,band", [
    ("config0", parity.CONFIG0_BAND), ("headline", parity.HEADLINE_BAND)])
def test_gate_bands(record, run, band):
    want = record["runs"][run]["final_metrics"]
    near = {m: v + 0.9 * band for m, v in want.items()}
    out = parity.gate(record, run, near, band)
    assert out["gap"]["Recall(k=20)"] == pytest.approx(0.9 * band)
    for m in parity.GATED_METRICS:
        far = dict(near, **{m: want[m] - 1.1 * band})
        with pytest.raises(AssertionError, match="beyond"):
            parity.gate(record, run, far, band)


def test_importing_the_gate_and_the_card_script_leaves_the_environment(monkeypatch):
    """The gate sets its environment defaults only when run as a script: a
    test that imports it (above) must not disable the JAX package's
    compilation cache for the tests that follow it in the same process."""
    import os

    monkeypatch.delenv("HEAT_TPU_NO_COMPILATION_CACHE", raising=False)
    before = dict(os.environ)
    _module("scripts/torch_parity_gate.py", "torch_parity_gate")
    _module("chip_smoke.py", "chip_smoke")
    assert dict(os.environ) == before
