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
    assert set(record["runs"]) == set(gate.RUNS) | set(gate.SEED_RUNS)
    assert set(gate.RUNS) == set(parity.BANDS) == set(smoke.GATED_RUNS)
    for name, overrides in gate.RUNS.items():
        assert record["runs"][name]["overrides"] == overrides, name
        assert smoke.GATED_RUNS[name] == overrides, name
        assert record["runs"][name]["band"] == parity.BANDS[name], name
    assert record["runs"]["headline"]["overrides"] == smoke.HEADLINE
    assert record["runs"]["config0"]["overrides"] == []
    for name, (run, seed) in gate.SEED_RUNS.items():
        assert record["runs"][name]["repeats"] == run
        assert record["runs"][name]["engine_seed"] == seed
        assert record["runs"][name]["overrides"] == gate.RUNS[run]
        assert "band" not in record["runs"][name]
    for run in record["runs"].values():
        assert run["seconds"] > 0
        for metrics in [run["final_metrics"]] + (
                [run["torch_cpu"]["final_metrics"]] if "torch_cpu" in run else []):
            for m in parity.GATED_METRICS:
                assert 0.0 < metrics[m] < 1.0


def _bench_rows() -> dict:
    """The JAX bench.py's ``time_epochs`` rows as written there: the row's
    name and its settings (``his_refresh``, the first argument, and the
    config keywords; ``reps`` and ``fused`` time, they set nothing)."""
    import ast

    rows = {}
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "time_epochs"
                and isinstance(node.targets[0], ast.Tuple)):
            continue
        call = node.value
        sets = {"his_refresh": ast.literal_eval(call.args[0])}
        sets.update({kw.arg: ast.literal_eval(kw.value) for kw in call.keywords
                     if kw.arg not in ("reps", "fused")})
        rows[node.targets[0].elts[0].id] = sets
    return rows


# The record's runs that are rows of the JAX bench.py, by the row's name.
BENCH_ROWS = {"default_shape": "subep_tile_s", "accl_user_s": "accl_user_s",
              "accl_self_s": "accl_self_s", "headline_ccl": "ccl_s"}


@pytest.mark.parametrize("run", sorted(BENCH_ROWS))
def test_the_runs_overrides_are_bench_rows(record, run):
    """Each run that stands for a row of the JAX bench.py sets on config0
    exactly what the row sets (bench.py's other settings, its geometry,
    learning rate, clip and milestones, are config0's own or the bench's
    synthetic data's, which the gate's data replaces)."""
    import yaml

    got = {k: yaml.safe_load(v) for k, _, v in
           (kv.partition("=") for kv in record["runs"][run]["overrides"])}
    assert got == _bench_rows()[BENCH_ROWS[run]]


def test_the_bands_were_set_before_the_card(record):
    """The paper's 0.0003 on every f32 run (config0 on a (4, 1) mesh too),
    0.0015 on every bf16 run, as written before the runs were first
    compared on the card; the collapsed
    complement run later tightened to 0.0005, less than half of each of
    its JAX metrics, so that a run that kept half of them (an untrained
    engine keeps a fifth) fails the gate."""
    assert parity.CONFIG0_BAND == 0.0003 and parity.HEADLINE_BAND == 0.0015
    assert parity.COLLAPSED_BAND == 0.0005
    for name, band in parity.BANDS.items():
        bf16 = "param_dtype=bfloat16" in record["runs"][name]["overrides"]
        if name == "complement":
            assert bf16 and band == parity.COLLAPSED_BAND < parity.HEADLINE_BAND
            continue
        assert band == (parity.HEADLINE_BAND if bf16 else parity.CONFIG0_BAND), name
    assert sorted(n for n, b in parity.BANDS.items() if b == parity.CONFIG0_BAND) == [
        "config0", "config0_mesh41", "config0_self_attention"]
    want = record["runs"]["complement"]["final_metrics"]
    assert all(parity.COLLAPSED_BAND < 0.5 * want[m] for m in parity.GATED_METRICS)
    with pytest.raises(AssertionError, match="beyond"):
        parity.gate(record, "complement", {m: 0.5 * v for m, v in want.items()},
                    parity.BANDS["complement"])


def test_the_mesh_run_records_its_own_data(record):
    """config0 on a (4, 1) mesh of JAX processes, on one user more than the
    other runs (the JAX engine needs the data axis to divide the users):
    the run carries its geometry and checksums, and ``check_run_data``
    reads them there, the record's elsewhere."""
    gate = _module("scripts/torch_parity_gate.py", "torch_parity_gate")
    run = record["runs"]["config0_mesh41"]
    (n_data, n_model), (users, items) = gate.MESH_RUNS["config0_mesh41"]
    assert run["mesh"] == [n_data, n_model] == [4, 1]
    assert run["synthetic"] == dict(record["synthetic"], num_users=users,
                                    num_items=items) and users % n_data == 0
    assert run["sha256"] != record["sha256"] and run["train_pairs"] > 0

    class Data:
        def __init__(self, pairs):
            self.pairs = pairs

    pairs = np.zeros((3, 2), np.int32)
    fake = {"runs": {"a": {**parity.data_fingerprint(Data(pairs), Data(pairs))},
                     "b": {}},
            **parity.data_fingerprint(Data(pairs[:2]), Data(pairs[:2]))}
    assert parity.check_run_data(fake, "a", Data(pairs), Data(pairs))
    assert parity.check_run_data(fake, "b", Data(pairs[:2]), Data(pairs[:2]))
    with pytest.raises(AssertionError, match="differs"):
        parity.check_run_data(fake, "a", Data(pairs[:2]), Data(pairs[:2]))


def test_the_seed_spread_entry(record):
    """config0 at the config's seed and two other engine seeds, on the same
    data: the record's spread is what ``parity.seed_spread`` reads from its
    runs."""
    spread = record["seed_spread"]
    assert spread == parity.seed_spread(record)
    assert spread["run"] == "config0"
    assert spread["runs"] == ["config0", "config0_seed2023", "config0_seed2024"]
    assert spread["engine_seeds"] == [2022, 2023, 2024]
    for m in parity.GATED_METRICS:
        vals = [record["runs"][n]["final_metrics"][m] for n in spread["runs"]]
        assert spread[m] == {"min": min(vals), "max": max(vals),
                             "range": max(vals) - min(vals)}
        assert spread[m]["range"] >= 0.0


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


@pytest.mark.parametrize("run,band", sorted(parity.BANDS.items()))
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
