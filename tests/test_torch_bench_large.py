"""``heat_tpu_torch.bench_large`` against the JAX package's ``bench_large.py``
at a tiny size on the CPU: the same dataset from the same seed, a JSON
line with every key of the JAX script's, the sort-dedup path reported
(and taken) when both tables are above the threshold (lowered here), and
the flags of unported features refused.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import heat_tpu_torch.train.scatter as tsc
from heat_tpu_torch import bench_large
from heat_tpu_torch.ops.cuda import scatter as kscatter

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--users", "300", "--items", "200", "--clicks",
        "1500", "--batch", "256", "--negs", "4", "--dim", "16", "--reps", "1"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_large", ROOT / "bench_large.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_result_keys() -> set:
    """The keys of the ``result`` dict literal in the JAX script's main."""
    tree = ast.parse((ROOT / "bench_large.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in bench_large.py")


def test_make_dataset_matches_the_jax_script():
    want = _jax_script().make_dataset(500, 300, 2000, 7, seed=3)
    got = bench_large.make_dataset(500, 300, 2000, 7, seed=3)
    for f in ("pairs", "his_items", "masks"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == np.int32
    assert (got.num_users, got.num_items, got.max_his) == (500, 300, 7)


@pytest.mark.parametrize("mode", ["dedup", "direct"])
def test_tiny_cpu_run_prints_the_jax_keys(monkeypatch, capsys, mode):
    monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 100)
    before = dict(kscatter.LAUNCHES)
    bench_large.main(TINY + ["--update-mode", mode])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    record = json.loads(line)
    assert _jax_result_keys() <= set(record)
    assert record["sorted_dedup_path"] == (mode == "dedup")
    assert record["update_mode"] == mode
    assert len(record["losses"]) == 2 and np.isfinite(record["losses"]).all()
    assert record["steps"] == 2 * -(-1500 // 256)
    assert record["device"] == "cpu"
    # Device numbers are not made up on the CPU.
    assert record["hbm_gbps"] is record["peak_device_bytes"] is None
    assert record["state_bytes"] == (300 + 200 + 16) * 16 * 4
    assert len(record["reduced"]) == 4
    assert kscatter.LAUNCHES == before  # plain versions on the CPU


def test_profile_on_the_cpu(monkeypatch):
    """--profile runs its steps after the timed epochs: wall times on the
    CPU, and no device number made up there."""
    monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 100)
    record = bench_large.run(TINY + ["--profile", "2"])
    prof = record["profile"]
    assert record["steps"] == 2 * -(-1500 // 256)  # the epochs' steps only
    assert prof["steps"] == 2
    assert prof["wall_ms_per_step"] > 0 and prof["profiled_wall_ms_per_step"] > 0
    assert prof["device_ms_per_step"] is prof["idle_share"] is None
    assert prof["device_ms_per_step_by_kernel"] == {}
    assert prof["shuffle_peak_device_bytes"] is prof["step_peak_device_bytes"] is None
    with pytest.raises(ValueError, match="at least 8"):
        bench_large.run(TINY + ["--profile", "4"])


@pytest.mark.parametrize("flags,item", [
    (["--tile", "128"], "item 10"), (["--refresh", "4096"], "item 10"),
    (["--aggregator", "user_attention"], "item 12"),
    (["--emb-pad", "128"], "do-not-port"),
])
def test_unported_flags_are_refused(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        bench_large.run(TINY + flags)
