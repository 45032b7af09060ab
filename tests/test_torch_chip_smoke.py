"""``chip_smoke.py``'s failure line: on any exception ``main`` prints, as its
last line of standard output, which phase failed and why, and names a job
that failed beside the main phases; then it exits 1."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return module


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_failed_phase_is_named_with_its_error(smoke, monkeypatch, capsys):
    def run(walls):
        walls["build"] = 0.5
        walls["kernels"] = 9.25
        print("kernel gather_blocks: ...")
        raise AssertionError("S2 gather_blocks disagrees " + "x" * 1000)

    monkeypatch.setattr(smoke, "run", run)
    assert smoke.main() == 1
    failed = _last_line(capsys)["failed"]
    assert failed["phase"] == "kernels"
    assert failed["error"].startswith("AssertionError: S2 gather_blocks disagrees")
    assert len(failed["error"]) == smoke.ERROR_CHARS == 500
    assert failed["phase_start_s"] == {"build": 0.5, "kernels": 9.25}
    assert "beside" not in failed


def test_a_failure_before_the_first_phase_and_a_job_beside(smoke, monkeypatch, capsys):
    def broken_job():
        raise RuntimeError("rank 2 exited with code 1")

    def run(walls):
        job = smoke.start_beside(broken_job)
        job[0].join()
        smoke.start_beside(lambda: None)[0].join()
        raise ImportError("No module named 'heat_tpu_torch'")

    monkeypatch.setattr(smoke, "run", run)
    assert smoke.main() == 1
    failed = _last_line(capsys)["failed"]
    assert failed["phase"] == "setup" and failed["phase_start_s"] == {}
    assert failed["error"] == "ImportError: No module named 'heat_tpu_torch'"
    assert failed["beside"] == {"broken_job": "RuntimeError: rank 2 exited with code 1"}


def test_no_line_without_a_card(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "run", lambda walls: pytest.fail("ran without a card"))
    assert smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_fused_cli_spread_summarizes_with_the_checks_own_ratio(smoke, tmp_path):
    """``heat_tpu_torch.fused_cli_spread --summarize``: its ratio is (l)'s
    (``held_to_spread``), and a fused run far off the plain runs fails the
    rule against every set of them."""
    import numpy as np

    from heat_tpu_torch import fused_cli_spread as fcs

    rng = np.random.default_rng(0)
    plain = [(1.0 + 1e-4 * rng.normal(size=5)).tolist() for _ in range(5)]
    near, far = (1.0 + 1e-4 * rng.normal(size=5)).tolist(), [1.01] * 5
    # f64 arrays, as the job hands them over (a list would become f32).
    held = smoke.held_to_spread("near", np.asarray(near),
                                [np.asarray(p) for p in plain])
    assert fcs._ratio(near, plain) == pytest.approx(held["ratio"], rel=1e-12)
    rep = {"plain": plain, "ok": False, "fused": {
        "fused_epochs_2": {"numbers": near, "ok": True},
        "fused_run": {"numbers": far, "ok": False}}}
    path = tmp_path / "jobs.jsonl"
    path.write_text(json.dumps({"name": "a", "runs": [rep]}) + "\n")
    got = fcs.summarize(path)["a"]
    assert (got["reps"], got["passed"], got["fused_runs"]) == (1, 0, 2)
    assert got["ratio_max"] > 2 and 0.5 <= got["p_fused_run_over"] <= 1
