"""The run's lifecycle in the port against the JAX package: the metrics log
(``utils/logging.py``), the phase timer, its breakdown and the trace
(``utils/profiling.py``), and the CLI's ``--log-file``, ``--breakdown``,
``--profile-dir`` and ``--fused-run`` with ``--profile-dir``."""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from heat_tpu_torch import main as tmain
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.models.state import init_train_state
from heat_tpu_torch.train.samplers import init_sampler_state
from heat_tpu_torch.train.train_step import Batch, train_step
from heat_tpu_torch.utils import logging as tlogging
from heat_tpu_torch.utils import profiling as tprofiling

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
TINY = ["--config", CONFIG0, "--synthetic", "200,400", "--epochs", "3"]
# The names the JAX step gives its jax.named_scope's.
STEP_PHASES = ("data", "read_emb", "read_his", "aggr_f", "his_mm", "dot",
               "loss", "grad", "aggr_b", "write_emb")


def test_copied_logging_and_profiling_match_the_originals(tmp_path):
    from heat_tpu.utils import logging as jlogging
    from heat_tpu.utils import profiling as jprofiling

    assert tprofiling.REFERENCE_PHASES == jprofiling.REFERENCE_PHASES
    assert set(STEP_PHASES) <= set(tprofiling.REFERENCE_PHASES)
    assert tlogging._FORMAT == jlogging._FORMAT
    records = []
    for mod in (jlogging, tlogging):
        path = tmp_path / f"{mod.__name__}.jsonl"
        log = mod.MetricsLogger(str(path))
        log.log("epoch", epoch=0, loss=1.5, lr=0.01, epoch_time_s=2.0)
        log.log("final_eval", epoch=1, **{"Recall(k=20)": 0.25})
        log.close()
        log.close()  # idempotent
        mod.MetricsLogger(None).log("ignored", x=1)  # no file, no error
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        for line in lines:
            assert isinstance(line.pop("ts"), float)
        records.append(lines)
    assert records[0] == records[1]
    for mod, name in ((jlogging, "heat_tpu"), (tlogging, "heat_tpu_torch")):
        logger = mod.get_logger(name + ".lifecycle_test")
        assert logger.level == logging.INFO and len(logger.handlers) == 1
        assert logger.handlers[0].formatter._fmt == mod._FORMAT
        assert mod.get_logger(name + ".lifecycle_test") is logger
    assert tlogging.get_logger().name == "heat_tpu_torch"

    timers = (jprofiling.PhaseTimer(), tprofiling.PhaseTimer())
    for timer in timers:
        with timer.phase("f_b"):
            pass
        assert set(timer.time_map) == {"f_b"} and timer.time_map["f_b"] >= 0
        timer.reset()
        assert not timer.time_map
        assert tprofiling.performance_breakdown(timer) == "no phases recorded"
        timer.time_map.update({"data": 0.25, "f_b": 1.5, "eval": 0.5})
    assert (tprofiling.performance_breakdown(timers[1])
            == jprofiling.performance_breakdown(timers[0]))


def test_a_dataset_warning_reaches_the_ports_formatted_handler(monkeypatch):
    """The copy of ``data/datasets.py`` warns about a non-contiguous user id
    space through ``utils.logging.get_logger()``, as the original warns
    through the JAX package's: the formatted stderr handler is attached
    and prints the warning."""
    import io
    import sys

    from heat_tpu_torch.data.datasets import ClickDataset

    logger = logging.getLogger("heat_tpu_torch")
    monkeypatch.setattr(logger, "handlers", [])
    monkeypatch.setattr(logger, "level", logging.NOTSET)
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    ClickDataset.from_user_items([[1, 2], [], [0]], max_his=2)
    (handler,) = logger.handlers
    assert handler.formatter._fmt == tlogging._FORMAT
    assert (" heat_tpu_torch WARNING user id space is not contiguous: 1 of 3 "
            "ids have no interactions") in err.getvalue()


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("fused_run", [False, True], ids=["chunks", "fused_run"])
def test_log_file_events_match_the_jax_cli(tmp_path, monkeypatch, capsys, fused_run):
    """The same events, in the same order, with the same keys and epochs,
    as the JAX CLI's log of the same run."""
    from heat_tpu import main as jmain

    monkeypatch.setenv("HEAT_TPU_NO_COMPILATION_CACHE", "1")
    extra = ["--fused-run"] if fused_run else []
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jmain.main(TINY + extra + ["--log-file", str(jlog)])
    tmain.main(TINY + extra + ["--device", "cpu", "--log-file", str(tlog)])
    capsys.readouterr()
    want, got = _events(jlog), _events(tlog)
    assert [(e["event"], e["epoch"], list(e)) for e in got] == [
        (e["event"], e["epoch"], list(e)) for e in want]
    assert [e["event"] for e in got] == ["epoch"] * 3 + ["eval", "final_eval"]
    for e in got:
        assert all(np.isfinite(v) for k, v in e.items() if k != "event")


def test_breakdown_prints_the_engine_phases(capsys):
    record = tmain.main(TINY + ["--device", "cpu", "--breakdown"])
    lines = capsys.readouterr().out.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith("total: "))
    phases = {ln.split(":")[0].strip() for ln in lines[at + 1:-1]}
    assert phases == {"data", "f_b", "eval"}
    assert json.loads(lines[-1])["final_metrics"] == record["final_metrics"]


def test_engine_phases_add_up_to_the_epochs_and_evaluations():
    from heat_tpu_torch.train.engine import Engine

    train, test = tsynthetic(120, 200, max_his=6, seed=3)
    engine = Engine(CFConfig(emb_dim=8, max_his=6, batch_size=64,
                             num_subepochs=2), train, test, device="cpu")
    engine.train_epochs(2)
    engine.evaluate()
    tm = engine.timer.time_map
    assert set(tm) == {"data", "f_b", "eval"} and min(tm.values()) > 0
    assert engine.performance_breakdown().startswith("total: ")


def _step_names(cfg) -> set:
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, gen, "cpu")
    sampler = init_sampler_state(cfg, "cpu", gen)
    his = torch.randint(0, cfg.num_items, (cfg.num_users, cfg.max_his),
                        generator=gen, dtype=torch.int32)
    masks = torch.full((cfg.num_users,), cfg.max_his, dtype=torch.int32)
    batch = Batch(torch.arange(8, dtype=torch.int32),
                  torch.arange(8, dtype=torch.int32) + 1,
                  torch.ones(8, dtype=torch.float32))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_step(state, sampler, gen, batch, his, masks, cfg)
    return {e.name for e in prof.events()}


def test_an_eager_step_carries_the_reference_phase_names():
    """The counterpart of the JAX package's named-scope test
    (``tests/test_ops.py`` ``test_train_step_named_scopes_present``): a
    profiler trace of one eager step on the CPU holds every phase name the
    JAX step labels."""
    cfg = CFConfig(emb_dim=16, num_users=32, num_items=64, max_his=4,
                   num_negs=3, batch_size=8)
    names = _step_names(cfg)
    missing = [p for p in STEP_PHASES if p not in names]
    assert not missing, missing


def test_profile_dir_writes_a_trace_of_the_second_epoch(tmp_path, capsys):
    out = tmp_path / "trace"
    tmain.main(TINY + ["--device", "cpu", "--profile-dir", str(out)])
    capsys.readouterr()
    traces = glob.glob(os.path.join(out, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # One epoch of eager steps: each step's phases, and the kernels' plain
    # versions under them.
    for phase in STEP_PHASES:
        assert phase in names, phase
    assert sum(1 for e in events if e.get("name") == "write_emb") >= 1


def test_fused_run_with_profile_dir_is_refused(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        tmain.main(TINY + ["--device", "cpu", "--fused-run", "--profile-dir",
                           str(tmp_path / "t")])
    assert err.value.code == 2
    assert "--fused-run is incompatible with --profile-dir" in (
        capsys.readouterr().err)
    assert not (tmp_path / "t").exists()


def test_trace_context_yields_the_profiler(tmp_path):
    with tprofiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(4).sum()
    assert isinstance(prof, torch.profiler.profile)
    assert glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    assert any(e.key == "aten::sum" for e in prof.key_averages())
