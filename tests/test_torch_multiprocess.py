"""The port's multi-process entry points on the CPU (ROADMAP item 15a):
the CLI under ``torch.distributed.run``, its refusals, the multihost demo,
and the JAX CLI's handling of synthetic data across processes, which the
port does not reproduce.

Every subprocess has its own timeout (at most 300 s) and a free port
(``--standalone`` picks one for the launcher).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from heat_tpu_torch.config import load_config
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.train.engine import Engine

import torch_mesh_support as mc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG0 = os.path.join(ROOT, "benchmarks", "AmazonBooks", "config0.yaml")
SYN = (200, 400)
# config0 at a small size: one step an epoch (every pair in one batch).
SETS = ["embedding_dim=16", "num_negs=4", "max_his=8"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    return env


def _argv(*extra):
    argv = ["--config", CONFIG0, "--synthetic", ",".join(map(str, SYN)),
            "--epochs", "3", "--device", "cpu"]
    for kv in SETS:
        argv += ["--set", kv]
    return argv + list(extra)


def _events(path, event):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == event]


def test_cli_on_a_mesh_equals_one_rank(tmp_path):
    """The CLI in two ranks (gloo on the CPU): each rank keeps its user
    range of the synthetic data, the engine's mesh is (2, 1), rank 0
    prints and logs. Its losses equal a single rank's that steps the same
    global batches (``Engine._shard_stream(2)``) to rtol 1e-5 (one step an
    epoch), its metrics within 1e-6; the export holds the global tables
    (within atol 1e-4 of the single rank's after three steps). Rank 0's
    trace of its second epoch shows that step's all-reduce over the data
    group, the span the chip's phase (a) reads its collective time from."""
    log, emb = tmp_path / "log.jsonl", tmp_path / "emb.npz"
    prof = tmp_path / "trace"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "heat_tpu_torch.main",
         *_argv("--log-file", str(log), "--export-embeddings", str(emb),
                "--kernel-launches", "--profile-dir", str(prof))],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch.distributed backend: gloo (2 ranks" in proc.stdout
    assert proc.stdout.count('{"final_metrics"') == 1  # rank 0 prints
    report = json.loads([ln for ln in proc.stdout.splitlines()
                         if ln.startswith('{"kernel_launches"')][0])
    # One step an epoch, and the evaluations after epoch 2 and at the end;
    # on the CPU the wrappers launch no kernel. Each step all-reduces once
    # over the data group.
    assert (report["steps"], report["evaluations"]) == (3, 2)
    assert not any(report["kernel_launches"].values())
    (path,) = prof.glob("*.pt.trace.json")
    coll = mc.trace_summary(path)
    assert coll["collective_calls"] >= 1 and coll["collective_s"] > 0, coll
    got = [r["loss"] for r in _events(log, "epoch")]
    final = _events(log, "final_eval")[0]

    cfg, _ = load_config(CONFIG0, embedding_dim=16, num_negs=4, max_his=8)
    cfg.epochs = 3
    train, test = synthetic_click_dataset(*SYN, max_his=cfg.max_his,
                                          seed=cfg.seed)
    oracle = Engine(cfg, train, test, device="cpu")
    oracle._shard_stream(2)
    want = [oracle.train_one_epoch() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    metrics = oracle.evaluate()
    for m, v in metrics.items():
        assert abs(final[m] - v) <= 1e-6, (m, final[m], v)
    z = np.load(emb)
    assert z["user_emb"].shape == (SYN[0], 16)
    assert z["item_emb"].shape == (SYN[1], 16)
    # Three steps compound the summation-order noise: atol 1e-4, where a
    # wrong update moves a row by up to lr * clip_val = 1e-2.
    np.testing.assert_allclose(z["item_emb"], oracle.state.item_emb.numpy(),
                               rtol=1e-2, atol=1e-4)


def test_cli_on_a_mesh_refuses_fused_runs():
    for flags in (["--fused-run"], ["--fused-epochs", "2"]):
        with pytest.raises(RuntimeError, match="item 15b"):
            mc.spawn_ranks(mc.rank_cli, 2, _argv(*flags), timeout=120)


def test_multihost_demo():
    """``heat_tpu_torch.multihost_demo --procs 2``: eight ranks on a (4, 2)
    mesh train the demo's 64 x 126 data, and every rank reports the same
    losses and Recall@20."""
    proc = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch.multihost_demo", "--procs",
         "2", "--device", "cpu", "--timeout", "240"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    reports = [ln.split(":", 1)[1] for ln in proc.stdout.splitlines()
               if ln.startswith("rank ")]
    assert len(reports) == 8 and len(set(reports)) == 1


_JAX_WORKER = """
import os, sys
rank, port = int(sys.argv[1]), int(sys.argv[2])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["HEAT_TPU_NO_COMPILATION_CACHE"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank)
import traceback
from heat_tpu import main
try:
    main.main(["--config", sys.argv[3], "--synthetic", "64,126", "--epochs",
               "1", "--set", "batch_size=32", "--set", "max_his=6", "--set",
               "embedding_dim=8", "--set", "num_negs=4"])
except Exception:
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(3)  # jax.distributed's exit would wait for the other process
sys.stdout.flush()
os._exit(0)
"""


def test_jax_cli_fails_on_synthetic_data_across_processes():
    """A reference fault not reproduced. The JAX CLI shards only file data
    (``heat_tpu/main.py`` l.150-186): with ``--synthetic`` under two
    ``jax.distributed`` processes every process hands the whole data to
    its engine, which trains on every pair and then fails at its first
    evaluation (``pack_train_bits`` meets users outside the process's
    range). The port's CLI shards synthetic data like file data
    (``test_cli_on_a_mesh_equals_one_rank``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = _env()
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_WORKER, str(rank), str(port), CONFIG0],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    try:
        out, _ = procs[0].communicate(timeout=200)
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert procs[0].returncode != 0
    assert "epoch: 0; loss:" in out, out  # it trained on every pair
    assert "IndexError" in out and "pack_train_bits" in out, out
