"""Sub-epochs on a ("data", "model") mesh of ranks (ROADMAP item 15b,
point 2): the reference's default run shape (the JAX ``bench.py``
headline with two sub-epochs, ``cf_config.py:7``) in global and
complement scope, held against the single-rank port; checkpoints that move
between meshes mid-run under sub-epochs and the "once" stream; the CLI in
the default shape; the multihost demo's ``subepoch`` and ``visit``
variants.

Each multi-rank case runs its ranks as processes of a gloo job on the CPU
(``torch_mesh_support.spawn_ranks``, a free localhost port, a timeout).
The single-rank oracle lays its stream out as the mesh does
(``Engine._shard_stream(n_data)``), sub-epochs included: every shard's
part of every bucket, its shuffle, and the global batch's draws, so that
it steps the mesh's global batches with the mesh's draws. Tolerances are
those of ``tests/test_torch_mesh_fastpath.py``: f32 runs of ``direct``
mode the loss rtol 5e-4 after one epoch and 2e-2 after two
(``tests/test_sharding.py:246``), bf16 trajectories rtol 2e-2. The
generators (the torch one, and the numpy one of the permutations) are
held equal on every rank and to the oracle's after two epochs, and
replicas bit-equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from heat_tpu_torch.data.datasets import user_range_bounds

import torch_mesh_support as mc
from test_torch_mesh_fastpath import (
    BASE,
    DATA,
    F32,
    HEADLINE,
    HEADLINE_SETS,
    TIMEOUT,
    _same_draws,
    cli_equals_one_rank,
)

DEFAULT_SHAPE = dict(HEADLINE, num_subepochs=2)
COMPLEMENT = dict(DEFAULT_SHAPE, subepoch_neg_scope="complement")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape,cfg", [
    ((2, 1), dict(DEFAULT_SHAPE, **F32)),
    ((2, 2), dict(COMPLEMENT, **F32)),
    ((2, 2), dict(DEFAULT_SHAPE, **F32)),
    ((2, 2), COMPLEMENT),
], ids=["2x1-global-f32", "2x2-complement-f32", "2x2-global-f32",
        "2x2-complement-bf16"])
def test_subepochs_equal_one_rank(shape, cfg):
    """Two epochs of two sub-epochs each against the single-rank oracle:
    the losses, each epoch's steps, the draws (both generators), the
    replicas; under complement scope every step's negatives lie outside
    its partition (``torch_mesh_support.ComplementProbe``)."""
    complement = cfg.get("subepoch_neg_scope") == "complement"
    ranks = mc.spawn_ranks(mc.rank_train, shape[0] * shape[1], shape, DATA,
                           cfg, 2, "cpu", probe_complement=complement,
                           timeout=TIMEOUT)
    oracle = mc.train_oracle(shape[0], DATA, cfg, 2, "cpu", n_model=shape[1])
    bf16 = cfg["param_dtype"] == "bfloat16"
    for r in ranks:
        for got, want, tol in zip(r["losses"], oracle["losses"],
                                  [2e-2, 2e-2] if bf16 else [5e-4, 2e-2]):
            np.testing.assert_allclose(got, want, rtol=tol)
        assert r["epoch_steps"] == ranks[0]["epoch_steps"]
        assert sum(r["epoch_steps"]) == r["steps"]
        if complement:
            assert r["complement_steps"] == r["steps"] > 0
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.02, (m, r["metrics"][m], v)
    mc.check_replicas([r["replicas"] for r in ranks])
    _same_draws(ranks, oracle)


def test_an_empty_local_bucket_steps_with_the_others():
    """The second data shard's users click two items only, so most of its
    buckets of four sub-epochs are empty while the first shard's are not:
    its rank steps every globally non-empty bucket with weight-0 rows and
    draws what the other draws. f32, (2, 1): equal to the oracle, the
    same steps on both ranks, the generators aligned."""
    data = dict(DATA, narrow_users=(DATA["num_users"] // 2, [5, 6]))
    cfg = dict(DEFAULT_SHAPE, num_subepochs=4, **F32)
    train, _ = mc.make_data(data)
    rng = np.random.default_rng(cfg["seed"] ^ 0x5EED)  # Engine._partition
    lo, _ = user_range_bounds(DATA["num_users"], 2, 1)
    empty = 0
    for _ in range(2):
        perm = rng.permutation(DATA["num_items"])
        bounds = np.linspace(0, DATA["num_items"], 5).astype(np.int64)
        part = np.empty(DATA["num_items"], np.int64)
        for s in range(4):
            part[perm[bounds[s]: bounds[s + 1]]] = s
        shard = [np.bincount(part[train.pairs[sel, 1]], minlength=4)
                 for sel in (train.pairs[:, 0] < lo, train.pairs[:, 0] >= lo)]
        empty += int(((shard[1] == 0) & (shard[0] > 0)).sum())
    assert empty >= 2
    ranks = mc.spawn_ranks(mc.rank_train, 2, (2, 1), data, cfg, 2, "cpu",
                           timeout=TIMEOUT)
    oracle = mc.train_oracle(2, data, cfg, 2, "cpu")
    assert ranks[0]["epoch_steps"] == ranks[1]["epoch_steps"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], oracle["losses"],
                                   rtol=5e-4)
    mc.check_replicas([r["replicas"] for r in ranks])
    _same_draws(ranks, oracle)


@pytest.mark.parametrize("cfg", [
    dict(DEFAULT_SHAPE, **F32),
    dict(BASE, shuffle_mode="once"),
], ids=["default_shape", "once"])
def test_checkpoints_move_between_meshes_mid_run(tmp_path, cfg):
    """A (2, 2) run saves after the first of two epochs. Restored on one
    rank (laid out as two data shards) it resumes the (2, 2) run's second
    epoch; restored on (4, 1) it equals a one-rank run laid out as four
    data shards restored from the same file. Under sub-epochs the file
    carries the permutations' generator, under "once" the generator state
    the stream was drawn from. f32, losses rtol 5e-4 (lr 0.005); a wrong
    restore is off by far more."""
    ck = str(tmp_path / "ck")
    run22 = mc.spawn_ranks(mc.rank_train, 4, (2, 2), DATA, cfg, 2, "cpu",
                           save_dir=ck, save_after=1, evaluate=False,
                           timeout=TIMEOUT)
    one = mc.train_oracle(2, DATA, cfg, 1, "cpu", restore_dir=ck,
                          evaluate=False, n_model=2)
    assert one["restored"] == 1
    np.testing.assert_allclose(one["losses"], run22[0]["losses"][1:], rtol=5e-4)
    _same_draws(run22, one)
    run41 = mc.spawn_ranks(mc.rank_train, 4, (4, 1), DATA, cfg, 1, "cpu",
                           restore_dir=ck, evaluate=False, timeout=TIMEOUT)
    one4 = mc.train_oracle(4, DATA, cfg, 1, "cpu", restore_dir=ck,
                           evaluate=False)
    for r in run41:
        assert r["restored"] == 1
        np.testing.assert_allclose(r["losses"], one4["losses"], rtol=5e-4)
    mc.check_replicas([r["replicas"] for r in run41])
    _same_draws(run41, one4)


def test_cli_on_a_mesh_runs_the_default_shape(tmp_path):
    cli_equals_one_rank(tmp_path, HEADLINE_SETS + ["num_subepochs=2"])


@pytest.mark.parametrize("variant", ["subepoch", "visit"])
def test_multihost_demo_variants(variant):
    """``heat_tpu_torch.multihost_demo --procs 1 --variant ...``: four ranks
    on a (2, 2) mesh; every rank reports the same line and the demo its
    checks passed (sub-epochs: learning, the generators and replicas
    aligned; visit: the user-sorted stream equals the presorted file
    order, with the dedup maps in use)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch.multihost_demo", "--procs",
         "1", "--variant", variant, "--device", "cpu", "--timeout", "200"],
        capture_output=True, text=True, timeout=260, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost demo ok" in proc.stdout
    reports = [ln.split(":", 1)[1] for ln in proc.stdout.splitlines()
               if ln.startswith("rank ")]
    assert len(reports) == 4 and len(set(reports)) == 1
    assert variant in reports[0]
