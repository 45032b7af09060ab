"""The attention aggregators on a ("data", "model") mesh of ranks (ROADMAP
item 15b, point 4), held against the single-rank port and the JAX
package: self- and user-attention pooled every step (whole history rows
summed over the model group, the pooling inside autograd, ``attn_q``'s
gradient summed over the data group only), with the history dedup, and
through cached user-attention pools; the JAX multihost demo's ``full``
combination (Adam, user-attention pools, the tile sampler); the pools'
refresh and ``evaluate(aggregate_users=True)`` on a mesh, export and
``Recommender.from_engine`` (aggregated and cold users), the CLI under
``torch.distributed.run`` and the demo's ``full`` and ``accl`` variants.

Each multi-rank case runs its ranks as processes of a gloo job on the CPU
(``torch_mesh_support.spawn_ranks``, a free localhost port, a timeout);
the runs of one mesh shape share one job (``rank_runs``). The single-rank
oracle steps the mesh's global batches with the mesh's draws
(``Engine._shard_stream(n_data)``). Tolerances: one step, the loss rtol
1e-5 (JAX's, ``tests/test_sharding.py:340-347``: the ranks add it in
another order) and the tables, ``w0``, ``attn_q`` and the slots bit for
bit (the oracle sums as the mesh does, on one thread as a rank runs);
two epochs at lr 0.002
the losses rtol 1e-4: at lr 0.005 a 1e-7 change of the initial item table
moves the second epoch's loss by 3e-4 (user-attention) and 3e-3
(self-attention) on one rank, at lr 0.002 by 3e-6 and 4e-6 (measured).
Replicas are held bit-equal (their SHA-256 over each group, ``attn_q``
and every slot included).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat_tpu_torch.config import CFConfig, load_config
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.models.aggregator import user_pools_impl
from heat_tpu_torch.models.state import state_from_numpy
from heat_tpu_torch.serving import Recommender
from heat_tpu_torch.train.engine import Engine

import torch_mesh_support as mc
from test_torch_mesh_slots import hold_to_jax, injected_against_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 300 items: 384 padded rows on one model shard, 512 on two.
DATA = dict(num_users=128, num_items=300, clicks_per_user=20, max_his=8, seed=9)
BASE = dict(emb_dim=16, num_negs=4, max_his=8, l_r=0.002, batch_size=128,
            milestones=[10], seed=3, metrics=["Recall(k=20)", "NDCG(k=50)"])
CONFIGS = {
    "self": dict(BASE, aggregator="self_attention"),
    "user": dict(BASE, aggregator="user_attention"),
    "user_pools": dict(BASE, aggregator="user_attention",
                       his_refresh="subepoch"),
    # The JAX multihost demo's "full" variant (scripts/multihost_demo.py:
    # 72-83) at this size: Adam, user-attention pools, the tile sampler.
    "full": dict(BASE, optimizer="adam", aggregator="user_attention",
                 neg_sampler=1, tile_size=32, refresh_interval=128,
                 his_refresh="subepoch"),
}
POOL_KINDS = ("self", "user")
SHAPES = [(2, 1), (1, 2), (2, 2)]
SERVE = [0, 7, 63, 64, 100, 127]  # users of every data shard
TIMEOUT = 180
ONE_STEP = 1 << 12  # every pair in one global batch


GROUPED = dict(shuffle_mode="none", visit_order="user")


def _runs(shape, export_dir):
    runs = {}
    for name, cfg in CONFIGS.items():
        runs[f"{name}_step"] = (dict(cfg, batch_size=ONE_STEP), 1, {
            "export_path": os.path.join(export_dir, f"{name}.npz"),
            "serve_users": SERVE, "serve_routes": True})
        runs[f"{name}_epochs"] = (cfg, 2, {})
    for name in POOL_KINDS:
        runs[f"{name}_pools"] = (CONFIGS[name], 0, {
            "pools": True, "aggregated_eval": True})
    if shape == (2, 2):
        for name in POOL_KINDS:
            for form in ("on", "off"):
                runs[f"{name}_dedup_{form}"] = (
                    dict(CONFIGS[name], **GROUPED), 2, {"dedup": form == "on"})
    return runs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """``jobs(shape)``: every run of :func:`_runs` on one mesh shape, in one
    job, started at the first call and kept for the module."""
    done = {}

    def get(shape):
        if shape not in done:
            runs = _runs(shape, str(tmp_path_factory.mktemp("export")))
            done[shape] = (shape, mc.spawn_ranks(
                mc.rank_runs, shape[0] * shape[1], shape, DATA, runs, "cpu",
                timeout=TIMEOUT), runs)
        return done[shape]

    return get


@pytest.fixture(params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def shape_runs(request, jobs):
    return jobs(request.param)


def _oracle(shape, runs, run, **kw):
    """The single-rank oracle of ``run``, on one thread as every rank
    :func:`mc.spawn_ranks` starts runs: a product split over threads adds
    its parts in another order
    (:func:`test_a_threaded_oracle_parts_from_the_mesh_in_w0`)."""
    cfg, epochs, _ = runs[run]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return mc.train_oracle(shape[0], DATA, cfg, epochs, "cpu",
                               n_model=shape[1], **kw)
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_step_equals_one_rank(shape_runs, name):
    """One global step of every pair: the loss (summed over the ranks in
    another order), and bit for bit the tables, ``w0``, ``attn_q`` (its
    gradient summed over "data" only: a sum over "model" too would scale
    it by n_model on (1, 2) and (2, 2)) and the slots against the oracle,
    which sums as the mesh does (``DataChunks``, ``PartialMeans``, one
    thread: :func:`test_a_threaded_oracle_parts_from_the_mesh_in_w0`);
    replicas bit-equal; every rank gathers the same state."""
    shape, ranks, runs = shape_runs
    oracle = _oracle(shape, runs, f"{name}_step")
    want = oracle["state"]
    for r in (r[f"{name}_step"] for r in ranks):
        got = r["state"]
        assert r["steps"] == 1
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=1e-5)
        for key in ("user_emb", "item_emb", "w0"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert ("attn_q" in got) == (name == "self")
        if name == "self":
            np.testing.assert_array_equal(got["attn_q"], want["attn_q"])
        for key, value in (want.get("opt_slots") or {}).items():
            np.testing.assert_array_equal(got["opt_slots"][key], value,
                                          err_msg=key)
        assert int(got["step"]) == int(want["step"]) == 1
        for key in got:
            if not isinstance(got[key], dict):
                np.testing.assert_array_equal(
                    got[key], ranks[0][f"{name}_step"]["state"][key])
    mc.check_replicas([r[f"{name}_step"]["replicas"] for r in ranks])


def test_a_threaded_oracle_parts_from_the_mesh_in_w0(jobs):
    """Why the one-step comparison holds bit for bit only against an
    oracle on one thread: on a (1, 2) mesh each rank takes ``w0``'s
    gradient over the whole 4,096-sample global batch on its one thread
    (``spawn_ranks``), and the product split over two threads adds its
    parts in another order. Adam turns that last-bit difference in
    ``w0``'s near-zero gradients into steps apart ("full"), while the
    tables, whose gradients are large, keep equal steps."""
    shape, ranks, runs = jobs((1, 2))
    got = ranks[0]["full_step"]["state"]
    one = _oracle(shape, runs, "full_step")["state"]
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg, epochs, _ = runs["full_step"]
        two = mc.train_oracle(shape[0], DATA, cfg, epochs, "cpu",
                              n_model=shape[1])["state"]
    finally:
        torch.set_num_threads(before)
    for key in ("user_emb", "item_emb", "w0"):
        np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    for key in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(got[key], two[key], err_msg=key)
    assert not np.array_equal(got["w0"], two["w0"])


def test_the_oracle_refreshes_the_pools_in_a_ranks_chunks(monkeypatch):
    """A data rank refreshes the user-attention pools of its own users,
    POOL_CHUNK_BYTES of history rows a chunk from its first user; on the
    card a chunk's batched products round by the chunk's size (the pools
    probe of ``spread_runner.py --check i``: at the
    (2, 2) "full" run's 52,644 users, 224 users' pools part by up to
    9.3e-10 when the refresh runs a shard at a time), and Adam carries
    that into ``w0``. So the oracle of an (n_data, .) mesh refreshes them
    a data shard at a time (``ShardPools``): ``pool_history`` sees each
    shard's chunks, not the whole table's. Here, 24 users a chunk over 2
    shards of 64 users; the pools bit-equal to the whole table's on the
    CPU."""
    from heat_tpu_torch.models import aggregator

    train, _ = synthetic_click_dataset(**DATA)
    cfg = CFConfig(**CONFIGS["full"])
    engine = Engine(cfg, train, device="cpu")
    monkeypatch.setattr(aggregator, "POOL_CHUNK_BYTES",
                        24 * BASE["max_his"] * BASE["emb_dim"] * 4)
    sizes, orig = [], aggregator.pool_history

    def counted(rows, *a, **kw):
        sizes.append(rows.shape[0])
        return orig(rows, *a, **kw)

    monkeypatch.setattr(aggregator, "pool_history", counted)
    whole = engine._pooled_history().clone()
    assert sizes == [24] * 5 + [8]
    sizes.clear()
    with mc.ShardPools(2) as shard_pools:
        pools = engine._pooled_history()
    assert shard_pools.calls == [(0, 64), (64, 128)]
    assert sizes == [24, 24, 16] * 2
    np.testing.assert_array_equal(pools.numpy(), whole.numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_epochs_equal_one_rank(shape_runs, name):
    """Two epochs of several steps and an evaluation at lr 0.002: losses
    rtol 1e-4, metrics within 0.02, the generators aligned, replicas
    bit-equal."""
    shape, ranks, runs = shape_runs
    oracle = _oracle(shape, runs, f"{name}_epochs")
    for r in (r[f"{name}_epochs"] for r in ranks):
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=1e-4)
        assert r["losses"][1] < r["losses"][0]
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.02, (m, r["metrics"][m], v)
        assert r["generators"] == oracle["generators"]
    mc.check_replicas([r[f"{name}_epochs"]["replicas"] for r in ranks])


@pytest.mark.parametrize("name", POOL_KINDS)
def test_pools_follow_the_aggregator_on_a_mesh(shape_runs, name):
    """The pools' refresh on a mesh (``Engine._pooled_history``) pools with
    the configured attention kind and the live query, as one rank pools
    the same users (the mesh once pooled the mean on every mesh branch);
    ``evaluate(aggregate_users=True)`` on the mesh equals the oracle's
    within 1e-6. The pools are whole rows summed over the model group
    (one nonzero term each), so they are bit-equal to one rank's."""
    shape, ranks, runs = shape_runs
    oracle = _oracle(shape, runs, f"{name}_pools", pools=True,
                     aggregated_eval=True)
    train, _ = synthetic_click_dataset(**DATA)
    mean = user_pools_impl(torch.as_tensor(oracle["state"]["item_emb"]),
                           torch.as_tensor(np.asarray(train.his_items)),
                           torch.as_tensor(np.asarray(train.masks))).numpy()
    for r in (r[f"{name}_pools"] for r in ranks):
        users = r["pool_users"]
        np.testing.assert_array_equal(r["pools"], oracle["pools"][users])
        # At the initial tables (std 1e-2) the attention weights are near
        # uniform, so the kinds part from the mean by ~1e-6, a thousand
        # ulps of the pools above.
        assert np.abs(r["pools"] - mean[users]).max() > 1e-7
        for m, v in oracle["metrics_aggregated"].items():
            assert abs(r["metrics_aggregated"][m] - v) <= 1e-6, m


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_and_from_engine_serve_as_one_rank(shape_runs, name):
    """A mesh export carries ``attn_q`` (self-attention); ``from_engine``
    on every rank serves plain, aggregated and cold users as one
    Recommender over the export's tables and all the train pairs and
    histories does."""
    shape, ranks, runs = shape_runs
    path = runs[f"{name}_step"][2]["export_path"]
    z = np.load(path)
    st = ranks[0][f"{name}_step"]["state"]
    assert ("attn_q" in z.files) == (name == "self")
    for key in ("user_emb", "item_emb", "w0") + (("attn_q",) if name == "self"
                                                 else ()):
        np.testing.assert_array_equal(z[key], st[key])
    train, _ = synthetic_click_dataset(**DATA)
    cfg = CFConfig(**CONFIGS[name])
    cfg.num_users, cfg.num_items = DATA["num_users"], DATA["num_items"]
    rec = Recommender(
        state_from_numpy(z["user_emb"], z["item_emb"], z["w0"], lr=0.0,
                         step=0, device="cpu",
                         attn_q=z["attn_q"] if "attn_q" in z.files else None),
        cfg, seen_pairs=train.pairs, his_items=train.his_items,
        his_masks=train.masks)
    want = (rec.recommend(SERVE, 10),
            rec.recommend(SERVE, 10, aggregate_users=True),
            rec.recommend_cold(mc.COLD, 10))
    for r in (r[f"{name}_step"] for r in ranks):
        for got, exp in zip((r["served"], r["served_aggregated"],
                             r["served_cold"]), want):
            np.testing.assert_array_equal(got, exp)


# ---------------------------------------------------------------------------
# The history dedup with attention on a mesh.

@pytest.mark.parametrize("name", POOL_KINDS)
def test_attention_dedup_on_a_mesh(jobs, name):
    """On the user-grouped fixed stream (``shuffle_mode: none``,
    ``visit_order: user``) the rank-local dedup maps are in use (the
    user-attention query sliced at each distinct user's first occurrence
    in the rank's rows, ``uniq_first``) and the run equals the one with
    the maps off, losses rtol 1e-5 as the JAX demo's ``accl`` variant
    holds them, and the single-rank oracle's (its own maps) rtol 1e-4."""
    shape, ranks, runs = jobs((2, 2))
    oracle = _oracle(shape, runs, f"{name}_dedup_on")
    for on, off in ((r[f"{name}_dedup_on"], r[f"{name}_dedup_off"])
                    for r in ranks):
        assert on["dedup_engaged"] and not off["dedup_engaged"]
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
        np.testing.assert_allclose(on["losses"], oracle["losses"], rtol=1e-4)
    mc.check_replicas([r[f"{name}_dedup_on"]["replicas"] for r in ranks])


# ---------------------------------------------------------------------------
# The sharded step against the JAX package's, with injected state and draws.


@pytest.mark.parametrize("aggregator", ["self_attention", "user_attention"])
def test_sharded_attention_steps_match_jax(aggregator):
    """Two steps of each attention kind on (2, 2) against the JAX step on
    the conftest's virtual (2, 2) mesh (whole history rows pooled, an
    empty history and a full one among them, the clip binding):
    ``tests/test_sharding.py``'s tolerances for the loss and ``attn_q``,
    the tables by the rule of ``hold_to_jax``."""
    ranks, jstate, jlosses, jss = injected_against_jax(
        {"aggregator": aggregator}, steps=2)
    hold_to_jax(ranks, jstate, jlosses, jss)
    if aggregator == "self_attention":
        for r in ranks:
            np.testing.assert_allclose(r["state"]["attn_q"],
                                       np.asarray(jstate.attn_q),
                                       rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# The CLI and the demo.

CONFIG0 = os.path.join(ROOT, "benchmarks", "AmazonBooks", "config0.yaml")
CLI_SETS = ["embedding_dim=16", "num_negs=4", "max_his=8", "batch_size=256",
            "learning_rate=0.002", "optimizer=adam",
            "aggregator=user_attention", "his_refresh=subepoch"]
CLI_SYN = (200, 400)


def test_cli_adam_user_attention_pools_on_two_ranks(tmp_path):
    """``torch.distributed.run`` with two CPU ranks, Adam and user-attention
    pools (``--set``): the epochs' losses against a single rank stepping
    the same global batches (rtol 1e-4 at lr 0.002), its metrics within
    0.02, the export's global tables."""
    import yaml

    emb = tmp_path / "emb.npz"
    argv = ["--config", CONFIG0, "--synthetic", ",".join(map(str, CLI_SYN)),
            "--epochs", "2", "--device", "cpu", "--export-embeddings", str(emb)]
    for kv in CLI_SETS:
        argv += ["--set", kv]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "heat_tpu_torch.main", *argv],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch.distributed backend: gloo (2 ranks" in proc.stdout
    final = json.loads([ln for ln in proc.stdout.splitlines()
                        if ln.startswith('{"final_metrics"')][-1])["final_metrics"]
    got = [float(ln.split("loss: ")[1].split(";")[0])
           for ln in proc.stdout.splitlines() if ln.startswith("epoch: ")]
    cfg, _ = load_config(CONFIG0, **{k: yaml.safe_load(v) for k, _, v in
                                     (kv.partition("=") for kv in CLI_SETS)})
    train, test = synthetic_click_dataset(*CLI_SYN, max_his=cfg.max_his,
                                          seed=cfg.seed)
    oracle = Engine(cfg, train, test, device="cpu")
    oracle._shard_stream(2)
    want = [oracle.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for m, v in oracle.evaluate().items():
        assert abs(final[m] - v) <= 0.02, (m, final[m], v)
    z = np.load(emb)
    assert z["user_emb"].shape == (CLI_SYN[0], 16)
    assert z["item_emb"].shape == (CLI_SYN[1], 16)


@pytest.mark.parametrize("variant", ["full", "accl"])
def test_multihost_demo_attention_variants(variant):
    """``heat_tpu_torch.multihost_demo --procs 1 --variant ...``: four ranks
    on a (2, 2) mesh; every rank reports the same line and the demo its
    checks passed (full: Adam, user-attention pools and the tile sampler
    learn, the sharded evaluation equals one evaluator over the gathered
    tables; accl: the attention dedup engaged with ``uniq_first`` and
    equal to the maps-off run for both kinds)."""
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
    assert (variant == "full") == ("accl" not in reports[0])
