"""The fast path on a ("data", "model") mesh of ranks (ROADMAP item 15b,
point 1), held against the single-rank port and the JAX package: the JAX
``bench.py`` headline (the tile sampler with whole-tile scoring, cached
history pools, bf16 tables and compute, ``update_mode: direct``), the
fixed streams with their history dedup, the pools' refresh, the CLI under
``torch.distributed.run``, export and ``Recommender.from_engine``.

Each multi-rank case runs its ranks as processes of a gloo job on the CPU
(``torch_mesh_support.spawn_ranks``, a free localhost port, a timeout).
The single-rank oracle steps the mesh's global batches with the mesh's
draws (``Engine._shard_stream(n_data)``; on the model axis it sums the
partial history means in f32 as the model group does,
``torch_mesh_support.PartialMeans``). Tolerances:

* f32, those of ``tests/test_sharding.py``: one tile step (:146) the loss
  rtol 1e-5, user rows rtol 1e-4 / atol 5e-6, item rows rtol 1e-2 / atol
  2e-6; epochs in ``direct`` mode (:246) the loss rtol 5e-4 after one
  epoch and 2e-2 after two.
* bf16, added here: the first step reads bit-equal inputs, so its loss is
  held to rtol 1e-5 and its tables to the rule the bf16 step is held to
  against JAX (``tests/test_torch_fastpath.py``): at least 99% of the
  elements bit-equal and none further than 2 bf16 ulps (an f32 sum taken
  in another order flips a rounding), ``w0`` (f32) within 1% of its
  largest move (its gradient is a bf16 product). From the second step on a flipped
  rounding (2^-8 of an element) moves every later step, so bf16
  trajectories are held to :246's two-epoch rtol 2e-2 in every epoch, and
  the logic of the same configurations to the f32 tolerances above.

Replicas are held bit-equal (their SHA-256 over each group), and the
engine's generators equal on every rank and the oracle's (every draw
aligned).
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
from heat_tpu_torch.models.state import state_from_numpy
from heat_tpu_torch.serving import Recommender
from heat_tpu_torch.train.engine import Engine

import torch_mesh_support as mc

# 300 items: 512 padded rows on two model shards, real items on both.
DATA = dict(num_users=128, num_items=300, clicks_per_user=20, max_his=8, seed=9)
BASE = dict(emb_dim=16, num_negs=4, max_his=8, l_r=0.005, batch_size=128,
            milestones=[10], seed=3, metrics=["Recall(k=20)", "NDCG(k=50)"])
# The JAX bench.py headline at a small tile.
HEADLINE = dict(BASE, neg_sampler=1, tile_size=32, refresh_interval=256,
                his_refresh="subepoch", param_dtype="bfloat16",
                compute_dtype="bfloat16", update_mode="direct")
F32 = dict(param_dtype="float32", compute_dtype="float32")
ONE_STEP = dict(HEADLINE, batch_size=1 << 12)  # every pair in one batch
SHAPES = [(2, 1), (1, 2), (2, 2)]
SERVE = [0, 7, 63, 64, 100, 127]  # users of every data shard
TIMEOUT = 180


def _ulps_bf16(got, want):
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    return np.abs(got.astype(np.float64) - want) / ulp


def _bf16_close(got, want, what):
    ulps = _ulps_bf16(got, want)
    assert (ulps == 0).mean() >= 0.99, (what, (ulps == 0).mean())
    assert ulps.max() <= 2, (what, ulps.max())


def _same_draws(ranks, oracle=None):
    digests = {json.dumps(r["generators"], sort_keys=True) for r in ranks}
    if oracle is not None:
        digests.add(json.dumps(oracle["generators"], sort_keys=True))
    assert len(digests) == 1, digests


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def one_step(request, tmp_path_factory):
    """One global headline step of every pair on a mesh (with the export,
    from_engine and the sharded top-k), and the single-rank oracle's."""
    shape = request.param
    out = tmp_path_factory.mktemp("export") / "emb.npz"
    ranks = mc.spawn_ranks(mc.rank_train, shape[0] * shape[1], shape, DATA,
                           ONE_STEP, 1, "cpu", export_path=str(out),
                           serve_users=SERVE, timeout=TIMEOUT)
    oracle = mc.train_oracle(shape[0], DATA, ONE_STEP, 1, "cpu",
                             n_model=shape[1])
    return shape, ranks, oracle, out


def test_headline_step_equals_one_rank(one_step):
    shape, ranks, oracle, _ = one_step
    for r in ranks:
        assert r["steps"] == 1 and r["backend"] == "gloo"
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=1e-5)
        for name in ("user_emb", "item_emb"):
            _bf16_close(r["state"][name], oracle["state"][name], name)
        move = np.abs(oracle["state"]["w0"] - oracle["w0_start"]).max()
        np.testing.assert_allclose(r["state"]["w0"], oracle["state"]["w0"],
                                   atol=1e-2 * move, rtol=0)
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.01, (m, r["metrics"][m], v)
        # The tile sampler's state is replicated: one refresh, one tile.
        for name in ("user_emb", "item_emb", "w0"):
            np.testing.assert_array_equal(r["state"][name], ranks[0]["state"][name])
    mc.check_replicas([r["replicas"] for r in ranks])
    _same_draws(ranks, oracle)


def test_headline_export_and_from_engine(one_step):
    """The export of bf16 mesh tables holds the gathered global tables (as
    f32, exactly), and ``from_engine`` on every rank serves what one
    Recommender over them and all the train pairs serves."""
    shape, ranks, _, path = one_step
    z = np.load(path)
    st = ranks[0]["state"]
    assert z["item_emb"].shape == (DATA["num_items"], BASE["emb_dim"])
    for name in ("user_emb", "item_emb", "w0"):
        np.testing.assert_array_equal(z[name], st[name])
    train, _ = synthetic_click_dataset(**DATA)
    cfg = CFConfig(**ONE_STEP)
    cfg.num_users, cfg.num_items = DATA["num_users"], DATA["num_items"]
    rec = Recommender(
        state_from_numpy(st["user_emb"], st["item_emb"], st["w0"], lr=0.0,
                         step=0, device="cpu", param_dtype=torch.bfloat16),
        cfg, seen_pairs=train.pairs, his_items=train.his_items,
        his_masks=train.masks)
    want = rec.recommend(SERVE, 10)
    for r in ranks:
        np.testing.assert_array_equal(r["served"], want)


@pytest.mark.parametrize("shape,dtypes", [((2, 2), F32), ((2, 2), {})],
                         ids=["2x2-f32", "2x2-bf16"])
def test_headline_epochs_equal_one_rank(shape, dtypes):
    """Two epochs of several steps (the tile refreshed on the global
    cadence, the pools once an epoch, ``direct`` updates) and an
    evaluation against the single-rank oracle, at :246's tolerances in f32
    and the bf16 trajectory rule; metrics within 0.02."""
    cfg = dict(HEADLINE, **dtypes)
    ranks = mc.spawn_ranks(mc.rank_train, shape[0] * shape[1], shape, DATA,
                           cfg, 2, "cpu", timeout=TIMEOUT)
    oracle = mc.train_oracle(shape[0], DATA, cfg, 2, "cpu", n_model=shape[1])
    rtol = [5e-4, 2e-2] if dtypes else [2e-2, 2e-2]
    for r in ranks:
        assert r["epoch_steps"][0] == r["epoch_steps"][1] > 1
        for got, want, tol in zip(r["losses"], oracle["losses"], rtol):
            np.testing.assert_allclose(got, want, rtol=tol)
        assert r["losses"][1] < r["losses"][0]
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.02, (m, r["metrics"][m], v)
    mc.check_replicas([r["replicas"] for r in ranks])
    _same_draws(ranks, oracle)


# ---------------------------------------------------------------------------
# The step against the JAX package's sharded step.


def _jax_tile_steps(arrays, kw, steps, pools):
    """``steps`` JAX steps on the conftest's virtual (2, 2) mesh from the
    injected global state, batch and pinned tiles, eagerly (op by op it
    rounds where the port does)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import heat_tpu.train.samplers as jsam
    import heat_tpu.train.train_step as jts
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.models.state import init_train_state as jinit
    from heat_tpu.parallel.mesh import make_mesh as jmake_mesh
    from heat_tpu.parallel.mesh import shard_data_arrays, shard_train_state

    jcfg = JCFConfig(**kw)
    jstate = jinit(jcfg, jax.random.key(1))
    mesh = jmake_mesh(2, 2, jax.devices()[:4])
    jstate = shard_train_state(jstate, mesh)
    jhis, jmasks = shard_data_arrays(mesh, jnp.asarray(arrays["his"]),
                                     jnp.asarray(arrays["masks"]))
    bsh = NamedSharding(mesh, P("data"))
    jbatch = jts.Batch(*(jax.device_put(jnp.asarray(arrays[n]), bsh)
                         for n in ("users", "pos", "weight")))
    tiles, idx = jnp.asarray(arrays["tiles"]), jnp.asarray(arrays["idx"])

    def pinned(key, sstate, pos_ids, cfg, real=None):
        it = sstate.iterations
        tile = tiles[it % tiles.shape[0]]
        drawn = idx[it + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)]
        adv = pos_ids.shape[0] if real is None else real
        return jsam.NegSample(tile[drawn], tile, drawn), jsam.SamplerState(
            tile=tile, iterations=it + adv)

    orig, jts.sample_negatives = jts.sample_negatives, pinned
    losses = []
    try:
        jss = jsam.init_sampler_state(jcfg, jax.random.key(2))
        for _ in range(steps):
            means = jts._refresh_pools(jcfg, jstate, jhis, jmasks) if pools else None
            jstate, jss, loss = jts.train_step(
                jstate, jss, jax.random.key(3), jbatch, jhis, jmasks, jcfg,
                user_means=means)
            losses.append(float(loss))
    finally:
        jts.sample_negatives = orig
    assert "data" in str(jstate.user_emb.sharding)
    return jinit(jcfg, jax.random.key(1)), jstate, jss, losses


@pytest.mark.parametrize("extra", [
    dict(F32, update_mode="direct"),
    dict(update_mode="direct", param_dtype="bfloat16", compute_dtype="bfloat16",
         his_refresh="subepoch"),
    dict(param_dtype="bfloat16", compute_dtype="bfloat16",
         his_refresh="subepoch"),
], ids=["f32-direct", "bf16-headline-unique", "bf16-pools"])
def test_sharded_tile_step_matches_jax(extra):
    """The port's (2, 2) tile step against the JAX package's on the
    conftest's virtual (2, 2) mesh: one injected state, global batch
    (repeated users and items, a weight-0 tail on each data shard) and
    pinned tiles and draws, two steps, with ``clip_val`` 0.02, which binds
    on the tile's data-summed gradient (each slot sums the whole global
    batch's draws of it), so a clip of a rank's part would show. f32:
    rtol 1e-5 / atol 1e-7 (tests/test_torch_step.py's rule; the partial
    means and the tile gradient sum in another order). bf16 (the
    ``tests/test_torch_fastpath.py`` rule above): the combined-row update
    on repeated ids, and the headline's ``direct`` update where no row
    occurs twice in a step (a bf16 add per occurrence depends on the
    order of the adds otherwise); losses rtol 1e-4, ``w0`` within 1% of
    its largest move."""
    import jax

    from heat_tpu_torch.testing import assert_state_array_close

    unique = extra.get("update_mode") == "direct" and "bfloat16" in extra.values()
    rng = np.random.default_rng(0)
    u, i, h, b, k, d, t = 64, 300, 8, 48, 4, 16, 32
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=0.05, clip_val=0.02, seed=0, neg_sampler=1,
              tile_size=t, refresh_interval=256, **extra)
    half = b // 2
    if unique:
        users = np.concatenate([rng.permutation(u // 2)[:half],
                                u // 2 + rng.permutation(u // 2)[:half]])
        items = rng.permutation(i)
        pos, tiles = items[:b], np.tile(items[b: b + t], (3, 1))
    else:
        users = np.concatenate([rng.integers(0, u // 2, half),
                                rng.integers(u // 2, u, half)])
        pos = rng.integers(0, i, b)
        users[:6], users[half: half + 4] = 3, u // 2 + 6  # repeated users
        pos[6:12] = 5  # a repeated item
        tiles = rng.integers(0, i, (3, t))
        tiles[:, 4], tiles[:, 7] = tiles[:, 2], 5  # a repeat, the positive
        tiles[0, 9] = 280  # an item of the second model shard
    weight = np.ones(b, np.float32)
    weight[half - 3: half] = weight[-4:] = 0.0
    arrays = {
        "users": users.astype(np.int32), "pos": pos.astype(np.int32),
        "weight": weight, "tiles": tiles.astype(np.int32),
        "idx": rng.integers(0, t, (4 * b, k)).astype(np.int32),
        "his": rng.integers(0, i, (u, h)).astype(np.int32),
        "masks": rng.integers(0, h + 1, u).astype(np.int32)}
    jstate0, jstate, jss, jlosses = _jax_tile_steps(
        arrays, kw, 2, kw.get("his_refresh") == "subepoch")
    for name in ("user_emb", "item_emb", "w0"):
        arrays[name] = np.asarray(getattr(jstate0, name), np.float32)
    cfg_kw = {k2: v for k2, v in kw.items() if k2 not in ("num_users", "num_items")}
    ranks = mc.spawn_ranks(mc.rank_steps_injected, 4, (2, 2), arrays, cfg_kw,
                           2, "cpu", pools=kw.get("his_refresh") == "subepoch",
                           timeout=TIMEOUT)
    mc.check_replicas([r["replicas"] for r in ranks])
    lr, clip = kw["l_r"], kw["clip_val"]
    moved = np.abs(np.asarray(jstate.item_emb, np.float32) - arrays["item_emb"])
    if kw.get("update_mode") == "direct" and not unique:
        # Two steps of per-occurrence updates: the clip bound some slot.
        assert (np.minimum(np.abs(moved - lr * clip),
                           np.abs(moved - 2 * lr * clip)) < 1e-6).any()
    for r in ranks:
        assert r["iterations"] == int(jss.iterations) == 2 * int(weight.sum())
        assert int(r["state"]["step"]) == 2
        if "bfloat16" in extra.values():
            np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
            for name in ("user_emb", "item_emb"):
                _bf16_close(r["state"][name],
                            np.asarray(getattr(jstate, name), np.float32), name)
            move = np.abs(np.asarray(jstate.w0) - arrays["w0"]).max()
            np.testing.assert_allclose(r["state"]["w0"], np.asarray(jstate.w0),
                                       atol=1e-2 * move, rtol=0)
            continue
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5, atol=1e-7)
        for name in ("user_emb", "item_emb", "w0"):
            assert_state_array_close(
                r["state"][name], np.asarray(getattr(jstate, name)), name,
                lr=lr, clip_val=clip, rtol=1e-5, atol=1e-7)
    assert jax.devices()[0].platform == "cpu"


# ---------------------------------------------------------------------------
# The pools' refresh.


def test_pools_round_once_on_a_mesh():
    """``Engine._pooled_history`` of bf16 tables: on (2, 1) bit-equal to one
    rank's pools (its users' rows); on (1, 2) within one bf16 ulp of them,
    the model shards' f32 partial means summed and rounded once. The
    partial means rounded to bf16 before their sum (what the model group
    summed before this was repaired) are further than one ulp on this
    data: the test would catch that fault."""
    data = dict(DATA, max_his=40, clicks_per_user=40)
    cfg = dict(HEADLINE, max_his=40)
    train, test = synthetic_click_dataset(**data)
    one = Engine(CFConfig(**cfg), train, test, device="cpu")
    want = one._pooled_history().float().numpy()
    got21 = mc.spawn_ranks(mc.rank_pools, 2, (2, 1), data, cfg, "cpu",
                           timeout=TIMEOUT)
    for r in got21:
        np.testing.assert_array_equal(r["pools"], want[r["users"]])
    got12 = mc.spawn_ranks(mc.rank_pools, 2, (1, 2), data, cfg, "cpu",
                           timeout=TIMEOUT)
    for r in got12:
        assert _ulps_bf16(r["pools"], want).max() <= 1.0
        np.testing.assert_array_equal(r["pools"], got12[0]["pools"])
        assert _ulps_bf16(r["double_rounded"], want).max() > 1.0


# ---------------------------------------------------------------------------
# The fixed streams with their history dedup.


def test_fixed_stream_dedup_on_a_mesh():
    """``shuffle_mode: none`` with ``visit_order: user`` on (2, 2): each rank
    pre-sorts its own shard, the dedup's go/no-go and width are decided
    over the data group, the maps are in use, and the run equals the same
    run with the maps off bit for bit (pooling once per distinct user is
    an exact rewrite) and the single-rank oracle at the f32 tolerances of
    tests/test_torch_mesh.py (rtol 5e-4 at lr 0.005)."""
    cfg = dict(BASE, shuffle_mode="none", visit_order="user")
    on = mc.spawn_ranks(mc.rank_train, 4, (2, 2), DATA, cfg, 2, "cpu",
                        timeout=TIMEOUT)
    off = mc.spawn_ranks(mc.rank_train, 4, (2, 2), DATA, cfg, 2, "cpu",
                         dedup=False, timeout=TIMEOUT)
    oracle = mc.train_oracle(2, DATA, cfg, 2, "cpu", n_model=2)
    for a, b in zip(on, off):
        assert a["dedup_engaged"] and not b["dedup_engaged"]
        assert a["losses"] == b["losses"]
        for name in ("user_emb", "item_emb", "w0"):
            np.testing.assert_array_equal(a["state"][name], b["state"][name])
        np.testing.assert_allclose(a["losses"], oracle["losses"], rtol=5e-4)
    mc.check_replicas([r["replicas"] for r in on])
    _same_draws(on, oracle)


# ---------------------------------------------------------------------------
# The CLI under torch.distributed.run.

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG0 = os.path.join(ROOT, "benchmarks", "AmazonBooks", "config0.yaml")
SYN = (200, 400)
SMALL = ["embedding_dim=16", "num_negs=4", "max_his=8", "tile_size=32",
         "refresh_interval=256"]
HEADLINE_SETS = ["neg_sampler=1", "his_refresh=subepoch",
                 "param_dtype=bfloat16", "compute_dtype=bfloat16",
                 "update_mode=direct"]


def test_cli_on_a_mesh_runs_the_headline(tmp_path):
    cli_equals_one_rank(tmp_path, HEADLINE_SETS)


def cli_equals_one_rank(tmp_path, sets):
    """The CLI in two ranks with ``sets`` (``--set`` overrides, here the
    headline's) at a small size: its losses against a single rank
    stepping the same global batches (the bf16 trajectory rule, rtol
    2e-2), its metrics within 0.02, and the export's global bf16 tables."""
    sets = SMALL + sets
    emb = tmp_path / "emb.npz"
    argv = ["--config", CONFIG0, "--synthetic", ",".join(map(str, SYN)),
            "--epochs", "3", "--device", "cpu", "--export-embeddings", str(emb)]
    for kv in sets:
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
    import yaml

    cfg, _ = load_config(CONFIG0, **{k: yaml.safe_load(v) for k, _, v in
                                     (kv.partition("=") for kv in sets)})
    train, test = synthetic_click_dataset(*SYN, max_his=cfg.max_his,
                                          seed=cfg.seed)
    oracle = Engine(cfg, train, test, device="cpu")
    oracle._shard_stream(2)
    want = [oracle.train_one_epoch() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    for m, v in oracle.evaluate().items():
        assert abs(final[m] - v) <= 0.02, (m, final[m], v)
    z = np.load(emb)
    assert z["item_emb"].shape == (SYN[1], 16)
    assert z["item_emb"].astype(np.float32).tobytes() == torch.from_numpy(
        z["item_emb"]).bfloat16().float().numpy().tobytes()  # bf16 values
