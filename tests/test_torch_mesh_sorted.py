"""Shards on the sort-dedup update and the blocked initial draw on a
("data", "model") mesh of ranks (ROADMAP item 15b, point 5), and the
fused epochs there (point 6), held against the JAX package and the
single-rank port.

The sort-dedup update is reached at test sizes by lowering
``DENSE_ROWS_THRESHOLD``: in ``heat_tpu.train.scatter`` for the JAX step,
called eagerly (it reads the threshold at call time then), and inside
each spawned rank (``torch_mesh_support`` ``dense_rows=``; a setting of
the parent's does not reach a spawned rank). The JAX package picks the
path by the global table's rows, the port by the shard's.

Each multi-rank case runs its ranks as processes of a gloo job on the
CPU (``torch_mesh_support.spawn_ranks``), one job for the runs of one
mesh shape. Tolerances: against the JAX step, f32 arrays by the rule the
single-card branches are held to (``heat_tpu_torch.testing
.assert_state_array_close``: rtol 1e-5 / atol 1e-7 on 99.5% of the
elements, none off by more than 1e-4 x lr, or 1e-3 x clip_val for arrays
of gradients) and losses rtol 1e-5 / atol 1e-7; bf16 tables bit-equal
where no row occurs twice in a step and within one bf16 ulp where rows
repeat (an f32 sum taken in another order flips a rounding). Against the
single-rank oracle (``Engine._shard_stream``, which sums the data
shards' parts, accum mode's stale term of ``w0``'s gradient among them,
and orders the occurrences as the data group's first rank gathers them),
those of ``tests/test_torch_mesh_slots.py``. Replicas
bit-equal (SHA-256 over each group), slots and accum rows included.
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.state import (
    init_train_state,
    state_to_numpy,
    torch_dtype,
)
from heat_tpu_torch.train.engine import Engine

import torch_mesh_support as mc
from test_torch_mesh_fastpath import _jax_tile_steps, _ulps_bf16
from test_torch_mesh_slots import _close_states, hold_to_jax

TIMEOUT = 180
SORTED = 16  # DENSE_ROWS_THRESHOLD that puts every shard here on the sorted path

# ---------------------------------------------------------------------------
# The sharded step against the JAX package's, on the sort-dedup update.

# (overrides, the threshold, steps): SGD in batch and accum mode, Adagrad
# and Adam with every table sorted on both sides (two steps where the
# second reads state the first left: the accum rows, the moments, Adam's
# bias correction); at 30 rows the 40-row JAX user table sorts and the
# port's 20-row user shards go dense.
UNIFORM = {
    "sgd": ({}, SORTED, 1),
    "accum": ({"sgd_mode": "accum"}, SORTED, 2),
    "adagrad": ({"optimizer": "adagrad"}, SORTED, 2),
    "adam": ({"optimizer": "adam"}, SORTED, 2),
    "sgd_threshold_between": ({}, 30, 1),
}
# The tile sampler with cached pools, bf16 tables and compute and the
# combined-row update, one step: where no row occurs twice in a step, and
# where users, items and tile slots repeat.
TILE = {"bf16_tile_unique": True, "bf16_tile_repeats": False}


def _jax_eager(dense_rows, fn, *args):
    """``fn(*args)`` with the JAX package's threshold at ``dense_rows``."""
    import heat_tpu.train.scatter as jsc

    saved, jsc.DENSE_ROWS_THRESHOLD = jsc.DENSE_ROWS_THRESHOLD, dense_rows
    try:
        return fn(*args)
    finally:
        jsc.DENSE_ROWS_THRESHOLD = saved


def _uniform_case(overrides, steps=2):
    """The injected state, global batch and uniform draws of
    ``test_torch_mesh_slots.injected_against_jax`` (repeated users and
    items, a weight-0 tail on each data shard, lr 0.05 and a clip of 0.02
    that binds): (arrays, the config's keywords)."""
    import jax

    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.models.state import init_train_state as jinit

    rng = np.random.default_rng(0)
    u, i, h, b, k, d = 40, 90, 8, 48, 4, 16
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=0.05, clip_val=0.02, seed=0, **overrides)
    half = b // 2
    users = np.concatenate([rng.integers(0, u // 2, half),
                            rng.integers(u // 2, u, half)]).astype(np.int32)
    pos = rng.integers(0, i, b).astype(np.int32)
    users[:6], users[half: half + 4] = 3, 30  # repeated users
    pos[6:12] = 5  # a repeated item
    weight = np.ones(b, np.float32)
    weight[half - 3: half] = weight[-4:] = 0.0
    masks = rng.integers(0, h + 1, u).astype(np.int32)
    masks[:2] = [0, h]
    arrays = {"his": rng.integers(0, i, (u, h)).astype(np.int32),
              "masks": masks, "users": users, "pos": pos, "weight": weight,
              "draws": rng.integers(0, i, ((steps + 2) * b, k)).astype(np.int32)}
    jstate0 = jinit(JCFConfig(**kw), jax.random.key(1))
    for name in ("user_emb", "item_emb", "w0", "user_gacc", "item_gacc",
                 "attn_q"):
        if getattr(jstate0, name) is not None:
            arrays[name] = np.asarray(getattr(jstate0, name))
    if jstate0.opt_slots is not None:
        arrays["opt_slots"] = {key: np.asarray(v)
                               for key, v in jstate0.opt_slots.items()}
    return arrays, kw


def _jax_uniform_steps(arrays, kw, steps):
    """The JAX step on the conftest's virtual (2, 2) mesh, eagerly, from
    the injected state with the draws pinned at the sampler's count."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import heat_tpu.train.train_step as jts
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.models.state import init_train_state as jinit
    from heat_tpu.parallel.mesh import make_mesh as jmake_mesh
    from heat_tpu.parallel.mesh import shard_data_arrays, shard_train_state
    from heat_tpu.train.samplers import NegSample as JNegSample
    from heat_tpu.train.samplers import init_sampler_state as jinit_sampler

    jcfg = JCFConfig(**kw)
    mesh = jmake_mesh(2, 2, jax.devices()[:4])
    jstate = shard_train_state(jinit(jcfg, jax.random.key(1)), mesh)
    jhis, jmasks = shard_data_arrays(mesh, jnp.asarray(arrays["his"]),
                                     jnp.asarray(arrays["masks"]))
    bsh = NamedSharding(mesh, P("data"))
    jbatch = jts.Batch(*(jax.device_put(jnp.asarray(arrays[n]), bsh)
                         for n in ("users", "pos", "weight")))
    table = jnp.asarray(arrays["draws"])

    def pinned(key, sstate, pos_ids, cfg, real=None):
        idx = sstate.iterations + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)
        adv = pos_ids.shape[0] if real is None else real
        return JNegSample(table[idx], None, None), sstate.replace(
            iterations=sstate.iterations + adv)

    orig, jts.sample_negatives = jts.sample_negatives, pinned
    try:
        jss = jinit_sampler(jcfg, jax.random.key(2))
        jlosses = []
        for _ in range(steps):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3), jbatch, jhis, jmasks, jcfg)
            jlosses.append(float(jloss))
    finally:
        jts.sample_negatives = orig
    return jstate, jlosses, jss


def _tile_case(unique):
    """The injected batch, pinned tiles and draws of
    ``test_torch_mesh_fastpath.test_sharded_tile_step_matches_jax`` (64
    users, 300 items, tile 32) for bf16 tables and compute, cached pools
    and the combined-row update: (arrays without the state, keywords)."""
    rng = np.random.default_rng(0)
    u, i, h, b, k, d, t = 64, 300, 8, 48, 4, 16, 32
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=0.05, clip_val=0.02, seed=0, neg_sampler=1,
              tile_size=t, refresh_interval=256, param_dtype="bfloat16",
              compute_dtype="bfloat16", his_refresh="subepoch")
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
    return {"users": users.astype(np.int32), "pos": pos.astype(np.int32),
            "weight": weight, "tiles": tiles.astype(np.int32),
            "idx": rng.integers(0, t, (4 * b, k)).astype(np.int32),
            "his": rng.integers(0, i, (u, h)).astype(np.int32),
            "masks": rng.integers(0, h + 1, u).astype(np.int32)}, kw


def _cases() -> dict:
    """Every case above: {name: (injected arrays, keywords, threshold,
    steps, its keywords for the rank program)}, the initial state the JAX
    package's."""
    import jax

    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.models.state import init_train_state as jinit

    cases = {}
    for name, (overrides, rows, steps) in UNIFORM.items():
        arrays, kw = _uniform_case(overrides, steps)
        cases[name] = (arrays, kw, rows, steps, {})
    for name, unique in TILE.items():
        arrays, kw = _tile_case(unique)
        jstate0 = jinit(JCFConfig(**kw), jax.random.key(1))
        for key in ("user_emb", "item_emb", "w0"):
            arrays[key] = np.asarray(getattr(jstate0, key), np.float32)
        cases[name] = (arrays, kw, SORTED, 1, {"pools": True})
    return cases


def _jax_steps(name, case):
    """The JAX package's steps of one case, eagerly, its threshold lowered:
    (state, losses, sampler state)."""
    arrays, kw, rows, steps, _ = case
    if name in UNIFORM:
        return _jax_eager(rows, _jax_uniform_steps, arrays, kw, steps)
    _, jstate, jss, jlosses = _jax_eager(rows, _jax_tile_steps, arrays, kw,
                                         steps, True)
    return jstate, jlosses, jss


@pytest.fixture(scope="module")
def mesh22():
    """One job of four ranks on (2, 2) for the module: the engine runs of
    :func:`_engine_runs`, then every case's injected steps, each rank
    lowering its own threshold; the JAX package's steps run here while the
    ranks run. Returns (each rank's engine runs, each rank's injected
    steps by case, the JAX results, the injected arrays)."""
    import threading

    cases = _cases()
    calls = [("rank_runs", ((2, 2), DATA, _engine_runs((2, 2)), "cpu"), {})]
    calls += [("rank_steps_injected", (
        (2, 2), arrays, {k: v for k, v in kw.items()
                         if k not in ("num_users", "num_items")}, steps, "cpu"),
        dict(extra, dense_rows=rows))
        for arrays, kw, rows, steps, extra in cases.values()]
    box = {}

    def job():
        try:
            box["ranks"] = mc.spawn_ranks(mc.rank_calls, 4, calls,
                                          timeout=TIMEOUT)
        except BaseException as err:  # raised again below
            box["error"] = err

    thread = threading.Thread(target=job)
    thread.start()
    try:
        jax_out = {name: _jax_steps(name, case) for name, case in cases.items()}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    return ([r[0] for r in ranks], [dict(zip(cases, r[1:])) for r in ranks],
            jax_out, {name: c[0] for name, c in cases.items()})


@pytest.fixture(scope="module")
def mesh41():
    """One job of four ranks on (4, 1): the engine runs of that shape."""
    return mc.spawn_ranks(mc.rank_runs, 4, (4, 1), DATA, _engine_runs((4, 1)),
                          "cpu", timeout=TIMEOUT)


@pytest.mark.parametrize("name", sorted(UNIFORM))
def test_sorted_step_matches_jax(mesh22, name):
    """The port's (2, 2) step with every table sorted (at 30 rows the user
    shards stay dense) against the JAX step's sort-dedup update, the clip
    binding on the combined rows: the tables, ``w0``, the slots or accum
    rows, the losses and the counters; replicas bit-equal."""
    _, ranks, jax_out, _ = mesh22
    hold_to_jax([r[name] for r in ranks], *jax_out[name])


@pytest.mark.parametrize("name", sorted(TILE))
def test_sorted_bf16_tile_step_matches_jax(mesh22, name):
    """The bf16 tile fast path (cached pools, the combined-row update on
    B + T item occurrences, the tile's gradient summed over the data
    group) on the sort-dedup update, one step against the JAX step:
    tables bit-equal where no row occurs twice, within one bf16 ulp where
    rows repeat; losses rtol 1e-4; ``w0`` (f32) within 1% of its largest
    move (its gradient is a bf16 product)."""
    _, ranks, jax_out, arrays = mesh22
    jstate, jlosses, jss = jax_out[name]
    w0_start = arrays[name]["w0"]
    mc.check_replicas([r[name]["replicas"] for r in ranks])
    for r in (r[name] for r in ranks):
        assert r["iterations"] == int(jss.iterations)
        assert int(r["state"]["step"]) == int(jstate.step) == 1
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        for key in ("user_emb", "item_emb"):
            want = np.asarray(getattr(jstate, key), np.float32)
            ulps = _ulps_bf16(r["state"][key], want)
            assert ulps.max() <= (0 if TILE[name] else 1), (key, ulps.max())
        move = np.abs(np.asarray(jstate.w0) - w0_start).max()
        np.testing.assert_allclose(r["state"]["w0"], np.asarray(jstate.w0),
                                   atol=1e-2 * move, rtol=0)


# ---------------------------------------------------------------------------
# Engines on the sorted path against the single-rank oracle; the fused
# epochs against the epochs one by one; the blocked initial draw.

DATA = dict(num_users=128, num_items=300, clicks_per_user=20, max_his=8, seed=9)
BASE = dict(emb_dim=16, num_negs=4, max_his=8, l_r=0.005, batch_size=128,
            milestones=[10], seed=3, metrics=["Recall(k=20)", "NDCG(k=50)"])
ENGINES = {
    "sgd": BASE,
    "adam_tile": dict(BASE, optimizer="adam", neg_sampler=1, tile_size=32,
                      refresh_interval=256),
    "accum": dict(BASE, sgd_mode="accum"),
}
# The fused forms of two stream layouts (the demo's "fused" variant holds
# the fixed stream with its dedup), each beside its plain twin (which
# evaluates at reference_schedule's epochs, eval_interval 1).
FUSED = {
    "shuffled": dict(BASE),
    "subepochs": dict(BASE, num_subepochs=2),
}
BLOCK = 16  # INIT_BLOCK_ROWS that splits both tables into blocks


# The engine runs of each shape.
SHAPE_ENGINES = {(2, 2): ("sgd", "adam_tile", "accum"),
                 (4, 1): ("sgd", "adam_tile", "accum")}


def _engine_runs(shape):
    runs = {name: (ENGINES[name], 2, {"dense_rows": SORTED})
            for name in SHAPE_ENGINES[shape]}
    if shape == (2, 2):
        for name, cfg in FUSED.items():
            for form in ("epochs", "run", None):
                runs[f"{name}_{form}"] = (cfg, 2, {
                    "dense_rows": SORTED, "fused": form, "eval_interval": 1})
        runs["blocked_draw"] = (ENGINES["adam_tile"], 0,
                                {"init_block_rows": BLOCK, "evaluate": False})
        runs["accum_blocked_draw"] = (ENGINES["accum"], 0,
                                      {"init_block_rows": BLOCK,
                                       "evaluate": False})
    return runs


@pytest.mark.parametrize("shape,name", [
    (shape, name) for shape, names in SHAPE_ENGINES.items() for name in names],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_sorted_engine_equals_one_rank(mesh22, mesh41, shape, name):
    """Two epochs with both shards on the sort-dedup update against the
    single-rank oracle on it: losses rtol 5e-4 at lr 0.005, the tables,
    ``w0``, the slots or accum rows as ``test_torch_mesh_slots`` holds
    them, metrics within 0.02, the generators aligned; replicas
    bit-equal."""
    ranks = mesh22[0] if shape == (2, 2) else mesh41
    cfg = ENGINES[name]
    oracle = mc.train_oracle(shape[0], DATA, cfg, 2, "cpu", n_model=shape[1],
                             dense_rows=SORTED)
    for r in (r[name] for r in ranks):
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=5e-4)
        assert r["losses"][1] < r["losses"][0]
        _close_states(r["state"], oracle["state"], name, cfg["l_r"])
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.02, (m, r["metrics"][m], v)
        assert r["generators"] == oracle["generators"]
    mc.check_replicas([r[name]["replicas"] for r in ranks])


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_epochs_on_a_mesh(mesh22, name):
    """On (2, 2), on the sort-dedup update: ``train_epochs(2)`` and
    ``run_epochs_with_eval(2, 1)`` equal two ``train_one_epoch`` calls
    with the evaluation after epoch 1 (and the final one) bit for bit:
    losses, metrics, every tensor of the state, the generators."""
    for r in mesh22[0]:
        plain = r[f"{name}_None"]
        assert len(plain["evals"]) == 1
        for form in ("epochs", "run"):
            fused = r[f"{name}_{form}"]
            assert fused["losses"] == plain["losses"], form
            assert fused["metrics"] == plain["metrics"], form
            assert fused["generators"] == plain["generators"], form
            for key in ("user_emb", "item_emb", "w0"):
                np.testing.assert_array_equal(fused["state"][key],
                                              plain["state"][key])
        assert r[f"{name}_run"]["evals"] == plain["evals"]


@pytest.mark.parametrize("run", ["blocked_draw", "accum_blocked_draw"])
def test_blocked_draw_on_a_mesh(mesh22, run):
    """With INIT_BLOCK_ROWS at 16 every table is drawn in blocks and each
    rank keeps its rows: the global state gathered from (2, 2) is a
    mesh-less engine's of the same seed and block, bit for bit, the
    slots and accum rows (zero, a shard each) included."""
    ranks = mesh22[0]
    cfg = ENGINES["adam_tile" if run == "blocked_draw" else "accum"]
    train, test = mc.make_data(DATA)
    with mc.Lowered(init_block_rows=BLOCK):
        want = state_to_numpy(
            Engine(CFConfig(**cfg), train, test, device="cpu").state)
    assert want.get("opt_slots") or want.get("user_gacc") is not None
    for got in (r[run]["state"] for r in ranks):
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, dict):
                assert set(got[key]) == set(value)
                for k, v in value.items():
                    np.testing.assert_array_equal(got[key][k], v, err_msg=k)
            else:
                np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_a_table_within_one_block_draws_as_before():
    """A table of at most INIT_BLOCK_ROWS rows is one draw, as before the
    blocks: ``randn`` of the whole table, scaled by INIT_STD and cast, the
    user table, then the item table, then ``w0``, from one generator. At a
    block of 16 rows a 128-row table is eight draws, and the same global
    tables come out with or without a mesh (``test_blocked_draw_on_a_mesh``)."""
    from heat_tpu_torch.models import state as st

    for dtype in ("float32", "bfloat16"):
        cfg = CFConfig(**BASE, param_dtype=dtype)
        cfg.num_users, cfg.num_items = 128, 300
        got = init_train_state(cfg, torch.Generator().manual_seed(5), "cpu")
        g = torch.Generator().manual_seed(5)
        d, t = cfg.emb_dim, torch_dtype(dtype)
        for key, rows in (("user_emb", 128), ("item_emb", 300)):
            want = torch.randn((rows, d), generator=g).mul_(st.INIT_STD).to(t)
            assert torch.equal(getattr(got, key), want), key
        assert torch.equal(got.w0, torch.randn((d, d), generator=g).mul_(
            st.INIT_STD))
        assert st.INIT_BLOCK_ROWS >= 4 * 1024 * 1024
        with mc.Lowered(init_block_rows=BLOCK):
            blocked = init_train_state(cfg, torch.Generator().manual_seed(5),
                                       "cpu")
        assert blocked.user_emb.shape == (128, d)
        assert blocked.item_emb.dtype == t
