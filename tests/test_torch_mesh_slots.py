"""Adagrad, Adam and ``sgd_mode: accum`` on a ("data", "model") mesh of
ranks (ROADMAP item 15b, point 3), held against the single-rank port and
the JAX package: the slot tables and the accum rows through the sharded
step (``train_step_sharded``: the user side's dense passes, the item
side's one reduced buffer with its global touched counts, ``step``
advanced before the updates), the accum rows zeroed after every sharded
sub-epoch, the state's layout on the mesh, and checkpoints that move
between meshes mid-run.

Each multi-rank case runs its ranks as processes of a gloo job on the CPU
(``torch_mesh_support.spawn_ranks``, a free localhost port, a timeout);
the runs of one mesh shape share one job (``rank_runs``). The single-rank
oracle steps the mesh's global batches with the mesh's draws
(``Engine._shard_stream(n_data)``; on the model axis it sums the partial
history means as the model group does). Tolerances, those of
``tests/test_torch_mesh.py``: one step the loss rtol 1e-5, user rows and
``w0`` rtol 1e-4 / atol 5e-6, item rows rtol 1e-2 / atol 2e-6; two
epochs at lr 0.005 the losses rtol 5e-4 (a 1e-7 change of the initial
tables moves the second epoch's loss by 5e-5 under Adagrad, 9e-6 under
Adam with the tile sampler and 1e-6 under accum at this size, measured on
one rank). Added for Adam, before its first run: the tables at atol
1e-3 x lr beside their rtol, because near g = 0 the update
``lr * m_hat / (sqrt(v_hat) + eps)`` has the slope lr / eps, which turns
an f32 summation-order difference of a gradient into a table difference
that the other tolerances do not cover; the moments and accum rows at
rtol 1e-4 (atol 1e-9 and 5e-6). Against the JAX step every array is held
to the rule of the single-card branches against JAX
(``heat_tpu_torch.testing.assert_state_array_close``); the first run held
the moments to rtol 1e-4 / atol 1e-9 there, and one element of 640 of
Adam's ``user_m`` (a repeated user, whose per-occurrence gradients of
~1e2 cancel) was 1.6e-7 (1.2e-4 relative) off. Replicas are held
bit-equal (their SHA-256 over each group: every slot table and accum row
too).
"""

import dataclasses

import numpy as np
import pytest
import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.models.state import init_train_state
from heat_tpu_torch.parallel.mesh import (
    gather_train_state,
    make_mesh,
    shard_train_state,
    table_shards,
)
from heat_tpu_torch.parallel import distributed

import torch_mesh_support as mc

# 300 items: 384 padded rows on one model shard, 512 on two.
DATA = dict(num_users=128, num_items=300, clicks_per_user=20, max_his=8, seed=9)
BASE = dict(emb_dim=16, num_negs=4, max_his=8, l_r=0.005, batch_size=128,
            milestones=[10], seed=3, metrics=["Recall(k=20)", "NDCG(k=50)"])
CONFIGS = {
    "adagrad": dict(BASE, optimizer="adagrad"),
    "adam_tile": dict(BASE, optimizer="adam", neg_sampler=1, tile_size=32,
                      refresh_interval=256),
    "accum": dict(BASE, sgd_mode="accum"),
}
SHAPES = [(2, 1), (1, 2), (2, 2)]
TIMEOUT = 180
ONE_STEP = 1 << 12  # every pair in one global batch
ACCUM_SUBEPOCHS = dict(CONFIGS["accum"], num_subepochs=2)


def _runs(shape):
    runs = {}
    for name, cfg in CONFIGS.items():
        runs[f"{name}_step"] = (dict(cfg, batch_size=ONE_STEP), 1, {})
        runs[f"{name}_epochs"] = (cfg, 2, {})
    if shape == (2, 1):
        runs["accum_subepochs"] = (ACCUM_SUBEPOCHS, 1, {"probe_gacc": True})
    if shape == (2, 2):
        runs["adam_untrained"] = (CONFIGS["adam_tile"], 0, {})
        runs["accum_untrained"] = (CONFIGS["accum"], 0, {})
    return runs


@pytest.fixture(scope="module")
def jobs():
    """``jobs(shape)``: every run of :func:`_runs` on one mesh shape, in one
    job, started at the first call and kept for the module."""
    done = {}

    def get(shape):
        if shape not in done:
            done[shape] = (shape, mc.spawn_ranks(
                mc.rank_runs, shape[0] * shape[1], shape, DATA, _runs(shape),
                "cpu", timeout=TIMEOUT))
        return done[shape]

    return get


@pytest.fixture(params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def shape_runs(request, jobs):
    return jobs(request.param)


def _oracle(shape, run):
    cfg, epochs, _ = _runs(shape)[run]
    return mc.train_oracle(shape[0], DATA, cfg, epochs, "cpu", n_model=shape[1])


def _adam(name):
    return name.startswith("adam")


def _close_states(got, want, name, lr):
    atol = 1e-3 * lr if _adam(name) else 0.0
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=1e-4,
                               atol=max(5e-6, atol), err_msg="user_emb")
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=1e-2,
                               atol=max(2e-6, atol), err_msg="item_emb")
    np.testing.assert_allclose(got["w0"], want["w0"], rtol=1e-4,
                               atol=max(5e-6, atol), err_msg="w0")
    for key, value in (want.get("opt_slots") or {}).items():
        np.testing.assert_allclose(got["opt_slots"][key], value, rtol=1e-4,
                                   atol=1e-9, err_msg=key)
    for key in ("user_gacc", "item_gacc"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=5e-6, err_msg=key)
    assert int(got["step"]) == int(want["step"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_step_equals_one_rank(shape_runs, name):
    """One global step of every pair: the loss, the tables, ``w0``, the
    slots or accum rows and ``step`` against the oracle; replicas
    bit-equal, slots included; every rank gathers the same state."""
    shape, ranks = shape_runs
    oracle = _oracle(shape, f"{name}_step")
    for r in (r[f"{name}_step"] for r in ranks):
        assert r["steps"] == 1
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=1e-5)
        _close_states(r["state"], oracle["state"], name, BASE["l_r"])
        np.testing.assert_array_equal(r["state"]["user_emb"],
                                      ranks[0][f"{name}_step"]["state"]["user_emb"])
    mc.check_replicas([r[f"{name}_step"]["replicas"] for r in ranks])
    digests = ranks[0][f"{name}_step"]["replicas"]
    assert {"user_v", "item_v", "w0_v"} <= set(digests) if name != "accum" \
        else {"user_gacc", "item_gacc"} <= set(digests)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_epochs_equal_one_rank(shape_runs, name):
    """Two epochs of several steps and an evaluation at lr 0.005: losses
    rtol 5e-4, metrics within 0.02, the generators aligned, replicas
    bit-equal."""
    shape, ranks = shape_runs
    oracle = _oracle(shape, f"{name}_epochs")
    for r in (r[f"{name}_epochs"] for r in ranks):
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=5e-4)
        assert r["losses"][1] < r["losses"][0]
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.02, (m, r["metrics"][m], v)
        assert r["generators"] == oracle["generators"]
    mc.check_replicas([r[f"{name}_epochs"]["replicas"] for r in ranks])


def test_accum_rows_zeroed_after_every_sharded_subepoch(jobs):
    """On (2, 1) under ``sgd_mode: accum`` with two sub-epochs the accum
    rows are zero before each sub-epoch's steps and after the epoch, on
    every rank, as the JAX engine zeroes them
    (``heat_tpu/train/train_step.py:787-790``, the reference's
    engine.cpp:345-347), and were not zero in between (the probe reads
    something). The oracle runs the same sharded sub-epochs, so the rows
    themselves are read; the losses equal the oracle's too."""
    shape, ranks = jobs((2, 1))
    oracle = _oracle(shape, "accum_subepochs")
    for r in (r["accum_subepochs"] for r in ranks):
        assert r["gacc_before_steps"] == [0.0, 0.0], r["gacc_before_steps"]
        assert r["gacc_after"] == 0.0
        assert r["steps"] > 0
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=5e-4)
    mc.check_replicas([r["accum_subepochs"]["replicas"] for r in ranks])


def test_mesh_layout_round_trips_every_slot(jobs):
    """The untrained state gathered from a (2, 2) mesh (items padded from
    300 to 512 rows) is the mesh-less engine's initial state, every slot
    table and accum row included; and in one process
    ``shard_train_state`` / ``gather_train_state`` round-trip them over a
    (1, 1) mesh whose item padding is 126 rows."""
    shape, ranks = jobs((2, 2))
    train, _ = synthetic_click_dataset(**DATA)
    for run, cfg in (("adam_untrained", CONFIGS["adam_tile"]),
                     ("accum_untrained", CONFIGS["accum"])):
        c = CFConfig(**cfg)
        c.num_users, c.num_items = train.num_users, train.num_items
        want = init_train_state(c, torch.Generator().manual_seed(c.seed), "cpu")
        for r in ranks:
            got = r[run]["state"]
            for f in dataclasses.fields(want):
                value = getattr(want, f.name)
                if isinstance(value, dict):
                    assert set(got[f.name]) == set(value)
                    for k, t in value.items():
                        np.testing.assert_array_equal(got[f.name][k], t.numpy())
                elif value is not None:
                    np.testing.assert_array_equal(got[f.name], value.numpy())


@pytest.mark.parametrize("cfg", [CONFIGS["adam_tile"], CONFIGS["accum"]],
                         ids=["adam", "accum"])
def test_layout_round_trip_in_one_process(cfg):
    mesh = make_mesh(1, 1, device="cpu")
    try:
        c = CFConfig(**cfg)
        c.num_users, c.num_items = 10, 130
        state = init_train_state(c, torch.Generator().manual_seed(0), "cpu")
        for t in [state.user_emb, state.item_emb, state.user_gacc,
                  state.item_gacc, *(state.opt_slots or {}).values()]:
            if t is not None:
                t.normal_()
        sh = table_shards(mesh, 10, 130)
        local = shard_train_state(state, sh)
        assert sh.item_rows == 128 + 128
        pad = [local.item_emb, local.item_gacc,
               *[v for k, v in (local.opt_slots or {}).items()
                 if k.startswith("item")]]
        for t in pad:
            if t is not None:
                assert t.shape[0] == 256 and not t[130:].any()
        back = gather_train_state(local, sh)
        for f in dataclasses.fields(state):
            a, b = getattr(state, f.name), getattr(back, f.name)
            if isinstance(a, dict):
                assert set(a) == set(b)
                assert all(torch.equal(a[k], b[k]) for k in a)
            elif a is None:
                assert b is None
            else:
                assert torch.equal(a, b)
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# The sharded step against the JAX package's, with injected state and draws.


def _injected_case(overrides: dict, steps: int):
    """The injected state (the JAX package's initial state of
    ``overrides``, slots, accum rows and ``attn_q`` included), global batch
    (repeated users and items, a weight-0 tail on each data shard),
    histories and uniform draws for ``steps`` steps; lr 0.05 and a clip
    of 0.02 that binds. Returns (arrays, the config's keywords, the JAX
    initial state)."""
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
    his = rng.integers(0, i, (u, h)).astype(np.int32)
    masks = rng.integers(0, h + 1, u).astype(np.int32)
    masks[:2] = [0, h]  # an empty history and a full one
    draws = rng.integers(0, i, ((steps + 2) * b, k)).astype(np.int32)
    jstate0 = jinit(JCFConfig(**kw), jax.random.key(1))
    arrays = {"user_emb": np.asarray(jstate0.user_emb),
              "item_emb": np.asarray(jstate0.item_emb),
              "w0": np.asarray(jstate0.w0), "his": his, "masks": masks,
              "users": users, "pos": pos, "weight": weight, "draws": draws}
    for name in ("user_gacc", "item_gacc", "attn_q"):
        if getattr(jstate0, name) is not None:
            arrays[name] = np.asarray(getattr(jstate0, name))
    if jstate0.opt_slots is not None:
        arrays["opt_slots"] = {key: np.asarray(v)
                               for key, v in jstate0.opt_slots.items()}
    return arrays, kw, jstate0


def _jax_steps22(arrays: dict, kw: dict, jstate0, steps: int):
    """The JAX step on the conftest's virtual (2, 2) mesh from the injected
    state, the draws pinned at the sampler's count: (the state after each
    step, the losses, the sampler state)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import heat_tpu.train.train_step as jts
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.parallel.mesh import make_mesh as jmake_mesh
    from heat_tpu.parallel.mesh import shard_data_arrays, shard_train_state as jshard
    from heat_tpu.train.samplers import NegSample as JNegSample
    from heat_tpu.train.samplers import init_sampler_state as jinit_sampler

    jcfg = JCFConfig(**kw)
    mesh = jmake_mesh(2, 2, jax.devices()[:4])
    jstate = jshard(jstate0, mesh)
    jhis, jmasks = shard_data_arrays(mesh, jnp.asarray(arrays["his"]),
                                     jnp.asarray(arrays["masks"]))
    bsh = NamedSharding(mesh, P("data"))
    jbatch = jts.Batch(*(jax.device_put(jnp.asarray(arrays[x]), bsh)
                         for x in ("users", "pos", "weight")))
    table = jnp.asarray(arrays["draws"])

    def pinned(key, sstate, pos_ids, cfg, real=None):
        idx = sstate.iterations + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)
        adv = pos_ids.shape[0] if real is None else real
        return JNegSample(table[idx], None, None), sstate.replace(
            iterations=sstate.iterations + adv)

    orig, jts.sample_negatives = jts.sample_negatives, pinned
    try:
        jss = jinit_sampler(jcfg, jax.random.key(2))
        jstates, jlosses = [], []
        for _ in range(steps):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3), jbatch, jhis, jmasks, jcfg)
            jstates.append(jstate)
            jlosses.append(float(jloss))
    finally:
        jts.sample_negatives = orig
    assert "data" in str(jstate.user_emb.sharding)
    return jstates, jlosses, jss


def injected_against_jax(overrides: dict, steps: int = 2):
    """``steps`` steps of the port's (2, 2) mesh (``rank_steps_injected``)
    and of the JAX step on the conftest's virtual (2, 2) mesh from one
    injected case (:func:`_injected_case`), the uniform draws pinned at
    the sampler's count. Returns (the ranks' results, the JAX state, the
    JAX losses, the JAX sampler state)."""
    arrays, kw, jstate0 = _injected_case(overrides, steps)
    cfg_kw = {k2: v for k2, v in kw.items() if k2 not in ("num_users", "num_items")}
    ranks = mc.spawn_ranks(mc.rank_steps_injected, 4, (2, 2), arrays, cfg_kw,
                           steps, "cpu", timeout=TIMEOUT)
    jstates, jlosses, jss = _jax_steps22(arrays, kw, jstate0, steps)
    return ranks, jstates[-1], jlosses, jss


def hold_to_jax(ranks, jstate, jlosses, jss, lr=0.05, clip_val=0.02):
    """Every rank's losses (rtol 1e-5 / atol 1e-7), counters and global
    state against the JAX step's, every array (tables, ``w0``, ``attn_q``,
    slots, accum rows) by the rule the single-card branches are held to
    against JAX (``heat_tpu_torch.testing.assert_state_array_close``:
    rtol 1e-5 / atol 1e-7 on 99.5% of the elements, none off by more than
    1e-4 x lr, or 1e-3 x clip_val for arrays of gradients); replicas
    bit-equal."""
    from heat_tpu_torch.testing import assert_state_array_close

    def close(got, want, name):
        assert_state_array_close(got, np.asarray(want), name, lr=lr,
                                 clip_val=clip_val)

    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5, atol=1e-7)
        assert r["iterations"] == int(jss.iterations)
        for name in ("user_emb", "item_emb", "w0", "user_gacc", "item_gacc",
                     "attn_q"):
            want = getattr(jstate, name)
            assert (want is None) == (name not in r["state"]), name
            if want is not None:
                close(r["state"][name], want, name)
        slots = jstate.opt_slots or {}
        assert set(slots) == set(r["state"].get("opt_slots") or {})
        for key, want in slots.items():
            close(r["state"]["opt_slots"][key], want, key)
        assert int(r["state"]["step"]) == int(jstate.step)
    mc.check_replicas([r["replicas"] for r in ranks])


def test_sharded_adam_steps_match_jax():
    """Adam's first two steps on (2, 2) against the JAX step: the bias
    correction reads the step advanced before the updates (the mesh once
    advanced it after them, and corrected with the previous count: a
    division by 1 - beta^0 = 0 at the first step), on the tables, ``w0``
    and every moment. Two steps, as the single-card Adam branch is held to
    JAX (``tests/test_torch_step.py``): at a third, 2 of w0's 256
    elements leave rtol 1e-5 by up to 8.6e-7 on a world of one as on
    (2, 2) (measured; the mesh and the world of one 9e-8 apart), noise of
    the two packages' summation orders that Adam divides by its own
    norm."""
    ranks, jstate, jlosses, jss = injected_against_jax(
        {"optimizer": "adam"}, steps=2)
    assert int(jstate.step) == 2
    hold_to_jax(ranks, jstate, jlosses, jss)


ACCUM_STEPS = 8  # accum on (2, 2) against JAX: steps 1-2 by the cap, 3-8 by the spread rule
ORDERS = 5  # reordered runs of the port for the spread rule
ACCUM_KEYS = ("user_emb", "item_emb", "w0", "user_gacc", "item_gacc")


def test_sharded_accum_steps_match_jax():
    """``sgd_mode: accum`` on (2, 2) over ACCUM_STEPS = 8 steps against
    the JAX step: the persistent rows (user rows decayed by gamma, item
    rows by 1.0) and the stale accumulated term of ``w0``'s gradient from
    the second step on, the clip binding on the accumulated rows. After
    step 2 every array is held to the rule of :func:`hold_to_jax` and the
    losses of steps 1-2 to rtol 1e-5. From step 3 on, where the rows of a
    repeated user, whose per-occurrence gradients of ~1e2 cancel, leave
    that rule's cap on a world of one too (3.7e-5 against 2e-5, measured;
    2.4e-5 on (2, 2)), every array and the loss are held by the spread
    rule (``heat_tpu_torch.testing.hold_by_order_spread``): within
    SPREAD_MULTIPLE = 4 times the largest difference among ORDERS + 1
    (2, 2) runs of the port that differ only in the order of their sums
    (``Order``: the samples permuted within each data shard with their
    pinned draws, each sample's negatives permuted, the latent axis
    permuted), the multiple stated before the first measurement; the
    replicas bit-equal and the counters exact in every run."""
    import threading

    from heat_tpu_torch.testing import Order, hold_by_order_spread

    arrays, kw, jstate0 = _injected_case({"sgd_mode": "accum"}, ACCUM_STEPS)
    cfg_kw = {k2: v for k2, v in kw.items() if k2 not in ("num_users", "num_items")}
    b, k = arrays["users"].shape[0], arrays["draws"].shape[1]
    orders = [Order(n, b, k, kw["emb_dim"], blocks=2) for n in range(ORDERS + 1)]
    calls = []
    for order in orders:
        case = dict(arrays, **order.state({key: arrays[key] for key in ACCUM_KEYS}))
        case.update({x: arrays[x][order.samples] for x in ("users", "pos", "weight")})
        case["draws"] = np.ascontiguousarray(arrays["draws"][:, order.negs])
        calls.append(("rank_steps_injected",
                      ((2, 2), case, cfg_kw, ACCUM_STEPS, "cpu"),
                      {"perm": order.samples, "every_step": True}))
    box = {}

    def job():
        try:
            box["ranks"] = mc.spawn_ranks(mc.rank_calls, 4, calls, timeout=TIMEOUT)
        except BaseException as err:  # raised again below
            box["error"] = err

    thread = threading.Thread(target=job)
    thread.start()
    try:
        jstates, jlosses, jss = _jax_steps22(arrays, kw, jstate0, ACCUM_STEPS)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    want = [{key: np.asarray(getattr(js, key)) for key in ACCUM_KEYS}
            for js in jstates]
    assert np.abs(want[-1]["user_gacc"]).max() >= 0.02 - 1e-9  # clipped
    from heat_tpu_torch.testing import assert_state_array_close

    for r in (r[0] for r in ranks):
        np.testing.assert_allclose(r["losses"][:2], jlosses[:2], rtol=1e-5,
                                   atol=1e-7)
        for key in ACCUM_KEYS:
            assert_state_array_close(r["states"][1][key], want[1][key], key,
                                     lr=0.05, clip_val=0.02)
    runs = [(r["losses"], [order.restore(st) for st in r["states"]])
            for order, r in zip(orders, ranks[0])]
    hold_by_order_spread(runs, (jlosses, want))
    for n in range(len(orders)):
        mc.check_replicas([r[n]["replicas"] for r in ranks])
        for r in ranks:
            assert r[n]["iterations"] == int(jss.iterations)
            assert int(r[n]["state"]["step"]) == int(jstates[-1].step) == ACCUM_STEPS
            for key in ACCUM_KEYS:  # every rank gathers the same state
                np.testing.assert_array_equal(r[n]["state"][key],
                                              ranks[0][n]["state"][key])


def test_sharded_adagrad_steps_match_jax():
    ranks, jstate, jlosses, jss = injected_against_jax(
        {"optimizer": "adagrad"}, steps=2)
    hold_to_jax(ranks, jstate, jlosses, jss)


# ---------------------------------------------------------------------------
# Checkpoints that move between meshes mid-run.

CKPT_RUNS = {"adam": CONFIGS["adam_tile"], "accum": CONFIGS["accum"],
             # attn_q and its moments ride the checkpoint too.
             "adam_self_attention": dict(BASE, optimizer="adam",
                                         aggregator="self_attention")}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A (2, 2) run of two epochs under Adam, under accum and under Adam
    with self-attention, each saving after its first epoch, then each
    restored on (4, 1): the restored state alone, and the second
    epoch."""
    base = tmp_path_factory.mktemp("ckpt")
    dirs = {name: str(base / name) for name in CKPT_RUNS}
    run22 = mc.spawn_ranks(mc.rank_runs, 4, (2, 2), DATA, {
        name: (cfg, 2, {"save_dir": dirs[name], "save_after": 1})
        for name, cfg in CKPT_RUNS.items()}, "cpu", evaluate=False,
        timeout=TIMEOUT)
    runs41 = {}
    for name, cfg in CKPT_RUNS.items():
        runs41[name] = (cfg, 1, {"restore_dir": dirs[name]})
        runs41[name + "_restored"] = (cfg, 0, {"restore_dir": dirs[name]})
    run41 = mc.spawn_ranks(mc.rank_runs, 4, (4, 1), DATA, runs41, "cpu",
                           evaluate=False, timeout=TIMEOUT)
    return dirs, run22, run41


@pytest.mark.parametrize("name", sorted(CKPT_RUNS))
def test_checkpoints_move_between_meshes_mid_run(checkpoints, name):
    """Saved on (2, 2) after the first of two epochs, the file holds the
    global state; restored on (4, 1) every rank gathers exactly that state
    back (the tables, the slots or accum rows, ``w0``, ``attn_q`` and its
    moments, ``step``: Adam's bias correction resumes at its count). Restored on one rank (laid out
    as two data shards) it resumes the (2, 2) run's second epoch;
    restored on (4, 1) it equals a one-rank run laid out as four data
    shards and restored from the same file. Losses rtol 5e-4 at lr 0.005;
    a wrong restore is off by far more."""
    import os

    from heat_tpu_torch.models.state import TrainState, state_to_numpy

    dirs, run22, run41 = checkpoints
    cfg = CKPT_RUNS[name]
    saved = torch.load(os.path.join(dirs[name], "ckpt_1.pt"), weights_only=True)
    want = state_to_numpy(TrainState(**saved["state"]))
    assert want.get("opt_slots") or want.get("user_gacc") is not None
    for r in (r[name + "_restored"] for r in run41):
        got = r["state"]
        assert r["restored"] == 1 and set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, dict):
                assert set(got[key]) == set(value)
                for k, v in value.items():
                    np.testing.assert_array_equal(got[key][k], v, err_msg=k)
            else:
                np.testing.assert_array_equal(got[key], value, err_msg=key)
    one = mc.train_oracle(2, DATA, cfg, 1, "cpu", restore_dir=dirs[name],
                          evaluate=False, n_model=2)
    assert one["restored"] == 1
    first = run22[0][name]
    np.testing.assert_allclose(one["losses"], first["losses"][1:], rtol=5e-4)
    assert int(one["state"]["step"]) == first["steps"]
    one4 = mc.train_oracle(4, DATA, cfg, 1, "cpu", restore_dir=dirs[name],
                           evaluate=False)
    for r in (r[name] for r in run41):
        assert r["restored"] == 1 and r["steps"] > first["steps"] // 2
        np.testing.assert_allclose(r["losses"], one4["losses"], rtol=5e-4)
        assert int(r["state"]["step"]) == int(one4["state"]["step"])
    mc.check_replicas([r[name]["replicas"] for r in run41])
    mc.check_replicas([r[name]["replicas"] for r in run22])
