"""The port on a ("data", "model") mesh of ranks (ROADMAP item 15a), held
against the single-rank port and the JAX package.

Each multi-rank case runs its ranks as processes of a gloo job on the CPU
(``torch_mesh_support.spawn_ranks``, a free localhost port, a timeout of
240 s). The single-rank oracle is an engine that lays its batch stream
out as the mesh does (``Engine._shard_stream(n_data)``): it steps
the mesh's global batches with the mesh's draws, so a mesh run equals it
up to summation order. Tolerances, those of ``tests/test_sharding.py``'s
sharded step against one device: the loss rtol 1e-5, user rows rtol 1e-4
/ atol 5e-6, item rows rtol 1e-2 / atol 2e-6 (the partial history means
of the model shards sum in another order than one rank's). Replicas are
held bit-equal (their SHA-256 over each group).
"""

import dataclasses

import numpy as np
import pytest
import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.evaluation.metrics import (
    device_metric_sums,
    evaluate_metrics,
    evaluate_sim_matrix,
    pad_truth,
)
from heat_tpu_torch.models.state import TrainState
from heat_tpu_torch.parallel import distributed
from heat_tpu_torch.parallel.mesh import (
    default_mesh_shape,
    gather_train_state,
    make_mesh,
    shard_train_state,
    sharded_item_rows,
    field_axis,
    table_shards,
)
from heat_tpu_torch.serving import Recommender
from heat_tpu_torch.models.state import state_from_numpy
from heat_tpu_torch.train.engine import Engine

import torch_mesh_support as mc

DATA = dict(num_users=128, num_items=256, clicks_per_user=20, max_his=8, seed=9)
CFG = dict(emb_dim=16, num_negs=4, max_his=8, l_r=0.05, batch_size=128,
           milestones=[10], seed=3, metrics=["Recall(k=20)", "NDCG(k=50)"])
ONE_STEP = dict(CFG, batch_size=1 << 12)  # every pair in one global batch
# Several steps an epoch. At lr 0.05 summation-order noise grows
# chaotically (test_several_epochs_are_chaotic_at_lr_0p05), so
# trajectories are compared at lr 0.005.
EPOCHS = dict(CFG, l_r=0.005)
SHAPES = [(2, 1), (1, 2), (2, 2)]
SERVE = [0, 7, 63, 64, 100, 127]  # users of every data shard


def _close_states(got, want):
    np.testing.assert_allclose(got["user_emb"], want["user_emb"],
                               rtol=1e-4, atol=5e-6)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"],
                               rtol=1e-2, atol=2e-6)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def one_step(request, tmp_path_factory):
    """One global step of every pair on a mesh (with the export and
    from_engine), and the single-rank oracle's."""
    shape = request.param
    out = tmp_path_factory.mktemp("export") / "emb.npz"
    ranks = mc.spawn_ranks(mc.rank_train, shape[0] * shape[1], shape, DATA,
                           ONE_STEP, 1, "cpu", export_path=str(out),
                           serve_users=SERVE)
    oracle = mc.train_oracle(shape[0], DATA, ONE_STEP, 1, "cpu")
    return shape, ranks, oracle, out


def test_mesh_step_equals_one_rank(one_step):
    shape, ranks, oracle, _ = one_step
    for r in ranks:
        assert r["steps"] == 1
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=1e-5)
        _close_states(r["state"], oracle["state"])
        np.testing.assert_allclose(r["state"]["w0"], oracle["state"]["w0"],
                                   rtol=1e-4, atol=5e-6)
        for m, v in oracle["metrics"].items():
            np.testing.assert_allclose(r["metrics"][m], v, atol=1e-6)
    mc.check_replicas([r["replicas"] for r in ranks])
    # Every rank gathers the same global state.
    for r in ranks[1:]:
        for name in ("user_emb", "item_emb", "w0"):
            np.testing.assert_array_equal(r["state"][name], ranks[0]["state"][name])


def test_mesh_export_and_from_engine(one_step):
    shape, ranks, _, path = one_step
    z = np.load(path)
    st = ranks[0]["state"]
    assert z["item_emb"].shape == (DATA["num_items"], CFG["emb_dim"])
    for name in ("user_emb", "item_emb", "w0"):
        np.testing.assert_array_equal(z[name], st[name])
    # from_engine on the mesh serves what one Recommender over the gathered
    # tables and all the train pairs serves, on every rank.
    train, _ = synthetic_click_dataset(**DATA)
    cfg = CFConfig(**CFG)
    cfg.num_users, cfg.num_items = DATA["num_users"], DATA["num_items"]
    rec = Recommender(
        state_from_numpy(st["user_emb"], st["item_emb"], st["w0"], lr=0.0,
                         step=0, device="cpu"),
        cfg, seen_pairs=train.pairs, his_items=train.his_items,
        his_masks=train.masks)
    want = rec.recommend(SERVE, 10)
    for r in ranks:
        np.testing.assert_array_equal(r["served"], want)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_mesh_epochs_equal_one_rank(shape):
    """Two epochs of several steps and an evaluation, on the mesh and on
    its single-rank oracle, at lr 0.005 (``EPOCHS``): losses rtol 5e-4,
    what a 1e-7 change of the initial tables stays within there
    (``test_several_epochs_are_chaotic_at_lr_0p05``); metrics within
    0.02."""
    ranks = mc.spawn_ranks(mc.rank_train, shape[0] * shape[1], shape, DATA,
                           EPOCHS, 2, "cpu")
    oracle = mc.train_oracle(shape[0], DATA, EPOCHS, 2, "cpu")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], oracle["losses"], rtol=5e-4)
        assert r["losses"][1] < r["losses"][0]
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 0.02, (m, r["metrics"][m], v)
    mc.check_replicas([r["replicas"] for r in ranks])


def test_model_shards_equal_one_rank_summing_their_partial_means():
    """On (1, 2) the mesh changes one summation order by design: each item
    shard's K1 gives a partial mean and the model group adds them. A single
    rank that pools its means that way (``torch_mesh_support.PartialMeans``) steps
    bit for bit as the mesh does, three epochs at lr 0.05, where the plain
    single rank drifts apart chaotically."""
    ranks = mc.spawn_ranks(mc.rank_train, 2, (1, 2), DATA, CFG, 3, "cpu",
                           evaluate=False, step_losses=64)
    oracle = mc.train_oracle(1, DATA, CFG, 3, "cpu", evaluate=False,
                             step_losses=64, n_model=2)
    for r in ranks:
        np.testing.assert_array_equal(r["step_losses"], oracle["step_losses"])
        for name in ("user_emb", "item_emb", "w0"):
            np.testing.assert_array_equal(r["state"][name], oracle["state"][name])
    mc.check_replicas([r["replicas"] for r in ranks])


def test_several_epochs_are_chaotic_at_lr_0p05():
    """Why the multi-epoch comparisons run at lr 0.005 (``EPOCHS``): one rank
    against itself with the initial item table scaled by 1 + 1e-7, the
    size of a summation-order difference. At lr 0.05 the second epoch's
    loss moves by more than 1e-3; at lr 0.005 by less than 5e-4, the
    tolerance the mesh is held to there."""
    train, test = synthetic_click_dataset(**DATA)
    moved = {}
    for lr in (0.05, 0.005):
        losses = []
        for scale in (1.0, 1.0 + 1e-7):
            engine = Engine(CFConfig(**dict(CFG, l_r=lr)), train, test,
                            device="cpu")
            engine._shard_stream(2)
            engine.state.item_emb.mul_(scale)
            losses.append([engine.train_one_epoch() for _ in range(2)])
        moved[lr] = abs(losses[1][1] / losses[0][1] - 1.0)
    assert moved[0.05] > 1e-3 and moved[0.005] < 5e-4, moved


def test_sharded_step_matches_jax():
    """The port's (2, 2) step against the JAX package's step on the
    conftest's virtual (2, 2) mesh: one injected state, global batch
    (repeated users and items, a weight-0 tail on each data shard) and
    draws, two steps; rtol 1e-5 / atol 1e-7 as tests/test_torch_step.py
    (the model shards' partial means sum in another order)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import heat_tpu.train.train_step as jts
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.models.state import init_train_state as jinit
    from heat_tpu.parallel.mesh import make_mesh as jmake_mesh
    from heat_tpu.parallel.mesh import shard_data_arrays, shard_train_state as jshard
    from heat_tpu.train.samplers import NegSample as JNegSample
    from heat_tpu.train.samplers import init_sampler_state as jinit_sampler

    rng = np.random.default_rng(0)
    u, i, h, b, k, d = 40, 90, 8, 48, 4, 16
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=0.05, clip_val=0.02, seed=0)
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
    draws = rng.integers(0, i, (4 * b, k)).astype(np.int32)
    jcfg = JCFConfig(**kw)
    jstate0 = jinit(jcfg, jax.random.key(1))
    arrays = {"user_emb": np.asarray(jstate0.user_emb),
              "item_emb": np.asarray(jstate0.item_emb),
              "w0": np.asarray(jstate0.w0), "his": his, "masks": masks,
              "users": users, "pos": pos, "weight": weight, "draws": draws}
    cfg_kw = {k2: v for k2, v in kw.items() if k2 not in ("num_users", "num_items")}
    ranks = mc.spawn_ranks(mc.rank_steps_injected, 4, (2, 2), arrays, cfg_kw,
                           2, "cpu")

    mesh = jmake_mesh(2, 2, jax.devices()[:4])
    jstate = jshard(jstate0, mesh)
    jhis, jmasks = shard_data_arrays(mesh, jnp.asarray(his), jnp.asarray(masks))
    bsh = NamedSharding(mesh, P("data"))
    jbatch = jts.Batch(*(jax.device_put(jnp.asarray(x), bsh)
                         for x in (users, pos, weight)))
    table = jnp.asarray(draws)

    def pinned(key, sstate, pos_ids, cfg, real=None):
        idx = sstate.iterations + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)
        adv = pos_ids.shape[0] if real is None else real
        return JNegSample(table[idx], None, None), sstate.replace(
            iterations=sstate.iterations + adv)

    orig, jts.sample_negatives = jts.sample_negatives, pinned
    try:
        jss = jinit_sampler(jcfg, jax.random.key(2))
        jlosses = []
        for _ in range(2):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3), jbatch, jhis, jmasks, jcfg)
            jlosses.append(float(jloss))
    finally:
        jts.sample_negatives = orig
    assert "data" in str(jstate.user_emb.sharding)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5, atol=1e-7)
        assert r["iterations"] == int(jss.iterations) == 2 * int(weight.sum())
        for name in ("user_emb", "item_emb", "w0"):
            np.testing.assert_allclose(
                r["state"][name], np.asarray(getattr(jstate, name)),
                rtol=1e-5, atol=1e-7, err_msg=name)
        assert int(r["state"]["step"]) == int(jstate.step) == 2


def test_sharded_topk_and_metric_sums():
    """sharded_topk on (2, 2) with 126 items (padded to 256, 128 a shard)
    against the dense oracle ``evaluate_sim_matrix``, tie aware (the
    k-th score's ties may resolve either way), and the mesh's
    ``device_metric_sums`` against ``evaluate_metrics`` within 1e-6."""
    train, test = synthetic_click_dataset(num_users=64, num_items=126,
                                          clicks_per_user=12, max_his=6, seed=7)
    rng = np.random.default_rng(1)
    ue = rng.standard_normal((64, 8)).astype(np.float32)
    ie = rng.standard_normal((126, 8)).astype(np.float32)
    ie[40] = ie[41]  # tied scores
    metrics, k = ["Recall(k=20)", "NDCG(k=20)", "HitRate(k=10)"], 20
    ranks = mc.spawn_ranks(mc.rank_topk, 4, (2, 2), ue, ie, train.pairs,
                           test.user_items, k, metrics, "cpu")
    scores = np.concatenate([r["scores"] for r in ranks if r["index"][1] == 0])
    ids = np.concatenate([r["ids"] for r in ranks if r["index"][1] == 0])
    for r in ranks:  # the model group's ranks merge alike
        mate = next(q for q in ranks if q["index"] == (r["index"][0], 0))
        np.testing.assert_array_equal(r["ids"], mate["ids"])
    sim = ue @ ie.T
    masked = sim.copy()
    for u_, items in enumerate(train.user_items):
        masked[u_, np.asarray(items, np.int64)] = -np.inf
    want = -np.sort(-masked, axis=1)[:, :k]
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-6)
    kth = want[:, -1:]
    got_scores = np.take_along_axis(masked, ids.astype(np.int64), axis=1)
    np.testing.assert_allclose(got_scores, scores, rtol=1e-5, atol=1e-6)
    assert (ids < 126).all()
    oracle_ids = np.argsort(-masked, axis=1, kind="stable")[:, :k]
    strict = want > kth + 1e-6  # above the k-th score: no tie can move them
    for row in range(64):
        assert set(oracle_ids[row][strict[row]]) <= set(ids[row])
    want_m = evaluate_sim_matrix(metrics, sim, train.user_items, test.user_items)
    got_m = evaluate_metrics(metrics, ids, test.user_items)
    sums = ranks[0]["sums"]
    for j, m in enumerate(metrics):
        np.testing.assert_allclose(sums[j] / sums[-1], got_m[m], atol=1e-6)
        np.testing.assert_allclose(got_m[m], want_m[m], atol=1e-6)


def test_evaluation_falls_back_to_the_gathered_items():
    """A k above the items of a shard (Recall@200 over 300 items on four
    model shards of 128 rows) takes ``_evaluate_multiprocess_allgather``:
    the item table gathered over the model group. On the untrained state
    (the same on the mesh and on one rank) it equals the single-rank
    evaluation within 1e-6."""
    data = dict(num_users=64, num_items=300, clicks_per_user=12, max_his=6,
                seed=7)
    cfg = dict(emb_dim=8, num_negs=4, max_his=6, batch_size=32, seed=3,
               metrics=["Recall(k=200)", "NDCG(k=20)"])
    ranks = mc.spawn_ranks(mc.rank_train, 4, (1, 4), data, cfg, 0, "cpu")
    oracle = mc.train_oracle(1, data, cfg, 0, "cpu")
    for r in ranks:
        for m, v in oracle["metrics"].items():
            assert abs(r["metrics"][m] - v) <= 1e-6, (m, r["metrics"][m], v)


def test_device_metric_sums_without_a_mesh():
    rng = np.random.default_rng(3)
    top = rng.integers(0, 50, (30, 20)).astype(np.int32)
    truth_items = [rng.choice(50, rng.integers(0, 5), replace=False)
                   for _ in range(30)]
    metrics = ["Recall(k=20)", "NDCG(k=10)", "MRR(k=20)", "Precision(k=5)"]
    truth, truth_len = pad_truth(truth_items)
    sums = device_metric_sums(metrics, torch.as_tensor(top),
                              torch.as_tensor(truth), torch.as_tensor(truth_len))
    want = evaluate_metrics(metrics, top, truth_items)
    assert sums[-1] == sum(1 for t in truth_items if len(t))
    for j, m in enumerate(metrics):
        np.testing.assert_allclose(sums[j] / sums[-1], want[m], atol=1e-6)


def test_checkpoints_move_between_meshes(tmp_path):
    """A (2, 2) run saves after its first of two epochs. Restored on one
    rank (laid out as two data shards) it resumes the (2, 2) run's second
    epoch; restored on (4, 1) it equals a one-rank run laid out as four
    data shards and restored from the same file. Losses rtol 5e-4 at lr
    0.005 (``EPOCHS``); a wrong restore is off by far more."""
    ck = str(tmp_path / "ck")
    run22 = mc.spawn_ranks(mc.rank_train, 4, (2, 2), DATA, EPOCHS, 2, "cpu",
                           save_dir=ck, save_after=1, evaluate=False)
    one = mc.train_oracle(2, DATA, EPOCHS, 1, "cpu", restore_dir=ck,
                          evaluate=False)
    assert one["restored"] == 1
    np.testing.assert_allclose(one["losses"], run22[0]["losses"][1:], rtol=5e-4)
    run41 = mc.spawn_ranks(mc.rank_train, 4, (4, 1), DATA, EPOCHS, 1, "cpu",
                           restore_dir=ck, evaluate=False)
    one4 = mc.train_oracle(4, DATA, EPOCHS, 1, "cpu", restore_dir=ck,
                           evaluate=False)
    for r in run41:
        assert r["restored"] == 1 and r["steps"] > run22[0]["steps"] // 2
        np.testing.assert_allclose(r["losses"], one4["losses"], rtol=5e-4)
    mc.check_replicas([r["replicas"] for r in run41])


# ---------------------------------------------------------------------------
# The plain versions under ids outside a table, as a shard's step has them.


def test_plain_gathers_follow_the_kernels_range_contract():
    """gather.cu's contract, which the mesh's shards rely on: an id outside
    [0, N) reads zeros (K2, its multi entry, S2) and is left out of K1's
    sum, which still divides by the whole length. Held against the Pallas
    kernels in interpret mode, which clamp or fault out of range: K2 on
    the in-range part, K1 over the table with one zero row appended, where
    every outside id is sent (the same sum, term for term)."""
    from heat_tpu.ops.pallas.gather import gather_rows as pallas_gather
    from heat_tpu.ops.pallas.gather import history_mean_gather as pallas_mean

    from heat_tpu_torch.ops.cuda import gather

    rng = np.random.default_rng(5)
    n, d = 200, 128
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-n, 2 * n, 300).astype(np.int32)
    ids[:4] = [-1, n, 0, n - 1]
    inside = (ids >= 0) & (ids < n)
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    want = np.asarray(pallas_gather(table, np.where(inside, ids, 0),
                                    interpret=True))
    np.testing.assert_array_equal(got.numpy()[inside], want[inside])
    assert not got.numpy()[~inside].any()
    multi = gather.gather_rows_multi(
        [(torch.from_numpy(table), torch.from_numpy(ids))] * 2, torch.bfloat16)
    assert all(torch.equal(m, got.bfloat16()) for m in multi)
    his = rng.integers(-n // 2, n + n // 2, (40, 7)).astype(np.int32)
    lens = rng.integers(0, 8, 40).astype(np.int32)
    lens[:2] = [0, 7]
    his_z = np.where((his >= 0) & (his < n), his, n)
    table_z = np.concatenate([table, np.zeros((1, d), np.float32)])
    want = np.asarray(pallas_mean(table_z, his_z, lens, interpret=True))
    got = gather.history_mean_gather(torch.from_numpy(table),
                                     torch.from_numpy(his), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    blocks = gather.gather_blocks(torch.from_numpy(table),
                                  torch.tensor([1, -1, 50, 3], dtype=torch.int32), 4)
    view = table.reshape(50, 4 * d)
    np.testing.assert_array_equal(blocks.numpy()[:4], view[1].reshape(4, d))
    np.testing.assert_array_equal(blocks.numpy()[12:], view[3].reshape(4, d))
    assert not blocks.numpy()[4:12].any()


# ---------------------------------------------------------------------------
# In this process: a world of one (gloo on the CPU).


@pytest.fixture(scope="module")
def mesh11():
    mesh = make_mesh(1, 1, device="cpu")
    yield mesh
    distributed.shutdown()


def test_mesh_layout_and_its_errors(mesh11):
    assert mesh11.shape == (1, 1) and mesh11.backend == "gloo"
    assert mesh11.device == torch.device("cpu")
    assert default_mesh_shape(8) == (2, 4) and default_mesh_shape(2) == (1, 2)
    assert sharded_item_rows(126, 2) == 256 and sharded_item_rows(256, 1) == 256
    assert distributed.choose_backend("cuda", 4, 1) == "gloo"
    assert distributed.choose_backend("cuda", 4, 4) == "nccl"
    assert distributed.choose_backend("cpu", 1, 0) == "gloo"
    with pytest.raises(ValueError, match="mesh 2x2 != 1 ranks"):
        make_mesh(2, 2, device="cpu")
    sh = table_shards(mesh11, 10, 130)
    assert (sh.user_lo, sh.user_rows, sh.item_lo, sh.item_rows) == (0, 10, 0, 256)
    g = torch.Generator().manual_seed(0)
    state = TrainState(
        user_emb=torch.randn(10, 4, generator=g),
        item_emb=torch.randn(130, 4, generator=g), w0=torch.randn(4, 4),
        lr=torch.tensor(0.1), step=torch.tensor(3, dtype=torch.int32),
        opt_slots={"user_v": torch.ones(10, 4), "item_v": torch.ones(130, 4),
                   "w0_v": torch.ones(4, 4)})
    assert [field_axis(n) for n in (
        "user_emb", "user_gacc", "user_v", "item_emb", "item_m", "w0", "w0_v",
        "attn_q", "lr", "step")] == ["data"] * 3 + ["model"] * 2 + [None] * 5
    local = shard_train_state(state, sh)
    assert local.item_emb.shape == (256, 4) and not local.item_emb[130:].any()
    back = gather_train_state(local, sh)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        if isinstance(a, dict):
            for key in a:
                assert torch.equal(a[key], b[key])
        elif a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_data_axis_must_divide_users():
    class FakeMesh:
        shape, data_index, model_index = (2, 1), 0, 0

    with pytest.raises(ValueError, match="divisible by the data axis"):
        table_shards(FakeMesh(), 131, 256)


# Settings a mesh runs since ROADMAP item 15b points 3 and 4 (the attention
# aggregators, the Adagrad / Adam slots, accum mode), alone and on top of the
# fast path and sub-epochs (points 1 and 2). Each of them refused the fused
# epochs (point 6) and a shard on the sort-dedup update (point 5) until
# those points were ported; each now runs both (the ids keep their names).
TILE_BF16 = {"neg_sampler": 1, "tile_size": 16, "refresh_interval": 64,
             "his_refresh": "subepoch", "param_dtype": "bfloat16",
             "compute_dtype": "bfloat16"}
REFUSED = [
    ({"aggregator": "user_attention"}, "attention"),
    ({"aggregator": "self_attention"}, "attention"),
    ({**TILE_BF16, "update_mode": "direct", "aggregator": "user_attention"},
     "attention"),
    ({"shuffle_mode": "none", "aggregator": "self_attention"}, "attention"),
    ({"optimizer": "adam"}, "Adagrad / Adam"),
    ({"optimizer": "adagrad"}, "Adagrad / Adam"),
    ({**TILE_BF16, "num_subepochs": 2, "optimizer": "adagrad"},
     "Adagrad / Adam"),
    ({"sgd_mode": "accum"}, "accum"),
    ({"num_subepochs": 2, "sgd_mode": "accum"}, "accum"),
    ({"shuffle_mode": "once", "sgd_mode": "accum"}, "accum"),
]


def _digests(engine):
    return mc.state_digests(engine.state)


class _SortedCalls:
    """Counts the sort-dedup updates the steps make: the item shard's
    across the data group (``train_step.apply_row_updates_sorted_reduced``)
    and every table's sorted update (``scatter._apply_row_updates_sorted``
    and its Adagrad / Adam form: the user shard's and the item shard's)."""

    def __init__(self, monkeypatch):
        import heat_tpu_torch.train.scatter as tsc
        import heat_tpu_torch.train.train_step as ts

        self.calls = {"items": 0, "tables": 0}
        for mod, name, key in (
                (ts, "apply_row_updates_sorted_reduced", "items"),
                (tsc, "_apply_row_updates_sorted", "tables"),
                (tsc, "_apply_row_updates_opt_sorted", "tables")):
            monkeypatch.setattr(mod, name, self._counted(
                getattr(mod, name), key))

    def _counted(self, fn, key):
        def call(*args, **kw):
            self.calls[key] += 1
            return fn(*args, **kw)
        return call


@pytest.mark.parametrize("override,what", REFUSED,
                         ids=[w.replace(" ", "_") + str(i)
                              for i, (_, w) in enumerate(REFUSED)])
def test_mesh_refuses_item_15b(mesh11, monkeypatch, override, what):
    """The setting (``what``) on a mesh, with what ROADMAP item 15b's
    points 5 and 6 added: ``train_epochs(1)`` equals ``train_one_epoch()``
    of a twin engine bit for bit (the loss and every tensor of the
    state); and with DENSE_ROWS_THRESHOLD at 16 rows (20 user rows, 128
    item rows) it builds and steps, both shards on the sort-dedup update
    (the item shard through the data group's one all-gather) unless
    ``update_mode: direct``, which has no table-sized buffer."""
    import heat_tpu_torch.train.scatter as tsc

    train, test = synthetic_click_dataset(num_users=20, num_items=40,
                                          max_his=4, seed=1)

    def engine():
        return Engine(CFConfig(max_his=4, **override), train, test,
                      device="cpu", mesh=mesh11)

    fused, plain = engine(), engine()
    if what == "attention":
        assert fused.cfg.aggregator != "mean"
    assert fused.train_epochs(1) == [plain.train_one_epoch()]
    assert _digests(fused) == _digests(plain)
    monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    calls = _SortedCalls(monkeypatch).calls
    lowered = engine()
    assert lowered.shards.user_rows > 16 and lowered.shards.item_rows > 16
    assert np.isfinite(lowered.train_epochs(1)).all()
    direct = override.get("update_mode") == "direct"
    steps = int(lowered.state.step)
    assert steps > 0
    assert calls == ({"items": 0, "tables": 0} if direct
                     else {"items": steps, "tables": 2 * steps}), calls


def test_mesh_refuses_fused_epochs_and_the_sort_dedup(mesh11, monkeypatch):
    """config0's path on a (1, 1) mesh: ``train_epochs(2)`` and
    ``run_epochs_with_eval(2, 1)`` equal two ``train_one_epoch`` calls
    and the evaluation after the second (``reference_schedule``) on twin
    engines bit for bit; with DENSE_ROWS_THRESHOLD at 64 rows (the 128
    item rows above it) the item shard takes the sort-dedup update and
    equals a mesh-less engine at that threshold bit for bit (one rank:
    the same occurrences in the same order). A rank's data must hold
    global user ids."""
    import heat_tpu_torch.train.scatter as tsc

    train, test = synthetic_click_dataset(num_users=20, num_items=40,
                                          max_his=4, seed=1)

    def engine(mesh=mesh11):
        return Engine(CFConfig(max_his=4), train, test, device="cpu",
                      mesh=mesh)

    fused, run, plain = engine(), engine(), engine()
    assert not fused._capture and fused.shards.item_rows == 128
    want = [plain.train_one_epoch() for _ in range(2)]
    want_eval = [{"epoch": 1, **plain.evaluate()}]
    assert fused.train_epochs(2) == want
    assert run.run_epochs_with_eval(2, 1) == (want, want_eval)
    assert _digests(fused) == _digests(plain) == _digests(run)
    monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 64)
    calls = _SortedCalls(monkeypatch).calls
    sorted_mesh, sorted_one = engine(), engine(mesh=None)
    got = sorted_mesh.train_epochs(2)
    assert calls["items"] == int(sorted_mesh.state.step) > 0
    assert got == [sorted_one.train_one_epoch() for _ in range(2)]
    st = sorted_mesh.unpadded_state()
    assert torch.equal(st.item_emb, sorted_one.state.item_emb)
    assert torch.equal(st.user_emb, sorted_one.state.user_emb)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="rebase=False"):
        from heat_tpu_torch.data.datasets import shard_by_user_range

        # Half the users where the (1, 1) mesh's rank holds all of them.
        Engine(CFConfig(max_his=4),
               shard_by_user_range(train, 2, 1, rebase=False), test,
               device="cpu", mesh=mesh11)


def test_world_of_one_equals_no_mesh(mesh11):
    """A (1, 1) mesh steps exactly as the engine without one: the same
    stream, draws and arithmetic (the collectives are no-ops)."""
    train, test = synthetic_click_dataset(num_users=60, num_items=90,
                                          clicks_per_user=8, max_his=6, seed=2)
    kw = dict(emb_dim=8, num_negs=4, max_his=6, batch_size=64, seed=5,
              metrics=["Recall(k=20)"])
    a = Engine(CFConfig(**kw), train, test, device="cpu", mesh=mesh11)
    b = Engine(CFConfig(**kw), train, test, device="cpu")
    assert [a.train_one_epoch() for _ in range(2)] == [
        b.train_one_epoch() for _ in range(2)]
    st = a.unpadded_state()
    assert torch.equal(st.user_emb, b.state.user_emb)
    assert torch.equal(st.item_emb, b.state.item_emb)
    assert a.evaluate() == pytest.approx(b.evaluate(), abs=1e-6)
