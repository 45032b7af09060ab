"""The port's serving slice against the JAX package: two-phase exact top-k,
masked selection, the tiled evaluator's mask layouts, the aggregator's
whole-table pools, ``Recommender`` on its three request routes, and the
embedding export.

Both packages get the same seeded numpy inputs. Top-k results are compared
tie-aware: equal score lists, and equal id sets wherever the k-th score is
strictly above the (k+1)-th. On the CPU the port's kernel wrappers run
their plain versions (K4 ``window_extract_ref`` in every two-phase top-k).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.evaluation.evaluator as jev
import heat_tpu.serving as jserving
import heat_tpu_torch.evaluation.evaluator as tev
import heat_tpu_torch.serving as tserving
from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.export import export_embeddings as jexport
from heat_tpu.models import aggregator as jagg
from heat_tpu.models.state import TrainState as JTrainState
from heat_tpu_torch import main as tmain
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.export import export_embeddings, load_embeddings
from heat_tpu_torch.models import aggregator as tagg
from heat_tpu_torch.models.state import state_from_numpy
from heat_tpu_torch.ops.cuda import topk as ktopk
from heat_tpu_torch.train.engine import Engine as TEngine

NEG = np.finfo(np.float32).min
# Scores of two f32 GEMMs in different summation orders differ by ~1e-6 at
# these sizes; ranks apart by less than this count as tied.
TIE = 1e-5


def assert_same_topk(got, want, scores, k, min_strict=0.9):
    """got / want: (R, k+1) ranked ids; scores: (R, I) float64 scores of
    every item. Equal score lists (rtol 1e-6, atol 1e-6: the two packages'
    f32 GEMMs differ in the last bits), equal id sets in the first k ranks
    where the k-th score is above the (k+1)-th by more than TIE."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    sg = np.take_along_axis(scores, got, 1)
    sw = np.take_along_axis(scores, want, 1)
    np.testing.assert_allclose(sg, sw, rtol=1e-6, atol=1e-6)
    strict = sw[:, k - 1] > sw[:, k] + TIE
    assert strict.mean() >= min_strict
    for r in np.flatnonzero(strict):
        assert set(got[r, :k]) == set(want[r, :k]), r


def jstate(user, item, w0):
    return JTrainState(
        user_emb=jnp.asarray(user), item_emb=jnp.asarray(item),
        w0=jnp.asarray(w0), user_gacc=None, item_gacc=None,
        lr=jnp.float32(0.05), step=jnp.int32(0),
    )


# --- two-phase exact top-k and masked selection ---------------------------


def _tied_scores(rng, rows, n):
    """Normal scores with planted exact ties at the top and NEG entries."""
    sim = rng.normal(size=(rows, n)).astype(np.float32)
    for r in range(rows):
        top = np.argsort(-sim[r])[:30]
        sim[r, rng.choice(n, 6, replace=False)] = sim[r, top[3]]
        sim[r, rng.choice(n, 4, replace=False)] = sim[r, top[12]]
        sim[r, rng.choice(n, n // 10, replace=False)] = NEG
    return sim


def _check_exact_topk(sim, s, ids, k):
    """(s, ids) of k+1 ranks is an exact top-(k+1) of sim: s equals the
    k+1 largest values, ids are distinct and hold those values."""
    want = -np.sort(-sim, axis=1)[:, : k + 1]
    np.testing.assert_array_equal(s, want)
    assert all(len(set(row)) == k + 1 for row in ids)
    np.testing.assert_array_equal(np.take_along_axis(sim, ids, 1), s)


@pytest.mark.parametrize("min_items", [None, 16])  # None: module default
def test_exact_topk_2phase_matches_jax(monkeypatch, min_items):
    """Widths >= 4096 and not a multiple of 128 (the NEG_INF pad), planted
    ties and finfo.min entries. min_items=16 forces the recursive branch
    (nw >= _TOPK_2PHASE_MIN_ITEMS) in both packages. Scores are copies, so
    equal exactly; ids tie-aware."""
    if min_items is not None:
        monkeypatch.setattr(jev, "_TOPK_2PHASE_MIN_ITEMS", min_items)
        monkeypatch.setattr(tev, "_TOPK_2PHASE_MIN_ITEMS", min_items)
    rng = np.random.default_rng(0)
    k = 20
    for n in (4100, 5000):
        sim = _tied_scores(rng, 12, n)
        js, jids = jev.exact_topk_2phase(sim, k + 1)
        ts, tids = tev.exact_topk_2phase(torch.from_numpy(sim), k + 1)
        js, jids = np.asarray(js), np.asarray(jids).astype(np.int64)
        ts, tids = ts.numpy(), tids.numpy()
        np.testing.assert_array_equal(ts, js)
        _check_exact_topk(sim, ts, tids, k)
        _check_exact_topk(sim, js, jids, k)
        strict = ts[:, k - 1] > ts[:, k]
        for r in np.flatnonzero(strict):
            assert set(tids[r, :k]) == set(jids[r, :k])


@pytest.mark.parametrize("n", [640, 4608])  # torch.topk / two-phase
def test_masked_topk_matches_jax(n):
    rng = np.random.default_rng(1)
    rows, k = 10, 15
    sim = _tied_scores(rng, rows, n)
    bits = rng.integers(0, 2**32, (rows, n // 32), dtype=np.uint32)
    bits &= rng.integers(0, 2**32, (rows, n // 32), dtype=np.uint32)  # ~25%
    masked = np.where(
        np.unpackbits(bits.view(np.uint8), axis=1, bitorder="little")
        .astype(bool), NEG, sim,
    )
    for b in (bits, None):
        js, jids = jev.masked_topk(sim, b, k + 1)
        ts, tids = tev.masked_topk(
            torch.from_numpy(sim),
            None if b is None else torch.from_numpy(b.view(np.int32)),
            k + 1,
        )
        ref = masked if b is not None else sim
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _check_exact_topk(ref, ts.numpy(), tids.numpy(), k)
        strict = ts[:, k - 1] > ts[:, k]
        for r in np.flatnonzero(strict.numpy()):
            assert set(tids[r, :k].tolist()) == set(np.asarray(jids)[r, :k].tolist())


def test_approximate_topk_is_refused():
    sim = torch.zeros(2, 256)
    with pytest.raises(NotImplementedError, match="item 16"):
        tev.masked_topk(sim, None, 5, exact=False)
    ev = tev.TiledEvaluator(None, 2, num_items=256)
    with pytest.raises(NotImplementedError, match="item 16"):
        ev.topk(torch.zeros(2, 4), torch.zeros(256, 4), 5, exact=False)


# --- tiled evaluator ------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """A seeded random model, 300 users x 4500 items at d = 16, with 12
    seen items and an (H = 8) history per user (some empty)."""
    rng = np.random.default_rng(7)
    u, i, d, h = 300, 4500, 16, 8
    user = rng.normal(size=(u, d)).astype(np.float32)
    item = rng.normal(size=(i, d)).astype(np.float32)
    w0 = (rng.normal(size=(d, d)) * 0.3).astype(np.float32)
    seen = np.stack(
        [np.repeat(np.arange(u), 12),
         np.concatenate([rng.choice(i, 12, replace=False) for _ in range(u)])],
        axis=1,
    ).astype(np.int32)
    his = seen[:, 1].reshape(u, 12)[:, :h].copy()
    lens = rng.integers(0, h + 1, u).astype(np.int32)
    lens[:3] = [0, h, 1]
    return dict(user=user, item=item, w0=w0, seen=seen, his=his, lens=lens,
                scores=user.astype(np.float64) @ item.T.astype(np.float64))


def _ranking_both(model, tile, k, monkeypatch=None, budget=None):
    if budget is not None:
        monkeypatch.setattr(jev, "MASK_BITS_MAX_BYTES", budget)
        monkeypatch.setattr(tev, "MASK_BITS_MAX_BYTES", budget)
    u, n_items = model["user"].shape[0], model["item"].shape[0]
    j = jev.TiledEvaluator(model["seen"], u, user_tile=tile, num_items=n_items)
    t = tev.TiledEvaluator(model["seen"], u, user_tile=tile, num_items=n_items)
    _, jids = j.topk(model["user"], model["item"], k + 1)
    ts, tids = t.topk(torch.from_numpy(model["user"]),
                      torch.from_numpy(model["item"]), k + 1,
                      return_scores=True)
    return t, np.asarray(jids), ts.numpy(), tids.numpy()


def test_tiled_evaluator_bitmap_path_matches_jax(model):
    t, jids, ts, tids = _ranking_both(model, 128, 20)
    assert t.mask_bits is not None
    assert tuple(t.mask_bits.shape) == (3, 128, 4608 // 32)  # 4500 -> 4608
    assert_same_topk(tids, jids, model["scores"], 20)
    np.testing.assert_allclose(
        ts, np.take_along_axis(model["scores"], tids.astype(np.int64), 1),
        rtol=1e-5, atol=1e-5,
    )
    seen = {tuple(p) for p in model["seen"].tolist()}
    assert not any((u, int(i)) in seen for u in range(300) for i in tids[u])


def test_tiled_evaluator_per_pair_path_matches_jax(model, monkeypatch):
    """Above MASK_BITS_MAX_BYTES the pairs are bucketed per tile and
    scattered; 300 users in tiles of 128 leave a partial last tile, and
    4500 items leave a 108-item pad tail that must stay masked."""
    t, jids, _, tids = _ranking_both(model, 128, 20, monkeypatch, budget=16)
    assert t.mask_bits is None and tuple(t.mask_u.shape)[0] == 3
    assert_same_topk(tids, jids, model["scores"], 20)
    assert tids.max() < 4500
    seen = {tuple(p) for p in model["seen"].tolist()}
    assert not any((u, int(i)) in seen for u in range(300) for i in tids[u])


def test_tiled_evaluator_widens_to_the_item_table(model):
    """The pairs imply far fewer items (largest seen id 999) than the table
    holds (4500): the mask's old pad bits are cleared and the new pad tail
    masked, as the JAX evaluator does; topk_scores infers the item count
    from the pairs."""
    keep = model["seen"][:, 1] < 1000
    pairs = model["seen"][keep]
    assert pairs[:, 1].max() == 999
    u, k = model["user"], 20
    j = jev.TiledEvaluator(pairs, 300, user_tile=128)
    t = tev.TiledEvaluator(pairs, 300, user_tile=128)
    _, jids = j.topk(u, model["item"], k + 1)
    _, tids = t.topk(torch.from_numpy(u), torch.from_numpy(model["item"]), k + 1)
    assert_same_topk(tids.numpy(), np.asarray(jids), model["scores"], k)
    js, jids2 = jev.topk_scores(u, model["item"], k + 1, train_pairs=pairs)
    ts, tids2 = tev.topk_scores(
        torch.from_numpy(u), torch.from_numpy(model["item"]), k + 1,
        train_pairs=pairs,
    )
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    assert_same_topk(tids2, jids2, model["scores"], k)
    seen = {tuple(p) for p in pairs.tolist()}
    assert not any((r, int(i)) in seen for r in range(300) for i in tids2[r])
    # A table narrower than the mask is refused, not silently misranked.
    with pytest.raises(ValueError, match="rows"):
        t.topk(torch.from_numpy(u), torch.from_numpy(model["item"][:500]), k)


# --- aggregator and engine ------------------------------------------------


def test_user_pools_match_jax(model):
    """Chunks of 7 users leave a partial last chunk. Summation orders
    differ (chunked einsum vs a masked sum): rtol 1e-5, atol 1e-6."""
    args = (model["item"], model["his"], model["lens"])
    want = np.asarray(jagg.user_pools_impl(*map(jnp.asarray, args), chunk=7))
    got = tagg.user_pools_impl(*map(torch.from_numpy, args), chunk=7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    embs = model["item"][model["his"]]
    np.testing.assert_allclose(
        tagg.pool_history(torch.from_numpy(embs), torch.from_numpy(model["lens"])).numpy(),
        np.asarray(jagg.pool_history(embs, model["lens"])),
        rtol=1e-5, atol=1e-6,
    )
    for kind in ("self_attention", "user_attention"):
        with pytest.raises(NotImplementedError, match="item 12"):
            tagg.user_pools_impl(*map(torch.from_numpy, args), aggregator=kind)


# --- Recommender ----------------------------------------------------------


def _recommenders(model, **kw):
    cfg_kw = dict(emb_dim=16, max_his=8, gamma=0.4)
    j = jserving.Recommender(
        jstate(model["user"], model["item"], model["w0"]), JCFConfig(**cfg_kw),
        his_items=model["his"], his_masks=model["lens"], **kw,
    )
    t = tserving.Recommender(
        state_from_numpy(model["user"], model["item"], model["w0"],
                         lr=0.05, step=0, device="cpu"),
        CFConfig(**cfg_kw), his_items=model["his"], his_masks=model["lens"],
        **kw,
    )
    return j, t


UIDS = [0, 5, 17, 42, 99, 150, 151, 299, 3, 77]  # 10 users: bucket of 16


def test_recommend_one_shot_route_matches_jax(model):
    j, t = _recommenders(model, seen_pairs=model["seen"])
    assert t._bits_flat is not None and not t._chunked_request
    assert tuple(t._item_pad.shape) == (4608, 16)
    got, want = t.recommend(UIDS, 21), j.recommend(UIDS, 21)
    assert got.dtype == np.int32 and got.shape == (10, 21)
    assert_same_topk(got, want, model["scores"][UIDS], 20)
    assert_same_topk(t.recommend_all(21)[UIDS], got, model["scores"][UIDS], 20)
    assert t.recommend([], 5).shape == (0, 5)
    with pytest.raises(IndexError):
        t.recommend([0, 300], 5)
    with pytest.raises(IndexError):
        t.recommend([-1], 5)
    with pytest.raises(NotImplementedError, match="item 16"):
        t.recommend(UIDS, 5, exact=False)


def test_recommend_chunked_route_matches_jax(model, monkeypatch):
    """Thresholds monkeypatched as in tests/test_serving.py: 4608 padded
    items go to 8192 in two 4096-item chunks (each a two-phase top-k),
    their pad rows' bits set."""
    for mod in (jserving, tserving):
        monkeypatch.setattr(mod, "_CHUNKED_REQUEST_MIN_ITEMS", 64)
        monkeypatch.setattr(mod, "_REQUEST_PAD_MULTIPLE", 4096)
    j, t = _recommenders(model, seen_pairs=model["seen"])
    assert t._chunked_request and t._bits_flat is not None
    assert tuple(t._bits_flat.shape) == (512, 8192 // 32)  # one 512-user tile
    assert tuple(t._item_pad.shape) == (8192, 16)
    got = t.recommend(UIDS, 21)
    assert_same_topk(got, j.recommend(UIDS, 21), model["scores"][UIDS], 20)
    assert got.max() < 4500
    seen = {tuple(p) for p in model["seen"].tolist()}
    assert not any((u, int(i)) in seen for u, row in zip(UIDS, got) for i in row)


def test_recommend_retrieve_filter_route_matches_jax(model, monkeypatch):
    """No packed bitmap (budget 16 bytes) on a chunked table: retrieve the
    top (k + cap) unmasked and drop seen ids on the host. Equal to the
    JAX package's route and to the bitmap route."""
    _, t_bitmap = _recommenders(model, seen_pairs=model["seen"])
    for mod in (jserving, tserving):
        monkeypatch.setattr(mod, "_CHUNKED_REQUEST_MIN_ITEMS", 64)
        monkeypatch.setattr(mod, "_REQUEST_PAD_MULTIPLE", 4096)
    monkeypatch.setattr(jev, "MASK_BITS_MAX_BYTES", 16)
    monkeypatch.setattr(tev, "MASK_BITS_MAX_BYTES", 16)
    j, t = _recommenders(model, seen_pairs=model["seen"])
    assert t._bits_flat is None and t._chunked_request
    assert t._seen_keys is not None and t._evaluator.mask_bits is None
    got = t.recommend(UIDS, 21)  # 2 * 16 < 300 users: this route
    assert_same_topk(got, j.recommend(UIDS, 21), model["scores"][UIDS], 20)
    assert_same_topk(got, t_bitmap.recommend(UIDS, 21), model["scores"][UIDS], 20)
    # A request covering most users ranks the whole table instead.
    everyone = list(range(300))
    assert_same_topk(t.recommend(everyone, 21), t_bitmap.recommend_all(21),
                     model["scores"], 20)
    # No seen pairs: the same route without a filter.
    _, t_nomask = _recommenders(model, seen_pairs=None)
    assert t_nomask._seen_keys is None and t_nomask._bits_flat is None
    top = np.argsort(-model["scores"][UIDS], axis=1, kind="stable")[:, :21]
    assert_same_topk(t_nomask.recommend(UIDS, 21), top, model["scores"][UIDS], 20)


@pytest.mark.parametrize("route", ["one_shot", "chunked", "retrieve", "whole_table"])
def test_inexact_selection_is_refused_on_every_route(model, monkeypatch, route):
    """exact=False raises on every route, the recommend_all fallbacks
    included, where the JAX package silently serves exact results
    (heat_tpu/serving.py:404)."""
    if route != "one_shot":
        monkeypatch.setattr(tserving, "_CHUNKED_REQUEST_MIN_ITEMS",
                            64 if route != "whole_table" else 1 << 30)
        monkeypatch.setattr(tserving, "_REQUEST_PAD_MULTIPLE", 4096)
    if route in ("retrieve", "whole_table"):
        monkeypatch.setattr(tev, "MASK_BITS_MAX_BYTES", 16)
    _, t = _recommenders(model, seen_pairs=model["seen"])
    assert t._chunked_request == (route in ("chunked", "retrieve"))
    assert (t._bits_flat is None) == (route in ("retrieve", "whole_table"))
    with pytest.raises(NotImplementedError, match="item 16"):
        t.recommend(UIDS, 5, exact=False)


def test_retrieve_filter_never_serves_pad_ids(monkeypatch):
    """40 real items padded to a 4096-item chunk; user 0 has seen 35 of
    them, so fewer than k = 10 unseen items exist. The retrieved pad rows
    (ids >= 40) are dropped before the seen filter, never served (the JAX
    package's heat_tpu/serving.py:507 does not clip them)."""
    monkeypatch.setattr(tserving, "_CHUNKED_REQUEST_MIN_ITEMS", 64)
    monkeypatch.setattr(tserving, "_REQUEST_PAD_MULTIPLE", 4096)
    monkeypatch.setattr(tev, "MASK_BITS_MAX_BYTES", 16)
    rng = np.random.default_rng(2)
    user = rng.normal(size=(50, 8)).astype(np.float32)
    item = rng.normal(size=(40, 8)).astype(np.float32)
    seen = np.stack([np.zeros(35, np.int32), np.arange(35, dtype=np.int32)], 1)
    t = tserving.Recommender(
        state_from_numpy(user, item, np.eye(8, dtype=np.float32), lr=0.05,
                         step=0, device="cpu"),
        CFConfig(emb_dim=8), seen_pairs=seen,
    )
    assert t._bits_flat is None and t._chunked_request
    got = t.recommend([0, 1], 10)
    assert got.max() < 40
    assert set(got[0, :5].tolist()) == set(range(35, 40))  # the unseen first
    np.testing.assert_array_equal(
        got[1], np.argsort(-(user[1] @ item.T), kind="stable")[:10]
    )


def test_recommend_aggregated_users_matches_jax(model):
    """aggregate_users=True: K1 means of the requested histories (and of
    every user for recommend_all), the w0/gamma blend, then ranking."""
    j, t = _recommenders(model, seen_pairs=model["seen"])
    pooled = np.asarray(jagg.user_pools_impl(
        *map(jnp.asarray, (model["item"], model["his"], model["lens"]))))
    agg = 0.4 * model["user"] + 0.6 * (pooled @ model["w0"])
    scores = agg.astype(np.float64) @ model["item"].T.astype(np.float64)
    assert_same_topk(t.recommend(UIDS, 21, aggregate_users=True),
                     j.recommend(UIDS, 21, aggregate_users=True),
                     scores[UIDS], 20)
    got_all = t.recommend_all(21, aggregate_users=True)
    assert_same_topk(got_all, j.recommend_all(21, aggregate_users=True),
                     scores, 20)
    assert_same_topk(t.recommend(UIDS, 21, aggregate_users=True),
                     got_all[UIDS], scores[UIDS], 20)
    bare =tserving.Recommender(t.state, t.cfg, seen_pairs=model["seen"])
    with pytest.raises(ValueError, match="history"):
        bare.recommend(UIDS, 5, aggregate_users=True)


def test_recommend_cold_matches_jax(model):
    j, t = _recommenders(model, seen_pairs=model["seen"])
    rng = np.random.default_rng(11)
    hist = [rng.choice(4500, int(n), replace=False).tolist()
            for n in rng.integers(1, 30, 40)]
    hist[3] = []
    pooled = np.stack([model["item"][h].mean(0) if h else np.zeros(16, np.float32)
                       for h in hist])
    u = 0.6 * (pooled.astype(np.float64) @ model["w0"])
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
    it = model["item"] / np.linalg.norm(model["item"], axis=1, keepdims=True)
    scores = u @ it.T.astype(np.float64)
    got = t.recommend_cold(hist, 21)
    assert got.dtype == np.int32 and got.shape == (40, 21)
    assert_same_topk(got, j.recommend_cold(hist, 21), scores, 20)
    for row, h in zip(got, hist):
        assert not set(row.tolist()) & set(h)
    assert t.recommend_cold([], 5).shape == (0, 5)
    with pytest.raises(IndexError):
        t.recommend_cold([[4500]], 5)


def test_recommender_sparse_seen_ids_matches_jax(model):
    """Seen pairs whose largest item id (19) sits far below the item count
    (4500) must not shrink the request path's mask width."""
    seen = np.stack([np.arange(20), np.arange(20)], 1).astype(np.int32)
    j, t = _recommenders(model, seen_pairs=seen)
    uids = list(range(20))
    got = t.recommend(uids, 11)
    assert got.max() < 4500
    assert_same_topk(got, j.recommend(uids, 11), model["scores"][uids], 10)
    for u in uids:
        assert u not in set(got[u].tolist())


def test_from_engine_on_a_cpu_engine():
    """from_engine serves the live engine's state with its train pairs as
    the seen pairs and its device histories; equal to a Recommender built
    by hand on the unpadded state."""
    train, test = tsynthetic(90, 300, clicks_per_user=12, max_his=6, seed=3)
    cfg = CFConfig(emb_dim=16, num_negs=4, max_his=6, batch_size=64,
                   l_r=0.05, clip_val=0.5, seed=9)
    eng = TEngine(cfg, train, test, device="cpu")
    eng.train_one_epoch()
    assert eng.unpadded_state() is eng.state
    rec = tserving.Recommender.from_engine(eng)
    manual = tserving.Recommender(
        eng.state, cfg, seen_pairs=np.asarray(train.pairs),
        his_items=train.his_items, his_masks=train.masks,
    )
    uids = [0, 5, 17, 89]
    np.testing.assert_array_equal(rec.recommend(uids, 5), manual.recommend(uids, 5))
    np.testing.assert_array_equal(
        rec.recommend(uids, 5, aggregate_users=True),
        manual.recommend(uids, 5, aggregate_users=True),
    )
    np.testing.assert_array_equal(rec.recommend_all(5), manual.recommend_all(5))
    seen = {tuple(p) for p in np.asarray(train.pairs).tolist()}
    assert not any((u, int(i)) in seen for u, row in zip(uids, rec.recommend(uids, 5))
                   for i in row)


def test_from_engine_serves_a_snapshot():
    """The engine updates its tables in place; a Recommender built from it
    keeps serving the state it was built on while training goes on."""
    train, test = tsynthetic(90, 300, clicks_per_user=12, max_his=6, seed=4)
    cfg = CFConfig(emb_dim=16, num_negs=4, max_his=6, batch_size=64,
                   l_r=0.05, clip_val=0.5, seed=9)
    eng = TEngine(cfg, train, test, device="cpu")
    eng.train_one_epoch()
    rec = tserving.Recommender.from_engine(eng)
    uids = np.arange(90)
    before = rec.recommend(uids, 5)
    before_agg = rec.recommend(uids, 5, aggregate_users=True)
    user, item = eng.state.user_emb.clone(), eng.state.item_emb.clone()
    eng.train_one_epoch()
    assert not torch.equal(eng.state.user_emb, user)  # the epoch moved rows
    assert not torch.equal(eng.state.item_emb, item)
    np.testing.assert_array_equal(rec.recommend(uids, 5), before)
    np.testing.assert_array_equal(
        rec.recommend(uids, 5, aggregate_users=True), before_agg
    )
    torch.testing.assert_close(rec.state.user_emb, user, rtol=0, atol=0)


# --- export ---------------------------------------------------------------


def test_export_matches_jax_key_by_key(model, tmp_path):
    cfg = CFConfig(emb_dim=16, max_his=8)
    state = state_from_numpy(model["user"], model["item"], model["w0"],
                             lr=0.05, step=0, device="cpu")
    got = export_embeddings(state, str(tmp_path / "t.npz"), cfg=cfg)
    want = jexport(jstate(model["user"], model["item"], model["w0"]),
                   str(tmp_path / "j.npz"), cfg=JCFConfig(emb_dim=16, max_his=8))
    back = load_embeddings(str(tmp_path / "t.npz"))
    jback = load_embeddings(str(tmp_path / "j.npz"))
    assert set(got) == set(want) == set(back) == set(jback)
    for key in want:
        assert back[key].dtype == jback[key].dtype, key
        np.testing.assert_array_equal(back[key], jback[key])
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    again = state_from_numpy(back["user_emb"], back["item_emb"], back["w0"],
                             lr=0.05, step=0, device="cpu")
    assert torch.equal(again.item_emb, state.item_emb)


def test_cli_exports_embeddings(tmp_path, capsys):
    path = tmp_path / "emb.npz"
    tmain.main([
        "--config", "benchmarks/AmazonBooks/config0.yaml", "--synthetic",
        "120,300", "--epochs", "1", "--device", "cpu",
        "--export-embeddings", str(path),
    ])
    assert f"exported embeddings to {path}" in capsys.readouterr().out
    back = load_embeddings(str(path))
    assert back["user_emb"].shape == (120, 64)
    assert back["item_emb"].shape == (300, 64)
    assert back["w0"].shape == (64, 64)
    assert all(np.isfinite(back[k]).all() for k in ("user_emb", "item_emb", "w0"))
    np.testing.assert_allclose(float(back["meta_gamma"]), 0.4, rtol=1e-6)
    assert int(back["meta_similarity"]) == 0  # config0 scores by cosine


def test_cpu_window_extract_launches_nothing(model):
    before = dict(ktopk.LAUNCHES)
    j, t = _recommenders(model, seen_pairs=model["seen"])
    t.recommend(UIDS, 5)
    assert ktopk.LAUNCHES == before
