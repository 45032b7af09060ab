"""The bench's fast path of the port against the JAX package, on the CPU:
the tile sampler with whole-tile scoring, cached history pools, bf16 tables
and compute, the history dedup and the visit orders.

Inputs come from a seed through numpy and go through the JAX function and
its counterpart in the port (the kernels' plain versions). Random draws are
injected on both sides: the samplers' ``randint`` calls are replaced for
the cadence test, and ``sample_negatives`` is replaced by one pinned
function of the sampler's sample counter for the step and engine tests
(the pinning of tests/test_torch_step.py). f32 results agree to the
tolerance of tests/test_torch_step.py (the two packages sum in different
orders); the bf16 tolerances are stated at their tests.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.train.samplers as jsam
import heat_tpu.train.scatter as jsc
import heat_tpu.train.train_step as jts
import heat_tpu_torch.train.samplers as tsam
import heat_tpu_torch.train.scatter as tsc
import heat_tpu_torch.train.train_step as tts
from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.data.synthetic import synthetic_click_dataset as jsynthetic
from heat_tpu.models.aggregator import history_mean_fused as jmean_fused
from heat_tpu.models.state import init_train_state as jinit
from heat_tpu.ops.losses import sample_losses_weighted as jweighted
from heat_tpu.ops.similarity import tile_scores as jtile_scores
from heat_tpu.train.engine import Engine as JEngine
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.models.aggregator import history_mean_fused, user_pools_impl
from heat_tpu_torch.models.state import (
    init_train_state,
    state_from_numpy,
    state_to_numpy,
)
from heat_tpu_torch.ops.losses import sample_losses, sample_losses_weighted
from heat_tpu_torch.ops.similarity import pair_scores, tile_scores
from heat_tpu_torch.testing import assert_state_array_close
from heat_tpu_torch.train.engine import Engine as TEngine

from test_torch_step import torch_state_of

TOL = dict(rtol=1e-5, atol=1e-7)
LOSSES = ["PairwiseLogisticLoss", "CosineContrastiveLoss", "SigmoidPairwiseLoss"]
TILE = dict(neg_sampler=1, tile_size=32, refresh_interval=256)


# --- scores and losses --------------------------------------------------


def _score_inputs(seed, b=64, t=32, k=6, d=16):
    rng = np.random.default_rng(seed)
    # Scaled so that dot scores stay within a few units (exp stays finite).
    u = (0.5 * rng.normal(size=(b, d))).astype(np.float32)
    p = (0.5 * rng.normal(size=(b, d))).astype(np.float32)
    tile = (0.5 * rng.normal(size=(t, d))).astype(np.float32)
    tile[3] = tile[1]  # a repeated tile row
    idx = rng.integers(0, t, (b, k)).astype(np.int32)
    idx[0] = 5  # all of one sample's draws on one slot
    counts = np.zeros((b, t), np.float32)
    np.add.at(counts, (np.arange(b)[:, None], idx), 1.0)
    return u, p, tile, idx, counts


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("loss", LOSSES)
def test_tile_scores_and_weighted_losses_match_jax(loss, similarity):
    u, p, tile, idx, counts = _score_inputs(0)
    kw = dict(loss=loss, similarity=similarity, temperature=0.25, ccl_margin=0.1,
              ccl_neg_weight=3.0)
    k = idx.shape[1]
    js_up, js = jtile_scores(*map(jnp.asarray, (u, p, tile)), similarity=similarity)
    want = jweighted(js_up, js, jnp.asarray(counts), k, JCFConfig(**kw))
    ts_up, ts = tile_scores(*map(torch.from_numpy, (u, p, tile)),
                            similarity=similarity)
    got = sample_losses_weighted(ts_up, ts, torch.from_numpy(counts), k,
                                 CFConfig(**kw))
    np.testing.assert_allclose(ts_up.numpy(), np.asarray(js_up), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("loss", LOSSES)
def test_tile_path_equals_pair_path_over_the_gathered_rows(loss, similarity):
    """The identity the tile path rests on: the (B, T) scores read through
    the multiplicities are the multiset of the K gathered scores, so the
    losses and their gradients equal ``pair_scores`` + ``sample_losses``
    over ``tile[idx]``, with the tile's gradient the per-slot sum."""
    u, p, tile, idx, counts = _score_inputs(1)
    cfg = CFConfig(loss=loss, similarity=similarity, temperature=0.25,
                   ccl_margin=0.1, ccl_neg_weight=3.0)
    tu, tp, tt = (torch.from_numpy(x).requires_grad_() for x in (u, p, tile))
    s_up, s = tile_scores(tu, tp, tt, similarity=similarity)
    tiled = sample_losses_weighted(s_up, s, torch.from_numpy(counts),
                                   idx.shape[1], cfg)
    g_tiled = torch.autograd.grad(tiled.sum(), (tu, tp, tt))

    pu, pp, pt = (torch.from_numpy(x).requires_grad_() for x in (u, p, tile))
    rows = pt[torch.from_numpy(idx).long()]  # (B, K, d)
    p_up, p_un = pair_scores(pu, pp, rows, similarity=similarity)
    paired = sample_losses(p_up, p_un, cfg)
    g_paired = torch.autograd.grad(paired.sum(), (pu, pp, pt))
    torch.testing.assert_close(tiled, paired, rtol=1e-5, atol=1e-6)
    # Each gradient element sums up to B * K terms of magnitude ~1 in
    # another order (a matrix product against per-draw adds), and they
    # cancel: atol 1e-5.
    for a, b in zip(g_tiled, g_paired):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_tile_scores_promote_bf16_inputs_to_f32():
    u, p, tile, _, _ = _score_inputs(2)
    bu, bp, bt = (torch.from_numpy(x).bfloat16() for x in (u, p, tile))
    s_up, s = tile_scores(bu, bp, bt)
    assert s_up.dtype == s.dtype == torch.float32
    w_up, w = tile_scores(bu.float(), bp.float(), bt.float())
    assert torch.equal(s_up, w_up) and torch.equal(s, w)
    j_up, j = jtile_scores(*(jnp.asarray(x, jnp.bfloat16) for x in (u, p, tile)))
    assert j.dtype == jnp.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


# --- the tile sampler ---------------------------------------------------


@pytest.mark.parametrize("batch", [64, 512, 8192, 32768, 100000])
@pytest.mark.parametrize("items", [0, 90, 200, 5000, 91599, 6_000_000])
def test_derive_tile_params_equals_jax(batch, items):
    kw = dict(batch_size=batch, num_items=items)
    assert tsam.derive_tile_params(CFConfig(**kw)) == (
        jsam.derive_tile_params(JCFConfig(**kw)))


def test_tile_tuning_constants_equal_jax():
    for name in ("TILE_TUNE_ALPHA", "TILE_TUNE_BETA", "TILE_SCORE_BUDGET_BYTES",
                 "TILE_DRAWS_PER_SLOT"):
        assert getattr(tsam, name) == getattr(jsam, name)
    # The shipped AmazonBooks setting falls out of "auto".
    assert tsam.derive_tile_params(CFConfig(batch_size=8192, num_items=91599)) == (
        512, 8192)


@pytest.mark.parametrize("it,real,refreshes", [
    (0, None, True),      # phase == 0
    (200, None, True),    # 200 + 64 crosses 256
    (64, None, False),    # no crossing
    (192, None, False),   # ends exactly on the boundary: not crossed yet
    (256, None, True),    # the boundary sample itself
    (200, 0, False),      # an all-padding batch: a no-op
    (0, 0, False),        # ... even at phase 0
    (200, 40, False),     # real < batch: 240 stays below 256
    (200, 57, True),      # real < batch and crossing
])
def test_tile_negatives_refresh_cadence_matches_jax(monkeypatch, it, real, refreshes):
    rng = np.random.default_rng(3)
    b, k, items, t, refresh = 64, 4, 300, 32, 256
    old = rng.integers(0, items, t).astype(np.int32)
    fresh = rng.integers(0, items, t).astype(np.int32)
    idx = rng.integers(0, t, (b, k)).astype(np.int32)

    def jrandint(key, shape, lo, hi, dtype=None):
        return jnp.asarray(fresh if tuple(shape) == (t,) else idx)

    monkeypatch.setattr(jax.random, "randint", jrandint)
    monkeypatch.setattr(
        tsam, "_tile_draws",
        lambda *a, **kw: (torch.from_numpy(fresh), torch.from_numpy(idx)),
    )
    jsample, jstate = jsam._tile_negatives(
        jax.random.key(0),
        jsam.SamplerState(tile=jnp.asarray(old), iterations=jnp.asarray(it, jnp.int32)),
        b, k, items, t, refresh,
        real=None if real is None else jnp.asarray(real, jnp.int32),
    )
    tsample, tstate = tsam._tile_negatives(
        None,
        tsam.SamplerState(iterations=torch.tensor(it, dtype=torch.int32),
                          tile=torch.from_numpy(old)),
        b, k, items, t, refresh,
        real=None if real is None else torch.tensor(real, dtype=torch.int32),
    )
    np.testing.assert_array_equal(tstate.tile.numpy(), np.asarray(jstate.tile))
    np.testing.assert_array_equal(tstate.tile.numpy(), fresh if refreshes else old)
    assert int(tstate.iterations) == int(jstate.iterations) == it + (
        b if real is None else real)
    assert tstate.iterations.dtype == torch.int32
    for name in ("ids", "tile", "tile_idx"):
        got = getattr(tsample, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jsample, name)))


def test_tile_sampler_draws_are_in_range_and_the_state_carries_the_tile():
    cfg = CFConfig(num_items=90, num_negs=4, batch_size=48, **TILE)
    g = torch.Generator().manual_seed(0)
    state = tsam.init_sampler_state(cfg, "cpu", g)
    assert state.tile.shape == (32,) and state.tile.dtype == torch.int32
    pos = torch.zeros(48, dtype=torch.int32)
    sample, state2 = tsam.sample_negatives(g, state, pos, cfg)
    assert sample.ids.shape == sample.tile_idx.shape == (48, 4)
    assert 0 <= int(sample.tile.min()) and int(sample.tile.max()) < 90
    assert 0 <= int(sample.tile_idx.min()) and int(sample.tile_idx.max()) < 32
    assert torch.equal(sample.ids, sample.tile[sample.tile_idx.long()])
    assert state2.tile is sample.tile and int(state2.iterations) == 48
    # The uniform sampler carries no tile.
    ucfg = CFConfig(num_items=90, num_negs=4, batch_size=48)
    usample, ustate = tsam.sample_negatives(
        g, tsam.init_sampler_state(ucfg, "cpu"), pos, ucfg)
    assert usample.tile is usample.tile_idx is ustate.tile is None


# --- the tile-path step -------------------------------------------------


@contextlib.contextmanager
def pinned_tiles(tiles: np.ndarray, idx_table: np.ndarray):
    """Both packages' samplers return the tile ``tiles[it % len(tiles)]``
    and the draws ``idx_table[it : it + B]``, ``it`` being the sampler's
    sample counter, which advances by the real sample count."""
    jtiles, jidx = jnp.asarray(tiles), jnp.asarray(idx_table)
    ttiles, tidx = torch.from_numpy(tiles), torch.from_numpy(idx_table)

    def jpinned(key, sstate, pos_ids, cfg, real=None):
        it = sstate.iterations
        tile = jtiles[it % tiles.shape[0]]
        idx = jidx[it + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)]
        adv = pos_ids.shape[0] if real is None else real
        return jsam.NegSample(tile[idx], tile, idx), jsam.SamplerState(
            tile=tile, iterations=it + adv)

    def tpinned(generator, sstate, pos_ids, cfg, real=None):
        it = int(sstate.iterations)
        tile = ttiles[it % tiles.shape[0]].to(pos_ids.device)
        idx = tidx[it : it + pos_ids.shape[0]].to(pos_ids.device)
        adv = pos_ids.shape[0] if real is None else real
        return tsam.NegSample(tile[idx.long()], tile, idx), tsam.SamplerState(
            iterations=sstate.iterations + adv, tile=tile)

    jorig, torig = jts.sample_negatives, tts.sample_negatives
    jts.sample_negatives, tts.sample_negatives = jpinned, tpinned
    try:
        yield
    finally:
        jts.sample_negatives, tts.sample_negatives = jorig, torig


def _step_setup(seed=0, u=40, i=90, h=8, b=48, k=4, d=16, t=32, lr=0.05,
                clip_val=0.02, **extra):
    rng = np.random.default_rng(seed)
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=lr, clip_val=clip_val, seed=seed, **TILE)
    kw.update(extra)
    users = rng.integers(0, u, b).astype(np.int32)
    pos = rng.integers(0, i, b).astype(np.int32)
    users[:6], pos[6:12] = 3, 5  # a repeated user, a repeated item
    weight = np.ones(b, np.float32)
    weight[-7:] = 0.0  # a weight-0 tail repeating real pairs
    users[-7:], pos[-7:] = users[:7], pos[:7]
    his = rng.integers(0, i, (u, h)).astype(np.int32)
    masks = rng.integers(0, h + 1, u).astype(np.int32)
    masks[3] = 0  # the repeated user has an empty history
    tiles = rng.integers(0, i, (5, t)).astype(np.int32)
    tiles[:, 4] = tiles[:, 2]  # every tile repeats an id
    tiles[:, 7] = 5  # ... and holds the repeated positive
    idx_table = rng.integers(0, t, (4 * b, k)).astype(np.int32)
    idx_table[:, 0] = np.where(rng.random(4 * b) < 0.3, 4, idx_table[:, 0])
    return JCFConfig(**kw), CFConfig(**kw), (users, pos, weight), his, masks, (
        tiles, idx_table)


L2 = dict(l2_enabled=True, l2=0.01)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("sort,extra", [
    (False, {}),
    (True, {}),
    (False, {"update_mode": "direct"}),
    (False, L2),
    (False, {"update_mode": "direct", **L2}),
    (True, {"update_mode": "direct"}),
    (False, {"sgd_mode": "accum"}),
    (False, {"loss": "CosineContrastiveLoss"}),
    (False, {"similarity": "dot", "clip_val": 1e9, "l_r": 1e-4}),
], ids=["dedup", "sorted", "direct", "l2", "direct-l2", "direct-huge",
        "accum-untiled", "ccl", "dot-unclipped"])
def test_tile_step_matches_jax(monkeypatch, sort, extra, steps):
    """``steps`` tile-path steps (the second reads the first's writes and
    sees another tile), then one on an all-padding batch, which changes
    nothing but nothing. Accum mode takes the untiled fallback over
    ``tile[idx]``. Held to the rule of tests/test_torch_step.py."""
    if sort:
        monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    extra = dict(extra)
    lr = extra.pop("l_r", 0.05)
    clip = extra.pop("clip_val", 0.02)
    jcfg, tcfg, (users, pos, weight), his, masks, pins = _step_setup(
        lr=lr, clip_val=clip, **extra)
    jstate = jinit(jcfg, jax.random.key(1))
    tstate = torch_state_of(jstate)
    pad = np.zeros_like(weight)
    batches = [(users, pos, weight)] * steps + [(users, pos, pad)]
    with pinned_tiles(*pins):
        jss = jsam.init_sampler_state(jcfg, jax.random.key(2))
        tss = tsam.init_sampler_state(tcfg, "cpu", torch.Generator().manual_seed(0))
        for arrays in batches:
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3),
                jts.Batch(*map(jnp.asarray, arrays)),
                jnp.asarray(his), jnp.asarray(masks), jcfg,
            )
            before = state_to_numpy(tstate)
            tstate, tss, tloss = tts.train_step(
                tstate, tss, None, tts.Batch(*map(torch.from_numpy, arrays)),
                torch.from_numpy(his), torch.from_numpy(masks), tcfg,
            )
            np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    after = state_to_numpy(tstate)
    want = state_to_numpy(torch_state_of(jstate))
    assert set(after) == set(want)
    for name, got in after.items():
        assert_state_array_close(got, want[name], name, lr=jcfg.l_r,
                                 clip_val=jcfg.clip_val, **TOL)
        if name not in ("lr", "step"):  # the padding batch: no change
            np.testing.assert_array_equal(got, before[name], err_msg=name)
    assert int(after["step"]) == int(jstate.step) == steps
    assert int(tss.iterations) == int(jss.iterations) == steps * 41
    np.testing.assert_array_equal(tss.tile.numpy(), np.asarray(jss.tile))


def test_tile_step_updates_tile_rows_and_positives_only():
    """B + T item rows: a row that is neither a real positive nor in the
    tile keeps its bits; every tile row moves, the drawn ones and (under
    the combined clip) no others."""
    _, tcfg, (users, pos, weight), his, masks, pins = _step_setup()
    state = init_train_state(tcfg, torch.Generator().manual_seed(1), "cpu")
    before = state.item_emb.clone()
    with pinned_tiles(*pins):
        tss = tsam.init_sampler_state(tcfg, "cpu", torch.Generator().manual_seed(0))
        state, tss, _ = tts.train_step(
            state, tss, None, tts.Batch(*map(torch.from_numpy, (users, pos, weight))),
            torch.from_numpy(his), torch.from_numpy(masks), tcfg,
        )
    tile, idx = pins[0][0], pins[1][:48]
    drawn = np.unique(tile[idx[weight > 0]])
    touched = np.union1d(drawn, pos[weight > 0])
    moved = np.flatnonzero((state.item_emb != before).any(1).numpy())
    np.testing.assert_array_equal(moved, touched)


# --- bf16 ---------------------------------------------------------------

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _ulps_bf16(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude's binade."""
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    return np.abs(got.astype(np.float64) - want) / ulp


def _bf16_two_steps(jcfg, tcfg, batch, his, masks, pins, steps=2):
    """``steps`` bf16 tile-path steps of both packages from one state;
    returns (jax state, torch state, the torch state before the last
    step's update as f32 arrays)."""
    users, pos, weight = batch
    jstate = jinit(jcfg, jax.random.key(1))
    assert jstate.user_emb.dtype == jnp.bfloat16
    tstate = state_from_numpy(
        jstate.user_emb, jstate.item_emb, jstate.w0, lr=jcfg.l_r, step=0,
        device="cpu", param_dtype=torch.bfloat16,
    )
    assert tstate.item_emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state_to_numpy(tstate)["item_emb"], np.asarray(jstate.item_emb, np.float32))
    jhis, jmasks = jnp.asarray(his), jnp.asarray(masks)
    this, tmasks = torch.from_numpy(his), torch.from_numpy(masks)
    pools = tcfg.his_refresh == "subepoch"
    with pinned_tiles(*pins):
        jss = jsam.init_sampler_state(jcfg, jax.random.key(2))
        tss = tsam.init_sampler_state(tcfg, "cpu", torch.Generator().manual_seed(0))
        for step in range(steps):
            jmeans = jts._refresh_pools(jcfg, jstate, jhis, jmasks)
            tmeans = (
                user_pools_impl(tstate.item_emb, this, tmasks) if pools else None
            )
            if pools:
                assert tmeans.dtype == torch.bfloat16
            if pools and step == 0:  # from bit-equal tables: bit-equal pools
                np.testing.assert_array_equal(
                    tmeans.float().numpy(), np.asarray(jmeans, np.float32))
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3),
                jts.Batch(*map(jnp.asarray, (users, pos, weight))),
                jhis, jmasks, jcfg, user_means=jmeans,
            )
            tstate, tss, tloss = tts.train_step(
                tstate, tss, None,
                tts.Batch(*map(torch.from_numpy, (users, pos, weight))),
                this, tmasks, tcfg, user_means=tmeans,
            )
            assert tloss.dtype == torch.float32
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tstate.user_emb.dtype == tstate.item_emb.dtype == torch.bfloat16
    assert tstate.w0.dtype == torch.float32
    return jstate, tstate


def _assert_bf16_tables_equal(jstate, tstate, jcfg):
    got = state_to_numpy(tstate)
    for name in ("user_emb", "item_emb"):
        want = np.asarray(getattr(jstate, name), np.float32)
        ulps = _ulps_bf16(got[name], want)
        assert (ulps == 0).mean() >= 0.99, (name, (ulps == 0).mean())
        assert ulps.max() <= 2, (name, ulps.max())
    start = np.asarray(jinit(jcfg, jax.random.key(1)).w0)
    move = np.abs(np.asarray(jstate.w0) - start).max()
    np.testing.assert_allclose(got["w0"], np.asarray(jstate.w0),
                               atol=1e-2 * move, rtol=0)


@pytest.mark.parametrize("sort,extra", [
    (False, {}), (False, L2), (False, {"his_refresh": "subepoch"}), (True, {}),
    (True, L2),
], ids=["dedup", "dedup-l2", "dedup-pools", "sorted", "sorted-l2"])
def test_bf16_tile_step_matches_jax(monkeypatch, sort, extra):
    """Two tile-path steps with bf16 tables and compute, combined-row
    update (one write per row, so the result does not depend on an order).
    Both packages round to bf16 at the same points (the casts of the
    gathered rows, the end of the history mean, the aggregation's product,
    its two scalar weights and its three elementwise operations, the
    gradients' casts, every table write), so the tables come out bit-equal
    but for roundings flipped by the other order of an f32 sum in between:
    at least 99% of the elements bit-equal, none further than 2 bf16 ulps
    (an ulp is 2^-7 of the element's binade: 1.2e-4 at the row scale of
    0.03, where a wrong step moves a row by lr * clip_val = 1e-3). Measured:
    all bit-equal. ``w0`` is f32: within 1% of its largest move. Losses are
    f32 sums over equal bf16 inputs: rtol 1e-4."""
    if sort:
        monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    jcfg, tcfg, batch, his, masks, pins = _step_setup(**BF16, **extra)
    jstate, tstate = _bf16_two_steps(jcfg, tcfg, batch, his, masks, pins)
    _assert_bf16_tables_equal(jstate, tstate, jcfg)


@pytest.mark.parametrize("extra", [{}, L2, {"his_refresh": "subepoch"}],
                         ids=["direct", "direct-l2", "direct-pools"])
def test_bf16_direct_step_with_unique_ids_matches_jax(extra):
    """The headline's update, ``direct`` mode, where no row occurs twice
    (distinct users, distinct positives, a tile of distinct ids that holds
    no positive): every row gets one bf16 add, so two steps are
    deterministic and held to the rule of the combined-row test."""
    jcfg, tcfg, _, his, masks, (_, idx_table) = _step_setup(
        u=64, update_mode="direct", **BF16, **extra)
    rng = np.random.default_rng(8)
    users = rng.permutation(64)[:48].astype(np.int32)
    items = rng.permutation(90).astype(np.int32)
    pos, tiles = items[:48], np.tile(items[48:80], (5, 1))
    weight = np.ones(48, np.float32)
    weight[-7:] = 0.0
    his = np.concatenate([his, his[:24]])
    masks = np.concatenate([masks, masks[:24]])
    jstate, tstate = _bf16_two_steps(
        jcfg, tcfg, (users, pos, weight), his, masks, (tiles, idx_table))
    _assert_bf16_tables_equal(jstate, tstate, jcfg)


def test_bf16_direct_step_with_repeated_ids_is_within_the_occurrence_bound():
    """``direct`` mode adds one rounded bf16 increment per occurrence, so
    over a repeated row the result depends on the order of the adds, which
    differs between JAX's scatter and ``index_add_`` (and, on the card,
    from run to run). Any order of k bf16 adds lies within k half-ulps of
    the largest partial sum of the exact sum, so two orders differ by at
    most k ulps of it: each element is held, after one step, to
    k * 2^-7 * (|row| + k * lr * clip_val), k being the row's occurrences
    (users: in the batch; items: as a real positive and as a tile slot),
    and rows that occur once to a single ulp."""
    jcfg, tcfg, (users, pos, weight), his, masks, pins = _step_setup(
        update_mode="direct", **BF16)
    jstate, tstate = _bf16_two_steps(
        jcfg, tcfg, (users, pos, weight), his, masks, pins, steps=1)
    got = state_to_numpy(tstate)
    real = weight > 0
    step = jcfg.l_r * jcfg.clip_val
    occurrences = {
        "user_emb": np.bincount(users[real], minlength=40),
        "item_emb": np.bincount(pos[real], minlength=90)
        + np.bincount(pins[0][0], minlength=90),
    }
    for name, k in occurrences.items():
        assert k.max() >= 3  # the batch does repeat rows
        want = np.asarray(getattr(jstate, name), np.float32)
        k = k[:, None].astype(np.float64)
        bound = np.maximum(k, 1) * 2.0**-7 * (np.abs(want) + k * step)
        diff = np.abs(got[name] - want)
        assert (diff <= bound).all(), (name, float((diff - bound).max()))
        assert (diff[k[:, 0] == 0] == 0).all()  # untouched rows: equal bits


def test_bf16_history_mean_rounds_once():
    """K1's contract in bf16: bf16 rows summed in f32, divided, rounded to
    bf16 once. Bit-equal to the JAX function, and different from a mean
    whose sum is rounded to bf16 before the division, which is what this
    test would catch."""
    rng = np.random.default_rng(5)
    n, d, b, h = 200, 16, 128, 12
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).bfloat16()
    his = rng.integers(0, n, (b, h)).astype(np.int32)
    lens = rng.integers(0, h + 1, b).astype(np.int32)
    lens[:3] = [0, h, 1]
    got = history_mean_fused(table, torch.from_numpy(his), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    want = jmean_fused(jnp.asarray(table.float().numpy(), jnp.bfloat16),
                       jnp.asarray(his), jnp.asarray(lens))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

    rows = table.float()[torch.from_numpy(his).long()]
    valid = (torch.arange(h)[None, :] < torch.from_numpy(lens)[:, None]).float()
    total = (rows * valid[:, :, None]).sum(1)
    denom = torch.from_numpy(lens).clamp(min=1).float()[:, None]
    once = (total / denom).bfloat16()
    twice = (total.bfloat16().float() / denom).bfloat16()
    assert torch.equal(got, once)
    assert (once != twice).float().mean() > 0.05
    assert not got[0].any()  # an empty history pools to zero

    # Into an f32 result the bf16 rows are exact; from an f32 table into a
    # bf16 result the rows are rounded first, as the JAX function does.
    f32 = history_mean_fused(table, torch.from_numpy(his), torch.from_numpy(lens),
                             torch.float32)
    assert f32.dtype == torch.float32 and torch.equal(f32, total / denom)
    wide = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    mixed = history_mean_fused(wide, torch.from_numpy(his), torch.from_numpy(lens),
                               torch.bfloat16)
    jmixed = jmean_fused(jnp.asarray(wide.numpy()), jnp.asarray(his),
                         jnp.asarray(lens), jnp.bfloat16)
    np.testing.assert_array_equal(mixed.float().numpy(), np.asarray(jmixed, np.float32))


def test_init_state_casts_the_tables_and_keeps_w0_f32():
    cfg = CFConfig(num_users=30, num_items=50, emb_dim=8, optimizer="adam", **BF16)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert state.user_emb.dtype == state.item_emb.dtype == torch.bfloat16
    assert state.w0.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in state.opt_slots.values())
    f32 = init_train_state(
        CFConfig(num_users=30, num_items=50, emb_dim=8, optimizer="adam"),
        torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(state.item_emb, f32.item_emb.bfloat16())  # drawn in f32
    arrays = state_to_numpy(state)
    assert arrays["user_emb"].dtype == np.float32
    back = state_from_numpy(
        arrays["user_emb"], arrays["item_emb"], arrays["w0"], lr=0.1, step=0,
        device="cpu", param_dtype=torch.bfloat16)
    assert torch.equal(back.user_emb, state.user_emb)
    accum = init_train_state(
        CFConfig(num_users=30, num_items=50, emb_dim=8, sgd_mode="accum", **BF16),
        torch.Generator().manual_seed(0), "cpu")
    assert accum.user_gacc.dtype == torch.bfloat16


# --- engine: pools, dedup, visit order ----------------------------------

LR, CLIP = 0.05, 0.1


def _engines(users=80, items=300, **override):
    kw = dict(emb_dim=16, max_his=6, num_negs=4, batch_size=256, l_r=LR,
              clip_val=CLIP, shuffle_mode="none", seed=21)
    kw.update(override)
    jtrain, jtest = jsynthetic(users, items, clicks_per_user=12, max_his=6, seed=9)
    ttrain, ttest = tsynthetic(users, items, clicks_per_user=12, max_his=6, seed=9)
    je = JEngine(JCFConfig(**kw), jtrain, jtest, seed=21)
    te = TEngine(CFConfig(**kw), ttrain, ttest, device="cpu")
    te.state = torch_state_of(je.state)
    return je, te


def _epoch_pins(je, t=32, epochs=2):
    rng = np.random.default_rng(3)
    n = epochs * je.cfg.train_size + je.cfg.batch_size
    tiles = rng.integers(0, je.cfg.num_items, (7, t)).astype(np.int32)
    idx_table = rng.integers(0, t, (n, je.cfg.num_negs)).astype(np.int32)
    return tiles, idx_table


def _assert_tables_close(te, je, share=0.98, cap=1e-2):
    """The rule of tests/test_torch_engine.py: rtol 1e-4 (atol 1e-6) on at
    least ``share`` of the elements and nowhere off by more than ``cap`` of
    one step's largest move, lr * clip_val. Per-occurrence gradients reach
    ~1e2 and cancel, so the two packages' summation orders leave a few
    elements apart after two epochs (measured on the tile path: 1.2% of
    the 256 elements of w0, at most 3.4e-6; 0.13% of the item elements, at
    most 2.5e-5); a wrong step moves whole rows by lr * clip_val = 5e-3."""
    for name in ("user_emb", "item_emb", "w0"):
        got = getattr(te.state, name).numpy()
        want = np.asarray(getattr(je.state, name))
        diff = np.abs(got - want)
        assert (diff <= 1e-6 + 1e-4 * np.abs(want)).mean() >= share, name
        assert diff.max() <= cap * LR * CLIP, (name, diff.max())


@pytest.mark.parametrize("update_mode", ["dedup", "direct"])
def test_cached_pools_epochs_match_jax(update_mode):
    """The bench's configuration in f32: tile sampler, cached pools, two
    epochs from one state with pinned tiles and draws."""
    je, te = _engines(his_refresh="subepoch", update_mode=update_mode, **TILE)
    with pinned_tiles(*_epoch_pins(je)):
        jl = [je.train_one_epoch() for _ in range(2)]
        tl = [te.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[1] < tl[0]
    # direct mode clips per occurrence, so the occurrences the clip does
    # not saturate carry their summation-order noise into the rows whole
    # (measured: 1.1% of the user elements outside rtol 1e-4, at most
    # 6.0e-5, 1.2% of a step's move): its cap is 3%.
    _assert_tables_close(te, je, cap=3e-2 if update_mode == "direct" else 1e-2)
    assert int(te.state.step) == int(je.state.step)
    assert int(te.sampler_state.iterations) == int(je.sampler_state.iterations)


def test_pools_are_taken_once_per_epoch_from_the_epoch_start_tables(monkeypatch):
    _, te = _engines(his_refresh="subepoch", **TILE)
    calls, seen = [], []
    orig_pools, orig_step = te._pooled_history, tts.train_step

    def pools(out=None):
        calls.append(te.state.item_emb.clone())
        return orig_pools(out=out)

    def step(state, ss, gen, batch, his, masks, cfg, **kw):
        seen.append(kw["user_means"])
        return orig_step(state, ss, gen, batch, his, masks, cfg, **kw)

    monkeypatch.setattr(te, "_pooled_history", pools)
    monkeypatch.setattr(tts, "train_step", step)  # the epoch's steps call it
    te.train_one_epoch()
    nb = -(-te.cfg.train_size // te.cfg.batch_size)
    assert nb > 1 and len(calls) == 1 and len(seen) == nb
    assert all(m is seen[0] for m in seen)  # one table for the whole epoch
    start = user_pools_impl(calls[0], te.his_items, te.his_masks)
    assert torch.equal(seen[0], start)
    # The item table moved during the epoch; the pools did not follow.
    assert not torch.equal(user_pools_impl(te.state.item_emb, te.his_items,
                                           te.his_masks), start)
    te.train_one_epoch()
    # A buffer taken again after the second epoch's shuffle, refreshed from
    # that epoch's start tables.
    assert len(calls) == 2 and seen[nb] is not seen[0]
    assert torch.equal(seen[nb], user_pools_impl(calls[1], te.his_items,
                                                 te.his_masks))


def test_pools_are_not_built_under_his_refresh_step(monkeypatch):
    _, te = _engines()
    monkeypatch.setattr(te, "_pooled_history", lambda: 1 / 0)
    assert np.isfinite(te.train_one_epoch())


def test_history_dedup_maps_equal_jax_on_a_user_grouped_stream():
    je, te = _engines()
    jusers, _, _ = je._make_batches(je.pairs)
    tusers, _, _ = te._make_batches(te.pairs)
    np.testing.assert_array_equal(tusers.numpy(), np.asarray(jusers))
    want = je._history_dedup(je.pairs, jusers)
    got = te._history_dedup(te.pairs, tusers)
    assert want is not None and got is not None
    uu, inv, first = got
    assert uu.dtype == inv.dtype == first.dtype == torch.int32
    assert uu.shape[1] % 8 == 0 and first.shape == uu.shape
    for got_map, want_map in zip(got, want):  # uniq, inverse, first
        np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    # Each distinct user's first occurrence holds that user.
    assert torch.equal(torch.gather(tusers, 1, first.long()), uu)
    # The maps reproduce the stream, and the stream is downloaded once.
    assert torch.equal(torch.gather(uu, 1, inv.long()), tusers)
    assert te._history_dedup(te.pairs, tusers) is got


@pytest.mark.parametrize("override", [
    {"shuffle_mode": "epoch"},
    {"his_refresh": "subepoch"},
    {"batch_size": 64, "visit_order": "item"},  # users mostly distinct
])
def test_history_dedup_is_none_where_it_does_not_apply(override):
    je, te = _engines(users=300, **override)
    tusers, _, _ = te._make_batches(te.pairs)
    jusers, _, _ = je._make_batches(je.pairs)
    assert te._history_dedup(te.pairs, tusers) is None
    assert je._history_dedup(je.pairs, jusers) is None


@pytest.mark.parametrize("tile", [False, True], ids=["uniform", "tile"])
def test_step_with_the_dedup_maps_equals_the_step_without(tile):
    """The port's own exact-rewrite check: pooling once per distinct user
    and reading the means back per sample gives the per-sample means, so
    two epochs with and without the maps agree to rtol 1e-6."""
    kw = dict(TILE) if tile else {}
    _, with_maps = _engines(**kw)
    _, without = _engines(**kw)
    without._history_dedup = lambda pairs, users: None
    tusers, _, _ = with_maps._make_batches(with_maps.pairs)
    assert with_maps._history_dedup(with_maps.pairs, tusers) is not None
    for eng in (with_maps, without):
        eng.generator.manual_seed(5)
        eng.sampler_state = tsam.init_sampler_state(eng.cfg, "cpu", eng.generator)
    la = [with_maps.train_one_epoch() for _ in range(2)]
    lb = [without.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for name in ("user_emb", "item_emb", "w0"):
        np.testing.assert_allclose(
            getattr(with_maps.state, name).numpy(),
            getattr(without.state, name).numpy(), rtol=1e-6, atol=1e-8,
            err_msg=name)


def test_dedup_epochs_match_jax():
    """Both engines take their dedup path (user-grouped file order)."""
    je, te = _engines(**TILE)
    with pinned_tiles(*_epoch_pins(je)):
        jl = [je.train_one_epoch() for _ in range(2)]
        tl = [te.train_one_epoch() for _ in range(2)]
    assert te._dedup_cache[1] is not None
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_tables_close(te, je)


@pytest.mark.parametrize("order", ["user", "item", "file"])
def test_visit_order_pair_stream_equals_jax(order):
    rng = np.random.default_rng(11)
    jtrain, jtest = jsynthetic(60, 200, clicks_per_user=10, max_his=6, seed=4)
    ttrain, ttest = tsynthetic(60, 200, clicks_per_user=10, max_his=6, seed=4)
    perm = rng.permutation(len(jtrain.pairs))  # an input in no order at all
    jtrain.pairs, ttrain.pairs = jtrain.pairs[perm], ttrain.pairs[perm]
    kw = dict(emb_dim=8, max_his=6, batch_size=128, visit_order=order,
              shuffle_mode="none")
    je = JEngine(JCFConfig(**kw), jtrain, jtest, seed=1)
    te = TEngine(CFConfig(**kw), ttrain, ttest, device="cpu")
    assert te.pairs.dtype == torch.int32
    np.testing.assert_array_equal(te.pairs.numpy(), np.asarray(je.pairs))
    col = {"user": 0, "item": 1}.get(order)
    if col is not None:
        assert (np.diff(te.pairs[:, col].numpy()) >= 0).all()
    for got, want in zip(te._make_batches(te.pairs), je._make_batches(je.pairs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_auto_tile_is_derived_by_the_engine():
    train, test = tsynthetic(30, 500, max_his=4, seed=1)
    cfg = CFConfig(max_his=4, batch_size=64, neg_sampler=1, tile_size=0)
    eng = TEngine(cfg, train, test, device="cpu")
    assert (cfg.tile_size, cfg.refresh_interval) == tsam.derive_tile_params(
        CFConfig(batch_size=64, num_items=500))
    assert eng.sampler_state.tile.shape == (cfg.tile_size,)
    assert np.isfinite(eng.train_one_epoch())


@pytest.mark.parametrize("override", [
    {"neg_sampler": 1, "tile_size": 32, "refresh_interval": 64},
    {"his_refresh": "subepoch"},
    BF16,
    {"compute_dtype": "bfloat16"},
    {"param_dtype": "bfloat16"},
    {"visit_order": "user", "shuffle_mode": "none"},
    {"visit_order": "item"},
    {"neg_sampler": 1, "tile_size": 32, "refresh_interval": 64,
     "his_refresh": "subepoch", "update_mode": "direct", **BF16},
    {"sgd_mode": "accum", **BF16},
    {"optimizer": "adam", **BF16},
], ids=["tile", "pools", "bf16", "bf16-compute", "bf16-tables", "visit-user",
        "visit-item", "headline", "bf16-accum", "bf16-adam"])
def test_fast_path_settings_train_and_evaluate(override):
    """Each setting the engine used to refuse now trains (the loss falls
    over three epochs) and evaluates to finite metrics."""
    train, test = tsynthetic(40, 120, max_his=4, seed=1)
    cfg = CFConfig(max_his=4, emb_dim=16, batch_size=128, l_r=0.05, **override)
    eng = TEngine(cfg, train, test, device="cpu")
    losses = [eng.train_one_epoch() for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    metrics = eng.evaluate(["Recall(k=20)"])
    assert 0.0 <= metrics["Recall(k=20)"] <= 1.0
    assert eng.state.user_emb.dtype == eng.state.item_emb.dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.param_dtype]
    assert eng.evaluate0().dtype == np.float32
