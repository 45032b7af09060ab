"""The attention aggregators of the port (self- and user-attention, the
paper's ACCL configurations) against the JAX package, on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in the port (the kernels' plain versions); states cross by
``state_from_numpy`` (``attn_q`` included); draws are pinned on both sides
to one table indexed by the sampler's sample counter (the pinning of
tests/test_torch_step.py and tests/test_torch_fastpath.py).

Tolerances, stated before the runs:

* f32: rtol 1e-5 / atol 1e-6 (the two packages sum in different orders);
  for trained states the rule of tests/test_torch_step.py
  (``assert_state_array_close``: that tolerance on 99.5% of the elements,
  none off by more than 1e-4 * lr, or 1e-3 * clip_val for a slot), and
  over epochs the rule of tests/test_torch_engine.py. Two exceptions,
  each with its cause (summation-order noise that the rule has no room
  for, not a fault) at its test: the adaptive optimizers' table cap, and
  the learning rate of the engine-level comparisons.
* bf16: the port pools with the JAX package's operations in the same
  order (``models/aggregator.py`` ``_softmax`` is ``jax.nn.softmax`` op by
  op), so the forward is held to one bf16 ulp of each element; the
  backward rounds at other points than the JAX package's transposed
  softmax rule, so gradients are held to 8 bf16 ulps of their largest
  magnitude, and after two bf16 steps the tables to the rule of
  tests/test_torch_fastpath.py (99% of the elements bit-equal, none
  further than 2 ulps), ``w0`` to 2% and ``attn_q`` to 5% of their largest
  move (the query's gradient carries those few ulps whole).

The ``cuda``-marked test runs on the card and skips here: ``python -m
pytest --noconftest -m cuda tests/test_torch_attention.py``; JAX is
imported only inside the tests that compare with it.
"""

import contextlib

import numpy as np
import pytest
import torch

import heat_tpu_torch.train.train_step as tts
from heat_tpu_torch import export as texport
from heat_tpu_torch import serving as tserving
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.models import aggregator as tagg
from heat_tpu_torch.models.state import (
    init_train_state,
    state_from_numpy,
    state_to_numpy,
)
from heat_tpu_torch.testing import (
    assert_state_array_close,
    distinct_id_dataset,
    replayed_equals_eager,
)
from heat_tpu_torch.train import samplers as tsam
from heat_tpu_torch.train.engine import Engine as TEngine

KINDS = ["self_attention", "user_attention"]
TOL = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _ulps_bf16(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude's binade."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    return np.abs(got - want) / ulp


def _f32(x) -> np.ndarray:
    """An array of either package as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _history(seed=0, b=12, h=8, d=16, n=40):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    his = rng.integers(0, n, (b, h)).astype(np.int32)
    lens = rng.integers(0, h + 1, b).astype(np.int32)
    lens[:3] = [0, h, 1]  # an empty history, a full one, a single slot
    query = rng.normal(size=(d,)).astype(np.float32)
    users = rng.normal(size=(b, d)).astype(np.float32)
    cot = rng.normal(size=(b, d)).astype(np.float32)
    return table, his, lens, query, users, cot


# --- pooling -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_pool_history_and_its_gradients_match_jax(kind, dtype):
    """The pooled rows and their gradients with respect to the query
    (``attn_q``, or the user rows) against ``jax.grad``, with empty
    histories, which pool to exactly zero with finite gradients."""
    import jax
    import jax.numpy as jnp
    from heat_tpu.models import aggregator as jagg

    table, his, lens, query, users, cot = _history()
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    embs = table[his]
    jembs, jq, ju = (jnp.asarray(x).astype(jt) for x in (embs, query, users))
    jlens = jnp.asarray(lens)

    def jloss(q, u):
        out = jagg.pool_history(jembs, jlens, u=u, attn_q=q, kind=kind)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jgq, jgu) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jq, ju)
    tq = torch.from_numpy(query).to(tt).requires_grad_()
    tu = torch.from_numpy(users).to(tt).requires_grad_()
    tout = tagg.pool_history(torch.from_numpy(embs).to(tt),
                             torch.from_numpy(lens), u=tu, attn_q=tq, kind=kind)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    assert tout.dtype == tt and jout.dtype == jt
    assert not tout[lens == 0].any()
    leaf, jgrad = (tq, jgq) if kind == "self_attention" else (tu, jgu)
    assert (tu.grad is None) == (kind == "self_attention")
    assert torch.isfinite(leaf.grad).all()
    if dtype == "float32":
        np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
        np.testing.assert_allclose(_f32(leaf.grad), _f32(jgrad), **TOL)
    else:
        assert _ulps_bf16(_f32(tout), _f32(jout)).max() <= 1
        top = np.abs(_f32(jgrad)).max()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert np.abs(_f32(leaf.grad) - _f32(jgrad)).max() <= 8 * ulp


def test_bf16_rows_with_an_f32_query_pool_in_f32_as_in_jax():
    """Serving passes the f32 ``attn_q`` against bf16 rows: ``jnp.einsum``
    promotes the pair, and so does the port; the pooled rows are f32
    (exact products of bf16 values, f32 sums)."""
    import jax.numpy as jnp
    from heat_tpu.models import aggregator as jagg

    table, his, lens, query, _, _ = _history(seed=1)
    embs16 = jnp.asarray(table[his]).astype(jnp.bfloat16)
    want = jagg.pool_history(embs16, jnp.asarray(lens),
                             attn_q=jnp.asarray(query), kind="self_attention")
    got = tagg.pool_history(torch.from_numpy(_f32(embs16)).bfloat16(),
                            torch.from_numpy(lens), attn_q=torch.from_numpy(query),
                            kind="self_attention")
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL)


def test_pool_history_refuses_what_it_cannot_pool():
    table, his, lens, *_ = _history()
    embs, lens = torch.from_numpy(table[his]), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="attn_q"):
        tagg.pool_history(embs, lens, kind="self_attention")
    with pytest.raises(ValueError, match="user embeddings"):
        tagg.pool_history(embs, lens, kind="user_attention")
    with pytest.raises(ValueError, match="unknown aggregator"):
        tagg.pool_history(embs, lens, kind="max")
    with pytest.raises(ValueError, match="unknown aggregator"):
        tagg.user_pools_impl(torch.from_numpy(table), torch.from_numpy(his),
                             lens, aggregator="max")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_user_pools_match_jax(kind, dtype):
    """All users' pools in chunks of 7 of 30 users (a partial last chunk),
    against the JAX function in chunks of 7; the default chunk and a given
    ``out`` buffer give the same bits. Under self-attention a bf16 table
    pools in f32 against the f32 query, which both packages refuse to write
    into the table-typed pools (``TypeError``).

    bf16: the JAX function traces its chunk loop (``fori_loop``) into one
    compiled program, whose softmax does not round at every operation as
    its eager ``pool_history`` does (measured: the JAX package's compiled
    pools 1.94 x 2^-8 of the history rows' largest magnitude off its own
    eager pools). So the port is held to one bf16 ulp of the eager JAX
    pooling of the same rows (the bound of the module docstring), and to
    4 x 2^-8 of each user's largest |row| element by element of the
    compiled JAX pools: a weight off by an ulp moves the weighted sum by
    at most 2^-8 of the largest row, the final rounding as much again."""
    import jax.numpy as jnp
    from heat_tpu.models import aggregator as jagg

    table, his, lens, query, users, _ = _history(b=30)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = (jnp.asarray(table).astype(jt), jnp.asarray(his), jnp.asarray(lens))
    targs = (torch.from_numpy(table).to(tt), torch.from_numpy(his),
             torch.from_numpy(lens))
    jkw = dict(user_emb=jnp.asarray(users).astype(jt), attn_q=jnp.asarray(query),
               aggregator=kind)
    tkw = dict(user_emb=torch.from_numpy(users).to(tt),
               attn_q=torch.from_numpy(query), aggregator=kind)
    if kind == "self_attention" and dtype == "bfloat16":
        with pytest.raises(TypeError):
            jagg.user_pools_impl(*jargs, chunk=7, **jkw)
        with pytest.raises(TypeError, match="attn_q"):
            tagg.user_pools_impl(*targs, chunk=7, **tkw)
        return
    want = jagg.user_pools_impl(*jargs, chunk=7, **jkw)
    got = tagg.user_pools_impl(*targs, chunk=7, **tkw)
    assert got.dtype == tt and got.shape == (30, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _f32(want), **TOL)
    else:
        rows = jargs[0][jargs[1]]
        eager = jagg.pool_history(rows, jargs[2], u=jkw["user_emb"], kind=kind)
        assert _ulps_bf16(_f32(got), _f32(eager)).max() <= 1
        scale = np.abs(_f32(rows)).max(1)  # (U, d): each user's largest |row|
        assert (np.abs(_f32(got) - _f32(want)) <= 4 * 2.0**-8 * scale).all()
    out = torch.full_like(got, 7.0)
    assert tagg.user_pools_impl(*targs, out=out, **tkw) is out
    assert torch.equal(out, got)


# --- the step ------------------------------------------------------------------


def _jax_step_inputs(tcfg_kw, **extra):
    """The batch, histories and pins of tests/test_torch_step.py (uniform)
    or tests/test_torch_fastpath.py (tile), for an attention config."""
    if tcfg_kw.get("neg_sampler") == 1:
        from test_torch_fastpath import _step_setup, pinned_tiles

        out = _step_setup(**tcfg_kw, **extra)
        return out, pinned_tiles(*out[5])
    from test_torch_step import _setup, pinned_negatives

    out = _setup(0.05, 0.02, **tcfg_kw, **extra)
    return out, pinned_negatives(out[5])


STEP_VARIANTS = {
    "uniform": {},
    "sorted": {"sort": True},
    "direct": {"update_mode": "direct"},
    "adagrad": {"optimizer": "adagrad"},
    "adam": {"optimizer": "adam"},
    "tile": {"neg_sampler": 1, "tile_size": 32, "refresh_interval": 256},
    "accum": {"sgd_mode": "accum"},
}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
@pytest.mark.parametrize("kind", KINDS)
def test_attention_step_matches_jax(monkeypatch, kind, variant):
    """Two f32 steps (the second reads the first's tables and query) and a
    third on an all-padding batch, which leaves everything but the sampler
    untouched: ``attn_q`` and its slots included. Losses rtol 1e-5;
    states by ``assert_state_array_close`` at rtol 1e-5 / atol 1e-6.

    Under Adagrad and Adam the parameters' cap is 1e-3 * lr, not 1e-4:
    their first step moves an element by lr * g / (|g| + eps), and where a
    combined gradient cancels to about eps (item element (3, 8) here: 2e-7)
    the summation-order noise of g is a large share of g. The attention
    kinds' longer chain carries more of it: measured 5.0-7.6e-6 against the
    mean's 2.9e-6, at that one element of 1,440 (the share rule holds); a
    wrong update moves an element by about lr. ``attn_q`` has 16 elements,
    so one such element is 6% of it and no share rule can hold: under
    these optimizers each of its elements is held to the cap alone
    (measured: one element 2.4-3.0e-6 off)."""
    import jax
    import jax.numpy as jnp
    import heat_tpu.train.scatter as jsc
    import heat_tpu.train.train_step as jts
    import heat_tpu_torch.train.scatter as tsc
    from heat_tpu.models.state import init_train_state as jinit
    from heat_tpu.train import samplers as jsam
    from test_torch_step import torch_state_of

    extra = dict(STEP_VARIANTS[variant])
    if extra.pop("sort", False):  # both tables on the sort-dedup path
        monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    tile = extra.get("neg_sampler") == 1
    (jcfg, tcfg, (users, pos, weight), his, masks, _), pins = _jax_step_inputs(
        extra, aggregator=kind)
    jstate = jinit(jcfg, jax.random.key(1))
    assert (jstate.attn_q is None) == (kind == "user_attention")
    tstate = torch_state_of(jstate)
    pad = np.zeros_like(weight)
    batches = [(users, pos, weight)] * 2 + [(users, pos, pad)]
    with pins:
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
                tstate, tss, torch.Generator(),
                tts.Batch(*map(torch.from_numpy, arrays)),
                torch.from_numpy(his), torch.from_numpy(masks), tcfg,
            )
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    after = state_to_numpy(tstate)
    want = state_to_numpy(torch_state_of(jstate))
    assert set(after) == set(want)
    assert ("attn_q" in after) == (kind == "self_attention")
    slots = after.pop("opt_slots", {})
    assert set(slots) == set(want.get("opt_slots", {}))
    if kind == "self_attention" and slots:
        assert "attn_q_v" in slots
    cap = 1e-3 * jcfg.l_r if jcfg.optimizer != "sgd" else None
    for name, got in [*after.items(), *slots.items()]:
        exp = want["opt_slots"][name] if name in slots else want[name]
        if name == "attn_q" and cap is not None:
            assert np.abs(got - exp).max() <= cap
        else:
            assert_state_array_close(got, exp, name, lr=jcfg.l_r,
                                     clip_val=jcfg.clip_val, cap=cap, **TOL)
        prev = before["opt_slots"][name] if name in slots else before[name]
        if name not in ("lr", "step"):  # the padding batch: no change
            np.testing.assert_array_equal(got, prev, err_msg=name)
    if kind == "self_attention":  # the query trained
        start = np.asarray(jinit(jcfg, jax.random.key(1)).attn_q)
        assert np.abs(after["attn_q"] - start).max() > 0
    assert int(after["step"]) == int(jstate.step) == 2
    if tile:
        np.testing.assert_array_equal(tss.tile.numpy(), np.asarray(jss.tile))


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_attention_tile_step_matches_jax(kind):
    """Two tile-path steps with bf16 tables and compute (the ACCL rows of
    the JAX bench in their step form), the JAX step run op by op so that
    it rounds where the port does; held to the bf16 bounds of the module
    docstring, losses rtol 1e-4."""
    import jax
    import jax.numpy as jnp
    import heat_tpu.train.train_step as jts
    from heat_tpu.models.state import init_train_state as jinit
    from heat_tpu.train import samplers as jsam
    from test_torch_step import torch_state_of

    extra = dict(STEP_VARIANTS["tile"], **BF16)
    (jcfg, tcfg, batch, his, masks, _), pins = _jax_step_inputs(
        extra, aggregator=kind)
    jstate0 = jstate = jinit(jcfg, jax.random.key(1))
    tstate = state_from_numpy(
        jstate.user_emb, jstate.item_emb, jstate.w0, lr=jcfg.l_r, step=0,
        device="cpu", param_dtype=torch.bfloat16,
        attn_q=None if jstate.attn_q is None else np.asarray(jstate.attn_q))
    assert tstate.item_emb.dtype == torch.bfloat16
    with pins:
        jss = jsam.init_sampler_state(jcfg, jax.random.key(2))
        tss = tsam.init_sampler_state(tcfg, "cpu", torch.Generator().manual_seed(0))
        for _ in range(2):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3),
                jts.Batch(*map(jnp.asarray, batch)), jnp.asarray(his),
                jnp.asarray(masks), jcfg)
            tstate, tss, tloss = tts.train_step(
                tstate, tss, None, tts.Batch(*map(torch.from_numpy, batch)),
                torch.from_numpy(his), torch.from_numpy(masks), tcfg)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    got = state_to_numpy(tstate)
    want = state_to_numpy(torch_state_of(jstate))
    for name in ("user_emb", "item_emb"):
        ulps = _ulps_bf16(got[name], want[name])
        assert (ulps == 0).mean() >= 0.99, (name, (ulps == 0).mean())
        assert ulps.max() <= 2, (name, ulps.max())
    for name, share in (("w0", 0.02), ("attn_q", 0.05)):
        if name not in want:
            continue
        move = np.abs(want[name] - np.asarray(getattr(jstate0, name))).max()
        assert move > 0
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=share * move, err_msg=name)


def _dedup_maps(users):
    uu, first, inv = np.unique(users, return_index=True, return_inverse=True)
    bu = -(-len(uu) // 8) * 8
    uu_p = np.full(bu, uu[0], np.int32)
    uf_p = np.full(bu, first[0], np.int32)
    uu_p[: len(uu)], uf_p[: len(uu)] = uu, first
    return [torch.from_numpy(a.astype(np.int32)) for a in (uu_p, inv, uf_p)]


@pytest.mark.parametrize("kind", KINDS)
def test_dedup_step_equals_the_step_without(kind):
    """The counterpart of tests/test_engine.py's single-step attention
    dedup check, on a sorted batch of 32 with repeated users: pooling once
    per distinct user (the user-attention query sliced from the first
    occurrence) and reading back per sample. The forward is the same
    arithmetic per user row, so the loss is bit-equal. The gradients are
    not summed in the same order: the per-sample query gradients of a
    repeated user are summed by the backward of the read-back
    (``index_select``) before the user row update adds them to the blend's,
    where without the maps each occurrence's whole gradient is added there
    (and ``attn_q``'s gradient is a sum over 32 samples in one form, over
    the distinct users in the other): tables and ``attn_q`` rtol 1e-6 /
    atol 1e-8. Without ``uniq_first`` the user-attention dedup raises."""
    rng = np.random.default_rng(1)
    cfg = CFConfig(emb_dim=16, num_users=50, num_items=80, max_his=6,
                   num_negs=4, batch_size=32, l_r=0.05, clip_val=1.0,
                   aggregator=kind)
    users = np.sort(rng.integers(0, 50, 32)).astype(np.int32)
    assert len(np.unique(users)) < 32
    batch = tts.Batch(torch.from_numpy(users),
                      torch.from_numpy(rng.integers(0, 80, 32).astype(np.int32)),
                      torch.ones(32))
    his = torch.from_numpy(rng.integers(0, 80, (50, 6)).astype(np.int32))
    masks = torch.from_numpy(rng.integers(1, 7, 50).astype(np.int32))
    uu, inv, uf = _dedup_maps(users)
    out = []
    for maps in ({}, dict(uniq_users=uu, uniq_inverse=inv, uniq_first=uf)):
        gen = torch.Generator().manual_seed(5)
        state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        ss = tsam.init_sampler_state(cfg, "cpu", gen)
        state, _, loss = tts.train_step(state, ss, gen, batch, his, masks, cfg,
                                        **maps)
        out.append((float(loss), state))
    (l1, s1), (l2, s2) = out
    assert l1 == l2
    for name in ("user_emb", "item_emb", "w0", "attn_q"):
        a, b = getattr(s1, name), getattr(s2, name)
        assert (a is None) == (b is None) == (
            name == "attn_q" and kind == "user_attention")
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-8, msg=name)
    if kind == "user_attention":
        state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(5)
        with pytest.raises(ValueError, match="uniq_first"):
            tts.train_step(state, tsam.init_sampler_state(cfg, "cpu", gen), gen,
                           batch, his, masks, cfg, uniq_users=uu, uniq_inverse=inv)


# --- the engine ----------------------------------------------------------------

# lr 0.01, not tests/test_torch_fastpath.py's 0.05: at 0.05 the
# user-attention pools carry the two packages' summation-order noise into
# every sample's aggregated row, and it grew past the cap within two epochs
# (measured: 1.9% of lr * clip_val at one item element after epoch 2, 0.03%
# after epoch 1; the mean at the same geometry 0.06%); at 0.01 it stays at
# 0.008%. tests/test_torch_subepochs.py lowers its lr for the same reason,
# and the JAX package records attention training as chaotic
# (tests/test_engine.py, the attention dedup check).
LR, CLIP = 0.01, 0.1


def _engines(users=80, items=300, **override):
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.data.synthetic import synthetic_click_dataset as jsynthetic
    from heat_tpu.train.engine import Engine as JEngine
    from test_torch_step import torch_state_of

    kw = dict(emb_dim=16, max_his=6, num_negs=4, batch_size=256, l_r=LR,
              clip_val=CLIP, shuffle_mode="none", seed=21)
    kw.update(override)
    jtrain, jtest = jsynthetic(users, items, clicks_per_user=12, max_his=6, seed=9)
    ttrain, ttest = tsynthetic(users, items, clicks_per_user=12, max_his=6, seed=9)
    je = JEngine(JCFConfig(**kw), jtrain, jtest, seed=21)
    te = TEngine(CFConfig(**kw), ttrain, ttest, device="cpu")
    te.state = torch_state_of(je.state)
    return je, te


def test_history_dedup_maps_equal_jax_and_the_direct_gate():
    """On the user-grouped file order both engines give the same three
    maps (the first occurrences too) under self-attention and under
    user-attention with combined updates; under user-attention with
    ``update_mode: direct`` both give none (the JAX engine's gate: the
    query's gradient concentrated on one occurrence would be clipped
    otherwise), and the epoch still trains."""
    for override, applies in (
            (dict(aggregator="self_attention"), True),
            (dict(aggregator="user_attention"), True),
            (dict(aggregator="user_attention", update_mode="direct"), False),
            (dict(aggregator="self_attention", update_mode="direct"), True)):
        je, te = _engines(**override)
        jusers, _, _ = je._make_batches(je.pairs)
        tusers, _, _ = te._make_batches(te.pairs)
        want = je._history_dedup(je.pairs, jusers)
        got = te._history_dedup(te.pairs, tusers)
        assert (want is not None) == (got is not None) == applies, override
        if applies:
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert np.isfinite(te.train_one_epoch())


@contextlib.contextmanager
def _pinned(je, epochs=2):
    from test_torch_fastpath import pinned_tiles
    from test_torch_step import pinned_negatives

    cfg = je.cfg
    rng = np.random.default_rng(3)
    n = epochs * cfg.train_size + cfg.batch_size
    if cfg.neg_sampler == 1:
        tiles = rng.integers(0, cfg.num_items, (7, cfg.tile_size)).astype(np.int32)
        idx = rng.integers(0, cfg.tile_size, (n, cfg.num_negs)).astype(np.int32)
        with pinned_tiles(tiles, idx):
            yield
    else:
        draws = rng.integers(0, cfg.num_items, (n, cfg.num_negs)).astype(np.int32)
        with pinned_negatives(draws):
            yield


ENGINE_CASES = {
    # self-attention pools every step (his_refresh: step); the user-grouped
    # file order takes the dedup maps.
    "self_step": dict(aggregator="self_attention"),
    # user-attention over the per-epoch pools, tile sampler.
    "user_pools": dict(aggregator="user_attention", his_refresh="subepoch",
                       neg_sampler=1, tile_size=32, refresh_interval=256),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_epochs_and_aggregated_evaluation_match_jax(case):
    """Two epochs of both engines from one state with pinned draws: losses
    rtol 1e-4, tables, ``w0`` and ``attn_q`` by the rule of
    tests/test_torch_engine.py (rtol 1e-4 / atol 1e-6 on 98% of the
    elements, none off by more than 1e-2 of lr * clip_val), ``step`` equal.
    Then both evaluate the JAX engine's trained state with freshly
    aggregated users: metrics within 1e-6."""
    je, te = _engines(**ENGINE_CASES[case])
    if case == "self_step":
        assert te._history_dedup(te.pairs, te._make_batches(te.pairs)[0])
    with _pinned(je):
        jl = [je.train_one_epoch() for _ in range(2)]
        tl = [te.train_one_epoch() for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[1] < tl[0]
    names = ["user_emb", "item_emb", "w0"]
    if case == "self_step":
        names.append("attn_q")
    for name in names:
        got = _f32(getattr(te.state, name))
        want = _f32(getattr(je.state, name))
        diff = np.abs(got - want)
        assert (diff <= 1e-6 + 1e-4 * np.abs(want)).mean() >= 0.98, name
        assert diff.max() <= 1e-2 * LR * CLIP, (name, diff.max())
    assert int(te.state.step) == int(je.state.step)

    from test_torch_step import torch_state_of

    te.state = torch_state_of(je.state)
    want = je.evaluate(aggregate_users=True)
    got = te.evaluate(aggregate_users=True)
    raw = te.evaluate()
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-6, (m, got[m], want[m])
    assert any(abs(got[m] - raw[m]) > 1e-4 for m in want)  # it aggregated


def test_user_attention_subepochs_match_jax():
    """User-attention over pools refreshed once a sub-epoch, two sub-epochs
    with the tile sampler, against the JAX engine's per-bucket path with
    pinned draws (the permutation needs no pinning), and the port's two
    forms bit-equal: the harness and rules of
    tests/test_torch_subepochs.py."""
    from test_torch_subepochs import TILE, run_against_jax

    run_against_jax(num_subepochs=2, aggregator="user_attention",
                    his_refresh="subepoch", **TILE)


def test_cli_trains_the_attention_kinds(capsys):
    """``--set aggregator=...`` is all the CLI needs."""
    from heat_tpu_torch import main as tmain

    for kind in KINDS:
        record = tmain.main([
            "--config", "benchmarks/AmazonBooks/config0.yaml", "--synthetic",
            "60,120", "--epochs", "2", "--device", "cpu", "--set",
            f"aggregator={kind}", "--set", "batch_size=128"])
        assert len(record["losses"]) == 2 and np.isfinite(record["losses"]).all()
        assert 0.0 <= record["final_metrics"]["Recall(k=20)"] <= 1.0
    capsys.readouterr()


# --- serving and export ------------------------------------------------------


def _model(seed=7, u=300, i=4500, d=16, h=8):
    rng = np.random.default_rng(seed)
    user = rng.normal(size=(u, d)).astype(np.float32)
    item = rng.normal(size=(i, d)).astype(np.float32)
    w0 = (rng.normal(size=(d, d)) * 0.3).astype(np.float32)
    query = rng.normal(size=(d,)).astype(np.float32)
    seen = np.stack(
        [np.repeat(np.arange(u), 12),
         np.concatenate([rng.choice(i, 12, replace=False) for _ in range(u)])],
        axis=1).astype(np.int32)
    his = seen[:, 1].reshape(u, 12)[:, :h].copy()
    lens = rng.integers(0, h + 1, u).astype(np.int32)
    lens[:3] = [0, h, 1]
    return dict(user=user, item=item, w0=w0, query=query, seen=seen, his=his,
                lens=lens)


def _recommenders(m, kind, bf16=False):
    import jax.numpy as jnp
    import heat_tpu.serving as jserving
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.models.state import TrainState as JTrainState

    kw = dict(emb_dim=16, max_his=8, gamma=0.4, aggregator=kind)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    user, item = (jnp.asarray(m[k]).astype(jt) for k in ("user", "item"))
    query = m["query"] if kind == "self_attention" else None
    j = jserving.Recommender(
        JTrainState(user_emb=user, item_emb=item, w0=jnp.asarray(m["w0"]),
                    user_gacc=None, item_gacc=None, lr=jnp.float32(0.05),
                    step=jnp.int32(0),
                    attn_q=None if query is None else jnp.asarray(query)),
        JCFConfig(**kw), seen_pairs=m["seen"], his_items=m["his"],
        his_masks=m["lens"])
    t = tserving.Recommender(
        state_from_numpy(_f32(user), _f32(item), m["w0"], lr=0.05, step=0,
                         device="cpu", attn_q=query,
                         param_dtype=torch.bfloat16 if bf16 else torch.float32),
        CFConfig(**kw), seen_pairs=m["seen"], his_items=m["his"],
        his_masks=m["lens"])
    return j, t


UIDS = [0, 1, 2, 5, 17, 42, 123, 299]


@pytest.mark.parametrize("kind", KINDS)
def test_recommender_serves_the_attention_kinds_like_jax(kind):
    """``recommend`` and ``recommend_all`` with freshly aggregated users,
    tie-aware against the JAX package's (scores from the JAX package's
    aggregated rows); a request ranks as ``recommend_all`` does; cold users
    (no trained row: self-attention with ``attn_q``, user-attention with
    the history mean as the query) against the JAX package's."""
    from heat_tpu.models import aggregator as jagg
    from test_torch_serving import assert_same_topk

    m = _model()
    j, t = _recommenders(m, kind)
    jrows = np.asarray(j._user_embeddings(True), np.float64)
    trows = t._user_embeddings(True).numpy()
    np.testing.assert_allclose(trows, jrows, **TOL)
    scores = jrows @ m["item"].T.astype(np.float64)
    got = t.recommend(UIDS, 21, aggregate_users=True)
    assert_same_topk(got, j.recommend(UIDS, 21, aggregate_users=True),
                     scores[UIDS], 20)
    got_all = t.recommend_all(21, aggregate_users=True)
    assert_same_topk(got_all, j.recommend_all(21, aggregate_users=True),
                     scores, 20)
    assert_same_topk(got, got_all[UIDS], scores[UIDS], 20)

    rng = np.random.default_rng(11)
    hist = [rng.choice(4500, int(n), replace=False).tolist()
            for n in rng.integers(1, 30, 40)]
    hist[3] = []
    jcold = np.asarray(j.recommend_cold(hist, 21))
    tcold = t.recommend_cold(hist, 21)
    assert tcold.dtype == np.int32 and tcold.shape == (40, 21)
    # The cold users' scores, from the JAX package's pooling.
    ids = np.zeros((40, 29), np.int32)
    lens = np.array([len(h) for h in hist], np.int32)
    for r, h in enumerate(hist):
        ids[r, : len(h)] = h
    embs = m["item"][ids]
    query = jagg.pool_history(embs, lens, kind="mean")
    pooled = np.asarray(jagg.pool_history(
        embs, lens, u=query, attn_q=m["query"], kind=kind), np.float64)
    uc = 0.6 * pooled @ m["w0"]
    uc /= np.maximum(np.linalg.norm(uc, axis=1, keepdims=True), 1e-12)
    it = m["item"] / np.linalg.norm(m["item"], axis=1, keepdims=True)
    cold_scores = uc @ it.T
    for r, h in enumerate(hist):
        cold_scores[r, h] = -np.inf
    assert_same_topk(tcold, jcold, cold_scores, 20)
    for row, h in zip(tcold, hist):
        assert not set(row.tolist()) & set(h)


def test_bf16_self_attention_serving_follows_jax():
    """Over bf16 tables the f32 query pools a request's rows in f32 in both
    packages, so aggregated requests are served; the whole-table pools
    cannot be written into a bf16 table of pools, so ``recommend_all`` with
    aggregated users raises ``TypeError`` in both. Requests without
    aggregation are unaffected."""
    from test_torch_serving import assert_same_topk

    m = _model()
    j, t = _recommenders(m, "self_attention", bf16=True)
    jrows = np.asarray(j._user_rows(np.asarray(UIDS, np.int32), True))
    trows = t._user_rows(torch.tensor(UIDS, dtype=torch.int32), True)
    assert jrows.dtype == np.float32 and trows.dtype == torch.float32
    np.testing.assert_allclose(trows.numpy(), jrows, **TOL)
    scores = jrows.astype(np.float64) @ _f32(t.state.item_emb).T.astype(np.float64)
    assert_same_topk(t.recommend(UIDS, 21, aggregate_users=True),
                     j.recommend(UIDS, 21, aggregate_users=True), scores, 20)
    with pytest.raises(TypeError):
        j.recommend_all(5, aggregate_users=True)
    with pytest.raises(TypeError):
        t.recommend_all(5, aggregate_users=True)
    assert t.recommend(UIDS, 5).shape == (len(UIDS), 5)


def test_export_round_trip_carries_attn_q(tmp_path):
    """A self-attention engine's export holds ``attn_q`` under the JAX
    package's key; loaded back through ``state_from_numpy`` it serves what
    ``Recommender.from_engine`` serves (a snapshot, ``attn_q`` copied)."""
    train, test = tsynthetic(60, 120, max_his=6, seed=1)
    e = TEngine(CFConfig(max_his=6, emb_dim=16, batch_size=64,
                         aggregator="self_attention"), train, test, device="cpu")
    e.train_one_epoch()
    live = tserving.Recommender.from_engine(e)
    assert live.state.attn_q is not e.state.attn_q
    assert torch.equal(live.state.attn_q, e.state.attn_q)
    path = str(tmp_path / "emb.npz")
    texport.export_embeddings(e.unpadded_state(), path, e.cfg)
    arrays = texport.load_embeddings(path)
    assert set(arrays) >= {"user_emb", "item_emb", "w0", "attn_q"}
    np.testing.assert_array_equal(arrays["attn_q"], e.state.attn_q.numpy())
    state = state_from_numpy(arrays["user_emb"], arrays["item_emb"],
                             arrays["w0"], lr=0.0, step=0, device="cpu",
                             attn_q=arrays["attn_q"])
    loaded = tserving.Recommender(state, e.cfg, seen_pairs=train.pairs,
                                  his_items=train.his_items,
                                  his_masks=train.masks)
    uids = list(range(20))
    np.testing.assert_array_equal(
        loaded.recommend(uids, 10, aggregate_users=True),
        live.recommend(uids, 10, aggregate_users=True))
    np.testing.assert_array_equal(loaded.recommend_cold([[1, 2, 3], [4]], 10),
                                  live.recommend_cold([[1, 2, 3], [4]], 10))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("override", [
    dict(aggregator="self_attention"),
    dict(aggregator="user_attention", neg_sampler=1, tile_size=16,
         refresh_interval=32, his_refresh="subepoch", update_mode="direct",
         **BF16),
    dict(aggregator="self_attention", neg_sampler=1, tile_size=16,
         refresh_interval=32, update_mode="direct", **BF16),
], ids=["self_config0", "user_pools_bf16", "self_tile_bf16"])
def test_replayed_attention_epochs_are_bit_equal_to_eager(cuda, override):
    """On clicks that repeat no user and no item (4,000,000 items: no row
    takes two adds in a step), two replayed epochs of three steps equal two
    eager ones bit for bit after each epoch, ``attn_q`` included: the
    history rows through K2, the pooling in the captured step."""
    data = distinct_id_dataset(48, 4_000_000, 6)
    cfg = CFConfig(emb_dim=64, max_his=6, batch_size=16, num_negs=2, **override)
    out = replayed_equals_eager(lambda: TEngine(cfg, data, device=cuda), 2)
    assert out["steps"] == 6 and out["captures"] == 1
