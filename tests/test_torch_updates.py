"""The port's row-update menu (``heat_tpu_torch/train/scatter.py``) against
the JAX package's ``heat_tpu/train/scatter.py``.

The same seeded numpy inputs go through both: the dense-accumulator and
sort-dedup paths (the sorted one forced at a small size by lowering
``DENSE_ROWS_THRESHOLD`` in both packages), with and without the fused
write-back, l2 and the accum rows; the direct update; row-sparse Adagrad
and lazy Adam; ``dense_opt_update``; and the plain version of S1 against
``.at[ids].set(mode="drop")``. Tolerance rtol 1e-5 / atol 1e-6 unless a
test says otherwise: the two packages sum repeated ids in different
orders. Also: the port updates in place, an all-sentinel batch leaves
every table bit-equal, and the state's gradient rows and slots survive
the numpy round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.train.scatter as jsc
import heat_tpu_torch.train.scatter as tsc
from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.models.state import init_train_state as jinit
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.state import (
    init_train_state,
    state_from_numpy,
    state_to_numpy,
    zero_grad_accumulators,
)
from heat_tpu_torch.ops.cuda.scatter import scatter_set_rows, scatter_set_rows_ref

TOL = dict(rtol=1e-5, atol=1e-6)
N, D, M = 50, 8, 64


@pytest.fixture(params=["dense", "sorted"])
def path(request, monkeypatch):
    """Force the sort-dedup path in both packages below 50 rows."""
    if request.param == "sorted":
        monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    return request.param


def _case(seed, n=N, d=D, m=M):
    """A table, ids with repeats and ~15% sentinels (== n), gradients,
    per-id identical write-back rows and accumulator rows."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, m).astype(np.int32)
    ids[:6] = 3  # a heavy repeat
    ids[m // 2:] = np.where(rng.random(m - m // 2) < 0.3, n, ids[m // 2:])
    grads = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    per_id = rng.normal(size=(n + 1, d)).astype(np.float32)
    wb = per_id[ids]  # repeated ids carry identical rows
    gacc = (rng.normal(size=(n, d)) * 0.1).astype(np.float32)
    return table, ids, grads, wb, gacc


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def test_segment_sum_by_id_matches_jax():
    """Stable sorts on both sides: the same representative ids in the same
    order, and the same sums."""
    _, ids, grads, _, _ = _case(0)
    jrep, jsum = jsc.segment_sum_by_id(jnp.asarray(ids), jnp.asarray(grads), N)
    trep, tsum = tsc.segment_sum_by_id(_t(ids), _t(grads), N)
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), **TOL)
    assert trep.dtype == torch.int32
    unused = trep.numpy() == N
    assert unused.sum() > 0 and not tsum.numpy()[np.flatnonzero(unused)[1:]].any()


@pytest.mark.parametrize("mode", ["batch", "writeback", "accum"])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_row_updates_matches_jax(path, mode, l2, seed):
    """clip_val 0.25 binds often, so the clip-after-combine order shows."""
    table, ids, grads, wb, gacc = _case(seed)
    kw = dict(clip_val=0.25, decay=0.4 if mode == "accum" else 1.0, l2=l2)
    jt, jg = jsc.apply_row_updates(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        lr=jnp.float32(0.1),
        gacc=jnp.asarray(gacc) if mode == "accum" else None,
        writeback=jnp.asarray(wb) if mode == "writeback" else None, **kw,
    )
    tt, tg = _t(table), _t(gacc) if mode == "accum" else None
    out_t, out_g = tsc.apply_row_updates(
        tt, _t(ids), _t(grads), lr=torch.tensor(0.1), gacc=tg,
        writeback=_t(wb) if mode == "writeback" else None, **kw,
    )
    assert out_t is tt and out_g is tg  # in place
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    if mode == "accum":
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    untouched = np.setdiff1d(np.arange(N), ids)
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("writeback", [False, True])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_apply_row_updates_direct_matches_jax(writeback, l2):
    """Per-occurrence clip and l2 against the forward rows; the repeated
    id's increments add up (K3 order vs XLA's: rtol 1e-5)."""
    table, ids, grads, wb, _ = _case(2)
    rows = np.random.default_rng(9).normal(size=grads.shape).astype(np.float32)
    kw = dict(clip_val=0.25, l2=l2)
    want = jsc.apply_row_updates_direct(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        lr=jnp.float32(0.1), rows=jnp.asarray(rows) if l2 else None,
        writeback=jnp.asarray(wb) if writeback else None, **kw,
    )
    tt = _t(table)
    got = tsc.apply_row_updates_direct(
        tt, _t(ids), _t(grads), lr=torch.tensor(0.1),
        rows=_t(rows) if l2 else None,
        writeback=_t(wb) if writeback else None, **kw,
    )
    assert got is tt
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_direct_l2_without_rows_raises():
    table, ids, grads, _, _ = _case(2)
    with pytest.raises(ValueError, match="needs rows"):
        tsc.apply_row_updates_direct(
            _t(table), _t(ids), _t(grads), lr=torch.tensor(0.1),
            clip_val=0.25, l2=0.01,
        )


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("writeback", [False, True])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_apply_row_updates_opt_matches_jax(path, adam, writeback, l2):
    """Two updates in a row from non-zero slots (step 3, then 4): the
    second reads the first's slots. Untouched rows' slots stay as they
    were (lazy moments)."""
    table, ids, grads, wb, _ = _case(4)
    rng = np.random.default_rng(5)
    v = (rng.normal(size=table.shape) ** 2 * 0.01).astype(np.float32)
    m = (rng.normal(size=table.shape) * 0.1).astype(np.float32) if adam else None
    kw = dict(clip_val=0.25, beta1=0.9, beta2=0.999, eps=1e-8, l2=l2)
    jt, jm, jv = jnp.asarray(table), None if m is None else jnp.asarray(m), jnp.asarray(v)
    tt, tm, tv = _t(table), None if m is None else _t(m), _t(v)
    for step in (3, 4):
        jt, jm, jv = jsc.apply_row_updates_opt(
            jt, jnp.asarray(ids), jnp.asarray(grads), lr=jnp.float32(0.05),
            step=jnp.int32(step), m=jm, v=jv,
            writeback=jnp.asarray(wb) if writeback else None, **kw,
        )
        out = tsc.apply_row_updates_opt(
            tt, _t(ids), _t(grads), lr=torch.tensor(0.05),
            step=torch.tensor(step, dtype=torch.int32), m=tm, v=tv,
            writeback=_t(wb) if writeback else None, **kw,
        )
        assert out[0] is tt and out[1] is tm and out[2] is tv
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    untouched = np.setdiff1d(np.arange(N), ids)
    np.testing.assert_array_equal(tv.numpy()[untouched], v[untouched])
    if adam:
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_array_equal(tm.numpy()[untouched], m[untouched])


@pytest.mark.parametrize("adam", [False, True])
def test_dense_opt_update_matches_jax(adam):
    rng = np.random.default_rng(6)
    w0, g = (rng.normal(size=(D, D)).astype(np.float32) for _ in range(2))
    slots = {"w0_v": (rng.normal(size=(D, D)) ** 2).astype(np.float32)}
    if adam:
        slots["w0_m"] = rng.normal(size=(D, D)).astype(np.float32)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    jw, js = jsc.dense_opt_update(
        jnp.asarray(w0), jnp.asarray(g),
        {k: jnp.asarray(x) for k, x in slots.items()}, "w0",
        lr=jnp.float32(0.05), step=jnp.int32(2), **kw,
    )
    tslots = {k: _t(x) for k, x in slots.items()}
    tw, ts = tsc.dense_opt_update(
        _t(w0), _t(g), tslots, "w0", lr=torch.tensor(0.05),
        step=torch.tensor(2, dtype=torch.int32), **kw,
    )
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert set(ts) == set(js) == set(slots)
    for k in slots:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)
        np.testing.assert_array_equal(tslots[k].numpy(), slots[k])  # not in place


def test_scatter_set_rows_ref_matches_jax_drop():
    """Exact: the sentinel N and ids past it are dropped; repeated ids
    carry identical rows."""
    table, ids, _, wb, _ = _case(7)
    ids[-3:] = [N + 1, N + 40, N]
    want = jnp.asarray(table).at[jnp.asarray(ids)].set(jnp.asarray(wb), mode="drop")
    got = scatter_set_rows_ref(_t(table), _t(ids), _t(wb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The wrapper on CPU tensors is the plain version, in place.
    tt = _t(table)
    assert scatter_set_rows(tt, _t(ids), _t(wb)) is tt
    np.testing.assert_array_equal(tt.numpy(), np.asarray(want))


@pytest.mark.parametrize("update", ["sgd", "writeback", "accum", "direct",
                                    "adagrad", "adam"])
def test_all_sentinel_batch_leaves_tables_bit_equal(path, update):
    table, _, grads, wb, gacc = _case(8)
    ids = np.full(M, N, np.int32)
    tt, tg = _t(table), _t(gacc)
    v, m = _t(np.abs(gacc)), _t(gacc)
    lr = torch.tensor(0.1)
    if update == "direct":
        tsc.apply_row_updates_direct(tt, _t(ids), _t(grads), lr=lr,
                                     clip_val=0.25, writeback=_t(wb))
    elif update in ("adagrad", "adam"):
        tsc.apply_row_updates_opt(
            tt, _t(ids), _t(grads), lr=lr, clip_val=0.25,
            step=torch.tensor(1, dtype=torch.int32),
            m=m if update == "adam" else None, v=v, l2=0.01,
            writeback=_t(wb),
        )
    else:
        tsc.apply_row_updates(
            tt, _t(ids), _t(grads), lr=lr, clip_val=0.25, l2=0.01,
            gacc=tg if update == "accum" else None,
            writeback=_t(wb) if update == "writeback" else None,
        )
    np.testing.assert_array_equal(tt.numpy(), table)
    np.testing.assert_array_equal(tg.numpy(), gacc)
    np.testing.assert_array_equal(v.numpy(), np.abs(gacc))
    np.testing.assert_array_equal(m.numpy(), gacc)


@pytest.mark.parametrize("override", [
    {"sgd_mode": "accum"}, {"optimizer": "adagrad"}, {"optimizer": "adam"},
])
def test_state_numpy_round_trip_carries_gacc_and_slots(override):
    """The JAX initial state's gradient rows and slots carry into the
    port and back, and the port's own init has the same layout."""
    kw = dict(emb_dim=D, num_users=30, num_items=40, **override)
    jstate = jinit(JCFConfig(**kw), jax.random.key(0))
    jslots = None if jstate.opt_slots is None else {
        k: np.asarray(x) + 0.5 for k, x in jstate.opt_slots.items()
    }
    jg = None if jstate.user_gacc is None else np.asarray(jstate.user_gacc) + 0.25
    tstate = state_from_numpy(
        jstate.user_emb, jstate.item_emb, jstate.w0, lr=0.1, step=7,
        device="cpu", user_gacc=jg,
        item_gacc=None if jg is None else np.asarray(jstate.item_gacc),
        opt_slots=jslots,
    )
    back = state_to_numpy(tstate)
    mine = state_to_numpy(init_train_state(CFConfig(**kw), torch.Generator(), "cpu"))
    assert set(back) == set(mine)
    assert int(back["step"]) == 7
    if jslots is None:
        assert "opt_slots" not in back
        np.testing.assert_array_equal(back["user_gacc"], jg)
        np.testing.assert_array_equal(back["item_gacc"], np.asarray(jstate.item_gacc))
        zero_grad_accumulators(tstate)
        assert not tstate.user_gacc.any() and not tstate.item_gacc.any()
    else:
        assert "user_gacc" not in back
        assert set(back["opt_slots"]) == set(jslots) == set(mine["opt_slots"])
        for k, x in jslots.items():
            np.testing.assert_array_equal(back["opt_slots"][k], x)
            assert mine["opt_slots"][k].shape == x.shape
            assert not mine["opt_slots"][k].any()
