"""The update entries of the row scatters (``scatter_add_update``,
``scatter_set_update``) and the callers that use them.

On the CPU each wrapper runs its plain version. Those are held here, on
seeded numpy inputs,

* bit for bit against the unfused PyTorch expressions they replaced in
  ``heat_tpu_torch/train/scatter.py`` (clip, l2, the product with lr, the
  cast, then the plain scatter), for f32 and bf16 tables, with and without
  l2, in both orders of clip and l2, over repeated and sentinel ids;
* through ``apply_row_updates_direct`` and the sort-dedup batch update of
  ``apply_row_updates`` (with and without the fused write-back; the sorted
  path forced by lowering ``DENSE_ROWS_THRESHOLD`` in both packages)
  against the JAX package's functions, called eagerly on the CPU: f32 at
  rtol 1e-6 / atol 1e-7 (the two packages sum a repeated id's gradients in
  different orders), bf16 bit-equal on unique ids.

Also: the wrappers refuse wrong types, shapes, devices and an ``lr`` that
is no tensor, and on CPU tensors they launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.train.scatter as jsc
import heat_tpu_torch.train.scatter as tsc
from heat_tpu_torch.models.aggregator import scalar_in
from heat_tpu_torch.ops.cuda import scatter

N, D, M = 50, 8, 64
CLIP, LR = 0.25, 0.1  # the clip binds on about half of the elements
DTYPES = [torch.float32, torch.bfloat16]
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _case(seed, unique=False, n=N, d=D, m=M):
    """A table, ids (repeats and ~15% sentinels, or unique ids and a
    sentinel tail), gradients, forward-pass rows and per-id identical
    write-back rows."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    if unique:
        m = n - 10
        ids = rng.permutation(n)[:m].astype(np.int32)
        ids[-6:] = n
    else:
        ids = rng.integers(0, n, m).astype(np.int32)
        ids[:6] = 3  # a heavy repeat
        ids[m // 2:] = np.where(rng.random(m - m // 2) < 0.3, n, ids[m // 2:])
    grads = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    rows = rng.normal(size=(m, d)).astype(np.float32)
    per_id = rng.normal(size=(n + 1, d)).astype(np.float32)
    return table, ids, grads, rows, per_id[ids]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def _j(x, dtype=torch.float32):
    """The numpy array as a JAX array holding the values of ``_t(x, dtype)``."""
    return jnp.asarray(_t(x, dtype).float().numpy()).astype(JDTYPE[dtype])


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def sorted_path(monkeypatch):
    """Force the sort-dedup path in both packages below 50 rows."""
    monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
    monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)


# --- the plain versions against the expressions they replaced -----------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_add_update_ref_clip_first_is_the_unfused_direct_update(dtype, l2, grad_dtype):
    """clip, then l2 against the forward rows, then -lr and the cast."""
    table, ids, grads, rows, _ = _case(0)
    lr = torch.tensor(LR)
    g = _t(grads, grad_dtype)
    want = _t(table, dtype)
    inc = torch.clamp(g.float(), -CLIP, CLIP)
    if l2:
        inc = inc + l2 * _t(rows, grad_dtype).float()
    scatter.scatter_add_rows_ref(want, _t(ids, torch.int32), inc.mul_(-lr).to(dtype))
    got = scatter.scatter_add_update_ref(
        _t(table, dtype), _t(ids, torch.int32), g, lr=lr, clip_val=CLIP, l2=l2,
        rows=_t(rows, grad_dtype) if l2 else None, clip_first=True,
    )
    assert got.dtype == dtype and torch.equal(got, want)
    assert not torch.equal(got, _t(table, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("unique", [False, True])
def test_add_update_ref_l2_first_is_the_unfused_sorted_update(dtype, l2, unique):
    """l2 against the table's own rows in the table's type (the scalar
    rounded to it first), then the clip, then -lr and the cast."""
    table, ids, grads, _, _ = _case(1, unique)
    lr = torch.tensor(LR)
    i = _t(ids, torch.int32)
    want = _t(table, dtype)
    summed = _t(grads)
    if l2:
        own = want.index_select(0, i.clamp(max=N - 1).long())
        valid = (i < N).to(dtype)[:, None]
        summed = summed + scalar_in(l2, dtype) * own * valid
    g = summed.clamp_(-CLIP, CLIP)
    scatter.scatter_add_rows_ref(want, i, g.mul_(-lr).to(dtype))
    got = scatter.scatter_add_update_ref(
        _t(table, dtype), i, _t(grads), lr=lr, clip_val=CLIP, l2=l2,
        clip_first=False,
    )
    assert torch.equal(got, want)


def test_the_two_clip_orders_differ_where_the_clip_binds():
    table, ids, grads, _, _ = _case(2, unique=True)
    lr = torch.tensor(LR)
    i = _t(ids, torch.int32)
    kw = dict(lr=lr, clip_val=CLIP, l2=0.5)
    own = _t(table)[i.clamp(max=N - 1).long()]
    first = scatter.scatter_add_update_ref(
        _t(table), i, _t(grads), rows=own, clip_first=True, **kw)
    last = scatter.scatter_add_update_ref(
        _t(table), i, _t(grads), clip_first=False, **kw)
    assert not torch.allclose(first, last, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("base_dtype", DTYPES)
def test_set_update_ref_is_the_unfused_writeback_update(dtype, l2, base_dtype):
    table, ids, grads, _, wb = _case(3, unique=True)
    lr = torch.tensor(LR)
    i = _t(ids, torch.int32)
    base = _t(wb, base_dtype)
    want = _t(table, dtype)
    b, summed = base.float().clone(), _t(grads)  # sub_ below is in place
    if l2:
        summed = summed + l2 * b * (i < N).float()[:, None]
    g = summed.clamp_(-CLIP, CLIP)
    scatter.scatter_set_rows_ref(want, i, b.sub_(lr * g).to(dtype))
    got = scatter.scatter_set_update_ref(
        _t(table, dtype), i, base, _t(grads), lr=lr, clip_val=CLIP, l2=l2)
    assert got.dtype == dtype and torch.equal(got, want)
    untouched = np.setdiff1d(np.arange(N), ids)
    assert torch.equal(got[untouched], _t(table, dtype)[untouched])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows_dtype", DTYPES)
def test_set_rows_casts_rows_of_either_type(dtype, rows_dtype):
    """The plain scatter-set takes f32 or bf16 rows for either table type
    and rounds as a cast does."""
    table, ids, _, _, wb = _case(4)
    i, rows = _t(ids, torch.int32), _t(wb, rows_dtype)
    want = _t(table, dtype)
    keep = ids < N
    want[ids[keep]] = rows[keep].to(dtype)
    got = scatter.scatter_set_rows(_t(table, dtype), i, rows)
    assert got.dtype == dtype and torch.equal(got, want)


# --- the callers against the JAX package ---------------------------------


def _close(got, want, dtype):
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype,unique", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True)])
@pytest.mark.parametrize("writeback", [False, True])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_direct_update_matches_jax(dtype, unique, writeback, l2):
    table, ids, grads, rows, wb = _case(5, unique)
    want = jsc.apply_row_updates_direct(
        _j(table, dtype), jnp.asarray(ids), _j(grads), lr=jnp.float32(LR),
        clip_val=CLIP, l2=l2, rows=_j(rows, dtype) if l2 else None,
        writeback=_j(wb, dtype) if writeback else None,
    )
    tt = _t(table, dtype)
    got = tsc.apply_row_updates_direct(
        tt, _t(ids, torch.int32), _t(grads), lr=torch.tensor(LR),
        clip_val=CLIP, l2=l2, rows=_t(rows, dtype) if l2 else None,
        writeback=_t(wb, dtype) if writeback else None,
    )
    assert got is tt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype,unique", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True)])
@pytest.mark.parametrize("writeback", [False, True])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_sorted_batch_update_matches_jax(sorted_path, dtype, unique, writeback, l2):
    table, ids, grads, _, wb = _case(6, unique)
    want, _ = jsc.apply_row_updates(
        _j(table, dtype), jnp.asarray(ids), _j(grads), lr=jnp.float32(LR),
        clip_val=CLIP, l2=l2, writeback=_j(wb, dtype) if writeback else None,
    )
    tt = _t(table, dtype)
    got, gacc = tsc.apply_row_updates(
        tt, _t(ids, torch.int32), _t(grads), lr=torch.tensor(LR),
        clip_val=CLIP, l2=l2, writeback=_t(wb, dtype) if writeback else None,
    )
    assert got is tt and gacc is None
    _close(got, want, dtype)
    untouched = np.setdiff1d(np.arange(N), ids)
    assert torch.equal(got[untouched], _t(table, dtype)[untouched])


@pytest.mark.parametrize("dtype", DTYPES)
def test_direct_update_takes_gradients_in_the_compute_type(dtype):
    """bf16 gradient rows widen exactly: the same result as their f32
    copies."""
    table, ids, grads, rows, _ = _case(7)
    g16 = _t(grads, torch.bfloat16)
    kw = dict(lr=torch.tensor(LR), clip_val=CLIP, l2=0.01, rows=_t(rows))
    got = tsc.apply_row_updates_direct(
        _t(table, dtype), _t(ids, torch.int32), g16, **kw)
    want = tsc.apply_row_updates_direct(
        _t(table, dtype), _t(ids, torch.int32), g16.float(), **kw)
    assert torch.equal(got, want)


# --- the wrappers' contract ------------------------------------------------


def _args(device="cpu"):
    table = torch.zeros(10, 8, device=device)
    ids = torch.zeros(4, dtype=torch.int32, device=device)
    rows = torch.zeros(4, 8, device=device)
    return table, ids, rows, torch.tensor(0.1, device=device)


@pytest.mark.parametrize("bad,exc,match", [
    (dict(lr=0.1), TypeError, "lr must be a tensor"),
    (dict(lr=torch.tensor(0.1, dtype=torch.float64)), ValueError, "one f32 value"),
    (dict(lr=torch.tensor([0.1, 0.2])), ValueError, "one f32 value"),
    (dict(lr=torch.tensor(0.1, device="meta")), ValueError, "lr must be on"),
    (dict(grads=torch.zeros(3, 8)), ValueError, "grads"),
    (dict(grads=torch.zeros(4, 8, dtype=torch.float64)), ValueError, "contiguous f32 or bf16"),
    (dict(grads=torch.zeros(8, 4).T), ValueError, "contiguous"),
    (dict(grads=torch.zeros(4, 8, device="meta")), ValueError, "grads must be on"),
    (dict(ids=torch.zeros(4, dtype=torch.int64)), ValueError, "int32"),
    (dict(table=torch.zeros(10, 8, dtype=torch.float16)), ValueError, "f32 or bf16"),
    (dict(l2=0.01), ValueError, "needs rows"),
    (dict(rows=torch.zeros(4, 8)), ValueError, "rows are read only"),
    (dict(l2=0.01, rows=torch.zeros(4, 8), clip_first=False), ValueError, "rows are read only"),
    (dict(l2=0.01, rows=torch.zeros(4, 7)), ValueError, "rows"),
])
def test_add_update_rejects_what_the_kernel_does_not_take(bad, exc, match):
    table, ids, grads, lr = _args()
    kw = dict(table=table, ids=ids, grads=grads, lr=lr, clip_val=1.0,
              clip_first=True)
    kw.update(bad)
    table, ids, grads = kw.pop("table"), kw.pop("ids"), kw.pop("grads")
    with pytest.raises(exc, match=match):
        scatter.scatter_add_update(table, ids, grads, **kw)


@pytest.mark.parametrize("bad,exc,match", [
    (dict(lr=0.1), TypeError, "lr must be a tensor"),
    (dict(lr=torch.tensor(1)), ValueError, "one f32 value"),
    (dict(base=torch.zeros(3, 8)), ValueError, "base"),
    (dict(base=torch.zeros(4, 8, dtype=torch.float16)), ValueError, "contiguous f32 or bf16"),
    (dict(summed=torch.zeros(4, 8, dtype=torch.bfloat16)), ValueError, "summed must be f32"),
    (dict(summed=torch.zeros(4, 8, device="meta")), ValueError, "summed must be on"),
    (dict(ids=torch.zeros(4, 1, dtype=torch.int32)), ValueError, "ids must be"),
    (dict(table=torch.zeros(8, 10).T), ValueError, "contiguous"),
])
def test_set_update_rejects_what_the_kernel_does_not_take(bad, exc, match):
    table, ids, rows, lr = _args()
    kw = dict(table=table, ids=ids, base=rows, summed=rows.clone(), lr=lr,
              clip_val=1.0)
    kw.update(bad)
    args = [kw.pop(k) for k in ("table", "ids", "base", "summed")]
    with pytest.raises(exc, match=match):
        scatter.scatter_set_update(*args, **kw)


def test_update_wrappers_run_plain_versions_on_cpu_and_launch_nothing():
    table, ids, grads, rows, wb = _case(8)
    lr = torch.tensor(LR)
    i = _t(ids, torch.int32)
    before = dict(scatter.LAUNCHES)
    for dtype in DTYPES:
        for clip_first in (True, False):
            kw = dict(lr=lr, clip_val=CLIP, l2=0.01, clip_first=clip_first,
                      rows=_t(rows) if clip_first else None)
            t = _t(table, dtype)
            got = scatter.scatter_add_update(t, i, _t(grads), **kw)
            assert got is t
            assert torch.equal(got, scatter.scatter_add_update_ref(
                _t(table, dtype), i, _t(grads), **kw))
        t = _t(table, dtype)
        got = scatter.scatter_set_update(t, i, _t(wb), _t(grads), lr=lr,
                                         clip_val=CLIP, l2=0.01)
        assert got is t
        assert torch.equal(got, scatter.scatter_set_update_ref(
            _t(table, dtype), i, _t(wb), _t(grads), lr=lr, clip_val=CLIP,
            l2=0.01))
    assert scatter.LAUNCHES == before
    assert {"scatter_add_update", "scatter_add_update_bf16",
            "scatter_set_update", "scatter_set_update_bf16"} <= set(before)
