"""The redesigned gathers: K1 with the user indirection, a caller's output
buffer and the history split over lanes, and K2's multi-table entry.

On the CPU the wrappers run their plain versions, held here against the
JAX package's Pallas kernels in interpret mode and its
``models.aggregator.history_mean``; the rewritten train step is held bit
for bit to the step with the separate row reads it replaced. The
``cuda``-marked tests hold the kernels against their plain versions on
the card and skip without one.

JAX is imported inside the tests that use it, so that a machine without
JAX can collect this file and run its ``cuda`` tests
(``python -m pytest --noconftest -m cuda tests/test_torch_gathers.py``).
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch.train.train_step as tts
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.models.aggregator import history_mean_fused, user_pools_impl
from heat_tpu_torch.ops.cuda import gather
from heat_tpu_torch.train.engine import Engine

from test_torch_kernels import _offset_view


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def _history_table(rng, n, d, u, h, b):
    """A table, the (u, h) histories of u users with every kind of length,
    and (b,) user rows with repeats."""
    table = rng.normal(size=(n, d)).astype(np.float32)
    his = rng.integers(0, n, (u, h)).astype(np.int32)
    lens = rng.integers(0, h + 1, u).astype(np.int32)
    lens[:4] = [0, h, 1, h + 3]  # empty, full, one row, beyond the width
    rows = rng.integers(0, u, b).astype(np.int32)
    rows[:6] = [0, 1, 2, 3, 1, 1]
    return table, his, lens, rows


def _t(x, device="cpu", dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return out if dtype is None else out.to(dtype)


def _within_one_bf16_ulp(got, exact):
    err = (got.float() - exact.float()).abs()
    return bool((err <= 2.0**-7 * exact.float().abs() + 1e-30).all())


# --- K1: rows and out, on the CPU, against the JAX package ----------------


def test_history_mean_with_rows_and_out_matches_pallas_and_history_mean():
    """Orders of summation differ between the three (per-row adds, masked
    block sums), hence rtol 1e-6 with atol 1e-6 for cancelling sums."""
    import jax.numpy as jnp
    from heat_tpu.models.aggregator import history_mean as jmean
    from heat_tpu.ops.pallas.gather import history_mean_gather as pallas_mean

    rng = np.random.default_rng(0)
    table, his, lens, rows = _history_table(rng, 200, 128, 37, 7, 50)
    lens = np.minimum(lens, 7)  # the JAX functions take lengths up to H
    want_pallas = np.asarray(
        pallas_mean(table, his[rows], lens[rows], interpret=True))
    want_mean = np.asarray(jmean(jnp.asarray(table)[his[rows]], lens[rows]))
    t, h, l, r = map(_t, (table, his, lens, rows))
    out = torch.full((50, 128), 7.0)
    got = gather.history_mean_gather(t, h, l, rows=r, out=out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_mean, rtol=1e-6, atol=1e-6)
    assert not got[0].any()  # an empty history pools to 0
    # The indirection is the composition it replaced, bit for bit.
    idx = r.long()
    assert torch.equal(got, gather.history_mean_gather(
        t, h.index_select(0, idx), l.index_select(0, idx)))
    assert torch.equal(got, history_mean_fused(t, h, l, rows=r))


def test_history_mean_bf16_with_rows_is_within_one_ulp_of_jax():
    import jax.numpy as jnp
    from heat_tpu.models.aggregator import history_mean as jmean

    rng = np.random.default_rng(1)
    table, his, lens, rows = _history_table(rng, 150, 32, 29, 9, 40)
    lens = np.minimum(lens, 9)
    table16 = jnp.asarray(table).astype(jnp.bfloat16)
    want = np.array(jmean(table16[his[rows]], lens[rows]).astype(jnp.float32))
    t16 = _t(table, dtype=torch.bfloat16)
    got = gather.history_mean_gather(t16, _t(his), _t(lens), rows=_t(rows),
                                     out=torch.empty(40, 32, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _within_one_bf16_ulp(got, torch.from_numpy(want))
    # f32 tables pooled in bf16 compute: the rows round first, as in JAX.
    got32 = gather.history_mean_gather(_t(table), _t(his), _t(lens),
                                       torch.bfloat16, rows=_t(rows))
    assert _within_one_bf16_ulp(got32, torch.from_numpy(want))


def test_rows_outside_the_history_table_pool_to_zero(device):
    rng = np.random.default_rng(2)
    table, his, lens, rows = _history_table(rng, 80, 16, 11, 5, 20)
    rows[7], rows[9] = -1, 11
    t, h, l, r = (_t(x, device) for x in (table, his, lens, rows))
    got = gather.history_mean_gather(t, h, l, rows=r)
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert not got[7].any() and not got[9].any()
    keep = [b for b in range(20) if b not in (7, 9)]
    want = gather.history_mean_gather_ref(t, h, l)[r[keep].long()]
    torch.testing.assert_close(got[keep], want, rtol=1e-5, atol=1e-6)


def test_user_pools_whole_table_equals_chunked():
    rng = np.random.default_rng(3)
    table, his, lens, _ = _history_table(rng, 120, 24, 53, 6, 6)
    for dtype in (torch.float32, torch.bfloat16):
        t = _t(table, dtype=dtype)
        whole = user_pools_impl(t, _t(his), _t(lens), chunk=53)
        chunked = user_pools_impl(t, _t(his), _t(lens), chunk=8)
        assert whole.dtype == dtype and torch.equal(whole, chunked)
        assert torch.equal(whole, gather.history_mean_gather(t, _t(his), _t(lens)))


# --- K2's multi-table entry, on the CPU ------------------------------------


def _segments(rng, device, dtypes, d=(128, 128, 64, 30)):
    sizes = ((300, 700), (90, 45), (500, 1), (64, 333))
    out = []
    for (n, m), width, dtype in zip(sizes, d, dtypes):
        table = _t(rng.normal(size=(n, width)).astype(np.float32), device, dtype)
        ids = rng.integers(0, n, m).astype(np.int32)
        out.append((table, _t(ids, device)))
    return out


def test_gather_rows_multi_matches_pallas_per_segment():
    from heat_tpu.ops.pallas.gather import gather_rows as pallas_gather

    rng = np.random.default_rng(4)
    segs = _segments(rng, "cpu", [torch.float32] * 4, d=(128, 128, 128, 128))
    got = gather.gather_rows_multi(segs)
    assert len(got) == 4
    for (table, ids), out in zip(segs, got):
        want = np.asarray(pallas_gather(table.numpy(), ids.numpy(), interpret=True))
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_gather_rows_multi_equals_the_single_entry_composition(out_dtype):
    rng = np.random.default_rng(5)
    mixed = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32]
    segs = _segments(rng, "cpu", mixed)
    segs.append((segs[0][0], segs[1][1]))  # a table read twice
    got = gather.gather_rows_multi(segs, out_dtype)
    for (table, ids), out in zip(segs, got):
        want = gather.gather_rows(table, ids)
        want = want if out_dtype is None else want.to(out_dtype)
        assert out.dtype == want.dtype and torch.equal(out, want)
    assert gather.gather_rows_multi([]) == []


def test_new_arguments_reject_what_the_kernels_do_not_take(device):
    table = torch.zeros(10, 8, device=device)
    his = torch.zeros(6, 3, dtype=torch.int32, device=device)
    lens = torch.zeros(6, dtype=torch.int32, device=device)
    rows = torch.zeros(4, dtype=torch.int32, device=device)
    mean = gather.history_mean_gather
    with pytest.raises(ValueError, match="int32"):
        mean(table, his, lens, rows=rows.long())
    with pytest.raises(ValueError, match="1-D"):
        mean(table, his, lens, rows=rows.reshape(2, 2))
    with pytest.raises(ValueError, match=r"contiguous \(4, 8\)"):
        mean(table, his, lens, rows=rows, out=torch.zeros(6, 8, device=device))
    with pytest.raises(ValueError, match=r"contiguous \(6, 8\)"):
        mean(table, his, lens, out=torch.zeros(8, 6, device=device).T)
    with pytest.raises(ValueError, match="out is"):
        mean(table, his, lens, torch.bfloat16, out=torch.zeros(6, 8, device=device))
    with pytest.raises(ValueError, match="f32 or bf16"):
        mean(table, his, lens, out=torch.zeros(6, 8, device=device).double())
    with pytest.raises(ValueError, match="split"):
        mean(table, his, lens, split=3)
    multi = gather.gather_rows_multi
    ids = torch.zeros(4, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="at most 8"):
        multi([(table, ids)] * 9)
    with pytest.raises(ValueError, match="int32"):
        multi([(table, ids), (table, ids.long())])
    with pytest.raises(ValueError, match="1-D"):
        multi([(table, ids.reshape(2, 2))])
    with pytest.raises(ValueError, match="f32 or bf16"):
        multi([(table, ids)], torch.float64)
    with pytest.raises(ValueError, match="f32 or bf16"):
        multi([(table.double(), ids)])
    if device.type == "cuda":
        with pytest.raises(ValueError, match="must be on cuda"):
            mean(table, his, lens, out=torch.zeros(6, 8))
        with pytest.raises(ValueError, match="must be on cuda"):
            mean(table, his, lens, rows=rows.cpu())
        with pytest.raises(ValueError, match="must be on cuda"):
            multi([(table, ids), (table.cpu(), ids.cpu())])


def test_cpu_dispatch_of_the_new_entries_launches_nothing():
    rng = np.random.default_rng(6)
    table, his, lens, rows = _history_table(rng, 60, 16, 12, 5, 9)
    t, h, l, r = map(_t, (table, his, lens, rows))
    before = dict(gather.LAUNCHES)
    assert torch.equal(
        gather.history_mean_gather(t, h, l, rows=r, split=4),
        gather.history_mean_gather_ref(t, h, l, rows=r))
    assert torch.equal(
        gather.gather_rows_multi([(t, r), (t.bfloat16(), r)], torch.float32)[1],
        gather.gather_rows_multi_ref([(t, r), (t.bfloat16(), r)], torch.float32)[1])
    user_pools_impl(t, h, l)
    assert gather.LAUNCHES == before
    assert {"gather_rows_multi", "gather_rows_multi_bf16"} <= set(before)


# --- the rewritten step against the separate reads it replaced ------------


def _separate_reads(monkeypatch):
    """Put the step's row reads back as they were: one K2 call and one cast
    a table, and K1 over ids and lengths selected beforehand."""
    def multi(segments, out_dtype=None):
        return [gather.gather_rows(t, i).to(t.dtype if out_dtype is None else out_dtype)
                for t, i in segments]

    def fused(item_emb, his_ids, mask, compute_dtype=None, rows=None):
        idx = rows.long()
        return history_mean_fused(item_emb, his_ids.index_select(0, idx),
                                  mask.index_select(0, idx), compute_dtype)

    monkeypatch.setattr(tts, "gather_rows_multi", multi)
    monkeypatch.setattr(tts, "history_mean_fused", fused)


BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.mark.parametrize("override", [
    {},  # config0's shape: uniform sampler, the mean per step
    dict(neg_sampler=1, tile_size=32, refresh_interval=256,
         his_refresh="subepoch", update_mode="direct", **BF16),
    dict(shuffle_mode="none", visit_order="user"),  # the history dedup
], ids=["config0", "tile_bf16_pools", "dedup_history"])
def test_step_is_bit_equal_to_the_step_with_separate_reads(monkeypatch, override):
    def engine():
        kw = dict(emb_dim=16, max_his=6, num_negs=4, batch_size=256, l_r=0.05,
                  clip_val=0.1, seed=21, **override)
        train, _ = synthetic_click_dataset(80, 300, clicks_per_user=12,
                                           max_his=6, seed=9)
        return Engine(CFConfig(**kw), train, device="cpu")

    new, old = engine(), engine()
    if "visit_order" in override:
        users, _, _ = new._make_batches(new.pairs)
        assert new._history_dedup(new.pairs, users) is not None
    losses = [new.train_one_epoch() for _ in range(2)]
    _separate_reads(monkeypatch)
    assert losses == [old.train_one_epoch() for _ in range(2)]
    for name in ("user_emb", "item_emb", "w0"):
        assert torch.equal(getattr(new.state, name), getattr(old.state, name)), name


# --- on the card -----------------------------------------------------------


def _hold_mean(got, table, his, lens, out_dtype, rows):
    """f32: any order of the sum is within H * 2^-24 * sum|x| / len of the
    exact one: rtol 1e-5, atol 1e-6 against the plain version. bf16: within
    one bf16 ulp of the f32-accumulated mean of the same rounded rows."""
    if out_dtype == torch.bfloat16:
        rounded = table.to(torch.bfloat16).float()
        exact = gather.history_mean_gather_ref(rounded, his, lens,
                                               torch.float32, rows)
        assert _within_one_bf16_ulp(got, exact)
    else:
        want = gather.history_mean_gather_ref(table, his, lens, out_dtype, rows)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("split", gather.SPLITS)
# Histories of less than one round of loads a lane group, of a few, of many.
@pytest.mark.parametrize("h", [5, 13, 37])
@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("d,offset", [(64, 0), (30, 0), (33, 0), (64, 1), (8, 0)])
def test_history_mean_kernel_team_shapes_match_plain(
        cuda, d, offset, table_dtype, out_dtype, h, split):
    """Every team shape the host rule can pick (S = 1, 2, 4 by ``split``,
    cut to 32 / G; G from 1 to 32 lanes by the width), vector and element
    paths, an unaligned view, with and without ``rows``; lengths 0, 1, H
    and beyond H; ids and rows out of range."""
    rng = np.random.default_rng(60)
    table, his, lens, rows = _history_table(rng, 500, d, 301, h, 257)
    his[5, :2] = [-1, 500]  # out of range: left out of the sum
    his[1, 0] = 500
    rows[9], rows[10] = -1, 301
    t = _offset_view(_t(table, cuda, table_dtype), offset)
    hi, l, r = (_t(x, cuda) for x in (his, lens, rows))
    inside = _t(((his >= 0) & (his < 500)), cuda)
    zeroed = torch.cat([t, torch.zeros_like(t[:1])])  # row 500: zeros
    plain_ids = torch.where(inside, hi, 500)
    for use_rows in (None, r):
        before = gather.LAUNCHES["history_mean_gather"]
        got = gather.history_mean_gather(t, hi, l, out_dtype, rows=use_rows,
                                         split=split)
        torch.cuda.synchronize()
        assert gather.LAUNCHES["history_mean_gather"] == before + 1
        assert got.dtype == out_dtype
        _hold_mean(got, zeroed, plain_ids, l, out_dtype, use_rows)
    assert not got[9].any() and not got[10].any()


@pytest.mark.cuda
@pytest.mark.parametrize("split", gather.SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_history_mean_kernel_gives_a_user_the_same_bits_anywhere(cuda, dtype, split):
    """The order of the sum depends on the valid length and the split only:
    one user's mean has the same bits at any position of a batch, in a
    batch of another size (another grid), through ``rows`` or not, and
    into a caller's buffer."""
    rng = np.random.default_rng(61)
    table, his, lens, rows = _history_table(rng, 400, 64, 200, 23, 1000)
    t = _t(table, cuda, dtype)
    hi, l, r = (_t(x, cuda) for x in (his, lens, rows))
    # With split = 0 the rule must pick one S for both batches: both are
    # far below the card's threads, so both get the most lanes.
    every = gather.history_mean_gather(t, hi, l, split=split)
    many = gather.history_mean_gather(t, hi, l, rows=r, split=split)
    few = gather.history_mean_gather(t, hi, l, rows=r[:7].contiguous(), split=split)
    out = torch.empty(1000, 64, dtype=dtype, device=cuda)
    gather.history_mean_gather(t, hi, l, rows=r, out=out, split=split)
    torch.cuda.synchronize()
    assert torch.equal(many, every[r.long()])
    assert torch.equal(few, many[:7])
    assert torch.equal(out, many)
    # Two splits agree to the rounding of the sum, not bit for bit.
    other = gather.history_mean_gather(t, hi, l, split=1 if split != 1 else 2)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(every, other, rtol=1e-5, atol=1e-6)
    else:
        exact = gather.history_mean_gather_ref(t.float(), hi, l, torch.float32)
        assert _within_one_bf16_ulp(other, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_user_pools_on_the_card_are_one_launch_in_place(cuda, dtype):
    rng = np.random.default_rng(62)
    table, his, lens, _ = _history_table(rng, 300, 64, 9000, 10, 6)
    t, hi, l = _t(table, cuda, dtype), _t(his, cuda), _t(lens, cuda)
    before = gather.LAUNCHES["history_mean_gather"]
    pools = user_pools_impl(t, hi, l)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["history_mean_gather"] == before + 1
    assert pools.dtype == dtype and pools.shape == (9000, 64)
    for lo in range(0, 9000, 4096):
        _hold_mean(pools[lo:lo + 4096], t, hi[lo:lo + 4096], l[lo:lo + 4096],
                   dtype, None)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(64, 0), (30, 0), (33, 0), (64, 1)])
def test_gather_rows_multi_kernel_is_bit_equal_to_plain(cuda, d, offset, out_dtype):
    """Mixed table types in one launch, the cast inside the kernel, vector
    and element paths, an unaligned table, ids out of range (zeros), an
    empty segment and a one-row segment."""
    rng = np.random.default_rng(63)
    mixed = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32]
    segs = _segments(rng, cuda, mixed, d=(d, d, 64, 30))
    segs = [(_offset_view(t, offset), i) for t, i in segs]
    segs[0][1][:3] = torch.tensor([-1, 300, 10**6], dtype=torch.int32)
    segs.append((segs[1][0], torch.zeros(0, dtype=torch.int32, device=cuda)))
    segs.append((segs[0][0], segs[1][1]))
    before = dict(gather.LAUNCHES)
    got = gather.gather_rows_multi(segs, out_dtype)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows_multi"] == before["gather_rows_multi"] + 1
    assert (gather.LAUNCHES["gather_rows_multi_bf16"]
            == before["gather_rows_multi_bf16"] + 1)
    assert gather.LAUNCHES["gather_rows"] == before["gather_rows"]
    for (table, ids), out in zip(segs, got):
        n = table.shape[0]
        inside = (ids >= 0) & (ids < n)
        want = gather.gather_rows_ref(table, torch.where(inside, ids, 0))
        want = want * inside[:, None].to(want.dtype)
        want = want if out_dtype is None else want.to(out_dtype)
        assert out.dtype == want.dtype and out.shape == want.shape
        assert torch.equal(out, want)
    assert not got[0][:3].any()
    # f32 tables only: the bf16 count stays.
    gather.gather_rows_multi(segs[:1] + segs[3:4], out_dtype)
    assert (gather.LAUNCHES["gather_rows_multi_bf16"]
            == before["gather_rows_multi_bf16"] + 1)


@pytest.mark.cuda
def test_gather_rows_multi_takes_eight_large_segments(cuda):
    """Eight segments whose blocks pass the per-segment cap, so that every
    block finds its segment and strides over it."""
    rng = np.random.default_rng(64)
    table = _t(rng.normal(size=(5000, 64)).astype(np.float32), cuda)
    segs = []
    for k in range(8):
        m = (40_000, 17, 300_000, 1)[k % 4]
        t = table if k % 2 else table.bfloat16()
        segs.append((t, _t(rng.integers(0, 5000, m).astype(np.int32), cuda)))
    got = gather.gather_rows_multi(segs, torch.float32)
    torch.cuda.synchronize()
    for want, out in zip(gather.gather_rows_multi_ref(segs, torch.float32), got):
        assert torch.equal(out, want)
