"""The port's kernels K1-K4 and S1 against the JAX package's Pallas kernels.

On the CPU each wrapper of ``heat_tpu_torch.ops.cuda`` runs its plain
PyTorch version; those are held here against the Pallas kernels in
interpret mode (as tests/test_pallas.py runs them) and against JAX's
``.at[].add(mode="drop")``; K4's plain version against a numpy oracle and
the one-hot einsum of ``heat_tpu/evaluation/evaluator.py`` (its Pallas
sources are closures inside ``scripts/profile_eval.py``); S1's plain
version against ``.at[].set(mode="drop")`` in tests/test_torch_updates.py.
The ``cuda``-marked tests hold each CUDA kernel against its plain version
on the card and skip without one.

JAX is imported inside the tests that use it, so that the card's
machine, which has no JAX, can collect this file and run its ``cuda``
tests (``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.ops.cuda import gather, scatter, topk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _history_inputs(rng, n, d, b, h):
    table = rng.normal(size=(n, d)).astype(np.float32)
    his = rng.integers(0, n, (b, h)).astype(np.int32)
    lens = rng.integers(0, h + 1, b).astype(np.int32)
    lens[:3] = [0, h, 1]  # an empty, a full and a one-row history
    return table, his, lens


def test_gather_rows_ref_matches_pallas():
    from heat_tpu.ops.pallas.gather import gather_rows as pallas_gather

    rng = np.random.default_rng(0)
    table = rng.normal(size=(300, 128)).astype(np.float32)
    ids = rng.integers(0, 300, 1500).astype(np.int32)
    want = np.asarray(pallas_gather(table, ids, interpret=True))
    got = gather.gather_rows_ref(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_history_mean_ref_matches_pallas():
    """Summation orders differ (masked block sum vs per-row adds), hence
    rtol 1e-5 / atol 1e-6 rather than equality."""
    from heat_tpu.ops.pallas.gather import history_mean_gather as pallas_mean

    rng = np.random.default_rng(1)
    table, his, lens = _history_inputs(rng, 200, 128, 20, 7)
    want = np.asarray(pallas_mean(table, his, lens, interpret=True))
    got = gather.history_mean_gather_ref(
        torch.from_numpy(table), torch.from_numpy(his), torch.from_numpy(lens)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[0].any()  # empty history -> 0


def test_scatter_add_ref_matches_pallas_unique_ids():
    from heat_tpu.ops.pallas.scatter import scatter_add_rows as pallas_scatter

    rng = np.random.default_rng(3)
    n, d, m = 400, 128, 200
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.choice(n, size=m, replace=False).astype(np.int32)
    deltas = rng.normal(size=(m, d)).astype(np.float32)
    ids = np.concatenate([ids, np.full(56, n, np.int32)])  # sentinels
    deltas = np.concatenate([deltas, rng.normal(size=(56, d)).astype(np.float32)])
    want = np.asarray(
        pallas_scatter(table.copy(), ids, deltas, interpret=True)
    )
    got = scatter.scatter_add_rows_ref(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(deltas),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_scatter_add_ref_matches_jax_drop_with_duplicates():
    """The dense accumulator of train/scatter.py: repeated ids add up and
    the sentinel id == N is dropped, as ``mode="drop"`` does."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, d, m = 50, 64, 300
    ids = rng.integers(0, n + 1, m).astype(np.int32)  # ~2% sentinels
    ids[:4] = n
    ids[4:12] = 7  # a heavy repeat
    deltas = rng.normal(size=(m, d)).astype(np.float32)
    want = np.asarray(
        jnp.zeros((n, d), jnp.float32).at[ids].add(deltas, mode="drop")
    )
    got = scatter.scatter_add_rows_ref(
        torch.zeros((n, d)), torch.from_numpy(ids), torch.from_numpy(deltas)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cpu_dispatch_runs_plain_versions_and_launches_nothing():
    rng = np.random.default_rng(5)
    table, his, lens = _history_inputs(rng, 60, 16, 12, 5)
    t, h, l = map(torch.from_numpy, (table, his, lens))
    ids = torch.from_numpy(rng.integers(0, 61, 40).astype(np.int32))
    deltas = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    before = {**gather.LAUNCHES, **scatter.LAUNCHES}

    assert torch.equal(
        gather.gather_rows(t, h[:, 0].contiguous()),
        gather.gather_rows_ref(t, h[:, 0].contiguous()),
    )
    assert torch.equal(
        gather.history_mean_gather(t, h, l),
        gather.history_mean_gather_ref(t, h, l),
    )
    assert torch.equal(
        scatter.scatter_add_rows(torch.zeros(60, 16), ids, deltas),
        scatter.scatter_add_rows_ref(torch.zeros(60, 16), ids, deltas),
    )
    assert {**gather.LAUNCHES, **scatter.LAUNCHES} == before


def _window_inputs(rng, rows, nw, w, kw):
    sim = rng.normal(size=(rows, nw * w)).astype(np.float32)
    widx = rng.integers(0, nw, (rows, kw)).astype(np.int32)
    widx[0, :3] = [-1, nw, nw + 7]  # out of range: finfo.min rows
    widx[1, :2] = [nw - 1, 0]
    return sim, widx


def test_window_extract_ref_matches_numpy_and_one_hot_einsum():
    """The copy is exact: equal to a numpy loop, and to the JAX package's
    one-hot HIGHEST einsum for in-range ids."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    nw, w = 9, 128
    sim, widx = _window_inputs(rng, 7, nw, w, 5)
    want = np.full((7, 5, w), np.finfo(np.float32).min, np.float32)
    for r in range(7):
        for j in range(5):
            if 0 <= widx[r, j] < nw:
                want[r, j] = sim[r, widx[r, j] * w : (widx[r, j] + 1) * w]
    got = topk.window_extract_ref(torch.from_numpy(sim), torch.from_numpy(widx), w)
    np.testing.assert_array_equal(got.numpy(), want)
    onehot = (widx[:, :, None] == np.arange(nw)[None, None, :]).astype(np.float32)
    einsum = jnp.einsum("bkn,bnw->bkw", onehot, sim.reshape(7, nw, w),
                        precision=jax.lax.Precision.HIGHEST)
    inside = (widx >= 0) & (widx < nw)
    np.testing.assert_array_equal(got.numpy()[inside], np.asarray(einsum)[inside])
    assert torch.equal(
        topk.window_extract(torch.from_numpy(sim), torch.from_numpy(widx), w), got
    )


# --- on the card --------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30])  # float4 path and scalar path
def test_gather_rows_kernel_matches_plain(cuda, d):
    rng = np.random.default_rng(10)
    table = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 500, 3000).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES["gather_rows"]
    got = gather.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(got, gather.gather_rows_ref(table, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30])
def test_history_mean_kernel_matches_plain(cuda, d):
    rng = np.random.default_rng(11)
    table, his, lens = _history_inputs(rng, 500, d, 300, 13)
    t, h, l = (torch.from_numpy(x).to(cuda) for x in (table, his, lens))
    before = gather.LAUNCHES["history_mean_gather"]
    got = gather.history_mean_gather(t, h, l)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["history_mean_gather"] == before + 1
    torch.testing.assert_close(
        got, gather.history_mean_gather_ref(t, h, l), rtol=1e-5, atol=1e-6
    )


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30])
def test_scatter_add_kernel_matches_plain(cuda, d):
    """Atomics land in a different order on every run, so repeated ids sum
    in another order than index_add_. Any order of k f32 additions lies
    within k * 2^-24 * sum|x| of the exact sum (k - 1 roundings of partial
    sums and one of the result), so the kernel and the plain version are
    each held to that bound against the f64 sum, element by element. (A
    fixed atol 1e-6 failed on one card run in four: sums of ~12 unit
    normals round at a few 1e-7 and cancel to near zero.)"""
    rng = np.random.default_rng(12)
    n, m = 400, 5000  # about 12 repeats per id
    ids = rng.integers(0, n + 1, m).astype(np.int32)  # ~0.25% sentinels
    deltas = rng.normal(size=(m, d)).astype(np.float32)
    i, dl = torch.from_numpy(ids).to(cuda), torch.from_numpy(deltas).to(cuda)
    before = scatter.LAUNCHES["scatter_add_rows"]
    got = scatter.scatter_add_rows(torch.zeros(n, d, device=cuda), i, dl)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter_add_rows"] == before + 1
    want = scatter.scatter_add_rows_ref(torch.zeros(n, d, device=cuda), i, dl)
    keep = i < n
    rows, x = i[keep].long(), dl[keep].double()
    exact = torch.zeros(n, d, dtype=torch.float64, device=cuda).index_add_(0, rows, x)
    mag = torch.zeros(n, d, dtype=torch.float64, device=cuda).index_add_(0, rows, x.abs())
    k = torch.bincount(rows, minlength=n).double()[:, None]
    bound = k * 2.0**-24 * mag
    for name, out in (("kernel", got), ("plain", want)):
        err = (out.double() - exact).abs()
        assert (err <= bound).all(), (name, float((err - bound).max()))


def _set_inputs(rng, n, m, d):
    """Ids with repeats carrying identical rows, sentinels (== n) and
    out-of-range ids (negative, past n)."""
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, m).astype(np.int32)
    ids[:40] = 17  # a heavy repeat
    ids[-60:-20] = n
    ids[-20:-10] = rng.integers(n + 1, 2 * n, 10)
    ids[-10:] = -rng.integers(1, n, 10)
    per_id = rng.normal(size=(n, d)).astype(np.float32)
    rows = per_id[np.clip(ids, 0, n - 1)]
    return table, ids, rows


@pytest.mark.cuda
# float4 path; scalar path; scalar path with rows off 16-byte alignment
@pytest.mark.parametrize("d", [64, 30, 33])
def test_scatter_set_kernel_matches_plain(cuda, d):
    """S1 moves bits: bit-equal to the plain version on the whole table,
    untouched rows included."""
    rng = np.random.default_rng(14)
    table, ids, rows = _set_inputs(rng, 700, 3000, d)
    t = torch.from_numpy(table).to(cuda)
    i, r = torch.from_numpy(ids).to(cuda), torch.from_numpy(rows).to(cuda)
    before = scatter.LAUNCHES["scatter_set_rows"]
    got = scatter.scatter_set_rows(t.clone(), i, r)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter_set_rows"] == before + 1
    assert torch.equal(got, scatter.scatter_set_rows_ref(t.clone(), i, r))
    untouched = np.setdiff1d(np.arange(700), ids)
    assert torch.equal(got[untouched], t[untouched])


def test_scatter_set_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(15)
    table, ids, rows = _set_inputs(rng, 90, 300, 12)
    before = dict(scatter.LAUNCHES)
    t, i, r = map(torch.from_numpy, (table, ids, rows))
    want = scatter.scatter_set_rows_ref(t.clone(), i, r)
    got = scatter.scatter_set_rows(t, i, r)
    assert got is t and torch.equal(got, want)
    assert scatter.LAUNCHES == before
    keep = (ids >= 0) & (ids < 90)
    expect = table.copy()
    expect[ids[keep]] = rows[keep]
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 30])  # float4 path and scalar path
def test_window_extract_kernel_matches_plain(cuda, w):
    """An exact copy: bit-equal to the plain version, out-of-range window
    ids included."""
    rng = np.random.default_rng(13)
    sim, widx = _window_inputs(rng, 300, 40, w, 20)
    s, i = torch.from_numpy(sim).to(cuda), torch.from_numpy(widx).to(cuda)
    before = topk.LAUNCHES["window_extract"]
    got = topk.window_extract(s, i, w)
    torch.cuda.synchronize()
    assert topk.LAUNCHES["window_extract"] == before + 1
    assert torch.equal(got, topk.window_extract_ref(s, i, w))


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    """The contract is checked on the CPU too, so the CPU tests catch a
    call that the card would refuse."""
    table = torch.zeros(10, 8, device=device)
    ids = torch.zeros(4, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(table, ids.long())
    with pytest.raises(ValueError, match="f32"):
        gather.gather_rows(table.double(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(table, torch.zeros(4, 2, dtype=torch.int32, device=device)[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        gather.history_mean_gather(table.T, ids.reshape(2, 2), ids[:2])
    with pytest.raises(ValueError, match="lens"):
        gather.history_mean_gather(table, ids.reshape(2, 2), ids)
    with pytest.raises(ValueError, match="deltas"):
        scatter.scatter_add_rows(table, ids, torch.zeros(3, 8, device=device))
    if device.type == "cuda":
        with pytest.raises(ValueError, match="must be on cuda"):
            gather.gather_rows(table, ids.cpu())


def test_scatter_set_rows_rejects_what_the_kernel_does_not_take(device):
    table = torch.zeros(10, 8, device=device)
    ids = torch.zeros(4, dtype=torch.int32, device=device)
    rows = torch.zeros(4, 8, device=device)
    with pytest.raises(ValueError, match="rows"):
        scatter.scatter_set_rows(table, ids, rows[:3])
    with pytest.raises(ValueError, match="contiguous f32"):
        scatter.scatter_set_rows(table, ids, rows.double())
    with pytest.raises(ValueError, match="int32"):
        scatter.scatter_set_rows(table, ids.long(), rows)
    with pytest.raises(ValueError, match="contiguous"):
        scatter.scatter_set_rows(torch.zeros(8, 10, device=device).T, ids, rows)
    if device.type == "cuda":
        with pytest.raises(ValueError, match="must be on cuda"):
            scatter.scatter_set_rows(table, ids, rows.cpu())


def test_window_extract_rejects_what_the_kernel_does_not_take(device):
    sim = torch.zeros(4, 256, device=device)
    widx = torch.zeros(4, 3, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="multiple"):
        topk.window_extract(sim[:, :200].contiguous(), widx, 128)
    with pytest.raises(ValueError, match="int32"):
        topk.window_extract(sim, widx.long(), 128)
    with pytest.raises(ValueError, match="f32"):
        topk.window_extract(sim.double(), widx, 128)
    # bf16 tables pass the gathers' contract; K4 has an f32 instance only.
    with pytest.raises(ValueError, match="float32"):
        topk.window_extract(sim.bfloat16(), widx, 128)
    with pytest.raises(ValueError, match="contiguous"):
        topk.window_extract(sim, torch.zeros(4, 6, dtype=torch.int32, device=device)[:, ::2], 128)
    with pytest.raises(ValueError, match="contiguous"):
        topk.window_extract(torch.zeros(512, 4, device=device).T, widx, 128)
    with pytest.raises(ValueError, match="widx"):
        topk.window_extract(sim, widx[:2], 128)
    if device.type == "cuda":
        with pytest.raises(ValueError, match="must be on cuda"):
            topk.window_extract(sim, widx.cpu(), 128)


# --- bf16 instances and the block gather S2, on the card ----------------


def _bf16(x, device):
    return torch.from_numpy(x).to(device).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30, 33])  # 16-byte path; element path
def test_gather_rows_bf16_kernel_matches_plain(cuda, d):
    rng = np.random.default_rng(20)
    table = _bf16(rng.normal(size=(500, d)).astype(np.float32), cuda)
    ids = torch.from_numpy(rng.integers(0, 500, 3000).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES["gather_rows"]
    got = gather.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows"] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gather.gather_rows_ref(table, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30])
@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
])
def test_history_mean_bf16_kernel_matches_plain(cuda, d, table_dtype, out_dtype):
    """The kernel sums in history order, the plain version blocked: both in
    f32 with one rounding to the output type, so a bf16 output is within
    one bf16 ulp (2^-8 relative) of the other, an f32 output within rtol
    1e-5."""
    rng = np.random.default_rng(21)
    table, his, lens = _history_inputs(rng, 500, d, 300, 13)
    t = torch.from_numpy(table).to(cuda).to(table_dtype)
    h, l = torch.from_numpy(his).to(cuda), torch.from_numpy(lens).to(cuda)
    before = gather.LAUNCHES["history_mean_gather"]
    got = gather.history_mean_gather(t, h, l, out_dtype)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["history_mean_gather"] == before + 1
    assert got.dtype == out_dtype
    want = gather.history_mean_gather_ref(t, h, l, out_dtype)
    if out_dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-8,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 33])  # bf16 pairs; single bf16 elements
def test_scatter_add_bf16_kernel_unique_ids_is_exact(cuda, d):
    """One add per element: the correctly rounded bf16 sum, bit-equal to
    the plain version."""
    rng = np.random.default_rng(22)
    n, m = 900, 400
    table = _bf16(rng.normal(size=(n, d)).astype(np.float32), cuda)
    ids = rng.choice(n, size=m, replace=False).astype(np.int32)
    ids[-9:] = n  # sentinels
    i = torch.from_numpy(ids).to(cuda)
    deltas = _bf16(rng.normal(size=(m, d)).astype(np.float32), cuda)
    before = scatter.LAUNCHES["scatter_add_rows"]
    got = scatter.scatter_add_rows(table.clone(), i, deltas)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter_add_rows"] == before + 1
    assert torch.equal(got, scatter.scatter_add_rows_ref(table.clone(), i, deltas))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 33])
def test_scatter_add_bf16_kernel_repeated_ids_within_bound(cuda, d):
    """Every bf16 add rounds, in an order that changes from run to run:
    each element lies within (occurrences of its row) x (one bf16 ulp,
    2^-8 relative, of the largest partial sum, itself at most the sum of
    the magnitudes) of the exact f64 sum."""
    rng = np.random.default_rng(23)
    n, m = 200, 3000  # about 15 repeats per id
    ids = rng.integers(0, n + 1, m).astype(np.int32)
    i = torch.from_numpy(ids).to(cuda)
    table = _bf16(rng.normal(size=(n, d)).astype(np.float32), cuda)
    deltas = _bf16(rng.normal(size=(m, d)).astype(np.float32), cuda)
    got = scatter.scatter_add_rows(table.clone(), i, deltas)
    torch.cuda.synchronize()
    keep = i < n
    rows, x = i[keep].long(), deltas[keep].double()
    exact = table.double().index_add_(0, rows, x)
    mag = table.double().abs().index_add_(0, rows, x.abs())
    k = torch.bincount(rows, minlength=n).double()[:, None]
    bound = k * 2.0**-8 * mag
    err = (got.double() - exact).abs()
    assert (err <= bound).all(), float((err - bound).max())
    assert (err > 0).any()  # it did round


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 30, 33])
def test_scatter_set_bf16_kernel_matches_plain(cuda, d):
    rng = np.random.default_rng(24)
    table, ids, rows = _set_inputs(rng, 700, 3000, d)
    t, r = _bf16(table, cuda), _bf16(rows, cuda)
    i = torch.from_numpy(ids).to(cuda)
    before = scatter.LAUNCHES["scatter_set_rows"]
    got = scatter.scatter_set_rows(t.clone(), i, r)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter_set_rows"] == before + 1
    assert torch.equal(got, scatter.scatter_set_rows_ref(t.clone(), i, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d", [(1, 128), (4, 128), (16, 128), (3, 30), (5, 33)])
def test_gather_blocks_kernel_matches_plain(cuda, dtype, r, d):
    """S2 copies bits: bit-equal to index_select on the (N / r, r * d)
    view, on the 16-byte path and on the element path."""
    rng = np.random.default_rng(25)
    n = 240 * r
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    table = table.to(cuda).to(dtype)
    ids = torch.from_numpy(rng.integers(0, n // r, 1000).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES["gather_blocks"]
    got = gather.gather_blocks(table, ids, r)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_blocks"] == before + 1
    assert got.shape == (1000 * r, d) and got.dtype == dtype
    assert torch.equal(got, gather.gather_blocks_ref(table, ids, r))


# --- bf16 on the CPU: the plain versions and the contract ---------------


def test_bf16_wrappers_run_plain_versions_on_cpu():
    rng = np.random.default_rng(30)
    table, his, lens = _history_inputs(rng, 60, 16, 12, 5)
    t16 = torch.from_numpy(table).bfloat16()
    h, l = torch.from_numpy(his), torch.from_numpy(lens)
    ids = torch.from_numpy(rng.integers(0, 61, 40).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32)).bfloat16()
    before = {**gather.LAUNCHES, **scatter.LAUNCHES}

    got = gather.gather_rows(t16, h[:, 0].contiguous())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, t16[h[:, 0].long()])
    for out_dtype in (None, torch.bfloat16, torch.float32):
        mean = gather.history_mean_gather(t16, h, l, out_dtype)
        assert mean.dtype == (out_dtype or torch.bfloat16)
        # bf16 rows are exact in f32: one rounding at the end, if any.
        f32 = gather.history_mean_gather_ref(t16.float(), h, l)
        assert torch.equal(mean, f32.to(mean.dtype))
    # From an f32 table into bf16 the rows are rounded first.
    mixed = gather.history_mean_gather(torch.from_numpy(table), h, l, torch.bfloat16)
    assert torch.equal(mixed, gather.history_mean_gather(t16, h, l))

    added = scatter.scatter_add_rows(t16.clone(), ids, rows)
    assert added.dtype == torch.bfloat16
    once = np.flatnonzero(np.bincount(ids.numpy(), minlength=61)[:60] == 1)
    for r in once:  # one occurrence: the correctly rounded bf16 sum
        k = int(np.flatnonzero(ids.numpy() == r)[0])
        assert torch.equal(added[r], (t16[r].float() + rows[k].float()).bfloat16())
    keep = ids < 60
    uniq = torch.unique(ids[keep]).long()
    set_ = scatter.scatter_set_rows(t16.clone(), ids, rows)
    assert set_.dtype == torch.bfloat16
    untouched = np.setdiff1d(np.arange(60), uniq.numpy())
    assert torch.equal(set_[untouched], t16[untouched])
    assert torch.equal(added[untouched], t16[untouched])
    assert {**gather.LAUNCHES, **scatter.LAUNCHES} == before


def test_wrappers_reject_mixed_and_unknown_types(device):
    """Rows to add have the table's type; rows to write are f32 or bf16
    for either table type and are cast on the way; a table is f32 or bf16;
    K1's output is f32 or bf16."""
    t32 = torch.zeros(10, 8, device=device)
    t16 = t32.bfloat16()
    ids = torch.zeros(4, dtype=torch.int32, device=device)
    rows32 = torch.zeros(4, 8, device=device)
    with pytest.raises(ValueError, match="table's type"):
        scatter.scatter_add_rows(t16, ids, rows32)
    with pytest.raises(ValueError, match="contiguous f32 or bf16"):
        scatter.scatter_set_rows(t32, ids, rows32.half())
    ids = torch.arange(4, dtype=torch.int32, device=device)
    rows = torch.linspace(0.1, 3.3, 32, device=device).reshape(4, 8)
    assert torch.equal(scatter.scatter_set_rows(t16, ids, rows)[:4], rows.bfloat16())
    assert torch.equal(scatter.scatter_set_rows(t32, ids, rows.bfloat16())[:4],
                       rows.bfloat16().float())
    with pytest.raises(ValueError, match="f32 or bf16"):
        gather.gather_rows(t32.half(), ids)
    with pytest.raises(ValueError, match="out_dtype"):
        gather.history_mean_gather(t16, ids.reshape(2, 2), ids[:2], torch.float16)


# --- the update entries and the vector instances, on the card -----------


def _update_case(rng, n, m, d, unique):
    """Ids (unique with a sentinel tail, or with about m / n repeats and a
    few sentinels), gradient rows that the clip 0.25 binds on, forward rows
    and write-back rows."""
    if unique:
        ids = rng.permutation(n)[:m].astype(np.int32)
        ids[-(m // 8):] = n
    else:
        ids = rng.integers(0, n + 1, m).astype(np.int32)
        ids[:40] = 17  # a heavy repeat
    grads = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    rows = rng.normal(size=(m, d)).astype(np.float32)
    base = rng.normal(size=(m, d)).astype(np.float32)
    return ids, grads, rows, base


def _offset_view(x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` elements into its
    buffer: off 16-byte alignment for offset = 1."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip_first", [True, False])
@pytest.mark.parametrize("l2", [0.0, 0.01])
# 16-byte vectors; bf16 pairs; single elements; vectors refused by alignment
@pytest.mark.parametrize("d,offset", [(64, 0), (30, 0), (33, 0), (64, 1)])
def test_scatter_add_update_kernel_unique_ids_is_bit_equal(
        cuda, dtype, grad_dtype, clip_first, l2, d, offset):
    """One increment per element, computed in f32 without FMA contraction
    and rounded once: bit-equal to the plain version, whose elementwise
    passes are PyTorch's."""
    rng = np.random.default_rng(40)
    n, m = 900, 400
    ids, grads, rows, _ = _update_case(rng, n, m, d, unique=True)
    table = _offset_view(
        torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda).to(dtype),
        offset)
    i = torch.from_numpy(ids).to(cuda)
    g = torch.from_numpy(grads).to(cuda).to(grad_dtype)
    kw = dict(lr=torch.tensor(0.1, device=cuda), clip_val=0.25, l2=l2,
              clip_first=clip_first)
    if clip_first and l2:
        kw["rows"] = torch.from_numpy(rows).to(cuda).to(grad_dtype)
    before = dict(scatter.LAUNCHES)
    got = scatter.scatter_add_update(table.clone(), i, g, **kw)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter_add_update"] == before["scatter_add_update"] + 1
    assert scatter.LAUNCHES["scatter_add_rows"] == before["scatter_add_rows"]
    want = scatter.scatter_add_update_ref(table.clone(), i, g, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, table)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 33])
def test_scatter_add_update_kernel_repeated_ids_within_bound(cuda, dtype, d):
    """Over repeats the increments (bit-equal to the plain version's, see
    above) land in any order: each element within occurrences x one
    rounding (2^-24 f32, 2^-8 bf16) x the sum of magnitudes of the exact
    f64 sum of the table's value and the rounded increments."""
    rng = np.random.default_rng(41)
    n, m = 200, 3000
    ids, grads, rows, _ = _update_case(rng, n, m, d, unique=False)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda).to(dtype)
    i = torch.from_numpy(ids).to(cuda)
    g, r = torch.from_numpy(grads).to(cuda), torch.from_numpy(rows).to(cuda)
    lr = torch.tensor(0.1, device=cuda)
    got = scatter.scatter_add_update(table.clone(), i, g, lr=lr, clip_val=0.25,
                                     l2=0.01, rows=r, clip_first=True)
    torch.cuda.synchronize()
    inc = ((torch.clamp(g, -0.25, 0.25) + 0.01 * r) * -lr).to(dtype)
    keep = i < n
    at, x = i[keep].long(), inc[keep].double()
    exact = table.double().index_add_(0, at, x)
    mag = table.double().abs().index_add_(0, at, x.abs())
    k = torch.bincount(at, minlength=n).double()[:, None]
    ulp = 2.0**-24 if dtype == torch.float32 else 2.0**-8
    err = (got.double() - exact).abs()
    assert (err <= k * ulp * mag).all(), float((err - k * ulp * mag).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("base_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("d,offset", [(64, 0), (30, 0), (33, 0), (64, 1)])
def test_scatter_set_update_kernel_is_bit_equal(cuda, dtype, base_dtype, l2, d, offset):
    rng = np.random.default_rng(42)
    n, m = 900, 400
    ids, grads, _, base = _update_case(rng, n, m, d, unique=True)
    table = _offset_view(
        torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda).to(dtype),
        offset)
    i = torch.from_numpy(ids).to(cuda)
    b = torch.from_numpy(base).to(cuda).to(base_dtype)
    s = torch.from_numpy(grads).to(cuda)
    kw = dict(lr=torch.tensor(0.1, device=cuda), clip_val=0.25, l2=l2)
    before = scatter.LAUNCHES["scatter_set_update"]
    got = scatter.scatter_set_update(table.clone(), i, b, s, **kw)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter_set_update"] == before + 1
    assert torch.equal(got, scatter.scatter_set_update_ref(table.clone(), i, b, s, **kw))
    untouched = np.setdiff1d(np.arange(n), ids)
    assert torch.equal(got[untouched], table[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("d,offset", [(64, 0), (30, 0), (33, 0), (64, 1)])
def test_scatter_set_kernel_casts_rows_of_the_other_type(cuda, dtype, rows_dtype, d, offset):
    """The conversion in registers rounds as ``.to`` does: bit-equal."""
    rng = np.random.default_rng(43)
    table, ids, rows = _set_inputs(rng, 700, 3000, d)
    t = _offset_view(torch.from_numpy(table).to(cuda).to(dtype), offset)
    i = torch.from_numpy(ids).to(cuda)
    r = torch.from_numpy(rows).to(cuda).to(rows_dtype)
    got = scatter.scatter_set_rows(t.clone(), i, r)
    torch.cuda.synchronize()
    assert torch.equal(got, scatter.scatter_set_rows_ref(t.clone(), i, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernels_on_unaligned_views_match_plain(cuda, dtype):
    """Table and rows one element off 16-byte alignment: the element paths
    of K3 (exact on unique ids) and S1 (bits)."""
    rng = np.random.default_rng(44)
    n, m, d = 300, 120, 64
    ids = rng.permutation(n)[:m].astype(np.int32)
    i = torch.from_numpy(ids).to(cuda)
    table = _offset_view(
        torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda).to(dtype), 1)
    rows = _offset_view(
        torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(cuda).to(dtype), 1)
    assert table.data_ptr() % 16 and rows.data_ptr() % 16
    for fn, ref in ((scatter.scatter_add_rows, scatter.scatter_add_rows_ref),
                    (scatter.scatter_set_rows, scatter.scatter_set_rows_ref)):
        got = fn(table.clone(), i, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, ref(table.clone(), i, rows)), fn.__name__


@pytest.mark.cuda
def test_launch_follows_the_tensors_device(cuda):
    """A tensor on another device than the current one launches on its own
    device (the guard is in the C entry points). With one card the two
    coincide, and all that can be shown is that the launch passes the
    tensor's index and leaves the current device as it was."""
    last = torch.cuda.device_count() - 1
    dev = torch.device("cuda", last)
    table = torch.arange(40, dtype=torch.float32, device=dev).reshape(10, 4)
    ids = torch.tensor([3, 1], dtype=torch.int32, device=dev)
    torch.cuda.set_device(0)
    got = gather.gather_rows(table, ids)
    added = scatter.scatter_add_rows(table.clone(), ids, got)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert got.device == dev and torch.equal(got, table[[3, 1]])
    assert torch.equal(added[[3, 1]], 2 * table[[3, 1]])


def _capture_cases(dev):
    """name -> (fn(out_or_table) -> result, fresh-state maker) for every
    kernel entry, at small shapes; in-place entries get a fresh table."""
    rng = np.random.default_rng(46)
    n, m, d = 500, 256, 64
    f32 = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(n)[:m].astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
    his = torch.from_numpy(rng.integers(0, n, (m, 9)).astype(np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(0, 10, m).astype(np.int32)).to(dev)
    sim = torch.from_numpy(rng.normal(size=(32, 1024)).astype(np.float32)).to(dev)
    widx = torch.from_numpy(rng.integers(0, 8, (32, 5)).astype(np.int32)).to(dev)
    lr = torch.tensor(0.1, device=dev)
    pooled = {tag: torch.empty(100, d, dtype=dtype, device=dev)
              for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    cases = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        t, r = f32.to(dtype), rows.to(dtype)
        cases[f"gather_rows_{tag}"] = (lambda x, t=t: gather.gather_rows(t, ids), None)
        cases[f"gather_blocks_{tag}"] = (
            lambda x, t=t: gather.gather_blocks(t, ids[:100] // 4, 4), None)
        cases[f"history_mean_{tag}"] = (
            lambda x, t=t: gather.history_mean_gather(t, his, lens), None)
        cases[f"history_mean_rows_out_{tag}"] = (
            lambda x, t=t: gather.history_mean_gather(
                t, his, lens, rows=ids[:100], out=pooled[tag], split=2), None)
        cases[f"gather_rows_multi_{tag}"] = (
            lambda x, t=t: torch.cat(gather.gather_rows_multi(
                [(t, ids), (f32, ids[:7]), (t, ids[:100])], torch.float32)), None)
        cases[f"scatter_add_rows_{tag}"] = (
            lambda x, r=r: scatter.scatter_add_rows(x, ids, r), t)
        cases[f"scatter_set_rows_{tag}"] = (
            lambda x: scatter.scatter_set_rows(x, ids, rows), t)
        cases[f"scatter_add_update_{tag}"] = (
            lambda x: scatter.scatter_add_update(
                x, ids, rows, lr=lr, clip_val=0.25, l2=0.01, rows=rows,
                clip_first=True), t)
        cases[f"scatter_add_update_own_{tag}"] = (
            lambda x: scatter.scatter_add_update(
                x, ids, rows, lr=lr, clip_val=0.25, l2=0.01, clip_first=False), t)
        cases[f"scatter_set_update_{tag}"] = (
            lambda x: scatter.scatter_set_update(
                x, ids, rows, rows, lr=lr, clip_val=0.25, l2=0.01), t)
    cases["window_extract"] = (lambda x: topk.window_extract(sim, widx, 128), None)
    return cases


@pytest.mark.cuda
def test_every_kernel_captures_into_a_cuda_graph_and_replays(cuda):
    """Each entry launches on the capture stream (read at every launch) and
    does nothing a capture forbids: the replayed graph gives the eager
    result (the ids are unique, so the adds are exact)."""
    for name, (fn, state) in _capture_cases(cuda).items():
        want = fn(None if state is None else state.clone())
        torch.cuda.synchronize()
        static = None if state is None else state.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(static)
        if static is not None:
            static.copy_(state)  # the capture ran nothing; start from the state
        else:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
