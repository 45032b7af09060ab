"""The port's kernels K1-K4 against the JAX package's Pallas kernels.

On the CPU each wrapper of ``heat_tpu_torch.ops.cuda`` runs its plain
PyTorch version; those are held here against the Pallas kernels in
interpret mode (as tests/test_pallas.py runs them) and against JAX's
``.at[].add(mode="drop")``; K4's plain version against a numpy oracle and
the one-hot einsum of ``heat_tpu/evaluation/evaluator.py`` (its Pallas
sources are closures inside ``scripts/profile_eval.py``). The ``cuda``-marked tests hold each CUDA
kernel against its plain version on the card and skip without one.

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
    in another order than index_add_: rtol 1e-5 / atol 1e-6."""
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
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


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


def test_window_extract_rejects_what_the_kernel_does_not_take(device):
    sim = torch.zeros(4, 256, device=device)
    widx = torch.zeros(4, 3, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="multiple"):
        topk.window_extract(sim[:, :200].contiguous(), widx, 128)
    with pytest.raises(ValueError, match="int32"):
        topk.window_extract(sim, widx.long(), 128)
    with pytest.raises(ValueError, match="f32"):
        topk.window_extract(sim.double(), widx, 128)
    with pytest.raises(ValueError, match="contiguous"):
        topk.window_extract(sim, torch.zeros(4, 6, dtype=torch.int32, device=device)[:, ::2], 128)
    with pytest.raises(ValueError, match="contiguous"):
        topk.window_extract(torch.zeros(512, 4, device=device).T, widx, 128)
    with pytest.raises(ValueError, match="widx"):
        topk.window_extract(sim, widx[:2], 128)
    if device.type == "cuda":
        with pytest.raises(ValueError, match="must be on cuda"):
            topk.window_extract(sim, widx.cpu(), 128)
