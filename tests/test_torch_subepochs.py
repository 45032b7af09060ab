"""Sub-epoch item partitioning (``num_subepochs > 1``) in the port.

Against the JAX package on the CPU: both engines train the same small
planted-cluster dataset in file order (shuffle mode "none") from one
initial state, with the negatives (or the tile and its draws) pinned on
both sides to one table indexed by the sampler's sample counter. The
permutation needs no pinning: both engines draw it from
``np.random.default_rng(seed ^ 0x5EED)``. Tables follow the rule of
``tests/test_torch_engine.py`` (``_assert_tables_close``: rtol 1e-4 / atol
1e-6 on a share of the elements, none off by more than 1e-2 of a step's
largest move, lr * clip_val), losses agree to rtol 1e-4 and ``step`` is
equal. The learning rate is 0.002: at batch 64 (a dozen steps an epoch)
the two packages' summation-order noise grows chaotically at 0.01 and
above, without and with sub-epochs alike, past that cap within two epochs.
The JAX engine's history dedup is switched off on its instance: its
per-bucket path caches the maps under ``id()`` of the bucket array
(``heat_tpu/train/engine.py:671``), so a bucket freed after its sub-epoch
can hand its id, and its maps, to the next one; the dedup is an exact
rewrite, and the port takes none under sub-epochs.

The port's two forms, the device bucketing (the default) and the host
per-bucket oracle (``engine._fuse_subepochs = False``), see the same
buckets in the same order, the same ``randperm`` draws and the same steps:
they are held bit for bit to each other.

The ``cuda``-marked tests run on the card and skip here: ``python -m pytest
--noconftest -m cuda tests/test_torch_subepochs.py``; JAX is imported only
inside the tests that compare with it.
"""

import contextlib

import numpy as np
import pytest
import torch

import heat_tpu_torch.train.train_step as tts
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.datasets import ClickDataset
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.testing import StepRecorder, distinct_id_dataset, replayed_equals_eager
from heat_tpu_torch.train.engine import Engine as TEngine

LR, CLIP = 0.002, 0.1
BASE = dict(emb_dim=16, max_his=6, num_negs=4, batch_size=64, l_r=LR,
            clip_val=CLIP, seed=21)
JAX_BASE = dict(shuffle_mode="none")
TILE = dict(neg_sampler=1, tile_size=32, refresh_interval=256)
DEFAULT_SHAPE = dict(TILE, his_refresh="subepoch", update_mode="direct",
                     param_dtype="bfloat16", compute_dtype="bfloat16")
EPOCHS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def port_engine(device="cpu", fused=True, data=None, **override):
    train, test = data or tsynthetic(80, 300, clicks_per_user=12, max_his=6,
                                     seed=9)
    e = TEngine(CFConfig(**{**BASE, **override}), train, test, device=device)
    e._fuse_subepochs = fused
    return e


def engines(jax_fused=False, **override):
    """The JAX engine (per-bucket, or its fused device path) and the port's
    device form and oracle, all from the JAX engine's initial state."""
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.data.synthetic import synthetic_click_dataset as jsynthetic
    from heat_tpu.train.engine import Engine as JEngine
    from test_torch_step import torch_state_of

    kw = {**BASE, **JAX_BASE, **override}
    jtrain, jtest = jsynthetic(80, 300, clicks_per_user=12, max_his=6, seed=9)
    je = JEngine(JCFConfig(**kw), jtrain, jtest, seed=kw["seed"])
    je._fuse_subepochs = jax_fused
    je._history_dedup = lambda pairs, users: None  # see the module docstring
    out = [je]
    for fused in (True, False):
        te = port_engine(fused=fused, **{**JAX_BASE, **override})
        te.state = torch_state_of(je.state)
        out.append(te)
    return out


@contextlib.contextmanager
def pinned(je):
    """Both packages' samplers pinned for EPOCHS epochs: negatives for the
    uniform sampler, the tile and its draws for the tile sampler."""
    from test_torch_fastpath import pinned_tiles
    from test_torch_step import pinned_negatives

    cfg = je.cfg
    rng = np.random.default_rng(3)
    n = EPOCHS * cfg.train_size + cfg.batch_size
    if cfg.neg_sampler == 1:
        tiles = rng.integers(0, cfg.num_items, (7, cfg.tile_size)).astype(np.int32)
        idx = rng.integers(0, cfg.tile_size, (n, cfg.num_negs)).astype(np.int32)
        with pinned_tiles(tiles, idx):
            yield
    else:
        draws = rng.integers(0, cfg.num_items, (n, cfg.num_negs)).astype(np.int32)
        with pinned_negatives(draws):
            yield


def assert_bucket_widths(te) -> None:
    """The two forms pack at one width only where every non-empty bucket
    holds at least batch_size pairs (the per-bucket path packs a bucket at
    min(batch_size, its size))."""
    perm = np.random.default_rng(te.cfg.seed ^ 0x5EED)
    clicks = np.bincount(te._pairs_np[:, 1], minlength=te.cfg.num_items)
    bounds = np.linspace(0, te.cfg.num_items, te.cfg.num_subepochs + 1).astype(int)
    for _ in range(EPOCHS):
        p = perm.permutation(te.cfg.num_items)
        for s in range(te.cfg.num_subepochs):
            n = clicks[p[bounds[s]: bounds[s + 1]]].sum()
            assert n == 0 or n >= te.cfg.batch_size, n


def assert_same_bits(a, b) -> None:
    """Everything the two forms leave is bit-equal."""
    for name in ("user_emb", "item_emb", "w0", "step", "lr", "user_gacc",
                 "item_gacc"):
        x, y = getattr(a.state, name), getattr(b.state, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    for k, v in (a.state.opt_slots or {}).items():
        assert torch.equal(v, b.state.opt_slots[k]), k
    assert torch.equal(a.sampler_state.iterations, b.sampler_state.iterations)
    if a.sampler_state.tile is not None:
        assert torch.equal(a.sampler_state.tile, b.sampler_state.tile)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.epoch == b.epoch


def run_against_jax(jax_fused=False, share=0.995, cap=1e-2, **override):
    """EPOCHS epochs of the JAX engine and of both port forms with pinned
    draws. The forms are bit-equal (losses included); the device form is
    held to the JAX engine: losses rtol 1e-4, tables by the rule of
    tests/test_torch_engine.py (rtol 1e-4 / atol 1e-6 on ``share`` of the
    elements, none off by more than ``cap`` of lr * clip_val), ``step`` and
    the sampler's count equal."""
    je, te, oracle = engines(jax_fused=jax_fused, **override)
    assert_bucket_widths(te)
    with pinned(je):
        jl = [je.train_one_epoch() for _ in range(EPOCHS)]
        tl = [te.train_one_epoch() for _ in range(EPOCHS)]
        ol = [oracle.train_one_epoch() for _ in range(EPOCHS)]
    assert tl == ol
    assert_same_bits(te, oracle)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for name in ("user_emb", "item_emb", "w0"):
        got = getattr(te.state, name).float().numpy()
        want = np.asarray(getattr(je.state, name), np.float32)
        diff = np.abs(got - want)
        assert (diff <= 1e-6 + 1e-4 * np.abs(want)).mean() >= share, name
        assert diff.max() <= cap * LR * CLIP, (name, diff.max())
    assert int(te.state.step) == int(je.state.step)
    assert int(te.sampler_state.iterations) == int(je.sampler_state.iterations)
    assert int(te.sampler_state.iterations) == EPOCHS * te.cfg.train_size
    return je, te


# --- the step's negative pool --------------------------------------------------


@pytest.mark.parametrize("tile", [False, True], ids=["uniform", "tile"])
def test_step_with_a_padded_negative_pool_matches_jax(tile):
    """``train_step(neg_candidates=, neg_candidates_size=)`` against the JAX
    step, two steps with pinned draws, a pool padded past its size with an
    id the draws must never reach: the tile (tile path) or the draws are
    remapped ``pool[id % size]``; the sampler keeps the raw tile. Held to
    the rule of tests/test_torch_step.py (rtol 1e-5 / atol 1e-7)."""
    import jax
    import jax.numpy as jnp

    import heat_tpu.train.train_step as jts
    from heat_tpu.models.state import init_train_state as jinit
    from heat_tpu.train.samplers import init_sampler_state as jinit_sampler
    from heat_tpu_torch.models.state import state_from_numpy
    from heat_tpu_torch.train.samplers import init_sampler_state
    from test_torch_fastpath import _step_setup, pinned_tiles
    from test_torch_step import TOL, _setup, pinned_negatives

    if tile:
        jcfg, tcfg, batch, his, masks, pins = _step_setup()
        pin = pinned_tiles(*pins)
    else:
        jcfg, tcfg, batch, his, masks, draws = _setup(0.05, 0.02)
        pin = pinned_negatives(draws)
    rng = np.random.default_rng(4)
    size = 57
    pool = np.full(64, 89, np.int32)  # the pad: an id outside the valid prefix
    pool[:size] = rng.permutation(80)[:size]
    jstate = jinit(jcfg, jax.random.key(1))
    tstate = state_from_numpy(jstate.user_emb, jstate.item_emb, jstate.w0,
                              lr=jcfg.l_r, step=0, device="cpu")
    before = tstate.item_emb[89].clone()
    args = [jnp.asarray(his), jnp.asarray(masks)], [torch.from_numpy(his),
                                                   torch.from_numpy(masks)]
    with pin:
        jss = jinit_sampler(jcfg, jax.random.key(2))
        tss = init_sampler_state(tcfg, "cpu", torch.Generator().manual_seed(0))
        for _ in range(2):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3),
                jts.Batch(*map(jnp.asarray, batch)), *args[0], jcfg,
                neg_candidates=jnp.asarray(pool),
                neg_candidates_size=jnp.asarray(size, jnp.int32))
            tstate, tss, tloss = tts.train_step(
                tstate, tss, None, tts.Batch(*map(torch.from_numpy, batch)),
                *args[1], tcfg, neg_candidates=torch.from_numpy(pool),
                neg_candidates_size=torch.tensor(size, dtype=torch.int32))
            np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for name in ("user_emb", "item_emb", "w0"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   err_msg=name, **TOL)
    if tile:
        np.testing.assert_array_equal(tss.tile.numpy(), np.asarray(jss.tile))
        assert not np.isin(tss.tile.numpy(), pool[:size]).all()  # raw tile
    # Item 89 is only in the pad: no negative reached it (as a positive it
    # may have moved, so only where no positive is 89).
    if not (batch[1] == 89).any():
        assert torch.equal(tstate.item_emb[89], before)


def test_profile_steps_runs_a_subepochs_stream_on_the_cpu():
    """bench_large.profile_steps on a sub-epoch engine runs the steps of
    its first sub-epoch, from the engine's buffers, with the negative
    pool."""
    from heat_tpu_torch import bench_large

    e = port_engine(num_subepochs=2, subepoch_neg_scope="complement",
                    batch_size=32, **TILE)
    out = bench_large.profile_steps(e, 2)
    assert out["steps"] == 2 and out["replayed"] is None
    assert int(e.state.step) == 5  # 2 timed, 1 in the profiler's warm-up, 2 traced
    assert e._neg_pool is not None and 0 < int(e._neg_pool[1]) < 300


# --- (a) the partition ------------------------------------------------------


def _record_buckets(engine, jax=False):
    """Wraps the engine so that each non-empty sub-epoch's bucket (its real
    pairs, in stream order) and negative pool are recorded: the JAX
    engine's and the port oracle's ``_run_pairs(pairs, ..., pool)``, the
    port device form's ``_steps`` over the stream buffers."""
    seen = []
    if jax or not engine._fuse_subepochs:
        orig = engine._run_pairs

        def run_pairs(pairs, *args):
            pool = args[-1] if args else None
            if int(pairs.shape[0]):
                seen.append((np.asarray(pairs),
                             None if pool is None else np.asarray(pool)))
            return orig(pairs, *args)

        engine._run_pairs = run_pairs
        return seen
    orig = engine._steps

    def steps(capture, count, dedup=None, neg_pool=(None, None)):
        users, pos, weight = (t[:count].reshape(-1) for t in engine._stream)
        pool, size = neg_pool
        seen.append((torch.stack([users, pos], 1)[weight > 0].numpy(),
                     None if pool is None else pool[: int(size)].numpy().copy()))
        return orig(capture, count, dedup, neg_pool)

    engine._steps = steps
    return seen


def test_partition_buckets_and_complements_equal_jax():
    """(a) For one seed, the permutation, the buckets (pair order kept) and
    the complements of both port forms equal the JAX engine's per-bucket
    path's, bit for bit, over two epochs, S = 3, complement scope."""
    je, te, oracle = engines(num_subepochs=3, subepoch_neg_scope="complement")
    want = _record_buckets(je, jax=True)
    got = [_record_buckets(e) for e in (te, oracle)]
    perm_j = np.random.default_rng(21 ^ 0x5EED).permutation(300)
    perm_t, bounds = te._partition()
    te._np_rng = np.random.default_rng(21 ^ 0x5EED)  # undo the draw above
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_array_equal(bounds, [0, 100, 200, 300])
    with pinned(je):
        for e in (je, te, oracle):
            for _ in range(EPOCHS):
                e.train_one_epoch()
    assert len(want) == EPOCHS * 3
    for rec in got:
        assert len(rec) == len(want)
        for (pairs, pool), (jpairs, jpool) in zip(rec, want):
            np.testing.assert_array_equal(pairs, jpairs)
            np.testing.assert_array_equal(pool, jpool)
    # Each bucket holds the clicks of its partition; the pools are the rest.
    for s, (pairs, pool) in enumerate(want[:3]):
        part = perm_j[bounds[s]: bounds[s + 1]]
        assert np.isin(pairs[:, 1], part).all()
        assert not np.isin(pool, part).any()
        assert len(pool) + len(part) == 300


# --- (b)-(g) the epochs against the JAX package ------------------------------


@pytest.mark.parametrize("scope", ["global", "complement"])
def test_uniform_sampler_subepochs_match_jax(scope):
    """(b), (g) Uniform sampler, S = 3: the port's forms against the JAX
    engine's per-bucket path (tests/test_engine.py:62), and bit-equal to
    each other. Complement scope changes the trajectory."""
    je, te = run_against_jax(num_subepochs=3, subepoch_neg_scope=scope)
    if scope == "complement":
        _, glob, _ = engines(num_subepochs=3)
        with pinned(je):
            for _ in range(EPOCHS):
                glob.train_one_epoch()
        assert not torch.equal(glob.state.item_emb, te.state.item_emb)


def test_accum_subepochs_match_jax():
    """(c), (g) Accum mode zeroes its gradient rows after every sub-epoch
    (tests/test_engine.py:72, engine.cpp:344-347). Its stored rows re-apply
    their summation-order noise at every later touch: share 0.99, as for
    accum in tests/test_torch_engine.py."""
    _, te = run_against_jax(share=0.99, num_subepochs=3, sgd_mode="accum")
    assert not te.state.user_gacc.any() and not te.state.item_gacc.any()


def test_accum_rows_are_zeroed_after_each_subepoch(monkeypatch):
    """(c) The gradient rows are zero when each sub-epoch starts, in both
    forms."""
    for fused in (True, False):
        e = port_engine(fused=fused, num_subepochs=3, sgd_mode="accum")
        starts = []
        orig = e._steps

        def steps(*args, **kw):
            starts.append(bool(e.state.user_gacc.any() or e.state.item_gacc.any()))
            return orig(*args, **kw)

        e._steps = steps
        e.train_one_epoch()
        assert starts == [False, False, False]


def test_adam_subepochs_match_jax():
    """(d), (g) Adam (tests/test_engine.py:937). An Adam step moves an
    element by up to lr, not lr * clip_val: the tables' cap is 1e-2 of lr.
    The moments, in gradient units, within 1e-2 of clip_val (its square for
    v)."""
    je, te = run_against_jax(cap=1e-2 / CLIP, num_subepochs=3, optimizer="adam")
    for k, v in te.state.opt_slots.items():
        diff = np.abs(v.numpy() - np.asarray(je.state.opt_slots[k]))
        assert diff.max() <= 1e-2 * CLIP ** (2 if k.endswith("_v") else 1), k


def test_tile_complement_subepochs_match_jax():
    """(e), (g) Tile sampler under complement scope (tests/test_engine.py:
    778, 903): the tile is remapped through each sub-epoch's pool; the
    sampler keeps the raw pinned tile, equal to the JAX engine's."""
    je, te = run_against_jax(num_subepochs=3, subepoch_neg_scope="complement",
                             **TILE)
    np.testing.assert_array_equal(te.sampler_state.tile.numpy(),
                                  np.asarray(je.sampler_state.tile))


def test_tile_remap_reads_only_complement_rows(monkeypatch):
    """(e) Every tile row a complement-scope step reads lies outside the
    sub-epoch's partition, in both forms."""
    import heat_tpu_torch.train.train_step as ts

    for fused in (True, False):
        e = port_engine(fused=fused, num_subepochs=3,
                        subepoch_neg_scope="complement", **TILE)
        partitions = []
        orig_partition = e._partition

        def partition():
            perm, bounds = orig_partition()
            partitions.append((perm, bounds))
            return perm, bounds

        e._partition = partition
        reads = []
        orig = ts.gather_rows_multi

        def multi(segments, dtype):
            reads.append((segments[1][1].clone(), segments[2][1].clone()))
            return orig(segments, dtype)

        monkeypatch.setattr(ts, "gather_rows_multi", multi)
        e.train_one_epoch()
        perm, bounds = partitions[0]
        part_of = np.empty(300, np.int64)
        for s in range(3):
            part_of[perm[bounds[s]: bounds[s + 1]]] = s
        for pos, tile in reads:
            (s,) = set(part_of[pos.numpy()])  # one partition a step
            assert (part_of[tile.numpy()] != s).all()
        monkeypatch.undo()


def test_default_shape_in_f32_matches_the_jax_fused_device_path():
    """(f), (g) The reference's default shape (tile sampler, pools once a
    sub-epoch, direct, S = 2) against the JAX engine's fused device path
    (its default), in f32."""
    run_against_jax(jax_fused=True, num_subepochs=2,
                    **{**DEFAULT_SHAPE, "param_dtype": "float32",
                       "compute_dtype": "float32"})


def test_default_shape_in_bf16_equals_the_jax_fused_device_path():
    """(f), (g) The default shape with bf16 tables and compute against the
    JAX engine's fused device path run op by op (``jax.disable_jit``: under
    jit XLA keeps some bf16 intermediates in f32, which eager PyTorch
    rounds), on clicks in which every user and every item occurs once and
    tiles of items nobody clicked: no row takes two bf16 adds in a step, so
    the result does not depend on the order of the adds. Two epochs are bit
    for bit the JAX package's: losses, both tables and w0."""
    import jax
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.data.datasets import ClickDataset as JClickDataset
    from heat_tpu.train.engine import Engine as JEngine
    from heat_tpu_torch.models.state import state_from_numpy
    from test_torch_fastpath import pinned_tiles

    def data(cls, n=128, items=300):
        rng = np.random.default_rng(0)
        return cls(
            pairs=np.stack([rng.permutation(n), rng.permutation(n)], 1).astype(np.int32),
            his_items=rng.integers(0, items, (n, 6)).astype(np.int32),
            masks=rng.integers(1, 7, n).astype(np.int32), num_users=n,
            num_items=items, max_his=6, user_items=[],
        )

    kw = dict(DEFAULT_SHAPE, num_subepochs=2, batch_size=32,
              shuffle_mode="none", l_r=0.01)
    je = JEngine(JCFConfig(**{**BASE, **kw}), data(JClickDataset), None, seed=21)
    out = []
    for fused in (True, False):
        te = port_engine(fused=fused, data=(data(ClickDataset), None), **kw)
        te.state = state_from_numpy(
            je.state.user_emb, je.state.item_emb, je.state.w0, lr=0.01,
            step=0, device="cpu", param_dtype=torch.bfloat16)
        out.append(te)
    assert_bucket_widths(out[0])
    rng = np.random.default_rng(3)
    tiles = (128 + np.stack([rng.permutation(172)[:32] for _ in range(7)])).astype(np.int32)
    idx = rng.integers(0, 32, (EPOCHS * 128 + 32, 4)).astype(np.int32)
    with pinned_tiles(tiles, idx):
        with jax.disable_jit():
            jl = [je.train_one_epoch() for _ in range(EPOCHS)]
        tl = [[e.train_one_epoch() for _ in range(EPOCHS)] for e in out]
    assert tl[0] == tl[1]
    np.testing.assert_allclose(tl[0], jl, rtol=1e-6)  # f32 sums, two orders
    assert_same_bits(*out)
    te = out[0]
    for name in ("user_emb", "item_emb", "w0"):
        want = torch.from_numpy(np.array(getattr(je.state, name), np.float32))
        assert torch.equal(getattr(te.state, name).float(), want), name
    assert int(te.state.step) == int(je.state.step) == 10
    assert te.state.user_emb.dtype == torch.bfloat16


# --- (h)-(k) -----------------------------------------------------------------


def skewed_dataset(seed: int, users=60, items=120, clicks_per_user=8):
    """Clicks with a Zipf-like item popularity, so that the bucket sizes
    jump from one permutation to the next."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, items + 1) ** 1.2
    pairs = np.stack([
        np.repeat(np.arange(users), clicks_per_user),
        rng.choice(items, users * clicks_per_user, p=p / p.sum()),
    ], 1).astype(np.int32)
    data = ClickDataset(
        pairs=pairs,
        his_items=rng.integers(0, items, (users, 6)).astype(np.int32),
        masks=rng.integers(1, 7, users).astype(np.int32),
        num_users=users, num_items=items, max_his=6, user_items=[],
    )
    return data, None


@pytest.mark.parametrize("override", [
    dict(num_subepochs=2, **TILE, milestones=[2]),
    dict(num_subepochs=3, sgd_mode="accum", shuffle_mode="once"),
    dict(num_subepochs=2, subepoch_neg_scope="complement", **DEFAULT_SHAPE),
], ids=["tile", "accum_once", "default_shape_complement"])
def test_train_epochs_matches_sequential_epochs(override):
    """(h) train_epochs(n) against n train_one_epoch calls: the same draws
    and the same bits (the epochs run one after the other), the learning
    rate's milestone inside the window."""
    a, b = port_engine(**override), port_engine(**override)
    seq = [a.train_one_epoch() for _ in range(4)]
    assert b.train_epochs(4) == seq
    assert_same_bits(a, b)
    assert b.train_epochs(0) == [] and b.epoch == 4


def test_train_epochs_matches_sequential_when_the_geometry_grows():
    """(h) The grow-only geometry grows in the middle of train_epochs(4)
    (the JAX engine bails and rewinds there, tests/test_engine.py:964): the
    stream buffers move once and the epochs still equal sequential ones."""
    data = skewed_dataset(4, items=60)
    kw = dict(num_subepochs=2, batch_size=16, data=data)
    a, b = port_engine(**kw), port_engine(**kw)
    geoms, ptrs = [], []
    for _ in range(4):
        a.train_one_epoch()
        geoms.append(a._subep_geom)
        ptrs.append(a._stream[0].data_ptr())
    assert geoms[0] != geoms[-1] and geoms[0][0] == geoms[-1][0], geoms
    assert len(set(ptrs)) == len(set(geoms))
    b2 = port_engine(**kw)
    seq = [b2.train_one_epoch() for _ in range(4)]
    assert b.train_epochs(4) == seq
    assert_same_bits(b, b2)
    assert b._subep_geom == geoms[-1]


def test_run_epochs_with_eval_fused_matches_unfused():
    """(i) tests/test_engine.py:855 at the default shape: the same losses,
    metrics and state, evaluations after epochs 2 and 4."""
    kw = dict(num_subepochs=2, metrics=["Recall(k=20)", "NDCG(k=20)"],
              **DEFAULT_SHAPE)
    f, s = port_engine(**kw), port_engine(**kw)
    lf, ef = f.run_epochs_with_eval(5, 2)
    ls, es = s.run_epochs_with_eval(5, 2, fused=False)
    assert lf == ls and ef == es
    assert [e["epoch"] for e in ef] == [2, 4]
    assert_same_bits(f, s)


def test_empty_buckets_run_nothing_and_draw_nothing(monkeypatch):
    """(j) Clicks on one item leave two of three buckets empty: each epoch
    draws one shuffle, of the one bucket, takes its steps and nothing more,
    in both forms; both leave the generator in one state."""
    rng = np.random.default_rng(0)
    data = ClickDataset(
        pairs=np.stack([np.arange(100), np.full(100, 7)], 1).astype(np.int32),
        his_items=rng.integers(0, 90, (100, 6)).astype(np.int32),
        masks=np.full(100, 6, np.int32), num_users=100, num_items=90,
        max_his=6, user_items=[],
    )
    draws = []
    orig = torch.randperm

    def randperm(n, *args, **kw):
        draws.append(n)
        return orig(n, *args, **kw)

    monkeypatch.setattr(torch, "randperm", randperm)
    out = []
    for fused in (True, False):
        e = port_engine(fused=fused, data=(data, None), num_subepochs=3,
                        batch_size=32, shuffle_mode="epoch")
        draws.clear()
        for _ in range(2):
            e.train_one_epoch()
        assert draws == [100, 100]
        assert int(e.state.step) == 2 * 4
        out.append(e)
    assert_same_bits(*out)


def test_once_gives_each_bucket_its_own_stream(monkeypatch):
    """(k) shuffle_mode "once" under sub-epochs: every sub-epoch trains its
    own bucket (a stream cached for the epoch's pairs would train one
    bucket's stream in every sub-epoch), shuffled anew each epoch; both
    forms alike."""
    out = []
    for fused in (True, False):
        e = port_engine(fused=fused, num_subepochs=2, shuffle_mode="once")
        steps = []
        orig_steps = e._steps

        def run(capture, count, *args, **kw):
            users, pos, weight = (t[:count].clone() for t in e._stream)
            steps.append(sorted(pos.reshape(-1)[weight.reshape(-1) > 0].tolist()))
            return orig_steps(capture, count, *args, **kw)

        e._steps = run
        parts = []
        orig_partition = e._partition

        def partition():
            parts.append(orig_partition())
            return parts[-1]

        e._partition = partition
        e.train_one_epoch()
        e.train_one_epoch()
        pairs = e._pairs_np
        for i, got in enumerate(steps):
            perm, bounds = parts[i // 2]
            part = perm[bounds[i % 2]: bounds[i % 2 + 1]]
            want = sorted(pairs[np.isin(pairs[:, 1], part), 1].tolist())
            assert got == want
        out.append(e)
    assert_same_bits(*out)


# --- the engine's faults -------------------------------------------------------


def test_once_cache_is_keyed_on_its_pairs():
    """A "once" stream is cached for the pairs it was drawn from: other
    pairs get their own stream, and the cached one is drawn anew once the
    buffers held another."""
    e = port_engine(shuffle_mode="once")
    a, b = e.pairs[:300].clone(), e.pairs[300:].clone()
    ua = e._make_batches(a)[1].clone()
    assert torch.equal(e._make_batches(a)[1], ua)  # cached
    pb = e._make_batches(b)[1]
    n = b.shape[0]
    assert sorted(pb.reshape(-1)[:n].tolist()) == sorted(b[:, 1].tolist())
    assert e._batch_cache[0] is b


def test_history_dedup_cache_holds_its_pairs():
    """The dedup maps are cached for the pairs object itself: pairs freed
    after their maps were taken cannot pass their ``id`` on to other pairs
    of the same stream shape, which would read the stale maps."""
    e = port_engine(shuffle_mode="none", visit_order="user")
    first = e.pairs.clone()
    users_a = e._make_batches(first)[0].clone()
    e._history_dedup(first, users_a)
    stale_id = id(first)
    del first
    flipped = np.ascontiguousarray(e.pairs.numpy()[::-1])
    other = None
    for _ in range(64):  # a new tensor object tends to take a freed id
        other = None
        other = torch.from_numpy(flipped.copy())
        if id(other) == stale_id:
            break
    users_b = e._make_batches(other)[0]
    maps = e._history_dedup(other, users_b)
    assert maps is not None
    assert torch.equal(torch.gather(maps[0], 1, maps[1].long()), users_b)


def test_no_history_dedup_under_subepochs(monkeypatch):
    """Buckets are drawn anew every epoch, so a map cached per stream would
    never be read again: the sub-epochs take no dedup, with a complement
    pool or without."""
    for scope in ("global", "complement"):
        for fused in (True, False):
            e = port_engine(fused=fused, num_subepochs=2, shuffle_mode="none",
                            visit_order="user", subepoch_neg_scope=scope)
            monkeypatch.setattr(e, "_history_dedup", lambda *a: 1 / 0)
            assert np.isfinite(e.train_one_epoch())


def test_stream_buffers_keep_their_address_across_bucket_sizes():
    """The stream buffers grow only: a shorter stream of the same width is
    written into the same buffers (the captured step reads one address),
    and sub-epochs of jittering bucket sizes keep them across epochs."""
    e = port_engine()
    ptrs = {t.data_ptr() for t in e._make_batches(e.pairs)}
    short = e._make_batches(e.pairs[:200].clone())
    assert {t.data_ptr() for t in short} == ptrs
    assert short[0].shape == (4, 64) and not short[2][3, 8:].any()
    s = port_engine(num_subepochs=3)
    s.train_one_epoch()
    held = [t.data_ptr() for t in s._stream]
    geom = s._subep_geom
    for _ in range(3):
        s.train_one_epoch()
    assert s._subep_geom == geom
    assert [t.data_ptr() for t in s._stream] == held


def test_subepoch_steps_replay_no_all_padding_batch(monkeypatch):
    """Each sub-epoch runs ceil(n_s / B) steps, over a buffer of more rows."""
    e = port_engine(num_subepochs=3)
    counts = []
    orig = e._steps

    def steps(capture, count, *args, **kw):
        counts.append(count)
        return orig(capture, count, *args, **kw)

    e._steps = steps
    e.train_one_epoch()
    assert sum(counts) == int(e.state.step)
    assert e._stream[0].shape[0] > max(counts)
    assert int(e.sampler_state.iterations) == e.cfg.train_size


def test_cli_runs_subepochs_with_the_fused_flags(capsys):
    """The CLI with --set num_subepochs=2, alone and with --fused-epochs
    and --fused-run: the same printed losses and metrics."""
    from heat_tpu_torch import main as tmain

    def lines(*flags):
        tmain.main(["--config", "benchmarks/AmazonBooks/config0.yaml",
                    "--synthetic", "200,400", "--epochs", "3", "--device",
                    "cpu", "--set", "num_subepochs=2", *flags])
        out = capsys.readouterr().out.strip().splitlines()
        return [line.split("; epoch_time:")[0] for line in out]

    plain = lines()
    assert sum(line.startswith("epoch: ") for line in plain) == 3
    for flags in (["--fused-epochs", "3"], ["--fused-run"]):
        assert lines(*flags) == plain


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("override", [
    {}, dict(neg_sampler=1, tile_size=16, refresh_interval=32,
             his_refresh="subepoch", update_mode="direct",
             param_dtype="bfloat16", compute_dtype="bfloat16"),
], ids=["config0_shape", "default_shape"])
def test_replayed_subepochs_are_bit_equal_to_eager(cuda, override):
    """On 48 clicks that repeat no user and no item (4,000,000 items), two
    sub-epoch epochs replayed equal two eager ones bit for bit after each
    epoch, every draw and loss included."""
    data = distinct_id_dataset(48, 4_000_000, 6)
    cfg = dict(BASE, batch_size=8, num_negs=2, num_subepochs=2, **override)
    out = replayed_equals_eager(
        lambda: TEngine(CFConfig(**cfg), data, device=cuda), 2)
    assert out["captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [False, True], ids=["uniform", "tile"])
def test_complement_draws_lie_outside_their_partition(cuda, tile):
    """Every negative a replayed complement-scope step reads lies outside
    the partition of its sub-epoch (the partition its positives lie in)."""
    e = port_engine(cuda, num_subepochs=2, subepoch_neg_scope="complement",
                    **(TILE if tile else {}))
    parts = []
    orig = e._partition

    def partition():
        parts.append(orig())
        return parts[-1]

    e._partition = partition
    steps = 2 * (-(-e.cfg.train_size // e.cfg.batch_size) + 2)
    rec = StepRecorder(steps, e.cfg.batch_size, e.cfg.num_negs,
                       e.cfg.tile_size if tile else 0, cuda, True)
    with rec:
        e.train_one_epoch()
    perm, bounds = parts[0]
    part_of = np.empty(e.cfg.num_items, np.int64)
    for s in range(2):
        part_of[perm[bounds[s]: bounds[s + 1]]] = s
    n = int(rec.count)
    assert n == int(e.state.step)
    for i in range(n):
        (s,) = set(part_of[rec.pos[i].cpu().numpy()])
        assert (part_of[rec.negs[i].cpu().numpy()] != s).all()


@pytest.mark.cuda
def test_one_capture_across_two_epochs(cuda):
    """The sub-epochs of two epochs replay one captured step at a fixed
    geometry: the stream, pool and negative pool buffers keep their
    addresses."""
    e = port_engine(cuda, num_subepochs=2, subepoch_neg_scope="complement",
                    **DEFAULT_SHAPE)
    e.train_one_epoch()
    geom = e._subep_geom
    e.train_one_epoch()
    assert e._subep_geom == geom
    assert e._epoch_fns[True].captures == 1
