"""The port's whole slice against the JAX package: engine, evaluation, CLI.

Both Engines train the same small planted-cluster dataset in file order
(``shuffle_mode: none``) from one initial state with pinned negatives;
then both evaluate one set of tables. Also: the copied framework-free
modules agree with their originals, configurations off the slice are
refused, and the package imports no JAX.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.config import load_config as jload_config
from heat_tpu.data.synthetic import synthetic_click_dataset as jsynthetic
from heat_tpu.evaluation import metrics as jmetrics
from heat_tpu.evaluation.evaluator import TiledEvaluator as JTiledEvaluator
from heat_tpu.train import optimizer as joptimizer
from heat_tpu.train.engine import Engine as JEngine
from heat_tpu_torch import main as tmain
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.config import load_config as tload_config
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.evaluation import metrics as tmetrics
from heat_tpu_torch.models.state import state_from_numpy
from heat_tpu_torch.train import optimizer as toptimizer
from heat_tpu_torch.train.engine import Engine as TEngine

import heat_tpu.train.scatter as jsc
import heat_tpu_torch.train.scatter as tsc
from test_torch_step import pinned_negatives, torch_state_of

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
METRICS = ["Recall(k=20)", "Recall(k=50)", "NDCG(k=20)", "NDCG(k=50)",
           "HitRate(k=20)", "Precision(k=20)", "MAP(k=20)", "MRR(k=20)"]
LR, CLIP = 0.05, 0.1


def _engines(**override):
    kw = dict(emb_dim=16, max_his=6, num_negs=4, batch_size=256,
              l_r=LR, clip_val=CLIP, shuffle_mode="none", seed=21,
              metrics=METRICS, **override)
    jtrain, jtest = jsynthetic(80, 300, clicks_per_user=12, max_his=6, seed=9)
    ttrain, ttest = tsynthetic(80, 300, clicks_per_user=12, max_his=6, seed=9)
    je = JEngine(JCFConfig(**kw), jtrain, jtest, seed=21)
    te = TEngine(CFConfig(**kw), ttrain, ttest, device="cpu")
    te.state = torch_state_of(je.state)
    return je, te


def _assert_tables_close(te, je, share=0.995):
    """rtol 1e-4 (atol 1e-6 for elements near zero) on at least ``share``
    of the elements, and nowhere off by more than 1% of one step's largest
    move (lr * clip_val). Per-occurrence gradients here reach ~1e2 and
    cancel in the per-row sums, so the two packages' summation orders
    leave a few elements apart by more than rtol 1e-4 (measured: 0.17% of
    item elements, at most 5.5e-6); a wrong step moves whole rows by
    ~lr * clip_val."""
    for name in ("user_emb", "item_emb", "w0"):
        got = getattr(te.state, name).numpy()
        want = np.asarray(getattr(je.state, name))
        diff = np.abs(got - want)
        assert (diff <= 1e-6 + 1e-4 * np.abs(want)).mean() >= share, name
        assert diff.max() <= 1e-2 * LR * CLIP, (name, diff.max())


def _pinned_two_epochs(je, te):
    draws = np.random.default_rng(3).integers(
        0, je.cfg.num_items,
        (2 * je.cfg.train_size + je.cfg.batch_size, je.cfg.num_negs),
    ).astype(np.int32)
    with pinned_negatives(draws):
        jl = [je.train_one_epoch() for _ in range(2)]
        tl = [te.train_one_epoch() for _ in range(2)]
    return jl, tl


def test_two_epochs_and_evaluation_match_jax():
    je, te = _engines()
    assert je.cfg.train_size % je.cfg.batch_size  # a weight-0 padded tail
    jl, tl = _pinned_two_epochs(je, te)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[1] < tl[0]
    _assert_tables_close(te, je)
    assert int(te.state.step) == int(je.state.step)

    # Evaluate one set of tables on both sides.
    te.state = state_from_numpy(
        je.state.user_emb, je.state.item_emb, je.state.w0,
        lr=LR, step=int(je.state.step), device="cpu",
    )
    want, got = je.evaluate(), te.evaluate()
    assert list(got) == METRICS
    for m in METRICS:
        assert abs(got[m] - want[m]) <= 1e-6, (m, got[m], want[m])

    # Tie-aware top-k: equal score lists, and equal id sets wherever the
    # k-th score is strictly above the (k+1)-th.
    k = 20
    jev = JTiledEvaluator(je.train_data.pairs, je.cfg.num_users,
                          num_items=je.cfg.num_items)
    js, jids = jev.topk(je.state.user_emb, je.state.item_emb, k + 1,
                        return_scores=True)
    te._ensure_evaluator(512)
    ts, tids = te._evaluator.topk(te.state.user_emb, te.state.item_emb, k + 1,
                                  return_scores=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    strict = ts[:, k - 1] > ts[:, k]
    assert strict.float().mean() > 0.9
    for row in np.flatnonzero(strict.numpy()):
        assert set(tids[row, :k].tolist()) == set(jids[row, :k].tolist())


def test_evaluate_through_two_phase_topk_matches_jax(monkeypatch):
    """At 4500 items (padded to 4608) every eval tile goes through
    masked_topk -> exact_topk_2phase -> K4 (its plain version here); the
    metrics equal the JAX package's on the same tables."""
    import heat_tpu_torch.evaluation.evaluator as tev
    from heat_tpu_torch.ops.cuda.topk import window_extract

    kw = dict(emb_dim=16, max_his=6, metrics=METRICS, seed=5)
    jtrain, jtest = jsynthetic(150, 4500, clicks_per_user=20, max_his=6, seed=2)
    ttrain, ttest = tsynthetic(150, 4500, clicks_per_user=20, max_his=6, seed=2)
    je = JEngine(JCFConfig(**kw), jtrain, jtest, seed=5)
    te = TEngine(CFConfig(**kw), ttrain, ttest, device="cpu")
    rng = np.random.default_rng(8)
    user = rng.normal(size=(150, 16)).astype(np.float32)
    item = rng.normal(size=(4500, 16)).astype(np.float32)
    je.state = je.state.replace(user_emb=user, item_emb=item)
    te.state = state_from_numpy(user, item, je.state.w0, lr=LR, step=0,
                                device="cpu")
    calls = []

    def counted(sim, widx, w):
        calls.append(tuple(sim.shape))
        return window_extract(sim, widx, w)

    monkeypatch.setattr(tev, "window_extract", counted)
    got, want = te.evaluate(user_tile=64), je.evaluate()
    assert calls == [(64, 4608), (64, 4608), (22, 4608)]
    for m in METRICS:
        assert abs(got[m] - want[m]) <= 1e-6, (m, got[m], want[m])


def test_evaluate0_matches_jax():
    je, te = _engines()
    np.testing.assert_allclose(te.evaluate0(), je.evaluate0(), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_with_aggregated_users_matches_jax(dtype):
    """``aggregate_users=True`` scores gamma * u + (1 - gamma) * pools @ w0
    over the pools of the live item table, on the same injected tables:
    the metrics agree to 1e-6 and the top-k tie-aware, in f32 and over
    bf16 tables (whose aggregation rounds where the JAX package's does)."""
    import jax.numpy as jnp
    from heat_tpu.models.aggregator import aggregate_history as jaggregate
    from heat_tpu_torch.models.aggregator import aggregate_history as taggregate

    je, te = _engines(param_dtype=dtype, compute_dtype=dtype)
    rng = np.random.default_rng(12)
    user = rng.normal(size=(80, 16)).astype(np.float32)
    item = rng.normal(size=(300, 16)).astype(np.float32)
    w0 = (np.eye(16) + 0.3 * rng.normal(size=(16, 16))).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    je.state = je.state.replace(user_emb=jnp.asarray(user, jdtype),
                                item_emb=jnp.asarray(item, jdtype),
                                w0=jnp.asarray(w0))
    te.state = state_from_numpy(
        user, item, w0, lr=LR, step=0, device="cpu",
        param_dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = je.evaluate(aggregate_users=True)
    got = te.evaluate(aggregate_users=True)
    raw = te.evaluate()
    assert list(got) == METRICS
    for m in METRICS:
        assert abs(got[m] - want[m]) <= 1e-6, (m, got[m], want[m])
    assert any(abs(got[m] - raw[m]) > 1e-4 for m in METRICS)  # it aggregated

    k = 20
    jagg = jaggregate(je.state.user_emb, je._pooled_history()[:80], je.state.w0,
                      je.cfg.gamma)
    tagg = taggregate(te.state.user_emb, te._pooled_history(), te.state.w0,
                      te.cfg.gamma)
    np.testing.assert_allclose(
        tagg.float().numpy(), np.asarray(jagg.astype(jnp.float32)),
        rtol=1e-6 if dtype == "float32" else 0, atol=1e-7 if dtype == "float32" else 0)
    jev = JTiledEvaluator(je.train_data.pairs, 80, num_items=300)
    js, jids = jev.topk(jagg, je.state.item_emb, k + 1, return_scores=True)
    ts, tids = te._evaluator.topk(tagg, te.state.item_emb, k + 1,
                                  return_scores=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    strict = ts[:, k - 1] > ts[:, k] + 1e-5
    assert strict.float().mean() > 0.9
    for row in np.flatnonzero(strict.numpy()):
        assert set(tids[row, :k].tolist()) == set(np.asarray(jids)[row, :k].tolist())


def test_copied_sim_matrix_oracle_matches_the_original():
    """``evaluate_sim_matrix`` and ``full_sim_matrix`` are copies of the
    JAX package's: the same metrics from the same dense matrix."""
    from heat_tpu.evaluation.evaluator import full_sim_matrix as jfull
    from heat_tpu_torch.evaluation.evaluator import full_sim_matrix as tfull

    je, te = _engines()
    sim = tfull(te.state.user_emb, te.state.item_emb)
    assert sim.dtype == np.float32 and sim.shape == (80, 300)
    np.testing.assert_allclose(
        sim, jfull(je.state.user_emb, je.state.item_emb), rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(sim, te.evaluate0())
    train_items = [[] for _ in range(80)]
    for u, i in np.asarray(te.train_data.pairs):
        train_items[u].append(int(i))
    args = (METRICS, sim, train_items, te.test_data.user_items)
    want = jmetrics.evaluate_sim_matrix(*args)
    got = tmetrics.evaluate_sim_matrix(*args)
    assert got == want and list(got) == METRICS


def test_cli_prints_final_metrics(capsys):
    record = tmain.main([
        "--config", CONFIG0, "--synthetic", "200,400", "--epochs", "2",
        "--device", "cpu",
    ])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("epoch: 0; loss: ")
    final = json.loads(lines[-1])["final_metrics"]
    assert set(final) == set(record["final_metrics"])
    assert final["Recall(k=20)"] > 3 * 20 / 400  # well above random ranking
    assert np.isfinite(record["losses"]).all()
    assert record["losses"][1] < record["losses"][0]


def test_copied_config_and_data_match_the_originals():
    jcfg, jds = jload_config(CONFIG0)
    tcfg, tds = tload_config(CONFIG0)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tds) == dataclasses.asdict(jds)
    for split_j, split_t in zip(jsynthetic(70, 150, max_his=9, seed=4),
                                tsynthetic(70, 150, max_his=9, seed=4)):
        for f in ("pairs", "his_items", "masks"):
            np.testing.assert_array_equal(getattr(split_t, f), getattr(split_j, f))
        assert (split_t.num_users, split_t.num_items) == (
            split_j.num_users, split_j.num_items)
        for a, b in zip(split_t.user_items, split_j.user_items):
            np.testing.assert_array_equal(a, b)
    for epoch in range(12):
        for ms in ([], [10], [3, 7]):
            assert toptimizer.scheduled_lr(0.01, epoch, ms, 0.1) == (
                joptimizer.scheduled_lr(0.01, epoch, ms, 0.1))
    rng = np.random.default_rng(0)
    top = rng.integers(0, 60, (25, 50))
    truth = [rng.choice(60, size=int(s), replace=False)
             for s in rng.integers(0, 6, 25)]
    assert tmetrics.evaluate_metrics(METRICS, top, truth) == (
        jmetrics.evaluate_metrics(METRICS, top, truth))


@pytest.mark.parametrize("sort", [False, True], ids=["dense", "sorted"])
@pytest.mark.parametrize("override", [
    {"optimizer": "adam"}, {"sgd_mode": "accum"},
], ids=["adam", "accum"])
def test_two_epochs_of_adam_and_accum_match_jax(monkeypatch, sort, override):
    """Both engines, two epochs from one state with pinned negatives, on
    the dense or (thresholds lowered in both packages) the sort-dedup
    path. Accum mode zeroes its gradient rows at each epoch's end. Its
    stored rows re-apply their summation-order noise at every later
    touch, so the share within rtol 1e-4 is 99% there (measured: 0.52% of
    item elements outside, at most 1.7e-5); the cap is the same."""
    if sort:
        monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    je, te = _engines(**override)
    jl, tl = _pinned_two_epochs(je, te)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[1] < tl[0]
    _assert_tables_close(te, je, share=0.99 if "sgd_mode" in override else 0.995)
    assert int(te.state.step) == int(je.state.step)
    if "sgd_mode" in override:
        assert not te.state.user_gacc.any() and not te.state.item_gacc.any()
    else:
        slots = te.state.opt_slots
        assert set(slots) == set(je.state.opt_slots)
        for k, v in slots.items():  # moments: gradient units, clip-bounded
            diff = np.abs(v.numpy() - np.asarray(je.state.opt_slots[k]))
            assert diff.max() <= 1e-2 * CLIP ** (2 if k.endswith("_v") else 1), k


@pytest.mark.parametrize("override", [
    {"optimizer": "adagrad"}, {"optimizer": "adam"}, {"sgd_mode": "accum"},
    {"update_mode": "direct"}, {"l2_enabled": True},
])
def test_update_menu_settings_are_accepted(override):
    train, test = tsynthetic(20, 40, max_his=4, seed=1)
    eng = TEngine(CFConfig(max_his=4, **override), train, test, device="cpu")
    assert np.isfinite(eng.train_one_epoch())


@pytest.mark.parametrize("override", [
    {"neg_sampler": 1, "num_subepochs": 2},
    {"visit_order": "user", "num_subepochs": 4},
    {"num_subepochs": 2},
], ids=["override0", "override5", "override6"])
def test_subepoch_settings_are_accepted(override):
    """Sub-epochs are ported (ROADMAP item 11b): the settings that were
    refused as item 11 train, and the epoch visits every pair once."""
    train, test = tsynthetic(20, 40, max_his=4, seed=1)
    eng = TEngine(CFConfig(max_his=4, **override), train, test, device="cpu")
    assert np.isfinite(eng.train_one_epoch())
    assert int(eng.sampler_state.iterations) == train.train_size


@pytest.mark.parametrize("override", [
    {"his_refresh": "subepoch", "aggregator": "user_attention"},
    {"aggregator": "self_attention"},
    {"aggregator": "user_attention"},
    {"param_dtype": "bfloat16", "aggregator": "self_attention"},
], ids=[f"override{i}" for i in (1, 2, 3, 7)])
def test_attention_settings_are_accepted(override):
    """The attention aggregators are ported (ROADMAP item 12): the settings
    that were refused as item 12 train a finite epoch that visits every
    pair once, and self-attention's query moves."""
    train, test = tsynthetic(20, 40, max_his=4, seed=1)
    eng = TEngine(CFConfig(max_his=4, **override), train, test, device="cpu")
    q0 = None if eng.state.attn_q is None else eng.state.attn_q.clone()
    assert np.isfinite(eng.train_one_epoch())
    assert int(eng.sampler_state.iterations) == train.train_size
    assert (q0 is None) == (override["aggregator"] == "user_attention")
    if q0 is not None:
        assert not torch.equal(eng.state.attn_q, q0)


@pytest.mark.parametrize("override,where", [
    # The tile sampler, cached pools, bf16, visit orders, sub-epochs and the
    # attention aggregators are ported; emb_pad stays refused beside them.
    ({"compute_dtype": "bfloat16", "emb_pad": 128}, "do-not-port"),
    ({"emb_pad": 128}, "do-not-port"),
    ({"visit_order": "item", "emb_pad": 256}, "do-not-port"),
], ids=[f"override{i}" for i in (4, 8, 9)])
def test_off_slice_settings_are_refused(override, where):
    train, test = tsynthetic(20, 40, max_his=4, seed=1)
    cfg = CFConfig(max_his=4, **override)
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        TEngine(cfg, train, test, device="cpu")
    assert where in str(err.value)


def test_mesh_is_refused():
    train, test = tsynthetic(20, 40, max_his=4, seed=1)
    with pytest.raises(NotImplementedError, match="item 15"):
        TEngine(CFConfig(max_his=4), train, test, device="cpu", mesh=object())


def test_cuda_device_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    train, test = tsynthetic(20, 40, max_his=4, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(CFConfig(max_his=4), train, test, device="cuda")


def test_package_imports_no_jax():
    code = (
        "import sys, heat_tpu_torch, heat_tpu_torch.main, "
        "heat_tpu_torch.serving, heat_tpu_torch.export, "
        "heat_tpu_torch.ops.cuda.topk, heat_tpu_torch.bench_large, "
        "heat_tpu_torch.profile_exact_ceiling, heat_tpu_torch.train.run, "
        "heat_tpu_torch.checkpoint, heat_tpu_torch.utils, "
        "heat_tpu_torch.utils.logging, heat_tpu_torch.utils.profiling, "
        "heat_tpu_torch.native, heat_tpu_torch.parity; "
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'heat_tpu.')) or m == 'heat_tpu']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
