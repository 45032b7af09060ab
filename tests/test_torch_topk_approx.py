"""Approximate top-k (``exact=False``, ``recall_target``) in the port against
the JAX package on the CPU.

The JAX package's ``exact=False`` is ``jax.lax.approx_max_k``, which
approximates only on a TPU and elsewhere sorts and slices
(``jax/_src/lax/ann.py``); the port selects as its exact path does (the
two-phase top-k through K4 from ``_TOPK_2PHASE_MIN_ITEMS`` columns up).
Both are exact selections here, so each route is held to
the JAX package's at ``exact=False`` on the same seeded numpy inputs: ids
tie-aware (``assert_same_topk``), scores within 1e-6, metrics within 1e-6.
A ``recall_target`` outside (0, 1] raises where ``approx_max_k`` raises.
"""

import json

import numpy as np
import pytest
import torch

import heat_tpu.evaluation.evaluator as jev
import heat_tpu.serving as jserving
import heat_tpu_torch.evaluation.evaluator as tev
import heat_tpu_torch.serving as tserving
from heat_tpu_torch import main as tmain
from heat_tpu_torch.train.engine import Engine as TEngine
from test_torch_engine import METRICS, _engines
from test_torch_serving import (  # noqa: F401 (model: a fixture)
    NEG,
    UIDS,
    _recommenders,
    _tied_scores,
    assert_same_topk,
    model,
)

RECALL = 0.95
CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
TINY = ["--config", CONFIG0, "--synthetic", "200,400", "--epochs", "3"]


def _counted_extracts(monkeypatch) -> list:
    """Watch K4 (``window_extract``) in the evaluator: the calls' shapes."""
    calls, extract = [], tev.window_extract

    def counted(sim, widx, w):
        calls.append(tuple(sim.shape))
        return extract(sim, widx, w)

    monkeypatch.setattr(tev, "window_extract", counted)
    return calls


@pytest.mark.parametrize("n", [640, 4608])  # below / above two-phase
@pytest.mark.parametrize("with_bits", [True, False], ids=["bits", "no_bits"])
def test_masked_topk_approximate_matches_jax(monkeypatch, n, with_bits):
    """At both widths ``exact=False`` takes the exact path (the two-phase
    top-k and K4 above ``_TOPK_2PHASE_MIN_ITEMS``), equal to the JAX
    package's ``approx_max_k`` fallback: scores within 1e-6, ids
    tie-aware, and the exact path's scores and ids."""
    rng = np.random.default_rng(1)
    rows, k = 10, 15
    sim = _tied_scores(rng, rows, n)
    bits = None
    masked = sim
    if with_bits:
        bits = rng.integers(0, 2**32, (rows, n // 32), dtype=np.uint32)
        bits &= rng.integers(0, 2**32, (rows, n // 32), dtype=np.uint32)
        masked = np.where(
            np.unpackbits(bits.view(np.uint8), axis=1, bitorder="little")
            .astype(bool), NEG, sim)
    tbits = None if bits is None else torch.from_numpy(bits.view(np.int32))
    calls = _counted_extracts(monkeypatch)
    two_phase = [(rows, n)] if n >= tev._TOPK_2PHASE_MIN_ITEMS else []
    js, jids = jev.masked_topk(sim, bits, k + 1, exact=False,
                               recall_target=RECALL)
    ts, tids = tev.masked_topk(torch.from_numpy(sim), tbits, k + 1,
                               exact=False, recall_target=RECALL)
    assert calls == two_phase and tids.dtype == torch.int64
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), -np.sort(-masked, 1)[:, : k + 1])
    assert_same_topk(tids.numpy(), np.asarray(jids), masked.astype(np.float64),
                     k, min_strict=0.5)
    es, eids = tev.masked_topk(torch.from_numpy(sim), tbits, k + 1)
    assert calls == two_phase * 2
    np.testing.assert_array_equal(ts.numpy(), es.numpy())
    np.testing.assert_array_equal(tids.numpy(), eids.numpy())


@pytest.mark.parametrize("budget", [None, 16], ids=["bitmask", "scatter_mask"])
def test_tiled_evaluator_approximate_matches_jax(model, monkeypatch, budget):
    """``TiledEvaluator.topk(exact=False)`` with the packed bitmask and,
    above ``MASK_BITS_MAX_BYTES``, the per-tile scatter mask: equal to the
    JAX evaluator's at ``exact=False`` and to the port's exact path (K4
    once a tile in both), no seen or pad id served; ``topk_scores``
    threads the flag."""
    if budget is not None:
        monkeypatch.setattr(jev, "MASK_BITS_MAX_BYTES", budget)
        monkeypatch.setattr(tev, "MASK_BITS_MAX_BYTES", budget)
    u, n_items, k = 300, 4500, 20
    j = jev.TiledEvaluator(model["seen"], u, user_tile=128, num_items=n_items)
    t = tev.TiledEvaluator(model["seen"], u, user_tile=128, num_items=n_items,
                           device="cpu")
    assert (t.mask_bits is None) == (budget is not None)
    user, item = torch.from_numpy(model["user"]), torch.from_numpy(model["item"])
    js, jids = j.topk(model["user"], model["item"], k + 1, exact=False,
                      recall_target=RECALL, return_scores=True)
    calls = _counted_extracts(monkeypatch)
    ts, tids = t.topk(user, item, k + 1, exact=False, recall_target=RECALL,
                      return_scores=True)
    assert len(calls) == t.num_tiles and tids.dtype == torch.int32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert_same_topk(tids.numpy(), np.asarray(jids), model["scores"], k)
    _, eids = t.topk(user, item, k + 1)
    assert len(calls) == 2 * t.num_tiles
    assert torch.equal(tids, eids)
    assert tids.max() < n_items
    seen = {tuple(p) for p in model["seen"].tolist()}
    assert not any((r, int(i)) in seen for r in range(u) for i in tids[r])
    ss, sids = tev.topk_scores(user, item, k + 1, train_pairs=model["seen"],
                               exact=False, recall_target=RECALL)
    np.testing.assert_allclose(ss, ts.numpy(), rtol=0, atol=1e-6)
    assert_same_topk(sids, tids.numpy(), model["scores"], k)


def _route(monkeypatch, route):
    """Thresholds set, in both packages, so that a 4500-item model takes
    ``route`` (as ``tests/test_torch_serving.py`` reaches them)."""
    if route != "one_shot":
        for mod in (jserving, tserving):
            monkeypatch.setattr(mod, "_CHUNKED_REQUEST_MIN_ITEMS",
                                64 if route != "whole_table" else 1 << 30)
            monkeypatch.setattr(mod, "_REQUEST_PAD_MULTIPLE", 4096)
    if route in ("retrieve", "whole_table"):
        monkeypatch.setattr(jev, "MASK_BITS_MAX_BYTES", 16)
        monkeypatch.setattr(tev, "MASK_BITS_MAX_BYTES", 16)


@pytest.mark.parametrize("route", ["one_shot", "chunked", "retrieve", "whole_table"])
def test_recommend_approximate_on_every_route_matches_jax(model, monkeypatch, route):
    """``recommend(exact=False)`` on the one-shot, chunked (each chunk's
    selection and the running merge) and retrieve-and-filter routes, and
    the whole-table fallback, which stays exact in both packages: ids
    tie-aware equal to the JAX package's and equal to the port's exact
    request, unseen and never a pad id. A target out of range raises on
    the three routes and not on the fallback, in both packages."""
    _route(monkeypatch, route)
    j, t = _recommenders(model, seen_pairs=model["seen"])
    assert t._chunked_request == (route in ("chunked", "retrieve"))
    assert (t._bits_flat is None) == (route in ("retrieve", "whole_table"))
    scores = model["scores"][UIDS]
    got = t.recommend(UIDS, 21, exact=False, recall_target=RECALL)
    want = j.recommend(UIDS, 21, exact=False, recall_target=RECALL)
    assert got.dtype == np.int32 and got.shape == (10, 21)
    assert_same_topk(got, want, scores, 20)
    np.testing.assert_array_equal(got, t.recommend(UIDS, 21))
    assert got.max() < 4500
    seen = {tuple(p) for p in model["seen"].tolist()}
    assert not any((u, int(i)) in seen for u, row in zip(UIDS, got) for i in row)
    if route == "whole_table":
        j.recommend(UIDS, 21, exact=False, recall_target=0.0)
        t.recommend(UIDS, 21, exact=False, recall_target=0.0)
    else:
        with pytest.raises(Exception, match="recall_target out of range"):
            j.recommend(UIDS, 21, exact=False, recall_target=0.0)
        with pytest.raises(ValueError, match=r"recall_target must be in \(0, 1\]"):
            t.recommend(UIDS, 21, exact=False, recall_target=0.0)


@pytest.mark.parametrize("aggregate_users", [False, True], ids=["raw", "aggregated"])
def test_evaluate_approximate_matches_jax(aggregate_users):
    """``Engine.evaluate(exact=False)`` at the engine's default target
    (0.99) and at 0.95 on the same injected tables: every metric within
    1e-6 of the JAX engine's at ``exact=False`` and of the port's exact
    evaluation."""
    from heat_tpu_torch.models.state import state_from_numpy

    je, te = _engines()
    rng = np.random.default_rng(12)
    user = rng.normal(size=(80, 16)).astype(np.float32)
    item = rng.normal(size=(300, 16)).astype(np.float32)
    w0 = (np.eye(16) + 0.3 * rng.normal(size=(16, 16))).astype(np.float32)
    je.state = je.state.replace(user_emb=user, item_emb=item, w0=w0)
    te.state = state_from_numpy(user, item, w0, lr=0.05, step=0, device="cpu")
    exact = te.evaluate(aggregate_users=aggregate_users)
    for kw in ({}, {"recall_target": RECALL}):
        want = je.evaluate(aggregate_users=aggregate_users, exact=False, **kw)
        got = te.evaluate(aggregate_users=aggregate_users, exact=False, **kw)
        assert list(got) == METRICS
        for m in METRICS:
            assert abs(got[m] - want[m]) <= 1e-6, (kw, m, got[m], want[m])
            assert abs(got[m] - exact[m]) <= 1e-6, (kw, m, got[m], exact[m])


@pytest.mark.parametrize("recall_target, accepted", [
    (1.0, True), (1e-9, True), (0.0, False), (-0.1, False), (1.5, False),
    (float("inf"), False),
])
def test_recall_target_is_checked_where_jax_checks_it(model, recall_target, accepted):
    """``approx_max_k`` takes a target in (0, 1] and raises otherwise; the
    port's ``masked_topk``, ``TiledEvaluator.topk``, ``Engine.evaluate``
    and ``Recommender.recommend`` raise ``ValueError`` on the same values,
    and accept the same. The exact path ignores the target, in both."""
    sim = np.random.default_rng(3).normal(size=(4, 300)).astype(np.float32)
    calls = [
        lambda: jev.masked_topk(sim, None, 5, exact=False,
                                recall_target=recall_target),
        lambda: jev.TiledEvaluator(None, 4, num_items=300).topk(
            sim[:, :16], np.ones((300, 16), np.float32), 5, exact=False,
            recall_target=recall_target),
    ]
    _, te = _engines()
    _, t = _recommenders(model, seen_pairs=model["seen"])
    ev = tev.TiledEvaluator(None, 4, num_items=300, device="cpu")
    ports = [
        lambda: tev.masked_topk(torch.from_numpy(sim), None, 5, exact=False,
                                recall_target=recall_target),
        lambda: ev.topk(torch.from_numpy(sim[:, :16]), torch.ones(300, 16), 5,
                        exact=False, recall_target=recall_target),
        lambda: te.evaluate(exact=False, recall_target=recall_target),
        lambda: t.recommend(UIDS, 5, exact=False, recall_target=recall_target),
    ]
    for call in calls:
        if accepted:
            call()
        else:
            with pytest.raises(Exception, match="recall_target out of range"):
                call()
    for call in ports:
        if accepted:
            call()
        else:
            with pytest.raises(ValueError, match=r"recall_target must be in \(0, 1\]"):
                call()
    tev.masked_topk(torch.from_numpy(sim), None, 5, recall_target=recall_target)
    te.evaluate(recall_target=recall_target)


def _evaluate_calls(monkeypatch, cls) -> list:
    """Watch ``cls.evaluate``: the keyword arguments of every call."""
    calls, evaluate = [], cls.evaluate

    def watched(self, *args, **kw):
        calls.append(kw)
        return evaluate(self, *args, **kw)

    monkeypatch.setattr(cls, "evaluate", watched)
    return calls


def test_cli_eval_approx_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``--eval-approx 0.95``: the periodic evaluation runs with
    ``exact=False, recall_target=0.95`` and the final one exact, in both
    CLIs; the log's events, keys and epochs equal the JAX CLI's, and the
    printed ``[Metrics]`` lines equal those of the port's run without the
    flag (the same seed, and an exact selection either way)."""
    from heat_tpu import main as jmain
    from heat_tpu.train.engine import Engine as JEngine

    monkeypatch.setenv("HEAT_TPU_NO_COMPILATION_CACHE", "1")
    jcalls = _evaluate_calls(monkeypatch, JEngine)
    tcalls = _evaluate_calls(monkeypatch, TEngine)
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    approx = ["--eval-approx", "0.95"]
    jmain.main(TINY + approx + ["--log-file", str(jlog)])
    capsys.readouterr()
    record = tmain.main(TINY + approx + ["--device", "cpu", "--log-file", str(tlog)])
    printed = capsys.readouterr().out.splitlines()
    periodic = {"exact": False, "recall_target": 0.95}
    assert jcalls == [periodic, {}] and tcalls == [periodic, {}]
    with open(jlog) as f:
        want = [json.loads(line) for line in f]
    with open(tlog) as f:
        got = [json.loads(line) for line in f]
    assert [(e["event"], e["epoch"], list(e)) for e in got] == [
        (e["event"], e["epoch"], list(e)) for e in want]
    assert [e["event"] for e in got] == ["epoch"] * 3 + ["eval", "final_eval"]

    plain = tmain.main(TINY + ["--device", "cpu"])
    plain_printed = capsys.readouterr().out.splitlines()
    assert record["losses"] == plain["losses"]
    assert [ln for ln in printed if ln.startswith("[Metrics]")] == [
        ln for ln in plain_printed if ln.startswith("[Metrics]")]
    assert record["final_metrics"] == plain["final_metrics"]


@pytest.mark.parametrize("flags, message", [
    (["--eval-approx", "0"], "--eval-approx must be in (0, 1], got 0.0"),
    (["--eval-approx", "1.5"], "--eval-approx must be in (0, 1], got 1.5"),
    (["--eval-approx", "nan"], "--eval-approx must be in (0, 1], got nan"),
    (["--eval-approx", "0.9", "--fused-run"],
     "--fused-run is incompatible with --profile-dir and --eval-approx"),
], ids=["zero", "above_one", "nan", "fused_run"])
def test_cli_eval_approx_parser_errors_match_the_jax_cli(monkeypatch, capsys,
                                                         flags, message):
    """Both CLIs exit through ``parser.error`` (code 2) with the same
    message."""
    from heat_tpu import main as jmain

    monkeypatch.setenv("HEAT_TPU_NO_COMPILATION_CACHE", "1")
    for cli, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            cli.main(TINY + extra + flags)
        assert err.value.code == 2
        assert message in capsys.readouterr().err, cli.__name__
