"""``chip_smoke.py``'s failure line: on any exception ``main`` prints, as its
last line of standard output, which phase failed and why, and names a job
that failed beside the main phases; then it exits 1."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return module


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_failed_phase_is_named_with_its_error(smoke, monkeypatch, capsys):
    def run(walls):
        walls["build"] = 0.5
        walls["kernels"] = 9.25
        print("kernel gather_blocks: ...")
        raise AssertionError("S2 gather_blocks disagrees " + "x" * 1000)

    monkeypatch.setattr(smoke, "run", run)
    assert smoke.main() == 1
    failed = _last_line(capsys)["failed"]
    assert failed["phase"] == "kernels"
    assert failed["error"].startswith("AssertionError: S2 gather_blocks disagrees")
    assert len(failed["error"]) == smoke.ERROR_CHARS == 500
    assert failed["phase_start_s"] == {"build": 0.5, "kernels": 9.25}
    assert "beside" not in failed


def test_a_failure_before_the_first_phase_and_a_job_beside(smoke, monkeypatch, capsys):
    def broken_job():
        raise RuntimeError("rank 2 exited with code 1")

    def run(walls):
        job = smoke.start_beside(broken_job)
        job[0].join()
        smoke.start_beside(lambda: None)[0].join()
        raise ImportError("No module named 'heat_tpu_torch'")

    monkeypatch.setattr(smoke, "run", run)
    assert smoke.main() == 1
    failed = _last_line(capsys)["failed"]
    assert failed["phase"] == "setup" and failed["phase_start_s"] == {}
    assert failed["error"] == "ImportError: No module named 'heat_tpu_torch'"
    assert failed["beside"] == {"broken_job": "RuntimeError: rank 2 exited with code 1"}


def test_no_line_without_a_card(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "run", lambda walls: pytest.fail("ran without a card"))
    assert smoke.main() == 1
    assert capsys.readouterr().out == ""


def _runner():
    spec = importlib.util.spec_from_file_location("spread_runner",
                                                  ROOT / "spread_runner.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fused_cli_spread_summarizes_with_the_checks_own_ratio(smoke, tmp_path):
    """``spread_runner.py --summarize``: its ratio is (l)'s, each
    quantity's (``held_to_spread``), and a fused run far off the plain
    runs fails the rule against every set of them, in its own repetition
    and as a check."""
    import numpy as np

    fcs = _runner()
    rng = np.random.default_rng(0)
    keys = ["epoch 0 loss", "epoch 1 loss", "Recall(k=20)"]

    def run():
        return {k: 1.0 + 1e-4 * float(rng.normal()) for k in keys}

    plain = [run() for _ in range(20)]
    near, far = run(), {k: 1.01 for k in keys}
    held = smoke.held_to_spread("near", near, plain)
    d2 = fcs._scalar_d2(plain + [near], keys)
    for k in keys:
        assert fcs.ratio(d2[k], 20, range(20)) == pytest.approx(
            held[k]["ratio"], rel=1e-12)
    rep = {"plain": plain, "fused": {"fused_epochs_2": near, "fused_run": far},
           "faulted": {"0.01": far}}
    path = tmp_path / "jobs.jsonl"
    path.write_text(json.dumps({"name": "a", "check": "l", "runs": [rep]}) + "\n")
    got = fcs.summarize(path)["l a"]
    assert (got["reps"], got["plain_runs"], got["n"]) == (
        1, 20, smoke.FUSED_CLI_PLAIN)
    assert got["limit"] == smoke.spread_limit(smoke.FUSED_CLI_PLAIN)
    assert got["p_check_flags"] == 1
    for name, entry in (("fused_run", got["fused"]["fused_run"]),
                        ("0.01", got["faulted"]["0.01"])):
        assert entry["p_flags"] == 1
        assert got["per_rep"][0][name]["flags"]
        assert entry["max_ratio"]["median"] > got["limit"]


def test_the_runner_summarizes_the_sync_cost(tmp_path):
    """``spread_runner.py --summarize`` of ``--check breakdown`` jobs: each
    shape's paired costs pooled over the jobs' rounds, their median, the
    share over the job's bound and the sign test's chance of failing; the
    planted delay's; the phase sums and ``check_trace``'s ratios against
    their bounds."""
    def reading(withs, withouts, faults):
        times = {"with": withs, "without": withouts, "fault": faults}
        return {"times_s": times, **{arm: {"costs": [
            w / wo - 1 for w, wo in zip(times[arm], withouts)]}
            for arm in ("with", "fault")}}

    base = [0.17 + 0.001 * k for k in range(20)]
    costs = {
        "config0": [reading([b * 1.002 for b in base], base,
                            [b * 1.02 for b in base])],
        "default shape": [reading([b * (1.012 if k % 4 == 0 else 1.0)
                                   for k, b in enumerate(base)], base,
                                  [b * 1.03 for b in base])]}
    path = tmp_path / "jobs.jsonl"
    path.write_text(json.dumps({
        "name": "a", "check": "breakdown", "sync_cost": 0.01, "costs": costs,
        "phase_sums": [{"off": -0.01}, {"off": 0.02}],
        "trace_ratios": [{"ratio": 0.97}, {"ratio": 1.01}]}) + "\n")
    got = _runner().summarize(path)["breakdown a"]
    assert got["bound"] == 0.01 and got["jobs"] == 1
    c0 = got["config0"]
    assert c0["rounds"] == 20
    assert c0["with"]["median"] == pytest.approx(0.002)
    assert c0["with"]["share_over"] == 0 and c0["with"]["p_fail_resampled"] == 0
    assert c0["fault"]["share_over"] == 1
    assert c0["fault"]["p_fail_binomial"] == pytest.approx(1.0)
    ds = got["default shape"]["with"]
    assert ds["share_over"] == pytest.approx(0.25)
    assert ds["p_fail_binomial"] < 1e-6
    assert got["phase_sum_off"] == {"n": 2, "min": -0.01, "max": 0.02,
                                    "band": 0.05}
    assert got["trace_ratio"]["max"] == 1.01


# The rule of every spread check (``held_to_spread``), on seeded Gaussian
# draws shaped like (l)'s: five quantities (three epoch losses, two
# metrics) whose run-to-run noise differs by four orders of magnitude.
SCALES = [1e-2, 1e-3, 1e-4, 1e-5, 1e-6]
MEANS = [2.2, 0.9, 0.7, 0.14, 0.2]


def _draws(rng, trials, runs):
    import numpy as np

    return np.asarray(MEANS) + rng.normal(size=(trials, runs, len(SCALES))) * SCALES


def _ratios(x, y):
    """Each quantity's ratio of ``y`` (trials, Q) against the oracles ``x``
    (trials, n, Q): ``held_to_spread``'s, by its closed form."""
    import numpy as np

    n = x.shape[1]
    s2 = x.var(axis=1, ddof=1)  # mean over pairs of (x_i - x_j)^2 is twice this
    d2 = (y - x.mean(axis=1)) ** 2 + (n - 1) / n * s2
    return np.sqrt(d2 / (2 * s2))


def _old_ratios(x, y):
    """The rule of old: one rms over all of a run's numbers."""
    import numpy as np

    n = x.shape[1]
    s2 = x.var(axis=1, ddof=1).sum(axis=-1)
    d2 = ((y - x.mean(axis=1)) ** 2).sum(axis=-1) + (n - 1) / n * s2
    return np.sqrt(d2 / (2 * s2))


def test_t_tail_and_the_limit(smoke):
    """``t_tail`` is Student's two-sided tail (scipy's), and
    ``spread_limit(n)`` puts one Gaussian scalar's t at the share of the
    false-alarm target that one comparison takes (SPREAD_ALPHA)."""
    from scipy import stats

    for df in (1, 2, 3, 4, 9, 19):
        for t in (0.3, 2.0, 7.5):
            assert smoke.t_tail(t, df) == pytest.approx(
                2 * stats.t.sf(t, df), rel=1e-9, abs=1e-15)
    alpha = smoke.SPREAD_ALPHA
    for n in (2, 3, 5, 20):
        r = smoke.spread_limit(n)
        t = ((2 * n * r * r - (n - 1)) / (n + 1)) ** 0.5
        assert 2 * stats.t.sf(t, n - 1) == pytest.approx(alpha, rel=1e-6)
    assert smoke.spread_limit(5) == pytest.approx(12.057, abs=1e-3)
    assert smoke.spread_limit(20) == pytest.approx(3.615, abs=1e-3)


def test_the_closed_form_is_held_to_spread(smoke):
    """The vectorized ratio the tests below use is ``held_to_spread``'s, on
    a dict of quantities (each on its own) and on one vector."""
    import numpy as np

    rng = np.random.default_rng(1)
    x, y = _draws(rng, 3, 20), _draws(rng, 3, 1)[:, 0]
    want = _ratios(x, y)
    for t in range(3):
        keys = [f"q{q}" for q in range(len(SCALES))]
        held = smoke.held_to_spread(
            "draw", dict(zip(keys, y[t].tolist())),
            [dict(zip(keys, row.tolist())) for row in x[t]])
        for q, key in enumerate(keys):
            assert held[key]["ratio"] == pytest.approx(want[t, q], rel=1e-9)
            assert held[key]["limit"] == smoke.spread_limit(20)
    big = np.full(5, 1.0)
    with pytest.raises(AssertionError, match="q4"):
        smoke.held_to_spread("far", dict(zip(keys, (y[0] + 1e-3 * big).tolist())),
                             [dict(zip(keys, row.tolist())) for row in x[0]])


def test_the_rule_holds_its_false_alarm_target(smoke):
    """Null draws, (l)'s shape: FUSED_CLI_PLAIN plain runs and one more run
    of the same law, 5 x 10^5 times. Each quantity fails
    ``spread_limit(n)`` at SPREAD_ALPHA (the limit is exact for a Gaussian
    scalar): within 30% of it; and a whole run of the most quantities
    :func:`check_spread_count` lets through within 30% of
    SPREAD_FALSE_ALARM."""
    import numpy as np

    rng = np.random.default_rng(2)
    n, limit = smoke.FUSED_CLI_PLAIN, smoke.spread_limit(smoke.FUSED_CLI_PLAIN)
    fails = comparisons = 0
    for _ in range(10):
        x, y = _draws(rng, 50_000, n), _draws(rng, 50_000, 1)[:, 0]
        r = _ratios(x, y)
        fails += int((r > limit).sum())
        comparisons += r.size
    alpha = smoke.SPREAD_ALPHA
    assert 0.7 * alpha <= fails / comparisons <= 1.3 * alpha
    most = round(smoke.SPREAD_FALSE_ALARM / smoke.SPREAD_ALPHA)
    assert most * fails / comparisons <= 1.3 * smoke.SPREAD_FALSE_ALARM


def test_the_old_rule_failed_one_check_in_seven(smoke):
    """The same draws under the rule of old, as (l) ran it: five plain runs,
    two fused runs, one rms over all five numbers within 2x: the noisiest
    quantity sets the yardstick, and one (l) check in seven or eight fails
    (the two fused runs share their plain runs; on the card 0.069-0.085
    a fused run, PERF.md §6). The new
    rule, with its limit at five oracles, on the same draws: about one in
    2,000."""
    import numpy as np

    rng = np.random.default_rng(3)
    x = _draws(rng, 40_000, 5)
    fused = [_draws(rng, 40_000, 1)[:, 0] for _ in range(2)]
    old = np.zeros(40_000, bool)
    new = np.zeros(40_000, bool)
    for y in fused:
        old |= _old_ratios(x, y) > 2.0
        new |= (_ratios(x, y) > smoke.spread_limit(5)).any(axis=1)
    assert 0.10 <= old.mean() <= 0.15
    assert new.mean() <= 0.002


@pytest.mark.parametrize("sds,new_least,new_most", [
    (1, 0.0, 0.001), (3, 0.0, 0.01), (10, 0.05, 0.3), (30, 0.95, 1.0),
    (100, 0.999, 1.0)])
def test_a_planted_offset_in_one_quantity(smoke, sds, new_least, new_most):
    """An offset of ``sds`` of its own noise's sd in the quietest quantity
    alone (1e-6, beside a 1e-2 neighbour), 10^4 draws of (l)'s
    FUSED_CLI_PLAIN plain runs: the new rule catches 30 and 100 sd
    (nearly) every time, 10 sd now and then, 1 and 3 sd not; the rule of
    old (one rms, 2x) misses even 100 sd, which the noisiest quantity
    drowns: it flags at its false-alarm rate."""
    import numpy as np

    rng = np.random.default_rng(4 + sds)
    n = smoke.FUSED_CLI_PLAIN
    x, y = _draws(rng, 10_000, n), _draws(rng, 10_000, 1)[:, 0]
    y[:, -1] += sds * SCALES[-1]
    caught = (_ratios(x, y) > smoke.spread_limit(n)).any(axis=1).mean()
    old = (_old_ratios(x, y) > 2.0).mean()
    assert new_least <= caught <= new_most
    assert old <= 0.1


def test_a_run_may_hold_no_more_quantities_than_counted(smoke, capsys):
    """A whole run may hold at most SPREAD_FALSE_ALARM / SPREAD_ALPHA
    quantities: ``check_spread_count`` fails a run that held more."""
    most = round(smoke.SPREAD_FALSE_ALARM / smoke.SPREAD_ALPHA)
    assert most == 100
    smoke.SPREAD_HELD[:] = ["q"] * most
    smoke.check_spread_count()
    assert json.loads(capsys.readouterr().out) == {"spread_held": most,
                                                  "spread_most": most}
    smoke.SPREAD_HELD.append("one more")
    with pytest.raises(AssertionError, match="more than"):
        smoke.check_spread_count()


def test_a_replay_that_lost_the_item_update_fails_the_rule(smoke, monkeypatch):
    """The replay phase's planted fault (``SkipItemUpdates``: the step a
    capture would record had it lost the item table's update) on the CPU
    at a small size, K3's atomics emulated by a last-bits noise on every
    update's gradients, drawn anew each run, and ``l_r`` 5e-4 for one
    epoch (at config0's 1e-2 this small a table is chaotic: the noise
    alone moves it as far as training does). Held to ORACLE_RUNS such
    runs (the replay's eager runs), a noisy run passes the rule and is no
    planted fault; the run without the item update is some hundreds of
    times their spread away in the item table: it fails the rule, and
    ``caught_by_spread`` counts it as caught. Against the two eager runs
    the replay phase held it to before, at ``spread_limit(2)``, it
    passed. The runs take one thread: on all of them, beside the suite's
    other workers, the engine's small ops waited on each other for
    minutes."""
    import contextlib

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.train import train_step
    from heat_tpu_torch.train.engine import Engine

    train, _ = synthetic_click_dataset(num_users=200, num_items=300,
                                       max_his=8, seed=0)
    cfg = load_config(str(ROOT / smoke.CONFIG0), batch_size=64, num_negs=4,
                      max_his=8, l_r=5e-4)[0]
    orig = {n: getattr(train_step, n) for n in smoke.SkipItemUpdates.NAMES}

    def run(seed, skip=False):
        gen = torch.Generator().manual_seed(seed)
        for name, fn in orig.items():
            def noisy(table, ids, grads, *a, fn=fn, **kw):
                grads = grads * (1 + 2.0 ** -20 * torch.randn(
                    grads.shape, generator=gen, dtype=grads.dtype))
                return fn(table, ids, grads, *a, **kw)
            monkeypatch.setattr(train_step, name, noisy)
        engine = Engine(cfg, train, device="cpu")
        with (smoke.SkipItemUpdates(engine.state.item_emb) if skip
              else contextlib.nullcontext()):
            engine.train_epochs(1)
        st = engine.state
        return {k: getattr(st, k).clone() for k in ("user_emb", "item_emb", "w0")}

    # One thread: a small engine on the test worker's share of the host.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        oracles = [run(seed) for seed in range(smoke.ORACLE_RUNS)]
        noisy, other, faulty = run(100), run(101), run(102, skip=True)
    finally:
        torch.set_num_threads(before)
    assert oracles[0]["item_emb"].ne(oracles[1]["item_emb"]).any()
    held = smoke.held_to_spread("noisy", noisy, oracles)
    assert all(q["ratio"] < 3 for q in held.values())
    with pytest.raises(AssertionError, match="passed the spread rule"):
        smoke.caught_by_spread("noisy", other, oracles)
    with pytest.raises(AssertionError, match="faulty item_emb"):
        smoke.held_to_spread("faulty", faulty, oracles)
    caught = smoke.caught_by_spread("faulty", faulty, oracles)
    assert 100 < caught["item_emb"]["ratio"] < smoke.spread_limit(2)
    two = smoke.spread_ratios(faulty, oracles[:2])
    assert not any(q["over"] for q in two.values())


# The phase timer's cost (``check_breakdown``): seeded epoch times shaped
# like the card's replayed epochs on an H100 (PERF.md §6), in units of the
# fastest epoch: a right-skewed host noise above the floor, exponential, of
# which a part is shared by the epochs of one round (they run back to
# back) and a part is each epoch's own, plus a little Gaussian jitter.
# (shared, own) scales: config0's noise is about ten times quieter than
# the default shape's, whose paired costs lie over 0.01 a quarter of the
# time with the marks and 0.83-0.86 of the time with the planted delay.
EPOCH_NOISE = {"config0": (0.001, 0.002), "default shape": (0.025, 0.01)}
MARK_COST = 0.0025  # the marks' paired cost the card read on config0


def _rounds(rng, noise, sets, rounds, costs):
    """One (sets, rounds) array of epoch times for each of ``costs`` (an
    arm's cost), the arms of a round sharing that round's part of the
    noise: 1 + cost + the noise."""
    shared, own = noise
    common = rng.exponential(shared, (sets, rounds))
    return [1.0 + cost + common + rng.exponential(own, (sets, rounds))
            + rng.normal(0.0, 2e-4, (sets, rounds)) for cost in costs]


def _sign_fails(smoke, with_s, without_s):
    """The sign test of ``check_breakdown`` on each set (row) of rounds."""
    over = (with_s / without_s - 1.0 > smoke.SYNC_COST).sum(axis=1)
    return over >= smoke.sign_test_count(with_s.shape[1])


def test_the_sign_test_fails_by_chance_within_its_share(smoke):
    """The count at which the sign test fails holds P(Binomial(n, 1/2) >= k)
    at SYNC_ALPHA or under, so a shape whose median paired cost is at the
    bound fails at most that often, whatever its noise; on draws shaped
    like both shapes' with the marks' measured cost, none of 20,000
    checks fails. The median's interval is the order statistics the
    binomial gives."""
    import math

    import numpy as np

    n, k = smoke.SYNC_PAIRS, smoke.sign_test_count(smoke.SYNC_PAIRS)
    tail = lambda j: sum(math.comb(n, i) for i in range(j, n + 1)) / 2 ** n  # noqa: E731
    assert (n, k) == (40, 32)
    assert tail(k) <= smoke.SYNC_ALPHA < tail(k - 1)
    assert smoke.sign_test_count(12) == 13  # twelve rounds can never fail
    assert smoke.median_interval(list(range(40))) == (11, 28)
    rng = np.random.default_rng(20)
    for noise in EPOCH_NOISE.values():
        without, marks = _rounds(rng, noise, 20_000, n, (0.0, MARK_COST))
        assert not _sign_fails(smoke, marks, without).any()


def test_the_sign_test_catches_the_planted_delay(smoke):
    """SYNC_FAULT of an epoch held back in the data phase, on config0's
    draws: every one of 2,000 checks fails. On the default shape's the
    same delay is caught only some of the time (the card read 0.79-0.90),
    which is why the script plants it on config0 alone; a cost of three
    times the bound is caught there too."""
    import numpy as np

    rng = np.random.default_rng(21)
    n = smoke.SYNC_PAIRS
    for shape, least in (("config0", 1.0), ("default shape", 0.5)):
        without, fault, big = _rounds(
            rng, EPOCH_NOISE[shape], 2_000, n,
            (0.0, MARK_COST + smoke.SYNC_FAULT, MARK_COST + 3 * smoke.SYNC_COST))
        caught = _sign_fails(smoke, fault, without).mean()
        assert caught >= least
        assert _sign_fails(smoke, big, without).mean() >= 0.95
        if shape == "default shape":
            assert caught < 1.0


def test_the_min_ratio_rule_failed_the_default_shape_by_chance(smoke):
    """The rule the sign test replaced, the fastest of 12 epochs with the
    marks over the fastest of 12 without, less 1, at most SYNC_COST: on
    the default shape's draws with the marks' measured cost it fails a few
    checks in a hundred (the card: 1 of 8 readings, and 0.005-0.07 of
    resampled sets of its rounds), on config0's none; the sign test on the
    same rounds, none."""
    import numpy as np

    rng = np.random.default_rng(22)
    for shape, lo, hi in (("config0", 0.0, 0.0), ("default shape", 0.02, 0.25)):
        without, marks = _rounds(rng, EPOCH_NOISE[shape], 20_000, 12,
                                 (0.0, MARK_COST))
        old = (marks.min(axis=1) / without.min(axis=1) - 1.0 > smoke.SYNC_COST).mean()
        assert lo <= old <= hi
        assert not _sign_fails(smoke, marks, without).any()


def test_the_runner_summarizes_the_gates(tmp_path):
    """``spread_runner.py --summarize`` of ``--check gates`` jobs: a run's
    mean gap and run-to-run sd a metric, the readings out of band, the
    normal fit's chance of leaving the band, and the least number of runs
    whose mean stays within GATE_SHARE: 1 far from the edge, more where
    one run's noise reaches it."""
    def run(name, k, recall, ndcg, band):
        return {"run": name, "rep": k, "band": band, "wall_s": 8.0,
                "gap": {"Recall(k=20)": recall, "NDCG(k=50)": ndcg}}

    quiet = [run("quiet", k, 4e-5 + 1e-6 * k, -6e-5, 3e-4) for k in range(8)]
    noisy = [run("noisy", k, 0.0, 2e-4 * (-1) ** k, 5e-4) for k in range(8)]
    path = tmp_path / "jobs.jsonl"
    path.write_text(json.dumps({"name": "a", "check": "gates",
                                "runs": quiet + noisy}) + "\n")
    got = _runner().summarize(path)["gates a"]
    q, n = got["quiet"], got["noisy"]
    assert q["n"] == 8 and q["m_needed"] == 1 and q["p_fail_fit"] < 1e-12
    assert q["metrics"]["Recall(k=20)"]["mean"] == pytest.approx(4.35e-5)
    assert n["metrics"]["NDCG(k=50)"]["out_of_band"] == 0
    assert n["p_fail_fit"] > got["share"] and n["m_needed"] > 1


def test_the_runner_reads_the_phase_hand_over_from_a_trace():
    """The device's idle gap where ``data`` hands over to ``f_b``, the
    host's time from its last wait in ``data`` to its first launch in
    ``f_b``, the launch's latency and the epoch's idle time, from a Chrome
    trace's events (a runtime call and its kernel share a correlation
    id)."""
    def x(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("epoch:True", "user_annotation", 0, 1000),
        x("phase:data", "user_annotation", 10, 300),
        x("cudaLaunchKernel", "cuda_runtime", 20, 5, 1),
        x("k1", "kernel", 30, 100, 1),
        x("cudaDeviceSynchronize", "cuda_runtime", 200, 100),
        x("phase:f_b", "user_annotation", 320, 600),
        x("aten::fill_", "cpu_op", 330, 20),
        x("cudaGraphLaunch", "cuda_runtime", 400, 10, 2),
        x("k2", "kernel", 420, 400, 2)]
    (got,) = _runner()._phase_gaps(events)
    assert got["marks"] and got["gap_us"] == 290
    assert got["wait_to_launch_us"] == 100 and got["launch_to_start_us"] == 20
    assert got["idle_ms"] == pytest.approx(0.5)
    assert got["host_ops_in_gap_us"] == {"aten::fill_": 20.0}
    assert got["waits_in_data"] == ["cudaDeviceSynchronize"]


def test_a_gate_holds_the_mean_of_its_runs(smoke, monkeypatch):
    """``check_gated_runs`` trains each run of GATE_MEAN_OF that many times,
    each held to the run checks, and hands the gate the mean of their final
    metrics; a run not in it trains once."""
    import itertools

    counter = itertools.count()

    class Cli:
        def main(self, argv):
            k = next(counter)
            return {"final_metrics": {"Recall(k=20)": 1e-3 + 1e-5 * k,
                                      "NDCG(k=50)": 2e-3}}

    reads = itertools.count()
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    checked = []
    out = smoke.check_gated_runs(
        Cli(), lambda: None,
        lambda: {"history_mean_gather_bf16": 5 if next(reads) == 0 else 10},
        lambda name, *a, **kw: checked.append(name))
    m = smoke.GATE_MEAN_OF["complement"]
    assert checked == ["headline_ccl"] + ["complement"] * m
    got = out["complement"]
    assert len(got["final_metrics_runs"]) == m
    assert got["final_metrics"]["Recall(k=20)"] == pytest.approx(
        1e-3 + 1e-5 * (1 + m) / 2)
    assert "final_metrics_runs" not in out["headline_ccl"]


def test_the_breakdown_is_read_off_a_cli_run(smoke):
    """``breakdown_of`` on what a CLI run with ``--breakdown`` printed (here
    on the CPU, at a tiny size): the three phases, their sum within
    PHASE_SUM_BAND of the run's epochs and evaluations."""
    from heat_tpu_torch import main as cli

    record, text = smoke.run_cli(cli, [
        "--config", smoke.CONFIG0, "--synthetic", "200,400", "--epochs", "3",
        "--device", "cpu", "--breakdown"])
    got = smoke.breakdown_of(record, text)
    assert set(got["phases_s"]) == {"data", "f_b", "eval"}
    assert abs(got["off"]) <= smoke.PHASE_SUM_BAND
    assert got["run_wall_s"] > 0
