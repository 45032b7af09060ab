"""``chip_smoke.py``'s chance checks alone and repeated: the spread checks
(l) and (i), the phase timer's cost in ``check_breakdown``, the phase sum,
``check_trace``'s ratio and the full-scale gate's runs; how often each
fails by chance, and whether a planted fault is caught (ROADMAP §3, F7,
F8 and F9).

    python spread_runner.py [--check l|i|breakdown|gates|mesh_gates]
        [--budget S] [--jobs N] [--job-timeout S] [--reps N]
        [--faults D,D,...] [--runs R] [--oracles N] [--pairs N]
        [--trace-epochs N] [--cli-runs N] [--profiles N] [--trace-dir DIR]
        [--mesh-reps RUN:N,...] [--device D]
        [--out FILE] NAME=CHECKOUT [NAME=CHECKOUT ...]
    python spread_runner.py --summarize FILE

Each job runs in a checkout of the repository with that checkout's own
``chip_smoke.py`` (its argv, constants and oracles) and rank programs; the
checkouts take turns (a, b, b, a, ...) until ``--budget`` seconds have
gone or ``--jobs`` jobs have run, and each job's line goes to ``--out``.
Needs the card unless ``--device cpu`` (which only (l) and (i) take).

``--check l`` (``check_mesh_sorted_gate``): the CLI on a (4, 1) mesh of
four gloo ranks, FUSED_CLI_PLAIN plain runs, the two fused runs
(``--fused-epochs 2``, ``--fused-run``) and, for each relative offset D of
``--faults``, a ``--fused-epochs 2`` run with ``l_r`` times 1 + D (a
planted fault), ``--reps`` times; each run's epoch losses and gated final
metrics (``chip_smoke.fused_cli_numbers``).

``--check i`` (``check_mesh_engine_slice``): ``--runs`` runs of the JAX
demo's "full" settings on a (2, 2) mesh (MESH_SLICE_ENGINE) in one job of
four gloo ranks and ``--oracles`` single-rank oracles of them
(``torch_mesh_support.train_oracle``, as ``held_to_oracles`` calls it);
for each quantity (step losses, both tables, ``w0``) the mean square of
the difference of every pair of runs. Beside them the pools probe: the
initial user-attention pools refreshed over all users, and a data shard
at a time as a (2, 2) rank refreshes them, and how many users' pools
differ.

``--check breakdown`` (``check_breakdown``), alone on the card as the
script takes it after its mesh phases: ``--reps`` readings of
``chip_smoke.sync_cost`` at ``--pairs`` rounds on config0 and on the
default shape (each round an epoch with the phase timer's device marks,
one without and one with the planted delay), a device trace of
``--trace-epochs`` epochs each way a shape (the data -> f_b hand-over,
kept gzipped in ``--trace-dir``), ``--cli-runs`` readings of the
``--breakdown`` phase sum, and ``--profiles`` readings of
``check_trace``'s ratio on config0's and the headline's engines.

``--check gates``: the single-card runs of ``chip_smoke.GATED_RUNS``
through the CLI at the script's schedule and seed, ``--reps`` times;
``--check mesh_gates``: the mesh's gated runs, ``--mesh-reps`` times each
(two (4, 1) CLI runs at a time, the sorted Engine runs in a job beside
them). Each run's final metrics and gaps to its JAX run, kept whether or
not they lie within the band.

``--summarize FILE`` reads such lines (no card) and prints, a checkout and
a check: for (l) and (i), ``chip_smoke.held_to_spread``'s verdicts (each
quantity on its own within ``spread_limit(n)``) on each repetition's own
oracles and on SETS random sets of oracles out of all the checkout's
(seeded), with the ratios' quantiles; for the phase timer, the paired
costs' quantiles, their median with its 99% interval, the sign test's
chance of failing (from the share over SYNC_COST, and resampled at
SYNC_PAIRS), the planted delay's, the replaced min-ratio rule resampled, the
trace's gaps, the phase sums and the trace ratios against their bounds;
for the gates, each run's mean gap, its run-to-run sd, the chance of
leaving the band (the readings' share, and a normal fit) and the least
number of runs whose mean fails at most GATE_SHARE.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

SETS = 3000  # random sets of oracle runs a run is held to
CHECKS = ("l", "i", "breakdown", "gates", "mesh_gates", "marks")
# --check mesh_gates: repetitions of each of the mesh's gated runs
MESH_REPS = ("full_mesh41:4,config0_sorted_mesh41:4,config0_mesh41:2,"
             "headline_mesh41:2,default_shape_mesh41:2,"
             "config0_self_attention_mesh41:2")


def _checkout():
    """The checkout at the working directory's ``chip_smoke`` and mesh
    support, imported from there."""
    root = Path.cwd()
    sys.path[:0] = [str(root), str(root / "tests")]
    import chip_smoke as cs
    import torch_mesh_support as mc

    return root, cs, mc


def _job_l(reps: int, device: str, faults: list) -> dict:
    """(l)'s CLI runs, ``reps`` times, in the checkout at the working
    directory."""
    root, cs, mc = _checkout()
    from heat_tpu_torch.config import load_config

    lr = load_config(cs.CONFIG0)[0].l_r
    argv = ["--config", cs.CONFIG0, "--synthetic", cs.FUSED_CLI_SYNTHETIC,
            "--epochs", "3", "--device", device]
    one = ([argv] * cs.FUSED_CLI_PLAIN
           + [argv + ["--fused-epochs", "2"], argv + ["--fused-run"]]
           + [argv + ["--fused-epochs", "2", "--set", f"l_r={lr * (1 + d)!r}"]
              for d in faults])
    t0 = time.perf_counter()
    clis = mc.spawn_ranks(mc.rank_clis, 4, one * reps, device=device,
                          timeout=cs.MESH_TIMEOUT)[0]
    out = {"check": "l", "tree": str(root), "reps": reps, "lr": lr,
           "wall_s": time.perf_counter() - t0, "runs": []}
    n = cs.FUSED_CLI_PLAIN
    for k in range(reps):
        group = [cs.fused_cli_numbers(c)
                 for c in clis[k * len(one):(k + 1) * len(one)]]
        out["runs"].append({
            "plain": group[:n],
            "fused": dict(zip(("fused_epochs_2", "fused_run"), group[n:n + 2])),
            "faulted": dict(zip(map(str, faults), group[n + 2:]))})
    return out


def _pairs_d2(values: list) -> list:
    """The mean square of a - b over the elements, for every pair of
    ``values`` (tensors of one shape), in f64: a symmetric matrix."""
    m = [[0.0] * len(values) for _ in values]
    for a, b in itertools.combinations(range(len(values)), 2):
        d = values[a].double() - values[b].double()
        m[a][b] = m[b][a] = float((d * d).mean())
    return m


def _pools_probe(cfg_kw: dict, data, dev, n_data: int = 2) -> dict:
    """The initial pools of ``cfg_kw``'s engine refreshed over all users
    and a data shard at a time: users whose pools differ, the largest
    difference."""
    import torch

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.aggregator import user_pools_impl
    from heat_tpu_torch.train.engine import Engine

    engine = Engine(CFConfig(**cfg_kw), data[0], device=dev)
    st, his, masks = engine.state, engine.his_items, engine.his_masks
    kw = dict(user_emb=st.user_emb, attn_q=st.attn_q,
              aggregator=engine.cfg.aggregator)
    whole = user_pools_impl(st.item_emb, his, masks, **kw)
    parts = torch.empty_like(whole)
    rows = his.shape[0] // n_data
    for lo in range(0, his.shape[0], rows):
        sl = slice(lo, lo + rows)
        user_pools_impl(st.item_emb, his[sl], masks[sl], out=parts[sl],
                        **dict(kw, user_emb=st.user_emb[sl]))
    diff = (whole.double() - parts.double()).abs()
    return {"users": int(his.shape[0]), "users_differ": int((diff.amax(1) > 0).sum()),
            "max_abs": float(diff.max())}


def _job_i(runs: int, oracles: int, device: str) -> dict:
    """(i)'s "full" (2, 2) runs and their oracles in the checkout at the
    working directory."""
    import torch

    root, cs, mc = _checkout()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    sets = cs.MESH_SLICE_ENGINE["full"][0]
    t0 = time.perf_counter()
    job, wall, data_kw, data = cs.mesh_engine_job(
        dev, "i", {f"full_{k}": sets for k in range(runs)})
    heads = [head for _, head in job.values()]
    cfg_kw = next(iter(job.values()))[0]
    t1 = time.perf_counter()
    ors = [mc.train_oracle(2, data_kw, cfg_kw, 1, dev.type, data=data,
                           step_losses=cs.MESH_STEPS, n_model=2, evaluate=False,
                           epoch_fraction=cs.MESH_EPOCH_FRACTION)
           for _ in range(oracles)]
    oracles_s = time.perf_counter() - t1
    d2 = {}
    for key in ("step_losses", "user_emb", "item_emb", "w0"):
        values = [torch.as_tensor(r["step_losses"] if key == "step_losses"
                                  else r["state"][key]).to(dev)
                  for r in heads + ors]
        d2[key] = _pairs_d2(values)
        del values
    return {"check": "i", "tree": str(root), "job_wall_s": wall,
            "oracles_s": oracles_s, "wall_s": time.perf_counter() - t0,
            "kinds": ["mesh"] * len(heads) + ["oracle"] * len(ors),
            "losses": [r["losses"] for r in heads + ors], "d2": d2,
            "pools_probe": _pools_probe(cfg_kw, data, dev)}


def _phase_trace(cs, dev, sets, train, test, epochs: int,
                 keep: Path = None) -> list:
    """A device trace of ``epochs`` replayed epochs with the phase timer's
    marks and as many without (after the capture), each phase labelled:
    per epoch, the device's idle gap where ``data`` hands over to
    ``f_b`` (the end of the last device work launched in ``data`` to the
    start of the first launched in ``f_b``), the host's time from the end
    of its last wait for the device in ``data`` (a sync or a blocking
    read) to its first launch in ``f_b``, the host operations in that
    time, and the device's idle time over the whole epoch. ``keep``: a
    file to write the trace's timed events into (gzipped JSON)."""
    import gzip
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.train.engine import Engine

    engine = Engine(load_config(cs.CONFIG0, **cs.overrides_of(sets))[0],
                    train, test, device=dev)
    engine.train_one_epoch()  # the capture
    phase = engine._phase

    @contextlib.contextmanager
    def labelled(name):
        with record_function(f"phase:{name}"), phase(name):
            yield

    engine._phase = labelled
    arms = [True] * epochs + [False] * epochs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for on in arms:
            engine.sync_phases = on
            torch.cuda.synchronize(dev)
            with record_function(f"epoch:{on}"):
                engine.train_one_epoch()
        torch.cuda.synchronize(dev)
    engine.sync_phases = True
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    if keep is not None:
        keep.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(keep, "wt") as f:
            json.dump(events, f)
    return _phase_gaps(events)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAITS = ("Synchronize", "cudaMemcpy", "cudaStreamSynchronize",
         "cudaEventSynchronize")


def _phase_gaps(events: list) -> list:
    """:func:`_phase_trace`'s readings from a Chrome trace's events."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = lambda prefix: sorted(  # noqa: E731
        (e for e in xs if e.get("cat") == "user_annotation"
         and e["name"].startswith(prefix)), key=lambda e: e["ts"])
    # The host's calls into CUDA (its runtime's and the layer below it).
    runtime = [e for e in xs if e.get("cat", "").startswith("cuda_")]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    by_corr = {}
    for e in device:
        by_corr.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    launches = sorted((e for e in runtime
                       if e.get("args", {}).get("correlation") in by_corr),
                      key=lambda e: e["ts"])
    ops = [e for e in xs if e.get("cat") == "cpu_op"]

    def inside(e, span):
        return span["ts"] <= e["ts"] <= span["ts"] + span["dur"]

    out = []
    phases = spans("phase:")
    for ep in spans("epoch:"):
        mine = [p for p in phases if inside(p, ep)]
        data = next(p for p in mine if p["name"] == "phase:data")
        fb = next(p for p in mine if p["name"] == "phase:f_b")
        d_launch = [e for e in launches if inside(e, data)]
        f_launch = [e for e in launches if inside(e, fb)]
        d_end = max((d["ts"] + d["dur"] for e in d_launch
                     for d in by_corr[e["args"]["correlation"]]), default=None)
        f_first = f_launch[0] if f_launch else None
        f_start = (min(d["ts"] for d in by_corr[f_first["args"]["correlation"]])
                   if f_first else None)
        waits = [e for e in runtime if inside(e, data)
                 and any(w in e["name"] for w in WAITS)]
        left = (waits[-1]["ts"] + waits[-1]["dur"]) if waits else None
        t_end = ep["ts"] + ep["dur"]
        busy = sorted((d["ts"], d["ts"] + d["dur"]) for d in device
                      if ep["ts"] <= d["ts"] <= t_end)
        covered, reach = 0.0, ep["ts"]
        for a, b in busy:
            a, b = max(a, reach), min(b, t_end)
            if b > a:
                covered += b - a
                reach = b
        gap_ops = {}
        if left is not None and f_first is not None:
            for e in ops:
                if left <= e["ts"] < f_first["ts"]:
                    gap_ops[e["name"]] = gap_ops.get(e["name"], 0.0) + e["dur"]
        out.append({
            "marks": ep["name"] == "epoch:True",
            "epoch_ms": ep["dur"] / 1e3, "data_ms": data["dur"] / 1e3,
            "f_b_ms": fb["dur"] / 1e3,
            "gap_us": None if d_end is None or f_start is None else f_start - d_end,
            "wait_to_launch_us": (None if left is None or f_first is None
                                  else f_first["ts"] - left),
            "launch_to_start_us": (None if f_first is None
                                   else f_start - f_first["ts"]),
            "waits_in_data": [e["name"] for e in waits],
            "idle_ms": (ep["dur"] - covered) / 1e3,
            "host_ops_in_gap_us": dict(sorted(gap_ops.items(),
                                              key=lambda kv: -kv[1])[:8])})
    return out


def _trace_ratios(cs, dev, train, profiles: int) -> list:
    """``check_trace``'s reading, ``profiles`` times on config0's and on
    the headline's engine: a replayed step's device time over the traced
    steps' wall (``bench_large.profile_steps``, PROFILE_STEPS steps)."""
    import torch

    from heat_tpu_torch import bench_large
    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.train.engine import Engine

    out = []
    for what, sets in (("config0", []), ("headline", cs.HEADLINE)):
        for _ in range(profiles):
            engine = Engine(load_config(cs.CONFIG0, **cs.overrides_of(sets))[0],
                            train, device=dev)
            rep = bench_large.profile_steps(engine, cs.PROFILE_STEPS)["replayed"]
            out.append({"what": what,
                        "ratio": rep["device_ms_per_step"]
                        / rep["profiled_wall_ms_per_step"],
                        "device_ms": rep["device_ms_per_step"],
                        "traced_wall_ms": rep["profiled_wall_ms_per_step"]})
            del engine
            torch.cuda.empty_cache()
    return out


def _job_breakdown(reps: int, pairs: int, trace_epochs: int, cli_runs: int,
                   profiles: int, trace_dir: str = "") -> dict:
    """In the checkout at the working directory: ``reps`` readings of
    ``chip_smoke.sync_cost`` at ``pairs`` rounds on config0 and the default
    shape, a device trace of each (:func:`_phase_trace`), ``cli_runs``
    readings of the ``--breakdown`` phases' sum against the run's wall
    (``chip_smoke.breakdown_of``), and ``profiles`` readings of
    ``check_trace``'s ratio a configuration."""
    import torch

    root, cs, _ = _checkout()
    from heat_tpu_torch import main as cli
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset

    dev = torch.device("cuda", 0)
    train, test = synthetic_click_dataset(num_users=cs.NUM_USERS,
                                          num_items=cs.NUM_ITEMS,
                                          max_his=cs.MAX_HIS, seed=2022)
    t0 = time.perf_counter()
    shapes = {"config0": [], "default shape": cs.DEFAULT_SHAPE}
    costs = {what: [cs.sync_cost(dev, sets, train, test, pairs=pairs)
                    for _ in range(reps)] for what, sets in shapes.items()}
    t1 = time.perf_counter()
    traces = {}
    for what, sets in shapes.items() if trace_epochs else ():
        keep = (Path(trace_dir) / f"{root.name}_{what.replace(' ', '_')}.json.gz"
                if trace_dir else None)
        try:
            traces[what] = _phase_trace(cs, dev, sets, train, test,
                                        trace_epochs, keep)
        except Exception as err:  # the readings above are kept
            traces[what] = {"error": f"{type(err).__name__}: {err}"[-2000:]}
    t2 = time.perf_counter()
    args = ["--config", cs.CONFIG0, "--synthetic", cs.SYNTHETIC, "--device",
            "cuda"]
    sums = [cs.breakdown_of(*cs.run_cli(cli, args + ["--breakdown"]))
            for _ in range(cli_runs)]
    t3 = time.perf_counter()
    ratios = _trace_ratios(cs, dev, train, profiles)
    return {"check": "breakdown", "tree": str(root), "reps": reps,
            "pairs": pairs, "sync_cost": cs.SYNC_COST,
            "walls_s": {"sync_cost": t1 - t0, "traces": t2 - t1,
                        "cli_runs": t3 - t2, "profiles": time.perf_counter() - t3},
            "wall_s": time.perf_counter() - t0, "costs": costs,
            "traces": traces, "phase_sums": sums, "trace_ratios": ratios}


def _variant_phase(engine, sync=(), events=(), idle: float = 0.0):
    """A stand-in for ``engine._phase``: the host's phase timer, then, at
    the end of the phases named, a device sync (``sync``), a timed CUDA
    event recorded and never read (``events``), and at the end of ``data``
    a host sleep of ``idle`` seconds."""
    import torch

    timer = engine.timer

    @contextlib.contextmanager
    def phase(name):
        with timer.phase(name):
            yield
            if name == "data" and idle:
                time.sleep(idle)
            if name in sync:
                torch.cuda.synchronize(engine.device)
            if name in events:
                torch.cuda.Event(enable_timing=True).record()

    return phase


def _round_trip():
    """One timed event recorded and waited for: the extra round trip of a
    read of the device after the host has already waited."""
    import torch

    now = torch.cuda.Event(enable_timing=True)
    now.record()
    now.synchronize()


# --check marks: what each piece of the phase timer's device accounting
# costs a replayed config0 epoch. name: (Engine.sync_phases, a stand-in
# for Engine._phase or None, something run after the epoch or None).
MARK_ARMS = {
    "none": (False, None, None),
    "none_again": (False, None, None),
    "engine": (True, None, None),
    "sync_both": (False, dict(sync=("data", "f_b")), None),
    "sync_data": (False, dict(sync=("data",)), None),
    "sync_f_b": (False, dict(sync=("f_b",)), None),
    "events": (False, dict(events=("data", "f_b")), None),
    "round_trip": (False, None, _round_trip),
    "idle_200us": (False, dict(idle=2e-4), None),
}


def _job_marks(rounds: int) -> dict:
    """``rounds`` rounds of replayed config0 epochs, one of each arm of
    MARK_ARMS a round in an order that turns round by round, on one engine
    after its capture, in the checkout at the working directory: each
    arm's epoch seconds."""
    import torch

    root, cs, _ = _checkout()
    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.train.engine import Engine

    dev = torch.device("cuda", 0)
    train, test = synthetic_click_dataset(num_users=cs.NUM_USERS,
                                          num_items=cs.NUM_ITEMS,
                                          max_his=cs.MAX_HIS, seed=2022)
    engine = Engine(load_config(cs.CONFIG0)[0], train, test, device=dev)
    engine.train_one_epoch()  # the capture
    arms = list(MARK_ARMS)
    times = {arm: [] for arm in arms}
    t0 = time.perf_counter()
    for i in range(rounds):
        turn = arms[i % len(arms):] + arms[:i % len(arms)]
        for arm in turn[::-1] if i % 2 else turn:
            on, variant, after = MARK_ARMS[arm]
            engine.sync_phases = on
            if variant is not None:
                engine._phase = _variant_phase(engine, **variant)
            torch.cuda.synchronize(dev)
            s = time.perf_counter()
            engine.train_one_epoch()
            if after is not None:
                after()
            times[arm].append(time.perf_counter() - s)
            if variant is not None:
                del engine._phase
    engine.sync_phases = True
    return {"check": "marks", "tree": str(root), "rounds": rounds,
            "wall_s": time.perf_counter() - t0, "times_s": times}


def _summarize_marks(recs: list) -> dict:
    """Per arm: the paired cost against ``none`` of the same round (its
    median with the 99% interval, its mean) and the epoch's median."""
    import chip_smoke as cs

    out = {}
    for arm in recs[0]["times_s"]:
        costs = [t / n - 1.0 for r in recs for t, n in zip(
            r["times_s"][arm], r["times_s"]["none"])]
        out[arm] = {"median": statistics.median(costs),
                    "median_99": cs.median_interval(costs),
                    "mean": statistics.fmean(costs),
                    "epoch_s_median": statistics.median(
                        t for r in recs for t in r["times_s"][arm])}
    return out


def _gate_reading(record, run, metrics, band):
    """``parity.gate``'s record without its raise: a reading beyond the
    band is kept, not an error."""
    from heat_tpu_torch import parity

    want = record["runs"][run]["final_metrics"]
    return {"run": run, "band": band,
            "gap": {m: metrics[m] - want[m] for m in parity.GATED_METRICS}}


def _job_gates(reps: int) -> dict:
    """The single-card gated runs of ``chip_smoke.GATED_RUNS``, each
    through the CLI at the script's schedule and seed, ``reps`` times in
    turn, in the checkout at the working directory: each run's final
    metrics and gaps to its JAX run."""
    import torch

    root, cs, _ = _checkout()
    from heat_tpu_torch import main as cli
    from heat_tpu_torch import parity

    record = parity.load_parity()
    args = ["--config", cs.CONFIG0, "--synthetic", cs.SYNTHETIC, "--device",
            "cuda"]
    t0 = time.perf_counter()
    out = []
    for k in range(reps):
        for run, sets in cs.GATED_RUNS.items():
            if run.endswith("_mesh41"):
                continue
            s = time.perf_counter()
            rec = cli.main(args + [x for kv in sets for x in ("--set", kv)])
            torch.cuda.empty_cache()
            final = {m: rec["final_metrics"][m] for m in parity.GATED_METRICS}
            out.append({"run": run, "rep": k, "metrics": final,
                        "losses": rec["losses"], "wall_s": time.perf_counter() - s,
                        **_gate_reading(record, run, final, parity.BANDS[run])})
    return {"check": "gates", "tree": str(root), "reps": reps,
            "wall_s": time.perf_counter() - t0, "runs": out}


def _job_mesh_gates(spec: dict) -> dict:
    """The mesh's gated runs, ``spec`` ({run: repetitions}) in the checkout
    at the working directory: the (4, 1) CLI runs two at a time
    (``chip_smoke.run_mesh_clis``, untraced), and ``config0_sorted_mesh41``
    (``check_mesh_sorted_gate``'s Engine run on (4, 1) at its threshold),
    its repetitions in one job of four ranks beside them."""
    import dataclasses
    import threading

    import torch

    root, cs, mc = _checkout()
    from heat_tpu_torch import parity

    parity.gate = _gate_reading
    dev = torch.device("cuda", 0)
    record = parity.load_parity()
    t0 = time.perf_counter()
    out, sorted_box = [], {}
    n_sorted = spec.pop(cs.MESH_SORTED_RUN, 0)

    def sorted_runs():
        cfg, data_kw, _ = cs.mesh_data()
        run = record["runs"][cs.MESH_SORTED_RUN]
        cfg_kw = dict(dataclasses.asdict(cfg), **cs.overrides_of(run["overrides"]))
        call = ("rank_train", ((4, 1), data_kw, cfg_kw, cfg_kw["epochs"],
                               dev.type),
                {"dense_rows": cs.MESH_SORTED_ROWS, "all_states": False,
                 "fused": "epochs"})
        s = time.perf_counter()
        ranks = mc.spawn_ranks(mc.rank_calls, 4, [call] * n_sorted,
                               device=dev.type,
                               timeout=cs.MESH_TIMEOUT * max(1, n_sorted))
        wall = (time.perf_counter() - s) / max(1, n_sorted)
        sorted_box["runs"] = [
            {"run": cs.MESH_SORTED_RUN, "rep": k, "metrics": r["metrics"],
             "losses": r["losses"], "wall_s": wall,
             **_gate_reading(record, cs.MESH_SORTED_RUN, r["metrics"],
                             parity.BANDS[cs.MESH_SORTED_RUN])}
            for k, r in enumerate(ranks[0])]

    def guarded():
        try:
            sorted_runs()
        except BaseException as err:  # reported in the job's record
            sorted_box["error"] = f"{type(err).__name__}: {err}"[-3000:]

    beside = threading.Thread(target=guarded)
    if n_sorted:
        beside.start()
    left = dict(spec)
    done = dict.fromkeys(spec, 0)
    while any(left.values()):
        pair = sorted((r for r in left if left[r]), key=lambda r: -left[r])[:2]
        got = cs.run_mesh_clis(dev, {r: (cs.GATED_RUNS[r], False) for r in pair})
        for r in pair:
            left[r] -= 1
            out.append({"run": r, "rep": done[r],
                        "metrics": got[r]["final_metrics"],
                        "losses": got[r]["losses"], "wall_s": got[r]["wall_s"],
                        "beside": got[r]["beside"],
                        "band": got[r]["gate_jax"]["band"],
                        "gap": got[r]["gate_jax"]["gap"]})
            done[r] += 1
    if n_sorted:
        beside.join()
    out += sorted_box.get("runs", [])
    return {"check": "mesh_gates", "tree": str(root),
            "wall_s": time.perf_counter() - t0, "runs": out,
            "sorted_error": sorted_box.get("error")}


def ratio(d2, run: int, oracles) -> float:
    """``held_to_spread``'s ratio from a matrix of pairs' mean squares:
    the rms distance of ``run`` pooled over its pairs with ``oracles``,
    over the oracles' own pooled rms spread (inf where that is 0 and the
    run is not)."""
    near = sum(d2[run][o] for o in oracles) / len(oracles)
    pairs = list(itertools.combinations(oracles, 2))
    spread = sum(d2[a][b] for a, b in pairs) / len(pairs)
    if spread == 0:
        return 0.0 if near == 0 else float("inf")
    return (near / spread) ** 0.5


def _scalar_d2(numbers: list, keys) -> dict:
    """{key: the matrix of (a - b)^2} of dicts of numbers."""
    return {k: [[(a[k] - b[k]) ** 2 for b in numbers] for a in numbers]
            for k in keys}


def _quantiles(xs: list) -> dict:
    """Quantiles of ratios, and the share of them over 2."""
    xs = sorted(xs)
    if not xs:
        return {}
    at = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"n": len(xs), "median": at(0.5), "q90": at(0.9), "q99": at(0.99),
            "max": xs[-1], "over_2": sum(x > 2 for x in xs) / len(xs)}


def law_over(x: float, n: int, t_tail) -> float:
    """The t law's chance that one Gaussian scalar's ratio against ``n``
    oracles exceeds ``x`` (``chip_smoke.spread_limit``'s model)."""
    t2 = (2 * n * x * x - (n - 1)) / (n + 1)
    return 1.0 if t2 <= 0 else t_tail(t2 ** 0.5, n - 1)


def _summarize_l(recs: list, n: int, limit: float) -> dict:
    reps = [rep for r in recs for rep in r.get("runs", [])]
    keys = list(reps[0]["plain"][0])
    plain = [p for rep in reps for p in rep["plain"]]
    out = {"reps": len(reps), "plain_runs": len(plain), "n": n,
           "limit": limit, "per_rep": [], "fused": {}, "faulted": {}}
    # Each repetition on its own first n plain runs.
    for rep in reps:
        runs = rep["plain"] + list(rep["fused"].values()) + list(rep["faulted"].values())
        d2 = _scalar_d2(runs, keys)
        names = list(rep["fused"]) + list(rep["faulted"])
        row = {}
        for i, name in enumerate(names):
            ratios = {k: ratio(d2[k], len(rep["plain"]) + i, range(n)) for k in keys}
            row[name] = {"flags": any(r > limit for r in ratios.values()),
                         "ratios": ratios}
        out["per_rep"].append(row)
    rng = random.Random(0)

    def against_sets(d2, run, pool, draws, per):
        flags, worst = 0, []
        for _ in range(draws):
            ratios = {k: ratio(d2[k], run, rng.sample(pool, n)) for k in keys}
            flags += any(r > limit for r in ratios.values())
            worst.append(max(ratios.values()))
            for k in keys:
                per[k].append(ratios[k])
        return flags, worst

    # Each plain run against random sets of the others: the null law.
    d2 = _scalar_d2(plain, keys)
    per, flags, draws = {k: [] for k in keys}, 0, SETS // len(plain) + 1
    for i in range(len(plain)):
        flags += against_sets(d2, i, [j for j in range(len(plain)) if j != i],
                              draws, per)[0]
    out["plain"] = {"p_flags": flags / (draws * len(plain)),
                    "ratio_by_quantity": {k: _quantiles(v) for k, v in per.items()}}
    # A check: both fused runs of a repetition against one random set out
    # of all plain runs.
    d2 = _scalar_d2(plain + [f for rep in reps for f in rep["fused"].values()], keys)
    flags, draws, at = 0, SETS // len(reps) + 1, len(plain)
    for rep in reps:
        fused = range(at, at + len(rep["fused"]))
        at += len(rep["fused"])
        for _ in range(draws):
            group = rng.sample(range(len(plain)), n)
            flags += any(ratio(d2[k], f, group) > limit for f in fused for k in keys)
    out["p_check_flags"] = flags / (draws * len(reps))
    # Every fused and faulted run against random sets out of all plain runs.
    for kind in ("fused", "faulted"):
        for name in sorted({name for rep in reps for name in rep[kind]}):
            runs = [rep[kind][name] for rep in reps if name in rep[kind]]
            d2 = _scalar_d2(plain + runs, keys)
            per, flags, worst = {k: [] for k in keys}, 0, []
            draws = SETS // len(runs) + 1
            for i in range(len(runs)):
                f, w = against_sets(d2, len(plain) + i, list(range(len(plain))),
                                    draws, per)
                flags += f
                worst += w
            out[kind][name] = {
                "runs": len(runs), "p_flags": flags / len(worst),
                "max_ratio": _quantiles(worst),
                "ratio_by_quantity": {k: _quantiles(v) for k, v in per.items()}}
    return out


def _summarize_i(recs: list, n: int, limit: float, t_tail) -> dict:
    rng = random.Random(0)
    out = {"jobs": len(recs), "n": n, "limit": limit,
           "law_over_2": law_over(2.0, n, t_tail),
           "pools_probe": [r["pools_probe"] for r in recs],
           "job_wall_s": [r["job_wall_s"] for r in recs],
           "oracles_s": [r["oracles_s"] for r in recs], "quantities": {}}
    for key in recs[0]["d2"]:
        ratios, own, rms = [], [], {"mesh-mesh": [], "oracle-oracle": [],
                                    "mesh-oracle": []}
        for r in recs:
            d2, kinds = r["d2"][key], r["kinds"]
            mesh = [i for i, k in enumerate(kinds) if k == "mesh"]
            ors = [i for i, k in enumerate(kinds) if k == "oracle"]
            for a, b in itertools.combinations(range(len(kinds)), 2):
                tag = ("mesh-oracle" if kinds[a] != kinds[b]
                       else f"{kinds[a]}-{kinds[a]}")
                rms[tag].append(d2[a][b] ** 0.5)
            for m in mesh:
                own.append(ratio(d2, m, ors[:n]))
                for _ in range(SETS // max(1, len(recs) * len(mesh)) + 1):
                    ratios.append(ratio(d2, m, rng.sample(ors, n)))
        out["quantities"][key] = {
            "ratio_first_oracles": own, "ratio": _quantiles(ratios),
            "p_flags": sum(x > limit for x in ratios) / len(ratios),
            "rms_median": {k: _quantiles(v).get("median") for k, v in rms.items()}}
    return out


def _binom_tail(n: int, p: float, k: int) -> float:
    """P(Binomial(n, p) >= k)."""
    return sum(math.comb(n, j) * p ** j * (1 - p) ** (n - j)
               for j in range(k, n + 1))


def _sign_rule(cs, pool: list, rng, n: int) -> float:
    """The share of SETS sets of ``n`` paired costs drawn from ``pool``
    (with replacement: the bootstrap) that the sign test fails."""
    fail_at = cs.sign_test_count(n)
    sets = [rng.choices(pool, k=n) for _ in range(SETS)]
    return sum(sum(c > cs.SYNC_COST for c in xs) >= fail_at
               for xs in sets) / SETS


def _summarize_breakdown(recs: list, cs) -> dict:
    """The sync cost's paired readings pooled a shape: their quantiles, the
    median with its 99% interval, the share over SYNC_COST and the sign
    test's chance of failing at SYNC_PAIRS (from that share, and by
    resampling the pool), the planted delay's (its power); the replaced
    min-ratio rule on resampled sets of 12 rounds; the trace's gaps; the
    phase sums and ``check_trace``'s ratios against their bounds."""
    rng = random.Random(0)
    bound = cs.SYNC_COST
    out = {"jobs": len(recs), "bound": bound, "pairs_a_check": cs.SYNC_PAIRS,
           "fail_at": cs.sign_test_count(cs.SYNC_PAIRS),
           "walls_s": [r.get("walls_s") for r in recs]}
    for what in recs[0]["costs"]:
        got = [c for r in recs for c in r["costs"][what]]
        times = {arm: [t for c in got for t in c["times_s"][arm]]
                 for arm in got[0]["times_s"]}
        entry = {"rounds": len(times["without"]),
                 "epoch_s_median": {a: statistics.median(t)
                                    for a, t in times.items()}}
        for arm in ("with", "fault"):
            costs = [c for g in got for c in g[arm]["costs"]]
            share = sum(c > bound for c in costs) / len(costs)
            q = _quantiles(costs)
            del q["over_2"]
            entry[arm] = {**q, "min": min(costs), "mean": statistics.fmean(costs),
                          "median_99": cs.median_interval(costs),
                          "share_over": share,
                          "p_fail_binomial": _binom_tail(
                              cs.SYNC_PAIRS, share, out["fail_at"]),
                          "p_fail_resampled": _sign_rule(
                              cs, costs, rng, cs.SYNC_PAIRS)}
        old = []
        rounds = list(zip(times["with"], times["without"]))
        for _ in range(SETS):
            pick = rng.choices(rounds, k=12)
            old.append(min(w for w, _ in pick) / min(o for _, o in pick) - 1)
        entry["old_rule_12"] = {"p_over": sum(x > bound for x in old) / SETS,
                                "median": statistics.median(old)}
        traced = [e for r in recs for e in r.get("traces", {}).get(what, [])
                  if isinstance(e, dict) and "marks" in e]
        for marks in (True, False):
            mine = [e for e in traced if e["marks"] == marks]
            if mine:
                entry[f"trace_marks_{marks}"] = {
                    k: [e[k] for e in mine] for k in (
                        "epoch_ms", "gap_us", "wait_to_launch_us",
                        "launch_to_start_us", "idle_ms")}
                entry[f"trace_marks_{marks}"]["host_ops_in_gap_us"] = \
                    mine[-1]["host_ops_in_gap_us"]
                entry[f"trace_marks_{marks}"]["waits_in_data"] = \
                    mine[-1]["waits_in_data"]
        out[what] = entry
    sums = [s["off"] for r in recs for s in r.get("phase_sums", [])]
    if sums:
        out["phase_sum_off"] = {"n": len(sums), "min": min(sums),
                                "max": max(sums), "band": cs.PHASE_SUM_BAND}
    ratios = [t["ratio"] for r in recs for t in r.get("trace_ratios", [])]
    if ratios:
        out["trace_ratio"] = {"n": len(ratios), "min": min(ratios),
                              "max": max(ratios), "bound": 1.25}
    return out


def _normal_out(mean: float, sd: float, band: float) -> float:
    """P(|X| > band) for X normal with ``mean`` and ``sd``."""
    if sd == 0:
        return float(abs(mean) > band)
    cdf = lambda x: 0.5 * math.erfc(-x / math.sqrt(2))  # noqa: E731
    return cdf((-band - mean) / sd) + 1.0 - cdf((band - mean) / sd)


def _summarize_gates(recs: list, cs) -> dict:
    """Per gated run and metric: the readings' gaps to the JAX run, their
    mean and sd (the port's own run-to-run spread), the band, the share
    of readings outside it and the normal fit's chance of it; per run, the
    chance that one run fails either metric, and the least m whose mean
    of m runs fails at most GATE_SHARE by the fit (None above 64); the
    mean's margin to the band edge in sds of one run."""
    runs = {}
    for r in recs:
        for x in r["runs"]:
            runs.setdefault(x["run"], []).append(x)
    out = {"share": cs.GATE_SHARE}
    for run, xs in runs.items():
        band = xs[0]["band"]
        entry = {"n": len(xs), "band": band,
                 "wall_s_median": statistics.median(x["wall_s"] for x in xs),
                 "metrics": {}}
        fits = []
        for m in xs[0]["gap"]:
            gaps = [x["gap"][m] for x in xs]
            mean = statistics.fmean(gaps)
            sd = statistics.stdev(gaps) if len(gaps) > 1 else 0.0
            fits.append((mean, sd))
            entry["metrics"][m] = {
                "gaps": gaps, "mean": mean, "sd": sd,
                "out_of_band": sum(abs(g) > band for g in gaps),
                "p_out_fit": _normal_out(mean, sd, band),
                "edge_margin_sd": (band - abs(mean)) / sd if sd else None}
        entry["p_fail_fit"] = sum(_normal_out(a, b, band) for a, b in fits)
        entry["m_needed"] = next(
            (m for m in range(1, 65) if sum(
                _normal_out(a, b / math.sqrt(m), band) for a, b in fits)
             <= cs.GATE_SHARE), None)
        out[run] = entry
    return out


def summarize(path: Path) -> dict:
    """Per check and checkout name of the job lines in ``path``: the
    verdicts and ratios (the module's docstring) at this checkout's
    FUSED_CLI_PLAIN and ORACLE_RUNS."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import FUSED_CLI_PLAIN, ORACLE_RUNS, spread_limit, t_tail

    import chip_smoke as cs

    recs = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
    out = {}
    for check in CHECKS:
        for name in dict.fromkeys(r["name"] for r in recs):
            mine = [r for r in recs if r["name"] == name
                    and r.get("check", "l") == check and "err" not in r]
            if not mine:
                continue
            out[f"{check} {name}"] = (
                _summarize_l(mine, FUSED_CLI_PLAIN, spread_limit(FUSED_CLI_PLAIN))
                if check == "l" else
                _summarize_i(mine, ORACLE_RUNS, spread_limit(ORACLE_RUNS), t_tail)
                if check == "i" else _summarize_breakdown(mine, cs)
                if check == "breakdown" else _summarize_marks(mine)
                if check == "marks" else _summarize_gates(mine, cs))
    return out


def run(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CHECKOUT")
    ap.add_argument("--check", choices=CHECKS, default="l")
    ap.add_argument("--budget", type=float, default=300.0)
    ap.add_argument("--jobs", type=int, default=200)
    ap.add_argument("--job-timeout", type=float, default=900.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--faults", default="")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--oracles", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=120)
    ap.add_argument("--trace-epochs", type=int, default=3)
    ap.add_argument("--cli-runs", type=int, default=3)
    ap.add_argument("--profiles", type=int, default=3)
    ap.add_argument("--mesh-reps", default=MESH_REPS)
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("spread_runner.jsonl"))
    ap.add_argument("--summarize", type=Path)
    ap.add_argument("--job", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize)))
        return
    faults = [float(d) for d in args.faults.split(",") if d]
    if args.job:  # in a checkout's working directory, by the loop below
        rec = (_job_l(args.reps, args.device, faults) if args.check == "l"
               else _job_i(args.runs, args.oracles, args.device)
               if args.check == "i" else _job_breakdown(
                   args.reps, args.pairs, args.trace_epochs, args.cli_runs,
                   args.profiles, args.trace_dir) if args.check == "breakdown"
               else _job_gates(args.reps) if args.check == "gates"
               else _job_marks(args.pairs) if args.check == "marks"
               else _job_mesh_gates({r: int(n) for r, n in (
                   x.split(":") for x in args.mesh_reps.split(","))}))
        print("JOB " + json.dumps(rec))
        return
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    order = [n for i in range(100) for n in (names if i % 2 == 0 else names[::-1])]
    t0 = time.perf_counter()
    for name in order[:args.jobs]:
        if time.perf_counter() - t0 > args.budget:
            break
        s = time.perf_counter()
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--job", "--check",
             args.check, "--reps", str(args.reps), "--faults", args.faults,
             "--runs", str(args.runs), "--oracles", str(args.oracles),
             "--pairs", str(args.pairs), "--trace-epochs",
             str(args.trace_epochs), "--cli-runs", str(args.cli_runs),
             "--profiles", str(args.profiles), "--mesh-reps", args.mesh_reps,
             "--trace-dir", os.path.abspath(args.trace_dir) if args.trace_dir
             else "",
             "--device", args.device],
            cwd=trees[name], capture_output=True, text=True,
            timeout=args.job_timeout)
        line = [ln for ln in done.stdout.splitlines() if ln.startswith("JOB ")]
        rec = (json.loads(line[-1][4:]) if line else
               {"check": args.check, "rc": done.returncode,
                "err": done.stderr[-3000:]})
        rec["name"], rec["job_s"] = name, time.perf_counter() - s
        with args.out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(name, args.check, round(rec["job_s"], 1),
              rec.get("err", "")[-500:] or "ok", flush=True)


if __name__ == "__main__":
    if "--job" in sys.argv:
        # Run by path inside another checkout: import that checkout's code,
        # not the modules beside this file.
        sys.path.pop(0)
    run()
