"""``chip_smoke.py``'s chance checks alone and repeated: the spread checks
(l) and (i), and the phase timer's sync cost of ``check_breakdown``; how
often each fails by chance, and whether (l) catches a planted fault
(ROADMAP §3, F7 and F8).

    python spread_runner.py [--check l|i|breakdown] [--budget S] [--reps N]
        [--faults D,D,...] [--runs R] [--oracles N] [--device D]
        [--out FILE] NAME=CHECKOUT [NAME=CHECKOUT ...]
    python spread_runner.py --summarize FILE

Each job runs in a checkout of the repository with that checkout's own
``chip_smoke.py`` (its argv, constants and oracles) and rank programs; the
checkouts take turns (a, b, b, a, ...) until ``--budget`` seconds have
gone, and each job's line goes to ``--out``. Needs the card unless
``--device cpu`` (``--check breakdown`` needs it always).

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

``--check breakdown`` (``check_breakdown``): ``--reps`` readings of
``chip_smoke.sync_cost`` on config0 and on the default shape, alone on
the card as the script takes them after its mesh phases.

``--summarize FILE`` reads such lines (no card) and prints, a checkout and
a check: for (l) and (i), ``chip_smoke.held_to_spread``'s verdicts (each
quantity on its own within ``spread_limit(n)``) on each repetition's own
oracles and on SETS random sets of oracles out of all the checkout's
(seeded), with the ratios' quantiles; for the sync cost, its quantiles
and the share of readings over SYNC_COST.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

SETS = 3000  # random sets of oracle runs a run is held to


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


def _job_breakdown(reps: int) -> dict:
    """``reps`` readings of the syncs' cost on config0 and the default
    shape in the checkout at the working directory."""
    import torch

    root, cs, _ = _checkout()
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset

    dev = torch.device("cuda", 0)
    train, test = synthetic_click_dataset(num_users=cs.NUM_USERS,
                                          num_items=cs.NUM_ITEMS,
                                          max_his=cs.MAX_HIS, seed=2022)
    t0 = time.perf_counter()
    shapes = {"config0": [], "default shape": cs.DEFAULT_SHAPE}
    costs = {what: [cs.sync_cost(dev, sets, train, test) for _ in range(reps)]
             for what, sets in shapes.items()}
    return {"check": "breakdown", "tree": str(root), "reps": reps,
            "sync_cost": cs.SYNC_COST, "wall_s": time.perf_counter() - t0,
            "costs": costs}


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


def _summarize_breakdown(recs: list) -> dict:
    bound = recs[0]["sync_cost"]
    out = {"jobs": len(recs), "bound": bound}
    for what in recs[0]["costs"]:
        costs = [c["cost"] for r in recs for c in r["costs"][what]]
        q = _quantiles(costs)
        del q["over_2"]
        out[what] = {**q, "min": min(costs),
                     "p_over": sum(c > bound for c in costs) / len(costs)}
    return out


def summarize(path: Path) -> dict:
    """Per check and checkout name of the job lines in ``path``: the
    verdicts and ratios (the module's docstring) at this checkout's
    FUSED_CLI_PLAIN and ORACLE_RUNS."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import FUSED_CLI_PLAIN, ORACLE_RUNS, spread_limit, t_tail

    recs = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
    out = {}
    for check in ("l", "i", "breakdown"):
        for name in dict.fromkeys(r["name"] for r in recs):
            mine = [r for r in recs if r["name"] == name
                    and r.get("check", "l") == check and "err" not in r]
            if not mine:
                continue
            out[f"{check} {name}"] = (
                _summarize_l(mine, FUSED_CLI_PLAIN, spread_limit(FUSED_CLI_PLAIN))
                if check == "l" else
                _summarize_i(mine, ORACLE_RUNS, spread_limit(ORACLE_RUNS), t_tail)
                if check == "i" else _summarize_breakdown(mine))
    return out


def run(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CHECKOUT")
    ap.add_argument("--check", choices=("l", "i", "breakdown"), default="l")
    ap.add_argument("--budget", type=float, default=300.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--faults", default="")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--oracles", type=int, default=10)
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
               if args.check == "i" else _job_breakdown(args.reps))
        print("JOB " + json.dumps(rec))
        return
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    order = [n for i in range(100) for n in (names if i % 2 == 0 else names[::-1])]
    t0 = time.perf_counter()
    for name in order:
        if time.perf_counter() - t0 > args.budget:
            break
        s = time.perf_counter()
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--job", "--check",
             args.check, "--reps", str(args.reps), "--faults", args.faults,
             "--runs", str(args.runs), "--oracles", str(args.oracles),
             "--device", args.device],
            cwd=trees[name], capture_output=True, text=True, timeout=900)
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
