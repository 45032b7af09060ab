"""``chip_smoke.py``'s (l) check of the CLI's fused flags, alone and
repeated, to measure how often it fails by chance (ROADMAP §3, F7).

    python -m heat_tpu_torch.fused_cli_spread [--budget S] [--reps N]
        [--device D] [--out FILE] NAME=CHECKOUT [NAME=CHECKOUT ...]
    python -m heat_tpu_torch.fused_cli_spread --summarize FILE

(l) (``check_mesh_sorted_gate``) runs the CLI on a (4, 1) mesh of four
gloo ranks FUSED_CLI_PLAIN times plain and twice fused (``--fused-epochs
2``, ``--fused-run``) and holds each fused run's epoch losses and final
metrics to SPREAD_RULE times the plain runs' pooled rms spread
(``held_to_spread``; K3's atomics make runs differ). Here each job runs
those seven CLI runs ``--reps`` times, one after another, in a checkout of
the repository with that checkout's own ``chip_smoke.py`` (its argv,
constants and rule) and rank programs, and applies the rule to each
repetition. The checkouts take turns (a, b, b, a, ...) until ``--budget``
seconds have gone; each job's line (every ratio, pass or failure and the
numbers held) goes to ``--out``. Needs the card unless ``--device cpu``.

``--summarize FILE`` instead reads such lines (no card) and prints, a
checkout, the repetitions that passed, the fused runs' ratios and the
chance that one fused run fails the rule against SETS random sets of
five (FUSED_CLI_PLAIN) of all that checkout's plain runs (seeded).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _job(reps: int, device: str) -> dict:
    """One job in the checkout at the working directory."""
    import numpy as np

    root = Path.cwd()
    sys.path[:0] = [str(root), str(root / "tests")]
    import chip_smoke as cs
    import torch_mesh_support as mc
    from heat_tpu_torch import parity

    def numbers(c):
        rec = c["record"]
        return np.asarray(rec["losses"] + [rec["final_metrics"][m]
                                           for m in parity.GATED_METRICS])

    argv = ["--config", cs.CONFIG0, "--synthetic", cs.FUSED_CLI_SYNTHETIC,
            "--epochs", "3", "--device", device]
    one = ([argv] * cs.FUSED_CLI_PLAIN
           + [argv + ["--fused-epochs", "2"], argv + ["--fused-run"]])
    t0 = time.perf_counter()
    clis = mc.spawn_ranks(mc.rank_clis, 4, one * reps, device=device,
                          timeout=cs.MESH_TIMEOUT)[0]
    out = {"tree": str(root), "reps": reps,
           "wall_s": time.perf_counter() - t0, "runs": []}
    for k in range(reps):
        group = clis[k * len(one):(k + 1) * len(one)]
        plain = [numbers(p) for p in group[:cs.FUSED_CLI_PLAIN]]
        rep = {"plain": [p.tolist() for p in plain], "fused": {}}
        for name, c in zip(("fused_epochs_2", "fused_run"),
                           group[cs.FUSED_CLI_PLAIN:]):
            try:
                held = cs.held_to_spread(name, numbers(c), plain)
                rep["fused"][name] = {"ratio": held["ratio"], "ok": True}
            except AssertionError as err:
                rep["fused"][name] = {"error": str(err), "ok": False}
            rep["fused"][name]["numbers"] = numbers(c).tolist()
        rep["ok"] = all(v["ok"] for v in rep["fused"].values())
        out["runs"].append(rep)
    return out


SETS = 3000  # random sets of plain runs a fused run is held to


def _ratio(got, plain) -> float:
    """``held_to_spread``'s ratio: the rms distance of ``got`` pooled over
    its pairs with the ``plain`` runs, over their own pooled spread."""
    import itertools

    import numpy as np

    def pooled(pairs):
        return float(np.sqrt(np.mean([np.mean((np.asarray(a) - np.asarray(b)) ** 2)
                                      for a, b in pairs])))

    return (pooled([(got, p) for p in plain])
            / pooled(list(itertools.combinations(plain, 2))))


def summarize(path: Path, rule: float = 2.0, plain_runs: int = 5) -> dict:
    """Per checkout name of the job lines in ``path``: repetitions run and
    passed, the fused runs' ratios (median, least, most), and the share
    of (fused run, random set of ``plain_runs`` plain runs) pairs whose
    ratio exceeds ``rule``."""
    import random
    import statistics

    recs = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
    out = {}
    for name in dict.fromkeys(r["name"] for r in recs):
        reps = [rep for r in recs if r["name"] == name for rep in r.get("runs", [])]
        plain = [p for rep in reps for p in rep["plain"]]
        fused = [v["numbers"] for rep in reps for v in rep["fused"].values()]
        ratios = [_ratio(v["numbers"], rep["plain"]) for rep in reps
                  for v in rep["fused"].values()]
        rng = random.Random(0)
        sets = [rng.sample(range(len(plain)), plain_runs) for _ in range(SETS)]
        over = sum(_ratio(f, [plain[i] for i in s]) > rule
                   for f in fused for s in sets)
        out[name] = {"reps": len(reps), "passed": sum(rep["ok"] for rep in reps),
                     "fused_runs": len(ratios), "plain_runs": len(plain),
                     "ratio_median": statistics.median(ratios),
                     "ratio_min": min(ratios), "ratio_max": max(ratios),
                     "p_fused_run_over": over / (len(fused) * SETS)}
    return out


def run(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CHECKOUT")
    ap.add_argument("--budget", type=float, default=300.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("fused_cli_spread.jsonl"))
    ap.add_argument("--summarize", type=Path)
    ap.add_argument("--job", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize)))
        return
    if args.job:  # in a checkout's working directory, by the loop below
        print("JOB " + json.dumps(_job(args.reps, args.device)))
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
            [sys.executable, os.path.abspath(__file__), "--job", "--reps",
             str(args.reps), "--device", args.device],
            cwd=trees[name], capture_output=True, text=True, timeout=600)
        line = [ln for ln in done.stdout.splitlines() if ln.startswith("JOB ")]
        rec = (json.loads(line[-1][4:]) if line else
               {"rc": done.returncode, "err": done.stderr[-3000:]})
        rec["name"], rec["job_s"] = name, time.perf_counter() - s
        with args.out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(name, json.dumps({"ok": [r["ok"] for r in rec.get("runs", [])],
                                "ratios": [[v.get("ratio") for v in r["fused"].values()]
                                           for r in rec.get("runs", [])],
                                "err": rec.get("err", "")[-500:]}), flush=True)


if __name__ == "__main__":
    if "--job" in sys.argv:
        # Run by path inside another checkout: import that checkout's code,
        # not the modules beside this file.
        sys.path.pop(0)
    run()
