"""A multi-process training and evaluation run on a mesh of ranks: the
port's counterpart of ``scripts/multihost_demo.py`` (its "base" variant).

The JAX demo runs ``--procs`` processes of four CPU devices each on a
``(2 * procs, 2)`` mesh. Here every device is a rank, so the launcher
starts ``4 * procs`` rank processes on that mesh (``--device cpu``
through gloo; on the card every rank shares it through gloo too). Every
rank generates the demo's data (64 users x 126 items: 126 is not a
multiple of 128 x n_model, so the evaluation takes the padded sharded
top-k, not the all-gather fallback), keeps its user range with global ids,
trains four epochs and evaluates: plainly, with aggregated users, and with
``exact=False``. Each rank checks that the sharded evaluation equals the
single-process evaluator over the gathered tables and the whole test set,
and prints its losses and Recall@20; the launcher checks that every rank
exits cleanly and reports the same ones.

    python -m heat_tpu_torch.multihost_demo --procs 2 [--device cpu]

prints ``multihost demo ok`` at the end.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

DEMO_DATA = dict(num_users=64, num_items=126, clicks_per_user=12, max_his=6,
                 seed=7)
DEMO_CFG = dict(emb_dim=8, num_negs=4, max_his=6, l_r=0.05, batch_size=32,
                seed=3, metrics=["Recall(k=20)"])


def worker(procs: int, rank: int, port: int, device: str) -> None:
    """One rank: the base variant's training and its checks."""
    import numpy as np
    import torch

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.data.datasets import shard_by_user_range
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.evaluation.evaluator import (
        TiledEvaluator,
        sharded_topk_supported,
    )
    from heat_tpu_torch.evaluation.metrics import evaluate_metrics
    from heat_tpu_torch.parallel import distributed
    from heat_tpu_torch.parallel.mesh import make_mesh
    from heat_tpu_torch.train.engine import Engine

    if device == "cpu":
        torch.set_num_threads(1)
    world = 4 * procs
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device)
    mesh = make_mesh(2 * procs, 2, device=device)
    train, test = synthetic_click_dataset(**DEMO_DATA)
    n_data, d = mesh.shape[0], mesh.data_index
    local_train = shard_by_user_range(train, n_data, d, rebase=False)
    local_test = shard_by_user_range(test, n_data, d)
    engine = Engine(CFConfig(**DEMO_CFG), local_train, local_test,
                    device=device, mesh=mesh)
    losses = [engine.train_one_epoch() for _ in range(4)]
    m = engine.evaluate()
    m_agg = engine.evaluate(aggregate_users=True)
    assert 0.0 <= m_agg["Recall(k=20)"] <= 1.0, m_agg
    assert sharded_topk_supported(mesh, train.num_items, 20, train.num_users), (
        "the demo's geometry must take the sharded top-k")
    # The sharded evaluation equals one evaluator over the gathered tables
    # and the whole test set.
    st = engine.unpadded_state()
    ref_ev = TiledEvaluator(train.pairs, train.num_users,
                            num_items=train.num_items, device=engine.device)
    _, ref_ids = ref_ev.topk(st.user_emb, st.item_emb, 20)
    ref = evaluate_metrics(["Recall(k=20)"], ref_ids.cpu().numpy(),
                           test.user_items)
    assert abs(m["Recall(k=20)"] - ref["Recall(k=20)"]) < 1e-6, (m, ref)
    m_approx = engine.evaluate(exact=False, recall_target=0.95)
    assert abs(m_approx["Recall(k=20)"] - m["Recall(k=20)"]) < 0.05
    print(f"rank {rank}: losses {[float(x) for x in losses]} "
          f"recall@20 {m['Recall(k=20)']!r}", flush=True)
    assert losses[-1] < losses[0], losses
    assert m["Recall(k=20)"] > 0.1, m
    assert np.isfinite(losses).all()
    distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--procs", type=int, default=2,
                        help="the JAX demo's processes: 4 * procs ranks on a "
                        "(2 * procs, 2) mesh")
    parser.add_argument("--port", type=int, default=None,
                        help="the coordinator's port (a free one by default)")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--timeout", type=float, default=240.0,
                        help="seconds each rank may take")
    parser.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    port = args.port or _free_port()
    if args.worker is not None:
        worker(args.procs, args.worker, port, args.device)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch.multihost_demo",
             "--procs", str(args.procs), "--port", str(port), "--device",
             args.device, "--worker", str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for rank in range(4 * args.procs)
    ]
    ok, reports = True, []
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=args.timeout)
            lines = [ln for ln in out.splitlines() if ln.startswith("rank ")]
            reports.append(lines[-1].split(":", 1)[1] if lines else None)
            tail = "\n".join(out.strip().splitlines()[-3:])
            print(f"--- rank {rank} (rc={p.returncode}):\n{tail}", flush=True)
            ok &= p.returncode == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if ok and all(r is not None and r == reports[0] for r in reports):
        print("multihost demo ok", flush=True)
        return 0
    print("multihost demo FAILED", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
