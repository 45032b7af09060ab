"""A multi-process training and evaluation run on a mesh of ranks: the
port's counterpart of ``scripts/multihost_demo.py`` and its eight
variants.

The JAX demo runs ``--procs`` processes of four CPU devices each on a
``(2 * procs, 2)`` mesh. Here every device is a rank, so the launcher
starts ``4 * procs`` rank processes on that mesh (``--device cpu``
through gloo; on the card every rank shares it through gloo too). Every
rank generates the demo's data (64 users x 126 items: 126 is not a
multiple of 128 x n_model, so the evaluation takes the padded sharded
top-k, not the all-gather fallback) and keeps its user range with global
ids. The variants (``--variant``):

* ``base``: four epochs and the evaluation: plainly, with aggregated
  users, and with ``exact=False``. Each rank checks that the sharded
  evaluation equals the single-process evaluator over the gathered
  tables and the whole test set.
* ``full``: ``base`` with the JAX variant's settings (Adam's slot tables,
  user-attention pools, the tile sampler; lr 0.01), Recall@20 above 0.05
  as the JAX demo holds it.
* ``subepoch``: the reference's default shape (the headline's fast path:
  tile sampler, cached pools, bf16, ``direct``; two sub-epochs) in
  complement scope, as the JAX variant runs it, three epochs. The losses
  fall; the engine's two generators (the numpy one draws the
  permutations on every rank, with no broadcast) and the replicas are
  the same on every rank, probed after the epochs through an all-gather.
* ``visit``: ``visit_order: user`` over a scrambled copy of each data
  shard's stream (``shuffle_mode: none``) trains exactly as an engine fed
  that shard presorted by user in file order, three epochs, and the
  history dedup's maps are in use.
* ``accl``: user-attention pooled every step on the parse-order fixed
  stream (``shuffle_mode: none``), ``train_epochs(3)`` with the history
  dedup's maps in use (``uniq_first`` among them) against
  ``train_epochs(3)`` with the maps forced off, losses within rtol 1e-5;
  then self-attention the same way over two epochs.
* ``fused``: ``train_epochs(3)`` against three ``train_one_epoch`` calls
  of a twin engine, on the shuffled stream and on the fixed one
  (``shuffle_mode: none``, where the history dedup must be in use),
  losses equal bit for bit (the JAX variant: within 1e-6); the fixed
  stream's ``train_epochs(3)`` with the maps forced off within rtol 1e-5.
* ``serve``: three epochs, then ``Recommender.from_engine`` (collective:
  the tables, the train pairs and the histories gathered, every rank
  serving the whole model): a request equals the rows of
  ``recommend_all``, aggregated and cold requests have their shapes,
  every rank serves the same ids, and the export, loaded into a plain
  ``Recommender`` over the whole data, serves them again.
* ``checkpoint``: ``train_epochs(4)`` against two epochs, a save, a new
  engine restored from it and two more epochs: the losses within 1e-6.

Each rank prints one line; the launcher checks that every rank exits
cleanly and reports the same one.

    python -m heat_tpu_torch.multihost_demo --procs 2 [--variant base] [--device cpu]

prints ``multihost demo ok`` at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile

DEMO_DATA = dict(num_users=64, num_items=126, clicks_per_user=12, max_his=6,
                 seed=7)
DEMO_CFG = dict(emb_dim=8, num_negs=4, max_his=6, l_r=0.05, batch_size=32,
                seed=3, metrics=["Recall(k=20)"])
# The reference's default shape at the demo's size, in complement scope.
SUBEPOCH_CFG = dict(DEMO_CFG, neg_sampler=1, tile_size=32, refresh_interval=256,
                    his_refresh="subepoch", param_dtype="bfloat16",
                    compute_dtype="bfloat16", update_mode="direct",
                    num_subepochs=2, subepoch_neg_scope="complement")
# The JAX "full" variant (scripts/multihost_demo.py:72-83).
FULL_CFG = dict(DEMO_CFG, optimizer="adam", aggregator="user_attention",
                neg_sampler=1, tile_size=32, refresh_interval=128,
                his_refresh="subepoch", l_r=0.01)
VARIANTS = ("base", "full", "checkpoint", "fused", "subepoch", "serve",
            "accl", "visit")


def _same_everywhere(value) -> None:
    """Raise AssertionError unless every rank of the job holds ``value``."""
    import torch.distributed as dist

    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    if any(v != seen[0] for v in seen):
        raise AssertionError(f"the ranks differ: {seen}")


def _digest(t) -> str:
    import hashlib

    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def subepoch_variant(rank, mesh, local_train, local_test, device) -> None:
    """The default shape in complement scope on the mesh (module docstring)."""
    import numpy as np
    import torch.distributed as dist

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.train.engine import Engine

    engine = Engine(CFConfig(**SUBEPOCH_CFG), local_train, local_test,
                    device=device, mesh=mesh)
    losses = [engine.train_one_epoch() for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    # Identical consumption on every rank leaves both generators equal.
    _same_everywhere((engine._np_rng.integers(0, 2**31, 8).tolist(),
                      _digest(engine.generator.get_state())))
    st = engine.state
    groups = ((st.user_emb, "model"), (st.item_emb, "data"), (st.w0, None))
    for table, axis in groups:
        group = [None] * (dist.get_world_size() if axis is None
                          else mesh.axis_size(axis))
        dist.all_gather_object(group, _digest(table),
                               group=None if axis is None else mesh._groups[axis])
        assert len(set(group)) == 1, ("replicas differ", axis, group)
    print(f"rank {rank}: subepoch losses {[float(x) for x in losses]}",
          flush=True)


def visit_variant(rank, mesh, local_train, local_test, device) -> None:
    """``visit_order: user`` against the presorted file order (module
    docstring)."""
    import dataclasses

    import numpy as np

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.train.engine import Engine

    # One scramble a data shard: the ranks of a model group hold one shard.
    rng = np.random.default_rng(13 + mesh.data_index)
    pairs = np.asarray(local_train.pairs)
    scrambled = dataclasses.replace(local_train,
                                    pairs=pairs[rng.permutation(len(pairs))])
    sp = np.asarray(scrambled.pairs)
    presorted = dataclasses.replace(
        scrambled, pairs=sp[np.argsort(sp[:, 0], kind="stable")])
    auto = Engine(CFConfig(**DEMO_CFG, shuffle_mode="none", visit_order="user"),
                  scrambled, local_test, device=device, mesh=mesh)
    got = [auto.train_one_epoch() for _ in range(3)]
    assert auto._dedup_cache is not None and auto._dedup_cache[2] is not None, (
        "the history dedup is idle")
    filed = Engine(CFConfig(**DEMO_CFG, shuffle_mode="none"), presorted,
                   local_test, device=device, mesh=mesh)
    want = [filed.train_one_epoch() for _ in range(3)]
    assert got == want, (got, want)
    print(f"rank {rank}: visit losses {got} == presorted", flush=True)


def accl_variant(rank, mesh, local_train, local_test, device) -> None:
    """The attention history dedup against the maps forced off (module
    docstring)."""
    import numpy as np

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.train.engine import Engine

    def epochs(kind, n, dedup):
        engine = Engine(CFConfig(**DEMO_CFG, shuffle_mode="none",
                                 his_refresh="step", aggregator=kind),
                        local_train, local_test, device=device, mesh=mesh)
        if not dedup:
            engine._history_dedup = lambda *a, **k: None
        losses = engine.train_epochs(n)
        maps = engine._dedup_cache[2] if engine._dedup_cache else None
        return losses, maps

    out = {}
    for kind, n in (("user_attention", 3), ("self_attention", 2)):
        on, maps = epochs(kind, n, True)
        assert maps is not None and maps[2] is not None, (
            f"{kind}: the history dedup is idle")
        off, _ = epochs(kind, n, False)
        assert np.allclose(on, off, rtol=1e-5, atol=0), (kind, on, off)
        out[kind] = on
    print(f"rank {rank}: accl dedup ok, user_attention {out['user_attention']}"
          f" == off, self_attention {out['self_attention']} == off", flush=True)


def fused_variant(rank, mesh, local_train, local_test, device) -> None:
    """``train_epochs`` against the epochs one by one (module docstring)."""
    import numpy as np

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.train.engine import Engine

    def engine(**kw):
        return Engine(CFConfig(**DEMO_CFG, **kw), local_train, local_test,
                      device=device, mesh=mesh)

    out = {}
    for mode in ("epoch", "none"):
        e_seq = engine(shuffle_mode=mode)
        seq = [e_seq.train_one_epoch() for _ in range(3)]
        e_fused = engine(shuffle_mode=mode)
        fused = e_fused.train_epochs(3)
        assert fused == seq, (mode, fused, seq)
        out[mode] = fused
    assert e_fused._dedup_cache is not None and e_fused._dedup_cache[2] is not None, (
        "the history dedup is idle on the fixed stream")
    e_off = engine(shuffle_mode="none")
    e_off._history_dedup = lambda *a, **k: None
    off = e_off.train_epochs(3)
    assert np.allclose(off, out["none"], rtol=1e-5, atol=0), (off, out["none"])
    print(f"rank {rank}: fused == sequential losses {out['epoch']} "
          f"(epoch shuffle) {out['none']} (fixed)", flush=True)


def serve_variant(rank, mesh, local_train, local_test, device, train,
                  workdir) -> None:
    """Serving and the export from the live mesh engine (module
    docstring)."""
    import numpy as np

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.export import export_embeddings, load_embeddings
    from heat_tpu_torch.models.state import state_from_numpy
    from heat_tpu_torch.serving import Recommender
    from heat_tpu_torch.train.engine import Engine

    engine = Engine(CFConfig(**DEMO_CFG), local_train, local_test,
                    device=device, mesh=mesh)
    losses = [engine.train_one_epoch() for _ in range(3)]
    assert np.isfinite(losses).all(), losses
    rec = Recommender.from_engine(engine)
    assert rec.state.user_emb.shape[0] == train.num_users
    assert rec.state.item_emb.shape[0] == train.num_items
    uids = [0, 7, 33, 63]  # every data shard's users
    got = rec.recommend(uids, 10)
    assert np.array_equal(got, rec.recommend_all(10)[np.asarray(uids)]), (
        "the request path differs from the whole-table ranking")
    assert rec.recommend(uids, 10, aggregate_users=True).shape == (4, 10)
    assert rec.recommend_cold([[1, 2, 3], [5]], 10).shape == (2, 10)
    _same_everywhere(np.asarray(got).tolist())
    path = os.path.join(workdir, "export.npz")
    export_embeddings(engine.unpadded_state(), path, cfg=engine.cfg, mesh=mesh)
    z = load_embeddings(path)
    assert z["user_emb"].shape == (train.num_users, DEMO_CFG["emb_dim"])
    oracle = Recommender(
        state_from_numpy(z["user_emb"], z["item_emb"], z["w0"], lr=0.0,
                         step=0, device=engine.device),
        engine.cfg, seen_pairs=train.pairs, his_items=train.his_items,
        his_masks=train.masks)
    assert np.array_equal(oracle.recommend(uids, 10), got), (
        "the exported model serves other ids")
    print(f"rank {rank}: serve ok, request == whole-table rows, ranks agree, "
          f"export served alike (losses {losses})", flush=True)


def checkpoint_variant(rank, mesh, local_train, local_test, device,
                       workdir) -> None:
    """Resume from a checkpoint mid-run (module docstring)."""
    from heat_tpu_torch.checkpoint import CheckpointManager
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.train.engine import Engine

    def engine():
        return Engine(CFConfig(**DEMO_CFG), local_train, local_test,
                      device=device, mesh=mesh)

    ref = engine().train_epochs(4)
    first = engine()
    half = [first.train_one_epoch() for _ in range(2)]
    CheckpointManager(os.path.join(workdir, "ckpt")).save(first)
    resumed = engine()
    assert CheckpointManager(os.path.join(workdir, "ckpt")).restore_latest(
        resumed) == 2
    got = half + [resumed.train_one_epoch() for _ in range(2)]
    assert all(abs(a - b) < 1e-6 for a, b in zip(ref, got)), (ref, got)
    print(f"rank {rank}: checkpoint-resume losses match {got}", flush=True)


def worker(procs: int, rank: int, port: int, device: str,
           variant: str = "base", workdir: str = "") -> None:
    """One rank: the variant's training and its checks."""
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
    if variant not in ("base", "full"):
        run = {"subepoch": subepoch_variant, "visit": visit_variant,
               "accl": accl_variant, "fused": fused_variant,
               "serve": lambda *a: serve_variant(*a, train, workdir),
               "checkpoint": lambda *a: checkpoint_variant(*a, workdir),
               }[variant]
        run(rank, mesh, local_train, local_test, device)
        distributed.shutdown()
        return
    cfg = CFConfig(**(FULL_CFG if variant == "full" else DEMO_CFG))
    engine = Engine(cfg, local_train, local_test, device=device, mesh=mesh)
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
    assert m["Recall(k=20)"] > (0.1 if variant == "base" else 0.05), m
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
    parser.add_argument("--variant", default="base", choices=VARIANTS,
                        help="what the ranks run (module docstring)")
    parser.add_argument("--timeout", type=float, default=240.0,
                        help="seconds each rank may take")
    parser.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--workdir", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    port = args.port or _free_port()
    if args.worker is not None:
        worker(args.procs, args.worker, port, args.device, args.variant,
               args.workdir)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # The export and the checkpoints of the serve and checkpoint variants.
    workdir = tempfile.mkdtemp(prefix="heat_demo_")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch.multihost_demo",
             "--procs", str(args.procs), "--port", str(port), "--device",
             args.device, "--variant", args.variant, "--worker", str(rank),
             "--workdir", workdir],
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
        shutil.rmtree(workdir, ignore_errors=True)
    if ok and all(r is not None and r == reports[0] for r in reports):
        print("multihost demo ok", flush=True)
        return 0
    print("multihost demo FAILED", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
