"""Command-line entry point: train a collaborative-filtering model from a
YAML config.

The PyTorch counterpart of ``heat_tpu/main.py``:

    python -m heat_tpu_torch.main --config benchmarks/AmazonBooks/config0.yaml \\
        --synthetic 52643,91599 --device cuda

It trains for the configured epochs, evaluates after every epoch e > 0
with e % eval_interval == 0, then runs a final exact ranking evaluation,
printing the same lines as the JAX CLI and ending with one
``{"final_metrics": ...}`` JSON line; ``--export-embeddings PATH`` then
writes the trained model to a portable ``.npz`` (``heat_tpu_torch.export``,
served by ``heat_tpu_torch.serving.Recommender``). ``--synthetic U,I`` trains on a
generated planted-cluster dataset when the benchmark text files are not
available. ``--set KEY=VALUE`` overrides a config key: the headline
configuration of the JAX package's ``bench.py`` is ``--set neg_sampler=1
--set tile_size=512 --set refresh_interval=8192 --set his_refresh=subepoch
--set param_dtype=bfloat16 --set compute_dtype=bfloat16 --set
update_mode=direct``. The device is ``cuda`` unless ``--device`` says otherwise, and
the run fails when CUDA is missing.

On the card each training step is one replay of a CUDA graph captured once
(``Engine.train_one_epoch``). ``--fused-epochs N`` runs up to N epochs a
call of ``Engine.train_epochs`` (one read of their losses), a chunk never
running past the next evaluation; ``--fused-run`` runs the whole schedule,
its evaluations included, through ``Engine.run_epochs_with_eval``. Both
print the same lines with per-epoch times that are chunk (or run)
averages.

The run's lifecycle, as in the JAX CLI: ``--checkpoint-dir DIR`` resumes
from the newest checkpoint there (printing ``resumed from epoch N``) and
saves one after every chunk, once at the end of ``--fused-run``
(``heat_tpu_torch.checkpoint``); ``--log-file PATH`` appends the
``epoch``, ``eval`` and ``final_eval`` events as JSON lines
(``utils/logging.py``); ``--profile-dir DIR`` writes a ``torch.profiler``
trace of the run's second epoch, run alone (``utils/profiling.py``; not
with ``--fused-run``); ``--breakdown`` prints the engine's host-phase
breakdown (``data``, ``f_b``, ``eval``) at the end; ``--no-data-cache``
parses the click files without the ``.npz`` sidecar cache;
``--kernel-launches`` prints the run's kernel launches, steps and
evaluations as one JSON line before the final metrics.

Under a launcher the CLI runs on a mesh of ranks (ROADMAP item 15a), as
the JAX CLI does across processes: ``python -m torch.distributed.run
--standalone --nproc-per-node N -m heat_tpu_torch.main ...`` (add
``--device cpu`` to run on the CPU through gloo). Every rank starts
``torch.distributed`` from the launcher's environment
(``parallel.distributed.initialize``: NCCL when each rank has a card of
its own, gloo when ranks share one or run on the CPU), loads the data and
keeps its user range (``shard_by_user_range``, global ids for training),
synthetic data included: the JAX CLI shards only file data, and given the
whole synthetic data in every process it fails at its first evaluation.
The engine gets ``global_mesh()``, an (N, 1) mesh; rank 0 prints and
logs, and writes the export and the checkpoints, which hold the global
tables. On a mesh the epochs run one by one (``--fused-epochs`` above 1
and ``--fused-run`` raise, ROADMAP item 15b).

``--eval-approx RECALL`` (in (0, 1]) ranks the periodic evaluations with
``exact=False`` at that recall target, as the JAX CLI does; the final
evaluation passes no flag. The JAX package's ``approx_max_k`` approximates
only on a TPU and elsewhere sorts and slices, so every evaluation here
selects exactly, through the two-phase top-k (``evaluation/evaluator.py``
``masked_topk``). Not with ``--fused-run``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import yaml

from heat_tpu_torch.checkpoint import CheckpointManager
from heat_tpu_torch.config import load_config
from heat_tpu_torch.data.datasets import load_with_cache, shard_by_user_range
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.export import export_embeddings
from heat_tpu_torch.parallel import distributed
from heat_tpu_torch.train.engine import Engine
from heat_tpu_torch.utils.logging import MetricsLogger
from heat_tpu_torch.utils.profiling import trace


def _sync(engine: Engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _launches() -> dict:
    """The kernel wrappers' launch counts so far (``ops.cuda``)."""
    from heat_tpu_torch.ops.cuda import gather, scatter, topk

    return {**gather.LAUNCHES, **scatter.LAUNCHES, **topk.LAUNCHES}


def main(argv=None) -> dict:
    """Run the CLI; returns the run's record: per-epoch ``losses`` and
    ``epoch_times`` (s), the periodic ``evals`` (each with its epoch and
    seconds, None under ``--fused-run``, whose epoch times include them),
    the ``final_metrics`` and their ``final_eval_s``, and the ``steps``
    taken."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--config", type=str, required=True, help="YAML config path"
    )
    parser.add_argument(
        "--synthetic",
        type=str,
        default=None,
        metavar="U,I",
        help="train on a synthetic UxI planted-cluster dataset instead of files",
    )
    parser.add_argument(
        "--epochs", type=int, default=None, help="override config epochs"
    )
    parser.add_argument(
        "--device",
        type=str,
        default="cuda",
        help="torch device to train and evaluate on (default: cuda)",
    )
    parser.add_argument(
        "--checkpoint-dir",
        type=str,
        default=None,
        help="resume from the newest checkpoint in this directory, and save "
        "one after every chunk of epochs",
    )
    parser.add_argument(
        "--log-file",
        type=str,
        default=None,
        help="append JSONL training/eval events (loss, lr, epoch time, "
        "metrics)",
    )
    parser.add_argument(
        "--profile-dir",
        type=str,
        default=None,
        help="write a torch.profiler trace of the run's second epoch into "
        "this dir (a Chrome trace, for TensorBoard or Perfetto)",
    )
    parser.add_argument(
        "--export-embeddings",
        type=str,
        default=None,
        metavar="PATH",
        help="after the run, write the trained tables and w0 to PATH as a "
        "portable f32 .npz (heat_tpu_torch.export)",
    )
    parser.add_argument(
        "--breakdown",
        action="store_true",
        help="print the host-phase performance breakdown at the end "
        "(the reference Engine::performance_breakdown)",
    )
    parser.add_argument(
        "--no-data-cache",
        action="store_true",
        help="disable the .npz sidecar cache of parsed click files",
    )
    parser.add_argument(
        "--fused-epochs",
        type=int,
        default=1,
        metavar="N",
        help="run up to N epochs a call of Engine.train_epochs (one read of "
        "their losses); the eval cadence is kept, and per-epoch times "
        "become chunk averages",
    )
    parser.add_argument(
        "--fused-run",
        action="store_true",
        help="run the whole schedule, its periodic evaluations included, "
        "through Engine.run_epochs_with_eval; per-epoch times become the "
        "run's average (evaluations included). Incompatible with "
        "--profile-dir and --eval-approx; checkpoints are written once at "
        "the end",
    )
    parser.add_argument(
        "--eval-approx",
        type=float,
        default=None,
        metavar="RECALL",
        help="rank the periodic (mid-training) evaluations with exact=False "
        "at this recall target, in (0, 1]; the selection stays exact, as "
        "the JAX package's approx_max_k selects off a TPU. The final "
        "evaluation is exact",
    )
    parser.add_argument(
        "--kernel-launches",
        action="store_true",
        help="print, before the final metrics, one JSON line of the run's "
        "kernel launches by wrapper (rank 0's on a mesh), its steps and "
        "evaluations",
    )
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override a model_config key (YAML-parsed value; repeatable), "
        "e.g. --set learning_rate=0.005",
    )
    args = parser.parse_args(argv)
    if args.eval_approx is not None and not 0.0 < args.eval_approx <= 1.0:
        parser.error(f"--eval-approx must be in (0, 1], got {args.eval_approx}")
    if args.fused_run and (args.profile_dir or args.eval_approx is not None):
        parser.error(
            "--fused-run is incompatible with --profile-dir and --eval-approx")

    overrides = {}
    for item in args.overrides:
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        overrides[key] = yaml.safe_load(value)
    cfg, ds_cfg = load_config(args.config, **overrides)
    if args.epochs is not None:
        cfg.epochs = args.epochs

    # Under a launcher: one rank of a mesh (the JAX CLI's processes).
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        distributed.initialize(device=args.device)
    nproc, rank = distributed.process_shard_index()
    if nproc > 1 and (args.fused_run or args.fused_epochs > 1):
        raise NotImplementedError(
            "--fused-epochs and --fused-run on a mesh are not ported to "
            "heat_tpu_torch (ROADMAP.md, modules still to port, item 15b)")

    if args.synthetic:
        num_users, num_items = (int(x) for x in args.synthetic.split(","))
        train_data, test_data = synthetic_click_dataset(
            num_users=num_users,
            num_items=num_items,
            max_his=cfg.max_his,
            seed=cfg.seed,
        )
    else:
        train_path = os.path.join(ds_cfg.data_dir, ds_cfg.train_data)
        test_path = os.path.join(ds_cfg.data_dir, ds_cfg.test_data)
        if not os.path.exists(train_path):
            raise SystemExit(
                f"training data not found: {train_path}\n"
                "Point dataset_config.data_dir at a LightGCN-format dataset "
                "(user item1 item2 ... lines), or pass --synthetic U,I to "
                "train on generated data."
            )
        train_data = load_with_cache(
            train_path, max_his=cfg.max_his, separator=ds_cfg.separator,
            seed=cfg.seed, cache=not args.no_data_cache,
        )
        test_data = load_with_cache(
            test_path,
            max_his=cfg.max_his,
            separator=ds_cfg.separator,
            num_items=train_data.num_items,
            seed=cfg.seed,
            cache=not args.no_data_cache,
        )
    mesh = None
    if nproc > 1:
        # Global ids: the shards feed one user table split over "data".
        train_data = shard_by_user_range(train_data, nproc, rank, rebase=False)
        test_data = shard_by_user_range(test_data, nproc, rank)
        mesh = distributed.global_mesh(device=args.device)
    lead = rank == 0

    def say(*a) -> None:
        if lead:
            print(*a, flush=True)

    engine = Engine(cfg, train_data, test_data, device=args.device, mesh=mesh)
    launches_before = _launches() if args.kernel_launches else None
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        if ckpt.restore_latest(engine) is not None:
            say(f"resumed from epoch {engine.epoch}")
    mlog = MetricsLogger(args.log_file if lead else None)
    # Trace the second epoch of this run, so that the first absorbs the
    # capture (the first, capture included, for a one-epoch run).
    profile_epoch = None
    if args.profile_dir:
        profile_epoch = min(engine.epoch + 1, cfg.epochs - 1)
    record = {"losses": [], "epoch_times": [], "evals": []}

    def report(epoch: int, loss: float, dt: float) -> None:
        say(f"epoch: {epoch}; loss: {loss:.6f}; epoch_time: {dt:.3f}s")
        mlog.log("epoch", epoch=epoch, loss=loss,
                 lr=float(engine.state.lr), epoch_time_s=dt)
        record["losses"].append(loss)
        record["epoch_times"].append(dt)

    def report_eval(epoch: int, metrics: dict, seconds) -> None:
        record["evals"].append(
            {"epoch": epoch, "seconds": seconds, "metrics": metrics}
        )
        say("[Metrics] "
            + " - ".join(f"{k}: {v:.6f}" for k, v in metrics.items()))
        mlog.log("eval", epoch=epoch, **metrics)

    if args.fused_run:
        _sync(engine)
        t0 = time.perf_counter()
        start = engine.epoch
        losses, evals = engine.run_epochs_with_eval(
            cfg.epochs - start, cfg.eval_interval
        )
        dt = (time.perf_counter() - t0) / max(1, len(losses))
        for i, loss in enumerate(losses):
            report(start + i, loss, dt)
            for ev in evals:
                if ev["epoch"] == start + i:  # timed inside the run's average
                    report_eval(ev["epoch"], {k: v for k, v in ev.items()
                                              if k != "epoch"}, None)
        if ckpt is not None:
            ckpt.save(engine)
    fused = max(1, args.fused_epochs)
    while engine.epoch < cfg.epochs:
        start = engine.epoch
        # A chunk ends at the end of training, at the next epoch after
        # which the reference evaluates (e % eval_interval == 0, e > 0),
        # which it may run through but not past, and at the traced epoch,
        # which runs alone.
        next_eval = -(-max(start, 1) // cfg.eval_interval) * cfg.eval_interval
        n = min(fused, cfg.epochs - start, next_eval - start + 1)
        if profile_epoch is not None and start <= profile_epoch < start + n:
            n = 1 if start == profile_epoch else profile_epoch - start
        _sync(engine)
        t0 = time.perf_counter()
        # A mesh runs its epochs one by one (n is 1 there).
        run = ((lambda k: [engine.train_one_epoch()]) if mesh is not None
               else engine.train_epochs)
        if n == 1 and start == profile_epoch:
            with trace(args.profile_dir) if lead else contextlib.nullcontext():
                losses = run(1)
        else:
            losses = run(n)  # reads the losses: waits
        dt = (time.perf_counter() - t0) / n
        for i, loss in enumerate(losses):
            report(start + i, loss, dt)
        if ckpt is not None:
            ckpt.save(engine)
        epoch = engine.epoch - 1
        if epoch > 0 and epoch % cfg.eval_interval == 0:
            t0 = time.perf_counter()
            if args.eval_approx is not None:
                metrics = engine.evaluate(
                    exact=False, recall_target=args.eval_approx)
            else:
                metrics = engine.evaluate()
            report_eval(epoch, metrics, time.perf_counter() - t0)

    _sync(engine)
    t0 = time.perf_counter()
    metrics = engine.evaluate()
    record["final_eval_s"] = time.perf_counter() - t0
    mlog.log("final_eval", epoch=cfg.epochs, **metrics)
    mlog.close()
    record["final_metrics"] = metrics
    record["steps"] = int(engine.state.step)
    if args.export_embeddings:
        export_embeddings(
            engine.unpadded_state(), args.export_embeddings, cfg=cfg,
            mesh=mesh,
        )
        say(f"exported embeddings to {args.export_embeddings}")
    if args.breakdown:
        say(engine.performance_breakdown())
    if launches_before is not None:
        report_k = {
            "kernel_launches": {k: n - launches_before[k]
                                for k, n in _launches().items()},
            "steps": record["steps"],
            "evaluations": len(record["evals"]) + 1,
        }
        say(json.dumps(report_k))
    say(json.dumps({"final_metrics": metrics}))
    return record


if __name__ == "__main__":
    main()
