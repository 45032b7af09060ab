"""Command-line entry point: train a collaborative-filtering model from a
YAML config.

The PyTorch counterpart of ``heat_tpu/main.py``:

    python -m heat_tpu_torch.main --config benchmarks/AmazonBooks/config0.yaml \\
        --synthetic 52643,91599 --device cuda

It trains for the configured epochs, evaluates after every epoch e > 0
with e % eval_interval == 0, then runs a final exact ranking evaluation,
printing the same lines as the JAX CLI and ending with one
``{"final_metrics": ...}`` JSON line. ``--synthetic U,I`` trains on a
generated planted-cluster dataset when the benchmark text files are not
available. The device is ``cuda`` unless ``--device`` says otherwise, and
the run fails when CUDA is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import yaml

from heat_tpu_torch.config import load_config
from heat_tpu_torch.data.datasets import load_with_cache
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.train.engine import Engine


def _sync(engine: Engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def main(argv=None) -> dict:
    """Run the CLI; returns the run's record: per-epoch ``losses`` and
    ``epoch_times`` (s), the periodic ``evals`` (each with its epoch and
    seconds), the ``final_metrics`` and their ``final_eval_s``, and the
    ``steps`` taken."""
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
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override a model_config key (YAML-parsed value; repeatable), "
        "e.g. --set learning_rate=0.005",
    )
    args = parser.parse_args(argv)

    overrides = {}
    for item in args.overrides:
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        overrides[key] = yaml.safe_load(value)
    cfg, ds_cfg = load_config(args.config, **overrides)
    if args.epochs is not None:
        cfg.epochs = args.epochs

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
            seed=cfg.seed,
        )
        test_data = load_with_cache(
            test_path,
            max_his=cfg.max_his,
            separator=ds_cfg.separator,
            num_items=train_data.num_items,
            seed=cfg.seed,
        )

    engine = Engine(cfg, train_data, test_data, device=args.device)
    record = {"losses": [], "epoch_times": [], "evals": []}
    while engine.epoch < cfg.epochs:
        _sync(engine)
        t0 = time.perf_counter()
        loss = engine.train_one_epoch()  # reads the loss: waits for the device
        dt = time.perf_counter() - t0
        epoch = engine.epoch - 1
        print(f"epoch: {epoch}; loss: {loss:.6f}; epoch_time: {dt:.3f}s")
        record["losses"].append(loss)
        record["epoch_times"].append(dt)
        # The reference evaluates after finishing epoch e when
        # e % eval_interval == 0 and e > 0.
        if epoch > 0 and epoch % cfg.eval_interval == 0:
            t0 = time.perf_counter()
            metrics = engine.evaluate()
            record["evals"].append(
                {"epoch": epoch, "seconds": time.perf_counter() - t0,
                 "metrics": metrics}
            )
            print(
                "[Metrics] "
                + " - ".join(f"{k}: {v:.6f}" for k, v in metrics.items())
            )

    _sync(engine)
    t0 = time.perf_counter()
    metrics = engine.evaluate()
    record["final_eval_s"] = time.perf_counter() - t0
    record["final_metrics"] = metrics
    record["steps"] = int(engine.state.step)
    print(json.dumps({"final_metrics": metrics}))
    return record


if __name__ == "__main__":
    main()
