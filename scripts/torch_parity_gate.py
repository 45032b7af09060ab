"""The JAX half of the full-scale Recall@20 gate of the PyTorch port.

Runs ``heat_tpu.main``'s schedule (5 epochs, evaluations after epochs 2
and 4, a final exact evaluation) for ``benchmarks/AmazonBooks/config0.yaml``
on the synthetic 52,643 x 91,599 planted-cluster data (data seed = the
config's seed, 2022), in config0 and in every configuration the port's
``chip_smoke.py`` trains (``RUNS``: the JAX ``bench.py`` headline, the
reference's default shape, config0 with self-attention, bench.py's ACCL
and CCL rows, complement scope), config0 again at two other engine
seeds and the (4, 1) "full" run at two (``SEED_RUNS``: the JAX
package's own spread), and config0, the
headline, the default shape, the settings of the JAX multihost demo's
"full" variant, config0 with self-attention and config0 with both tables
on the sort-dedup update on a (4, 1) mesh of four JAX processes
(``MESH_RUNS``: on 52,644 x 91,599, one user more, since the JAX engine
needs the data axis to divide the users; each such run records its own
geometry and checksums), and writes
``PARITY_TORCH.json`` at the root of the repository: the JAX version, the
geometry, the train and test pair counts with a SHA-256 of each (int32,
row-major), each run's overrides, band (``heat_tpu_torch.parity.BANDS``),
full-precision final metrics and seconds, and the seed spread.
``chip_smoke.py`` (the card's half, which has no JAX) reads the file,
checks that its own data has the same checksums and holds its final
metrics to the recorded ones (``heat_tpu_torch.parity``).

    JAX_PLATFORMS=cpu python scripts/torch_parity_gate.py [--runs config0,headline] [--torch]

A mesh run starts one worker process a rank (this script with
``--mesh-worker``): each initializes ``jax.distributed`` over localhost
with one CPU device, takes its ``shard_by_user_range`` of the synthetic
data (train with global ids, test rebased) and runs ``heat_tpu.main`` on
it; the JAX CLI itself shards only file data (``heat_tpu/main.py``
l.150-186), and given the whole synthetic data in every process it fails
at its first evaluation.

``--runs`` picks the runs (each is merged into an existing file, so they
can be made one at a time; ``--out`` writes another file). ``--torch``
also runs the port's CLI on the CPU on the same data and records its
metrics beside the JAX ones (``torch_cpu``), a check that needs no card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
SYNTHETIC = (52643, 91599)
# The JAX bench.py's headline (bench.py:245-251) and the reference's
# default shape, the headline with two sub-epochs (cf_config.py:7).
HEADLINE = ["neg_sampler=1", "tile_size=512", "refresh_interval=8192",
            "his_refresh=subepoch", "param_dtype=bfloat16",
            "compute_dtype=bfloat16", "update_mode=direct"]
DEFAULT_SHAPE = HEADLINE + ["num_subepochs=2"]
# Each run: its overrides of config0 (the CLI's --set). accl_user_s,
# accl_self_s and headline_ccl are bench.py's rows of those names
# (bench.py:602-613, 642-647) on config0's schedule.
RUNS = {
    "config0": [],
    "headline": HEADLINE,
    "default_shape": DEFAULT_SHAPE,
    "config0_self_attention": ["aggregator=self_attention"],
    "accl_user_s": HEADLINE + ["aggregator=user_attention"],
    "accl_self_s": [kv for kv in HEADLINE if not kv.startswith("his_refresh=")]
    + ["his_refresh=step", "aggregator=self_attention"],
    "headline_ccl": HEADLINE + ["loss=CosineContrastiveLoss"],
    "complement": DEFAULT_SHAPE + ["subepoch_neg_scope=complement"],
}
# The JAX package's own spread: a run again at other engine seeds
# (``Engine(seed=)``) on the same data (whose seed stays the config's);
# a mesh run's repeats run on its mesh.
SEED_RUNS = {"config0_seed2023": ("config0", 2023),
             "config0_seed2024": ("config0", 2024),
             "full_mesh41_seed2023": ("full_mesh41", 2023),
             "full_mesh41_seed2024": ("full_mesh41", 2024)}
# Runs on a mesh of JAX processes: (n_data, n_model) and the synthetic
# geometry (users, items). Each is also a RUNS entry (its overrides).
MESH_RUNS = {"config0_mesh41": ((4, 1), (52644, 91599)),
             "headline_mesh41": ((4, 1), (52644, 91599)),
             "default_shape_mesh41": ((4, 1), (52644, 91599)),
             "full_mesh41": ((4, 1), (52644, 91599)),
             "config0_self_attention_mesh41": ((4, 1), (52644, 91599))}
RUNS["config0_mesh41"] = []
RUNS["headline_mesh41"] = HEADLINE
RUNS["default_shape_mesh41"] = DEFAULT_SHAPE
# The settings of the JAX multihost demo's "full" variant
# (scripts/multihost_demo.py:72-83: Adam, user-attention pools, the tile
# sampler) at config0's widths, tile and learning rate, in f32.
RUNS["full_mesh41"] = ["optimizer=adam", "aggregator=user_attention",
                       "neg_sampler=1", "tile_size=512",
                       "refresh_interval=8192", "his_refresh=subepoch"]
RUNS["config0_self_attention_mesh41"] = RUNS["config0_self_attention"]
# config0 on (4, 1) with both tables on the sort-dedup update: the JAX
# package picks it by the global table's rows, so a threshold of 8,192
# rows (``heat_tpu.train.scatter.DENSE_ROWS_THRESHOLD``, set in every
# rank) sends both tables there; config0's schedule.
MESH_RUNS["config0_sorted_mesh41"] = ((4, 1), (52644, 91599))
RUNS["config0_sorted_mesh41"] = []
DENSE_ROWS = {"config0_sorted_mesh41": 8192}


class _Tee(io.TextIOBase):
    """Writes to the terminal and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.out.flush()
        return self.buf.write(s)


def _argv(overrides, synthetic=SYNTHETIC) -> list[str]:
    argv = ["--config", os.path.join(ROOT, CONFIG0),
            "--synthetic", ",".join(map(str, synthetic))]
    for kv in overrides:
        argv += ["--set", kv]
    return argv


def _seeded_engine(jax_main, engine_seed):
    """The JAX CLI's engine class, seeded with ``engine_seed`` in place of
    the config's seed when one is given."""
    if engine_seed is None:
        return jax_main.Engine
    return functools.partial(jax_main.Engine, seed=engine_seed)


def run_jax(overrides, engine_seed=None) -> dict:
    """One run of the JAX CLI on the CPU: its final metrics and seconds.
    ``engine_seed`` seeds the CLI's engine in place of the config's seed
    (the data keeps the config's)."""
    from unittest import mock

    from heat_tpu import main as jax_main

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), mock.patch.object(
            jax_main, "Engine", _seeded_engine(jax_main, engine_seed)):
        jax_main.main(_argv(overrides))
    seconds = time.perf_counter() - t0
    last = [ln for ln in tee.buf.getvalue().splitlines()
            if ln.startswith('{"final_metrics"')][-1]
    return {"final_metrics": json.loads(last)["final_metrics"],
            "seconds": seconds}


def mesh_worker(rank: int, world: int, port: int, name: str,
                engine_seed=None) -> None:
    """One rank of a mesh run: ``jax.distributed`` over localhost with one
    CPU device, then the JAX CLI on this rank's user shard of the
    synthetic data (the CLI shards only file data), its engine seeded
    with ``engine_seed`` when one is given. Rank 0's output holds the
    run's final metrics."""
    from unittest import mock

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=world, process_id=rank)
    from heat_tpu import main as jax_main
    from heat_tpu.data.datasets import shard_by_user_range
    from heat_tpu.data.synthetic import synthetic_click_dataset

    def sharded(**kw):
        train, test = synthetic_click_dataset(**kw)
        return (shard_by_user_range(train, world, rank, rebase=False),
                shard_by_user_range(test, world, rank))

    (n_data, n_model), synthetic = MESH_RUNS[name]
    if (n_data * n_model, n_model) != (world, 1):
        raise SystemExit(f"{name}: the JAX CLI's mesh is (processes, 1)")
    if name in DENSE_ROWS:
        from heat_tpu.train import scatter

        scatter.DENSE_ROWS_THRESHOLD = DENSE_ROWS[name]
    with mock.patch.object(jax_main, "synthetic_click_dataset", sharded), \
            mock.patch.object(jax_main, "Engine",
                              _seeded_engine(jax_main, engine_seed)):
        jax_main.main(_argv(RUNS[name], synthetic))
    jax.distributed.shutdown()


def run_jax_mesh(name: str, engine_seed=None) -> dict:
    """A mesh run: one worker process a rank (each engine seeded with
    ``engine_seed`` when one is given, as :func:`run_jax`); rank 0's final
    metrics and the run's seconds."""
    import socket
    import subprocess

    (n_data, n_model), _ = MESH_RUNS[name]
    world = n_data * n_model
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               HEAT_TPU_NO_COMPILATION_CACHE="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker",
         f"{rank},{world},{port}", "--runs", name]
        + ([] if engine_seed is None else ["--engine-seed", str(engine_seed)]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]
    outs = [p.communicate()[0] for p in procs]
    seconds = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(f"{name}: rank {rank} exited {p.returncode}:\n{out}")
    print(outs[0], flush=True)
    finals = [json.loads([ln for ln in out.splitlines()
                          if ln.startswith('{"final_metrics"')][-1])
              for out in outs]
    if any(f != finals[0] for f in finals):
        raise SystemExit(f"{name}: the ranks' final metrics differ: {finals}")
    return {"final_metrics": finals[0]["final_metrics"], "seconds": seconds}


def run_torch_cpu(overrides) -> dict:
    """The port's CLI on the CPU on the same data."""
    from heat_tpu_torch import main as torch_main

    t0 = time.perf_counter()
    record = torch_main.main(_argv(overrides) + ["--device", "cpu"])
    return {"final_metrics": record["final_metrics"],
            "losses": record["losses"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", default="config0,headline",
                        help="comma-separated runs among "
                        + ", ".join([*RUNS, *SEED_RUNS]))
    parser.add_argument("--out", default=os.path.join(ROOT, "PARITY_TORCH.json"))
    parser.add_argument("--torch", action="store_true",
                        help="also run the port's CLI on the CPU")
    parser.add_argument("--mesh-worker", default=None, metavar="RANK,WORLD,PORT",
                        help=argparse.SUPPRESS)
    parser.add_argument("--engine-seed", type=int, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    names = [n for n in args.runs.split(",") if n]
    if args.mesh_worker:
        rank, world, port = map(int, args.mesh_worker.split(","))
        mesh_worker(rank, world, port, names[0], args.engine_seed)
        return
    unknown = sorted(set(names) - set(RUNS) - set(SEED_RUNS))
    if unknown:
        parser.error(f"unknown runs {unknown}")

    import jax

    # The container may pin another platform at import: force the CPU.
    jax.config.update("jax_platforms", "cpu")
    from heat_tpu.config import load_config
    from heat_tpu.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset as port_data
    from heat_tpu_torch.parity import BANDS, data_fingerprint, seed_spread

    cfg, _ = load_config(os.path.join(ROOT, CONFIG0))
    geometry = {"num_users": SYNTHETIC[0], "num_items": SYNTHETIC[1],
                "max_his": cfg.max_his, "seed": cfg.seed}
    fingerprint = data_fingerprint(*synthetic_click_dataset(**geometry))
    port_fingerprint = data_fingerprint(*port_data(**geometry))
    if port_fingerprint != fingerprint:
        raise SystemExit(
            f"the port's synthetic data differs: {port_fingerprint} against "
            f"{fingerprint}")

    record = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            record = json.load(f)
        if record.get("sha256") not in (None, fingerprint["sha256"]):
            raise SystemExit(f"{args.out} holds runs on other data")
    record.update({
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_parity_gate.py",
        "jax_version": jax.__version__,
        "platform": jax.devices()[0].platform,
        "config": CONFIG0,
        "synthetic": geometry,
        **fingerprint,
    })
    record.setdefault("runs", {})

    def write():
        for name, run in record["runs"].items():
            if name in BANDS:
                run["band"] = BANDS[name]
        if any(r.get("repeats") for r in record["runs"].values()):
            record["seed_spread"] = seed_spread(record)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")

    def mesh_entry(name, engine_seed=None):
        (n_data, n_model), (users, items) = MESH_RUNS[name]
        geom = dict(geometry, num_users=users, num_items=items)
        return {"overrides": RUNS[name], "mesh": [n_data, n_model],
                "synthetic": geom,
                **({"dense_rows_threshold": DENSE_ROWS[name]}
                   if name in DENSE_ROWS else {}),
                **data_fingerprint(*synthetic_click_dataset(**geom)),
                **run_jax_mesh(name, engine_seed)}

    for name in names:
        print(f"== JAX {name}", flush=True)
        if name in MESH_RUNS:
            record["runs"][name] = mesh_entry(name)
            write()
            continue
        if name in SEED_RUNS:
            run, seed = SEED_RUNS[name]
            record["runs"][name] = {
                "repeats": run, "engine_seed": seed,
                **(mesh_entry(run, seed) if run in MESH_RUNS else {
                    "overrides": RUNS[run],
                    **run_jax(RUNS[run], engine_seed=seed)})}
            write()
            continue
        record["runs"][name] = {"overrides": RUNS[name], **run_jax(RUNS[name])}
        write()
        if args.torch:
            print(f"== port {name} (CPU)", flush=True)
            record["runs"][name]["torch_cpu"] = run_torch_cpu(RUNS[name])
            write()
    print(json.dumps(record["runs"], sort_keys=True))


if __name__ == "__main__":
    # The JAX package's persistent compilation cache writes under the home
    # directory; the gate runs without it. Set here, not at import: a test
    # that imports this module must leave its process's environment alone.
    os.environ.setdefault("HEAT_TPU_NO_COMPILATION_CACHE", "1")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
