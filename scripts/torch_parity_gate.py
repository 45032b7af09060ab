"""The JAX half of the full-scale Recall@20 gate of the PyTorch port.

Runs ``heat_tpu.main``'s schedule (5 epochs, evaluations after epochs 2
and 4, a final exact evaluation) for ``benchmarks/AmazonBooks/config0.yaml``
on the synthetic 52,643 x 91,599 planted-cluster data (data seed = the
config's seed, 2022), in config0 and in every configuration the port's
``chip_smoke.py`` trains (``RUNS``: the JAX ``bench.py`` headline, the
reference's default shape, config0 with self-attention, bench.py's ACCL
and CCL rows, complement scope), and config0 again at two other engine
seeds (``SEED_RUNS``: the JAX package's own spread), and writes
``PARITY_TORCH.json`` at the root of the repository: the JAX version, the
geometry, the train and test pair counts with a SHA-256 of each (int32,
row-major), each run's overrides, band (``heat_tpu_torch.parity.BANDS``),
full-precision final metrics and seconds, and the seed spread.
``chip_smoke.py`` (the card's half, which has no JAX) reads the file,
checks that its own data has the same checksums and holds its final
metrics to the recorded ones (``heat_tpu_torch.parity``).

    JAX_PLATFORMS=cpu python scripts/torch_parity_gate.py [--runs config0,headline] [--torch]

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
# The JAX package's own spread: config0 again at other engine seeds
# (``Engine(seed=)``) on the same data (whose seed stays the config's).
SEED_RUNS = {"config0_seed2023": ("config0", 2023),
             "config0_seed2024": ("config0", 2024)}


class _Tee(io.TextIOBase):
    """Writes to the terminal and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.out.flush()
        return self.buf.write(s)


def _argv(overrides) -> list[str]:
    argv = ["--config", os.path.join(ROOT, CONFIG0),
            "--synthetic", ",".join(map(str, SYNTHETIC))]
    for kv in overrides:
        argv += ["--set", kv]
    return argv


def run_jax(overrides, engine_seed=None) -> dict:
    """One run of the JAX CLI on the CPU: its final metrics and seconds.
    ``engine_seed`` seeds the CLI's engine in place of the config's seed
    (the data keeps the config's)."""
    from unittest import mock

    from heat_tpu import main as jax_main

    engine = jax_main.Engine
    if engine_seed is not None:
        engine = functools.partial(engine, seed=engine_seed)
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), mock.patch.object(
            jax_main, "Engine", engine):
        jax_main.main(_argv(overrides))
    seconds = time.perf_counter() - t0
    last = [ln for ln in tee.buf.getvalue().splitlines()
            if ln.startswith('{"final_metrics"')][-1]
    return {"final_metrics": json.loads(last)["final_metrics"],
            "seconds": seconds}


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
    args = parser.parse_args(argv)
    names = [n for n in args.runs.split(",") if n]
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

    for name in names:
        print(f"== JAX {name}", flush=True)
        if name in SEED_RUNS:
            run, seed = SEED_RUNS[name]
            record["runs"][name] = {"overrides": RUNS[run], "repeats": run,
                                    "engine_seed": seed,
                                    **run_jax(RUNS[run], engine_seed=seed)}
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
