"""Smoke check of the PyTorch port (heat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. environment: torch and CUDA versions, the card's name and power limit,
   TF32 off for f32 matmuls;
2. build: the CUDA kernels of heat_tpu_torch/csrc with nvcc;
3. kernels: K1 (history mean), K2 (row gather) and K3 (row scatter-add)
   against their plain PyTorch versions at the config0 step's shapes, with
   median times over 30 runs; then one training step on the card against
   the same step on the CPU at a small size;
4. main path: the CLI (heat_tpu_torch.main) on AmazonBooks config0 at full
   width on a synthetic 52,643 x 91,599 planted-cluster dataset: first
   with 0 epochs (the untrained model's metrics), then the whole 5-epoch
   schedule with its evaluations, with every kernel's launch count read
   around that run;
5. the kernels' JSON line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Fails without a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
SYNTHETIC = "52643,91599"  # AmazonBooks users x items
NUM_USERS, NUM_ITEMS = 52643, 91599
BATCH, MAX_HIS, NUM_NEGS, DIM = 8192, 100, 16, 64
RUNS = 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def median_ms(fn) -> float:
    """Median of RUNS CUDA-event timings of fn(), after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(dev) -> list[dict]:
    """Each kernel against its plain version at the config0 step's shapes."""
    import torch

    from heat_tpu_torch.ops.cuda import gather, scatter

    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(NUM_ITEMS, DIM, generator=g, device=dev)

    def ids(m, hi):
        return torch.randint(0, hi, (m,), generator=g, device=dev,
                             dtype=torch.int32)

    results = []

    # K2: the step's 8192 + 131,072 item-row reads; timed at the negatives.
    neg_ids = ids(BATCH * NUM_NEGS, NUM_ITEMS)
    got = gather.gather_rows(table, neg_ids)
    want = gather.gather_rows_ref(table, neg_ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 gather_rows disagrees with its plain version")
    results.append({
        "name": "gather_rows", "route": "cuda",
        "source": "heat_tpu_torch/csrc/gather.cu",
        "replaces": "heat_tpu/ops/pallas/gather.py:80",
        "max_abs_err": float((got - want).abs().max()),
        "ms": median_ms(lambda: gather.gather_rows(table, neg_ids)),
        "plain_ms": median_ms(lambda: gather.gather_rows_ref(table, neg_ids)),
        "shape": f"({NUM_ITEMS}, {DIM}) f32 table, {BATCH * NUM_NEGS} ids",
    })

    # K1: B = 8192 histories of H = 100, lengths uniform in [0, 100].
    his = ids(BATCH * MAX_HIS, NUM_ITEMS).reshape(BATCH, MAX_HIS)
    lens = ids(BATCH, MAX_HIS + 1)
    got = gather.history_mean_gather(table, his, lens)
    want = gather.history_mean_gather_ref(table, his, lens)
    torch.cuda.synchronize()
    # Sequential vs blocked f32 sums: rtol 1e-5, atol 1e-6.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    results.append({
        "name": "history_mean_gather", "route": "cuda",
        "source": "heat_tpu_torch/csrc/gather.cu",
        "replaces": "heat_tpu/ops/pallas/gather.py:141",
        "max_abs_err": float((got - want).abs().max()),
        "ms": median_ms(lambda: gather.history_mean_gather(table, his, lens)),
        "plain_ms": median_ms(
            lambda: gather.history_mean_gather_ref(table, his, lens)
        ),
        "shape": f"({NUM_ITEMS}, {DIM}) f32 table, ({BATCH}, {MAX_HIS}) ids",
    })

    # K3: the item update's 8192 + 131,072 ids, with repeats and about 1%
    # sentinels (id == N), into a zeroed accumulator.
    m = BATCH * (1 + NUM_NEGS)
    sc_ids = ids(m, NUM_ITEMS)
    sentinel = torch.rand(m, generator=g, device=dev) < 0.01
    sc_ids = torch.where(sentinel, NUM_ITEMS, sc_ids).to(torch.int32)
    deltas = torch.randn(m, DIM, generator=g, device=dev)
    acc = torch.zeros(NUM_ITEMS, DIM, device=dev)
    got = scatter.scatter_add_rows(acc.clone(), sc_ids, deltas)
    want = scatter.scatter_add_rows_ref(acc.clone(), sc_ids, deltas)
    torch.cuda.synchronize()
    # Atomics land in a different order every run: rtol 1e-5, atol 1e-6.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    results.append({
        "name": "scatter_add_rows", "route": "cuda",
        "source": "heat_tpu_torch/csrc/scatter.cu",
        "replaces": "heat_tpu/ops/pallas/scatter.py:89",
        "max_abs_err": float((got - want).abs().max()),
        "ms": median_ms(lambda: scatter.scatter_add_rows(acc, sc_ids, deltas)),
        "plain_ms": median_ms(
            lambda: scatter.scatter_add_rows_ref(acc, sc_ids, deltas)
        ),
        "shape": f"({NUM_ITEMS}, {DIM}) f32 accumulator, {m} ids",
    })
    return results


def check_step_against_cpu(dev) -> float:
    """One train_step on the card (kernels) against the same step on the
    CPU (plain versions): small shapes, repeated ids, a weight-0 tail and
    the same negatives. Returns the largest table difference."""
    import numpy as np
    import torch

    import heat_tpu_torch.train.train_step as ts
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import state_from_numpy, state_to_numpy
    from heat_tpu_torch.train.samplers import (
        NegSample,
        SamplerState,
        init_sampler_state,
    )

    rng = np.random.default_rng(1)
    u, i, h, b, k, d = 40, 90, 8, 48, 4, 64
    cfg = CFConfig(emb_dim=d, num_users=u, num_items=i, max_his=h,
                   num_negs=k, batch_size=b, l_r=0.05, clip_val=0.02)
    users = rng.integers(0, u, b).astype(np.int32)
    pos = rng.integers(0, i, b).astype(np.int32)
    users[:6], pos[6:12] = 3, 5
    weight = np.ones(b, np.float32)
    weight[-7:] = 0.0
    his = rng.integers(0, i, (u, h)).astype(np.int32)
    masks = rng.integers(0, h + 1, u).astype(np.int32)
    negs = rng.integers(0, i, (b, k)).astype(np.int32)
    init = [(rng.normal(size=s) * 0.01).astype(np.float32)
            for s in ((u, d), (i, d), (d, d))]

    def fixed(generator, sstate, pos_ids, _cfg, real=None):
        return (NegSample(torch.from_numpy(negs).to(pos_ids.device)),
                SamplerState(sstate.iterations + pos_ids.shape[0]))

    out = []  # (tables, loss) on the card, then on the CPU
    orig = ts.sample_negatives
    ts.sample_negatives = fixed
    try:
        for device in (dev, torch.device("cpu")):
            def put(x):
                return torch.from_numpy(x).to(device)

            state, _, loss = ts.train_step(
                state_from_numpy(*init, lr=cfg.l_r, step=0, device=device),
                init_sampler_state(cfg, device),
                None,
                ts.Batch(put(users), put(pos), put(weight)),
                put(his), put(masks), cfg,
            )
            out.append((state_to_numpy(state), float(loss)))
    finally:
        ts.sample_negatives = orig
    (card, card_loss), (cpu, cpu_loss) = out
    worst = 0.0
    for name in ("user_emb", "item_emb", "w0"):
        np.testing.assert_allclose(
            card[name], cpu[name], rtol=1e-5, atol=1e-6,
            err_msg=f"step on the card vs the CPU: {name}",
        )
        worst = max(worst, float(np.abs(card[name] - cpu[name]).max()))
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # Outside a checkout this import fails, and the script with it.
    from heat_tpu_torch import main as cli
    from heat_tpu_torch.ops.cuda import _build, gather, scatter
    from heat_tpu_torch.train.engine import set_f32_matmul_precision

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(card)
    set_f32_matmul_precision()

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    kernels = check_kernels(dev)
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}"
              f" ms), max_abs_err {k['max_abs_err']:.3g}, {k['shape']}")
    print(f"train_step card vs CPU: max table diff "
          f"{check_step_against_cpu(dev):.3g}")

    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    untrained = cli.main(args + ["--epochs", "0"])["final_metrics"]
    print(f"untrained: {json.dumps(untrained)}")

    counters = [(gather.LAUNCHES, "gather_rows"),
                (gather.LAUNCHES, "history_mean_gather"),
                (scatter.LAUNCHES, "scatter_add_rows")]
    for launches, name in counters:
        launches[name] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    record = cli.main(args)
    launches = {name: d[name] for d, name in counters}

    losses = record["losses"]
    if len(losses) != 5 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected 5 finite epoch losses, got {losses}")
    if not losses[4] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    steps = record["steps"]
    for name, n in launches.items():
        if n < steps:
            raise AssertionError(
                f"{name} launched {n} times in {steps} steps of the main path"
            )
    final = record["final_metrics"]
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in final.values()):
        raise AssertionError(f"metrics out of range: {final}")
    r_final, r_untrained = final["Recall(k=20)"], untrained["Recall(k=20)"]
    if not r_final >= 10 * r_untrained:
        raise AssertionError(
            f"Recall(k=20) {r_final} < 10 x untrained {r_untrained}"
        )
    print(f"epoch losses: {losses}")
    print(f"epoch seconds: {record['epoch_times']}")
    print(f"periodic evals: {[(e['epoch'], e['seconds']) for e in record['evals']]}")
    print(f"final eval seconds: {record['final_eval_s']}")
    print(f"steps: {steps}; launches: {launches}")
    print(f"peak device memory (training run): "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"final metrics: {json.dumps(final)}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
        del k["shape"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
