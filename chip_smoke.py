"""Smoke check of the PyTorch port (heat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. environment: torch and CUDA versions, the card's name and power limit,
   TF32 off for f32 matmuls;
2. build: the CUDA kernels of heat_tpu_torch/csrc with nvcc;
3. kernels: K1 (history mean), K2 (row gather) and K3 (row scatter-add)
   against their plain PyTorch versions at the config0 step's shapes, and
   K4 (top-k window extraction) at the eval tile and at a B = 8192
   request, with median times over 30 runs; then one training step on the
   card against the same step on the CPU at a small size;
4. main path: the CLI (heat_tpu_torch.main) on AmazonBooks config0 at full
   width on a synthetic 52,643 x 91,599 planted-cluster dataset: first
   with 0 epochs (the untrained model's metrics), then the whole 5-epoch
   schedule with its evaluations and ``--export-embeddings``, with every
   kernel's launch count read around that run;
5. serving: the exported model in a ``Recommender`` on the card, requests
   of 1, 256 and 8192 users timed and held against ``recommend_all``, the
   Recall@20 of every user's requested top-20 against the run's final
   eval, aggregated-user requests and cold-start users against plain
   oracles, with the launch counts read around the phase;
6. huge item table: a random 1,048,576-item state whose requests take the
   chunked route (4,096 users) and the retrieve-and-filter route (9,216
   users, the seen bitmap above its budget), each held against a plain
   on-card oracle;
7. the kernels' JSON line, the card's line, and last
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
from pathlib import Path

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
SYNTHETIC = "52643,91599"  # AmazonBooks users x items
NUM_USERS, NUM_ITEMS = 52643, 91599
BATCH, MAX_HIS, NUM_NEGS, DIM = 8192, 100, 16, 64
RUNS = 30
I_PAD = 91_648  # NUM_ITEMS padded to the 128-wide top-k windows
EVAL_TILE, EVAL_K = 512, 50  # one eval tile of the top-50 eval
REQUEST_B, REQUEST_K = 8192, 20  # the largest timed serving request
HUGE_ITEMS, HUGE_SEEN = 1_048_576, 36
HUGE_USERS = (4096, 9216)  # chunked route; retrieve-and-filter route
HUGE_B = 256
EXPORT = Path(__file__).resolve().parent / "build" / "chip_smoke" / "config0.npz"


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
    results.append(check_window_extract(dev))
    return results


def check_window_extract(dev) -> dict:
    """K4 at the eval tile and at the B = 8192 request, against its plain
    version: the copy is exact, so the two must be bit-equal."""
    import torch

    from heat_tpu_torch.ops.cuda import topk

    g = torch.Generator(device=dev).manual_seed(1)
    nw = I_PAD // 128
    entry = {
        "name": "window_extract", "route": "cuda",
        "source": "heat_tpu_torch/csrc/topk.cu",
        "replaces": "scripts/profile_eval.py:264 (pallas_extract), "
                    "scripts/profile_eval.py:361 (pallas_extract_slices)",
        "max_abs_err": 0.0,
    }
    for rows, kw, key in ((EVAL_TILE, EVAL_K, ""),
                          (REQUEST_B, REQUEST_K, f"_b{REQUEST_B}")):
        sim = torch.randn(rows, I_PAD, generator=g, device=dev)
        widx = torch.randint(0, nw, (rows, kw), generator=g, device=dev,
                             dtype=torch.int32)
        widx[0, :2] = torch.tensor([-1, nw])  # out of range: finfo.min rows
        got = topk.window_extract(sim, widx, 128)
        want = topk.window_extract_ref(sim, widx, 128)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K4 window_extract disagrees with its plain version at "
                f"({rows}, {I_PAD}), kw {kw}"
            )
        entry["max_abs_err"] = max(
            entry["max_abs_err"], float((got - want).abs().max())
        )
        entry["ms" + key] = median_ms(lambda: topk.window_extract(sim, widx, 128))
        entry["plain_ms" + key] = median_ms(
            lambda: topk.window_extract_ref(sim, widx, 128)
        )
        del sim, got, want
    entry["shape"] = (f"({EVAL_TILE}, {I_PAD}) f32, kw {EVAL_K}; "
                      f"b{REQUEST_B}: ({REQUEST_B}, {I_PAD}), kw {REQUEST_K}")
    return entry


def _score_rows(user, item, rows, ids):
    """(R, k) f64 scores user[rows[r]] . item[ids[r, j]] on the card."""
    import torch

    dev = user.device
    r = torch.as_tensor(rows, device=dev, dtype=torch.long)
    i = torch.as_tensor(ids, device=dev, dtype=torch.long)
    return torch.einsum(
        "rd,rkd->rk", user[r].double(), item[i].double()
    ).cpu().numpy()


def same_topk(got, want, score, k, what, atol=1e-5):
    """Tie-aware: equal score lists, and equal id sets in the first k ranks
    wherever the k-th score is above the (k+1)-th by more than atol (two
    f32 GEMMs of other shapes round differently in the last bits).
    got / want: (R, k + 1) ids; score(ids) gives their (R, k + 1) scores."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {got.shape} vs {want.shape}")
    sg, sw = score(got), score(want)
    if not np.allclose(sg, sw, rtol=1e-6, atol=atol):
        raise AssertionError(
            f"{what}: score lists differ by up to {np.abs(sg - sw).max():.3g}"
        )
    strict = sw[:, k - 1] > sw[:, k] + atol
    for r in np.flatnonzero(strict):
        if set(got[r, :k].tolist()) != set(want[r, :k].tolist()):
            raise AssertionError(f"{what}: row {r} ranks other ids")
    return float(strict.mean())


def time_request(fn, reps: int) -> float:
    """Median wall ms of fn() (a request: ids in, numpy ids out, so it ends
    with a device-to-host copy), with a sync before each call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_serving(dev, final_recall: float) -> dict:
    """The exported config0 model served on the card (see the docstring)."""
    import numpy as np
    import torch

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.evaluation.metrics import evaluate_metrics
    from heat_tpu_torch.export import load_embeddings
    from heat_tpu_torch.models.state import state_from_numpy
    from heat_tpu_torch.serving import Recommender

    cfg, _ = load_config(CONFIG0)
    train, test = synthetic_click_dataset(
        num_users=NUM_USERS, num_items=NUM_ITEMS, max_his=cfg.max_his,
        seed=cfg.seed,
    )
    emb = load_embeddings(str(EXPORT))
    state = state_from_numpy(emb["user_emb"], emb["item_emb"], emb["w0"],
                             lr=cfg.l_r, step=0, device=dev)
    rec = Recommender(state, cfg, seen_pairs=train.pairs,
                      his_items=train.his_items, his_masks=train.masks)
    if rec._chunked_request or rec._bits_flat is None:
        raise AssertionError("config0 serving is not on the one-shot route")
    k = REQUEST_K
    seen_keys = np.sort(train.pairs[:, 0].astype(np.int64) * NUM_ITEMS
                        + train.pairs[:, 1])
    every = rec.recommend_all(k + 1)
    out = {}
    rng = np.random.default_rng(3)
    for b, reps in ((1, 20), (256, 20), (REQUEST_B, 5)):
        uids = rng.integers(0, NUM_USERS, b)
        got = rec.recommend(uids, k + 1)
        same_topk(got, every[uids],
                  lambda ids: _score_rows(state.user_emb, state.item_emb, uids, ids),
                  k, f"request B={b} vs recommend_all")
        if np.isin(uids[:, None] * NUM_ITEMS + got, seen_keys).any():
            raise AssertionError(f"request B={b} returned a seen item")
        out[f"serve_b{b}_ms"] = time_request(lambda: rec.recommend(uids, k), reps)

    top = np.concatenate([
        rec.recommend(np.arange(lo, min(lo + REQUEST_B, NUM_USERS)), k)
        for lo in range(0, NUM_USERS, REQUEST_B)
    ])
    recall = evaluate_metrics(["Recall(k=20)"], top, test.user_items)["Recall(k=20)"]
    if abs(recall - final_recall) > 1e-5:
        raise AssertionError(
            f"served Recall@20 {recall} vs the run's final eval {final_recall}"
        )
    out["served_recall20"] = recall

    from heat_tpu_torch.ops.cuda import gather

    k1_before = gather.LAUNCHES["history_mean_gather"]
    uids = rng.integers(0, NUM_USERS, 256)
    agg = rec._user_embeddings(True)
    got = rec.recommend(uids, k + 1, aggregate_users=True)
    k1_request = gather.LAUNCHES["history_mean_gather"] - k1_before
    same_topk(got, rec.recommend_all(k + 1, aggregate_users=True)[uids],
              lambda ids: _score_rows(agg, state.item_emb, uids, ids),
              k, "aggregated request B=256 vs recommend_all")
    if k1_request < 1:
        raise AssertionError("the aggregated request did not launch K1")
    out["agg_b256_ms"] = time_request(
        lambda: rec.recommend(uids, k, aggregate_users=True), 20
    )

    # Cold start: 64 users' train histories, against a plain oracle.
    hist = [train.his_items[u, : train.masks[u]].tolist() for u in range(64)]
    got = rec.recommend_cold(hist, k + 1)
    it = state.item_emb / state.item_emb.norm(dim=1, keepdim=True).clamp(min=1e-12)
    users = []
    for h in hist:
        pooled = state.item_emb[torch.as_tensor(h, device=dev)].mean(0)
        u = (1.0 - cfg.gamma) * (pooled @ state.w0)
        users.append(u / u.norm().clamp(min=1e-12))
    cold_u = torch.stack(users)
    sims = cold_u @ it.T
    for r, h in enumerate(hist):
        sims[r, torch.as_tensor(h, device=dev)] = torch.finfo(torch.float32).min
    want = torch.topk(sims, k + 1, dim=1).indices.cpu().numpy()
    same_topk(got, want,
              lambda ids: _score_rows(cold_u, it, np.arange(64), ids),
              k, "recommend_cold vs a plain oracle", atol=1e-6)
    out["cold_b64_ms"] = time_request(lambda: rec.recommend_cold(hist, k), 20)
    return out


def check_huge_table(dev) -> dict:
    """Requests on a random 1,048,576 x 64 f32 state at the routes' real
    thresholds: 4,096 users (a 512 MB seen bitmap, chunked route) and
    9,216 users (1.2 GB, above MASK_BITS_MAX_BYTES: retrieve-and-filter,
    and the evaluator on its per-pair path), each against an on-card
    oracle (GEMM, seen pairs set to finfo.min, torch.topk)."""
    import numpy as np
    import torch

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import TrainState
    from heat_tpu_torch.serving import Recommender

    g = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    item = torch.randn(HUGE_ITEMS, DIM, generator=g, device=dev)
    k, out = REQUEST_K, {}
    for users in HUGE_USERS:
        user = torch.randn(users, DIM, generator=g, device=dev)
        seen_items = rng.integers(0, HUGE_ITEMS, (users, HUGE_SEEN))
        seen = np.stack([np.repeat(np.arange(users), HUGE_SEEN),
                         seen_items.reshape(-1)], 1).astype(np.int32)
        state = TrainState(
            user_emb=user, item_emb=item,
            w0=torch.zeros(DIM, DIM, device=dev),
            lr=torch.tensor(0.0, device=dev),
            step=torch.tensor(0, dtype=torch.int32, device=dev),
        )
        rec = Recommender(state, CFConfig(emb_dim=DIM), seen_pairs=seen)
        bitmap = rec._bits_flat is not None
        if not rec._chunked_request or bitmap != (users == HUGE_USERS[0]):
            raise AssertionError(
                f"{users} users: chunked {rec._chunked_request}, "
                f"bitmap {bitmap}"
            )
        if not bitmap and rec._evaluator.mask_bits is not None:
            raise AssertionError("the evaluator is not on its per-pair path")
        route = "chunked" if bitmap else "retrieve_filter"
        uids = rng.choice(users, HUGE_B, replace=False)
        got = rec.recommend(uids, k + 1)
        sims = user[torch.as_tensor(uids, device=dev)] @ item.T
        rows = torch.arange(HUGE_B, device=dev).repeat_interleave(HUGE_SEEN)
        cols = torch.as_tensor(seen_items[uids].reshape(-1), device=dev)
        sims[rows, cols] = torch.finfo(torch.float32).min
        want = torch.topk(sims, k + 1, dim=1).indices.cpu().numpy()
        del sims
        same_topk(got, want,
                  lambda ids: _score_rows(user, item, uids, ids),
                  k, f"huge table, {route} route vs oracle")
        out[f"huge_{route}_b{HUGE_B}_ms"] = time_request(
            lambda: rec.recommend(uids, k), 10
        )
        del rec, state, user
    return out


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
    from heat_tpu_torch.ops.cuda import _build, gather, scatter, topk
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
        if "ms_b8192" in k:
            print(f"kernel {k['name']} at B=8192: {k['ms_b8192']:.4f} ms "
                  f"(plain {k['plain_ms_b8192']:.4f} ms)")
    print(f"train_step card vs CPU: max table diff "
          f"{check_step_against_cpu(dev):.3g}")

    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    untrained = cli.main(args + ["--epochs", "0"])["final_metrics"]
    print(f"untrained: {json.dumps(untrained)}")

    counters = [(gather.LAUNCHES, "gather_rows"),
                (gather.LAUNCHES, "history_mean_gather"),
                (scatter.LAUNCHES, "scatter_add_rows"),
                (topk.LAUNCHES, "window_extract")]

    def reset():
        for d, name in counters:
            d[name] = 0

    def read():
        return {name: d[name] for d, name in counters}

    EXPORT.parent.mkdir(parents=True, exist_ok=True)
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    record = cli.main(args + ["--export-embeddings", str(EXPORT)])
    launches = read()

    losses = record["losses"]
    if len(losses) != 5 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"expected 5 finite epoch losses, got {losses}")
    if not losses[4] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    steps = record["steps"]
    for name, n in launches.items():
        if name != "window_extract" and n < steps:
            raise AssertionError(
                f"{name} launched {n} times in {steps} steps of the main path"
            )
    eval_tiles = 3 * -(-NUM_USERS // EVAL_TILE)  # two periodic evals + final
    if launches["window_extract"] < eval_tiles:
        raise AssertionError(
            f"window_extract launched {launches['window_extract']} times in "
            f"the run's evals, expected >= {eval_tiles} (every eval tile)"
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

    reset()
    serving = check_serving(dev, final["Recall(k=20)"])
    serving.update(check_huge_table(dev))
    serving_launches = read()
    for name in ("gather_rows", "history_mean_gather", "window_extract"):
        if serving_launches[name] < 1:
            raise AssertionError(f"{name} was not launched by serving")
    print(f"serving: {json.dumps(serving)}")
    print(f"serving launches: {serving_launches}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_serving"] = serving_launches[k["name"]]
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
