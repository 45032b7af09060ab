"""Smoke check of the PyTorch port (heat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. environment: torch and CUDA versions, the card's name and power limit,
   TF32 off for f32 matmuls;
2. build: the CUDA kernels of heat_tpu_torch/csrc with nvcc;
3. kernels: K1 (history mean), K2 (row gather) and K3 (row scatter-add)
   against their plain PyTorch versions at the config0 step's shapes, K4
   (top-k window extraction) at the eval tile and at a B = 8192 request,
   and S1 (row scatter-set) at the huge-table path's user shape (32,768
   sorted ids, 1/8 sentinels, into 16,000,000 x 64) and item shape
   (557,056 ids into 6,000,000 x 64), with median times over 30 runs;
   the kernels again at the other shapes their paths give them: K2 at the
   huge path's 32,768 user rows of the 16M table (``_big_users``) and
   524,288 negative rows of the 6M table (``_big_negs``), K1 at its
   (32,768, 10) histories over the 6M table (``_big``), K3 at direct
   mode's 557,056 adds into the 6M table (``_big_items``), S1 at the
   config0 step's user write-back (``_config0``: 8,192 unsorted ids with
   repeats and sentinels into 52,643 x 64, bit-equal on the whole table);
   then two training steps on the card against the same steps on the CPU
   at a small size, for each branch of the update menu (dense, sorted,
   direct, l2, Adagrad, Adam, accum);
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
7. huge-table training: ``heat_tpu_torch.bench_large`` at its default
   geometry (16,000,000 users x 6,000,000 items, d = 64, 40M clicks,
   batch 32,768), a warm-up and a timed epoch in ``dedup`` mode (both
   tables on the sort-dedup path) and then in ``direct`` mode, with the
   launch counts read around each run and peak device memory against the
   bytes held; then one full-size sort-dedup update of both tables on the
   card against the same update on the CPU (plain versions), untouched
   rows bit-equal to before;
8. the kernels' JSON line, the card's line, and last
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
BIG_USERS, BIG_ITEMS = 16_000_000, 6_000_000  # bench_large's default tables
BIG_BATCH, BIG_NEGS, BIG_HIS = 32_768, 16, 10
S1_SHAPES = (  # (table rows, ids, key suffix): user and item sides
    (BIG_USERS, BIG_BATCH, ""),
    (BIG_ITEMS, BIG_BATCH * (1 + BIG_NEGS), "_items"),
)
MEM_RATIO = 1.25  # peak device memory / bytes held, at most
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


def check_scatter_set(dev) -> dict:
    """S1 against its plain version at the huge-table path's shapes:
    sorted unique ids with the last 1/8 set to the sentinel (the layout of
    the sort-dedup path's rep_ids), bit-equal on the whole table."""
    import torch

    from heat_tpu_torch.ops.cuda import scatter

    g = torch.Generator(device=dev).manual_seed(2)
    entry = {
        "name": "scatter_set_rows", "route": "cuda",
        "source": "heat_tpu_torch/csrc/scatter.cu",
        "replaces": "scripts/profile_scatter_pallas.py:65 (pallas_scatter_set)",
        "max_abs_err": 0.0,
    }
    for n, m, key in S1_SHAPES:
        table = torch.randn(n, DIM, generator=g, device=dev)
        ids = torch.randperm(n, generator=g, device=dev)[:m].sort().values
        ids = ids.to(torch.int32)
        ids[-(m // 8):] = n
        rows = torch.randn(m, DIM, generator=g, device=dev)
        got = scatter.scatter_set_rows(table.clone(), ids, rows)
        want = scatter.scatter_set_rows_ref(table.clone(), ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"S1 scatter_set_rows disagrees with its plain version at "
                f"({n}, {DIM}), {m} ids"
            )
        entry["max_abs_err"] = max(
            entry["max_abs_err"], float((got - want).abs().max())
        )
        del got, want
        entry["ms" + key] = median_ms(
            lambda: scatter.scatter_set_rows(table, ids, rows)
        )
        entry["plain_ms" + key] = median_ms(
            lambda: scatter.scatter_set_rows_ref(table, ids, rows)
        )
        del table
    entry["shape"] = (f"({BIG_USERS}, {DIM}) f32, {BIG_BATCH} sorted ids, "
                      f"1/8 sentinels; _items: ({BIG_ITEMS}, {DIM}), "
                      f"{BIG_BATCH * (1 + BIG_NEGS)} ids")
    return entry


def check_path_shapes(dev, entries: dict) -> None:
    """K2, K1 and K3 at the huge-table path's shapes and S1 at the config0
    step's write-back, each against its plain version; each shape's times
    go into the kernel's entry under a key suffix."""
    import torch

    from heat_tpu_torch.ops.cuda import gather, scatter

    g = torch.Generator(device=dev).manual_seed(4)

    def ids(m, hi):
        return torch.randint(0, hi, (m,), generator=g, device=dev,
                             dtype=torch.int32)

    def record(name, key, got, want, fn, ref):
        entry = entries[name]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   float((got - want).abs().max()))
        entry["ms" + key] = median_ms(fn)
        entry["plain_ms" + key] = median_ms(ref)

    users = torch.randn(BIG_USERS, DIM, generator=g, device=dev)
    items = torch.randn(BIG_ITEMS, DIM, generator=g, device=dev)

    # K2: a step's 32,768 user rows of the 16M table and its 524,288
    # negative rows of the 6M table; a copy, so bit-equal.
    for table, m, key in ((users, BIG_BATCH, "_big_users"),
                          (items, BIG_BATCH * BIG_NEGS, "_big_negs")):
        i = ids(m, table.shape[0])
        got, want = gather.gather_rows(table, i), gather.gather_rows_ref(table, i)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K2 gather_rows disagrees with its plain version at "
                f"({table.shape[0]}, {DIM}), {m} ids"
            )
        record("gather_rows", key, got, want,
               lambda: gather.gather_rows(table, i),
               lambda: gather.gather_rows_ref(table, i))

    # K1: (32,768, 10) histories over the 6M item table, lengths uniform
    # in [0, 10]; rtol 1e-5, atol 1e-6 as at config0.
    his = ids(BIG_BATCH * BIG_HIS, BIG_ITEMS).reshape(BIG_BATCH, BIG_HIS)
    lens = ids(BIG_BATCH, BIG_HIS + 1)
    got = gather.history_mean_gather(items, his, lens)
    want = gather.history_mean_gather_ref(items, his, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    record("history_mean_gather", "_big", got, want,
           lambda: gather.history_mean_gather(items, his, lens),
           lambda: gather.history_mean_gather_ref(items, his, lens))

    # K3: direct mode's 557,056 per-occurrence adds into the 6M item
    # table, repeats and about 1% sentinels; rtol 1e-5, atol 1e-6.
    m = BIG_BATCH * (1 + BIG_NEGS)
    sc_ids = ids(m, BIG_ITEMS)
    sentinel = torch.rand(m, generator=g, device=dev) < 0.01
    sc_ids = torch.where(sentinel, BIG_ITEMS, sc_ids).to(torch.int32)
    deltas = torch.randn(m, DIM, generator=g, device=dev)
    got = scatter.scatter_add_rows(items.clone(), sc_ids, deltas)
    want = scatter.scatter_add_rows_ref(items.clone(), sc_ids, deltas)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    record("scatter_add_rows", "_big_items", got, want,
           lambda: scatter.scatter_add_rows(items, sc_ids, deltas),
           lambda: scatter.scatter_add_rows_ref(items, sc_ids, deltas))
    del users, items, got, want

    # S1: the config0 step's user write-back, 8,192 unsorted ids into
    # 52,643 x 64 with repeats carrying identical rows (each user's row)
    # and a weight-0 tail of sentinels; bit-equal on the whole table.
    table = torch.randn(NUM_USERS, DIM, generator=g, device=dev)
    uid = ids(BATCH, NUM_USERS)
    uid[:64] = uid[0]
    rows = torch.randn(NUM_USERS, DIM, generator=g, device=dev)[uid.long()]
    uid[-(BATCH // 64):] = NUM_USERS
    got = scatter.scatter_set_rows(table.clone(), uid, rows)
    want = scatter.scatter_set_rows_ref(table.clone(), uid, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            "S1 scatter_set_rows disagrees with its plain version at the "
            "config0 write-back"
        )
    record("scatter_set_rows", "_config0", got, want,
           lambda: scatter.scatter_set_rows(table, uid, rows),
           lambda: scatter.scatter_set_rows_ref(table, uid, rows))
    torch.cuda.empty_cache()


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


STEP_VARIANTS = {  # name: (sort-dedup forced, config overrides)
    "dense": (False, {}),
    "sorted": (True, {}),
    "direct": (False, {"update_mode": "direct"}),
    "l2": (False, {"l2_enabled": True, "l2": 0.01}),
    "sorted_l2": (True, {"l2_enabled": True, "l2": 0.01}),
    "adagrad": (False, {"optimizer": "adagrad"}),
    "adam": (False, {"optimizer": "adam"}),
    "sorted_adam": (True, {"optimizer": "adam"}),
    "accum": (False, {"sgd_mode": "accum"}),
    "sorted_accum": (True, {"sgd_mode": "accum"}),
}


def check_step_against_cpu(dev) -> dict:
    """Two train_steps on the card (kernels) against the same steps on the
    CPU (plain versions), for each branch of the update menu: small
    shapes, repeated ids, a weight-0 tail and the same negatives; the
    sorted variants lower the port's DENSE_ROWS_THRESHOLD below both
    tables. Returns the largest state difference of each variant."""
    import numpy as np
    import torch

    import heat_tpu_torch.train.scatter as tsc
    import heat_tpu_torch.train.train_step as ts
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import (
        init_train_state,
        state_from_numpy,
        state_to_numpy,
    )
    from heat_tpu_torch.testing import assert_state_array_close
    from heat_tpu_torch.train.samplers import (
        NegSample,
        SamplerState,
        init_sampler_state,
    )

    rng = np.random.default_rng(1)
    u, i, h, b, k, d = 40, 90, 8, 48, 4, 64
    users = rng.integers(0, u, b).astype(np.int32)
    pos = rng.integers(0, i, b).astype(np.int32)
    users[:6], pos[6:12] = 3, 5
    weight = np.ones(b, np.float32)
    weight[-7:] = 0.0
    his = rng.integers(0, i, (u, h)).astype(np.int32)
    masks = rng.integers(0, h + 1, u).astype(np.int32)
    negs = rng.integers(0, i, (b, k)).astype(np.int32)

    def fixed(generator, sstate, pos_ids, _cfg, real=None):
        return (NegSample(torch.from_numpy(negs).to(pos_ids.device)),
                SamplerState(sstate.iterations + pos_ids.shape[0]))

    def flat(state):
        arrays = state_to_numpy(state)
        arrays.update(arrays.pop("opt_slots", {}))
        return arrays

    worst = {}
    orig_sampler, orig_threshold = ts.sample_negatives, tsc.DENSE_ROWS_THRESHOLD
    ts.sample_negatives = fixed
    try:
        for name, (sort, extra) in STEP_VARIANTS.items():
            cfg = CFConfig(emb_dim=d, num_users=u, num_items=i, max_his=h,
                           num_negs=k, batch_size=b, l_r=0.05, clip_val=0.02,
                           **extra)
            tsc.DENSE_ROWS_THRESHOLD = 16 if sort else orig_threshold
            init = state_to_numpy(init_train_state(
                cfg, torch.Generator().manual_seed(3), "cpu"
            ))
            out = []  # (state arrays, losses) on the card, then on the CPU
            for device in (dev, torch.device("cpu")):
                def put(x):
                    return torch.from_numpy(x).to(device)

                state = state_from_numpy(**init, device=device)
                sstate = init_sampler_state(cfg, device)
                losses = []
                for _ in range(2):
                    state, sstate, loss = ts.train_step(
                        state, sstate, None,
                        ts.Batch(put(users), put(pos), put(weight)),
                        put(his), put(masks), cfg,
                    )
                    losses.append(float(loss))
                out.append((flat(state), losses))
            (card, card_loss), (cpu, cpu_loss) = out
            np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5,
                                       err_msg=f"{name}: losses")
            # The tests' rule (heat_tpu_torch.testing), with atol 1e-6: K3's
            # atomics add in another order than index_add_.
            worst[name] = 0.0
            for key in card:
                try:
                    diff = assert_state_array_close(
                        card[key], cpu[key], key, lr=cfg.l_r,
                        clip_val=cfg.clip_val, rtol=1e-5, atol=1e-6,
                    )
                except AssertionError as err:
                    raise AssertionError(
                        f"step on the card vs the CPU, {name}: {err}"
                    ) from None
                worst[name] = max(worst[name], diff)
    finally:
        ts.sample_negatives = orig_sampler
        tsc.DENSE_ROWS_THRESHOLD = orig_threshold
    return worst


def check_huge_training(reset, read) -> dict:
    """bench_large at its default geometry, dedup then direct mode (see
    the docstring); returns each run's record with its launch counts."""
    import torch

    from heat_tpu_torch import bench_large

    out = {}
    for mode in ("dedup", "direct"):
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        record = bench_large.run(["--update-mode", mode, "--reps", "1"])
        wall = time.perf_counter() - t0
        launches = read()
        print(json.dumps(record))
        losses = record["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"bench_large {mode}: losses {losses}")
        if mode == "dedup" and not record["sorted_dedup_path"]:
            raise AssertionError("bench_large dedup: not on the sort-dedup path")
        steps = record["steps"]
        need = ["gather_rows", "history_mean_gather", "scatter_add_rows",
                "scatter_set_rows"]
        for name in need:
            if launches[name] < steps:
                raise AssertionError(
                    f"bench_large {mode}: {name} launched {launches[name]} "
                    f"times in {steps} steps"
                )
        held = record["state_bytes"] + record["data_bytes"]
        peak = record["peak_device_bytes"]
        print(f"bench_large {mode}: {wall:.1f} s in all; launches {launches}; "
              f"peak device memory {peak / 1e9:.3f} GB against "
              f"{held / 1e9:.3f} GB of state and data held "
              f"({peak / held:.3f}x; with the epoch's batch stream "
              f"{record['epoch_stream_bytes'] / 1e9:.3f} GB: "
              f"{peak / (held + record['epoch_stream_bytes']):.3f}x)")
        if mode == "dedup" and peak > MEM_RATIO * held:
            raise AssertionError(
                f"bench_large dedup: peak device memory {peak} B above "
                f"{MEM_RATIO} x {held} B held: a step-time table copy?"
            )
        record["launches"] = launches
        record["wall_s"] = wall
        out[mode] = record
    return out


def check_huge_step(dev, users=BIG_USERS, items=BIG_ITEMS, batch=BIG_BATCH,
                    negs=BIG_NEGS) -> dict:
    """One sort-dedup update of both tables at the bench_large geometry
    (the user table with its fused write-back, the item table with the
    step's 557,056 ids) on the card, against the same update of CPU
    copies (plain versions: index_add_, index_copy_, the same torch
    sort-dedup) on the same gradients. Touched rows agree to rtol 1e-5 /
    atol 1e-7 (K3 sums repeats in another order); untouched rows are
    bit-equal to before. Returns the largest difference and the
    launches."""
    import torch

    import heat_tpu_torch.train.scatter as tsc
    from heat_tpu_torch.ops.cuda import scatter

    if max(users, items) <= tsc.DENSE_ROWS_THRESHOLD:
        raise AssertionError("the tables must be on the sort-dedup path")
    g = torch.Generator(device=dev).manual_seed(7)
    lr = torch.tensor(0.01, device=dev)  # bench_large's lr and clip
    d = DIM

    def ids(n, m):
        out = torch.randint(0, n, (m,), generator=g, device=dev,
                            dtype=torch.int32)
        out[:64] = out[0]  # a heavy repeat
        out[-(m // 64):] = n  # a weight-0 tail
        return out

    uid, iid = ids(users, batch), ids(items, batch * (1 + negs))
    per_id = torch.randn(batch, d, generator=g, device=dev)
    per_id[:64] = per_id[0]  # the repeat writes identical rows
    cases = (  # (table, ids, grads, writeback)
        (torch.randn(users, d, generator=g, device=dev).mul_(0.01), uid,
         torch.randn(batch, d, generator=g, device=dev), per_id),
        (torch.randn(items, d, generator=g, device=dev).mul_(0.01), iid,
         torch.randn(iid.shape[0], d, generator=g, device=dev), None),
    )
    for counter in scatter.LAUNCHES:
        scatter.LAUNCHES[counter] = 0
    worst = 0.0
    for table, i, grads, wb in cases:
        before = table.clone()
        cpu = table.cpu()
        tsc.apply_row_updates(table, i, grads, lr=lr, clip_val=1.0,
                              writeback=wb)
        tsc.apply_row_updates(
            cpu, i.cpu(), grads.cpu(), lr=lr.cpu(), clip_val=1.0,
            writeback=None if wb is None else wb.cpu(),
        )
        torch.cuda.synchronize()
        touched = torch.unique(i[i < table.shape[0]]).long()
        got, want = table[touched], cpu[touched.cpu()].to(dev)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        worst = max(worst, float((got - want).abs().max()))
        if torch.equal(got, before[touched]):
            raise AssertionError("the update moved no touched row")
        table.index_fill_(0, touched, 0.0)
        before.index_fill_(0, touched, 0.0)
        if not torch.equal(table, before):
            raise AssertionError("an untouched row changed")
        del before, cpu, got, want
    return {"max_abs_diff": worst, "launches": dict(scatter.LAUNCHES)}


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
    kernels.append(check_scatter_set(dev))
    check_path_shapes(dev, {k["name"]: k for k in kernels})
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}"
              f" ms), max_abs_err {k['max_abs_err']:.3g}, {k['shape']}")
        for key in k:
            if key.startswith("ms_"):
                print(f"kernel {k['name']} at {key[3:]}: {k[key]:.4f} ms "
                      f"(plain {k['plain_' + key]:.4f} ms)")
    print(f"train_step card vs CPU, max state diff per branch: "
          f"{json.dumps(check_step_against_cpu(dev))}")

    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    untrained = cli.main(args + ["--epochs", "0"])["final_metrics"]
    print(f"untrained: {json.dumps(untrained)}")

    counters = [(gather.LAUNCHES, "gather_rows"),
                (gather.LAUNCHES, "history_mean_gather"),
                (scatter.LAUNCHES, "scatter_add_rows"),
                (scatter.LAUNCHES, "scatter_set_rows"),
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

    huge = check_huge_training(reset, read)
    step = check_huge_step(dev)
    if step["launches"]["scatter_set_rows"] < 1:
        raise AssertionError("the full-size dedup update did not launch S1")
    print(f"full-size dedup update, card vs CPU: max touched-row diff "
          f"{step['max_abs_diff']:.3g}; untouched rows bit-equal; "
          f"launches {step['launches']}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_serving"] = serving_launches[k["name"]]
        for mode, record in huge.items():
            k[f"launches_huge_{mode}"] = record["launches"].get(k["name"], 0)
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
