"""Smoke check of the PyTorch port (heat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. environment: torch and CUDA versions, the card's name and power limit,
   TF32 off for f32 matmuls;
2. build: the CUDA kernels of heat_tpu_torch/csrc with nvcc (one compile
   per source, started together);
3. kernels: every kernel instance against its plain PyTorch version at the
   shapes its paths give it, with times of the kernel, the plain version
   and, where there is one, the single PyTorch call that computes the same
   function (a yardstick the port never calls; for an update entry the
   unfused sequence of PyTorch launches and the plain entry that it
   replaced): ``ms`` the median of 30 single launches between two events
   (it holds the host's launch latency), ``loop_ms`` 100 launches between
   two events over 100, ``host_us`` the host clock around those 100 calls
   per call, ``graph_ms`` the 100 launches captured into one CUDA graph and
   replayed, per launch: the device's own time, the one to read against
   the bound: the bytes the function must move over the card's 3.35 TB/s
   (ids, each distinct table row once, the output; or its operations over
   the f32 rate, whichever is larger). A kernel that cannot be captured
   fails the run. f32: K1
   (history mean), K2 (row gather) and K3 (row scatter-add) at the config0
   step's shapes and at the f32 huge-table path's (``_big*``), K4 (top-k
   window extraction) at the eval tile and a B = 8192 request, S1 (row
   scatter-set) at the huge path's user and item shapes and at the config0
   write-back. bf16, at the headline step's shapes: K2 at the 512 tile
   rows and 8,192 pool rows (bit-equal), K1 at a (4,096, 100) chunk of the
   pools (within one bf16 ulp of the f32-accumulated mean), K3 at the item
   update's 8,192 + 512 ids with repeats (within occurrences x half a bf16
   ulp of the largest partial sum per add), S1 at the user write-back
   (bit-equal); and all four at the shapes ``bench_large`` gives them on
   its 16,000,000 x 6,000,000 bf16 tables in both update modes
   (``_big*``). The update entries of K3 and S1 (clip, l2, lr and the
   rounding inside the kernel) at the shapes of their paths: K3's in bf16
   at the headline's item and user updates (repeats: K3's bound; the
   increments bit-equal) and, f32 and bf16, at the sorted item update of
   the 6,000,000-row table (unique ids: bit-equal); S1's, f32 and bf16, at
   the 16,000,000-row user table (bit-equal). K3 also with every id
   distinct and with sorted ids (what repeats cost). S2 (block gather) at the measuring script's
   shapes, f32 and bf16 at r = 1, 4, 16 (bit-equal). Then train steps on the
   card against the same steps on the CPU at a small size, for each
   branch of the update menu (dense, sorted, direct, l2, Adagrad, Adam,
   accum) and of the tile path (whole-tile scoring with pinned tile and
   draws: dedup, sorted, direct, pools, accum's untiled fallback in f32;
   dedup, sorted and pools + direct in bf16, with the tolerance stated at
   ``check_step_against_cpu``);
4. main paths: the CLI (heat_tpu_torch.main) on AmazonBooks config0 at full
   width on a synthetic 52,643 x 91,599 planted-cluster dataset: first
   with 0 epochs (the untrained model's metrics), then the whole 5-epoch
   schedule with its evaluations and ``--export-embeddings``; then the
   same schedule in the headline configuration of the JAX package's bench
   (tile sampler 512 / 8192 with whole-tile scoring, cached pools, bf16
   tables and compute, ``update_mode: direct``), its Recall@20 held within
   RECALL_BAND of the config0 run's; every kernel's launch count is read
   around each run, and the headline run must go through the bf16
   instances only;
5. serving: the exported model in a ``Recommender`` on the card, requests
   of 1, 256 and 8192 users timed and held against ``recommend_all``, the
   Recall@20 of every user's requested top-20 against the run's final
   eval, aggregated-user requests and cold-start users against plain
   oracles, with the launch counts read around the phase;
6. huge item table: a random 1,048,576-item state whose requests take the
   chunked route (4,096 users) and the retrieve-and-filter route (9,216
   users, the seen bitmap above its budget), each held against a plain
   on-card oracle;
7. huge-table training: the path without the tile sampler (uniform
   sampler, per-step history mean, 16,000,000 x 6,000,000 tables), a
   warm-up and a timed ``Engine.train_one_epoch`` of BIG_F32_STEPS steps in
   f32 per update mode and in bf16 under row-sparse Adagrad (the main path
   of the plain K3 bf16 instance and of S1's conversion of f32 rows); then
   ``heat_tpu_torch.bench_large``
   at its default geometry and configuration (tile sampler, cached pools,
   bf16; 40M clicks, batch 32,768), a warm-up and a timed epoch in
   ``dedup`` mode (both tables on the sort-dedup path) and in ``direct``
   mode, with the launch counts read around each run and peak device
   memory against the bytes held; then one full-size sort-dedup update of
   both tables on the card against the same update on the CPU (plain
   versions), untouched rows bit-equal to before; then the launches per
   step (device events under ``torch.profiler`` over PROFILE_STEPS steps)
   of the headline step and of both 16M x 6M steps, on a line
   ``{"launches_per_step": ...}``;
8. ``heat_tpu_torch.profile_exact_ceiling`` at 10 timed calls per
   measurement: the one path that runs S2;
9. the kernels' JSON line (each instance with its launches on its own main
   path: f32 on config0, bf16 on the headline run, S2 on its script), the
   card's line, and last ``{"ok": true, "device": {...}}``.

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
TILE, POOL_CHUNK = 512, 4096  # the headline's tile; users per K1 launch of the pools
# The headline configuration of the JAX package's bench.py, on config0.
HEADLINE = ["neg_sampler=1", "tile_size=512", "refresh_interval=8192",
            "his_refresh=subepoch", "param_dtype=bfloat16",
            "compute_dtype=bfloat16", "update_mode=direct"]
RECALL_BAND = 0.0015  # headline Recall@20 against the f32 config0 run's
S2_WIDTH, S2_ROWS = 128, 65_536  # the measuring script's block gather
RUNS = 30
I_PAD = 91_648  # NUM_ITEMS padded to the 128-wide top-k windows
EVAL_TILE, EVAL_K = 512, 50  # one eval tile of the top-50 eval
REQUEST_B, REQUEST_K = 8192, 20  # the largest timed serving request
HUGE_ITEMS, HUGE_SEEN = 1_048_576, 36
HUGE_USERS = (4096, 9216)  # chunked route; retrieve-and-filter route
HUGE_B = 256
BIG_USERS, BIG_ITEMS = 16_000_000, 6_000_000  # bench_large's default tables
BIG_BATCH, BIG_NEGS, BIG_HIS = 32_768, 16, 10
BIG_TILE = 128  # bench_large's tile from "auto" at this geometry
BIG_F32_STEPS = 150  # steps an epoch of the f32 huge-table phase
S1_SHAPES = (  # (table rows, ids, key suffix): user and item sides
    (BIG_USERS, BIG_BATCH, ""),
    (BIG_ITEMS, BIG_BATCH * (1 + BIG_NEGS), "_items"),
)
MEM_RATIO = 1.25  # peak device memory / bytes held, at most
PROFILE_STEPS = 50  # steps timed, then traced, for the launches per step
# Device launches per step before the update entries existed, traced by the
# same command on that tree (NVIDIA H100 80GB HBM3).
LAUNCHES_BEFORE = {"headline": 176, "dedup_16m_6m": 235, "direct_16m_6m": 176}
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


H100_BYTES_PER_MS = 3.35e12 / 1e3  # NVIDIA H100 SXM data sheet: 3.35 TB/s
H100_F32_OPS_PER_MS = 67e12 / 1e3  # f32 outside the tensor cores
LOOP = 100  # launches between two events, and captured into one graph


def loop_times(fn) -> tuple[float, float]:
    """(loop_ms, host_us) of fn(): LOOP calls between two CUDA events over
    the count (the device's time per launch when the host keeps ahead, the
    host's when it does not), and the host clock around the same calls
    before any synchronise, per call (what a caller pays to enqueue one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(LOOP):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LOOP, host * 1e6 / LOOP


def graph_ms(fn) -> float:
    """The device's own time per launch of fn(): LOOP launches captured
    once into a CUDA graph, the median of 5 timed replays over LOOP. No
    host work lies between the launches. A kernel that cannot be captured
    raises here. In-place functions run on: their values drift, their
    addresses and work do not."""
    import torch

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LOOP):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LOOP)
    del graph
    return statistics.median(times)


def timed(entry: dict, key: str, fn, ref, lib, nbytes: float, nops: float) -> None:
    """Time the kernel ``fn``, its plain version ``ref`` and, where there is
    one, the single PyTorch call (or, for an update entry, the unfused
    sequence) ``lib`` that computes the same function (a yardstick: the
    port never calls it); and write the bound beside them: the least time
    the card could take, the larger of ``nbytes`` (each input read once,
    each output written once) over the memory rate and ``nops`` over the
    f32 rate. ``ms`` is one launch between two events (it holds the host's
    launch latency), ``loop_ms`` and ``host_us`` are :func:`loop_times`,
    ``graph_ms`` (kernel and PyTorch call) is :func:`graph_ms`, the time
    to read against the bound. Keys get the suffix ``key``."""
    for name, f in (("", fn), ("plain_", ref), ("library_", lib)):
        if f is None:
            for what in ("ms", "loop_ms", "host_us", "graph_ms"):
                entry[name + what + key] = None
            continue
        entry[name + "ms" + key] = median_ms(f)
        loop, host = loop_times(f)
        entry[name + "loop_ms" + key] = loop
        entry[name + "host_us" + key] = host
        # Not the plain versions: their masks wait for the host.
        entry[name + "graph_ms" + key] = None if f is ref else graph_ms(f)
    by_bytes = nbytes / H100_BYTES_PER_MS
    by_ops = nops / H100_F32_OPS_PER_MS
    entry["bound_ms" + key] = max(by_bytes, by_ops)
    entry["bound_by" + key] = "bytes" if by_bytes >= by_ops else "operations"


def new_entry(name: str, source: str, replaces: str, shape: str) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"heat_tpu_torch/csrc/{source}", "replaces": replaces,
            "max_abs_err": 0.0, "shape": shape}


def worst(entry: dict, got, want) -> None:
    entry["max_abs_err"] = max(
        entry["max_abs_err"], float((got.float() - want.float()).abs().max())
    )


def check_gather_rows(entry, key, table, ids) -> None:
    """K2 at one shape: a copy, so bit-equal to its plain version."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    got, want = gather.gather_rows(table, ids), gather.gather_rows_ref(table, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"K2 gather_rows disagrees with its plain version at "
            f"{tuple(table.shape)} {table.dtype}, {ids.shape[0]} ids"
        )
    worst(entry, got, want)
    long_ids = ids.long()
    m, d = ids.shape[0], table.shape[1]
    timed(entry, key,
          lambda: gather.gather_rows(table, ids),
          lambda: gather.gather_rows_ref(table, ids),
          lambda: table.index_select(0, long_ids),
          # The ids, each distinct row read once, every output row written.
          nbytes=4 * m + (_distinct(ids) + m) * d * table.element_size(),
          nops=0)


def check_history_mean(entry, key, table, his, lens, out_dtype=None) -> None:
    """K1 at one shape. f32: the kernel sums in history order, the plain
    version blocked: rtol 1e-5, atol 1e-6. bf16: within one bf16 ulp
    (2^-7 of its magnitude) of the f32-accumulated mean of the same rows.
    The library call is ``embedding_bag(mode="mean")`` over the valid ids,
    flattened beforehand."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    got = gather.history_mean_gather(table, his, lens, out_dtype)
    want = gather.history_mean_gather_ref(table, his, lens, out_dtype)
    torch.cuda.synchronize()
    if got.dtype == torch.bfloat16:
        exact = gather.history_mean_gather_ref(table, his, lens, torch.float32)
        err = (got.float() - exact).abs()
        if not bool((err <= 2.0**-7 * exact.abs() + 1e-30).all()):
            raise AssertionError(
                f"K1 bf16 at {tuple(his.shape)}: further than one bf16 ulp "
                f"from the f32-accumulated mean"
            )
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    worst(entry, got, want)
    b, h = his.shape
    d = table.shape[1]
    n = lens.clamp(0, h)
    valid = torch.arange(h, device=his.device)[None, :] < n[:, None]
    flat = his[valid].long()
    offsets = torch.cumsum(n, 0) - n
    rows_read = int(n.sum())
    timed(entry, key,
          lambda: gather.history_mean_gather(table, his, lens, out_dtype),
          lambda: gather.history_mean_gather_ref(table, his, lens, out_dtype),
          lambda: torch.nn.functional.embedding_bag(
              flat, table, offsets, mode="mean"),
          # This run's valid ids and the lengths, each distinct row they
          # name read once (a row read again comes from cache, not from
          # memory), the means written; one add per valid element.
          nbytes=_distinct(flat) * d * table.element_size() + 4 * rows_read
          + 4 * b + b * d * got.element_size(),
          nops=rows_read * d)


def _distinct(ids) -> int:
    """How many distinct values ``ids`` holds: the rows a function must
    move between memory and the chip, however often it names them."""
    import torch

    return int(torch.unique(ids).numel())


def hold_scatter_add(what, table, ids, deltas, outs) -> None:
    """``outs`` (name -> result) against ``table[ids] += deltas``. Atomics
    land in another order every run. f32: rtol 1e-5, atol 1e-6 between the
    results. bf16: every add rounds, so each element is held to
    (occurrences of its row) x 2^-8 x (the sum of the magnitudes added,
    which bounds every partial sum) around the exact f64 sum: a half ulp of
    the largest partial sum per add; untouched rows bit-equal. Where no id
    repeats, the results must be bit-equal."""
    import torch

    n = table.shape[0]
    keep = (ids >= 0) & (ids < n)
    rows = ids[keep].long()
    kept = deltas[keep]
    results = list(outs.values())
    touched, inverse = torch.unique(rows, return_inverse=True)
    if touched.numel() == rows.numel():
        if not all(torch.equal(results[0], r) for r in results[1:]):
            raise AssertionError(f"{what}: not bit-equal on unique ids")
    elif table.dtype == torch.bfloat16:
        base = table[touched].double()
        exact = base.clone().index_add_(0, inverse, kept.double())
        mag = base.abs().index_add_(0, inverse, kept.double().abs())
        k = torch.bincount(inverse).double()[:, None]
        for name, out in outs.items():
            err = (out[touched].double() - exact).abs()
            if not bool((err <= k * 2.0**-8 * mag).all()):
                raise AssertionError(
                    f"{what} {name} at {n} rows, {ids.shape[0]} ids: outside "
                    f"occurrences x half a bf16 ulp of the largest partial sum"
                )
            changed = (out != table).any(1)
            changed[touched] = False
            if bool(changed.any()):
                raise AssertionError(
                    f"{what} {name} at {n} rows: an untouched row changed")
    else:
        for r in results[1:]:
            torch.testing.assert_close(results[0], r, rtol=1e-5, atol=1e-6)


def check_scatter_add(entry, key, table, ids, deltas) -> None:
    """K3 at one shape, held by :func:`hold_scatter_add` against its plain
    version; the library call is ``index_add_`` over pre-filtered ids."""
    import torch

    from heat_tpu_torch.ops.cuda import scatter

    n, d = table.shape
    got = scatter.scatter_add_rows(table.clone(), ids, deltas)
    want = scatter.scatter_add_rows_ref(table.clone(), ids, deltas)
    torch.cuda.synchronize()
    hold_scatter_add("K3", table, ids, deltas,
                     {"kernel": got, "plain version": want})
    worst(entry, got, want)
    del got, want
    keep = (ids >= 0) & (ids < n)
    rows = ids[keep].long()
    kept = deltas[keep]
    m = ids.shape[0]
    timed(entry, key,
          lambda: scatter.scatter_add_rows(table, ids, deltas),
          lambda: scatter.scatter_add_rows_ref(table, ids, deltas),
          lambda: table.index_add_(0, rows, kept),
          # Deltas and ids in; each touched row read and written once.
          nbytes=4 * m + m * d * table.element_size()
          + 2 * _distinct(rows) * d * table.element_size(),
          nops=int(keep.sum()) * d)


def check_add_update(entry, key, table, ids, grads, lr, clip_val, l2=0.0,
                     rows=None, *, clip_first) -> None:
    """K3's update entry at one shape against its plain version: the
    increments are bit-equal (f32 arithmetic without contraction, one
    rounding), so on unique ids the tables are too, and over repeats they
    are held as K3 is. Timed beside the unfused sequence it replaced: the
    elementwise PyTorch launches, then the plain scatter-add entry."""
    import torch

    from heat_tpu_torch.models.aggregator import scalar_in
    from heat_tpu_torch.ops.cuda import gather, scatter

    n, d = table.shape
    kw = dict(lr=lr, clip_val=clip_val, l2=l2, rows=rows, clip_first=clip_first)
    got = scatter.scatter_add_update(table.clone(), ids, grads, **kw)
    want = scatter.scatter_add_update_ref(table.clone(), ids, grads, **kw)
    torch.cuda.synchronize()
    if clip_first or not l2:
        # The increments the plain version adds (row k of a zero table gets
        # increment k), for the bound over repeats.
        each = torch.arange(ids.shape[0], device=ids.device, dtype=torch.int32)
        inc = scatter.scatter_add_update_ref(
            torch.zeros(ids.shape[0], d, dtype=table.dtype, device=table.device),
            each, grads, **kw)
        hold_scatter_add("K3 update", table, ids, inc,
                         {"kernel": got, "plain version": want})
    elif not torch.equal(got, want):  # l2 reads the table: unique ids only
        raise AssertionError("K3 update (l2 first): not bit-equal on unique ids")
    worst(entry, got, want)
    del got, want

    def unfused():
        if clip_first:
            g = torch.clamp(grads.float(), -clip_val, clip_val)
            if l2:
                g = g + l2 * rows.float()
        else:
            g = grads.float()
            if l2:
                own = gather.gather_rows(table, ids.clamp(max=n - 1))
                valid = (ids < n).to(own.dtype)[:, None]
                g = g + scalar_in(l2, own.dtype) * own * valid
            g = torch.clamp(g, -clip_val, clip_val)
        scatter.scatter_add_rows(table, ids, g.mul_(-lr).to(table.dtype))

    keep = (ids >= 0) & (ids < n)
    m = ids.shape[0]
    src = grads.element_size() + (rows.element_size() if rows is not None else 0)
    timed(entry, key,
          lambda: scatter.scatter_add_update(table, ids, grads, **kw),
          lambda: scatter.scatter_add_update_ref(table, ids, grads, **kw),
          unfused,
          # Ids, gradient rows and forward rows in; each touched row read
          # and written once; clip, l2, lr: about 4 operations an element.
          nbytes=4 * m + m * d * src
          + 2 * _distinct(ids[keep]) * d * table.element_size(),
          nops=4 * int(keep.sum()) * d)


def check_set_update(entry, key, table, ids, base, summed, lr, clip_val,
                     l2=0.0) -> None:
    """S1's update entry at one shape: bit-equal to its plain version on
    the whole table. Timed beside the unfused sequence it replaced (clamp,
    product, subtraction, cast, then the plain scatter-set entry)."""
    import torch

    from heat_tpu_torch.ops.cuda import scatter

    n, d = table.shape
    kw = dict(lr=lr, clip_val=clip_val, l2=l2)
    got = scatter.scatter_set_update(table.clone(), ids, base, summed, **kw)
    want = scatter.scatter_set_update_ref(table.clone(), ids, base, summed, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"S1 update disagrees with its plain version at "
            f"{tuple(table.shape)} {table.dtype}, {ids.shape[0]} ids"
        )
    worst(entry, got, want)
    del got, want

    def unfused():
        b = base.float()
        g = summed + l2 * b * (ids < n).float()[:, None] if l2 else summed
        g = torch.clamp(g, -clip_val, clip_val)
        scatter.scatter_set_rows(table, ids, (b - lr * g).to(table.dtype))

    keep = (ids >= 0) & (ids < n)
    m = ids.shape[0]
    timed(entry, key,
          lambda: scatter.scatter_set_update(table, ids, base, summed, **kw),
          lambda: scatter.scatter_set_update_ref(table, ids, base, summed, **kw),
          unfused,
          # Ids, base and summed rows in; each row in range written once.
          nbytes=4 * m + m * d * (base.element_size() + 4)
          + int(keep.sum()) * d * table.element_size(),
          nops=4 * int(keep.sum()) * d)


def check_scatter_set_at(entry, key, table, ids, rows) -> None:
    """S1 at one shape: it moves bits, so bit-equal to its plain version
    on the whole table. The library call is ``index_copy_`` over the ids
    in range, filtered beforehand."""
    import torch

    from heat_tpu_torch.ops.cuda import scatter

    n, d = table.shape
    got = scatter.scatter_set_rows(table.clone(), ids, rows)
    want = scatter.scatter_set_rows_ref(table.clone(), ids, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"S1 scatter_set_rows disagrees with its plain version at "
            f"{tuple(table.shape)} {table.dtype}, {ids.shape[0]} ids"
        )
    worst(entry, got, want)
    del got, want
    keep = (ids >= 0) & (ids < n)
    long_ids, kept = ids[keep].long(), rows[keep]
    m = ids.shape[0]
    timed(entry, key,
          lambda: scatter.scatter_set_rows(table, ids, rows),
          lambda: scatter.scatter_set_rows_ref(table, ids, rows),
          lambda: table.index_copy_(0, long_ids, kept),
          nbytes=4 * m + m * d * table.element_size()
          + int(keep.sum()) * d * table.element_size(),
          nops=0)


def check_gather_blocks_at(entry, key, table, ids, r) -> None:
    """S2 at one shape: a copy, so bit-equal to its plain version, which
    is the library call too (``index_select`` on the (N / r, r * d)
    view)."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    got = gather.gather_blocks(table, ids, r)
    want = gather.gather_blocks_ref(table, ids, r)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"S2 gather_blocks disagrees with its plain version at "
            f"{tuple(table.shape)} {table.dtype}, r = {r}"
        )
    worst(entry, got, want)
    n, d = table.shape
    view, long_ids = table.view(n // r, r * d), ids.long()
    m = ids.shape[0]
    timed(entry, key,
          lambda: gather.gather_blocks(table, ids, r),
          lambda: gather.gather_blocks_ref(table, ids, r),
          lambda: view.index_select(0, long_ids),
          # The ids, each distinct block read once, every block written.
          nbytes=4 * m + (_distinct(ids) + m) * r * d * table.element_size(),
          nops=0)


def check_kernels(dev) -> list[dict]:
    """Every kernel instance against its plain version, at the shapes its
    paths give it: the config0 step's (f32), the headline step's (bf16: the
    512 tile rows and 8,192 pool rows for K2, a (4,096, 100) chunk of the
    pools for K1, the item update's 8,192 + 512 ids for K3, the user
    write-back for S1) and the measuring script's for S2."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    items = torch.randn(NUM_ITEMS, DIM, generator=g, device=dev)
    items16 = items.bfloat16()
    users16 = torch.randn(NUM_USERS, DIM, generator=g, device=dev).bfloat16()

    def ids(m, hi):
        return torch.randint(0, hi, (m,), generator=g, device=dev,
                             dtype=torch.int32)

    def with_sentinels(i, n, share=0.01):
        sentinel = torch.rand(i.shape[0], generator=g, device=dev) < share
        return torch.where(sentinel, n, i).to(torch.int32)

    k2 = new_entry("gather_rows", "gather.cu", "heat_tpu/ops/pallas/gather.py:80",
                   f"({NUM_ITEMS}, {DIM}) f32 table, {BATCH * NUM_NEGS} ids")
    check_gather_rows(k2, "", items, ids(BATCH * NUM_NEGS, NUM_ITEMS))
    k2b = new_entry("gather_rows_bf16", "gather.cu", k2["replaces"],
                    f"({NUM_ITEMS}, {DIM}) bf16 table, {TILE} tile ids; _pool: "
                    f"({NUM_USERS}, {DIM}) bf16 pools, {BATCH} ids")
    check_gather_rows(k2b, "", items16, ids(TILE, NUM_ITEMS))
    check_gather_rows(k2b, "_pool", users16, ids(BATCH, NUM_USERS))

    # K1: histories with lengths uniform in [0, 100].
    k1 = new_entry("history_mean_gather", "gather.cu",
                   "heat_tpu/ops/pallas/gather.py:141",
                   f"({NUM_ITEMS}, {DIM}) f32 table, ({BATCH}, {MAX_HIS}) ids")
    check_history_mean(k1, "", items, ids(BATCH * MAX_HIS, NUM_ITEMS).reshape(
        BATCH, MAX_HIS), ids(BATCH, MAX_HIS + 1))
    k1b = new_entry("history_mean_gather_bf16", "gather.cu", k1["replaces"],
                    f"({NUM_ITEMS}, {DIM}) bf16 table, ({POOL_CHUNK}, {MAX_HIS}) "
                    f"ids, bf16 means; _f32out: f32 means")
    his = ids(POOL_CHUNK * MAX_HIS, NUM_ITEMS).reshape(POOL_CHUNK, MAX_HIS)
    lens = ids(POOL_CHUNK, MAX_HIS + 1)
    check_history_mean(k1b, "", items16, his, lens)
    check_history_mean(k1b, "_f32out", items16, his, lens, torch.float32)

    # K3: the item update's ids, with repeats and about 1% sentinels
    # (id == N): config0's 8192 + 131,072 into a zeroed f32 accumulator,
    # the headline's 8192 + 512 into the bf16 item table.
    m = BATCH * (1 + NUM_NEGS)
    k3 = new_entry("scatter_add_rows", "scatter.cu",
                   "heat_tpu/ops/pallas/scatter.py:89",
                   f"({NUM_ITEMS}, {DIM}) f32 accumulator, {m} ids")
    check_scatter_add(k3, "", torch.zeros(NUM_ITEMS, DIM, device=dev),
                      with_sentinels(ids(m, NUM_ITEMS), NUM_ITEMS),
                      torch.randn(m, DIM, generator=g, device=dev))
    m = BATCH + TILE
    k3b = new_entry("scatter_add_rows_bf16", "scatter.cu", k3["replaces"],
                    f"({NUM_ITEMS}, {DIM}) bf16 table, {m} ids with repeats")
    sc_ids = ids(m, NUM_ITEMS)
    sc_ids[:64] = sc_ids[0]  # a heavy repeat
    sc_ids = with_sentinels(sc_ids, NUM_ITEMS)
    small = 0.01 * torch.randn(m, DIM, generator=g, device=dev)
    check_scatter_add(k3b, "", items16.clone(), sc_ids, small.bfloat16())
    # What repeats cost (would combining equal neighbours in a warp pay?):
    # the same two shapes with every id distinct, and config0's ids sorted,
    # so that the occurrences of a row are neighbours.
    m0 = BATCH * (1 + NUM_NEGS)
    check_scatter_add(
        k3, "_sorted_ids", torch.zeros(NUM_ITEMS, DIM, device=dev),
        ids(m0, NUM_ITEMS).sort().values,
        torch.randn(m0, DIM, generator=g, device=dev))
    check_scatter_add(
        k3b, "_unique_ids", items16.clone(),
        torch.randperm(NUM_ITEMS, generator=g, device=dev)[:m].to(torch.int32),
        small.bfloat16())

    # The update entries at the headline step's shapes (direct mode, bf16
    # tables, gradient rows in the compute type, no l2, config0's clip 1.0
    # made to bind): the item update's ids above, and the user update's
    # 8,192 ids.
    lr = torch.tensor(0.05, device=dev)
    k3u = new_entry("scatter_add_update", "scatter.cu", k3["replaces"] + " with "
                    "heat_tpu/train/scatter.py:395-401 (l2, clip, -lr, cast)",
                    f"({BIG_ITEMS}, {DIM}) f32 table, "
                    f"{BIG_BATCH + BIG_TILE} unique-or-sentinel ids, l2 first")
    k3ub = new_entry("scatter_add_update_bf16", "scatter.cu", k3["replaces"]
                     + " with heat_tpu/train/scatter.py:161-167 (clip, l2, "
                     "-lr, cast)",
                     f"({NUM_ITEMS}, {DIM}) bf16 table, {m} ids, a 64-fold "
                     f"repeat, bf16 gradient rows, clip first; _users: "
                     f"({NUM_USERS}, {DIM}), {BATCH} ids; _big_items: "
                     f"({BIG_ITEMS}, {DIM}), {BIG_BATCH + BIG_TILE} "
                     f"unique-or-sentinel ids, f32 rows, l2 first")
    check_add_update(k3ub, "", items16.clone(), sc_ids, (100 * small).bfloat16(),
                     lr, 1.0, clip_first=True)
    uid = ids(BATCH, NUM_USERS)
    uid[:64] = uid[0]
    uid[-(BATCH // 64):] = NUM_USERS
    check_add_update(k3ub, "_users", users16.clone(), uid,
                     torch.randn(BATCH, DIM, generator=g, device=dev).bfloat16(),
                     lr, 1.0, clip_first=True)
    s1u = new_entry("scatter_set_update", "scatter.cu",
                    "scripts/profile_scatter_pallas.py:65 (pallas_scatter_set) "
                    "with heat_tpu/train/scatter.py:380-390 (l2, clip, base - "
                    "lr * g, cast)",
                    f"({BIG_USERS}, {DIM}) f32, {BIG_BATCH} sorted ids, 1/8 "
                    f"sentinels, f32 base")
    s1ub = new_entry("scatter_set_update_bf16", "scatter.cu", s1u["replaces"],
                     f"({BIG_USERS}, {DIM}) bf16, {BIG_BATCH} sorted ids, 1/8 "
                     f"sentinels, bf16 base")

    k4 = check_window_extract(dev)
    s1 = check_scatter_set(dev)
    # S1 bf16: the headline's user write-back, 8,192 unsorted ids with
    # repeats carrying identical rows and a weight-0 tail of sentinels.
    s1b = new_entry("scatter_set_rows_bf16", "scatter.cu", s1["replaces"],
                    f"({NUM_USERS}, {DIM}) bf16 table, {BATCH} ids, repeats, "
                    f"sentinels")
    uid = ids(BATCH, NUM_USERS)
    uid[:64] = uid[0]
    rows = torch.randn(NUM_USERS, DIM, generator=g, device=dev).bfloat16()[uid.long()]
    uid[-(BATCH // 64):] = NUM_USERS
    check_scatter_set_at(s1b, "", users16.clone(), uid, rows)

    # S2 at the measuring script's shapes: 65,536 rows of width 128 from a
    # 91,600-row table as blocks of r rows; f32 (the JAX script's type) and
    # bf16, at r = 4 and, with key suffixes, r = 1 and 16.
    n = NUM_ITEMS // 16 * 16 + 16
    wide = torch.randn(n, S2_WIDTH, generator=g, device=dev)
    s2 = new_entry("gather_blocks", "gather.cu",
                   "scripts/profile_exact_ceiling.py:125 (gather_blocks, "
                   "_multi_row_kernel)",
                   f"({n}, {S2_WIDTH}) f32 table, {S2_ROWS} rows as blocks of "
                   f"r = 4; _r1, _r16: r = 1, 16")
    s2b = new_entry("gather_blocks_bf16", "gather.cu", s2["replaces"],
                    f"({n}, {S2_WIDTH}) bf16 table, the same blocks")
    for r, key in ((4, ""), (1, "_r1"), (16, "_r16")):
        check_gather_blocks_at(s2, key, wide, ids(S2_ROWS // r, n // r), r)
        check_gather_blocks_at(s2b, key, wide.bfloat16(),
                               ids(S2_ROWS // r, n // r), r)
    return [k2, k2b, k1, k1b, k3, k3b, k3u, k3ub, k4, s1, s1b, s1u, s1ub, s2,
            s2b]


def check_window_extract(dev) -> dict:
    """K4 at the eval tile and at the B = 8192 request, against its plain
    version: the copy is exact, so the two must be bit-equal. The library
    call is ``torch.gather`` on the (R, nw, w) view over in-range window
    ids."""
    import torch

    from heat_tpu_torch.ops.cuda import topk

    g = torch.Generator(device=dev).manual_seed(1)
    nw = I_PAD // 128
    entry = new_entry(
        "window_extract", "topk.cu",
        "scripts/profile_eval.py:264 (pallas_extract), "
        "scripts/profile_eval.py:361 (pallas_extract_slices)",
        f"({EVAL_TILE}, {I_PAD}) f32, kw {EVAL_K}; b{REQUEST_B}: "
        f"({REQUEST_B}, {I_PAD}), kw {REQUEST_K}")
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
        worst(entry, got, want)
        view = sim.view(rows, nw, 128)
        index = widx.clamp(0, nw - 1).long()[:, :, None].expand(-1, -1, 128)
        in_range = (widx >= 0) & (widx < nw)
        flat_windows = (torch.arange(rows, device=dev)[:, None] * nw
                        + widx)[in_range]
        timed(entry, key,
              lambda: topk.window_extract(sim, widx, 128),
              lambda: topk.window_extract_ref(sim, widx, 128),
              lambda: torch.gather(view, 1, index),
              # The ids, each distinct in-range (row, window) read once,
              # every output window written.
              nbytes=4 * rows * kw
              + (_distinct(flat_windows) + rows * kw) * 128 * 4, nops=0)
        del sim, got, want, view, index
    return entry


def check_scatter_set(dev) -> dict:
    """S1 against its plain version at the huge-table path's shapes:
    sorted unique ids with the last 1/8 set to the sentinel (the layout of
    the sort-dedup path's rep_ids), bit-equal on the whole table."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    entry = new_entry(
        "scatter_set_rows", "scatter.cu",
        "scripts/profile_scatter_pallas.py:65 (pallas_scatter_set)",
        f"({BIG_USERS}, {DIM}) f32, {BIG_BATCH} sorted ids, 1/8 sentinels; "
        f"_items: ({BIG_ITEMS}, {DIM}), {BIG_BATCH * (1 + BIG_NEGS)} ids")
    for n, m, key in S1_SHAPES:
        table = torch.randn(n, DIM, generator=g, device=dev)
        ids = torch.randperm(n, generator=g, device=dev)[:m].sort().values
        ids = ids.to(torch.int32)
        ids[-(m // 8):] = n
        rows = torch.randn(m, DIM, generator=g, device=dev)
        check_scatter_set_at(entry, key, table, ids, rows)
        del table
    return entry


def check_path_shapes(dev, entries: dict) -> None:
    """K2, K1 and K3 at the f32 huge-table path's shapes, S1 at the
    config0 step's write-back, and the bf16 instances of all four at the
    shapes ``bench_large`` gives them on its 16M x 6M bf16 tables (where
    64-bit offsets matter), each against its plain version; each shape's
    numbers go into the kernel's entry under a key suffix."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)

    def ids(m, hi):
        return torch.randint(0, hi, (m,), generator=g, device=dev,
                             dtype=torch.int32)

    users = torch.randn(BIG_USERS, DIM, generator=g, device=dev)
    items = torch.randn(BIG_ITEMS, DIM, generator=g, device=dev)

    # K2: a step's 32,768 user rows of the 16M table and its 524,288
    # negative rows of the 6M table.
    check_gather_rows(entries["gather_rows"], "_big_users", users,
                      ids(BIG_BATCH, BIG_USERS))
    check_gather_rows(entries["gather_rows"], "_big_negs", items,
                      ids(BIG_BATCH * BIG_NEGS, BIG_ITEMS))
    # K1: (32,768, 10) histories over the 6M item table, lengths uniform
    # in [0, 10].
    check_history_mean(
        entries["history_mean_gather"], "_big", items,
        ids(BIG_BATCH * BIG_HIS, BIG_ITEMS).reshape(BIG_BATCH, BIG_HIS),
        ids(BIG_BATCH, BIG_HIS + 1))
    # K3: direct mode's 557,056 per-occurrence adds into the 6M item
    # table, repeats and about 1% sentinels.
    m = BIG_BATCH * (1 + BIG_NEGS)
    sc_ids = ids(m, BIG_ITEMS)
    sentinel = torch.rand(m, generator=g, device=dev) < 0.01
    sc_ids = torch.where(sentinel, BIG_ITEMS, sc_ids).to(torch.int32)
    check_scatter_add(entries["scatter_add_rows"], "_big_items", items, sc_ids,
                      torch.randn(m, DIM, generator=g, device=dev))

    # The update entries on the sort-dedup path: bench_large's lr and clip
    # (made to bind by unit-normal sums), no l2. The item update's 32,896
    # representative ids (sorted, unique, the tail sentinels) with f32
    # segment sums; the user update's 32,768 with its write-back rows.
    lr = torch.tensor(0.01, device=dev)

    def sorted_reps(n, m):
        out = torch.randperm(n, generator=g, device=dev)[:m].sort().values
        out = out.to(torch.int32)
        out[-(m // 8):] = n
        return out

    def sums(m):
        return torch.randn(m, DIM, generator=g, device=dev)

    m = BIG_BATCH + BIG_TILE
    check_add_update(entries["scatter_add_update"], "", items,
                     sorted_reps(BIG_ITEMS, m), sums(m), lr, 1.0,
                     clip_first=False)
    check_set_update(entries["scatter_set_update"], "", users,
                     sorted_reps(BIG_USERS, BIG_BATCH), sums(BIG_BATCH),
                     sums(BIG_BATCH), lr, 1.0)
    del users, items

    # S1: the config0 step's user write-back, 8,192 unsorted ids into
    # 52,643 x 64 with repeats carrying identical rows (each user's row)
    # and a weight-0 tail of sentinels; bit-equal on the whole table.
    table = torch.randn(NUM_USERS, DIM, generator=g, device=dev)
    uid = ids(BATCH, NUM_USERS)
    uid[:64] = uid[0]
    rows = torch.randn(NUM_USERS, DIM, generator=g, device=dev)[uid.long()]
    uid[-(BATCH // 64):] = NUM_USERS
    check_scatter_set_at(entries["scatter_set_rows"], "_config0", table, uid, rows)
    del table, rows
    torch.cuda.empty_cache()

    # The bf16 instances at bench_large's shapes, both update modes.
    users16 = torch.randn(BIG_USERS, DIM, generator=g, device=dev).bfloat16()
    items16 = torch.randn(BIG_ITEMS, DIM, generator=g, device=dev).bfloat16()
    torch.cuda.empty_cache()

    def with_repeats_and_sentinels(i, n):
        i[:64] = i[0]  # a heavy repeat
        sentinel = torch.rand(i.shape[0], generator=g, device=dev) < 0.01
        return torch.where(sentinel, n, i).to(torch.int32)

    def small(m):  # gradient-sized rows
        return (0.01 * torch.randn(m, DIM, generator=g, device=dev)).bfloat16()

    # K2: a step's 32,768 user rows, as many rows of the (16M, 64) pools,
    # and the 128 tile rows of the 6M table.
    k2 = entries["gather_rows_bf16"]
    check_gather_rows(k2, "_big_users", users16, ids(BIG_BATCH, BIG_USERS))
    pools16 = users16.roll(1, 0)
    check_gather_rows(k2, "_big_pool", pools16, ids(BIG_BATCH, BIG_USERS))
    del pools16
    check_gather_rows(k2, "_big_tile", items16, ids(BIG_TILE, BIG_ITEMS))
    # K1: one (4,096, 10) chunk of the pools over the 6M table.
    check_history_mean(
        entries["history_mean_gather_bf16"], "_big", items16,
        ids(POOL_CHUNK * BIG_HIS, BIG_ITEMS).reshape(POOL_CHUNK, BIG_HIS),
        ids(POOL_CHUNK, BIG_HIS + 1))
    # S1: the sort-dedup path's 32,768 sorted representative ids, 1/8
    # sentinels, into the 16M table.
    rep_ids = sorted_reps(BIG_USERS, BIG_BATCH)
    check_scatter_set_at(entries["scatter_set_rows_bf16"], "_big", users16,
                         rep_ids, small(BIG_BATCH))
    check_set_update(entries["scatter_set_update_bf16"], "", users16, rep_ids,
                     sums(BIG_BATCH).bfloat16(), sums(BIG_BATCH), lr, 1.0)
    check_add_update(entries["scatter_add_update_bf16"], "_big_items", items16,
                     sorted_reps(BIG_ITEMS, BIG_BATCH + BIG_TILE),
                     sums(BIG_BATCH + BIG_TILE), lr, 1.0, clip_first=False)
    # K3: direct mode's per-occurrence adds, 32,768 into the 16M table and
    # 32,768 + 128 into the 6M table, repeats and about 1% sentinels.
    k3 = entries["scatter_add_rows_bf16"]
    check_scatter_add(
        k3, "_big_users", users16,
        with_repeats_and_sentinels(ids(BIG_BATCH, BIG_USERS), BIG_USERS),
        small(BIG_BATCH))
    m = BIG_BATCH + BIG_TILE
    check_scatter_add(
        k3, "_big_items", items16,
        with_repeats_and_sentinels(ids(m, BIG_ITEMS), BIG_ITEMS), small(m))
    del users16, items16
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


BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
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
    # The tile path (whole-tile scoring over a pinned tile and draws).
    "tile": (False, {"neg_sampler": 1}),
    "tile_sorted": (True, {"neg_sampler": 1}),
    "tile_direct": (False, {"neg_sampler": 1, "update_mode": "direct"}),
    "tile_pools_direct_l2": (False, {
        "neg_sampler": 1, "update_mode": "direct", "his_refresh": "subepoch",
        "l2_enabled": True, "l2": 0.01}),
    "tile_accum": (False, {"neg_sampler": 1, "sgd_mode": "accum"}),
    "tile_bf16": (False, {"neg_sampler": 1, **BF16}),
    "tile_bf16_sorted": (True, {"neg_sampler": 1, **BF16}),
    "tile_bf16_pools_direct": (False, {
        "neg_sampler": 1, "update_mode": "direct", "his_refresh": "subepoch",
        **BF16}),
}


def check_step_against_cpu(dev) -> dict:
    """Two train_steps on the card (kernels) against the same steps on the
    CPU (plain versions), for each branch of the update menu and of the
    tile path: small shapes, repeated ids, a weight-0 tail and the same
    negatives (the tile variants pin a tile with repeated ids and the
    draws into it; the pools variants take their pools from the state
    before each step); the sorted variants lower the port's
    DENSE_ROWS_THRESHOLD below both tables. f32 variants are held to the
    tests' rule. The bf16 variants take ONE step (a second would amplify
    a flipped rounding through the clip) and are held element by element
    to k x 2^-7 x (|value| + k x lr x clip_val), k being the occurrences of
    the element's row in the step (at least 1): one bf16 ulp where a row
    is written once, and the order-dependence of k rounded adds under
    ``direct``; ``w0`` (f32; its gradient is a bf16 product, 2^-8
    relative a rounding) to 2% of its largest move. Returns the largest state difference of each variant."""
    import numpy as np
    import torch

    import heat_tpu_torch.train.scatter as tsc
    import heat_tpu_torch.train.train_step as ts
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.aggregator import user_pools_impl
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
    t = 32
    tile = rng.integers(0, i, t).astype(np.int32)
    tile[4], tile[7] = tile[2], 5  # a repeated id; the repeated positive
    tile_idx = rng.integers(0, t, (b, k)).astype(np.int32)

    def fixed(generator, sstate, pos_ids, cfg, real=None):
        where = pos_ids.device
        state = SamplerState(sstate.iterations + pos_ids.shape[0], sstate.tile)
        if cfg.neg_sampler == 1:
            tl = torch.from_numpy(tile).to(where)
            idx = torch.from_numpy(tile_idx).to(where)
            return NegSample(tl[idx.long()], tl, idx), state
        return NegSample(torch.from_numpy(negs).to(where)), state

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
                           tile_size=t, refresh_interval=4 * b, **extra)
            bf16 = cfg.param_dtype == "bfloat16"
            dtype = torch.bfloat16 if bf16 else torch.float32
            tsc.DENSE_ROWS_THRESHOLD = 16 if sort else orig_threshold
            init = state_to_numpy(init_train_state(
                cfg, torch.Generator().manual_seed(3), "cpu"
            ))
            out = []  # (state arrays, losses) on the card, then on the CPU
            for device in (dev, torch.device("cpu")):
                def put(x):
                    return torch.from_numpy(x).to(device)

                state = state_from_numpy(**init, device=device,
                                         param_dtype=dtype)
                sstate = init_sampler_state(
                    cfg, device, torch.Generator(device=device).manual_seed(0))
                losses = []
                for _ in range(1 if bf16 else 2):
                    means = None
                    if cfg.his_refresh == "subepoch":
                        means = user_pools_impl(state.item_emb, put(his),
                                                put(masks))
                    state, sstate, loss = ts.train_step(
                        state, sstate, None,
                        ts.Batch(put(users), put(pos), put(weight)),
                        put(his), put(masks), cfg, user_means=means,
                    )
                    losses.append(float(loss))
                out.append((flat(state), losses))
            (card, card_loss), (cpu, cpu_loss) = out
            np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5,
                                       err_msg=f"{name}: losses")
            worst[name] = 0.0
            if bf16:
                real = weight > 0
                occurrences = {
                    "user_emb": np.bincount(users[real], minlength=u),
                    "item_emb": np.bincount(pos[real], minlength=i)
                    + np.bincount(tile, minlength=i),
                }
                step = cfg.l_r * cfg.clip_val
                for key, occ in occurrences.items():
                    occ = np.maximum(occ, 1)[:, None].astype(np.float64)
                    diff = np.abs(card[key] - cpu[key])
                    bound = occ * 2.0**-7 * (np.abs(cpu[key]) + occ * step)
                    if not (diff <= bound).all():
                        raise AssertionError(
                            f"step on the card vs the CPU, {name}: {key} off "
                            f"by up to {diff.max():.3g}, outside its bound"
                        )
                    worst[name] = max(worst[name], float(diff.max()))
                move = np.abs(cpu["w0"] - init["w0"]).max()
                diff = float(np.abs(card["w0"] - cpu["w0"]).max())
                if not diff <= 2e-2 * move:
                    raise AssertionError(
                        f"step on the card vs the CPU, {name}: w0 off by {diff}"
                    )
                continue
            # The tests' rule (heat_tpu_torch.testing), with atol 1e-6: K3's
            # atomics add in another order than index_add_.
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


HUGE_ENGINE_RUNS = {  # name: (config overrides, kernels launched every step)
    # dedup: the segment sums (K3), the item update (K3's update entry) and
    # the user write-back + update (S1's).
    "dedup": ({"update_mode": "dedup"}, (
        "gather_rows", "history_mean_gather", "scatter_add_rows",
        "scatter_add_update", "scatter_set_update")),
    # direct: the write-back (S1) and both per-occurrence updates.
    "direct": ({"update_mode": "direct"}, (
        "gather_rows", "history_mean_gather", "scatter_add_update",
        "scatter_set_rows")),
    # Row-sparse Adagrad on bf16 tables: the path that adds rows as they are
    # into a bf16 table (the plain K3 bf16 instance, item update) and writes
    # f32 rows into one (S1's conversion, user write-back + update).
    "adagrad_bf16": ({"optimizer": "adagrad", "param_dtype": "bfloat16",
                      "compute_dtype": "bfloat16"}, (
        "gather_rows_bf16", "history_mean_gather_bf16",
        "scatter_add_rows_bf16", "scatter_set_rows_bf16")),
}


def check_huge_f32(dev, reset, read) -> dict:
    """The huge-table path without the tile sampler (uniform sampler,
    per-step history mean, tables of 16,000,000 x 6,000,000 rows, both
    above the threshold) on a dataset cut to BIG_F32_STEPS batches: per run
    of HUGE_ENGINE_RUNS (f32 in both update modes, and bf16 tables under
    Adagrad) a warm-up ``Engine.train_one_epoch`` and a timed one (it ends
    by reading the loss, a device sync). It keeps the f32 sort-dedup path,
    K1 at (32,768, 10), K2 at 524,288 negatives and S1 / K3 at the 16M table
    on a main path, with their launch counts over the timed epoch and the
    peak memory against the bytes held."""
    import torch

    from heat_tpu_torch import bench_large
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.train.engine import Engine

    steps = BIG_F32_STEPS
    dataset = bench_large.make_dataset(
        BIG_USERS, BIG_ITEMS, steps * BIG_BATCH, BIG_HIS)
    out = {}
    for mode, (overrides, every_step) in HUGE_ENGINE_RUNS.items():
        torch.cuda.empty_cache()
        cfg = CFConfig(emb_dim=DIM, num_negs=BIG_NEGS, max_his=BIG_HIS,
                       batch_size=BIG_BATCH, l_r=0.01, clip_val=1.0,
                       milestones=[10], seed=2022, **overrides)
        engine = Engine(cfg, dataset, device=dev)
        st = engine.state
        slots = list(st.opt_slots.values()) if st.opt_slots else []
        held = sum(t.numel() * t.element_size() for t in (
            st.user_emb, st.item_emb, st.w0, engine.pairs, engine.his_items,
            engine.his_masks, *slots))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = [engine.train_one_epoch()]  # warm-up
        reset()
        t0 = time.perf_counter()
        losses.append(engine.train_one_epoch())
        ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = read()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"huge {mode}: losses {losses}")
        bf16 = cfg.param_dtype == "bfloat16"
        for name in every_step:
            if launches[name] < steps:
                raise AssertionError(
                    f"huge {mode}: {name} launched {launches[name]} times "
                    f"in {steps} steps")
        if not bf16 and any(n for name, n in launches.items()
                            if name.endswith("_bf16")):
            raise AssertionError(f"huge {mode}: a bf16 kernel ran: {launches}")
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"huge {mode}: {steps} steps an epoch, {ms:.3f} ms a step "
              f"({BIG_BATCH / ms * 1e3:.0f} interactions/s); epoch losses "
              f"{losses}; launches {launches}; peak device memory "
              f"{peak / 1e9:.3f} GB against {held / 1e9:.3f} GB held "
              f"({peak / held:.3f}x)")
        if mode == "dedup" and peak > MEM_RATIO * held:
            raise AssertionError(
                f"huge f32 dedup: peak device memory {peak} B above "
                f"{MEM_RATIO} x {held} B held: a step-time table copy?"
            )
        out[mode] = {"ms_per_step": ms, "steps": steps, "launches": launches,
                     "peak_device_bytes": peak, "held_bytes": held}
        del engine, st
    return out


def check_huge_training(reset, read) -> dict:
    """bench_large at its default geometry and configuration (tile sampler
    with the tile from "auto", cached pools, bf16), dedup then direct mode
    (see the docstring); returns each run's record with its launch
    counts."""
    import torch

    from heat_tpu_torch import bench_large

    out = {}
    for mode in ("dedup", "direct"):
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        record = bench_large.run(["--update-mode", mode, "--reps", "1",
                                  "--profile", str(PROFILE_STEPS)])
        wall = time.perf_counter() - t0
        launches = read()
        print(json.dumps(record))
        losses = record["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"bench_large {mode}: losses {losses}")
        if mode == "dedup" and not record["sorted_dedup_path"]:
            raise AssertionError("bench_large dedup: not on the sort-dedup path")
        if record["reduced"] != bench_large.REDUCED or len(record["reduced"]) != 1:
            raise AssertionError(f"bench_large: reduced {record['reduced']}")
        if (record["param_dtype"], record["his_refresh"]) != ("bfloat16", "subepoch"):
            raise AssertionError("bench_large: not bf16 with cached pools")
        if record["tile_size"] != BIG_TILE:
            raise AssertionError(
                f"bench_large: tile {record['tile_size']}, but the kernels "
                f"were checked at {BIG_TILE} tile rows")
        steps = record["steps"]
        # Per step: K2 for the user, pool, positive and tile rows; S1 and
        # K3 in both modes; K1 only for the pools (3,907 chunks an epoch),
        # all on bf16 tables (the segment sums' K3 adds into f32 buffers).
        chunks = 2 * -(-record["users"] // POOL_CHUNK)
        need = {"gather_rows_bf16": 4 * steps, "history_mean_gather_bf16": chunks}
        if mode == "dedup":  # segment sums; item update; user write-back + update
            need.update({"scatter_add_rows": 2 * steps,
                         "scatter_add_update_bf16": steps,
                         "scatter_set_update_bf16": steps})
        else:  # the write-back, then both per-occurrence updates
            need.update({"scatter_set_rows_bf16": steps,
                         "scatter_add_update_bf16": 2 * steps})
        for name, least in need.items():
            if launches[name] < least:
                raise AssertionError(
                    f"bench_large {mode}: {name} launched {launches[name]} "
                    f"times in {steps} steps, expected >= {least}"
                )
        held = record["state_bytes"] + record["data_bytes"] + record["pools_bytes"]
        peak = record["peak_device_bytes"]
        print(f"bench_large {mode}: {wall:.1f} s in all; launches {launches}; "
              f"peak device memory {peak / 1e9:.3f} GB against "
              f"{held / 1e9:.3f} GB of state, data and pools held "
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
    from heat_tpu_torch import profile_exact_ceiling
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
    check_path_shapes(dev, {k["name"]: k for k in kernels})
    for k in kernels:
        for key in [key for key in k if key == "ms" or key.startswith("ms_")]:
            suffix = key[2:]
            def of(prefix):
                return " / ".join(
                    "none" if k[prefix + what + suffix] is None
                    else format(k[prefix + what + suffix], ".4f")
                    for what in ("ms", "loop_ms", "graph_ms"))

            print(f"kernel {k['name']}{' at ' + suffix[1:] if suffix else ''}: "
                  f"ms / loop_ms / graph_ms {of('')} (plain {of('plain_')}; "
                  f"PyTorch call {of('library_')}); host_us "
                  f"{k['host_us' + suffix]:.2f} (PyTorch call "
                  f"{k['library_host_us' + suffix] or float('nan'):.2f}); "
                  f"bound {k['bound_ms' + suffix]:.4f} ms by "
                  f"{k['bound_by' + suffix]}")
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, {k['shape']}")
    print(f"train_step card vs CPU, max state diff per branch: "
          f"{json.dumps(check_step_against_cpu(dev))}")

    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    untrained = cli.main(args + ["--epochs", "0"])["final_metrics"]
    print(f"untrained: {json.dumps(untrained)}")

    counters = [gather.LAUNCHES, scatter.LAUNCHES, topk.LAUNCHES]

    def reset():
        for d in counters:
            for name in d:
                d[name] = 0

    def read():
        return {name: n for d in counters for name, n in d.items()}

    def check_run(what, record, launches, least):
        """The checks every full training run is held to: five finite
        epoch losses that fall, metrics in range, every eval tile through
        K4, and each kernel of ``least`` launched at least that often."""
        losses = record["losses"]
        if len(losses) != 5 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: expected 5 finite epoch losses, got {losses}")
        if not losses[4] < losses[0]:
            raise AssertionError(f"{what}: loss did not fall: {losses}")
        for name, n in least.items():
            if launches[name] < n:
                raise AssertionError(
                    f"{what}: {name} launched {launches[name]} times on the "
                    f"main path, expected >= {n}"
                )
        final = record["final_metrics"]
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in final.values()):
            raise AssertionError(f"{what}: metrics out of range: {final}")
        if not final["Recall(k=20)"] >= 10 * untrained["Recall(k=20)"]:
            raise AssertionError(
                f"{what}: Recall(k=20) {final['Recall(k=20)']} < 10 x untrained "
                f"{untrained['Recall(k=20)']}"
            )
        print(f"{what}: epoch losses: {losses}")
        print(f"{what}: epoch seconds: {record['epoch_times']}")
        print(f"{what}: periodic evals: "
              f"{[(e['epoch'], e['seconds']) for e in record['evals']]}")
        print(f"{what}: final eval seconds: {record['final_eval_s']}")
        print(f"{what}: steps: {record['steps']}; launches: {launches}")
        print(f"{what}: final metrics: {json.dumps(final)}")

    eval_tiles = 3 * -(-NUM_USERS // EVAL_TILE)  # two periodic evals + final

    # config0 at full width (f32, uniform sampler, per-step history mean).
    EXPORT.parent.mkdir(parents=True, exist_ok=True)
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    record = cli.main(args + ["--export-embeddings", str(EXPORT)])
    launches = read()
    steps = record["steps"]
    check_run("config0", record, launches, {
        "gather_rows": steps, "history_mean_gather": steps,
        "scatter_add_rows": steps, "scatter_set_rows": steps,
        "window_extract": eval_tiles})
    if any(n for name, n in launches.items() if name.endswith("_bf16")):
        raise AssertionError(f"config0 launched a bf16 kernel: {launches}")
    print(f"peak device memory (training run): "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    final = record["final_metrics"]

    # The headline configuration at full width: tile sampler with
    # whole-tile scoring, cached pools, bf16 tables and compute, direct.
    reset()
    head = cli.main(args + [x for kv in HEADLINE for x in ("--set", kv)])
    head_launches = read()
    steps = head["steps"]
    pool_chunks = 5 * -(-NUM_USERS // POOL_CHUNK)  # once an epoch
    check_run("headline", head, head_launches, {
        # user, positive, tile and pool rows; the pools; the user and the
        # item update (K3's update entry); the user write-back: all on bf16
        # tables.
        "gather_rows_bf16": 4 * steps, "history_mean_gather_bf16": pool_chunks,
        "scatter_add_update_bf16": 2 * steps, "scatter_set_rows_bf16": steps,
        "window_extract": eval_tiles})
    if head_launches["scatter_add_rows"]:
        raise AssertionError(
            f"headline: the plain scatter-add ran beside its update entry: "
            f"{head_launches}")
    for name in ("gather_rows", "history_mean_gather", "scatter_add_update",
                 "scatter_set_rows"):
        if head_launches[name] != head_launches[name + "_bf16"]:
            raise AssertionError(f"headline launched an f32 {name}: {head_launches}")
    if head_launches["history_mean_gather"] != pool_chunks:
        raise AssertionError(
            f"headline: K1 launched {head_launches['history_mean_gather']} "
            f"times, not once per pool chunk per epoch ({pool_chunks})"
        )
    head_final = head["final_metrics"]
    gap = head_final["Recall(k=20)"] - final["Recall(k=20)"]
    print(f"headline vs config0: Recall@20 {head_final['Recall(k=20)']:.6f} vs "
          f"{final['Recall(k=20)']:.6f} (gap {gap:+.6f}, band {RECALL_BAND}); "
          f"NDCG@50 {head_final['NDCG(k=50)']:.6f} vs {final['NDCG(k=50)']:.6f}; "
          f"median epoch {statistics.median(head['epoch_times']):.4f} s vs "
          f"{statistics.median(record['epoch_times']):.4f} s")
    if not abs(gap) <= RECALL_BAND:
        raise AssertionError(
            f"headline Recall@20 {head_final['Recall(k=20)']} is not within "
            f"{RECALL_BAND} of config0's {final['Recall(k=20)']}"
        )

    reset()
    serving = check_serving(dev, final["Recall(k=20)"])
    serving.update(check_huge_table(dev))
    serving_launches = read()
    for name in ("gather_rows", "history_mean_gather", "window_extract"):
        if serving_launches[name] < 1:
            raise AssertionError(f"{name} was not launched by serving")
    print(f"serving: {json.dumps(serving)}")
    print(f"serving launches: {serving_launches}")

    huge_f32 = check_huge_f32(dev, reset, read)
    huge = check_huge_training(reset, read)
    # The headline step at its own geometry through the same entry point,
    # for its launches per step (a warm-up and one timed epoch, then
    # PROFILE_STEPS steps timed and as many traced).
    from heat_tpu_torch import bench_large

    head_profile = bench_large.run([
        "--users", str(NUM_USERS), "--items", str(NUM_ITEMS), "--clicks",
        "1895148", "--max-his", str(MAX_HIS), "--batch", str(BATCH), "--tile",
        str(TILE), "--refresh", "8192", "--update-mode", "direct", "--reps",
        "1", "--profile", str(PROFILE_STEPS)])["profile"]
    per_step = {
        "headline": head_profile, "dedup_16m_6m": huge["dedup"]["profile"],
        "direct_16m_6m": huge["direct"]["profile"]}
    print(json.dumps({"launches_per_step": {
        name: {"before": LAUNCHES_BEFORE.get(name),
               "after": p["device_launches_per_step"],
               "device_ms_per_step": p["device_ms_per_step"],
               "wall_ms_per_step": p["wall_ms_per_step"],
               "idle_share": p["idle_share"]}
        for name, p in per_step.items()}}))
    step = check_huge_step(dev)
    if min(step["launches"][name] for name in
           ("scatter_set_update", "scatter_add_update", "scatter_add_rows")) < 1:
        raise AssertionError(
            f"the full-size dedup update did not launch the segment sums and "
            f"both update entries: {step['launches']}")
    print(f"full-size dedup update, card vs CPU: max touched-row diff "
          f"{step['max_abs_diff']:.3g}; untouched rows bit-equal; "
          f"launches {step['launches']}")

    # S2's path: the measuring entry point, at a reduced iteration count.
    reset()
    ceiling = profile_exact_ceiling.run(["--iters", "10"])
    ceiling_launches = read()
    print(json.dumps(ceiling))
    # Per r and type: the checked call, 3 warm-ups and 10 timed calls.
    s2_calls = 14 * len(ceiling["blocks"])
    if (ceiling_launches["gather_blocks_bf16"] < s2_calls
            or ceiling_launches["gather_blocks"] < 2 * s2_calls):
        raise AssertionError(
            f"profile_exact_ceiling launched S2 "
            f"{ceiling_launches['gather_blocks']} times, "
            f"{ceiling_launches['gather_blocks_bf16']} of them in bf16"
        )

    # Each instance's launches on its own main path: the f32 instances on
    # config0 (K4 too), the bf16 instances on the headline run, S2 on its
    # measuring entry point; the update entries' f32 instances on the f32
    # huge-table run in dedup mode, S1's bf16 update entry on bench_large in
    # dedup mode, and the plain K3 bf16 instance (whose headline callers now
    # use the update entry) on the bf16 Adagrad huge-table run.
    dedup_f32 = huge_f32["dedup"]["launches"]
    on_path = {
        "gather_blocks": (ceiling_launches["gather_blocks"]
                          - ceiling_launches["gather_blocks_bf16"]),
        "gather_blocks_bf16": ceiling_launches["gather_blocks_bf16"],
        "scatter_add_update": dedup_f32["scatter_add_update"],
        "scatter_set_update": dedup_f32["scatter_set_update"],
        "scatter_set_update_bf16":
            huge["dedup"]["launches"]["scatter_set_update_bf16"],
        "scatter_add_rows_bf16":
            huge_f32["adagrad_bf16"]["launches"]["scatter_add_rows_bf16"],
    }
    for k in kernels:
        name = k["name"]
        if name in on_path:
            k["launches"] = on_path[name]
        elif name.endswith("_bf16"):
            k["launches"] = head_launches[name]
        else:
            k["launches"] = launches[name] - launches.get(name + "_bf16", 0)
        if k["launches"] < 1:
            raise AssertionError(f"{name} was not launched on its main path")
        k["launches_serving"] = serving_launches[name]
        for mode in HUGE_ENGINE_RUNS:
            k[f"launches_huge_f32_{mode}"] = huge_f32[mode]["launches"][name]
        for mode in ("dedup", "direct"):
            k[f"launches_huge_{mode}"] = huge[mode]["launches"][name]
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
