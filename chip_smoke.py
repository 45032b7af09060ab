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
   shapes, f32 and bf16 at r = 1, 4, 16 (bit-equal). K1 with the user
   indirection at config0's step (8,192 ``rows`` into the (52,643, 100)
   history table) and over whole tables of pools in one launch into a given
   buffer ((52,643, 100) and (16,000,000, 10) histories, bf16; the latter
   held chunk by chunk), and that a user's mean has the same bits at any
   position of any batch under one split of the history. K2's multi-table
   entry at the row reads of the config0, headline and 16M x 6M steps and
   with f32 tables read into bf16 (bit-equal to ``index_select`` and the
   cast). Then train steps on the
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
   instances only. Every training epoch on the card runs each step as
   one replay of the captured step; a wrapper counts a launch where it
   launches (the capture's eager warm-up step, the capture itself, and
   everything eager), so the kernels of the replayed steps are counted
   from device traces (``bench_large.profile_steps``: per step, the port's
   kernels by family, equal in the eager and the replayed steps and equal
   to the wrappers' counts over the eager ones) at config0, the headline
   geometry, 16M x 6M in both update modes and the f32 huge-table runs.
   Then config0 again through the CLI's
   ``--fused-epochs 5`` and ``--fused-run`` (the same checks, Recall@20
   within RECALL_BAND of the default run's); then, from one seed, three
   engines each of config0 and the headline (two epochs: an epoch boundary
   with its eager shuffle) and of bench_large's 16M x 6M bf16 dedup
   geometry (one epoch): eager, eager again and replayed. The replayed
   draws (every negative, tile and tile index; fingerprints at 16M x 6M)
   equal the eager ones, ``step`` and ``iterations`` are equal, and the
   per-step losses, ``w0`` and tables lie within twice the eager-vs-eager
   spread by root mean square (K3's atomics add in no fixed order); and,
   in config0's and the headline's configurations on 48 clicks in which no
   user and no item repeats (batch 16, 4,000,000 items: no row takes two
   adds in a step, so the step is deterministic), two epochs of three
   steps eager, eager again and replayed are bit-equal after each epoch
   (``heat_tpu_torch.testing.replayed_equals_eager``). Then sub-epochs
   (``check_subepochs``): the reference's default run shape
   (DEFAULT_SHAPE: the headline with ``num_subepochs: 2``, global scope)
   through the CLI plain, ``--fused-epochs 5`` and ``--fused-run``, each
   held to the run checks and its Recall@20 to RECALL_BAND of config0's,
   with each sub-epoch's steps, the captures (one a run), K1's launches
   (one pool refresh a sub-epoch) and the host's share of each epoch;
   that shape replayed against eager over two epochs, and config0's and
   that shape's configurations with two sub-epochs bit-equal on the
   distinct clicks; complement scope on config0 with two sub-epochs, the
   uniform and the tile sampler, eager and replayed, every negative a step
   reads outside its sub-epoch's partition; the device trace of a replayed
   sub-epoch step, equal to the headline step's;
5. serving: the exported model in a ``Recommender`` on the card, requests
   of 1, 256 and 8192 users timed and held against ``recommend_all``, the
   Recall@20 of every user's requested top-20 against the run's final
   eval, aggregated-user requests and cold-start users against plain
   oracles, with the launch counts read around the phase; then the
   headline run's export served from bf16 tables (the main path of K2's
   single bf16 instance and of K1 bf16 with ``rows``);
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
   memory against the bytes held (nothing subtracted: the live blocks
   left by earlier phases are printed); one epoch (after a warm-up epoch)
   at that geometry in dedup mode with two sub-epochs, its peak device
   memory held to MEM_RATIO of the bytes held; then one full-size
   sort-dedup update of both tables on the card against the same update
   on the CPU (plain versions), untouched rows bit-equal to before; then
   the launches per
   step (device events under ``torch.profiler`` over PROFILE_STEPS steps)
   of the headline step and of both 16M x 6M steps, on a line
   ``{"launches_per_step": ...}`` (the eager steps), and on a line
   ``{"eager_vs_replayed": ...}`` the eager and the replayed steps' wall
   and device ms, idle share, launches and peak memory against the bytes
   held, the graph pool,
   config0's CLI epoch seconds in its three forms and the replay phase's
   spreads and host time per replay call;
8. ``heat_tpu_torch.profile_exact_ceiling`` at 10 timed calls per
   measurement: the one path that runs S2;

The attention aggregators (ROADMAP item 12) add, in phase 3, K2's
multi-table entry at the attention steps' reads (``_attn``: the (B, H)
history rows beside the step's rows) and its single entry at a chunk of
the user-attention pools, and the card-vs-CPU step in five attention
variants; in phase 4, after the sub-epochs, ``check_attention``: config0
with self-attention through the CLI (plain, exported, and
``--fused-epochs 5``) and the JAX bench's three ACCL rows (``accl_user_s``,
``accl_self_s``, ``accl_self_grouped_s``), each held to the run checks, to
K1 never running, runs 1-3 to RECALL_BAND of config0's Recall@20, the
dedup maps on the grouped stream and ``attn_q`` moving; the grouped run
with the dedup against two without it (DEDUP_BAND); replayed against eager
at config0 self-attention and accl_user_s, and bit-equal on the distinct
clicks; the device traces of replayed and eager steps; in phase 5 the
self-attention export served (``check_serving_attention``); in phase 7
``bench_large --aggregator user_attention`` at 16M x 6M in dedup mode
(``check_huge_attention``, peak at most MEM_RATIO); and, before the
kernels' line, the plain pooling's time against K2's and the replayed
step's (``time_pooling``) on a line ``{"attention": ...}``;
The run's lifecycle (ROADMAP items 8, 14, 17) adds, in phase 4 right
after the headline run, the full-scale gate (``check_gate``): this data's
pair counts and SHA-256 against ``PARITY_TORCH.json``, the JAX package's
record of the same schedule on the CPU (``scripts/torch_parity_gate.py``),
config0's Recall@20 and NDCG@50 within 0.0003 of its values, the
headline's within 0.0015; in the replay phase, the host's seconds to save
and restore a checkpoint of the 16M x 6M bf16 state; after the attention
phases, resume bit for bit on the distinct clicks, in config0's and the
default shape's configurations, into a fresh engine and into the engine
that captured (``check_resume_distinct``); config0 and the default shape
through the CLI, 3 epochs then resumed to 5 with ``--checkpoint-dir``,
against three uninterrupted runs (``check_resume_cli``: draws, ``step``,
``iterations`` and the generators exact, tables, ``w0`` and step losses
within twice the spread pooled over the runs' pairs, each epoch loss its
steps' sum); ``--profile-dir`` (the trace of a replayed epoch names
the port's kernels, ``check_profile_dir``); ``--breakdown`` (the phases'
sum against the run's wall, and the cost of the phase timer's syncs,
``check_breakdown``); the native parser and hit matrix on the full data,
against numpy and timed, the native path required (``check_native``); and
a ``{"lifecycle": ...}`` line before the kernels' line.

Approximate top-k (ROADMAP item 16) and the wider gate (8b) add, in
phase 3, K4 timed over buffers that do not fit in L2 (ROTATE_BYTES of
scores, window ids and outputs turned over launch by launch; the replay of
one set beside it as ``graph_ms_same_buffers``); in phase 4, after
config0's fused runs, this slice's own main path, config0 through the CLI
with ``--eval-approx 0.95`` (``check_eval_approx_cli``: the periodic
evaluations with ``exact=False``, the final one without it, each through
K4 once an eval tile, the parser's refusals of ``--eval-approx 0`` and of
``--fused-run`` with it); after the attention phases the gate's two
configurations no other phase trains (``check_gated_runs``: the headline
with CosineContrastiveLoss, the default shape under complement scope),
and every gated run (GATED_RUNS: the default shape's plain CLI run,
config0 self-attention, accl_user_s, accl_self_s and those two) against
its JAX twin within its band; in phase 5 ``check_approx``:
``evaluate(exact=False)`` against ``evaluate()`` on config0's export, the
top ids and a B = 8192 request equal, the times of both calls (whole
evaluation, the request), and at the eval tile and at B = 8192 the
two-phase selection timed beside one ``torch.topk`` over the masked row,
the form ``approx_max_k`` takes off a TPU, which the port does not use.

9. the kernels' JSON line (each instance with its launches on its own main
   path: f32 on config0, bf16 on the headline run, K2's single entry on
   serving, S2 on its script; and ``launches_eval_approx``, on the
   ``--eval-approx`` run), the
   card's line, and last ``{"ok": true, "device": {...}}``.

Fails without a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import itertools
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
TILE, POOL_CHUNK = 512, 4096  # the headline's tile; a K1 shape kept from chunked pools
PLAIN_CHUNK = 1 << 20  # users a call of K1's plain version over 16M histories
# The headline configuration of the JAX package's bench.py, on config0.
HEADLINE = ["neg_sampler=1", "tile_size=512", "refresh_interval=8192",
            "his_refresh=subepoch", "param_dtype=bfloat16",
            "compute_dtype=bfloat16", "update_mode=direct"]
RECALL_BAND = 0.0015  # headline Recall@20 against the f32 config0 run's
# The reference's default run shape (cf_config.py:7 pairs the tile sampler
# with num_subepoches = 2): the headline with two sub-epochs, global scope
# (bench.py:515-517). The JAX package's full-scale Recall@20 at this shape
# and exact (PARITY.md:102, README.md:39): a quality record, not a speed.
DEFAULT_SHAPE = HEADLINE + ["num_subepochs=2"]
JAX_DEFAULT_SHAPE_RECALL, JAX_EXACT_RECALL = 0.0122, 0.0126
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
HUGE_TRACE_STEPS = 10  # steps timed, then traced, after its epochs
S1_SHAPES = (  # (table rows, ids, key suffix): user and item sides
    (BIG_USERS, BIG_BATCH, ""),
    (BIG_ITEMS, BIG_BATCH * (1 + BIG_NEGS), "_items"),
)
MEM_RATIO = 1.25  # peak device memory / bytes held, at most
# The bit-equal replay check: clicks (= users), items (below the dense-path
# threshold), batch, negatives, tile and tile refresh.
DISTINCT_CLICKS, DISTINCT_ITEMS = 48, 4_000_000
DISTINCT_SETS = {"batch_size": 16, "num_negs": 2}
DISTINCT_TILE_SETS = {"tile_size": 16, "refresh_interval": 32}
PROFILE_STEPS = 50  # steps timed, then traced, for the launches per step
# Device launches per step before the step read its rows in one launch,
# traced by the same command on that tree (NVIDIA H100 80GB HBM3).
LAUNCHES_BEFORE = {"headline": 165, "dedup_16m_6m": 225, "direct_16m_6m": 165}
EXPORT = Path(__file__).resolve().parent / "build" / "chip_smoke" / "config0.npz"
EXPORT_HEADLINE = EXPORT.with_name("headline.npz")
# The attention aggregators (ROADMAP item 12): config0 with self-attention,
# and the JAX bench's three ACCL rows (bench.py:602-640): user attention
# over the headline's cached pools; self attention, which needs the history
# pooled every step; and that on the user-grouped stream, where the history
# dedup with the first-occurrence map applies.
CONFIG0_SELF = ["aggregator=self_attention"]
ACCL_USER = HEADLINE + ["aggregator=user_attention"]
ACCL_SELF = [kv for kv in HEADLINE if not kv.startswith("his_refresh=")] + [
    "his_refresh=step", "aggregator=self_attention"]
ACCL_SELF_GROUPED = ACCL_SELF + ["shuffle_mode=none", "visit_order=user"]
EXPORT_SELF = EXPORT.with_name("self_attention.npz")
DEDUP_BAND = 0.0003  # dedup against no dedup: at least this, or 2x the spread
# The full-scale gate (heat_tpu_torch.parity): every configuration this
# script trains through the CLI at the record's schedule (5 epochs, the
# evaluations after epochs 2 and 4, a final exact one), by the record's
# run name, with its overrides of config0. bench.py's ccl_s row, and the
# default shape under complement scope.
HEADLINE_CCL = HEADLINE + ["loss=CosineContrastiveLoss"]
COMPLEMENT = DEFAULT_SHAPE + ["subepoch_neg_scope=complement"]
GATED_RUNS = {
    "config0": [], "headline": HEADLINE, "default_shape": DEFAULT_SHAPE,
    "config0_self_attention": CONFIG0_SELF, "accl_user_s": ACCL_USER,
    "accl_self_s": ACCL_SELF, "headline_ccl": HEADLINE_CCL,
    "complement": COMPLEMENT,
}
APPROX_RECALL = 0.95  # --eval-approx, and exact=False against exact
# K4's timed launches rotate over buffers (scores, window ids, outputs) of
# this many bytes in all, so that no launch finds its windows in the
# H100's 50 MB L2.
ROTATE_BYTES = 256 << 20


def attn_pool_chunk(his: int, elem: int = 2) -> int:
    """Users a chunk of the attention pools at width DIM (the port's
    ``models/aggregator.py`` POOL_CHUNK_BYTES of history rows)."""
    from heat_tpu_torch.models.aggregator import POOL_CHUNK_BYTES

    return POOL_CHUNK_BYTES // (his * DIM * elem)


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


def hold_history_mean(got, table, his, lens, out_dtype=None, rows=None,
                      order_term=False) -> None:
    """K1's result against its plain version. f32: the kernel sums each
    lane group's history slots in order and then the groups, the plain
    version blocked; any order is within H x 2^-24 x sum|x| / len of the
    exact sum: rtol 1e-5, atol 1e-6. bf16: within one bf16 ulp (2^-7 of
    its magnitude) of the f32-accumulated mean of the same rows; with
    ``order_term`` plus that f32 bound on the order of the sum, which alone
    decides where a mean cancels to nearly nothing (over 10^9 elements some
    do)."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    if got.dtype == torch.bfloat16:
        exact = gather.history_mean_gather_ref(table, his, lens, torch.float32,
                                               rows)
        err = (got.float() - exact).abs()
        bound = 2.0**-7 * exact.abs() + 1e-30
        if order_term:
            bound += his.shape[1] * 2.0**-24 * gather.history_mean_gather_ref(
                table.abs(), his, lens, torch.float32, rows)
        if not bool((err <= bound).all()):
            at = int((err - bound).argmax())
            raise AssertionError(
                f"K1 bf16 at {tuple(got.shape)} of {tuple(his.shape)}: further "
                f"than one bf16 ulp from the f32-accumulated mean: "
                f"{float(got.flatten()[at])} against {float(exact.flatten()[at])}"
                f", {int((err > bound).sum())} elements"
            )
    else:
        want = gather.history_mean_gather_ref(table, his, lens, out_dtype, rows)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _bags(his, lens):
    """(flat valid ids, offsets, their count) of (B, H) histories: the
    inputs of ``embedding_bag``, made beforehand."""
    import torch

    n = lens.clamp(0, his.shape[1])
    valid = torch.arange(his.shape[1], device=his.device)[None, :] < n[:, None]
    return his[valid].long(), torch.cumsum(n, 0) - n, int(n.sum())


def check_history_mean(entry, key, table, his, lens, out_dtype=None,
                       rows=None) -> None:
    """K1 at one shape, held by :func:`hold_history_mean`. With ``rows`` the
    kernel reads sample b's history ``his[rows[b]]`` itself. The library
    call is ``embedding_bag(mode="mean")`` over the valid ids, flattened
    beforehand; with ``rows`` after the two ``index_select`` calls that
    fetch the samples' ids and lengths, which the kernel no longer needs."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    got = gather.history_mean_gather(table, his, lens, out_dtype, rows=rows)
    torch.cuda.synchronize()
    hold_history_mean(got, table, his, lens, out_dtype, rows)
    worst(entry, got, gather.history_mean_gather_ref(table, his, lens,
                                                     out_dtype, rows))
    b, d = got.shape
    if rows is None:
        flat, offsets, rows_read = _bags(his, lens)

        def library():
            return torch.nn.functional.embedding_bag(
                flat, table, offsets, mode="mean")
    else:
        idx = rows.long()
        flat, offsets, rows_read = _bags(his.index_select(0, idx),
                                         lens.index_select(0, idx))

        def library():
            his.index_select(0, idx)
            lens.index_select(0, idx)
            return torch.nn.functional.embedding_bag(
                flat, table, offsets, mode="mean")

    timed(entry, key,
          lambda: gather.history_mean_gather(table, his, lens, out_dtype,
                                             rows=rows),
          lambda: gather.history_mean_gather_ref(table, his, lens, out_dtype,
                                                 rows),
          library,
          # This run's valid ids and the lengths (and the rows), each distinct
          # table row they name read once (a row read again comes from cache,
          # not from memory), the means written; one add per valid element.
          nbytes=_distinct(flat) * d * table.element_size() + 4 * rows_read
          + 4 * b * (1 if rows is None else 2) + b * d * got.element_size(),
          nops=rows_read * d)


def check_pools(entry, key, table, his, lens, plain_chunk=None) -> None:
    """K1 over every user's history in ONE launch into a given buffer (what
    ``user_pools_impl`` does on the card), held by
    :func:`hold_history_mean`, ``plain_chunk`` users at a time where the
    plain version's (U, H, d) f32 buffer would not fit (it is then not
    timed). The library call is ``embedding_bag`` over the valid ids."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    u, d = his.shape[0], table.shape[1]
    out = torch.empty((u, d), dtype=table.dtype, device=table.device)
    before = gather.LAUNCHES["history_mean_gather"]
    got = gather.history_mean_gather(table, his, lens, out=out)
    torch.cuda.synchronize()
    if got is not out or gather.LAUNCHES["history_mean_gather"] != before + 1:
        raise AssertionError("K1 over the whole pools: not one launch in place")
    step = plain_chunk or u
    for lo in range(0, u, step):
        hold_history_mean(got[lo:lo + step], table, his[lo:lo + step],
                          lens[lo:lo + step], order_term=True)
    worst(entry, got[:step], gather.history_mean_gather_ref(
        table, his[:step], lens[:step]))
    flat, offsets, rows_read = _bags(his, lens)
    timed(entry, key,
          lambda: gather.history_mean_gather(table, his, lens, out=out),
          None if plain_chunk else
          (lambda: gather.history_mean_gather_ref(table, his, lens)),
          lambda: torch.nn.functional.embedding_bag(
              flat, table, offsets, mode="mean"),
          nbytes=_distinct(flat) * d * table.element_size() + 4 * rows_read
          + 4 * u + u * d * out.element_size(),
          nops=rows_read * d)


def check_same_bits(table, his, lens, rows) -> None:
    """The order of K1's sum depends on the valid length and the split of
    the history over lanes only: under one split a user's mean has the same
    bits in the table of all pools, at any position of a batch of ``rows``
    and in a batch of another size (another grid)."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    few = rows[:256].contiguous()
    for split in (1, 2):
        every = gather.history_mean_gather(table, his, lens, split=split)
        batch = gather.history_mean_gather(table, his, lens, rows=rows,
                                           split=split)
        short = gather.history_mean_gather(table, his, lens, rows=few,
                                           split=split)
        torch.cuda.synchronize()
        if not (torch.equal(batch, every[rows.long()])
                and torch.equal(short, batch[:256])):
            raise AssertionError(
                f"K1 {table.dtype}, split {split}: a user's mean differs "
                f"between batches")


def check_gather_multi(entry, key, segments, out_dtype) -> None:
    """K2's multi-table entry at one step's row reads: every segment
    bit-equal to its plain version (``index_select`` and the cast). The
    library yardstick is that sequence of PyTorch calls over ids made int64
    beforehand; the bound is the sum of the segments' bytes."""
    import torch

    from heat_tpu_torch.ops.cuda import gather

    got = gather.gather_rows_multi(segments, out_dtype)
    want = gather.gather_rows_multi_ref(segments, out_dtype)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(
                f"K2 gather_rows_multi{key}: segment {k} disagrees with its "
                f"plain version")
        worst(entry, g, w)
    longs = [ids.long() for _, ids in segments]

    def library():
        for (table, _), ids in zip(segments, longs):
            rows = table.index_select(0, ids)
            if out_dtype is not None and out_dtype != table.dtype:
                rows = rows.to(out_dtype)

    nbytes = sum(
        4 * ids.shape[0]
        + _distinct(ids) * table.shape[1] * table.element_size()
        + out.numel() * out.element_size()
        for (table, ids), out in zip(segments, got))
    del got, want
    timed(entry, key,
          lambda: gather.gather_rows_multi(segments, out_dtype),
          lambda: gather.gather_rows_multi_ref(segments, out_dtype),
          library, nbytes=nbytes, nops=0)


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
    # K1 reading the samples' histories out of the whole (52,643, 100)
    # history table through config0's 8,192 ``rows``; every user's pools in
    # one launch into a given buffer (the headline's refresh, bf16); and the
    # same bits for a user wherever it stands.
    his = ids(NUM_USERS * MAX_HIS, NUM_ITEMS).reshape(NUM_USERS, MAX_HIS)
    lens = ids(NUM_USERS, MAX_HIS + 1)
    rows = ids(BATCH, NUM_USERS)
    k1["shape"] += (f"; _rows: {BATCH} rows into ({NUM_USERS}, {MAX_HIS}) "
                    f"histories")
    k1b["shape"] += (f"; _pools: all ({NUM_USERS}, {MAX_HIS}) histories, one "
                     f"launch into a given buffer")
    check_history_mean(k1, "_rows", items, his, lens, rows=rows)
    check_pools(k1b, "_pools", items16, his, lens)
    check_same_bits(items, his, lens, rows)
    check_same_bits(items16, his, lens, rows)

    # K2's multi-table entry at the row reads of a step: config0's three
    # (users, positives, 131,072 negatives; f32), the same read into bf16
    # compute, and the headline's four (users, positives, 512 tile rows,
    # pool rows; bf16).
    users = torch.randn(NUM_USERS, DIM, generator=g, device=dev)
    k2m = new_entry("gather_rows_multi", "gather.cu", k2["replaces"],
                    f"({NUM_USERS}, {DIM}) and ({NUM_ITEMS}, {DIM}) f32 tables, "
                    f"{BATCH} + {BATCH} + {BATCH * NUM_NEGS} ids; _mixed: the "
                    f"same into bf16")
    step0 = [(users, rows), (items, ids(BATCH, NUM_ITEMS)),
             (items, ids(BATCH * NUM_NEGS, NUM_ITEMS))]
    check_gather_multi(k2m, "", step0, None)
    check_gather_multi(k2m, "_mixed", step0, torch.bfloat16)
    k2mb = new_entry("gather_rows_multi_bf16", "gather.cu", k2["replaces"],
                     f"({NUM_USERS}, {DIM}) users and pools, ({NUM_ITEMS}, {DIM}) "
                     f"items, bf16, {BATCH} + {BATCH} + {TILE} + {BATCH} ids")
    pools16 = users16.roll(1, 0)
    check_gather_multi(k2mb, "", [
        (users16, rows), (items16, ids(BATCH, NUM_ITEMS)),
        (items16, ids(TILE, NUM_ITEMS)), (pools16, rows)], torch.bfloat16)
    # The attention steps' reads (ROADMAP item 12): the same launch also
    # reads the samples' (B, H) history rows, 819,200 ids more: config0's
    # self-attention step in f32, the tile step (accl_self_s) in bf16. And
    # K2's single entry at one chunk of the user-attention pools.
    his_ids = his.index_select(0, rows).reshape(-1)
    k2m["shape"] += (f"; _attn: and {BATCH} x {MAX_HIS} history rows of the "
                     f"item table")
    k2mb["shape"] += (f"; _attn: users, items, {TILE} tile rows and "
                      f"{BATCH} x {MAX_HIS} history rows")
    check_gather_multi(k2m, "_attn", step0 + [(items, his_ids)], None)
    check_gather_multi(k2mb, "_attn", [
        (users16, rows), (items16, ids(BATCH, NUM_ITEMS)),
        (items16, ids(TILE, NUM_ITEMS)), (items16, his_ids)], torch.bfloat16)
    chunk = attn_pool_chunk(MAX_HIS)
    k2b["shape"] += (f"; _attn_pools: {chunk} x {MAX_HIS} history rows, a "
                     f"chunk of the user-attention pools")
    check_gather_rows(k2b, "_attn_pools", items16, his[:chunk].reshape(-1))
    del users, pools16, step0, his_ids

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
    return [k2, k2b, k2m, k2mb, k1, k1b, k3, k3b, k3u, k3ub, k4, s1, s1b, s1u,
            s1ub, s2, s2b]


def rotating(fn, sets: int):
    """A call that runs ``fn(i)`` for i = 0, 1, ..., sets - 1 in turn and
    keeps its result until the turn comes round again: each launch reads
    and writes other buffers than the launch before it."""
    turn, held = itertools.count(), [None] * sets

    def call():
        i = next(turn) % sets
        held[i] = fn(i)

    return call


def check_window_extract(dev) -> dict:
    """K4 at the eval tile and at the B = 8192 request, against its plain
    version: the copy is exact, so the two must be bit-equal. The library
    call is ``torch.gather`` on the (R, nw, w) view over in-range window
    ids. Every timed launch (kernel, plain version and library call) turns
    over sets of scores, window ids and outputs of ROTATE_BYTES in all, so
    that it reads its windows from HBM, as an eval tile does after the
    mask pass and the window maxima have streamed the whole tile through
    L2; ``graph_ms_same_buffers`` is the replay of one set, whose windows
    stay in L2 (what the row read before)."""
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
        in_range = (widx >= 0) & (widx < nw)
        flat_windows = (torch.arange(rows, device=dev)[:, None] * nw
                        + widx)[in_range]
        # The ids, each distinct in-range (row, window) read once, every
        # output window written.
        nbytes = 4 * rows * kw + (_distinct(flat_windows) + rows * kw) * 128 * 4
        same = graph_ms(lambda: topk.window_extract(sim, widx, 128))
        sets = max(2, -(-ROTATE_BYTES // int(nbytes)))
        sims = [sim] + [torch.randn(rows, I_PAD, generator=g, device=dev)
                        for _ in range(sets - 1)]
        widxs = [widx] + [torch.randint(0, nw, (rows, kw), generator=g,
                                        device=dev, dtype=torch.int32)
                          for _ in range(sets - 1)]
        views = [x.view(rows, nw, 128) for x in sims]
        indexes = [w.clamp(0, nw - 1).long()[:, :, None].expand(-1, -1, 128)
                   for w in widxs]
        timed(entry, key,
              rotating(lambda i: topk.window_extract(sims[i], widxs[i], 128), sets),
              rotating(lambda i: topk.window_extract_ref(sims[i], widxs[i], 128), sets),
              rotating(lambda i: torch.gather(views[i], 1, indexes[i]), sets),
              nbytes=nbytes, nops=0)
        entry["graph_ms_same_buffers" + key] = same
        entry["rotated_sets" + key] = sets
        entry["rotated_bytes" + key] = sets * nbytes
        del sim, sims, widxs, got, want, views, indexes
        torch.cuda.empty_cache()
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
    check_gather_rows(k2, "_big_tile", items16, ids(BIG_TILE, BIG_ITEMS))
    # The same step's four row reads in one launch.
    uid = ids(BIG_BATCH, BIG_USERS)
    check_gather_multi(entries["gather_rows_multi_bf16"], "_big", [
        (users16, uid), (items16, ids(BIG_BATCH, BIG_ITEMS)),
        (items16, ids(BIG_TILE, BIG_ITEMS)), (pools16, uid)], torch.bfloat16)
    del pools16
    # K1: one (4,096, 10) chunk of the pools over the 6M table.
    check_history_mean(
        entries["history_mean_gather_bf16"], "_big", items16,
        ids(POOL_CHUNK * BIG_HIS, BIG_ITEMS).reshape(POOL_CHUNK, BIG_HIS),
        ids(POOL_CHUNK, BIG_HIS + 1))
    # K1: the pools of all 16,000,000 users in one launch into a given
    # buffer, held against the plain version PLAIN_CHUNK users at a time.
    his = ids(BIG_USERS * BIG_HIS, BIG_ITEMS).reshape(BIG_USERS, BIG_HIS)
    check_pools(entries["history_mean_gather_bf16"], "_big_pools", items16, his,
                ids(BIG_USERS, BIG_HIS + 1), plain_chunk=PLAIN_CHUNK)
    del his
    torch.cuda.empty_cache()
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


def check_serving_bf16(dev) -> dict:
    """The headline run's export served from bf16 tables: a 256-user request
    against ``recommend_all`` (the requested rows come through K2's bf16
    instance bit for bit, so the rankings agree tie-aware), and the rows of
    an aggregated request (K1 bf16 reading the users' histories through
    ``rows``) against the same users' rows of the whole aggregated table:
    the request splits a history over more lanes than the table of all
    pools does, so each of the two means is within one bf16 ulp of the
    exact one and they are within 2^-6 of each other; through the product
    with ``w0`` and the blend (bf16 roundings of 2^-8 each) the aggregated
    rows are within 2^-6 x ((1 - gamma) |means| @ |w0| + gamma |u| + |row|)."""
    import numpy as np
    import torch

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.export import load_embeddings
    from heat_tpu_torch.models.aggregator import user_pools_impl
    from heat_tpu_torch.models.state import state_from_numpy
    from heat_tpu_torch.serving import Recommender

    cfg, _ = load_config(CONFIG0)
    train, _ = synthetic_click_dataset(
        num_users=NUM_USERS, num_items=NUM_ITEMS, max_his=cfg.max_his,
        seed=cfg.seed,
    )
    emb = load_embeddings(str(EXPORT_HEADLINE))
    state = state_from_numpy(emb["user_emb"], emb["item_emb"], emb["w0"],
                             lr=cfg.l_r, step=0, device=dev,
                             param_dtype=torch.bfloat16)
    rec = Recommender(state, cfg, seen_pairs=train.pairs,
                      his_items=train.his_items, his_masks=train.masks)
    k = REQUEST_K
    uids = np.random.default_rng(8).integers(0, NUM_USERS, 256)
    got = rec.recommend(uids, k + 1)
    same_topk(got, rec.recommend_all(k + 1)[uids],
              lambda ids: _score_rows(state.user_emb, state.item_emb, uids, ids),
              k, "bf16 request B=256 vs recommend_all")
    on_card = torch.as_tensor(uids.astype(np.int32), device=dev)
    rows = rec._user_rows(on_card, True).float()
    idx = on_card.long()
    every = rec._user_embeddings(True)[idx].float()
    means = user_pools_impl(state.item_emb, rec._his_dev, rec._masks_dev)[idx]
    torch.cuda.synchronize()
    bound = 2.0**-6 * (
        (1.0 - cfg.gamma) * (means.float().abs() @ state.w0.abs())
        + cfg.gamma * state.user_emb[idx].float().abs() + every.abs())
    if not bool(((rows - every).abs() <= bound).all()):
        raise AssertionError(
            "bf16 aggregated request rows: outside the bf16 rounding of the "
            "whole aggregated table's")
    top = rec.recommend(uids, k, aggregate_users=True)
    if top.shape != (256, k) or top.min() < 0 or top.max() >= NUM_ITEMS:
        raise AssertionError("bf16 aggregated request: ids out of range")
    return {
        "serve_bf16_b256_ms": time_request(lambda: rec.recommend(uids, k), 20),
        "agg_bf16_b256_ms": time_request(
            lambda: rec.recommend(uids, k, aggregate_users=True), 20),
        "agg_rows_max_abs_diff": float((rows - every).abs().max()),
    }


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
    # The attention aggregators: the history rows in the multi-table read,
    # the pooling inside the loss, attn_q's SGD update.
    "self_attention": (False, {"aggregator": "self_attention"}),
    "user_attention": (False, {"aggregator": "user_attention"}),
    "self_attention_sorted": (True, {"aggregator": "self_attention"}),
    "tile_bf16_self_attention_direct": (False, {
        "neg_sampler": 1, "update_mode": "direct",
        "aggregator": "self_attention", **BF16}),
    "tile_bf16_user_attention_pools_direct": (False, {
        "neg_sampler": 1, "update_mode": "direct", "his_refresh": "subepoch",
        "aggregator": "user_attention", **BF16}),
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
    relative a rounding) to 2% of its largest move, ``attn_q`` (f32; its
    gradient runs through the bf16 softmax and contractions) to 5% of its
    largest move. Returns the largest state difference of each variant."""
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
                        means = user_pools_impl(
                            state.item_emb, put(his), put(masks),
                            user_emb=state.user_emb, attn_q=state.attn_q,
                            aggregator=cfg.aggregator)
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
                for key, share in (("w0", 2e-2), ("attn_q", 5e-2)):
                    if key not in cpu:
                        continue
                    move = np.abs(cpu[key] - init[key]).max()
                    diff = float(np.abs(card[key] - cpu[key]).max())
                    if not diff <= share * move:
                        raise AssertionError(
                            f"step on the card vs the CPU, {name}: {key} off "
                            f"by {diff}, {share} of its move {move} at most")
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
        "gather_rows_multi", "history_mean_gather", "scatter_add_rows",
        "scatter_add_update", "scatter_set_update")),
    # direct: the write-back (S1) and both per-occurrence updates.
    "direct": ({"update_mode": "direct"}, (
        "gather_rows_multi", "history_mean_gather", "scatter_add_update",
        "scatter_set_rows")),
    # Row-sparse Adagrad on bf16 tables: the path that adds rows as they are
    # into a bf16 table (the plain K3 bf16 instance, item update) and writes
    # f32 rows into one (S1's conversion, user write-back + update).
    "adagrad_bf16": ({"optimizer": "adagrad", "param_dtype": "bfloat16",
                      "compute_dtype": "bfloat16"}, (
        "gather_rows_multi_bf16", "history_mean_gather_bf16",
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
    on a main path, with their launch counts over both epochs (the
    capture's warm-up step and the capture: the replays call no wrapper),
    the timed epoch's replayed steps traced (``check_trace``, over
    HUGE_TRACE_STEPS steps) and the peak memory against the bytes held."""
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
        reset()
        losses = [engine.train_one_epoch()]  # warm-up
        t0 = time.perf_counter()
        losses.append(engine.train_one_epoch())
        ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = read()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"huge {mode}: losses {losses}")
        bf16 = cfg.param_dtype == "bfloat16"
        for name in every_step:
            if launches[name] < 1:
                raise AssertionError(
                    f"huge {mode}: {name} was not launched: {launches}")
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
        trace = check_trace(f"huge {mode}",
                            bench_large.profile_steps(engine, HUGE_TRACE_STEPS),
                            ("K1", "K2_multi", "K3", "S1"))
        out[mode] = {"ms_per_step": ms, "steps": steps, "launches": launches,
                     "peak_device_bytes": peak, "held_bytes": held,
                     "port_kernels_per_step": trace,
                     "captures": engine._epoch_fns[True].captures}
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
        # What earlier phases left allocated, counted in the peak below.
        before = torch.cuda.memory_allocated()
        print(f"bench_large {mode}: {before / 1e9:.3f} GB allocated before "
              f"it, live blocks (MiB): {live_blocks()}")
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
        # Per step: one K2 launch for the user, pool, positive and tile rows;
        # S1 and K3 in both modes; K1 only for the pools, one launch a
        # refresh (the warm-up epoch, the timed one and the profile's), all
        # on bf16 tables (the segment sums' K3 adds into f32 buffers).
        refreshes = 3
        if launches["history_mean_gather_bf16"] != refreshes:
            raise AssertionError(
                f"bench_large {mode}: K1 launched "
                f"{launches['history_mean_gather_bf16']} times for "
                f"{refreshes} pool refreshes")
        if launches["gather_rows_bf16"]:
            raise AssertionError(
                f"bench_large {mode}: a step read rows outside the "
                f"multi-table launch: {launches}")
        need = ["gather_rows_multi_bf16"]
        if mode == "dedup":  # segment sums; item update; user write-back + update
            need += ["scatter_add_rows", "scatter_add_update_bf16",
                     "scatter_set_update_bf16"]
        else:  # the write-back, then both per-occurrence updates
            need += ["scatter_set_rows_bf16", "scatter_add_update_bf16"]
        for name in need:
            if launches[name] < 1:
                raise AssertionError(
                    f"bench_large {mode}: {name} was not launched: {launches}")
        # Per replayed step, from the trace: one K2 multi launch, the
        # segment sums and the item update (dedup: 3 K3) or both updates
        # (direct: 2 K3), and the user write-back (one S1); no K1.
        got = check_trace(f"bench_large {mode}", record["profile"],
                          ("K2_multi", "K3", "S1"))
        if got["K1"] or got["K3"] != (3 if mode == "dedup" else 2):
            raise AssertionError(f"bench_large {mode}: per step {got}")
        held = record["state_bytes"] + record["data_bytes"] + record["pools_bytes"]
        peak = record["peak_device_bytes"]
        print(f"bench_large {mode}: {record['captures']} capture(s); "
              f"{wall:.1f} s in all; launches {launches}; "
              f"peak device memory {peak / 1e9:.3f} GB against "
              f"{held / 1e9:.3f} GB of state, data and pools held "
              f"({peak / held:.3f}x; with the epoch's batch stream "
              f"{record['epoch_stream_bytes'] / 1e9:.3f} GB: "
              f"{peak / (held + record['epoch_stream_bytes']):.3f}x)")
        # The steps' peak, where a step-time table copy would show: the
        # replayed steps of the profile. The epochs' peak also holds the
        # shuffle's randperm (32 B a click), which the pools buffer's memory
        # takes while the engine drops it.
        step_peak = record["profile"]["replayed"]["step_peak_device_bytes"]
        print(f"bench_large {mode}: replayed steps' peak {step_peak / 1e9:.3f} "
              f"GB ({step_peak / held:.3f}x held); graph pool "
              f"{record['profile']['replayed']['graph_pool_bytes'] / 1e9:.3f} GB")
        if mode == "dedup" and max(step_peak, peak) > MEM_RATIO * held:
            raise AssertionError(
                f"bench_large dedup: peak device memory {step_peak} B in the "
                f"steps, {peak} B in the epochs, against {held} B held: a "
                f"table copy?"
            )
        record["launches"] = launches
        record["wall_s"] = wall
        record["allocated_before_bytes"] = before
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


def rms_diff(a, b, rows=1 << 20) -> tuple[float, float]:
    """(root-mean-square, max) of a - b over all elements, in f64, the
    tables chunk by chunk."""
    total, worst = 0.0, 0.0
    for lo in range(0, a.shape[0], rows):
        d = a[lo: lo + rows].double() - b[lo: lo + rows].double()
        total += float((d * d).sum())
        worst = max(worst, float(d.abs().max()))
    return math.sqrt(total / max(1, a.numel())), worst


def live_blocks() -> list:
    """The sizes in MiB of the allocator's live blocks of 1 MiB or more,
    largest first: what is left allocated between phases."""
    import torch

    sizes = [b["size"] for seg in torch.cuda.memory._snapshot()["segments"]
             for b in seg["blocks"] if b["state"] == "active_allocated"]
    return sorted((round(n / 2**20, 1) for n in sizes if n >= 2**20),
                  reverse=True)


def check_trace(what, profile, every_step) -> dict:
    """The kernels of the replayed steps, from the device trace of
    ``bench_large.profile_steps``: per step, the port's kernels by family
    are those of the eager steps on the same batches, the wrappers counted
    exactly the kernels the trace saw over the eager steps and none over
    the replayed ones (a replay calls no wrapper), each family of
    ``every_step`` ran at least once a step, and the replayed steps' device
    time is at most 1.25x their wall time."""
    eager, replayed = profile["eager"], profile["replayed"]
    got = replayed["port_kernels_per_step"]
    if got != eager["port_kernels_per_step"]:
        raise AssertionError(
            f"{what}: the replayed steps launched {got} of the port's "
            f"kernels a step, the eager ones {eager['port_kernels_per_step']}")
    if eager["wrapper_launches_per_step"] != eager["port_kernels_per_step"]:
        raise AssertionError(
            f"{what}: the wrappers counted {eager['wrapper_launches_per_step']} "
            f"a step, the trace saw {eager['port_kernels_per_step']}")
    if any(replayed["wrapper_launches_per_step"].values()):
        raise AssertionError(
            f"{what}: a replay called a wrapper: "
            f"{replayed['wrapper_launches_per_step']}")
    for fam in every_step:
        if got[fam] < 1:
            raise AssertionError(
                f"{what}: {fam} ran {got[fam]} times a replayed step")
    # One stream: the device's time a step cannot much exceed the wall's.
    if replayed["device_ms_per_step"] > 1.25 * replayed["wall_ms_per_step"]:
        raise AssertionError(
            f"{what}: {replayed['device_ms_per_step']} ms of device time a "
            f"replayed step in {replayed['wall_ms_per_step']} ms of wall: "
            f"the trace counts something that is not device work")
    print(f"{what}: port kernels a replayed step (device trace of "
          f"{profile['steps']} steps): {json.dumps(got)}")
    return got


def check_replayed_against_eager(what, make_engine, epochs, full, dev) -> dict:
    """The replay phase: ``epochs`` epochs of three engines from
    one seed: eager, eager again, and replayed (each step one replay of the
    captured step). Every run's draws (``full``: every negative, tile and
    tile index; otherwise a fingerprint a step) are ``torch.equal`` to the
    first eager run's, across the epochs' boundaries with their eager
    shuffles; ``step`` and the sampler's ``iterations`` are equal in all
    three. The per-step losses, ``w0``, ``attn_q`` (self-attention) and
    both tables of the replayed run
    differ from the first eager run's by at most twice what the second
    eager run differs by (K3's atomics add in no fixed order), and not at
    all where that spread is 0. The difference is the root mean square over
    the elements (over the steps for the losses): the max over millions of
    elements, and one epoch loss, are single extremes of a chaotic
    divergence and moved 3x between calls. Returns the spreads and
    differences (root mean square and max), each run's seconds, the
    replayed engine's host time per replay call and its graph pool."""
    import torch

    from heat_tpu_torch.testing import StepRecorder

    runs = {}
    for name, capture in (("eager", False), ("eager_again", False),
                          ("replayed", True)):
        torch.cuda.empty_cache()
        engine = make_engine()
        engine._capture = capture
        cfg = engine.cfg
        # At most one step more an epoch for each sub-epoch past the first.
        steps = epochs * (-(-cfg.train_size // cfg.batch_size)
                          + cfg.num_subepochs - 1)
        tile = cfg.tile_size if cfg.neg_sampler == 1 else 0
        rec = StepRecorder(steps, cfg.batch_size, cfg.num_negs, tile, dev, full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec:
            losses = engine.train_epochs(epochs)
        seconds = time.perf_counter() - t0
        st = engine.state
        *draws, step_losses = rec.records()
        run = {"epoch_losses": losses, "step_losses": step_losses,
               "w0": st.w0.clone(), "user_emb": st.user_emb.clone(),
               "attn_q": None if st.attn_q is None else st.attn_q.clone(),
               "item_emb": st.item_emb.clone(), "step": int(st.step),
               "iterations": int(engine.sampler_state.iterations),
               "draws": draws, "count": int(rec.count), "seconds": seconds}
        if capture:
            # The host's cost of one replay call, 20 calls from the stream's
            # first batch, not waited for (the recorder, in the graph,
            # writes from slot 0 again: its records are cloned above).
            rec.count.fill_(0)
            fn = engine._epoch_fns[True]
            fn._index.fill_(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn._graph.replay()
            run["host_us_per_replay"] = (time.perf_counter() - t0) * 1e6 / 20
            torch.cuda.synchronize()
            run["graph_pool_bytes"] = fn.graph_pool_bytes
        runs[name] = run
        del engine, st, rec
    eager, again, replayed = runs["eager"], runs["eager_again"], runs["replayed"]
    steps = eager["count"]
    for run in runs.values():
        if run["count"] != steps or run["step"] != steps:
            raise AssertionError(
                f"{what}: {run['count']} steps recorded, {run['step']} taken, "
                f"the first eager run {steps}")
        for want, got in zip(eager["draws"], run["draws"]):
            if not torch.equal(want, got):
                raise AssertionError(f"{what}: a step drew other values")
    for key in ("step", "iterations"):
        if not eager[key] == again[key] == replayed[key]:
            raise AssertionError(
                f"{what}: {key} {eager[key]} / {again[key]} / {replayed[key]}")
    out = {"epochs": epochs, "steps": steps,
           "seconds": {k: r["seconds"] for k, r in runs.items()},
           "epoch_losses": {k: r["epoch_losses"] for k, r in runs.items()},
           "host_us_per_replay": replayed["host_us_per_replay"],
           "graph_pool_bytes": replayed["graph_pool_bytes"]}
    for key in ("step_losses", "w0", "user_emb", "item_emb", "attn_q"):
        if eager[key] is None:
            continue
        spread, spread_max = rms_diff(again[key], eager[key])
        diff, diff_max = rms_diff(replayed[key], eager[key])
        out[key] = {"eager_spread_rms": spread, "replayed_vs_eager_rms": diff,
                    "eager_spread_max": spread_max,
                    "replayed_vs_eager_max": diff_max}
        if diff > 2 * spread:
            raise AssertionError(
                f"{what}: replayed {key} off the eager run's by {diff} (rms), "
                f"more than twice the eager-vs-eager spread {spread}")
    print(f"replayed vs eager, {what}: draws equal over {steps} steps, step "
          f"{eager['step']}, iterations {eager['iterations']}; "
          f"{json.dumps(out)}")
    return out


def check_replay(dev) -> dict:
    """(a) and (b) at config0 and the headline at full width (two epochs:
    an epoch boundary and its eager shuffle between the replays; every
    draw held), the same two configurations bit-equal on clicks that
    repeat no id, config0's replayed steps traced (``check_trace``), and
    (b) at bench_large's 16M x 6M bf16 dedup geometry (one epoch,
    fingerprints of the draws)."""
    import torch

    from heat_tpu_torch import bench_large
    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.testing import distinct_id_dataset, replayed_equals_eager
    from heat_tpu_torch.train.engine import Engine

    out = {}
    train, _ = synthetic_click_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS,
                                       max_his=MAX_HIS, seed=2022)
    distinct = distinct_id_dataset(DISTINCT_CLICKS, DISTINCT_ITEMS, MAX_HIS)
    for what, sets in (("config0", []), ("headline", HEADLINE)):
        overrides = overrides_of(sets)

        def make(overrides=overrides):
            return Engine(load_config(CONFIG0, **overrides)[0], train, device=dev)

        out[what] = check_replayed_against_eager(what, make, 2, True, dev)
        small = {**overrides, **DISTINCT_SETS}
        if overrides.get("neg_sampler") == 1:
            small.update(DISTINCT_TILE_SETS)

        def make_small(small=small):
            return Engine(load_config(CONFIG0, **small)[0], distinct, device=dev)

        torch.cuda.empty_cache()
        exact = replayed_equals_eager(make_small, 2)
        print(f"replayed vs eager, {what} on {DISTINCT_CLICKS} clicks that "
              f"repeat no id ({json.dumps(small)}): bit-equal after each of "
              f"{exact['epochs']} epochs, {exact['steps']} steps, "
              f"{exact['captures']} capture(s)")
        out[what]["bit_equal"] = exact
    del distinct
    torch.cuda.empty_cache()
    # The replayed config0 step's kernels, from a device trace.
    engine = Engine(load_config(CONFIG0)[0], train, device=dev)
    profile = bench_large.profile_steps(engine, PROFILE_STEPS)
    out["config0"]["trace"] = check_trace(
        "config0", profile, ("K1", "K2_multi", "K3", "S1"))
    out["config0"]["profile"] = {
        form: {k: profile[form][k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "idle_share",
            "device_launches_per_step")}
        for form in ("eager", "replayed")}
    del engine, train
    args = bench_large._parser().parse_args(["--update-mode", "dedup"])
    dataset = bench_large.make_dataset(args.users, args.items, args.clicks,
                                       args.max_his)

    def make_big():
        return Engine(bench_large.make_config(args), dataset, device=dev)

    out["dedup_16m_6m"] = check_replayed_against_eager(
        "16M x 6M bf16 dedup", make_big, 1, False, dev)
    # The host's cost of a checkpoint of this state (item 14).
    engine = make_big()
    out["dedup_16m_6m"]["checkpoint"] = time_checkpoint(engine, "ckpt_16m_6m")
    print(f"checkpoint at 16M x 6M bf16: "
          f"{json.dumps(out['dedup_16m_6m']['checkpoint'])}")
    del engine, dataset
    torch.cuda.empty_cache()
    return out


def overrides_of(sets) -> dict:
    import yaml

    return {k: yaml.safe_load(v) for k, _, v in (kv.partition("=") for kv in sets)}


class SubepochWatch:
    """Records, while installed, every sub-epoch an engine runs (the
    ``count`` of steps of each ``Engine._steps`` call, which under
    sub-epochs is one a sub-epoch), the partitions it draws and the engines
    themselves, so that their captures can be read after a CLI run; and,
    host clock, per epoch the seconds of the host's permutation and bucket
    sizes (``partition_s``) and from its start to the first sub-epoch's
    steps (``prep_s``: the permutation, the device grouping, which waits
    for the device, the first shuffle)."""

    def __init__(self):
        from heat_tpu_torch.train.engine import Engine

        self.cls, self.engines, self.counts, self.partitions = Engine, [], [], []
        self.orig = (Engine._steps, Engine._partition)
        self.partition_s, self.prep_s, self._t0 = [], [], None

    def __enter__(self):
        watch = self
        steps, partition = self.orig

        def counted(engine, capture, count, *args, **kw):
            if engine not in watch.engines:
                watch.engines.append(engine)
            watch.counts.append(count)
            if watch._t0 is not None:
                watch.prep_s.append(time.perf_counter() - watch._t0)
                watch._t0 = None
            return steps(engine, capture, count, *args, **kw)

        def drawn(engine):
            watch._t0 = time.perf_counter()
            out = partition(engine)
            watch.partitions.append(out)
            watch.partition_s.append(time.perf_counter() - watch._t0)
            return out

        self.cls._steps, self.cls._partition = counted, drawn
        return self

    def __exit__(self, *exc):
        self.cls._steps, self.cls._partition = self.orig

    def captures(self) -> int:
        return sum(e._epoch_fns[True].captures for e in self.engines
                   if True in e._epoch_fns)


def check_complement_draws(what, engine, dev) -> dict:
    """One epoch of ``engine`` (config0 with two sub-epochs under
    "complement") with every step's positives and the negative ids it
    reads recorded (``StepRecorder``): each step's positives lie in one
    partition, its negatives all outside it; the losses are finite."""
    import torch

    from heat_tpu_torch.testing import StepRecorder

    cfg = engine.cfg
    steps = -(-cfg.train_size // cfg.batch_size) + cfg.num_subepochs - 1
    tile = cfg.tile_size if cfg.neg_sampler == 1 else 0
    rec = StepRecorder(steps, cfg.batch_size, cfg.num_negs, tile, dev, True)
    with SubepochWatch() as watch, rec:
        loss = engine.train_one_epoch()
    n = int(rec.count)
    if n != int(engine.state.step) or not math.isfinite(loss):
        raise AssertionError(f"{what}: {n} steps recorded, loss {loss}")
    (perm, bounds), = watch.partitions
    part_of = torch.empty(cfg.num_items, dtype=torch.int64, device=dev)
    for s in range(cfg.num_subepochs):
        part_of[torch.as_tensor(perm[bounds[s]: bounds[s + 1]], device=dev)] = s
    pos_part = part_of[rec.pos[:n].long()]  # (n, B)
    sub = pos_part[:, 0]
    if not bool((pos_part == sub[:, None]).all()):
        raise AssertionError(f"{what}: a step's positives span two partitions")
    inside = int((part_of[rec.negs[:n].long()] == sub[:, None, None]).sum())
    if inside:
        raise AssertionError(
            f"{what}: {inside} negatives inside their sub-epoch's partition")
    print(f"{what}: {n} steps ({watch.counts} a sub-epoch), "
          f"{rec.negs[:n].numel()} negatives, none inside its sub-epoch's "
          f"partition; loss {loss}")
    return {"steps": n, "steps_per_subepoch": watch.counts, "loss": loss}


def check_subepochs(dev, cli, reset, read, config0_recall, check_run) -> dict:
    """The reference's default shape (DEFAULT_SHAPE) at full width through
    the CLI, plain, ``--fused-epochs 5`` and ``--fused-run``, each held to
    ``check_run`` and to RECALL_BAND of config0's Recall@20, with each
    sub-epoch's replays, the captures and K1's launches (one pool refresh
    a sub-epoch); replayed against eager at that shape (two epochs) and
    bit-equal on clicks that repeat no id; complement scope's draws outside
    their partition (config0 with two sub-epochs, uniform sampler, then
    the tile sampler; eager and replayed); and the device trace of a
    replayed sub-epoch step."""
    import torch

    from heat_tpu_torch import bench_large
    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.testing import distinct_id_dataset, replayed_equals_eager
    from heat_tpu_torch.train.engine import Engine

    out = {"runs": {}}
    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    sets = [x for kv in DEFAULT_SHAPE for x in ("--set", kv)]
    epochs = 5
    for flags in ([], ["--fused-epochs", "5"], ["--fused-run"]):
        name = " ".join(["default shape"] + flags)
        reset()
        with SubepochWatch() as watch:
            record = cli.main(args + sets + flags)
        launches = read()
        check_run(name, record, launches, {
            "gather_rows_multi_bf16": 1,
            "history_mean_gather_bf16": 2 * epochs,
            "scatter_add_update_bf16": 1, "scatter_set_rows_bf16": 1,
            "window_extract": 3 * -(-NUM_USERS // EVAL_TILE)})
        if launches["history_mean_gather_bf16"] != 2 * epochs:
            raise AssertionError(
                f"{name}: K1 launched {launches['history_mean_gather_bf16']} "
                f"times, not once a sub-epoch ({2 * epochs})")
        if len(watch.counts) != 2 * epochs or watch.captures() != 1:
            raise AssertionError(
                f"{name}: sub-epochs {watch.counts}, captures {watch.captures()}")
        recall = record["final_metrics"]["Recall(k=20)"]
        gap = recall - config0_recall
        print(f"{name}: Recall@20 {recall:.6f} vs config0 {config0_recall:.6f} "
              f"(gap {gap:+.6f}, band {RECALL_BAND}); the JAX package's record "
              f"at this shape {JAX_DEFAULT_SHAPE_RECALL} vs {JAX_EXACT_RECALL} "
              f"exact (gap {JAX_DEFAULT_SHAPE_RECALL - JAX_EXACT_RECALL:+.4f}, "
              f"a quality figure); steps a sub-epoch {watch.counts} (the "
              f"first of the run captures, then replays); captures "
              f"{watch.captures()}; K1 launches "
              f"{launches['history_mean_gather_bf16'] / epochs:.0f} an epoch; "
              f"host permutation s {watch.partition_s}, until the first step "
              f"s {watch.prep_s}")
        if not abs(gap) <= RECALL_BAND:
            raise AssertionError(f"{name}: Recall@20 gap {gap} to config0")
        out["runs"][name] = {
            "epoch_times": record["epoch_times"], "recall": recall,
            "final_metrics": record["final_metrics"],
            "gap_to_config0": gap, "steps_per_subepoch": watch.counts,
            "captures": watch.captures(), "partition_s": watch.partition_s,
            "prep_s": watch.prep_s,
            "k1_launches_per_epoch": launches["history_mean_gather_bf16"] / epochs}
        del watch

    train, _ = synthetic_click_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS,
                                       max_his=MAX_HIS, seed=2022)
    shape = overrides_of(DEFAULT_SHAPE)

    def make(overrides=shape):
        return Engine(load_config(CONFIG0, **overrides)[0], train, device=dev)

    out["replay"] = check_replayed_against_eager("default shape", make, 2, True, dev)
    distinct = distinct_id_dataset(DISTINCT_CLICKS, DISTINCT_ITEMS, MAX_HIS)
    for what, sets_ in (("config0, 2 sub-epochs", ["num_subepochs=2"]),
                        ("default shape", DEFAULT_SHAPE)):
        small = {**overrides_of(sets_), **DISTINCT_SETS}
        if small.get("neg_sampler") == 1:
            small.update(DISTINCT_TILE_SETS)
        exact = replayed_equals_eager(
            lambda small=small: Engine(load_config(CONFIG0, **small)[0],
                                       distinct, device=dev), 2)
        print(f"replayed vs eager, {what} on {DISTINCT_CLICKS} clicks that "
              f"repeat no id ({json.dumps(small)}): bit-equal after each of "
              f"{exact['epochs']} epochs, {exact['steps']} steps, "
              f"{exact['captures']} capture(s)")
        out[f"bit_equal {what}"] = exact
    del distinct

    complement = {"num_subepochs": 2, "subepoch_neg_scope": "complement"}
    tile = {"neg_sampler": 1, "tile_size": TILE, "refresh_interval": 8192}
    for what, extra in (("uniform", {}), ("tile", tile)):
        for capture in (False, True):
            torch.cuda.empty_cache()
            engine = make({**complement, **extra})
            engine._capture = capture
            name = f"complement scope, {what}, {'replayed' if capture else 'eager'}"
            out[name] = check_complement_draws(name, engine, dev)
            del engine

    torch.cuda.empty_cache()
    engine = make()
    profile = bench_large.profile_steps(engine, PROFILE_STEPS)
    out["trace"] = check_trace("default shape (a sub-epoch's replayed steps)",
                               profile, ("K2_multi", "K3", "S1"))
    del engine, train
    torch.cuda.empty_cache()
    return out


def check_huge_subepochs(dev) -> dict:
    """One epoch at bench_large's 16M x 6M bf16 geometry in dedup mode with
    two sub-epochs (global scope), through the engine factory of the other
    huge runs: a warm-up epoch (the capture) and a timed one, the peak
    device memory over both against the bytes held (state, data and pools,
    nothing subtracted)."""
    import dataclasses

    import torch

    from heat_tpu_torch import bench_large
    from heat_tpu_torch.train.engine import Engine

    args = bench_large._parser().parse_args(["--update-mode", "dedup"])
    dataset = bench_large.make_dataset(args.users, args.items, args.clicks,
                                       args.max_his)
    cfg = dataclasses.replace(bench_large.make_config(args), num_subepochs=2)
    torch.cuda.empty_cache()
    engine = Engine(cfg, dataset, device=dev)
    st = engine.state
    held = sum(t.numel() * t.element_size() for t in (
        st.user_emb, st.item_emb, st.w0, engine.pairs, engine.his_items,
        engine.his_masks)) + st.user_emb.numel() * st.user_emb.element_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with SubepochWatch() as watch:
        losses = [engine.train_one_epoch()]
        t0 = time.perf_counter()
        losses.append(engine.train_one_epoch())
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"16M x 6M, 2 sub-epochs: losses {losses}")
    print(f"16M x 6M bf16 dedup, 2 sub-epochs: epoch {seconds:.4f} s (the "
          f"second; the first captured), of which the host's permutation "
          f"{watch.partition_s[1]:.4f} s and until the first step "
          f"{watch.prep_s[1]:.4f} s; losses {losses}; steps a sub-epoch "
          f"{watch.counts}; captures {watch.captures()}; peak device memory "
          f"{peak / 1e9:.3f} GB against {held / 1e9:.3f} GB held "
          f"({peak / held:.3f}x)")
    if peak > MEM_RATIO * held:
        raise AssertionError(
            f"16M x 6M, 2 sub-epochs: peak device memory {peak} B above "
            f"{MEM_RATIO} x {held} B held")
    out = {"epoch_s": seconds, "partition_s": watch.partition_s,
           "prep_s": watch.prep_s, "losses": losses, "peak_over_held": peak / held,
           "peak_device_bytes": peak, "held_bytes": held,
           "steps_per_subepoch": watch.counts, "captures": watch.captures()}
    del engine, st, dataset
    torch.cuda.empty_cache()
    return out


class AttentionWatch:
    """Records, while installed, the engines whose steps run (with each
    engine's ``attn_q`` before its first step) and the history dedup maps
    of every ``Engine._steps`` call, so that a CLI run's query and maps can
    be read after it."""

    def __init__(self):
        from heat_tpu_torch.train.engine import Engine

        self.cls, self.orig = Engine, Engine._steps
        self.engines, self.start_q, self.dedups = [], [], []

    def __enter__(self):
        watch, steps = self, self.orig

        def counted(engine, capture, count, dedup=None, *args, **kw):
            if engine not in watch.engines:
                watch.engines.append(engine)
                q = engine.state.attn_q
                watch.start_q.append(None if q is None else q.clone())
            watch.dedups.append(dedup)
            return steps(engine, capture, count, dedup, *args, **kw)

        self.cls._steps = counted
        return self

    def __exit__(self, *exc):
        self.cls._steps = self.orig

    def query_move(self) -> float:
        """The largest move of the run's ``attn_q`` from its first value."""
        (engine,), (q0,) = self.engines, self.start_q
        return float((engine.state.attn_q - q0).abs().max())


def check_attention(dev, cli, reset, read, config0_recall, check_run) -> dict:
    """The attention aggregators (ROADMAP item 12) at full width on the
    planted clusters of config0's geometry (seed 2022):

    1. config0 with self-attention (f32, uniform sampler, pooled every step
       from its (B, H, d) history rows) through the CLI, plain (with
       ``--export-embeddings``, served by :func:`check_serving_attention`)
       and ``--fused-epochs 5``;
    2. ``accl_user_s`` (ACCL_USER: the headline with user attention over the
       pools refreshed once an epoch, the history rows of each chunk of
       users read by K2's single entry);
    3. ``accl_self_s`` (ACCL_SELF: the headline with self-attention pooled
       every step);
    4. ``accl_self_grouped_s`` (ACCL_SELF_GROUPED: run 3 on the user-grouped
       stream, where the three dedup maps, first occurrences included, are
       passed to every step).

    Each run is held to ``check_run`` (10x the untrained Recall@20 among
    them), runs K1 never (the history rows go through K2) and, for runs
    1-3, lands within RECALL_BAND of config0's Recall@20; self-attention's
    ``attn_q`` moves. Then: run 4 with the dedup against two runs without
    it (``Engine.run_epochs_with_eval`` over the CLI's schedule): Recall@20
    within twice the spread of the two, or DEDUP_BAND, whichever is
    larger; replayed against eager (``check_replayed_against_eager``,
    two epochs) at config0 self-attention and accl_user_s, and bit-equal
    on clicks that repeat no id for both kinds
    (``testing.replayed_equals_eager``); the device traces of replayed and
    eager steps of runs 1 and 3 (``bench_large.profile_steps``: K2 multi
    once a step, K1 never, K3 and S1 as on the mean path)."""
    import torch

    from heat_tpu_torch import bench_large
    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.testing import distinct_id_dataset, replayed_equals_eager
    from heat_tpu_torch.train.engine import Engine

    out = {"runs": {}, "traces": {}}
    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    eval_tiles = 3 * -(-NUM_USERS // EVAL_TILE)
    f32 = {"gather_rows_multi": 1, "scatter_add_rows": 1,
           "scatter_set_rows": 1, "window_extract": eval_tiles}
    bf16 = {"gather_rows_multi_bf16": 1, "scatter_add_update_bf16": 1,
            "scatter_set_rows_bf16": 1, "window_extract": eval_tiles}
    # K2's single entry: one launch a chunk of users, one refresh an epoch.
    pool_reads = 5 * -(-NUM_USERS // attn_pool_chunk(MAX_HIS))
    runs = (
        ("config0 self_attention", CONFIG0_SELF,
         ["--export-embeddings", str(EXPORT_SELF)], f32),
        ("config0 self_attention --fused-epochs 5", CONFIG0_SELF,
         ["--fused-epochs", "5"], f32),
        ("accl_user_s", ACCL_USER, [], {**bf16, "gather_rows_bf16": pool_reads}),
        ("accl_self_s", ACCL_SELF, [], bf16),
        ("accl_self_grouped_s", ACCL_SELF_GROUPED, [], bf16),
    )
    EXPORT_SELF.parent.mkdir(parents=True, exist_ok=True)
    for name, sets, flags, least in runs:
        torch.cuda.empty_cache()
        reset()
        with AttentionWatch() as watch:
            record = cli.main(args + [x for kv in sets for x in ("--set", kv)]
                              + flags)
        launches = read()
        check_run(name, record, launches, least)
        if launches["history_mean_gather"]:
            raise AssertionError(
                f"{name}: K1 ran, but the attention steps and pools read "
                f"their history rows through K2: {launches}")
        if name == "accl_user_s" and launches["gather_rows_bf16"] != pool_reads:
            raise AssertionError(
                f"{name}: K2 read {launches['gather_rows_bf16']} chunks of "
                f"history rows for the pools, not {pool_reads}")
        grouped = name == "accl_self_grouped_s"
        if grouped and not all(d is not None and len(d) == 3
                               for d in watch.dedups):
            raise AssertionError(f"{name}: a step ran without the three dedup maps")
        if not grouped and any(d is not None for d in watch.dedups):
            raise AssertionError(f"{name}: a shuffled stream took the dedup maps")
        recall = record["final_metrics"]["Recall(k=20)"]
        gap = recall - config0_recall
        entry = {"epoch_times": record["epoch_times"], "recall": recall,
                 "final_metrics": record["final_metrics"],
                 "gap_to_config0": gap, "final_eval_s": record["final_eval_s"],
                 "launches": launches,
                 "captures": watch.engines[0]._epoch_fns[True].captures}
        if "self" in name:
            entry["attn_q_move"] = watch.query_move()
            if not entry["attn_q_move"] > 0:
                raise AssertionError(f"{name}: attn_q did not move")
        print(f"{name}: Recall@20 {recall:.6f} vs config0 {config0_recall:.6f} "
              f"(gap {gap:+.6f}, band {RECALL_BAND}"
              f"{', not held: see the dedup comparison' if grouped else ''}); "
              f"captures {entry['captures']}; attn_q moved by "
              f"{entry.get('attn_q_move')}; dedup maps in "
              f"{sum(d is not None for d in watch.dedups)} of "
              f"{len(watch.dedups)} epochs")
        if not grouped and not abs(gap) <= RECALL_BAND:
            raise AssertionError(f"{name}: Recall@20 gap {gap} to config0")
        out["runs"][name] = entry
        del watch, record
    torch.cuda.empty_cache()

    train, test = synthetic_click_dataset(num_users=NUM_USERS, num_items=NUM_ITEMS,
                                          max_his=MAX_HIS, seed=2022)
    grouped = overrides_of(ACCL_SELF_GROUPED)

    def schedule(dedup: bool) -> float:
        cfg = load_config(CONFIG0, **grouped)[0]
        engine = Engine(cfg, train, test, device=dev)
        if not dedup:
            engine._history_dedup = lambda pairs, users: None
        engine.run_epochs_with_eval(cfg.epochs, cfg.eval_interval)
        recall = engine.evaluate()["Recall(k=20)"]
        maps = engine._dedup_cache
        if dedup != bool(maps and maps[2] is not None):
            raise AssertionError(f"dedup {dedup}: the maps were {maps}")
        del engine
        torch.cuda.empty_cache()
        return recall

    with_maps, without, again = schedule(True), schedule(False), schedule(False)
    bound = max(2 * abs(without - again), DEDUP_BAND)
    out["dedup"] = {"with_maps": with_maps, "without": [without, again],
                    "bound": bound}
    print(f"accl_self_grouped_s, dedup vs none: Recall@20 {with_maps:.6f} vs "
          f"{without:.6f} and {again:.6f} (bound {bound:.6f})")
    if not abs(with_maps - without) <= bound:
        raise AssertionError(
            f"the grouped stream with the dedup maps reached Recall@20 "
            f"{with_maps}, without {without} (bound {bound})")

    distinct = distinct_id_dataset(DISTINCT_CLICKS, DISTINCT_ITEMS, MAX_HIS)
    for what, sets in (("config0 self_attention", CONFIG0_SELF),
                       ("accl_user_s", ACCL_USER)):
        overrides = overrides_of(sets)

        def make(overrides=overrides):
            return Engine(load_config(CONFIG0, **overrides)[0], train, device=dev)

        out[f"replay {what}"] = check_replayed_against_eager(what, make, 2, True, dev)
        small = {**overrides, **DISTINCT_SETS}
        if small.get("neg_sampler") == 1:
            small.update(DISTINCT_TILE_SETS)
        torch.cuda.empty_cache()
        exact = replayed_equals_eager(
            lambda small=small: Engine(load_config(CONFIG0, **small)[0],
                                       distinct, device=dev), 2)
        print(f"replayed vs eager, {what} on {DISTINCT_CLICKS} clicks that "
              f"repeat no id ({json.dumps(small)}): bit-equal after each of "
              f"{exact['epochs']} epochs, {exact['steps']} steps, "
              f"{exact['captures']} capture(s)")
        out[f"replay {what}"]["bit_equal"] = exact
    del distinct

    for what, sets in (("config0 self_attention", CONFIG0_SELF),
                       ("accl_self_s", ACCL_SELF)):
        torch.cuda.empty_cache()
        engine = Engine(load_config(CONFIG0, **overrides_of(sets))[0], train,
                        device=dev)
        st = engine.state
        held = sum(t.numel() * t.element_size() for t in (
            st.user_emb, st.item_emb, st.w0, engine.pairs, engine.his_items,
            engine.his_masks))
        profile = bench_large.profile_steps(engine, PROFILE_STEPS, top=40)
        trace = check_trace(what, profile, ("K2_multi", "K3", "S1"))
        if trace["K1"] or trace["K2_multi"] != 1 or trace["K3"] != 2 or trace["S1"] != 1:
            raise AssertionError(f"{what}: port kernels a step {trace}")
        out["traces"][what] = {"port_kernels_per_step": trace, "held_bytes": held}
        for form in ("eager", "replayed"):
            f = profile[form]
            out["traces"][what][form] = {
                key: f[key] for key in (
                    "wall_ms_per_step", "device_ms_per_step", "idle_share",
                    "device_launches_per_step", "step_peak_device_bytes",
                    "device_ms_per_step_by_kernel")}
            out["traces"][what][form]["step_peak_over_held"] = (
                f["step_peak_device_bytes"] / held)
        out["traces"][what]["replayed"]["graph_pool_bytes"] = (
            profile["replayed"]["graph_pool_bytes"])
        del engine, st
    del train, test
    torch.cuda.empty_cache()
    return out


def time_pooling(dev, traces, entries) -> dict:
    """What item 12 asks to measure before a fused gather-softmax-pool
    kernel is written: the plain PyTorch pooling (logits, softmax, weighted
    sum; forward and backward with respect to the query) at the attention
    steps' shapes, replayed 100 times from one CUDA graph (``graph_ms``),
    beside K2's multi-table launch at the same step's shape (``_attn``) and
    the replayed step's device time (``check_attention``'s trace), and its
    device time by kernel (``torch.profiler``, 10 calls); then the whole
    user-attention pools refresh of accl_user_s (every user's history rows
    by K2 a chunk, pooled in plain torch) beside K1's one-launch mean
    pools."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from heat_tpu_torch.models.aggregator import pool_history, user_pools_impl

    g = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for what, dtype, multi in (
            ("config0 self_attention", torch.float32, "gather_rows_multi"),
            ("accl_self_s", torch.bfloat16, "gather_rows_multi_bf16")):
        rows = (0.05 * torch.randn(BATCH, MAX_HIS, DIM, generator=g,
                                   device=dev)).to(dtype)
        lens = torch.randint(0, MAX_HIS + 1, (BATCH,), generator=g, device=dev,
                             dtype=torch.int32)
        q = (0.01 * torch.randn(DIM, generator=g, device=dev)).requires_grad_()
        cot = torch.randn(BATCH, DIM, generator=g, device=dev).to(dtype)

        def fwd_bwd():
            pooled = pool_history(rows, lens, attn_q=q.to(dtype),
                                  kind="self_attention")
            torch.autograd.grad(pooled, q, cot)

        def fwd():
            with torch.no_grad():
                pool_history(rows, lens, attn_q=q.to(dtype), kind="self_attention")

        fwd_bwd()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fwd_bwd()
            torch.cuda.synchronize()
        by_kernel = {
            e.key[:70]: e.self_device_time_total / 1e3 / 10
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}
        ms = graph_ms(fwd_bwd)
        step = traces[what]["replayed"]["device_ms_per_step"]
        k2 = entries[multi]["graph_ms_attn"]
        out[what] = {"pool_fwd_bwd_graph_ms": ms, "pool_fwd_graph_ms": graph_ms(fwd),
                     "k2_multi_attn_graph_ms": k2, "step_device_ms": step,
                     "pool_share_of_step": ms / step, "k2_share_of_step": k2 / step,
                     "pool_by_kernel_ms": by_kernel}
        print(f"pooling, {what}: forward + backward {ms:.4f} ms (graph), "
              f"K2 multi at the step's reads {k2:.4f} ms, the replayed step "
              f"{step:.4f} ms of device time: pooling {ms / step:.3f}, K2 "
              f"{k2 / step:.3f} of it")
        del rows, lens, q, cot
    items16 = (0.05 * torch.randn(NUM_ITEMS, DIM, generator=g, device=dev)).bfloat16()
    users16 = (0.05 * torch.randn(NUM_USERS, DIM, generator=g, device=dev)).bfloat16()
    his = torch.randint(0, NUM_ITEMS, (NUM_USERS, MAX_HIS), generator=g,
                        device=dev, dtype=torch.int32)
    lens = torch.randint(0, MAX_HIS + 1, (NUM_USERS,), generator=g, device=dev,
                         dtype=torch.int32)
    buf = torch.empty_like(users16)
    refresh = median_ms(lambda: user_pools_impl(
        items16, his, lens, user_emb=users16, aggregator="user_attention",
        out=buf))
    out["accl_user_s pools"] = {
        "refresh_ms": refresh, "chunk_users": attn_pool_chunk(MAX_HIS),
        "k1_mean_pools_graph_ms": entries["history_mean_gather_bf16"]["graph_ms_pools"]}
    print(f"pooling, accl_user_s: the pools of {NUM_USERS} users "
          f"{refresh:.4f} ms a refresh (median of {RUNS}), chunks of "
          f"{attn_pool_chunk(MAX_HIS)} users; K1's mean pools "
          f"{entries['history_mean_gather_bf16']['graph_ms_pools']:.4f} ms")
    return out


def check_serving_attention(dev, final_recall: float) -> dict:
    """The exported config0 self-attention model (``attn_q`` in the file)
    served on the card: requests of 1, 256 and 8192 users with and without
    ``aggregate_users`` held tie-aware against ``recommend_all`` with the
    same flag (the aggregated requests pool their users' history rows read
    by K2; ``recommend_all`` pools the whole table in chunks), the Recall@20
    of every user's requested top-20 against the run's final eval (within
    1e-5), and 64 cold users against a plain f64 oracle of the
    self-attention pooling."""
    import numpy as np
    import torch

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.evaluation.metrics import evaluate_metrics
    from heat_tpu_torch.export import load_embeddings
    from heat_tpu_torch.models.state import state_from_numpy
    from heat_tpu_torch.serving import Recommender

    cfg, _ = load_config(CONFIG0, **overrides_of(CONFIG0_SELF))
    train, test = synthetic_click_dataset(
        num_users=NUM_USERS, num_items=NUM_ITEMS, max_his=cfg.max_his,
        seed=cfg.seed)
    emb = load_embeddings(str(EXPORT_SELF))
    if "attn_q" not in emb:
        raise AssertionError("the self-attention export holds no attn_q")
    state = state_from_numpy(emb["user_emb"], emb["item_emb"], emb["w0"],
                             lr=cfg.l_r, step=0, device=dev,
                             attn_q=emb["attn_q"])
    rec = Recommender(state, cfg, seen_pairs=train.pairs,
                      his_items=train.his_items, his_masks=train.masks)
    k, out = REQUEST_K, {}
    rng = np.random.default_rng(4)
    for agg in (False, True):
        every = rec.recommend_all(k + 1, aggregate_users=agg)
        users = rec._user_embeddings(agg)
        tag = "agg_" if agg else ""
        for b, reps in ((1, 20), (256, 20), (REQUEST_B, 5)):
            uids = rng.integers(0, NUM_USERS, b)
            got = rec.recommend(uids, k + 1, aggregate_users=agg)
            same_topk(got, every[uids],
                      lambda ids: _score_rows(users, state.item_emb, uids, ids),
                      k, f"self-attention request B={b}, aggregate_users={agg}, "
                      f"vs recommend_all")
            out[f"serve_{tag}b{b}_ms"] = time_request(
                lambda: rec.recommend(uids, k, aggregate_users=agg), reps)
        del every, users
    top = np.concatenate([
        rec.recommend(np.arange(lo, min(lo + REQUEST_B, NUM_USERS)), k)
        for lo in range(0, NUM_USERS, REQUEST_B)])
    recall = evaluate_metrics(["Recall(k=20)"], top, test.user_items)["Recall(k=20)"]
    if abs(recall - final_recall) > 1e-5:
        raise AssertionError(
            f"served Recall@20 {recall} vs the run's final eval {final_recall}")
    out["served_recall20"] = recall

    hist = [train.his_items[u, : train.masks[u]].tolist() for u in range(64)]
    got = rec.recommend_cold(hist, k + 1)
    item = state.item_emb.double()
    it = item / item.norm(dim=1, keepdim=True).clamp(min=1e-12)
    q = state.attn_q.double()
    cold = []
    for h in hist:
        rows = item[torch.as_tensor(h, device=dev, dtype=torch.long)]
        a = torch.softmax(rows @ q * DIM ** -0.5, 0)
        u = (1.0 - cfg.gamma) * ((a @ rows) @ state.w0.double())
        cold.append(u / u.norm().clamp(min=1e-12))
    cold_u = torch.stack(cold)
    sims = cold_u @ it.T
    for r, h in enumerate(hist):
        sims[r, torch.as_tensor(h, device=dev, dtype=torch.long)] = -math.inf
    want = torch.topk(sims, k + 1, dim=1).indices.cpu().numpy()
    same_topk(got, want, lambda ids: _score_rows(cold_u, it, np.arange(64), ids),
              k, "self-attention recommend_cold vs a plain f64 oracle")
    out["cold_b64_ms"] = time_request(lambda: rec.recommend_cold(hist, k), 20)
    return out


def check_huge_attention(dev, reset, read) -> dict:
    """``bench_large --aggregator user_attention`` at its 16M x 6M bf16
    geometry in dedup mode: a warm-up epoch and one timed epoch; the pools
    of 16,000,000 users pooled with their own rows as queries, chunk by
    chunk through K2 (no K1), finite losses, and the peak device memory at
    most MEM_RATIO of the state, data and pools held."""
    import torch

    from heat_tpu_torch import bench_large

    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    record = bench_large.run(["--update-mode", "dedup", "--aggregator",
                              "user_attention", "--reps", "1"])
    wall = time.perf_counter() - t0
    launches = read()
    held = record["state_bytes"] + record["data_bytes"] + record["pools_bytes"]
    peak = record["peak_device_bytes"]
    chunks = 2 * -(-BIG_USERS // attn_pool_chunk(BIG_HIS))  # two refreshes
    print(f"bench_large dedup, user attention: epoch {record['value']} s; "
          f"losses {record['losses']}; {wall:.1f} s in all; launches "
          f"{launches}; peak device memory {peak / 1e9:.3f} GB against "
          f"{held / 1e9:.3f} GB held ({peak / held:.3f}x)")
    if record["aggregator"] != "user_attention" or not all(
            math.isfinite(x) for x in record["losses"]):
        raise AssertionError(f"bench_large user attention: {record}")
    if launches["history_mean_gather"] or launches["gather_rows_bf16"] != chunks:
        raise AssertionError(
            f"bench_large user attention: the pools took K1 "
            f"{launches['history_mean_gather']} times and K2 "
            f"{launches['gather_rows_bf16']} times, not 0 and {chunks}")
    if peak > MEM_RATIO * held:
        raise AssertionError(
            f"bench_large user attention: peak device memory {peak} B above "
            f"{MEM_RATIO} x {held} B held")
    record.update(launches=launches, wall_s=wall, peak_over_held=peak / held)
    torch.cuda.empty_cache()
    return record


# The run's lifecycle (ROADMAP items 8, 14, 17): the full-scale gate, the
# checkpoint resume, the trace, the phase breakdown and the native helpers.
LIFECYCLE = EXPORT.parent / "lifecycle"  # checkpoints, traces, the click file
PHASE_SUM_BAND = 0.05  # the breakdown's phases against the run's wall
SYNC_COST = 0.01  # the phase timer's syncs: at most this share of an epoch
SYNC_PAIRS = 12  # epochs with and without the syncs, alternated
RESUME_AT = 3  # the resumed runs stop after this many epochs, then go to 5


class _Tee:
    """Standard output to the terminal and into a buffer."""

    def __init__(self, out):
        import io

        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_cli(cli, argv) -> tuple[dict, str]:
    """``cli.main(argv)``, printing as it does; returns its record and what
    it printed."""
    import contextlib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        record = cli.main(argv)
    return record, tee.buf.getvalue()


def fresh_dir(name: str) -> Path:
    import shutil

    path = LIFECYCLE / name
    shutil.rmtree(path, ignore_errors=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def check_gate(finals: dict, data: bool = True):
    """The full-scale gate (ROADMAP items 8, 8b) against the JAX package's
    record ``PARITY_TORCH.json`` (``scripts/torch_parity_gate.py``):
    ``finals`` maps runs of the record (GATED_RUNS) to the final metrics of
    this script's CLI run of the same configuration and schedule, whose
    overrides must be the record's; each run's Recall@20 and NDCG@50 lie
    within its band (``parity.BANDS``: 0.0003 on the f32 runs, 0.0015 on
    the bf16 ones, set before their first run here; 0.0005 on the
    collapsed complement run, less than half its JAX metrics) of the JAX
    run's. With
    ``data``, also the data this script trains on (the CLI's
    ``--synthetic`` data, regenerated here with the port's copy of the
    generator) has the record's pair counts and SHA-256 checksums, and the
    JAX package's own spread over engine seeds is printed beside the bands.
    Returns the gaps and, with ``data``, the data (train, test)."""
    from heat_tpu_torch import parity
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset

    record = parity.load_parity()
    want = {"num_users": NUM_USERS, "num_items": NUM_ITEMS,
            "max_his": MAX_HIS, "seed": 2022}
    if record["synthetic"] != want:
        raise AssertionError(f"the gate's record was made at "
                             f"{record['synthetic']}, this script trains {want}")
    out = {"jax_version": record["jax_version"]}
    for run, final in finals.items():
        if record["runs"][run]["overrides"] != GATED_RUNS[run]:
            raise AssertionError(
                f"the gate's {run} ran {record['runs'][run]['overrides']}, "
                f"this script's {run} is {GATED_RUNS[run]}")
        out[run] = parity.gate(record, run, final, parity.BANDS[run])
        print(f"gate, {run} against the JAX package (jax "
              f"{record['jax_version']}, CPU): {json.dumps(out[run])}")
    if not data:
        return out, None
    out["jax_seed_spread"] = record["seed_spread"]
    print(f"gate: the JAX package's spread over engine seeds "
          f"{json.dumps(record['seed_spread'])}; bands {json.dumps(parity.BANDS)}")
    train, test = synthetic_click_dataset(**want)
    out["data"] = parity.check_data(record, train, test)
    return out, (train, test)


def check_gated_runs(cli, reset, read, check_run) -> dict:
    """The two configurations of the gate that no other phase trains,
    through the CLI at the record's schedule: ``headline_ccl`` (the
    headline with CosineContrastiveLoss, bench.py's ccl_s) and
    ``complement`` (the default shape with complement-scoped negatives),
    each held to the run checks with the headline's bf16 kernels, K1 once
    a pool refresh (an epoch; a sub-epoch under complement). Complement
    scope at two sub-epochs doubles each item's negative pressure and
    collapses (Recall@20 about 0.001 in both packages, the JAX record's
    own finding that made global scope the default), so that run is not
    held to learning: the gate holds it to the JAX run within
    ``parity.COLLAPSED_BAND``, which an untrained engine's metrics (a
    fifth of the JAX run's) fail. Returns each run's record."""
    import torch

    args = ["--config", CONFIG0, "--synthetic", SYNTHETIC, "--device", "cuda"]
    bf16 = {"gather_rows_multi_bf16": 1, "scatter_add_update_bf16": 1,
            "scatter_set_rows_bf16": 1,
            "window_extract": 3 * -(-NUM_USERS // EVAL_TILE)}
    out = {}
    for name, sets, refreshes in (("headline_ccl", HEADLINE_CCL, 5),
                                  ("complement", COMPLEMENT, 10)):
        torch.cuda.empty_cache()
        reset()
        record = cli.main(args + [x for kv in sets for x in ("--set", kv)])
        launches = read()
        check_run(name, record, launches,
                  {**bf16, "history_mean_gather_bf16": refreshes},
                  learns=name != "complement")
        if launches["history_mean_gather_bf16"] != refreshes:
            raise AssertionError(
                f"{name}: K1 launched {launches['history_mean_gather_bf16']} "
                f"times, not {refreshes}")
        out[name] = record
    return out


class EvaluateWatch:
    """Records, while installed, the keyword arguments of every
    ``Engine.evaluate`` call."""

    def __init__(self):
        from heat_tpu_torch.train.engine import Engine

        self.cls, self.orig, self.calls = Engine, Engine.evaluate, []

    def __enter__(self):
        watch, evaluate = self, self.orig

        def watched(engine, *args, **kw):
            watch.calls.append(kw)
            return evaluate(engine, *args, **kw)

        self.cls.evaluate = watched
        return self

    def __exit__(self, *exc):
        self.cls.evaluate = self.orig


def check_eval_approx_cli(cli, args, reset, read, check_run, config0) -> dict:
    """This slice's own main path (ROADMAP item 16): config0 through the CLI
    with ``--eval-approx APPROX_RECALL``. Its periodic evaluations call
    ``Engine.evaluate(exact=False, recall_target=APPROX_RECALL)``, the
    final one passes no flag, and every evaluation selects exactly, K4
    launched once an eval tile of each (three evaluations); the two
    periodic ``[Metrics]`` lines are printed; the run is held to the run
    checks and its final metrics to the JAX package's config0 (the gate's
    band) and to RECALL_BAND of this script's config0 run. Then
    ``--eval-approx 0`` and ``--eval-approx 0.9 --fused-run`` end in the
    parser's error (exit code 2) before anything is built."""
    import contextlib
    import io

    tiles = 3 * -(-NUM_USERS // EVAL_TILE)  # two periodic evals + final
    reset()
    with EvaluateWatch() as watch:
        record, printed = run_cli(
            cli, args + ["--eval-approx", str(APPROX_RECALL)])
    launches = read()
    check_run("config0 --eval-approx", record, launches, {
        "gather_rows_multi": 1, "history_mean_gather": 1,
        "scatter_add_rows": 1, "scatter_set_rows": 1, "window_extract": tiles})
    periodic = {"exact": False, "recall_target": APPROX_RECALL}
    if watch.calls != [periodic, periodic, {}]:
        raise AssertionError(f"config0 --eval-approx evaluated with {watch.calls}")
    if launches["window_extract"] != tiles:
        raise AssertionError(
            f"config0 --eval-approx: K4 launched {launches['window_extract']} "
            f"times, not once an eval tile of each evaluation ({tiles})")
    lines = [ln for ln in printed.splitlines() if ln.startswith("[Metrics]")]
    if len(lines) != 2 or [e["epoch"] for e in record["evals"]] != [2, 4]:
        raise AssertionError(f"config0 --eval-approx: periodic evals {lines}")
    final = record["final_metrics"]
    gap = final["Recall(k=20)"] - config0["final_metrics"]["Recall(k=20)"]
    if not abs(gap) <= RECALL_BAND:
        raise AssertionError(f"config0 --eval-approx: Recall@20 gap {gap}")
    gate, _ = check_gate({"config0": final}, data=False)
    refused = {}
    for flags in (["--eval-approx", "0"],
                  ["--eval-approx", "0.9", "--fused-run"]):
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                cli.main(args + flags)
        except SystemExit as e:
            refused[" ".join(flags)] = (e.code, err.getvalue().splitlines()[-1])
        else:
            raise AssertionError(f"{flags} ran")
        if refused[" ".join(flags)][0] != 2:
            raise AssertionError(f"{flags}: exit code {refused[' '.join(flags)]}")
    print(f"config0 --eval-approx {APPROX_RECALL}: evaluate calls {watch.calls}; "
          f"K4 launches {launches['window_extract']} ({tiles} eval tiles in "
          f"three evaluations); "
          f"periodic evals {[(e['epoch'], e['seconds']) for e in record['evals']]} s "
          f"against config0's {[(e['epoch'], e['seconds']) for e in config0['evals']]} s; "
          f"Recall@20 gap to config0 {gap:+.6f}; refused: {refused}")
    return {"evals": record["evals"], "final_eval_s": record["final_eval_s"],
            "epoch_times": record["epoch_times"], "gate": gate["config0"],
            "launches": launches, "refused": refused}


def check_approx(dev) -> dict:
    """``exact=False`` against the exact path on the card, on one trained
    config0 state (the CLI run's export): ``Engine.evaluate`` at
    APPROX_RECALL with every metric within 1e-6 of the exact evaluation's,
    the (U, 51) top ids of ``TiledEvaluator.topk`` equal up to ties, and a
    B = 8192 ``Recommender.recommend`` equal up to ties; both take the
    same exact selection, so a difference is a fault. Then the times of
    both calls, alternated: the whole evaluation (wall, a sync before and
    after) and the B = 8192 request (wall). Last, at the eval tile (512
    users) and at B = 8192, the selection alone over the scores and packed
    mask rows (CUDA events, ``median_ms``): ``masked_topk``, the two-phase
    top-k both calls run, against one ``torch.topk`` over the masked row,
    the sort-and-slice ``approx_max_k`` falls back to off a TPU; the port
    does not use the latter, it is timed to show why."""
    import numpy as np
    import torch

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset
    from heat_tpu_torch.evaluation.evaluator import (
        NEG_INF,
        masked_topk,
        unpack_bits,
    )
    from heat_tpu_torch.export import load_embeddings
    from heat_tpu_torch.models.state import state_from_numpy
    from heat_tpu_torch.serving import Recommender
    from heat_tpu_torch.train.engine import Engine

    cfg, _ = load_config(CONFIG0)
    train, test = synthetic_click_dataset(
        num_users=NUM_USERS, num_items=NUM_ITEMS, max_his=cfg.max_his,
        seed=cfg.seed)
    emb = load_embeddings(str(EXPORT))
    engine = Engine(cfg, train, test, device=dev)
    engine.state = state_from_numpy(emb["user_emb"], emb["item_emb"],
                                    emb["w0"], lr=cfg.l_r, step=0, device=dev)
    st = engine.state
    exact = engine.evaluate()
    approx = engine.evaluate(exact=False, recall_target=APPROX_RECALL)
    worst_metric = max(abs(exact[m] - approx[m]) for m in exact)
    if not worst_metric <= 1e-6:
        raise AssertionError(
            f"evaluate(exact=False) {approx} against evaluate() {exact}")
    ev, k = engine._evaluator, EVAL_K
    _, ids = ev.topk(st.user_emb, st.item_emb, k + 1)
    _, aids = ev.topk(st.user_emb, st.item_emb, k + 1, exact=False,
                      recall_target=APPROX_RECALL)
    users = np.arange(NUM_USERS)
    strict = same_topk(aids.cpu().numpy(), ids.cpu().numpy(),
                       lambda x: _score_rows(st.user_emb, st.item_emb, users, x),
                       k, "TiledEvaluator.topk exact=False vs exact")

    rec = Recommender(st, cfg, seen_pairs=train.pairs)
    uids = np.random.default_rng(5).integers(0, NUM_USERS, REQUEST_B)
    got = rec.recommend(uids, REQUEST_K + 1, exact=False,
                        recall_target=APPROX_RECALL)
    same_topk(got, rec.recommend(uids, REQUEST_K + 1),
              lambda x: _score_rows(st.user_emb, st.item_emb, uids, x),
              REQUEST_K, f"recommend B={REQUEST_B} exact=False vs exact")

    forms = {"exact": {}, "approx": {"exact": False,
                                     "recall_target": APPROX_RECALL}}
    times = {form: {"evaluate_s": [], "request_ms": []} for form in forms}
    for _ in range(3):
        for form, kw in forms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.evaluate(**kw)
            torch.cuda.synchronize()
            times[form]["evaluate_s"].append(time.perf_counter() - t0)
            times[form]["request_ms"].append(time_request(
                lambda kw=kw: rec.recommend(uids, REQUEST_K, **kw), 5))
    out = {"metrics_max_abs_diff": worst_metric, "strict_share": strict}
    for form in forms:
        out[form] = {
            "evaluate_s": statistics.median(times[form]["evaluate_s"]),
            "evaluate_s_all": times[form]["evaluate_s"],
            f"request_b{REQUEST_B}_ms": statistics.median(times[form]["request_ms"]),
        }
    item_t = rec._item_pad.float().T
    req = torch.as_tensor(uids, device=dev)
    for shape, users, bits in (
            ("eval_tile", torch.arange(EVAL_TILE, device=dev), ev.mask_bits[0]),
            (f"b{REQUEST_B}", req, rec._bits_flat.index_select(0, req))):
        sim = st.user_emb.index_select(0, users) @ item_t
        out[f"select_{shape}"] = {
            "two_phase_ms": median_ms(lambda: masked_topk(sim, bits, k)),
            "torch_topk_ms": median_ms(lambda: torch.topk(
                sim.masked_fill(unpack_bits(bits), NEG_INF), k, dim=1)),
        }
        del sim
    print(f"exact=False vs exact on the config0 export: metrics equal within "
          f"{worst_metric:.3g}; top-{k + 1} ids equal up to ties ({strict:.4f} of "
          f"rows strict); B={REQUEST_B} request equal up to ties; times "
          f"{json.dumps(out)}")
    del engine, st, rec, item_t
    torch.cuda.empty_cache()
    return out


def _snapshot(engine) -> dict:
    """Clones of everything a resume must give back: the state's tensors,
    the sampler's, the generator's state and the numpy generator's."""
    import dataclasses

    st, ss = engine.state, engine.sampler_state
    out = {}
    for f in dataclasses.fields(st):
        value = getattr(st, f.name)
        if isinstance(value, dict):
            out.update({f"{f.name}.{k}": v.clone() for k, v in value.items()})
        elif value is not None:
            out[f.name] = value.clone()
    out["iterations"] = ss.iterations.clone()
    if ss.tile is not None:
        out["tile"] = ss.tile.clone()
    out["generator"] = engine.generator.get_state()
    out["np_rng"] = engine._np_rng.bit_generator.state
    return out


def _same(a: dict, b: dict, what: str) -> None:
    import torch

    for key in a:
        equal = (a[key] == b[key]) if key == "np_rng" else torch.equal(a[key], b[key])
        if not equal:
            raise AssertionError(f"{what}: {key} differs")


def check_resume_distinct(dev) -> dict:
    """A resumed run on the card, bit for bit, where the step is
    deterministic (48 clicks that repeat no id, config0's and the default
    shape's configurations): two replayed epochs with a checkpoint after
    the first, against a fresh engine restored from it that replays the
    second (its first epoch after the restore, capture included); and the
    first engine restored from the same checkpoint after its captures,
    which drops them, replaying the second epoch again. Losses, every state
    tensor, the sampler's and both generators' states are equal."""
    import torch

    from heat_tpu_torch.checkpoint import CheckpointManager
    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.testing import distinct_id_dataset
    from heat_tpu_torch.train.engine import Engine

    distinct = distinct_id_dataset(DISTINCT_CLICKS, DISTINCT_ITEMS, MAX_HIS)
    out = {}
    for what, sets in (("config0", []), ("default shape", DEFAULT_SHAPE)):
        small = {**overrides_of(sets), **DISTINCT_SETS}
        if small.get("neg_sampler") == 1:
            small.update(DISTINCT_TILE_SETS)

        def make(small=small):
            return Engine(load_config(CONFIG0, **small)[0], distinct, device=dev)

        mgr = CheckpointManager(str(fresh_dir(f"distinct_{len(sets)}")))
        full = make()
        full.train_one_epoch()
        mgr.save(full)
        loss_full = full.train_one_epoch()
        want = _snapshot(full)
        resumed = make()
        if mgr.restore_latest(resumed) != 1:
            raise AssertionError(f"{what}: the checkpoint of epoch 1 is not the newest")
        loss_resumed = resumed.train_one_epoch()
        _same(want, _snapshot(resumed), f"{what} on distinct clicks, resumed")
        captures_before = full._epoch_fns[True].captures
        mgr.restore_latest(full)
        if full._epoch_fns:
            raise AssertionError(f"{what}: a restore kept the captures")
        loss_again = full.train_one_epoch()
        _same(want, _snapshot(full), f"{what} on distinct clicks, restored "
              f"after its captures")
        if not loss_full == loss_resumed == loss_again:
            raise AssertionError(
                f"{what}: losses {loss_full} / {loss_resumed} / {loss_again}")
        captures = resumed._epoch_fns[True].captures
        print(f"resume on {DISTINCT_CLICKS} clicks that repeat no id, {what}: "
              f"bit-equal (fresh engine: {captures} capture; the same engine "
              f"after {captures_before} capture(s), restored: "
              f"{full._epoch_fns[True].captures} new)")
        out[what] = {"loss": loss_full, "captures_resumed": captures}
        del full, resumed
    torch.cuda.empty_cache()
    return out


def check_resume_cli(dev, cli, args) -> dict:
    """Checkpoint and resume through the CLI at full width, config0 and the
    default shape: three uninterrupted 5-epoch runs with
    ``--checkpoint-dir`` (the spread) and a run of RESUME_AT epochs resumed
    to 5 with the same directory, each step's draws fingerprinted and its
    loss recorded (``StepRecorder``). The draws, ``step``, ``iterations``,
    the tile and both generators' final states equal the first
    uninterrupted run's exactly. The tables, ``w0`` (the final checkpoints)
    and the step losses lie within twice the spread by root mean square
    (``check_replayed_against_eager``'s measure: K3's atomics add in no
    fixed order), equal where that spread is 0: the spread pools the three
    pairs of uninterrupted runs, the resumed run's difference its three
    pairs with them (how far two runs drift apart is itself a random
    amount, and one pair on each side reads it badly). Each run's epoch
    losses are its own steps' loss sums over the training pairs, to within
    f32 summation (the resumed epochs count each step once); they are
    reported beside their spread, not bounded by it: five numbers, each the
    mean of some 232 step losses, say nothing the step losses do not and
    are the noisiest reading of them."""
    import torch

    from heat_tpu_torch.testing import StepRecorder
    from heat_tpu_torch.train.engine import Engine

    uninterrupted = ("whole", "again", "again2")
    out = {}
    for what, sets in (("config0", []), ("default shape", DEFAULT_SHAPE)):
        flags = [x for kv in sets for x in ("--set", kv)]
        subs = 2 if "num_subepochs=2" in sets else 1
        tile = TILE if "neg_sampler=1" in sets else 0
        runs = {}
        plan = [(name, [[]]) for name in uninterrupted] + [
            ("resumed", [["--epochs", str(RESUME_AT)], []])]
        for name, legs in plan:
            ck = fresh_dir(f"cli_{len(sets)}_{name}")
            prints, step_losses, losses, seconds, epochs = [], [], [], [], []
            sizes = []
            for i, leg in enumerate(legs):
                rec = StepRecorder(5 * (-(-1895148 // BATCH) + subs - 1),
                                   BATCH, NUM_NEGS, tile, dev, False)
                epoch, ends = Engine._epoch, []

                def counted(self, capture, epoch=epoch, rec=rec, ends=ends):
                    # The steps recorded so far, read in stream order.
                    loss_sum = epoch(self, capture)
                    ends.append(rec.count.clone())
                    sizes.append(self.cfg.train_size)
                    return loss_sum

                Engine._epoch = counted
                try:
                    with rec:
                        record, text = run_cli(cli, args + flags + leg
                                               + ["--checkpoint-dir", str(ck)])
                finally:
                    Engine._epoch = epoch
                resumed_line = f"resumed from epoch {RESUME_AT}"
                if (resumed_line in text.splitlines()) != (i == 1):
                    raise AssertionError(f"{what} {name}: leg {i} printed "
                                         f"{text.splitlines()[:2]}")
                n = int(rec.count)
                fp, sl = rec.records()
                prints.append(fp[:n])
                step_losses.append(sl[:n])
                ends = [0] + [int(e) for e in ends]
                if ends[-1] != n:
                    raise AssertionError(f"{what} {name}: leg {i} counted "
                                         f"{n} steps, its epochs {ends}")
                epochs += [sl[lo:hi].double() for lo, hi in zip(ends, ends[1:])]
                losses += record["losses"]
                seconds += record["epoch_times"]
            ckpt = torch.load(ck / "ckpt_5.pt", weights_only=True,
                              map_location=dev)
            check_epoch_sums(f"{what} {name}", losses, epochs, sizes)
            runs[name] = {"prints": torch.cat(prints),
                          "step_losses": torch.cat(step_losses),
                          "epoch_losses": torch.tensor(losses, dtype=torch.float64),
                          "ckpt": ckpt, "recall": record["final_metrics"]["Recall(k=20)"],
                          "epoch_s": seconds}
        whole = runs["whole"]
        for name in ("again", "again2", "resumed"):
            run = runs[name]
            if not torch.equal(run["prints"], whole["prints"]):
                raise AssertionError(f"{what} {name}: the draws differ "
                                     f"({run['prints'].shape[0]} steps against "
                                     f"{whole['prints'].shape[0]})")
            a, b = whole["ckpt"], run["ckpt"]
            exact = {"step": (a["state"]["step"], b["state"]["step"]),
                     "iterations": (a["sampler"]["iterations"],
                                    b["sampler"]["iterations"]),
                     "generator": (a["generator"]["state"], b["generator"]["state"])}
            if a["sampler"]["tile"] is not None:
                exact["tile"] = (a["sampler"]["tile"], b["sampler"]["tile"])
            for key, (x, y) in exact.items():
                if not torch.equal(x, y):
                    raise AssertionError(f"{what} {name}: {key} differs")
            if a["np_rng"] != b["np_rng"] or not a["epoch"] == b["epoch"] == 5:
                raise AssertionError(f"{what} {name}: numpy generator or epoch")
        res = {"steps": int(whole["prints"].shape[0]),
               "recall": {k: r["recall"] for k, r in runs.items()},
               "epoch_losses_by_run": {k: r["epoch_losses"].tolist()
                                       for k, r in runs.items()},
               "epoch_s": {k: r["epoch_s"] for k, r in runs.items()}}
        for key in ("user_emb", "item_emb", "w0", "step_losses", "epoch_losses"):
            def value(name, key=key):
                run = runs[name]
                return run[key] if key.endswith("losses") else run["ckpt"]["state"][key]

            spread, spread_max = pooled_rms_diff(
                [(value(x), value(y)) for x, y in
                 itertools.combinations(uninterrupted, 2)])
            diff, diff_max = pooled_rms_diff(
                [(value("resumed"), value(x)) for x in uninterrupted])
            res[key] = {"spread_rms": spread, "resumed_rms": diff,
                        "spread_max": spread_max, "resumed_max": diff_max}
            if key != "epoch_losses" and diff > 2 * spread:
                raise AssertionError(
                    f"{what}: the resumed {key} is off the uninterrupted runs' "
                    f"by {diff} (rms over three pairs), more than twice their "
                    f"spread {spread}")
        print(f"resume through the CLI, {what}: {RESUME_AT} epochs then 5 "
              f"against 5: draws equal over {res['steps']} steps, step, "
              f"iterations and generators equal; {json.dumps(res)}")
        out[what] = res
    torch.cuda.empty_cache()
    return out


def pooled_rms_diff(pairs) -> tuple[float, float]:
    """(root-mean-square, max) of a - b over the elements of all pairs
    (``rms_diff`` pooled, each pair of the same size)."""
    diffs = [rms_diff(a, b) for a, b in pairs]
    return (math.sqrt(sum(r * r for r, _ in diffs) / len(diffs)),
            max(m for _, m in diffs))


def check_epoch_sums(what, losses, epochs, sizes) -> None:
    """Each epoch loss the CLI printed is its steps' f32 loss sums added in
    f32 over the epoch's training pairs (``sizes``): within the bound of f32
    summation, n + 2 units of 2**-24 of the sum of the n step losses (and
    the sub-epochs' partial sums) from their exact f64 sum."""
    if not len(epochs) == len(sizes) == len(losses):
        raise AssertionError(f"{what}: {len(losses)} epoch losses, "
                             f"{len(epochs)} epochs of steps")
    for e, (loss, steps, train_size) in enumerate(zip(losses, epochs, sizes)):
        exact = float(steps.sum())
        bound = (steps.numel() + 2) * 2.0 ** -24 * float(steps.abs().sum())
        if not steps.numel() or abs(loss * train_size - exact) > bound:
            raise AssertionError(
                f"{what}: epoch {e} loss {loss} is not its {steps.numel()} "
                f"steps' sum {exact} over {train_size} (bound {bound})")


def check_profile_dir(cli, args) -> dict:
    """``--profile-dir`` on config0 over two epochs: one trace file of the
    second epoch, whose device events name the port's kernels (replayed
    steps: the graph's kernels) at least once a step for K1, K2 multi and
    S1, twice for K3."""
    from collections import Counter

    from heat_tpu_torch import bench_large

    out_dir = fresh_dir("trace")
    t0 = time.perf_counter()
    record = cli.main(args + ["--epochs", "2", "--profile-dir", str(out_dir)])
    wall = time.perf_counter() - t0
    traces = sorted(out_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile-dir wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    port = Counter(f for f in map(bench_large.kernel_family, kernels) if f)
    steps = -(-1895148 // BATCH)
    want = {"K1": steps, "K2_multi": steps, "K3": 2 * steps, "S1": steps}
    short = {k: port[k] for k, n in want.items() if port[k] < n}
    if short:
        raise AssertionError(
            f"the trace of a replayed config0 epoch holds too few of the "
            f"port's kernels: {short} (want {want}; {dict(port)})")
    res = {"trace_bytes": traces[0].stat().st_size, "kernel_events": len(kernels),
           "port_kernels": dict(port), "epoch_s": record["epoch_times"],
           "run_s": wall}
    print(f"--profile-dir: {json.dumps(res)}")
    return res


def check_breakdown(dev, cli, args, train, test) -> dict:
    """``--breakdown`` on config0's run: the phases ``data``, ``f_b`` and
    ``eval``, their sum within PHASE_SUM_BAND of the run's wall (its
    epochs' and evaluations' seconds, as the CLI times them). Then, one
    engine each of config0 and the default shape, after the capture,
    SYNC_PAIRS pairs of replayed epochs with the phases' syncs and without
    (``Engine.sync_phases``), alternated: the syncs' cost is the fastest
    epoch with them over the fastest without, less 1 (the host's noise only
    adds time, and the fastest of SYNC_PAIRS epochs is the least noisy
    reading; the median of the pairs' differences is reported beside it),
    at most SYNC_COST."""
    import torch

    from heat_tpu_torch.config import load_config
    from heat_tpu_torch.train.engine import Engine

    record, text = run_cli(cli, args + ["--breakdown"])
    lines = text.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith("total: "))
    phases = {}
    for ln in lines[at + 1:]:
        name, _, rest = ln.strip().partition(": ")
        if name not in ("data", "f_b", "eval"):
            break
        phases[name] = float(rest.split("s")[0])
    wall = (sum(record["epoch_times"]) + sum(e["seconds"] for e in record["evals"])
            + record["final_eval_s"])
    total = sum(phases.values())
    if set(phases) != {"data", "f_b", "eval"} or not (
            abs(total - wall) <= PHASE_SUM_BAND * wall):
        raise AssertionError(f"--breakdown: phases {phases} (sum {total} s) "
                             f"against the run's {wall} s")
    out = {"phases_s": phases, "phases_sum_s": total, "run_wall_s": wall}
    for what, sets in (("config0", []), ("default shape", DEFAULT_SHAPE)):
        engine = Engine(load_config(CONFIG0, **overrides_of(sets))[0], train,
                        test, device=dev)
        engine.train_one_epoch()  # the capture
        pairs = []
        for i in range(SYNC_PAIRS):
            times = {}
            for sync in ((True, False) if i % 2 == 0 else (False, True)):
                engine.sync_phases = sync
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                engine.train_one_epoch()
                times[sync] = time.perf_counter() - t0
            pairs.append(times)
        with_s, without_s = ([p[k] for p in pairs] for k in (True, False))
        cost = min(with_s) / min(without_s) - 1.0
        out[what] = {"with_syncs_s": with_s, "without_s": without_s,
                     "cost": cost, "median_paired_cost": statistics.median(
                         (p[True] - p[False]) / p[False] for p in pairs)}
        if not cost <= SYNC_COST:
            raise AssertionError(
                f"{what}: the phase timer's syncs cost {cost:.4f} of an epoch "
                f"(fastest of {SYNC_PAIRS} against fastest of {SYNC_PAIRS}), "
                f"more than {SYNC_COST}")
        del engine
    print(f"--breakdown: {json.dumps(out)}")
    return out


def time_checkpoint(engine, name: str) -> dict:
    """The host's seconds to save ``engine``'s checkpoint and to restore it
    into the same engine, with the file's bytes; not measured (and said so)
    where the disk holds less than twice the state."""
    import shutil

    import torch

    from heat_tpu_torch.checkpoint import CheckpointManager

    d = fresh_dir(name)
    d.mkdir()
    st = engine.state
    held = sum(t.numel() * t.element_size() for t in (
        st.user_emb, st.item_emb, st.w0))
    free = shutil.disk_usage(d).free
    if free < 2 * held:
        return {"not_measured": f"{free} bytes free for a {held}-byte state"}
    before = float(st.user_emb[:4096].float().sum())
    mgr = CheckpointManager(str(d))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(engine)
    save_s = time.perf_counter() - t0
    size = sum(p.stat().st_size for p in d.iterdir())
    st.user_emb[:4096].zero_()
    t0 = time.perf_counter()
    mgr.restore_latest(engine)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if float(st.user_emb[:4096].float().sum()) != before:
        raise AssertionError(f"{name}: the restored table differs")
    shutil.rmtree(d)
    return {"save_s": save_s, "restore_s": restore_s, "file_bytes": size,
            "state_bytes": held}


def check_native(train, test) -> dict:
    """The native host helpers on the card's machine: built from the
    repository's sources into build/ (timed apart when this call builds
    them, ``build_s``), the click parser on the full
    synthetic train split written as a text file (under build/) and the hit
    matrix of a (52,643, 50) ranking against the test split, each equal to
    its numpy path and timed beside it; ``ClickDataset.from_file`` must take
    the native path (``native.PATHS``), not the fallback."""
    import numpy as np

    from heat_tpu_torch import native
    from heat_tpu_torch.data.datasets import ClickDataset, _parse_lines_numpy
    from heat_tpu_torch.evaluation import metrics

    path = fresh_dir("clicks_train.txt")
    with open(path, "w") as f:
        for u, items in enumerate(train.user_items):
            f.write(" ".join(map(str, [u, *items.tolist()])) + "\n")
    built = not native._SO.exists()
    t0 = time.perf_counter()
    native._lib()  # builds here when build/ holds no library yet
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native.parse_click_file(str(path))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _parse_lines_numpy(str(path), " ")
    numpy_s = time.perf_counter() - t0
    if len(got) != len(want) or not all(
            np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the native parser differs from the numpy parser")
    ds = ClickDataset.from_file(str(path), max_his=MAX_HIS, seed=2022)
    if native.PATHS.get("parse_click_file") != "native":
        raise AssertionError(f"from_file took the numpy path: {native.BUILD_ERROR}")
    if not np.array_equal(ds.pairs, train.pairs):
        raise AssertionError("from_file's pairs differ from the data written")
    top = np.random.default_rng(0).integers(
        0, NUM_ITEMS, (NUM_USERS, 50)).astype(np.int32)
    t0 = time.perf_counter()
    hits = metrics._hits_matrix(top, test.user_items)
    hits_native_s = time.perf_counter() - t0
    if native.PATHS.get("hits_matrix") != "native":
        raise AssertionError(f"the hit matrix took the numpy path: {native.BUILD_ERROR}")
    kernel = native.hits_matrix
    native.hits_matrix = None  # the fallback, for its time
    try:
        t0 = time.perf_counter()
        plain = metrics._hits_matrix(top, test.user_items)
        hits_numpy_s = time.perf_counter() - t0
    finally:
        native.hits_matrix = kernel
    if not np.array_equal(hits, plain):
        raise AssertionError("the native hit matrix differs from numpy's")
    out = {"build_s": build_s if built else None,
           "file_bytes": path.stat().st_size, "users": len(got),
           "pairs": int(ds.pairs.shape[0]), "parse_native_s": native_s,
           "parse_numpy_s": numpy_s, "hits_native_s": hits_native_s,
           "hits_numpy_s": hits_numpy_s, "hits": int(hits.sum()),
           "library": str(native._SO.relative_to(Path(__file__).resolve().parent))}
    print(f"native helpers: {json.dumps(out)}")
    return out


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

    def check_run(what, record, launches, least, learns=True):
        """The checks every full training run is held to: five finite
        epoch losses that fall, metrics in range, every eval tile through
        K4, and each wrapper of ``least`` launched at least that often (a
        step's wrappers launch in the capture's warm-up step and record
        their launch in the capture; the replays call none, so the
        replayed steps' kernels are counted from device traces:
        ``check_trace``). A run that does not learn (``learns=False``:
        complement scope, which collapses in the JAX package too) is not
        held to falling losses and to ten times the untrained Recall@20;
        the gate holds it to its JAX run instead."""
        losses = record["losses"]
        if len(losses) != 5 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: expected 5 finite epoch losses, got {losses}")
        if learns and not losses[4] < losses[0]:
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
        if learns and not final["Recall(k=20)"] >= 10 * untrained["Recall(k=20)"]:
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
    check_run("config0", record, launches, {
        "gather_rows_multi": 1, "history_mean_gather": 1,
        "scatter_add_rows": 1, "scatter_set_rows": 1,
        "window_extract": eval_tiles})
    if any(n for name, n in launches.items() if name.endswith("_bf16")):
        raise AssertionError(f"config0 launched a bf16 kernel: {launches}")
    print(f"peak device memory (training run): "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    final = record["final_metrics"]

    # config0 through the CLI's fused flags: train_epochs chunks up to the
    # next evaluation, and the whole schedule in run_epochs_with_eval.
    cli_runs = {"default": record}
    for flags in (["--fused-epochs", "5"], ["--fused-run"]):
        reset()
        fused = cli.main(args + flags)
        fused_launches = read()
        check_run(f"config0 {' '.join(flags)}", fused, fused_launches, {
            "gather_rows_multi": 1, "history_mean_gather": 1,
            "scatter_add_rows": 1, "scatter_set_rows": 1,
            "window_extract": eval_tiles})
        gap = fused["final_metrics"]["Recall(k=20)"] - final["Recall(k=20)"]
        if not abs(gap) <= RECALL_BAND:
            raise AssertionError(f"config0 {flags}: Recall@20 gap {gap}")
        cli_runs[flags[0].lstrip("-")] = fused
    eval_approx = check_eval_approx_cli(cli, args, reset, read, check_run, record)
    approx_launches = eval_approx["launches"]

    # The headline configuration at full width: tile sampler with
    # whole-tile scoring, cached pools, bf16 tables and compute, direct.
    reset()
    head = cli.main(args + [x for kv in HEADLINE for x in ("--set", kv)]
                    + ["--export-embeddings", str(EXPORT_HEADLINE)])
    head_launches = read()
    pool_chunks = 5  # the pools of every user: one launch an epoch
    check_run("headline", head, head_launches, {
        # user, positive, tile and pool rows in one launch; the pools; the
        # user and the item update (K3's update entry); the user write-back:
        # all on bf16 tables.
        "gather_rows_multi_bf16": 1, "history_mean_gather_bf16": pool_chunks,
        "scatter_add_update_bf16": 1, "scatter_set_rows_bf16": 1,
        "window_extract": eval_tiles})
    if head_launches["scatter_add_rows"]:
        raise AssertionError(
            f"headline: the plain scatter-add ran beside its update entry: "
            f"{head_launches}")
    for name in ("gather_rows", "gather_rows_multi", "history_mean_gather",
                 "scatter_add_update", "scatter_set_rows"):
        if head_launches[name] != head_launches[name + "_bf16"]:
            raise AssertionError(f"headline launched an f32 {name}: {head_launches}")
    if head_launches["history_mean_gather"] != pool_chunks:
        raise AssertionError(
            f"headline: K1 launched {head_launches['history_mean_gather']} "
            f"times, not once an epoch ({pool_chunks})"
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
    gate, (gate_train, gate_test) = check_gate(
        {"config0": final, "headline": head_final})

    replay = check_replay(dev)
    subepochs = check_subepochs(dev, cli, reset, read, final["Recall(k=20)"],
                                check_run)
    attention = check_attention(dev, cli, reset, read, final["Recall(k=20)"],
                                check_run)
    gated = check_gated_runs(cli, reset, read, check_run)
    gate.update(check_gate({
        "default_shape": subepochs["runs"]["default shape"]["final_metrics"],
        "config0_self_attention":
            attention["runs"]["config0 self_attention"]["final_metrics"],
        "accl_user_s": attention["runs"]["accl_user_s"]["final_metrics"],
        "accl_self_s": attention["runs"]["accl_self_s"]["final_metrics"],
        "headline_ccl": gated["headline_ccl"]["final_metrics"],
        "complement": gated["complement"]["final_metrics"],
    }, data=False)[0])
    lifecycle = {
        "gate": gate,
        "eval_approx": eval_approx,
        "gated_runs": {name: {key: r[key] for key in (
            "losses", "epoch_times", "final_eval_s", "final_metrics")}
            for name, r in gated.items()},
        "resume_distinct": check_resume_distinct(dev),
        "resume_cli": check_resume_cli(dev, cli, args),
        "profile_dir": check_profile_dir(cli, args),
        "breakdown": check_breakdown(dev, cli, args, gate_train, gate_test),
        "native": check_native(gate_train, gate_test),
        "checkpoint_16m_6m": replay["dedup_16m_6m"]["checkpoint"],
    }
    del gate_train, gate_test

    reset()
    serving = check_serving(dev, final["Recall(k=20)"])
    serving.update(check_huge_table(dev))
    serving_launches = read()
    for name in ("gather_rows", "history_mean_gather", "window_extract"):
        if serving_launches[name] < 1:
            raise AssertionError(f"{name} was not launched by serving")
    serving["approx"] = check_approx(dev)
    print(f"serving: {json.dumps(serving)}")
    print(f"serving launches: {serving_launches}")
    reset()
    serving16 = check_serving_bf16(dev)
    serving16_launches = read()
    for name in ("gather_rows_bf16", "history_mean_gather_bf16"):
        if serving16_launches[name] < 1:
            raise AssertionError(f"{name} was not launched by bf16 serving")
    print(f"serving, bf16 tables: {json.dumps(serving16)}")
    print(f"serving launches, bf16 tables: {serving16_launches}")
    reset()
    serving_attn = check_serving_attention(
        dev, attention["runs"]["config0 self_attention"]["recall"])
    serving_attn_launches = read()
    for name in ("gather_rows", "window_extract"):
        if serving_attn_launches[name] < 1:
            raise AssertionError(f"{name} was not launched by self-attention serving")
    if serving_attn_launches["history_mean_gather"]:
        raise AssertionError("self-attention serving launched K1")
    print(f"serving, self-attention: {json.dumps(serving_attn)}")
    print(f"serving launches, self-attention: {serving_attn_launches}")

    huge_f32 = check_huge_f32(dev, reset, read)
    huge = check_huge_training(reset, read)
    huge_sub = check_huge_subepochs(dev)
    huge_attn = check_huge_attention(dev, reset, read)
    print(f"16M x 6M dedup epoch: 2 sub-epochs {huge_sub['epoch_s']:.4f} s "
          f"against {huge['dedup']['value']} s unpartitioned (bench_large, "
          f"this call)")
    # The headline step at its own geometry through the same entry point,
    # for its launches per step (a warm-up and one timed epoch, then
    # PROFILE_STEPS steps timed and as many traced).
    from heat_tpu_torch import bench_large

    head_before = torch.cuda.memory_allocated()
    head_bench = bench_large.run([
        "--users", str(NUM_USERS), "--items", str(NUM_ITEMS), "--clicks",
        "1895148", "--max-his", str(MAX_HIS), "--batch", str(BATCH), "--tile",
        str(TILE), "--refresh", "8192", "--update-mode", "direct", "--reps",
        "1", "--profile", str(PROFILE_STEPS)])
    head_bench["allocated_before_bytes"] = head_before
    head_trace = check_trace("headline geometry", head_bench["profile"],
                             ("K2_multi", "K3", "S1"))
    if head_trace["K1"]:
        raise AssertionError(f"the headline step ran K1: {head_trace}")
    if subepochs["trace"] != head_trace:
        raise AssertionError(
            f"a replayed default-shape sub-epoch step launched "
            f"{subepochs['trace']} of the port's kernels, the headline step "
            f"{head_trace}")
    benches = {"headline": head_bench, "dedup_16m_6m": huge["dedup"],
               "direct_16m_6m": huge["direct"]}
    per_step = {name: b["profile"] for name, b in benches.items()}
    print(json.dumps({"launches_per_step": {
        name: {"before": LAUNCHES_BEFORE.get(name),
               "after": p["device_launches_per_step"],
               "device_ms_per_step": p["device_ms_per_step"],
               "wall_ms_per_step": p["wall_ms_per_step"],
               "idle_share": p["idle_share"]}
        for name, p in per_step.items()}}))
    # (c): eager and replayed steps, from one call, beside what is held.
    forms = {}
    for name, b in benches.items():
        held = b["state_bytes"] + b["data_bytes"] + b["pools_bytes"]
        forms[name] = {"epoch_s": b["value"], "held_bytes": held,
                       "allocated_before_bytes": b["allocated_before_bytes"],
                       "captures": b["captures"],
                       "epoch_peak_over_held": b["peak_device_bytes"] / held}
        for form in ("eager", "replayed"):
            f = b["profile"][form]
            forms[name][form] = {
                key: f[key] for key in (
                    "wall_ms_per_step", "device_ms_per_step", "idle_share",
                    "device_launches_per_step", "step_peak_device_bytes")}
            forms[name][form]["step_peak_over_held"] = (
                f["step_peak_device_bytes"] / held)
        forms[name]["replayed"]["graph_pool_bytes"] = (
            b["profile"]["replayed"]["graph_pool_bytes"])
        forms[name]["replayed"]["first_step_ms"] = (
            b["profile"]["replayed"]["first_step_ms"])
    forms["config0_cli_epoch_s"] = {
        name: r["epoch_times"] for name, r in cli_runs.items()}
    forms["replay"] = replay
    forms["subepochs"] = {**subepochs, "huge_16m_6m": huge_sub}
    print(json.dumps({"eager_vs_replayed": forms}))
    pooling = time_pooling(dev, attention["traces"], {k["name"]: k for k in kernels})
    huge_attn_keys = ("value", "epoch_times_s", "losses", "peak_device_bytes",
                      "state_bytes", "data_bytes", "pools_bytes",
                      "peak_over_held", "captures", "launches", "wall_s")
    print(json.dumps({"attention": {
        **attention, "pooling": pooling, "serving": serving_attn,
        "huge_16m_6m_user_attention": {k: huge_attn[k] for k in huge_attn_keys},
        "headline_epoch_s": head["epoch_times"],
        "config0_epoch_s": record["epoch_times"]}}))
    print(f"card for the line above: {card}")
    print(json.dumps({"lifecycle": lifecycle}))
    print(f"card for the line above: {card}")
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
    # use the update entry) on the bf16 Adagrad huge-table run. K2's single
    # entry, which the steps left for the multi-table launch: the requested
    # users' rows in serving, f32 on the config0 export and bf16 on the
    # headline's.
    dedup_f32 = huge_f32["dedup"]["launches"]
    on_path = {
        "gather_rows": (serving_launches["gather_rows"]
                        - serving_launches["gather_rows_bf16"]),
        "gather_rows_bf16": serving16_launches["gather_rows_bf16"],
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
        k["launches_eval_approx"] = approx_launches[name]
        k["launches_serving"] = serving_launches[name]
        k["launches_serving_bf16"] = serving16_launches[name]
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
