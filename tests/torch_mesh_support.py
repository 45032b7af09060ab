"""Test support for the mesh (ROADMAP item 15a), shared by the tests and
``chip_smoke.py``: starting the ranks of a job, the rank programs that
train, rank and checkpoint on a mesh and report what the comparisons
need, and their single-rank oracles.

:func:`spawn_ranks` runs one function in ``world`` new processes, each a
rank of a ``torch.distributed`` job over localhost (gloo on the CPU, or
where the ranks share a card; NCCL at a world of one on a card), and
returns what each rank returned. The rank programs below are such
functions; :func:`train_oracle` is their single-rank counterpart, an
engine whose batch stream is laid out as the mesh's is
(``Engine._shard_stream(n_data)``), so that it steps the mesh's global
batches with its draws. Import it as ``torch_mesh_support`` with this
directory on ``sys.path`` (pytest puts it there; ``chip_smoke.py`` adds
it), so that the spawned ranks find it under the same name.
"""

from __future__ import annotations

import hashlib
import math
import os
import socket
import time
import traceback
from typing import Optional

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(target, rank, world, port, device, args, kwargs, queue) -> None:
    import torch

    from heat_tpu_torch.parallel import distributed

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device)
        queue.put((rank, True, target(rank, *args, **kwargs)))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def spawn_ranks(target, world: int, *args, device: str = "cpu",
                timeout: float = 240.0, **kwargs) -> list:
    """``target(rank, *args, **kwargs)`` in ``world`` new processes, each
    one rank of
    a job whose store listens on a free localhost port; returns the ranks'
    results in rank order. A rank that raises, or a job that outlasts
    ``timeout`` seconds, raises RuntimeError (with the rank's traceback)
    once every process is stopped."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.pop(k) for k in env_keys if k in os.environ}
    procs = [ctx.Process(target=_entry, args=(target, r, world, port, device,
                                              args, kwargs, queue))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        results = {}
        deadline = time.monotonic() + timeout
        while len(results) < world:
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"{target.__name__}: ranks {dead} exited without a "
                        f"result (exit codes {[procs[r].exitcode for r in dead]})"
                    ) from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{target.__name__}: the ranks took more than "
                        f"{timeout} s (done: {sorted(results)})") from None
                continue
            if not ok:
                raise RuntimeError(f"{target.__name__}: rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(30)
        return [results[r] for r in range(world)]
    finally:
        os.environ.update(saved)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (a bf16 tensor's as int16): how
    replicas are held bit-equal."""
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


UNIFORM_BLOCK = 1 << 20  # users whose histories one generator draws


def uniform_data(users: int, items: int, clicks: int, max_his: int,
                 seed: int = 0, shard: Optional[tuple] = None):
    """``bench_large``'s kind of data at any scale: ``clicks`` uniform
    random (user, item) pairs and full histories of uniform random items,
    the histories drawn in blocks of UNIFORM_BLOCK users from generators
    seeded by (seed, block), so that a rank draws only its own rows.
    Returns the train ClickDataset (no test data: None), whole, or with
    ``shard=(n_data, index)`` the data shard's user range with global ids
    (``shard_by_user_range(..., rebase=False)``'s result)."""
    from heat_tpu_torch.data.datasets import ClickDataset, user_range_bounds

    rng = np.random.default_rng(seed)
    pairs = np.stack([rng.integers(0, users, clicks, dtype=np.int32),
                      rng.integers(0, items, clicks, dtype=np.int32)], axis=1)
    lo, hi = 0, users
    if shard is not None:
        lo, hi = user_range_bounds(users, *shard)
        pairs = pairs[(pairs[:, 0] >= lo) & (pairs[:, 0] < hi)]
    his = np.empty((hi - lo, max_his), np.int32)
    for block in range(lo // UNIFORM_BLOCK, -(-hi // UNIFORM_BLOCK)):
        b_lo = block * UNIFORM_BLOCK
        rows = np.random.default_rng((seed, block)).integers(
            0, items, (min(UNIFORM_BLOCK, users - b_lo), max_his),
            dtype=np.int32)
        a, b = max(b_lo, lo), min(b_lo + rows.shape[0], hi)
        his[a - lo: b - lo] = rows[a - b_lo: b - b_lo]
    return ClickDataset(pairs=pairs, his_items=his,
                        masks=np.full(hi - lo, max_his, np.int32),
                        num_users=users, num_items=items, max_his=max_his,
                        user_items=[]), None


def make_data(data_kw: dict):
    """The planted-cluster (train, test) of ``data_kw``. With
    ``narrow_users=(first, items)`` the train clicks of the users from
    ``first`` on are replaced by ``items`` (each user clicks them all):
    a data shard of such users has no click in most of a sub-epoch
    partition's buckets. ``{"uniform": {...}}`` is :func:`uniform_data`'s
    keywords instead (no test data)."""
    from heat_tpu_torch.data.datasets import ClickDataset
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset

    if "uniform" in data_kw:
        return uniform_data(**data_kw["uniform"])
    kw = dict(data_kw)
    narrow = kw.pop("narrow_users", None)
    train, test = synthetic_click_dataset(**kw)
    if narrow is not None:
        first, items = narrow
        user_items = [u if i < first else np.asarray(items, np.int32)
                      for i, u in enumerate(train.user_items)]
        train = ClickDataset.from_user_items(
            user_items, kw["max_his"], num_items=train.num_items,
            seed=kw.get("seed"))
    return train, test


def generator_digest(engine) -> dict:
    """The digests of the engine's two generators' states (the torch one,
    which draws the shuffles, the tile and the negatives, and the numpy
    one of the sub-epochs' permutations): equal on every rank of a mesh,
    and equal to its single-rank oracle's, when every draw stayed
    aligned."""
    import torch

    state = engine._np_rng.bit_generator.state
    return {"torch": digest(engine.generator.get_state().to(torch.uint8)),
            "numpy": hashlib.sha256(repr(state).encode()).hexdigest()}


class ComplementProbe:
    """Within a ``with`` block, every step under a sub-epoch's negative
    pool is checked: its negatives (the tile remapped through the pool,
    ``pool[tile % size]``) and its real positives lie in disjoint item
    sets, the negatives in the pool's ``size`` real entries and none of
    the positives there. ``steps`` counts the checked steps."""

    def __init__(self):
        import heat_tpu_torch.train.train_step as ts

        self.ts, self.orig, self.steps = ts, ts.train_step, 0

    def step(self, state, sampler_state, generator, batch, *args, **kw):
        out = self.orig(state, sampler_state, generator, batch, *args, **kw)
        pool, size = kw.get("neg_candidates"), kw.get("neg_candidates_size")
        if pool is not None:
            size = pool.shape[0] if size is None else int(size)
            allowed = set(pool[:size].tolist())
            negs = pool[sampler_state.tile.long() % size].tolist()
            real = batch.pos[batch.weight > 0].tolist()
            if not set(negs) <= allowed or allowed & set(real):
                raise AssertionError(
                    f"a complement step's negatives {sorted(set(negs))[:8]} "
                    f"or positives {sorted(set(real))[:8]} cross the partition")
            self.steps += 1
        return out

    def __enter__(self):
        self.ts.train_step = self.step
        return self

    def __exit__(self, *exc):
        self.ts.train_step = self.orig


def mesh_engine(shape, data_kw: dict, cfg_kw: dict, device: str, data=None):
    """This rank's engine on an ``shape`` mesh over its shard of the data
    (``data``: a (train, test) pair, made from ``data_kw`` when None)."""
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.data.datasets import shard_by_user_range
    from heat_tpu_torch.parallel.mesh import make_mesh
    from heat_tpu_torch.train.engine import Engine

    mesh = make_mesh(*shape, device=device)
    d = mesh.data_index
    if data is None and "uniform" in data_kw:  # only the rank's rows drawn
        train, _ = uniform_data(**data_kw["uniform"], shard=(shape[0], d))
        return Engine(CFConfig(**cfg_kw), train, None, device=device,
                      mesh=mesh)
    train, test = make_data(data_kw) if data is None else data
    return Engine(CFConfig(**cfg_kw),
                  shard_by_user_range(train, shape[0], d, rebase=False),
                  shard_by_user_range(test, shape[0], d), device=device,
                  mesh=mesh)


def state_digests(state) -> dict:
    """The SHA-256 of every tensor of a TrainState (a rank's shard): the
    tables, their accum rows and optimizer slots, ``w0``, ``attn_q`` and
    their slots, and ``step``, by field or slot name."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            out.update({k: digest(t) for k, t in value.items()})
        elif value is not None and f.name != "lr":
            out[f.name] = digest(value)
    return out


def replica_report(engine) -> dict:
    """The rank's index and the digests of every tensor of its shard
    (:func:`state_digests`): user rows and their accum rows and slots
    equal across each model group, item rows and theirs across each data
    group, the replicated rest everywhere."""
    mesh = engine.mesh
    return {"index": (mesh.data_index, mesh.model_index),
            **state_digests(engine.state)}


def check_replicas(reports: list) -> None:
    """Raise AssertionError unless the ranks' replicas are bit-equal
    (:func:`replica_report`), every tensor by the axis
    ``parallel.mesh.field_axis`` splits it over."""
    from heat_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, field_axis

    for key in reports[0]:
        if key == "index":
            continue
        axis = field_axis(key)
        groups: dict = {}
        for r in reports:
            group = {DATA_AXIS: r["index"][0], MODEL_AXIS: r["index"][1],
                     None: None}[axis]
            groups.setdefault(group, set()).add(r[key])
        bad = {g: v for g, v in groups.items() if len(v) != 1}
        if bad:
            raise AssertionError(f"{key} replicas differ: {bad}")


class StepLosses:
    """Wraps ``train_step.train_step`` and writes each step's loss into a
    device buffer at a device counter (a captured step's replays write
    too), for ``steps`` steps at most; installed for a ``with`` block."""

    def __init__(self, steps: int, device):
        import torch

        import heat_tpu_torch.train.train_step as ts

        self.ts, self.orig = ts, ts.train_step
        self.count = torch.zeros(1, dtype=torch.int64, device=device)
        self.losses = torch.zeros(steps, dtype=torch.float32, device=device)

    def step(self, *args, **kw):
        out = self.orig(*args, **kw)
        self.losses.index_copy_(0, self.count, out[2].view(1))
        self.count += 1
        return out

    def read(self) -> np.ndarray:
        return self.losses[: int(self.count)].cpu().numpy()

    def __enter__(self):
        self.ts.train_step = self.step
        return self

    def __exit__(self, *exc):
        self.ts.train_step = self.orig


COLLECTIVE_PREFIXES = ("gloo:", "nccl:")


def trace_summary(path) -> dict:
    """What a ``torch.profiler`` chrome trace (``path``) shows of its
    process: the device's busy seconds (the union of its kernel, copy and
    set events) over the span of all its events, the idle share, the
    collectives' calls and seconds (the host-side ``gloo:*`` / ``nccl:*``
    spans, each from the call to the work's completion, the wait for the
    other ranks included; the trace's device-side copies of those spans
    are not counted), and the port's kernels by family
    (``bench_large.KERNEL_FAMILIES``)."""
    import json
    import math

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if "ts" in e and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events))
    coll = [float(e["dur"]) for e in events
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(COLLECTIVE_PREFIXES)]
    from heat_tpu_torch.bench_large import KERNEL_FAMILIES, kernel_family

    port = dict.fromkeys(KERNEL_FAMILIES, 0)
    for e in events:
        fam = kernel_family(str(e.get("name", ""))) if e.get("cat") == "kernel" else None
        if fam is not None:
            port[fam] += 1
    return {"span_s": span / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1.0 - busy / span, "device_events": len(spans),
            "collective_calls": len(coll), "collective_s": sum(coll) / 1e6,
            "port_kernels": port}


def profiled(fn, trace_path: str) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (CPU, and the card's activity
    where there is one), write its chrome trace to ``trace_path`` and
    return the wall seconds with :func:`trace_summary`'s."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return {"wall_s": wall, **trace_summary(trace_path)}


class Lowered:
    """Within a ``with`` block, ``train.scatter.DENSE_ROWS_THRESHOLD``
    (``dense_rows``) and ``models.state.INIT_BLOCK_ROWS``
    (``init_block_rows``) set in this process (None leaves one as it
    is): how a test reaches the sort-dedup update and the blocked draw at
    small sizes. A spawned rank sets them itself (a parent's setting
    does not reach it)."""

    def __init__(self, dense_rows: Optional[int] = None,
                 init_block_rows: Optional[int] = None):
        from heat_tpu_torch.models import state
        from heat_tpu_torch.train import scatter

        self.sets = [(m, k, v) for m, k, v in (
            (scatter, "DENSE_ROWS_THRESHOLD", dense_rows),
            (state, "INIT_BLOCK_ROWS", init_block_rows)) if v is not None]
        self.saved = []

    def __enter__(self):
        self.saved = [(m, k, getattr(m, k)) for m, k, _ in self.sets]
        for m, k, v in self.sets:
            setattr(m, k, v)
        return self

    def __exit__(self, *exc):
        for m, k, v in self.saved:
            setattr(m, k, v)


def held_bytes(engine) -> dict:
    """The bytes a rank's engine holds on its device: the state (tables,
    accum rows, slots, ``w0``), the data (pairs, histories, lengths) and
    the pools buffer."""
    import dataclasses

    def size(t):
        return 0 if t is None else t.numel() * t.element_size()

    state = 0
    for f in dataclasses.fields(engine.state):
        value = getattr(engine.state, f.name)
        state += (sum(map(size, value.values())) if isinstance(value, dict)
                  else size(value))
    return {"state": state,
            "data": sum(map(size, (engine.pairs, engine.his_items,
                                   engine.his_masks))),
            "pools": size(engine._pools)}


def sampled_state(engine, stride: int) -> dict:
    """Every ``stride``-th row of the global user and item tables (rows
    0, stride, 2 stride, ...) and ``w0``, as f32 numpy, without gathering a
    table: on a mesh each rank takes its shard's rows at those global
    indices and the pieces are all-gathered as host objects (collective:
    every rank calls it). For tables too large to move whole."""
    st, sh, mesh = engine.state, engine.shards, engine.mesh
    out = {"w0": st.w0.detach().float().cpu().numpy()}
    for key, axis, lo, total in (
            ("user_emb", "data", 0 if sh is None else sh.user_lo,
             engine.cfg.num_users),
            ("item_emb", "model", 0 if sh is None else sh.item_lo,
             engine.cfg.num_items)):
        table = getattr(st, key)
        rows = table[(-lo) % stride: max(0, total - lo): stride]
        part = rows.detach().float().cpu().numpy()
        if mesh is not None:
            part = np.concatenate(mesh.all_gather_object(part, axis))
        out[key] = part
    return out


def rank_train(rank, shape, data_kw, cfg_kw, epochs, device, *,
               dense_rows: Optional[int] = None,
               init_block_rows: Optional[int] = None, **kw) -> dict:
    """:func:`train_run` with DENSE_ROWS_THRESHOLD and INIT_BLOCK_ROWS set
    in the rank (:class:`Lowered`) for the run."""
    with Lowered(dense_rows, init_block_rows):
        return train_run(rank, shape, data_kw, cfg_kw, epochs, device, **kw)


def train_run(rank, shape, data_kw, cfg_kw, epochs, device, *,
               save_dir: Optional[str] = None, save_after: int = 0,
               restore_dir: Optional[str] = None, evaluate: bool = True,
               export_path: Optional[str] = None, serve_users=None,
               all_states: bool = True, step_losses: int = 0,
               profile_last: Optional[str] = None, topk: int = 0,
               dedup: bool = True, probe_complement: bool = False,
               serve_routes: bool = False, pools: bool = False,
               probe_gacc: bool = False, aggregated_eval: bool = False,
               fused: Optional[str] = None, eval_interval: int = 0,
               sample_rows: int = 0, epoch_fraction: float = 1.0) -> dict:
    """A rank program: restore from ``restore_dir`` (when given), train
    ``epochs`` epochs (saving a checkpoint into ``save_dir`` after the
    first ``save_after``), evaluate, export (rank 0 writes
    ``export_path``) and serve ``serve_users`` top 10 through
    ``Recommender.from_engine``. Returns the losses, the metrics, the
    global state (numpy; rank 0's only unless ``all_states``), the replica
    digests, the restored epoch, the served ids, with ``step_losses`` (a
    bound on the steps) every step's loss, with ``profile_last`` (a file
    path) rank 0's last epoch run under the profiler, its trace written
    there (:func:`profiled`: its device time and collectives, and its
    steps), with ``topk`` the
    sharded top ``topk + 1`` ids of the rank's users after the training,
    the process's kernel launches (``launches``), the generators' digests
    (:func:`generator_digest`), whether the history dedup's maps were in
    use (``dedup_engaged``; ``dedup=False`` turns them off), with
    ``probe_complement`` the steps :class:`ComplementProbe` checked, and
    the steps of each epoch. ``serve_routes`` also serves ``serve_users``
    aggregated and :data:`COLD` cold; ``pools`` returns the pools of the
    initial state (``Engine._pooled_history``) with the rank's users;
    ``probe_gacc`` the largest accum row element found before each
    ``Engine._steps`` call and after the epochs (:class:`GaccProbe`);
    ``aggregated_eval`` the evaluation with ``aggregate_users=True``.
    The epochs run one ``train_one_epoch`` at a time, with an evaluation
    after each epoch e > 0 with e % ``eval_interval`` == 0 (``evals``;
    none when 0); ``fused="epochs"`` runs them as one
    ``Engine.train_epochs`` call, ``fused="run"`` as
    ``Engine.run_epochs_with_eval(epochs, eval_interval)``. On a card it
    also returns the peak of allocated bytes after the engine's
    construction (``peak_init_bytes``) and after the epochs
    (``peak_bytes``), with the engine's :func:`held_bytes`. ``sample_rows``
    returns every such row of the tables (:func:`sampled_state`) in
    place of the global state; ``epoch_fraction`` < 1 runs that share of
    each epoch's steps (:class:`PartEpochs`)."""
    import contextlib
    import time

    import torch

    from heat_tpu_torch.checkpoint import CheckpointManager
    from heat_tpu_torch.export import export_embeddings
    from heat_tpu_torch.main import _launches
    from heat_tpu_torch.models.state import state_to_numpy
    from heat_tpu_torch.serving import Recommender

    card = torch.device(device).type == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    engine = mesh_engine(shape, data_kw, cfg_kw, device)
    out = {"restored": None}
    if card:
        out["peak_init_bytes"] = torch.cuda.max_memory_allocated()
        out["held_init"] = held_bytes(engine)
    if not dedup:
        engine._history_dedup = lambda *a, **k: None
    if pools:
        lo = engine.shards.user_lo
        out["pools"] = engine._pooled_history().float().cpu().numpy()
        out["pool_users"] = np.arange(lo, lo + engine.shards.user_rows)
    if restore_dir is not None:
        out["restored"] = CheckpointManager(restore_dir).restore_latest(engine)
    losses = []
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda *a: None)
    recorder = (StepLosses(step_losses, engine.device) if step_losses
                else contextlib.nullcontext())
    probe = ComplementProbe() if probe_complement else contextlib.nullcontext()
    gacc = GaccProbe(engine) if probe_gacc else contextlib.nullcontext()
    part = (PartEpochs(engine, epoch_fraction) if epoch_fraction < 1
            else contextlib.nullcontext())
    epoch_steps = []
    evals = []
    sync()
    t0 = time.perf_counter()
    with recorder, probe, gacc, part:
        if fused == "epochs":
            losses = engine.train_epochs(epochs)
        elif fused == "run":
            losses, evals = engine.run_epochs_with_eval(epochs, eval_interval)
        for e in range(epochs if fused is None else 0):
            before_epoch = int(engine.state.step)
            if profile_last and rank == 0 and e == epochs - 1:
                before = int(engine.state.step)
                seen = profiled(lambda: losses.append(engine.train_one_epoch()),
                                profile_last)
                out["last_epoch_profile"] = dict(
                    seen, steps=int(engine.state.step) - before)
            else:
                losses.append(engine.train_one_epoch())
            epoch_steps.append(int(engine.state.step) - before_epoch)
            if save_dir is not None and e + 1 == save_after:
                CheckpointManager(save_dir).save(engine)
            if eval_interval and e > 0 and e % eval_interval == 0:
                evals.append({"epoch": e, **engine.evaluate()})
    sync()
    out["train_s"] = time.perf_counter() - t0
    out["evals"] = evals
    if card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["held"] = held_bytes(engine)
    out["steps"] = int(engine.state.step)
    out["epoch_steps"] = epoch_steps
    out["losses"] = losses
    out["generators"] = generator_digest(engine)
    out["dedup_engaged"] = bool(engine._dedup_cache is not None
                                and engine._dedup_cache[2] is not None)
    if probe_complement:
        out["complement_steps"] = probe.steps
    if probe_gacc:
        out["gacc_before_steps"] = gacc.before
        out["gacc_after"] = gacc.largest()
    if step_losses:
        out["step_losses"] = recorder.read()
    if evaluate:
        t0 = time.perf_counter()
        out["metrics"] = engine.evaluate()
        out["eval_s"] = time.perf_counter() - t0
    if aggregated_eval:
        out["metrics_aggregated"] = engine.evaluate(aggregate_users=True)
    if topk:
        from heat_tpu_torch.evaluation.evaluator import sharded_topk

        bits, _, _ = engine._mp_eval_tensors()
        _, ids = sharded_topk(engine.mesh, engine.state.user_emb,
                              engine.state.item_emb, bits, topk + 1)
        out["topk"] = ids.cpu().numpy()
    state = (sampled_state(engine, sample_rows) if sample_rows
             else state_to_numpy(engine.state, engine.shards))
    out["state"] = state if all_states or rank == 0 else None
    out["capture"] = engine._capture
    out["launches"] = _launches()
    out["replicas"] = replica_report(engine)
    if export_path is not None:
        export_embeddings(engine.unpadded_state(), export_path,
                          cfg=engine.cfg, mesh=engine.mesh)
    if serve_users is not None:
        rec = Recommender.from_engine(engine)
        out["served"] = rec.recommend(list(serve_users), 10)
        if serve_routes:
            out["served_aggregated"] = rec.recommend(
                list(serve_users), 10, aggregate_users=True)
            out["served_cold"] = rec.recommend_cold(COLD, 10)
    out["backend"] = engine.mesh.backend
    return out


# Histories served cold (``Recommender.recommend_cold``) by ``serve_routes``.
COLD = [[1, 2, 3], [5], [40, 41, 42, 43, 44, 45]]


def rank_runs(rank, shape, data_kw, runs: dict, device, **kw) -> dict:
    """A rank program: :func:`rank_train` for each run of ``runs``, one
    after the other in one job (the start of a job's processes is most of
    a small run's time): ``{name: (cfg_kw, epochs, keywords)}``, the
    keywords over ``kw`` (``data_kw`` among them: the run's data in place
    of the job's). Returns ``{name: its result}``."""
    return {name: rank_train(
                rank, shape, extra.get("data_kw", data_kw), cfg_kw, epochs,
                device, **dict(kw, **{k: v for k, v in extra.items()
                                      if k != "data_kw"}))
            for name, (cfg_kw, epochs, extra) in runs.items()}


class GaccProbe:
    """Within a ``with`` block, the largest absolute element of the
    engine's accum rows (user and item, this rank's shard) before every
    ``Engine._steps`` call (each sub-epoch's steps), in ``before``: zero
    wherever the rows were zeroed after the sub-epoch before
    (engine.cpp:344-347)."""

    def __init__(self, engine):
        self.engine, self.orig, self.before = engine, engine._steps, []

    def largest(self) -> float:
        st = self.engine.state
        return max(float(t.abs().max()) for t in (st.user_gacc, st.item_gacc))

    def steps(self, *args, **kw):
        self.before.append(self.largest())
        return self.orig(*args, **kw)

    def __enter__(self):
        self.engine._steps = self.steps
        return self

    def __exit__(self, *exc):
        self.engine._steps = self.orig


class PartEpochs:
    """Within a ``with`` block, each ``Engine._steps`` call of ``engine``
    (an epoch's steps, or a sub-epoch's) runs the first ceil(``fraction``
    x its count) steps of its stream: a run cut in depth, each epoch
    still shuffled, refreshed and counted as a whole one is. A mesh and
    its single-rank oracle cut alike step the same global batches."""

    def __init__(self, engine, fraction: float):
        self.engine, self.orig, self.fraction = engine, engine._steps, fraction

    def steps(self, capture, count, *args, **kw):
        return self.orig(capture, max(1, math.ceil(count * self.fraction)),
                         *args, **kw)

    def __enter__(self):
        self.engine._steps = self.steps
        return self

    def __exit__(self, *exc):
        self.engine._steps = self.orig


class PartialMeans:
    """Within a ``with`` block, the single-rank engine pools its history
    means as a mesh of ``n_model`` item shards does: K1 over each shard's
    rows of the item table (other shards' ids outside it), each an f32
    mean over the whole length, the partial means added in shard order, as
    the model group's all-reduce adds them, and the sum rounded once to
    the type asked for. It patches ``models.aggregator.history_mean_gather``,
    which the step's K1 call and the pools' refresh read at call time (a
    captured step captures it)."""

    def __init__(self, n_model: int):
        from heat_tpu_torch.models import aggregator

        self.aggregator, self.n_model = aggregator, n_model
        self.orig = aggregator.history_mean_gather
        self._rebased = {}

    def means(self, table, his_ids, lens, out_dtype=None, *, rows=None,
              out=None, split=0):
        from heat_tpu_torch.parallel.mesh import sharded_item_rows

        rows_m = sharded_item_rows(table.shape[0], self.n_model) // self.n_model
        key = (his_ids.data_ptr(), tuple(his_ids.shape))
        if key not in self._rebased:
            self._rebased = {key: [his_ids - m * rows_m
                                   for m in range(self.n_model)]}
        import torch

        dtype = out_dtype or (table.dtype if out is None else out.dtype)
        total = None
        for m, his in enumerate(self._rebased[key]):
            part = self.orig(table[m * rows_m: (m + 1) * rows_m], his, lens,
                             torch.float32, rows=rows, split=split)
            total = part if total is None else total + part
        total = total.to(dtype)
        return total if out is None else out.copy_(total)

    def __enter__(self):
        self.aggregator.history_mean_gather = self.means
        return self

    def __exit__(self, *exc):
        self.aggregator.history_mean_gather = self.orig


class ShardPools:
    """Within a ``with`` block, the single-rank engine refreshes the
    attention kinds' pools as a mesh of ``n_data`` data shards does: each
    shard's users on their own (``user_pools_impl`` over its rows of the
    histories and of the user table), so in the chunks a data rank takes
    them (POOL_CHUNK_BYTES of rows from the shard's first user), not in
    the chunks of the whole table. On the card a chunk's batched products
    round by the chunk's size. It patches ``train.engine.compute_user_pools``,
    which ``Engine._pooled_history`` reads at call time; ``calls`` holds the
    users of each call it made."""

    def __init__(self, n_data: int):
        from heat_tpu_torch.train import engine

        self.engine, self.n, self.calls = engine, n_data, []
        self.orig = engine.compute_user_pools

    def pools(self, item_emb, his_items, his_masks, user_emb=None,
              attn_q=None, aggregator="mean", out=None, **kw):
        import torch

        if aggregator == "mean":
            return self.orig(item_emb, his_items, his_masks, user_emb=user_emb,
                             attn_q=attn_q, aggregator=aggregator, out=out, **kw)
        if out is None:
            out = torch.empty((his_items.shape[0], item_emb.shape[1]),
                              dtype=item_emb.dtype, device=item_emb.device)
        rows = his_items.shape[0] // self.n  # table_shards' user rows
        for lo in range(0, his_items.shape[0], rows):
            hi = lo + rows
            self.calls.append((lo, hi))
            self.orig(item_emb, his_items[lo:hi], his_masks[lo:hi],
                      user_emb=None if user_emb is None else user_emb[lo:hi],
                      attn_q=attn_q, aggregator=aggregator, out=out[lo:hi], **kw)
        return out

    def __enter__(self):
        self.engine.compute_user_pools = self.pools
        return self

    def __exit__(self, *exc):
        self.engine.compute_user_pools = self.orig


_KEEP_GRAD = []


def _keep_grad():
    """An identity autograd Function, ``apply(x, store, key)``, whose
    backward keeps the gradient it passes in ``store[key]`` (built at the
    first call: the module imports torch lazily)."""
    if not _KEEP_GRAD:
        import torch

        class KeepGrad(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, store, key):
                ctx.store, ctx.key = store, key
                return x.clone()

            @staticmethod
            def backward(ctx, g):
                ctx.store[ctx.key] = g
                return g, None, None

        _KEEP_GRAD.append(KeepGrad)
    return _KEEP_GRAD[0]


_FAN = []


def _fan():
    """An autograd Function, ``apply(x, n, dtype)``: ``n`` copies of ``x``
    whose backward adds their gradients in index order (first + second,
    then + third...), the order in which the sort-dedup update on a mesh
    adds the data ranks' parts, and rounds the sum once to ``dtype`` (None:
    not at all), as a mesh rounds a sum of f32 parts to the compute type
    (built at the first call)."""
    if not _FAN:
        import torch

        class Fan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, n, dtype):
                ctx.dtype = dtype
                return tuple(x.clone() for _ in range(n))

            @staticmethod
            def backward(ctx, *grads):
                total = None
                for g in grads:
                    if g is not None:
                        total = g if total is None else total + g
                if ctx.dtype is not None:
                    total = total.to(ctx.dtype).to(total.dtype)
                return total, None, None

        _FAN.append(Fan)
    return _FAN[0]


class DataChunks:
    """Within a ``with`` block, the single-rank ``engine``'s step sums
    what a mesh's data group sums as the data ranks do. The gradients of
    ``w0``, of the tile rows and of self-attention's ``attn_q`` become the
    sum of ``n_data`` partials, one a data shard's columns of the global
    batch: the step's ``aggregate_history``, ``tile_scores`` and
    ``pool_history`` are patched (read at call time; a captured step
    captures the patch) to run on each shard's rows and concatenate, so
    that autograd adds the shards' gradients. The item table's dense
    accumulator (``scatter._dense_acc``) becomes the sum of each shard's
    own (its positives' rows, its samples' negatives' rows or its part of
    the tile rows' gradient, kept as autograd passes it), as a data rank
    accumulates its own before ``scatter.apply_row_updates_reduced`` sums
    them. Accum mode's stale term of ``w0``'s gradient
    (``train_step.stale_w0_term``) is one f32 product a shard, the parts
    added in index order, as the data group sums the ranks' parts before
    ``train_step_sharded`` adds them to the rounded ``w0`` gradient (one
    product over the global batch is another order, which grows beyond
    the tolerances within two epochs on (4, 1)). The shards' parts of
    ``w0``'s and of the tile rows' gradients
    are f32, added in index order, as the sort-dedup update adds them
    (two partials add alike in either order), and rounded once to the
    compute type after the sum, as a mesh rounds them (``w0``'s: the
    shards' products with ``f32_weight_grad``; the tile rows enter the
    shards' scoring in f32, and their gradient is rounded to the rows'
    type). On the sort-dedup
    path (``scatter._apply_row_updates_sorted`` and its Adagrad / Adam
    form) the item occurrences are put in the order the data group's
    first rank gathers them: each shard's positives and its negatives in
    turn, the tile slots last. Optimizers that divide a gradient by its
    own size (Adagrad, Adam) turn another summation order into a drift
    beyond the single-rank runs' spread."""

    def __init__(self, n_data: int, engine):
        import heat_tpu_torch.train.scatter as sc
        import heat_tpu_torch.train.train_step as ts

        self.ts, self.sc, self.n, self.engine = ts, sc, n_data, engine
        self.orig = (ts.aggregate_history, ts.tile_scores, ts.pool_history,
                     sc._dense_acc, sc._apply_row_updates_sorted,
                     sc._apply_row_updates_opt_sorted, ts.stale_w0_term)
        self.tile_grads = {}  # shard: its part of the tile rows' gradient

    def stale(self, user_gacc, users, means, weight, gamma):
        # Accum mode's stale term of w0's gradient: one f32 product a
        # shard, added in index order, as the data group's sum adds them.
        total = None
        for u, m, w in zip(users.chunk(self.n), means.chunk(self.n),
                           weight.chunk(self.n)):
            part = self.orig[6](user_gacc, u, m, w, gamma)
            total = part if total is None else total + part
        return total

    def aggregate(self, u, means, w0, gamma, **kw):
        import torch

        # Each shard's part of w0's gradient in f32, summed, rounded once.
        w0s = _fan().apply(w0, self.n, means.dtype)
        return torch.cat([self.orig[0](a, m, w, gamma, f32_weight_grad=True)
                          for a, m, w in zip(u.chunk(self.n),
                                             means.chunk(self.n), w0s)])

    def tile(self, u_agg, p, n, similarity="cosine"):
        import torch

        keep = _keep_grad()
        # One f32 gradient, the shards' parts added in index order and
        # rounded once to n's type.
        n32 = _fan().apply(n.float(), self.n, None)
        parts = [self.orig[1](a, q, keep.apply(n32[s], self.tile_grads, s),
                              similarity=similarity)
                 for s, (a, q) in enumerate(zip(u_agg.chunk(self.n),
                                                p.chunk(self.n)))]
        return (torch.cat([s for s, _ in parts]),
                torch.cat([t for _, t in parts]))

    def pool(self, his_embs, mask, u=None, attn_q=None, kind="mean"):
        import torch

        if attn_q is None:  # a per-user query: no sum across the users
            return self.orig[2](his_embs, mask, u=u, attn_q=attn_q, kind=kind)
        # The samples', or the distinct users' (the oracle's dedup maps are
        # laid out shard by shard, Engine._history_dedup), rows.
        return torch.cat([self.orig[2](e, k, attn_q=attn_q, kind=kind) for e, k
                          in zip(his_embs.chunk(self.n), mask.chunk(self.n))])

    def _layout(self, ids):
        """(tiled, K, T, B, rows a shard) of the step's item occurrences:
        B positives, then the T tile slots or the B x K negatives, sample
        by sample."""
        from heat_tpu_torch.config import NEG_SAMPLER_TILE

        st, cfg = self.engine.state, self.engine.cfg
        tiled = cfg.neg_sampler == NEG_SAMPLER_TILE and st.item_gacc is None
        k, t = (0, cfg.tile_size) if tiled else (cfg.num_negs, 0)
        b = (ids.shape[0] - t) // (1 + k)
        return tiled, k, t, b, b // self.n

    def sorted_update(self, table, ids, grads, **kw):
        import torch

        fn = self.orig[5] if "step" in kw else self.orig[4]
        if table is not self.engine.state.item_emb:
            return fn(table, ids, grads, **kw)
        tiled, k, t, b, lb = self._layout(ids)
        if not tiled:
            order = torch.cat([torch.cat([
                torch.arange(s * lb, (s + 1) * lb),
                torch.arange(b + s * lb * k, b + (s + 1) * lb * k)])
                for s in range(self.n)]).to(ids.device)
            ids, grads = ids.index_select(0, order), grads.index_select(0, order)
        return fn(table, ids, grads, **kw)

    def dense_acc(self, table, ids, grads):
        import torch

        if table is not self.engine.state.item_emb:
            return self.orig[3](table, ids, grads)
        tiled, k, t, b, lb = self._layout(ids)
        acc = None
        for s in range(self.n):
            rows = [slice(s * lb, (s + 1) * lb)]
            if tiled:  # the shard's part of the tile's gradient
                own = [grads[rows[0]], self.tile_grads[s].to(grads.dtype)]
                rows.append(slice(b, None))
            else:
                rows.append(slice(b + s * lb * k, b + (s + 1) * lb * k))
                own = [grads[r] for r in rows]
            part = self.orig[3](table, torch.cat([ids[r] for r in rows]),
                                torch.cat(own))
            acc = part if acc is None else acc + part
        return acc

    def __enter__(self):
        ts, sc = self.ts, self.sc
        ts.aggregate_history, ts.tile_scores, ts.pool_history = (
            self.aggregate, self.tile, self.pool)
        sc._dense_acc = self.dense_acc
        sc._apply_row_updates_sorted = self.sorted_update
        sc._apply_row_updates_opt_sorted = self.sorted_update
        ts.stale_w0_term = self.stale
        return self

    def __exit__(self, *exc):
        ts, sc = self.ts, self.sc
        (ts.aggregate_history, ts.tile_scores, ts.pool_history,
         sc._dense_acc, sc._apply_row_updates_sorted,
         sc._apply_row_updates_opt_sorted, ts.stale_w0_term) = self.orig


def capture_collectives(device) -> dict:
    """One ``all_reduce`` and one ``broadcast`` over the job's group
    captured in a CUDA graph (after each ran once eagerly, which makes the
    communicator), the graph replayed twice on new values: returns what
    each replay gave and what it should give (a world of one: the sum of
    one term, the broadcast of its own value)."""
    import torch
    import torch.distributed as dist

    x = torch.arange(4.0, device=device)
    y = torch.zeros(4, device=device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        dist.all_reduce(x)
        dist.broadcast(y, src=0)
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        x.mul_(2.0)
        dist.all_reduce(x)
        y.copy_(x).add_(1.0)
        dist.broadcast(y, src=0)
    got, want = [], []
    for start in (1.0, 5.0):
        x.copy_(torch.arange(4.0, device=device) + start)
        graph.replay()
        torch.cuda.synchronize(device)
        got.append([x.tolist(), y.tolist()])
        w = [2.0 * (k + start) for k in range(4)]
        want.append([w, [v + 1.0 for v in w]])
    return {"got": got, "want": want, "ok": got == want}


def rank_world_of_one(rank, data_kw, cfg_kw, device, step_losses,
                      plain_runs: int = 3, capture_epochs: int = 0,
                      capture_runs: int = 2) -> dict:
    """A rank program for a world of one: an all-reduce over the job's
    group, then one epoch and an evaluation of
    ``Engine(mesh=make_mesh(1, 1))`` (each step a replay over NCCL on a
    card, eager over gloo), then of ``plain_runs`` mesh-less engines
    (replayed on a card); each with its step losses, state, epoch seconds
    and metrics. With ``capture_epochs`` n (on a card) also: the
    collectives captured in a graph (:func:`capture_collectives`); and n
    epochs of the mesh engine by ``train_epochs(n)`` and by
    ``run_epochs_with_eval(n, cfg.eval_interval)`` (replayed), beside
    ``capture_runs`` mesh engines stepping eagerly (``_capture = False``)
    and as many mesh-less replayed ones, n ``train_one_epoch`` calls each:
    their losses, step losses (``step_losses`` bounds an epoch's), item
    tables, evaluations and captures."""
    import time

    import torch

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import state_to_numpy
    from heat_tpu_torch.parallel.mesh import make_mesh
    from heat_tpu_torch.train.engine import Engine

    mesh = make_mesh(1, 1, device=device)
    # The mesh's own groups are of size 1 and call nothing: one all-reduce
    # over the job's group shows the backend working on the rank's device.
    probe = torch.arange(4.0, device=mesh.device)
    torch.distributed.all_reduce(probe)
    if probe.tolist() != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"a world of one's all-reduce gave {probe.tolist()}")
    train, test = make_data(data_kw)

    def one(**kw):
        engine = Engine(CFConfig(**cfg_kw), train, test, device=device, **kw)
        with StepLosses(step_losses, engine.device) as rec:
            if engine.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = engine.train_one_epoch()
            seconds = time.perf_counter() - t0
        return {"losses": [loss], "epoch_s": seconds,
                "step_losses": rec.read(), "metrics": engine.evaluate(),
                "state": state_to_numpy(engine.unpadded_state())}

    out = {"backend": mesh.backend, "mesh": one(mesh=mesh),
           "plain": [one() for _ in range(plain_runs)]}
    if not capture_epochs:
        return out
    n = capture_epochs
    out["probe"] = capture_collectives(mesh.device)

    def epochs(form, **kw):
        engine = Engine(CFConfig(**cfg_kw), train, test, device=device, **kw)
        if form == "eager":
            engine._capture = False
        evals = []
        with StepLosses(n * step_losses, engine.device) as rec:
            if form == "train_epochs":
                losses = engine.train_epochs(n)
            elif form == "run_epochs_with_eval":
                losses, evals = engine.run_epochs_with_eval(
                    n, engine.cfg.eval_interval)
            else:
                losses = [engine.train_one_epoch() for _ in range(n)]
        fn = engine._epoch_fns.get(True)
        return {"losses": losses, "evals": evals, "step_losses": rec.read(),
                "capture": engine._capture,
                "captures": 0 if fn is None else fn.captures,
                "item_emb": engine.unpadded_state().item_emb.float().cpu().numpy()}

    out["captured"] = {form: epochs(form, mesh=mesh) for form in (
        "train_epochs", "run_epochs_with_eval")}
    out["eager_mesh"] = [epochs("eager", mesh=mesh) for _ in range(capture_runs)]
    out["replayed_plain"] = [epochs("plain") for _ in range(capture_runs)]
    return out


def train_oracle(n_data, data_kw, cfg_kw, epochs, device, *,
                 restore_dir: Optional[str] = None, evaluate: bool = True,
                 data=None, step_losses: int = 0, n_model: int = 1,
                 pools: bool = False, aggregated_eval: bool = False,
                 dedup: bool = True, dense_rows: Optional[int] = None,
                 init_block_rows: Optional[int] = None,
                 sample_rows: int = 0, epoch_fraction: float = 1.0) -> dict:
    """The single-rank counterpart of :func:`rank_train`: one engine over
    all the data that steps the global batches of an ``n_data``-row mesh
    with its draws (``Engine._shard_stream``; on a card each step a replay of
    the captured step). Returns its losses, metrics, state, restored
    epoch and, with ``step_losses``, every step's loss. ``n_model`` > 1
    pools the history means in the mesh's partial sums
    (:class:`PartialMeans`); ``n_data`` > 1 takes the gradients the data
    group sums as the sum of the data shards' partials
    (:class:`DataChunks`) and refreshes the attention kinds' pools a data
    shard at a time (:class:`ShardPools`). ``pools``, ``aggregated_eval``, ``dedup``,
    ``dense_rows``, ``init_block_rows``, ``sample_rows`` and
    ``epoch_fraction`` as :func:`rank_train` takes them."""
    with Lowered(dense_rows, init_block_rows):
        return _oracle_run(n_data, data_kw, cfg_kw, epochs, device,
                           restore_dir, evaluate, data, step_losses, n_model,
                           pools, aggregated_eval, dedup, sample_rows,
                           epoch_fraction)


def _oracle_run(n_data, data_kw, cfg_kw, epochs, device, restore_dir,
                evaluate, data, step_losses, n_model, pools, aggregated_eval,
                dedup, sample_rows, epoch_fraction) -> dict:
    import contextlib

    from heat_tpu_torch.checkpoint import CheckpointManager
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import state_to_numpy
    from heat_tpu_torch.train.engine import Engine

    train, test = make_data(data_kw) if data is None else data
    engine = Engine(CFConfig(**cfg_kw), train, test, device=device)
    engine._shard_stream(n_data)
    if not dedup:
        engine._history_dedup = lambda *a, **k: None
    out = {"restored": None, "w0_start": engine.state.w0.cpu().numpy().copy()}
    if pools:
        out["pools"] = engine._pooled_history().float().cpu().numpy()
    if restore_dir is not None:
        out["restored"] = CheckpointManager(restore_dir).restore_latest(engine)
    recorder = (StepLosses(step_losses, engine.device) if step_losses
                else contextlib.nullcontext())
    means = PartialMeans(n_model) if n_model > 1 else contextlib.nullcontext()
    chunks, shard_pools = ((DataChunks(n_data, engine), ShardPools(n_data))
                           if n_data > 1 else (contextlib.nullcontext(),) * 2)
    part = (PartEpochs(engine, epoch_fraction) if epoch_fraction < 1
            else contextlib.nullcontext())
    with recorder, means, chunks, shard_pools, part:
        out["losses"] = [engine.train_one_epoch() for _ in range(epochs)]
    if step_losses:
        out["step_losses"] = recorder.read()
    if evaluate:
        out["metrics"] = engine.evaluate()
    if aggregated_eval:
        out["metrics_aggregated"] = engine.evaluate(aggregate_users=True)
    out["state"] = (sampled_state(engine, sample_rows) if sample_rows
                    else state_to_numpy(engine.state))
    out["generators"] = generator_digest(engine)
    return out


def rank_pools(rank, shape, data_kw, cfg_kw, device) -> dict:
    """A rank program: the pools' refresh (``Engine._pooled_history``) of
    the initial tables of ``Engine(mesh=)``, and beside it the model
    group's partial pools in the table's type added in that type (each
    partial rounded before the sum, as a bf16 all-reduce adds them).
    Returns the rank's users (global ids) and both, as f32 numpy."""
    from heat_tpu_torch.models.aggregator import user_pools_impl

    engine = mesh_engine(shape, data_kw, cfg_kw, device)
    pools = engine._pooled_history()
    parts = engine.mesh.all_gather(user_pools_impl(
        engine.state.item_emb, engine.his_items, engine.his_masks), "model")
    double = parts[0]
    for part in parts[1:]:
        double = double + part
    lo = engine.shards.user_lo
    return {"users": np.arange(lo, lo + engine.shards.user_rows),
            "pools": pools.float().cpu().numpy(),
            "double_rounded": double.float().cpu().numpy()}


def rank_calls(rank, calls: list) -> list:
    """A rank program: each ``(name, args, keywords)`` of ``calls`` in
    turn, ``name`` a rank program of this module, in one job (one start
    of the ranks for them all); returns their results."""
    return [globals()[name](rank, *args, **kw) for name, args, kw in calls]


def rank_cli(rank, argv) -> dict:
    """A rank program: the CLI (``heat_tpu_torch.main``) on this rank of
    the job; returns its record."""
    from heat_tpu_torch import main

    return main.main(list(argv))


def rank_clis(rank, argvs) -> list:
    """A rank program: the CLI once for each argv of ``argvs``, one after
    the other in one job; returns each run's record and the lines it
    printed (rank 0 prints, the other ranks print nothing)."""
    import contextlib
    import io

    from heat_tpu_torch import main

    out = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            record = main.main(list(argv))
        out.append({"record": record, "printed": buf.getvalue().splitlines()})
    return out


def rank_topk(rank, shape, user_emb, item_emb, train_pairs, truth_items, k,
              metrics, device) -> dict:
    """A rank program: ``sharded_topk`` of the rank's users against its
    item shard (the item table padded as the mesh pads it, the train
    mask packed as the engine packs it) and ``device_metric_sums`` over
    the mesh. Returns the rank's index, its users' (scores, ids) and the
    summed metric sums."""
    import torch

    from heat_tpu_torch.evaluation.evaluator import pack_train_bits, sharded_topk
    from heat_tpu_torch.evaluation.metrics import device_metric_sums, pad_truth
    from heat_tpu_torch.parallel.mesh import make_mesh, table_shards

    mesh = make_mesh(*shape, device=device)
    sh = table_shards(mesh, user_emb.shape[0], item_emb.shape[0])
    dev = mesh.device
    users = torch.as_tensor(user_emb[sh.user_lo: sh.user_lo + sh.user_rows],
                            device=dev)
    items = np.zeros((sh.item_rows, item_emb.shape[1]), np.float32)
    rows = item_emb[sh.item_lo: sh.item_lo + sh.item_rows]
    items[: rows.shape[0]] = rows
    pairs = np.asarray(train_pairs) - np.asarray([sh.user_lo, sh.item_lo])
    pairs = pairs[(pairs[:, 0] >= 0) & (pairs[:, 0] < sh.user_rows)
                  & (pairs[:, 1] >= 0) & (pairs[:, 1] < sh.item_rows)]
    real = min(max(item_emb.shape[0] - sh.item_lo, 0), sh.item_rows)
    bits = pack_train_bits(pairs, sh.user_rows, real, pad_items=sh.item_rows)
    scores, ids = sharded_topk(
        mesh, users, torch.as_tensor(items, device=dev),
        torch.as_tensor(bits.view(np.int32), device=dev), k, user_chunk=16)
    truth, truth_len = pad_truth(
        truth_items[sh.user_lo: sh.user_lo + sh.user_rows])
    sums = device_metric_sums(metrics, ids, torch.as_tensor(truth, device=dev),
                              torch.as_tensor(truth_len, device=dev), mesh=mesh)
    return {"index": (mesh.data_index, mesh.model_index),
            "scores": scores.cpu().numpy(), "ids": ids.cpu().numpy(),
            "sums": sums}


def rank_steps_injected(rank, shape, arrays: dict, cfg_kw: dict, steps: int,
                        device: str, pools: bool = False,
                        dense_rows: Optional[int] = None, perm=None,
                        every_step: bool = False) -> dict:
    """A rank program: ``steps`` sharded steps from an injected global state
    (``arrays``: user_emb, item_emb, w0, his, masks, users, pos, weight of
    the global batch, whose rows ``[d * b, (d + 1) * b)`` hold data index
    d's users, and the (steps * B, K) uniform ``draws``, or the tile
    sampler's ``tiles`` (n, T) and ``idx`` (steps * B, K)), each rank's
    negatives pinned at the sampler's count: its rows of the draws, or the
    tile ``tiles[it % n]`` and its rows of ``idx[it: it + B]``, as
    ``tests/test_torch_fastpath.py`` ``pinned_tiles`` pins one rank. The
    tables take the config's ``param_dtype``; with ``pools`` each step
    reads the pools the engine's refresh computes before it
    (``Engine._pooled_history``'s arithmetic). ``arrays`` may also hold
    the state's ``user_gacc`` / ``item_gacc``, ``opt_slots`` (a dict) and
    ``attn_q``. ``dense_rows``: DENSE_ROWS_THRESHOLD in the rank; ``perm``:
    the order in which a step's rows of the uniform draws go to the
    global batch's samples (for a batch permuted alike). Returns the
    global state after the steps (numpy; with ``every_step`` also after
    each step, ``states``), the losses, the counters and the replica
    digests."""
    with Lowered(dense_rows):
        return _steps_injected(shape, arrays, cfg_kw, steps, device, pools,
                               perm, every_step)


def _steps_injected(shape, arrays, cfg_kw, steps, device, pools, perm,
                    every_step) -> dict:
    import torch

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import (
        state_from_numpy,
        state_to_numpy,
        torch_dtype,
    )
    from heat_tpu_torch.models.aggregator import user_pools_impl
    from heat_tpu_torch.parallel.mesh import make_mesh, table_shards
    from heat_tpu_torch.train import train_step as ts
    from heat_tpu_torch.train.samplers import NegSample, init_sampler_state

    mesh = make_mesh(*shape, device=device)
    cfg = CFConfig(**cfg_kw)
    a = arrays
    sh = table_shards(mesh, a["user_emb"].shape[0], a["item_emb"].shape[0])
    dev = mesh.device
    state = state_from_numpy(
        a["user_emb"], a["item_emb"], a["w0"], lr=cfg.l_r, step=0,
        device=dev, shards=sh, param_dtype=torch_dtype(cfg.param_dtype),
        user_gacc=a.get("user_gacc"), item_gacc=a.get("item_gacc"),
        opt_slots=a.get("opt_slots"), attn_q=a.get("attn_q"))
    cfg.num_items = a["item_emb"].shape[0]
    sampler = init_sampler_state(cfg, dev, torch.Generator(device=dev))
    tiled = "tiles" in a
    table = {k: torch.as_tensor(a[k], device=dev)
             for k in (("tiles", "idx") if tiled else ("draws",))}

    order = None if perm is None else torch.as_tensor(perm, device=dev)

    def pinned(generator, sstate, pos_ids, cfg, batch, rows, real):
        it = int(sstate.iterations)
        sstate.iterations.add_(real.to(torch.int32))
        if not tiled:
            if order is None:
                return NegSample(table["draws"][it + rows[0]: it + rows[1]]), sstate
            window = table["draws"][it: it + order.shape[0]].index_select(0, order)
            return NegSample(window[rows[0]: rows[1]]), sstate
        tile = table["tiles"][it % table["tiles"].shape[0]]
        sstate.tile.copy_(tile)
        idx = table["idx"][it + rows[0]: it + rows[1]]
        return NegSample(tile[idx.long()], sstate.tile, idx), sstate

    b = a["users"].shape[0] // shape[0]
    lo = mesh.data_index * b
    batch = ts.Batch(*(torch.as_tensor(a[n][lo: lo + b], device=dev)
                       for n in ("users", "pos", "weight")))
    his = a["his"][sh.user_lo: sh.user_lo + sh.user_rows] - sh.item_lo
    his = torch.as_tensor(his.astype(np.int32), device=dev)
    masks = torch.as_tensor(a["masks"][sh.user_lo: sh.user_lo + sh.user_rows],
                            device=dev)
    orig, ts.sample_negatives_rows = ts.sample_negatives_rows, pinned
    losses, states = [], []
    try:
        for _ in range(steps):
            means = None
            if pools:
                # Engine._pooled_history: f32 partial pools summed over the
                # model group, rounded once to the table's type.
                means = user_pools_impl(state.item_emb, his, masks, out=torch.empty(
                    (sh.user_rows, state.item_emb.shape[1]), device=dev))
                means = mesh.all_reduce(means, "model").to(state.item_emb.dtype)
            state, sampler, loss = ts.train_step(
                state, sampler, torch.Generator(device=dev), batch, his, masks,
                cfg, user_means=means, shards=sh)
            losses.append(float(loss))
            if every_step:
                states.append({k: v.copy() if isinstance(v, np.ndarray) else v
                               for k, v in state_to_numpy(state, sh).items()})
    finally:
        ts.sample_negatives_rows = orig
    return {"state": state_to_numpy(state, sh), "losses": losses,
            "states": states,
            "iterations": int(sampler.iterations),
            "replicas": {"index": (mesh.data_index, mesh.model_index),
                         **state_digests(state)}}
