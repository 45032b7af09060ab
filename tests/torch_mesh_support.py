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
    """SHA-256 of a tensor's bytes: how replicas are held bit-equal."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def make_data(data_kw: dict):
    """The planted-cluster (train, test) of ``data_kw``."""
    from heat_tpu_torch.data.synthetic import synthetic_click_dataset

    return synthetic_click_dataset(**data_kw)


def mesh_engine(shape, data_kw: dict, cfg_kw: dict, device: str, data=None):
    """This rank's engine on an ``shape`` mesh over its shard of the data
    (``data``: a (train, test) pair, made from ``data_kw`` when None)."""
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.data.datasets import shard_by_user_range
    from heat_tpu_torch.parallel.mesh import make_mesh
    from heat_tpu_torch.train.engine import Engine

    mesh = make_mesh(*shape, device=device)
    train, test = make_data(data_kw) if data is None else data
    d = mesh.data_index
    return Engine(CFConfig(**cfg_kw),
                  shard_by_user_range(train, shape[0], d, rebase=False),
                  shard_by_user_range(test, shape[0], d), device=device,
                  mesh=mesh)


def replica_report(engine) -> dict:
    """The rank's index and the digests of its shards: user rows equal
    across each model group, item rows across each data group, ``w0``
    everywhere."""
    st, mesh = engine.state, engine.mesh
    return {"index": (mesh.data_index, mesh.model_index),
            "user_emb": digest(st.user_emb), "item_emb": digest(st.item_emb),
            "w0": digest(st.w0)}


def check_replicas(reports: list) -> None:
    """Raise AssertionError unless the ranks' replicas are bit-equal
    (:func:`replica_report`)."""
    for key, axis in (("user_emb", 0), ("item_emb", 1), ("w0", None)):
        groups: dict = {}
        for r in reports:
            groups.setdefault(None if axis is None else r["index"][axis],
                              set()).add(r[key])
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
    set events) over the span of all its events, the idle share, and the
    collectives' calls and seconds (the host-side ``gloo:*`` / ``nccl:*``
    spans, each from the call to the work's completion, the wait for the
    other ranks included; the trace's device-side copies of those spans
    are not counted)."""
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
    return {"span_s": span / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1.0 - busy / span, "device_events": len(spans),
            "collective_calls": len(coll), "collective_s": sum(coll) / 1e6}


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


def rank_train(rank, shape, data_kw, cfg_kw, epochs, device, *,
               save_dir: Optional[str] = None, save_after: int = 0,
               restore_dir: Optional[str] = None, evaluate: bool = True,
               export_path: Optional[str] = None, serve_users=None,
               all_states: bool = True, step_losses: int = 0,
               profile_last: Optional[str] = None, topk: int = 0) -> dict:
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
    and the process's kernel launches (``launches``)."""
    import contextlib
    import time

    import torch

    from heat_tpu_torch.checkpoint import CheckpointManager
    from heat_tpu_torch.export import export_embeddings
    from heat_tpu_torch.main import _launches
    from heat_tpu_torch.models.state import state_to_numpy
    from heat_tpu_torch.serving import Recommender

    engine = mesh_engine(shape, data_kw, cfg_kw, device)
    out = {"restored": None}
    if restore_dir is not None:
        out["restored"] = CheckpointManager(restore_dir).restore_latest(engine)
    losses = []
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda *a: None)
    recorder = (StepLosses(step_losses, engine.device) if step_losses
                else contextlib.nullcontext())
    sync()
    t0 = time.perf_counter()
    with recorder:
        for e in range(epochs):
            if profile_last and rank == 0 and e == epochs - 1:
                before = int(engine.state.step)
                seen = profiled(lambda: losses.append(engine.train_one_epoch()),
                                profile_last)
                out["last_epoch_profile"] = dict(
                    seen, steps=int(engine.state.step) - before)
            else:
                losses.append(engine.train_one_epoch())
            if save_dir is not None and e + 1 == save_after:
                CheckpointManager(save_dir).save(engine)
    sync()
    out["train_s"] = time.perf_counter() - t0
    out["steps"] = int(engine.state.step)
    out["losses"] = losses
    if step_losses:
        out["step_losses"] = recorder.read()
    if evaluate:
        t0 = time.perf_counter()
        out["metrics"] = engine.evaluate()
        out["eval_s"] = time.perf_counter() - t0
    if topk:
        from heat_tpu_torch.evaluation.evaluator import sharded_topk

        bits, _, _ = engine._mp_eval_tensors()
        _, ids = sharded_topk(engine.mesh, engine.state.user_emb,
                              engine.state.item_emb, bits, topk + 1)
        out["topk"] = ids.cpu().numpy()
    state = state_to_numpy(engine.state, engine.shards)
    out["state"] = state if all_states or rank == 0 else None
    out["launches"] = _launches()
    out["replicas"] = replica_report(engine)
    if export_path is not None:
        export_embeddings(engine.unpadded_state(), export_path,
                          cfg=engine.cfg, mesh=engine.mesh)
    if serve_users is not None:
        rec = Recommender.from_engine(engine)
        out["served"] = rec.recommend(list(serve_users), 10)
    out["backend"] = engine.mesh.backend
    return out


class PartialMeans:
    """Within a ``with`` block, the single-rank step pools its history
    means as a mesh of ``n_model`` item shards does: K1 over each shard's
    rows of the item table (other shards' ids outside it), each a mean
    over the whole length, and the partial means added in shard order, as
    the model group's all-reduce adds them. It patches
    ``models.aggregator.history_mean_gather``, which the step's K1 call
    reads at call time (a captured step captures it)."""

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
        total = None
        for m, his in enumerate(self._rebased[key]):
            part = self.orig(table[m * rows_m: (m + 1) * rows_m], his, lens,
                             out_dtype, rows=rows, split=split)
            total = part if total is None else total + part
        return total if out is None else out.copy_(total)

    def __enter__(self):
        self.aggregator.history_mean_gather = self.means
        return self

    def __exit__(self, *exc):
        self.aggregator.history_mean_gather = self.orig


def rank_world_of_one(rank, data_kw, cfg_kw, device, step_losses,
                      plain_runs: int = 3) -> dict:
    """A rank program for a world of one: an all-reduce over the job's
    group, then one epoch and an evaluation of
    ``Engine(mesh=make_mesh(1, 1))`` (eager, through the job's backend:
    NCCL on a card), then of ``plain_runs`` mesh-less engines (replayed on
    a card);
    each with its step losses, state, epoch seconds and metrics."""
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

    return {"backend": mesh.backend, "mesh": one(mesh=mesh),
            "plain": [one() for _ in range(plain_runs)]}


def train_oracle(n_data, data_kw, cfg_kw, epochs, device, *,
                 restore_dir: Optional[str] = None, evaluate: bool = True,
                 data=None, step_losses: int = 0, n_model: int = 1) -> dict:
    """The single-rank counterpart of :func:`rank_train`: one engine over
    all the data that steps the global batches of an ``n_data``-row mesh
    with its draws (``Engine._shard_stream``; on a card each step a replay of
    the captured step). Returns its losses, metrics, state, restored
    epoch and, with ``step_losses``, every step's loss. ``n_model`` > 1
    pools the history means in the mesh's partial sums
    (:class:`PartialMeans`)."""
    import contextlib

    from heat_tpu_torch.checkpoint import CheckpointManager
    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import state_to_numpy
    from heat_tpu_torch.train.engine import Engine

    train, test = make_data(data_kw) if data is None else data
    engine = Engine(CFConfig(**cfg_kw), train, test, device=device)
    engine._shard_stream(n_data)
    out = {"restored": None}
    if restore_dir is not None:
        out["restored"] = CheckpointManager(restore_dir).restore_latest(engine)
    recorder = (StepLosses(step_losses, engine.device) if step_losses
                else contextlib.nullcontext())
    means = PartialMeans(n_model) if n_model > 1 else contextlib.nullcontext()
    with recorder, means:
        out["losses"] = [engine.train_one_epoch() for _ in range(epochs)]
    if step_losses:
        out["step_losses"] = recorder.read()
    if evaluate:
        out["metrics"] = engine.evaluate()
    out["state"] = state_to_numpy(engine.state)
    return out


def rank_cli(rank, argv) -> dict:
    """A rank program: the CLI (``heat_tpu_torch.main``) on this rank of
    the job; returns its record."""
    from heat_tpu_torch import main

    return main.main(list(argv))


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
                        device: str) -> dict:
    """A rank program: ``steps`` sharded steps from an injected global state
    (``arrays``: user_emb, item_emb, w0, his, masks, users, pos, weight of
    the global batch, whose rows ``[d * b, (d + 1) * b)`` hold data index
    d's users, and the (steps * B, K) draws), each rank's negatives pinned
    to its rows of the draws at the sampler's count. Returns the global
    state after the steps (numpy), the losses and the counters."""
    import torch

    from heat_tpu_torch.config import CFConfig
    from heat_tpu_torch.models.state import state_from_numpy, state_to_numpy
    from heat_tpu_torch.parallel.mesh import make_mesh, table_shards
    from heat_tpu_torch.train import train_step as ts
    from heat_tpu_torch.train.samplers import init_sampler_state

    mesh = make_mesh(*shape, device=device)
    cfg = CFConfig(**cfg_kw)
    a = arrays
    sh = table_shards(mesh, a["user_emb"].shape[0], a["item_emb"].shape[0])
    dev = mesh.device
    state = state_from_numpy(a["user_emb"], a["item_emb"], a["w0"],
                             lr=cfg.l_r, step=0, device=dev, shards=sh)
    sampler = init_sampler_state(cfg, dev)
    draws = torch.as_tensor(a["draws"], device=dev)

    def pinned(generator, batch, num_negs, num_items, pos_ids, ignore_pos,
               rows=None):
        it = int(sampler.iterations)
        return draws[it + rows[0]: it + rows[1]]

    b = a["users"].shape[0] // shape[0]
    lo = mesh.data_index * b
    batch = ts.Batch(*(torch.as_tensor(a[n][lo: lo + b], device=dev)
                       for n in ("users", "pos", "weight")))
    his = a["his"][sh.user_lo: sh.user_lo + sh.user_rows] - sh.item_lo
    his = torch.as_tensor(his.astype(np.int32), device=dev)
    masks = torch.as_tensor(a["masks"][sh.user_lo: sh.user_lo + sh.user_rows],
                            device=dev)
    orig, ts.uniform_negatives = ts.uniform_negatives, pinned
    losses = []
    try:
        for _ in range(steps):
            state, sampler, loss = ts.train_step(
                state, sampler, torch.Generator(device=dev), batch, his, masks,
                cfg, shards=sh)
            losses.append(float(loss))
    finally:
        ts.uniform_negatives = orig
    return {"state": state_to_numpy(state, sh), "losses": losses,
            "iterations": int(sampler.iterations)}
