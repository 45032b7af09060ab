"""Training engine: the epoch loop and evaluation.

Counterpart of ``heat_tpu/train/engine.py``, on one device or on a mesh
of ranks (``Engine(mesh=)``): ``Engine.__init__`` (with the tile
sampler's "auto" parameters and the stable pre-sort of ``visit_order``
"user" / "item"), batch packing with weight-0 padding
(``_make_batches`` / ``_shuffle_or_pack``, modes "epoch", "once" and
"none"), ``train_one_epoch`` with the LR milestones, sub-epoch
item partitioning (``num_subepochs > 1``), ``evaluate`` and ``evaluate0``;
``train_epochs`` and ``run_epochs_with_eval``, the JAX engine's fused
programs. Where the JAX epoch is one ``lax.scan`` program, here on the
card each step is one replay of a CUDA graph of the step, captured once
(``train_step.make_epoch_fn``), and the epoch is a host loop of replays; on
the CPU, on a gloo mesh, and for the eager oracle (``self._capture =
False``), the steps run one by one. The epoch shuffle, the bucketing, the pool refresh and the
evaluation stay eager between the replays. The epoch's loss sum stays on
the device and is read once per call (per epoch for ``train_one_epoch``,
once for ``train_epochs(n)``).

The captured step reads fixed addresses, so everything it reads is kept in
place: the state (``train_step`` updates every tensor of it in place, and
``lr`` is filled in place each epoch), the batch stream buffers (every
stream is written into them; they only grow), the negative pool of
sub-epochs. Without sub-epochs the pools buffer is dropped before each
epoch's shuffle and taken again after it, which gives its block back
unless the shuffle kept part of it; under sub-epochs it is held. A caller
that assigns a new ``state``, or pools that come back at another address,
get a new capture at the next epoch.

Sub-epochs (the reference's item-column partitioning, engine.cpp:91-131):
each epoch draws a permutation of the items on the host (numpy, the JAX
engine's generator expression, so a seed gives its partitions), cuts it
into ``num_subepochs`` partitions, and trains the clicks of each partition
in turn (a bucket), the learning rate set once an epoch. Under
``subepoch_neg_scope: complement`` a sub-epoch's negatives are drawn from
the items outside its partition (the step remaps its draws through that
pool); "global" draws from all items. Under ``his_refresh: subepoch`` the
pools are refreshed before every sub-epoch; under ``sgd_mode: accum`` the
gradient rows are zeroed after every sub-epoch (engine.cpp:344-347). The
default form buckets on the device (``_bucketed_streams``: the pairs
grouped stably by partition, each bucket shuffled and written into the one
grow-only stream, ceil(n_s / B) steps, no all-padding batch), so one
capture serves every sub-epoch of every epoch; ``self._fuse_subepochs =
False`` buckets on the host with boolean masks and runs each bucket as a
pair set of its own (the JAX engine's per-bucket path): the equivalence
oracle, bit-equal to the default form wherever every non-empty bucket
holds at least ``batch_size`` pairs (both then pack at one width). An empty
bucket runs and draws nothing. The history dedup applies only to an
unpartitioned epoch: buckets are drawn anew every epoch, so maps cached
per stream would never be read twice. On a stream laid out over data
shards (a mesh, or :meth:`Engine._shard_stream`) each shard buckets its own
pairs and every globally non-empty bucket is stepped by every rank
(:meth:`Engine._subepochs_sharded`, the JAX engine's multiprocess form,
the accum rows zeroed after each sub-epoch there too);
``_fuse_subepochs`` has no other form there.

Per epoch, before the first step: under ``his_refresh: subepoch`` the
(U, d) pooled-history table is computed from the live tables into one
buffer of the item table's type (the mean: kernel K1, one launch; the
attention kinds: chunks of history rows read by K2 and pooled with the
live query, ``attn_q`` or the user rows) and every step reads its rows;
under ``his_refresh: step`` with a fixed batch stream (``shuffle_mode``
"none" or "once") whose batches repeat users, ``_history_dedup`` gives
each step the distinct users of its batch, so that the history is pooled
once per distinct user (the mean by K1; the attention kinds read the
distinct users' history rows and pool them inside the loss). The maps are
computed on the host once per stream and cached.

The host-visible phases (``Engine.timer``, ``performance_breakdown``, the
JAX engine's): ``data`` (the shuffle and packing, the dedup maps; under
sub-epochs the partition and the grouping), ``f_b`` (the pool refresh and
the steps; under sub-epochs every sub-epoch's shuffle, pool refresh and
steps, as in the JAX engine's one program an epoch) and ``eval``. On the
card each holds its device work: it ends with a device sync when the next
phase starts, and the last one before a read of the device (the epoch's
loss, the metrics) ends at that read, with no sync of its own; nothing
syncs between the replays inside one. A checkpoint
(``heat_tpu_torch.checkpoint``) restores into the engine's own tensors and
drops its captures (``drop_captures``); under ``shuffle_mode: once`` the
generator's state before the stream's draw is kept (``_once_state``), so
that a restored engine draws the same stream (``redraw_once_stream``).

The one configuration outside the port (``emb_pad``, on the do-not-port
list) raises ``NotImplementedError``; nothing falls back silently.

Memory: the step updates the state in place (``train/scatter.py``), and
the per-epoch visit order is built with int32 index tensors, so at a
16M-user table the epoch holds no table-sized temporary beyond the dense
path's accumulator (which only tables up to DENSE_ROWS_THRESHOLD rows
take).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from heat_tpu_torch.config import (
    CFConfig,
    NEG_SAMPLER_TILE,
    SGD_MODE_ACCUM,
)
from heat_tpu_torch.data.datasets import ClickDataset, user_range_bounds
from heat_tpu_torch.evaluation.evaluator import (
    TiledEvaluator,
    full_sim_matrix,
    pack_train_bits,
    sharded_topk,
    sharded_topk_supported,
)
from heat_tpu_torch.evaluation.metrics import (
    device_metric_sums,
    evaluate_metrics,
    evaluate_metrics_device,
    pad_truth,
    parse_metric,
)
from heat_tpu_torch.models.aggregator import aggregate_history, user_pools_impl
from heat_tpu_torch.models.state import (
    TrainState,
    init_train_state,
    zero_grad_accumulators,
)
from heat_tpu_torch.parallel.mesh import gather_train_state, table_shards
from heat_tpu_torch.train.optimizer import scheduled_lr
from heat_tpu_torch.train.run import reference_schedule
from heat_tpu_torch.train.samplers import derive_tile_params, init_sampler_state
from heat_tpu_torch.train.train_step import make_epoch_fn
from heat_tpu_torch.utils.profiling import PhaseTimer, performance_breakdown


# Chunked whole-table pooling; the implementation lives next to the pooling
# math in models/aggregator.py (the JAX package jits it here).
compute_user_pools = user_pools_impl


def check_slice(cfg: CFConfig) -> None:
    """Raise NotImplementedError for any setting this port does not run
    yet, naming where ROADMAP.md ("Modules still to port") places it."""
    off_slice = [
        (bool(cfg.emb_pad), "emb_pad (TPU lane padding)", "the do-not-port list"),
    ]
    for bad, what, where in off_slice:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to heat_tpu_torch "
                f"(ROADMAP.md, modules still to port, {where})"
            )


def set_f32_matmul_precision() -> None:
    """Keep every f32 product on the card full f32 (no TF32), and check
    that the settings took: ranking and scores depend on it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError("could not turn TF32 off for f32 matmuls")


class Engine:
    """Drives training and evaluation for one model on one device.

    Args:
      cfg: hyperparameters (num_users/num_items/train_size are taken from
        ``train_data``).
      train_data: parsed click data.
      test_data: held-out clicks for ranking metrics (optional).
      seed: seeds the engine's generator (cfg.seed when None), which draws
        the initial state, the epoch shuffles and the negatives.
      device: "cuda" (the default; fails without a card) or "cpu"; on a
        mesh the mesh's device, of this type.
      mesh: a ``parallel.mesh.Mesh`` of ranks (ROADMAP item 15a), or None.
        On a mesh every rank builds its own engine from its own data, as
        the JAX package's processes do: ``train_data`` is the rank's
        ``shard_by_user_range(train, n_data, d, rebase=False)`` (global
        ids), ``test_data`` its ``shard_by_user_range(test, n_data, d)``.

    On a mesh (``parallel.mesh``): every rank draws the mesh-less global
    initial state from the engine's generator and keeps its shard
    (``init_train_state(shards=)``: a table above one draw block is drawn
    block by block, and no rank holds it whole): user rows by data index,
    item rows (padded to ``sharded_item_rows``) by model index, the rest
    replicated. The engine's generator stays in step on every rank: each
    epoch every rank draws the permutation of every data shard's pairs in
    turn and keeps its own, and every step draws the global batch's
    negatives (``train_step.train_step_sharded``). ``cfg.train_size`` is
    the global count. The mesh runs every setting and entry point the
    engine runs without one: config0's path (item 15a), the fast path
    (the tile sampler, cached pools, bf16, ``direct``, the fixed streams
    with their history dedup), sub-epochs (item 15b, points 1 and 2;
    :meth:`_subepochs_sharded`), Adagrad, Adam and accum mode (point 3),
    the attention aggregators (point 4), shards on the sort-dedup update
    (point 5: a shard above ``scatter.DENSE_ROWS_THRESHOLD`` rows, where
    the JAX package counts the global table's rows; ``train/scatter.py``),
    and ``train_epochs`` / ``run_epochs_with_eval`` (point 6), with the
    draws and results of as many ``train_one_epoch`` calls.

    The backend rule (``parallel.distributed.choose_backend``) decides
    the capture: over NCCL (one card a rank) each step is one replay of a
    CUDA graph holding the step's collectives, as without a mesh; over
    gloo (ranks that share a card, or the CPU) the steps run eagerly,
    since gloo's collectives cannot be captured. That is the rule, not a
    fallback: nothing is tried and caught.
    """

    def __init__(
        self,
        cfg: CFConfig,
        train_data: ClickDataset,
        test_data: Optional[ClickDataset] = None,
        seed: Optional[int] = None,
        device="cuda",
        mesh=None,
    ):
        cfg.num_users = train_data.num_users
        cfg.num_items = train_data.num_items
        cfg.train_size = train_data.train_size
        check_slice(cfg)
        self.mesh = mesh
        self.shards = None
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(
                    f"device {device!r} is not the mesh's {mesh.device}")
            device = mesh.device
        if cfg.neg_sampler == NEG_SAMPLER_TILE and cfg.tile_size <= 0:
            # "auto": the paper's Alg. 1 tile tuning (derive_tile_params).
            cfg.tile_size, cfg.refresh_interval = derive_tile_params(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (pass --device cpu to run on the CPU)"
            )
        set_f32_matmul_precision()
        self.cfg = cfg
        self.train_data = train_data
        self.test_data = test_data
        self.epoch = 0

        pairs = np.asarray(train_data.pairs, np.int32)
        # Data shards of the batch stream (_sharded_batches): n_data on a
        # mesh; a mesh-less engine lays it out so only in _shard_stream.
        self._stream_shards = 1 if mesh is None else mesh.shape[0]
        if mesh is not None:
            self.shards = sh = table_shards(mesh, cfg.num_users, cfg.num_items)
            self._check_shard_data(train_data, pairs)
            counts = mesh.all_gather(torch.tensor(
                [pairs.shape[0]], device=self.device), "data")
            self._shard_counts = [int(c) for c in torch.cat(counts).cpu()]
            cfg.train_size = sum(self._shard_counts)

        seed = cfg.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state: TrainState = init_train_state(
            cfg, self.generator, self.device, shards=self.shards
        )
        self.sampler_state = init_sampler_state(
            cfg, self.device, self.generator
        )
        if cfg.visit_order != "file" and pairs.shape[0] > 0:
            # Stable pre-sort of the visit stream, on the host before the
            # one upload: "user" groups the clicks by user on any input
            # order (which is what gives the history dedup its repeats
            # under a fixed stream), "item" groups them by item.
            col = 0 if cfg.visit_order == "user" else 1
            pairs = pairs[np.argsort(pairs[:, col], kind="stable")]
        self._pairs_np = pairs  # the host's copy: sub-epoch bucket sizes
        self.pairs = torch.as_tensor(pairs, device=self.device)
        his = np.asarray(train_data.his_items, np.int32)
        if mesh is not None:
            # Item ids as rows of this rank's item shard: ids of other
            # shards fall outside it, and K1 leaves them out of its sums.
            his = his - np.int32(self.shards.item_lo)
        self.his_items = torch.as_tensor(his, device=self.device)
        self.his_masks = torch.as_tensor(
            np.asarray(train_data.masks, np.int32), device=self.device
        )
        self._evaluator = None  # lazy TiledEvaluator (mask tensors cached)
        self._mp_eval_cache = None  # the mesh's (bits, truth, truth_len)
        self._batch_cache = None  # (pairs, geometry, stream) of "once"
        self._dedup_cache = None  # (pairs, stream shape, maps) of _history_dedup
        # Each step one replay of a captured CUDA graph (on the card; on a
        # mesh over NCCL, its collectives in the graph), or the eager steps
        # (the CPU; a gloo mesh, whose collectives cannot be captured; the
        # oracle the tests compare with).
        self._capture = self.device.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
        self._epoch_fns = {}  # capture: make_epoch_fn(cfg, capture)
        self._stream = None  # (users, pos, weight) grow-only (rows, B) buffers
        self._pools = None  # the (U, d) pools buffer of his_refresh: subepoch
        # Sub-epochs: the item permutations' generator (the JAX engine's
        # expression, so that a seed gives its partitions), the device
        # bucketing (False: the per-bucket host oracle), the grow-only
        # (batch, rows) geometry, the items' click counts, the (perm, order)
        # buffers and the (C_max,) negative pool with its 0-d size.
        self._np_rng = np.random.default_rng(seed ^ 0x5EED)
        self._fuse_subepochs = True
        self._subep_geom = None
        self._item_clicks = None
        self._shard_clicks = None  # {data shard: its items' click counts}
        self._bucket_bufs = None
        self._neg_pool = None
        # The generator's state before the "once" stream was drawn: what a
        # checkpoint keeps to draw the same stream again.
        self._once_state = None
        # Host-visible phase accumulation (the reference's time_map /
        # performance_breakdown, engine.cpp:22-65, at engine granularity):
        # "data" (shuffle, packing, partition), "f_b" (the steps), "eval".
        # On the card each phase holds its device work: it stays open after
        # the host leaves it until the next phase starts (a device sync
        # then) or the host reads the device anyway (the epoch's loss, the
        # metrics: _close_phase), so that the last phase before such a read
        # adds no wait of its own; sync_phases = False leaves the syncs
        # and the reads out (the phases then time only the host's
        # launches), which is how their cost is measured.
        self.timer = PhaseTimer()
        self.sync_phases = True
        self._open_phase = None  # (name, the host's end of it)

    def _check_shard_data(self, train_data: ClickDataset, pairs) -> None:
        """A mesh rank's data must be its user range with global ids
        (``shard_by_user_range(..., rebase=False)``)."""
        sh = self.shards
        rows = np.shape(train_data.his_items)[0]
        inside = ((pairs[:, 0] >= sh.user_lo)
                  & (pairs[:, 0] < sh.user_lo + sh.user_rows)).all()
        if rows != sh.user_rows or not inside:
            raise ValueError(
                "on a mesh train_data must be this rank's "
                "shard_by_user_range(train, n_data, data_index, "
                f"rebase=False): users [{sh.user_lo}, "
                f"{sh.user_lo + sh.user_rows}), got {rows} history rows")

    def _shard_stream(self, n_data: int) -> None:
        """Lay this mesh-less engine's batch stream out as a mesh of
        ``n_data`` data shards lays out its own (:meth:`_sharded_batches`,
        and under sub-epochs :meth:`_subepochs_sharded`): the engine then
        steps that mesh's global batches with its draws, the single-rank
        oracle the mesh's tests compare with. Call it before the first
        epoch."""
        if self.mesh is not None:
            raise ValueError("a mesh lays out its own batch stream")
        bounds = [user_range_bounds(self.cfg.num_users, n_data, s)
                  for s in range(n_data)]
        self._stream_shards = n_data
        self._shard_user_lo = [lo for lo, _ in bounds]
        # Each shard's pairs, in the visit order (a mesh rank's own).
        shard_of = np.searchsorted(np.asarray([hi for _, hi in bounds]),
                                   self._pairs_np[:, 0], side="right")
        self._shard_pairs_np = [self._pairs_np[shard_of == s]
                                for s in range(n_data)]
        self._shard_pairs = [torch.as_tensor(p, device=self.device)
                             for p in self._shard_pairs_np]
        self._shard_counts = [int(p.shape[0]) for p in self._shard_pairs]

    @contextlib.contextmanager
    def _phase(self, name: str) -> Iterator[None]:
        """A phase of :attr:`timer`. On the card it stays open after the
        host leaves it, until :meth:`_close_phase`: the next phase closes
        it first."""
        self._close_phase()
        with self.timer.phase(name):
            yield
        if self.sync_phases and self.device.type == "cuda":
            self._open_phase = (name, time.perf_counter())

    def _close_phase(self, waited: Optional[float] = None) -> None:
        """Give the open phase its device work: the host's time from its end
        of the phase to ``waited``, the host's time just after a read that
        waited for the device's work (the epoch's loss, the metrics), or,
        without one, after a device sync here."""
        if self._open_phase is None:
            return
        name, host_end = self._open_phase
        self._open_phase = None
        if waited is None:
            torch.cuda.synchronize(self.device)
            waited = time.perf_counter()
        self.timer.time_map[name] += waited - host_end

    def performance_breakdown(self) -> str:
        """Percentage tree over host-visible phases (engine.cpp:22-65)."""
        self._close_phase()
        return performance_breakdown(self.timer)

    def drop_captures(self) -> None:
        """Release the captured step graphs and what is derived from the
        draws (the cached "once" stream, the dedup maps): the next epoch
        captures again and draws its stream from the engine's generator as
        it then stands. A checkpoint restore calls it."""
        for fn in self._epoch_fns.values():
            fn._release()
        self._epoch_fns = {}
        self._batch_cache = None
        self._dedup_cache = None

    def _once_cached(self) -> bool:
        """Whether the buffers hold the fixed stream of ``shuffle_mode:
        once`` over the epoch's pairs (never under sub-epochs, whose
        buckets are drawn anew every epoch)."""
        cached = self._batch_cache
        return (cached is not None and cached[0] is self.pairs
                and self.cfg.num_subepochs <= 1)

    def redraw_once_stream(self) -> None:
        """Draw the "once" stream from the generator as it stands and cache
        it (a checkpoint restore sets the generator to the state the
        stream was first drawn from)."""
        self._batch_cache = None
        self._make_batches(self.pairs)

    # ------------------------------------------------------------------
    def unpadded_state(self) -> TrainState:
        """The train state for serving and export. Without a mesh it is the
        engine's state; on a mesh it is the global state gathered from
        every rank's shard, the item padding cut off (collective: every
        rank calls it)."""
        if self.mesh is None:
            return self.state
        return gather_train_state(self.state, self.shards)

    # ------------------------------------------------------------------
    def _stream_buffers(self, num_batches: int, batch: int):
        """The engine's (users, pos, weight) (rows, batch) buffers, with
        rows >= ``num_batches``: every epoch's and sub-epoch's stream is
        written into them, so the captured step reads one address. They
        only grow: they are made again (and the step captured again) only
        for a stream of more batches than they hold, or of another width."""
        buf = self._stream
        if buf is None or buf[0].shape[1] != batch or buf[0].shape[0] < num_batches:
            shape = (num_batches, batch)
            self._stream = buf = (
                torch.empty(shape, dtype=torch.int32, device=self.device),
                torch.empty(shape, dtype=torch.int32, device=self.device),
                torch.empty(shape, dtype=torch.float32, device=self.device),
            )
        return buf

    def _write_stream(self, pairs, idx, num_batches: int, batch: int):
        """Write the stream ``pairs[idx]`` into the first ``num_batches``
        rows of the stream buffers, the tail padded by repeating the stream
        with weight 0, and return those rows. Each column is gathered once
        into its contiguous batch rows (the kernels take contiguous ids);
        the weights are written in place."""
        self._batch_cache = None  # the buffers stop holding a cached stream
        n, total = idx.shape[0], num_batches * batch
        if total > n:
            idx = idx.repeat(-(-total // n))[:total]
        out = self._stream_buffers(num_batches, batch)
        for col, buf in enumerate(out[:2]):
            torch.index_select(pairs[:, col], 0, idx, out=buf.view(-1)[:total])
        weight = out[2].view(-1)
        weight[:n].fill_(1.0)
        weight[n:total].fill_(0.0)
        return tuple(t[:num_batches] for t in out)

    def _shuffle_or_pack(self, pairs, num_batches: int, batch: int):
        """(users, pos, weight), each (num_batches, batch): pairs in a
        shuffled ("epoch"; "once" shuffles once per ``pairs`` object and
        geometry, and reuses that stream while the buffers hold it) or file
        ("none") order, written by :meth:`_write_stream`."""
        mode = self.cfg.shuffle_mode
        cached = self._batch_cache
        if (mode == "once" and cached is not None and cached[0] is pairs
                and cached[1] == (num_batches, batch)):
            return cached[2]
        n = pairs.shape[0]
        self._pools = None  # not held over the shuffle (_pools_buffer)
        if mode == "none":
            idx = torch.arange(n, dtype=torch.int32, device=self.device)
        else:
            if mode == "once":
                self._once_state = self.generator.get_state()
            idx = torch.randperm(
                n, generator=self.generator, device=self.device,
                dtype=torch.int32,
            )
        out = self._write_stream(pairs, idx, num_batches, batch)
        if mode == "once":
            self._batch_cache = (pairs, (num_batches, batch), out)
            self._dedup_cache = None  # maps of a stream drawn before
        return out

    def _make_batches(self, pairs: torch.Tensor):
        if self._stream_shards > 1:
            return self._sharded_batches(pairs)
        n = int(pairs.shape[0])
        batch = min(self.cfg.batch_size, max(1, n))
        num_batches = -(-n // batch)
        return self._shuffle_or_pack(pairs, num_batches, batch)

    def _sharded_batches(self, pairs: torch.Tensor):
        """(users, pos, weight) of a stream laid out over S data shards
        (the mesh's ``n_data``, or :meth:`_shard_stream`'s; the JAX
        engine's ``_local_batches``): each shard shuffles its own pairs and
        gives ``lb`` = ceil(B / S) rows of every batch (no more than the
        largest shard holds), the count of batches is the most any shard
        needs, and shorter shards pad with weight-0 rows
        (:meth:`_write_shards`). On a mesh the stream is the rank's
        (nb, lb) block; without one it is the global (nb, S * lb) stream,
        shard s in columns [s * lb, (s + 1) * lb). "once" keeps its stream
        as :meth:`_shuffle_or_pack` does."""
        cfg, counts = self.cfg, self._shard_counts
        lb = min(-(-cfg.batch_size // self._stream_shards), max(1, max(counts)))
        nb = max(-(-max(1, c) // lb) for c in counts)
        mode = cfg.shuffle_mode
        cached = self._batch_cache
        if (mode == "once" and cached is not None and cached[0] is pairs
                and cached[1] == (nb, lb)):
            return cached[2]
        if mode == "once":
            self._once_state = self.generator.get_state()
        out = self._write_shards(
            {s: (p, None, lo) for s, (p, lo) in self._held_shards(pairs).items()},
            counts, nb, nb, lb)
        if mode == "once":
            self._batch_cache = (pairs, (nb, lb), out)
            self._dedup_cache = None
        return out

    def _held_shards(self, pairs=None) -> dict:
        """{data shard: (its pairs on the device, its first user)} of the
        shards whose stream this engine writes: a mesh rank's own (``pairs``,
        the epoch's), or every shard of :meth:`_shard_stream`."""
        if self.mesh is not None:
            return {self.mesh.data_index: (
                self.pairs if pairs is None else pairs, self.shards.user_lo)}
        return {s: (p, lo) for s, (p, lo) in enumerate(
            zip(self._shard_pairs, self._shard_user_lo))}

    def _write_shards(self, parts: dict, counts, rows: int, nb: int, lb: int):
        """Write ``nb`` batches of a stream laid out over the S data shards
        into the stream buffers (``rows`` >= ``nb`` of them, grow-only) and
        return them. ``counts``: every shard's count of pairs in the
        stream, which every rank knows; ``parts``: {shard: (pairs, sel,
        first user)} of the shards this engine writes, ``sel`` the pair
        indices of the shard's stream in visit order (None: all its pairs).
        Every rank draws the permutation of every shard in turn from the
        engine's generator (``arange`` under "none"), so that the generator
        stays in step on every rank and a rank with all the pairs draws
        what the mesh draws; each shard gives ``lb`` rows of every batch,
        the tail padded by repeating its stream with weight 0, and an empty
        shard pads with its first user and item 0."""
        mode = self.cfg.shuffle_mode
        # The written shards' permutations are kept; the others are drawn
        # (the generator stays in step) and dropped one by one.
        perms = {}
        for s, c in enumerate(counts):
            perm = (torch.arange(c, dtype=torch.int32, device=self.device)
                    if mode == "none" else torch.randperm(
                        c, generator=self.generator, device=self.device,
                        dtype=torch.int32))
            if s in parts:
                perms[s] = perm
        width = lb if self.mesh is not None else lb * len(counts)
        self._batch_cache = None
        out = tuple(t[:nb] for t in self._stream_buffers(rows, width))
        for s, (shard_pairs, sel, user_lo) in parts.items():
            col = slice(0, lb) if self.mesh is not None else slice(s * lb, (s + 1) * lb)
            users, pos, weight = (t[:, col] for t in out)
            idx = perms[s]
            n = int(idx.shape[0])
            if n == 0:
                users.fill_(user_lo)
                pos.fill_(0)
                weight.fill_(0.0)
                continue
            if sel is not None:
                idx = sel.index_select(0, idx.long())
            idx = idx.repeat(-(-nb * lb // n))[: nb * lb].long()
            users.copy_(shard_pairs[idx, 0].view(nb, lb))
            pos.copy_(shard_pairs[idx, 1].view(nb, lb))
            w = torch.zeros(nb * lb, dtype=torch.float32, device=self.device)
            w[:n] = 1.0
            weight.copy_(w.view(nb, lb))
        return out

    def _history_dedup(self, pairs, users) -> Optional[tuple]:
        """Per-batch (uniq_users (nb, Bu), uniq_inverse (nb, B), uniq_first
        (nb, Bu)) int32 maps for the train step's history-gather dedup, or
        None. ``uniq_first`` is each distinct user's first occurrence in
        its batch, from which the user-attention query is read.

        It applies when the pooled history is recomputed per step from the
        live table (``his_refresh: step``, any aggregator) and the batch
        stream is fixed across epochs (``shuffle_mode`` "none" or "once": a
        user-grouped file order is where repeats are massive), and only if
        no batch has more than 0.7 x batch distinct users: on a shuffled
        stream the dedup would only add a (B,) gather. Not under
        ``user_attention`` with ``update_mode: direct`` (the JAX engine's
        gate): the dedup concentrates the query's gradient on the first
        occurrence's row, and direct mode clips each occurrence apart, so
        where the clip binds it would clip otherwise. Bu is the largest
        distinct count rounded up to 8; short batches pad by repeating
        their first user and its first occurrence. Computed on the host
        with ``np.unique`` (one download of the stream) and cached for the
        ``pairs`` object (held, so that its address cannot pass to other
        pairs) and the stream's shape, so a fixed stream pays once. On a
        mesh the maps are of the rank's (nb, lb) block (its users are its
        own: the dedup is exact per rank), and the go/no-go and Bu are
        decided over the data group from every shard's largest distinct
        count and width, so that every rank steps the same path. A stream
        laid out over S data shards without a mesh (the oracle of
        :meth:`_shard_stream`) takes the mesh's maps side by side: each
        shard's columns deduplicated alone into a block of Bu slots, so
        that its steps pool what every rank of the mesh pools."""
        cfg = self.cfg
        if (cfg.his_refresh != "step"
                or cfg.shuffle_mode not in ("none", "once")
                or (cfg.aggregator == "user_attention"
                    and cfg.update_mode == "direct")):
            return None
        cached = self._dedup_cache
        if (cached is not None and cached[0] is pairs
                and cached[1] == tuple(users.shape)):
            return cached[2]
        users_np = users.cpu().numpy()
        blocks = 1 if self.mesh is not None else self._stream_shards
        nb, batch = users_np.shape[0], users_np.shape[1] // blocks
        # maps[b][s]: (distinct users, first occurrences, inverse) of
        # batch b's columns of data shard s.
        maps = [[np.unique(users_np[b, s * batch: (s + 1) * batch],
                           return_index=True, return_inverse=True)
                 for s in range(blocks)] for b in range(nb)]
        max_u = max([1] + [len(uu) for row in maps for uu, _, _ in row])
        if self.mesh is not None:
            # Every rank of the mesh takes the same decision and width from
            # every data shard's (max_u, batch): one that decided alone
            # would step another path (the JAX engine's _history_dedup_mp).
            stats = torch.stack(self.mesh.all_gather(torch.tensor(
                [max_u, batch], dtype=torch.int64, device=self.device),
                "data")).cpu()
            max_u, batch = int(stats[:, 0].max()), int(stats[:, 1].min())
        out = None
        if max_u <= 0.7 * batch:  # worth the extra (B,) means gather
            bu = -(-max_u // 8) * 8
            uu_arr = np.zeros((nb, blocks, bu), np.int32)
            uf_arr = np.zeros((nb, blocks, bu), np.int32)
            inv_arr = np.zeros((nb, blocks, batch), np.int32)
            for b, row in enumerate(maps):
                for s, (uu, uf, inv) in enumerate(row):
                    n = len(uu)
                    uu_arr[b, s, :n], uu_arr[b, s, n:] = uu, uu[0]
                    uf_arr[b, s, :n], uf_arr[b, s, n:] = uf, uf[0]
                    uf_arr[b, s] += s * batch
                    inv_arr[b, s] = inv + s * bu
            out = tuple(
                torch.as_tensor(a.reshape(nb, -1), device=self.device)
                for a in (uu_arr, inv_arr, uf_arr))
        self._dedup_cache = (pairs, tuple(users.shape), out)
        return out

    def _pooled_history(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(U, d) pooled history of every user from the live tables under
        the configured aggregator (the query of the attention kinds: the
        live ``attn_q``, or the live user rows), in the item table's type
        (written into ``out`` when given). On a mesh, the pools of the
        rank's users: the mean's partial means over its item shard (K1
        writing f32), summed over the model group in f32 and rounded once
        to the table's type (on a (., 1) mesh K1 writes the table's type
        itself); the attention kinds pool whole rows, each chunk's history
        rows summed over the model group (``user_pools_impl(reduce=)``)."""
        st, mesh = self.state, self.mesh
        if mesh is not None and self.cfg.aggregator == "mean":
            if mesh.shape[1] == 1:
                return compute_user_pools(st.item_emb, self.his_items,
                                          self.his_masks, out=out)
            # The partial means of the model shards summed in f32 and
            # rounded once: the one rounding of a single rank's K1.
            pools = compute_user_pools(
                st.item_emb, self.his_items, self.his_masks,
                out=torch.empty((self.his_items.shape[0], st.item_emb.shape[1]),
                                dtype=torch.float32, device=self.device))
            mesh.all_reduce(pools, "model")
            if out is None:
                return pools.to(st.item_emb.dtype)
            return out.copy_(pools)
        reduce = None
        if mesh is not None and mesh.shape[1] > 1:
            reduce = functools.partial(mesh.all_reduce, axis="model")
        return compute_user_pools(
            st.item_emb, self.his_items, self.his_masks,
            user_emb=(st.user_emb if self.cfg.aggregator == "user_attention"
                      else None),
            attn_q=st.attn_q, aggregator=self.cfg.aggregator, out=out,
            reduce=reduce,
        )

    def _pools_buffer(self) -> torch.Tensor:
        """The (U, d) buffer the pools are refreshed into. The shuffle
        (``_shuffle_or_pack``) drops it first, so that its temporaries may
        use that memory, and the epoch takes a new one after; the allocator
        gives the same block back when the shuffle freed it whole, and the
        step is captured again only when the address moved."""
        item = self.state.item_emb
        shape = (self.his_items.shape[0], item.shape[1])
        if self._pools is None or self._pools.shape != shape \
                or self._pools.dtype != item.dtype:
            self._pools = torch.empty(shape, dtype=item.dtype, device=self.device)
        return self._pools

    def _epoch_fn(self, capture: bool):
        fn = self._epoch_fns.get(capture)
        if fn is None:
            fn = self._epoch_fns[capture] = make_epoch_fn(
                self.cfg, capture, self.shards)
        return fn

    def _steps(self, capture: bool, count: int, dedup=None,
               neg_pool=(None, None)) -> torch.Tensor:
        """Steps 0 to ``count`` - 1 of the stream in the stream buffers
        (replays of the captured step when ``capture``), after the pool
        refresh under ``his_refresh: subepoch`` (the (U, d) pooled-history
        table from the live item table: one K1 launch into the pools
        buffer, whose rows every step reads). ``neg_pool``: the negative
        pool and its size (:func:`train_step.train_step`). Returns the
        steps' loss sum, a 0-d tensor on the device; nothing waits."""
        users, pos, weight = self._stream
        user_means = None
        if self.cfg.his_refresh == "subepoch":
            user_means = self._pooled_history(out=self._pools_buffer())
        self.state, self.sampler_state, loss_sum = self._epoch_fn(capture)(
            self.state,
            self.sampler_state,
            self.generator,
            users,
            pos,
            weight,
            self.his_items,
            self.his_masks,
            user_means=user_means,
            uniq_users=dedup[0] if dedup else None,
            uniq_inverse=dedup[1] if dedup else None,
            # The first occurrences feed only the attention kinds' dedup.
            uniq_first=(dedup[2] if dedup and self.cfg.aggregator != "mean"
                        else None),
            neg_candidates=neg_pool[0],
            neg_candidates_size=neg_pool[1],
            count=count,
        )
        return loss_sum

    def _run_pairs(self, pairs, capture: bool, neg_candidates=None) -> torch.Tensor:
        """One pair set (the epoch's pairs, or a sub-epoch's bucket): its
        batch stream, then its steps; an empty set runs and draws nothing.
        The history dedup applies only to an unpartitioned epoch."""
        if int(pairs.shape[0]) == 0 and self._stream_shards == 1:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        with self._phase("data"):
            # A sharded stream steps even where this shard is empty: the
            # other shards' batches (and a mesh's collectives) need it.
            users, _, _ = self._make_batches(pairs)
            dedup = None
            if self.cfg.num_subepochs <= 1:
                dedup = self._history_dedup(pairs, users)
        with self._phase("f_b"):
            return self._steps(capture, users.shape[0], dedup,
                               (neg_candidates, None))

    # ------------------------------------------------------------------
    def _partition(self):
        """One epoch's item partition (engine.cpp:91-131), drawn on the
        host from the engine's numpy generator exactly as the JAX engine
        draws it: the item permutation and the S + 1 bounds; sub-epoch s
        owns the items ``perm[bounds[s]:bounds[s + 1]]``."""
        cfg = self.cfg
        perm = self._np_rng.permutation(cfg.num_items)
        bounds = np.linspace(
            0, cfg.num_items, cfg.num_subepochs + 1).astype(np.int64)
        return perm, bounds

    def _subepoch_geometry(self, counts) -> tuple[int, int]:
        """(batch, rows) of the sub-epochs' stream buffers, kept across
        epochs and grow-only, so that the jitter of the bucket sizes from
        epoch to epoch keeps one capture: the batch is
        min(batch_size, largest bucket), the rows one batch and 1/16 more
        than the first epoch's largest bucket needs. They grow (a new
        capture) only when a later bucket needs more."""
        batch = min(self.cfg.batch_size, max(1, max(counts)))
        return self._grown_geometry(
            batch, max([-(-n // batch) for n in counts if n > 0] or [1]))

    def _grown_geometry(self, batch: int, need: int) -> tuple[int, int]:
        """The kept (batch, rows), made again with 1/16 more rows than
        ``need`` when the batch changed or the rows are too few."""
        geom = self._subep_geom
        if geom is None or geom[0] != batch or geom[1] < need:
            self._subep_geom = geom = (batch, need + 1 + need // 16)
        return geom

    def _subepochs_per_bucket(self, capture: bool) -> torch.Tensor:
        """The sub-epochs of one epoch bucketed on the host, one bucket
        after the other through :meth:`_run_pairs` (the JAX engine's
        per-bucket path, kept as the equivalence oracle of the device
        form): boolean masks of the pairs by partition (pair order kept),
        and under ``subepoch_neg_scope: complement`` the permutation
        without the partition as the negative pool."""
        cfg = self.cfg
        with self._phase("data"):
            perm, bounds = self._partition()
            part_of = np.empty(cfg.num_items, np.int64)
            for s in range(cfg.num_subepochs):
                part_of[perm[bounds[s]: bounds[s + 1]]] = s
            pair_part = part_of[self._pairs_np[:, 1]]
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in range(cfg.num_subepochs):
            with self._phase("data"):
                bucket = torch.as_tensor(self._pairs_np[pair_part == s],
                                         device=self.device)
                pool = None
                if cfg.subepoch_neg_scope == "complement":
                    pool = torch.as_tensor(np.concatenate(
                        [perm[: bounds[s]], perm[bounds[s + 1]:]]
                    ).astype(np.int32), device=self.device)
            total = total + self._run_pairs(bucket, capture, pool)
            if cfg.sgd_mode == SGD_MODE_ACCUM:
                zero_grad_accumulators(self.state)
        return total

    def _bucketed_streams(self):
        """The sub-epochs of one epoch bucketed on the device (the JAX
        package's ``make_subepoch_epoch_impl`` steps 1-4): the partition
        and the grouping run at the call, which returns an iterator that
        yields ``(count, neg_pool)`` for each non-empty sub-epoch in order,
        once it has written its batch stream into the stream buffers and,
        under "complement", its pool into the negative pool buffers.

        The permutation is drawn on the host (:meth:`_partition`) and
        uploaded once into a buffer of its own; the bucket sizes are sums
        of the items' click counts over each partition (the counts
        ``np.bincount`` of the pairs' partitions gives). On the device: the
        partition ids scattered through the permutation, and the pair
        indices grouped by ``part_of[pos]``, stably
        (:meth:`_group_by_partition`), so that each bucket is a contiguous
        run of pair indices in the pairs' original order (the host masks'
        order), kept in a buffer of its own. Each bucket then gets the shuffle of
        :meth:`_shuffle_or_pack` (a ``randperm`` of its size from the
        engine's generator; "once" too, never cached: buckets are drawn
        anew every epoch), is written at the width of the grow-only
        geometry, and its complement ``perm`` without the partition goes
        into the (C_max,) pool buffer, the size into its 0-d buffer. An
        empty bucket is skipped and draws nothing. The pools buffer is held
        throughout (dropped and taken again, it can come back at another
        address, and the step would be captured again): the grouping and
        the shuffles run beside it."""
        cfg, dev = self.cfg, self.device
        perm, bounds = self._partition()
        if self._item_clicks is None:
            self._item_clicks = np.bincount(self._pairs_np[:, 1],
                                            minlength=cfg.num_items)
        counts = [int(self._item_clicks[perm[bounds[s]: bounds[s + 1]]].sum())
                  for s in range(cfg.num_subepochs)]
        if not any(counts):
            return iter(())
        batch, rows = self._subepoch_geometry(counts)
        self._stream_buffers(rows, batch)
        n_items, n_pairs = cfg.num_items, int(self.pairs.shape[0])
        if self._bucket_bufs is None:
            self._bucket_bufs = (
                torch.empty(n_items, dtype=torch.int32, device=dev),  # perm
                torch.empty(n_pairs, dtype=torch.int32, device=dev),  # order
            )
            self._neg_pool_buffers(bounds)
        perm_dev, order = self._bucket_bufs
        host = torch.from_numpy(perm.astype(np.int32))
        if dev.type == "cuda":
            host = host.pin_memory()
        perm_dev.copy_(host, non_blocking=True)
        self._group_by_partition(perm_dev, bounds, counts, order)
        return self._write_buckets(perm_dev, order, bounds, counts, batch)

    def _neg_pool_buffers(self, bounds) -> None:
        """Under ``subepoch_neg_scope: complement``, the (C_max,) negative
        pool buffer and its 0-d size, made once: every sub-epoch's
        complement is written into them."""
        if self.cfg.subepoch_neg_scope == "complement" and self._neg_pool is None:
            c_max = self.cfg.num_items - int(np.diff(bounds).min())
            self._neg_pool = (
                torch.empty(c_max, dtype=torch.int32, device=self.device),
                torch.empty((), dtype=torch.int32, device=self.device),
            )

    def _write_complement(self, perm_dev, bounds, s: int):
        """Sub-epoch ``s``'s negative pool: under "complement" the
        permutation without its partition, written into the pool buffers
        (padded with its first id; the size says how much is real), else
        (None, None)."""
        pool = self._neg_pool
        if pool is None:
            return None, None
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        size = self.cfg.num_items - (hi - lo)
        pool[0][:lo].copy_(perm_dev[:lo])
        pool[0][lo:size].copy_(perm_dev[hi:])
        pool[0][size:].copy_(perm_dev[:1].expand(pool[0].shape[0] - size))
        pool[1].fill_(size)
        return pool

    def _write_buckets(self, perm_dev, order, bounds, counts, batch):
        """The generator of :meth:`_bucketed_streams`: each non-empty
        bucket's stream and complement, written when it is asked for."""
        start = 0
        for s, n in enumerate(counts):
            if n:
                count = -(-n // batch)
                self._write_bucket(order[start: start + n], count, batch)
                yield count, self._write_complement(perm_dev, bounds, s)
            start += n

    def _group_by_partition(self, perm_dev, bounds, counts, order) -> None:
        """``order`` := the pair indices grouped by the partition of their
        item, in pair order within each group: a stable sort by partition
        (steps 1-2 of the device bucketing), as one ``nonzero`` of each
        partition's mask, whose temporaries (0.4 GB at 40M pairs) are a
        third of a radix sort's. Each ``nonzero`` waits for the device."""
        sizes = torch.as_tensor(np.diff(bounds), device=self.device)
        part_ids = torch.repeat_interleave(
            torch.arange(len(sizes), dtype=torch.int32, device=self.device),
            sizes)
        part_of = torch.empty_like(part_ids).scatter_(
            0, perm_dev.long(), part_ids)
        pair_part = part_of.index_select(0, self.pairs[:, 1])
        start = 0
        for s, n in enumerate(counts):
            if n:
                order[start: start + n].copy_(
                    torch.nonzero(pair_part == s).view(-1))
            start += n

    def _write_bucket(self, rows, count: int, batch: int) -> None:
        """A bucket's stream (``rows``: its pair indices in pair order)
        into the stream buffers, shuffled as :meth:`_shuffle_or_pack`
        shuffles; the temporaries die here."""
        if self.cfg.shuffle_mode != "none":
            rows = rows.index_select(0, torch.randperm(
                rows.shape[0], generator=self.generator, device=self.device,
                dtype=torch.int32))
        self._write_stream(self.pairs, rows, count, batch)

    def _subepochs_device(self, capture: bool) -> torch.Tensor:
        """The sub-epochs of one epoch, bucketed on the device
        (:meth:`_bucketed_streams`): per non-empty sub-epoch, its pool
        refresh and ceil(n_s / B) steps, no all-padding batch (replays of
        the one captured step over the same buffers, on the card); under
        ``sgd_mode: accum`` the gradient rows zeroed after it."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        # The phases of the JAX engine's one-program epoch: "data" the host's
        # permutation and the grouping, "f_b" the sub-epochs (each bucket's
        # shuffle and pool refresh, and its steps) with no sync between them.
        with self._phase("data"):
            streams = self._bucketed_streams()
        with self._phase("f_b"):
            for count, pool in streams:
                total = total + self._steps(capture, count, neg_pool=pool)
                if self.cfg.sgd_mode == SGD_MODE_ACCUM:
                    zero_grad_accumulators(self.state)
        return total

    def _subepochs_sharded(self, capture: bool) -> torch.Tensor:
        """The sub-epochs of one epoch on a stream laid out over data
        shards: a mesh's ranks, or the single-rank oracle of
        :meth:`_shard_stream` (the JAX engine's multiprocess sub-epochs,
        ``_run_subepochs_fused`` under ``_multiprocess``).

        Every rank draws the same item permutation from ``_np_rng`` (no
        broadcast) and buckets its own pairs on the device (grouped by
        partition, in pair order); the bucket sizes come from its items'
        click counts, and every shard's sizes are all-gathered over the
        data group, so that every rank knows the (S, P) table. The stream
        geometry follows from it on every rank alike: ``lb`` = ceil(B / S)
        rows a shard (no more than the largest shard bucket holds), and
        the rows grow-only as :meth:`_subepoch_geometry` keeps them. Every
        globally non-empty bucket is stepped by every rank, the most steps
        any shard's part needs (so no global batch is all padding); a rank
        whose part is empty pads it with weight-0 rows and draws what a
        rank with pairs draws (:meth:`_write_shards`: every shard's
        shuffle; then the global batch's negatives every step). A bucket
        empty on every shard is skipped and draws nothing. The pools are
        refreshed once a sub-epoch (:meth:`_steps`), and the complement
        pool, a function of the permutation, is the same on every rank."""
        cfg, dev = self.cfg, self.device
        n_parts = cfg.num_subepochs
        total = torch.zeros((), dtype=torch.float32, device=dev)
        with self._phase("data"):
            perm, bounds = self._partition()
            held = self._held_shards()
            if self._shard_clicks is None:
                host = ({self.mesh.data_index: self._pairs_np}
                        if self.mesh is not None
                        else dict(enumerate(self._shard_pairs_np)))
                self._shard_clicks = {
                    s: np.bincount(p[:, 1], minlength=cfg.num_items)
                    for s, p in host.items()}
            local = {s: [int(c[perm[bounds[p]: bounds[p + 1]]].sum())
                         for p in range(n_parts)]
                     for s, c in self._shard_clicks.items()}
            if self.mesh is not None:
                counts = torch.stack(self.mesh.all_gather(torch.tensor(
                    local[self.mesh.data_index], dtype=torch.int64,
                    device=dev), "data")).tolist()
            else:
                counts = [local[s] for s in range(self._stream_shards)]
            lb = min(-(-cfg.batch_size // self._stream_shards),
                     max(1, max(max(row) for row in counts)))
            steps = [max(-(-row[p] // lb) for row in counts)
                     for p in range(n_parts)]
            geom = self._grown_geometry(lb, max(max(steps), 1))
            perm_dev = torch.as_tensor(perm.astype(np.int32), device=dev)
            part_of = torch.empty_like(perm_dev).scatter_(
                0, perm_dev.long(), torch.repeat_interleave(
                    torch.arange(n_parts, dtype=torch.int32, device=dev),
                    torch.as_tensor(np.diff(bounds), device=dev)))
            sel = {}
            for s, (pairs, _) in held.items():
                pair_part = part_of.index_select(0, pairs[:, 1])
                sel[s] = [torch.nonzero(pair_part == p).view(-1)
                          for p in range(n_parts)]
            self._neg_pool_buffers(bounds)
        with self._phase("f_b"):
            for p in range(n_parts):
                if not steps[p]:
                    continue
                self._write_shards(
                    {s: (pairs, sel[s][p], lo) for s, (pairs, lo) in held.items()},
                    [row[p] for row in counts], geom[1], steps[p], lb)
                total = total + self._steps(
                    capture, steps[p],
                    neg_pool=self._write_complement(perm_dev, bounds, p))
                if cfg.sgd_mode == SGD_MODE_ACCUM:
                    zero_grad_accumulators(self.state)
        return total

    def _epoch(self, capture: bool) -> torch.Tensor:
        """One epoch: its learning rate, then its steps (replays of the
        captured step when ``capture``) over the whole stream, or over each
        sub-epoch's under ``num_subepochs > 1``. Returns the epoch's loss
        sum, a 0-d tensor on the device; nothing waits."""
        cfg = self.cfg
        lr = scheduled_lr(cfg.l_r, self.epoch, cfg.milestones, cfg.lr_gamma)
        self.state.lr.fill_(lr)  # in place: kernels read it by its address
        if cfg.num_subepochs > 1 and self._stream_shards > 1:
            loss_sum = self._subepochs_sharded(capture)
        elif cfg.num_subepochs > 1:
            loss_sum = (self._subepochs_device(capture) if self._fuse_subepochs
                        else self._subepochs_per_bucket(capture))
        else:
            loss_sum = self._run_pairs(self.pairs, capture)
            if cfg.sgd_mode == SGD_MODE_ACCUM:
                # The reference zeroes the grad rows at the end of every
                # sub-epoch, the only one included (engine.cpp:345-347).
                zero_grad_accumulators(self.state)
        self.epoch += 1
        return loss_sum

    def train_one_epoch(self) -> float:
        """Run one epoch; returns the mean per-sample loss (on a mesh, of
        the whole mesh's samples)."""
        loss = float(self._epoch(self._capture))
        self._close_phase(time.perf_counter())
        return loss / max(1, self.cfg.train_size)

    def _train_epochs(self, n: int, capture: bool) -> list[float]:
        if n <= 0:
            return []
        sums = torch.stack([self._epoch(capture) for _ in range(n)]).cpu()
        self._close_phase(time.perf_counter())
        return [float(s) / max(1, self.cfg.train_size) for s in sums]

    def train_epochs(self, n: int) -> list[float]:
        """Run ``n`` epochs; returns the mean per-sample loss of each.

        The same draws, learning rates and results as ``n`` sequential
        ``train_one_epoch`` calls (the epochs run one after the other, each
        with its own shuffle and pool refresh), with one read of the ``n``
        loss sums at the end: the port of the JAX engine's
        ``train_epochs`` / ``_train_epochs_fixed``, whose one device program
        here is the replays of the captured step. On a mesh every rank
        calls it (the JAX engine's multiprocess epochs)."""
        return self._train_epochs(n, self._capture)

    def run_epochs_with_eval(
        self,
        epochs: int,
        eval_interval: int,
        metrics: Optional[Sequence[str]] = None,
        user_tile: int = 512,
        fused: bool = True,
    ) -> tuple[list[float], list[dict]]:
        """The reference's full deployment shape (cf/main.py:106-124):
        ``epochs`` epochs with a ranking evaluation after epoch ``e``
        whenever ``e > 0 and e % eval_interval == 0``, the schedule
        anchored at the engine's current epoch (``reference_schedule``), so
        a resumed run evaluates at the same absolute epochs.

        Each segment of the schedule runs through ``train_epochs`` (on the
        card, replays of the captured step) and each evaluation through
        ``evaluate``, eagerly: the JAX engine's own fallback shape (its
        ``make_run_fn`` makes the whole run one program; capturing the
        evaluation waits for a fused seen-mask kernel). ``fused=False`` runs
        the eager step (the oracle) with the same draws.

        Returns (per-epoch mean losses, evals), each eval
        ``{"epoch": e, metric: value, ...}`` in schedule order.
        """
        metrics = list(metrics if metrics is not None else self.cfg.metrics)
        capture = self._capture and fused
        losses: list[float] = []
        evals: list[dict] = []
        for n, do_eval in reference_schedule(epochs, eval_interval, self.epoch):
            losses.extend(self._train_epochs(n, capture))
            if do_eval:
                evals.append({"epoch": self.epoch - 1,
                              **self.evaluate(metrics, user_tile=user_tile)})
        return losses, evals

    # ------------------------------------------------------------------
    def _ensure_evaluator(self, user_tile: int) -> None:
        if self._evaluator is None or self._evaluator.user_tile != user_tile:
            self._evaluator = TiledEvaluator(
                self.train_data.pairs,
                self.cfg.num_users,
                user_tile=user_tile,
                num_items=self.cfg.num_items,
                device=self.device,
            )
            truth, truth_len = pad_truth(self.test_data.user_items)
            self._truth_dev = (
                torch.as_tensor(truth, device=self.device),
                torch.as_tensor(truth_len, device=self.device),
            )

    def evaluate(
        self,
        metrics: Optional[Sequence[str]] = None,
        user_tile: int = 512,
        aggregate_users: bool = False,
        exact: bool = True,
        recall_target: float = 0.99,
    ) -> dict[str, float]:
        """Tiled top-k over all items (train items masked) and the metric
        library, on the engine's device.

        aggregate_users: score with freshly aggregated user embeddings
        (gamma * u + (1 - gamma) * pool(history) @ w0, the pools of
        :meth:`_pooled_history`) instead of the raw user table. With the default False,
        scoring uses the raw table, whose rows were already aggregated
        during training by the write-back.

        exact=False checks ``recall_target`` as the JAX package's
        ``approx_max_k`` does and, as that selects off a TPU, selects
        exactly (``evaluator.masked_topk``).
        """
        if self.test_data is None:
            raise ValueError("no test_data provided")
        metrics = list(metrics if metrics is not None else self.cfg.metrics)
        max_k = max(parse_metric(m)[1] for m in metrics)
        if self.mesh is not None:
            with self._phase("eval"):
                out = self._evaluate_multiprocess(
                    metrics, max_k, user_tile, aggregate_users, exact=exact,
                    recall_target=recall_target)
            self._close_phase(time.perf_counter())
            return out
        user_emb = self.state.user_emb
        if aggregate_users:
            user_emb = aggregate_history(
                user_emb, self._pooled_history(), self.state.w0, self.cfg.gamma
            )
        with self._phase("eval"):
            self._ensure_evaluator(user_tile)
            _, top_ids = self._evaluator.topk(
                user_emb, self.state.item_emb, max_k, exact=exact,
                recall_target=recall_target)
            out = evaluate_metrics_device(metrics, top_ids, *self._truth_dev)
        self._close_phase(time.perf_counter())
        return out

    def _mp_eval_tensors(self):
        """The mesh's evaluation tensors, built once: the packed train mask
        of the rank's users over its item shard (rows of the rank's users,
        the shard's words; the pad items' bits set) and the padded truth
        of its users."""
        if self._mp_eval_cache is not None:
            return self._mp_eval_cache
        sh = self.shards
        pairs = self._pairs_np - np.asarray([sh.user_lo, sh.item_lo], np.int32)
        pairs = pairs[(pairs[:, 1] >= 0) & (pairs[:, 1] < sh.item_rows)]
        real = min(max(self.cfg.num_items - sh.item_lo, 0), sh.item_rows)
        bits = pack_train_bits(pairs, sh.user_rows, real, pad_items=sh.item_rows)
        truth, truth_len = pad_truth(self.test_data.user_items)
        rows = sh.user_rows
        if truth.shape[0] < rows:  # trailing users without test rows
            truth = np.concatenate(
                [truth, np.full((rows - truth.shape[0], truth.shape[1]), -1,
                                np.int32)])
            truth_len = np.concatenate(
                [truth_len, np.zeros(rows - truth_len.shape[0], np.int32)])
        self._mp_eval_cache = tuple(
            torch.as_tensor(a, device=self.device)
            for a in (bits.view(np.int32), truth[:rows], truth_len[:rows]))
        return self._mp_eval_cache

    def _evaluate_multiprocess(
        self,
        metrics: Sequence[str],
        max_k: int,
        user_tile: int,
        aggregate_users: bool = False,
        exact: bool = True,
        recall_target: float = 0.99,
    ) -> dict[str, float]:
        """The mesh's evaluation (the JAX engine's): every rank ranks its
        users against its item shard, the candidates are merged over the
        model group (``evaluator.sharded_topk``) and the metric sums over
        the data group (``metrics.device_metric_sums``); only
        len(metrics) + 1 numbers reach the host. The all-gather fallback
        takes the geometries ``sharded_topk`` cannot cover."""
        cfg = self.cfg
        user_arr = self.state.user_emb
        if aggregate_users:
            user_arr = aggregate_history(
                user_arr, self._pooled_history(), self.state.w0, cfg.gamma)
        if not sharded_topk_supported(self.mesh, cfg.num_items, max_k,
                                      cfg.num_users):
            return self._evaluate_multiprocess_allgather(
                metrics, max_k, user_tile, user_arr)
        bits, truth, truth_len = self._mp_eval_tensors()
        # The live item shard: the table is kept at the padded width (the
        # JAX engine pads it before each evaluation).
        _, top_ids = sharded_topk(
            self.mesh, user_arr, self.state.item_emb, bits, max_k,
            exact=exact, recall_target=recall_target, user_chunk=user_tile)
        sums = device_metric_sums(metrics, top_ids, truth, truth_len,
                                  mesh=self.mesh)
        denom = max(float(sums[-1]), 1.0)
        return {m: float(sums[i]) / denom for i, m in enumerate(metrics)}

    def _evaluate_multiprocess_allgather(
        self, metrics: Sequence[str], max_k: int, user_tile: int, user_arr,
    ) -> dict[str, float]:
        """The fallback for a ``k`` above the items of a shard: the item
        table gathered over the model group, the rank's users ranked
        against all of it, the metric sums summed over the data group."""
        sh = self.shards
        items = torch.cat(self.mesh.all_gather(self.state.item_emb, "model"))
        pairs = self._pairs_np - np.asarray([sh.user_lo, 0], np.int32)
        ev = TiledEvaluator(pairs, sh.user_rows, user_tile=user_tile,
                            num_items=self.cfg.num_items, device=self.device)
        _, top_ids = ev.topk(user_arr, items[: self.cfg.num_items], max_k)
        local = evaluate_metrics(metrics, top_ids.cpu().numpy(),
                                 self.test_data.user_items)
        count = sum(1 for t in self.test_data.user_items if len(t))
        sums = torch.tensor([local[m] * count for m in metrics] + [count],
                            dtype=torch.float64, device=self.device)
        totals = self.mesh.all_reduce(sums, "data").cpu().numpy()
        denom = max(totals[-1], 1.0)
        return {m: float(totals[i] / denom) for i, m in enumerate(metrics)}

    def evaluate0(self) -> np.ndarray:
        """Dense user x item dot-product matrix on the host (small problems
        and parity tests only)."""
        st = self.unpadded_state()
        return full_sim_matrix(st.user_emb, st.item_emb)
