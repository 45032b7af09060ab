"""The ("data", "model") mesh of ranks and the training state's layout on it.

Counterpart of ``heat_tpu/parallel/mesh.py``. The JAX package annotates
its arrays with a GSPMD layout and lets XLA insert the collectives; here
the layout is written out and the collectives are called by hand. A mesh
is ``n_data x n_model`` ranks, one process a device, rank
``r = d * n_model + m``:

* user rows (and the accum rows and optimizer slots of users) are split
  over "data": data index ``d`` holds the contiguous user range of
  ``shard_by_user_range(num_users, n_data, d)``, as the reference's MPI
  user shards; the ranks that share ``d`` (its "model group") hold
  replicas of it;
* item rows (and their accum rows and slots) are split over "model":
  model index ``m`` holds rows ``[m * I_m, (m + 1) * I_m)`` of the item
  table padded with zero rows to ``I_m * n_model``, a multiple of
  ``128 * n_model`` (``sharded_item_rows``: every shard's slice of the
  packed train mask is then whole words, and the evaluator's windows line
  up); the ranks that share ``m`` (its "data group") hold replicas of it;
* ``w0``, ``attn_q``, their slots, ``lr`` and ``step`` are replicated, as
  are the sampler's state (``iterations`` and the tile: every rank draws
  them from its generator, which is in step on every rank) and a
  sub-epoch's negative pool;
* the pools of ``his_refresh: subepoch`` are laid out as the user rows:
  data index ``d`` holds its users' pools (each summed over its model
  group in f32 and rounded once to the table's type).

The pad rows are never drawn (the samplers draw from the logical item
count), never batched, score nowhere (their mask bits are set) and are cut
off by :func:`gather_train_state`.

:class:`Mesh` holds this rank's place, the process groups of its two
groups and the three collectives the training layer uses:
``all_reduce`` (sum), ``all_gather`` and ``broadcast``, each over one axis
and on tensors of the rank's device; over an axis of size 1 each is a
no-op. The gather and the broadcast move bf16 tensors as their bytes; no
sum is taken of a bf16 tensor (the training layer sums f32 buffers). Their time is read from a profile: ``torch.profiler`` records each
as a ``gloo:*`` or ``nccl:*`` span.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# Item rows are padded to a multiple of this many rows a model shard.
ITEM_PAD_GRANULE = 128


class Mesh:
    """This rank's place in an ``n_data x n_model`` mesh of ranks (built by
    :func:`make_mesh`).

    Attributes:
      shape: (n_data, n_model).
      rank: the rank in the job; ``data_index`` = rank // n_model and
        ``model_index`` = rank % n_model.
      device: the rank's device.
      backend: "nccl" or "gloo".
    """

    def __init__(self, shape, rank, device, backend, groups):
        self.shape = tuple(shape)
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.data_index, self.model_index = divmod(rank, self.shape[1])
        self._groups = groups  # axis -> process group (None at size 1)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"index=({self.data_index}, {self.model_index}), "
                f"device={self.device}, backend={self.backend})")

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def axis_size(self, axis: str) -> int:
        return self.shape[0] if axis == DATA_AXIS else self.shape[1]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.data_index if axis == DATA_AXIS else self.model_index

    def _rank_at(self, axis: str, index: int) -> int:
        """The job rank at ``index`` along ``axis`` in this rank's group."""
        if axis == DATA_AXIS:
            return index * self.shape[1] + self.model_index
        return self.data_index * self.shape[1] + index

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` (every rank of the group gets
        the same sum); returns ``t``."""
        group = self._groups[axis]
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """Every rank's ``t`` along ``axis`` (equal shapes), in the order
        of their index along it."""
        group = self._groups[axis]
        if group is None:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.axis_size(axis))]
        dist.all_gather([_bits(o) for o in out], _bits(t), group=group)
        return out

    def all_gather_object(self, obj, axis: str) -> list:
        """Every rank's picklable ``obj`` along ``axis``, in index order
        (host objects of any size, such as a rank's train pairs)."""
        group = self._groups[axis]
        if group is None:
            return [obj]
        out = [None] * self.axis_size(axis)
        dist.all_gather_object(out, obj, group=group)
        return out

    def broadcast(self, t: torch.Tensor, axis: str, index: int = 0) -> torch.Tensor:
        """``t`` of the rank at ``index`` along ``axis``, written in place
        into every rank's ``t`` of the group; returns ``t``."""
        group = self._groups[axis]
        if group is not None:
            src = self._rank_at(axis, index)
            dist.broadcast(_bits(t), src=src, group=group)
        return t

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a one-element all-reduce on
        the rank's device)."""
        if self.size > 1:
            dist.all_reduce(torch.zeros(1, device=self.device))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as the uint8 of its bytes (a view; gloo has no 16-bit
    integer type): what moves a bf16 table through either backend exactly,
    whatever its support of bf16."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def make_mesh(n_data: int = 1, n_model: int = 1, device: str = "cuda") -> Mesh:
    """The ``n_data x n_model`` mesh over the job's ranks, starting
    ``torch.distributed`` first when it is not started
    (``distributed.initialize(device=device)``: a world of one when no
    launcher set one up). Every rank calls it, with the same shape; it
    makes the process groups of every row and column of the mesh."""
    from heat_tpu_torch.parallel import distributed

    distributed.initialize(device=device)
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    groups = {DATA_AXIS: None, MODEL_AXIS: None}
    # new_group is collective: every rank makes every group, in one order.
    if n_model > 1:
        for i in range(n_data):
            g = dist.new_group([i * n_model + j for j in range(n_model)])
            if i == d:
                groups[MODEL_AXIS] = g
    if n_data > 1:
        for j in range(n_model):
            g = dist.new_group([i * n_model + j for i in range(n_data)])
            if j == m:
                groups[DATA_AXIS] = g
    return Mesh((n_data, n_model), rank, distributed.rank_device(),
                distributed.backend(), groups)


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Largest power-of-two model axis up to 4, the rest on data."""
    n_model = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            n_model = cand
            break
    return n_devices // n_model, n_model


def sharded_item_rows(num_items: int, n_model: int) -> int:
    """The item rows of the sharded table: ``num_items`` padded up to a
    multiple of ``128 * n_model`` (the JAX package's
    ``sharded_pad_items``)."""
    gran = ITEM_PAD_GRANULE * n_model
    return -(-num_items // gran) * gran


@dataclasses.dataclass(frozen=True)
class TableShards:
    """The rows of the tables one rank holds (:func:`table_shards`).

    Attributes:
      mesh: the mesh.
      num_users / num_items: the global (logical) table sizes.
      user_lo, user_rows: the rank's users ``[user_lo, user_lo +
        user_rows)``.
      item_lo, item_rows: the rank's item rows ``[item_lo, item_lo +
        item_rows)`` of the padded item table (rows at or above
        ``num_items`` are padding).
    """

    mesh: Mesh
    num_users: int
    num_items: int
    user_lo: int
    user_rows: int
    item_lo: int
    item_rows: int


def table_shards(mesh: Mesh, num_users: int, num_items: int) -> TableShards:
    """The rank's rows of a ``num_users x num_items`` model on ``mesh``.
    The data axis must divide ``num_users`` (a ValueError otherwise, as
    the JAX engine refuses a multi-host run)."""
    n_data, n_model = mesh.shape
    if num_users % n_data:
        raise ValueError(
            "multi-host runs require num_users divisible by the data axis "
            f"({n_data}); got {num_users}")
    u_rows = num_users // n_data
    i_rows = sharded_item_rows(num_items, n_model) // n_model
    return TableShards(mesh, num_users, num_items,
                       mesh.data_index * u_rows, u_rows,
                       mesh.model_index * i_rows, i_rows)


def field_axis(name: str) -> Optional[str]:
    """The mesh axis a TrainState field (or optimizer slot) is split over:
    user rows over "data", item rows over "model", the rest replicated
    (None): the counterpart of the JAX package's
    ``train_state_shardings``."""
    if name.startswith("user"):
        return DATA_AXIS
    if name.startswith("item"):
        return MODEL_AXIS
    return None


def _rows(t: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """Rows [lo, lo + rows) of ``t``, zero where they pass its end."""
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    hi = min(lo + rows, t.shape[0])
    if hi > lo:
        out[: hi - lo].copy_(t[lo:hi])
    return out


def _map_state(state, fn):
    """A TrainState of ``fn(name, tensor)`` for every present tensor."""
    kw = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            kw[f.name] = {k: fn(k, v) for k, v in value.items()}
        else:
            kw[f.name] = None if value is None else fn(f.name, value)
    return type(state)(**kw)


def shard_train_state(state, shards: TableShards):
    """The rank's shard of a global TrainState: its user rows, its rows of
    the zero-padded item table, and copies of the replicated fields, on
    the tensors' device."""

    def one(name, t):
        axis = field_axis(name)
        if axis == DATA_AXIS:
            return _rows(t, shards.user_lo, shards.user_rows)
        if axis == MODEL_AXIS:
            return _rows(t, shards.item_lo, shards.item_rows)
        return t.clone()

    return _map_state(state, one)


def gather_train_state(state, shards: TableShards):
    """The global TrainState from every rank's shard (collective: every
    rank calls it and gets the whole state), the item padding cut off."""
    mesh = shards.mesh

    def one(name, t):
        axis = field_axis(name)
        if axis is None:
            return t.clone()
        whole = torch.cat(mesh.all_gather(t, axis))
        return whole[: shards.num_items] if axis == MODEL_AXIS else whole

    return _map_state(state, one)
