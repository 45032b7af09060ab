"""Checkpoint / resume.

The counterpart of ``heat_tpu/checkpoint.py`` ``CheckpointManager``, where
Orbax becomes one ``torch.save`` file an epoch in the directory
(``ckpt_<epoch>.pt``, written under a temporary name and moved into place
with ``os.replace``, so a reader never sees half a file). A file holds:

* every tensor of the ``TrainState``: the tables, ``w0``, ``attn_q``, the
  accum mode's gradient rows, the optimizer slots, ``lr`` and ``step``;
* the sampler state (``iterations``, and the tile of the tile sampler);
* the engine's generator state (``Generator.get_state``) and the device
  type it belongs to;
* the state of the engine's numpy generator, which draws the sub-epochs'
  item permutations;
* under ``shuffle_mode: once`` (without sub-epochs), the generator state
  from which the fixed stream was drawn, so that a resumed run draws the
  same stream again;
* the epoch.

A resumed run is the uninterrupted run, draw for draw: the JAX package's
checkpoint keeps neither the sub-epochs' permutation generator nor the
"once" stream, and its resumed runs differ from the uninterrupted ones in
those two configurations (``tests/test_torch_checkpoint.py`` pins both).
What the engine derives (the stream buffers, the sub-epoch geometry and
buffers, the dedup maps, the evaluator) is rebuilt, not saved.

Restoring writes into the engine's own tensors (``copy_``), so they keep
their addresses, and drops the engine's captured CUDA graphs: a graph
captured before the restore is never replayed against the restored
generator. The CLI restores before the first epoch, before any capture.

On a mesh a checkpoint holds the global state, in the same format: the
save gathers every rank's shard (``Engine.unpadded_state``), the mesh's
first rank writes the file, and every rank waits until it is in place;
the restore reads the global arrays on every rank and keeps the rank's
shard (``parallel.mesh.shard_train_state``). The engine's generator is
the same on every rank of a mesh. So a checkpoint moves between meshes,
and between a mesh and one rank, as the JAX package's Orbax checkpoints
do.

A CUDA generator's state does not load into a CPU generator (nor the
reverse): a checkpoint moved to another device type carries the
parameters, the optimizer and the sampler, not the same draws, and
``restore_latest`` raises ``ValueError`` on it rather than go on with other
draws (its tensors can still be read with ``torch.load``). The port does
not read the JAX package's Orbax checkpoints; its weights cross over
through ``models.state.state_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from heat_tpu_torch.models.state import TrainState
from heat_tpu_torch.parallel.mesh import shard_train_state

FORMAT = 1
_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Saves and restores an ``Engine``'s training state, one file an
    epoch, keeping the newest ``max_to_keep`` (every one when None, as
    Orbax keeps them)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch}.pt")

    def all_steps(self) -> list[int]:
        """The epochs held, oldest first."""
        names = map(_NAME.match, os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in names if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, engine) -> None:
        """Save the engine's state keyed by its epoch counter (on a mesh,
        every rank calls it; the first writes)."""
        mesh = engine.mesh
        st = engine.unpadded_state()
        once = engine._once_state if engine._once_cached() else None
        payload = {
            "format": FORMAT,
            "epoch": int(engine.epoch),
            "state": {f.name: getattr(st, f.name)
                      for f in dataclasses.fields(st)},
            "sampler": {"iterations": engine.sampler_state.iterations,
                        "tile": engine.sampler_state.tile},
            "generator": {"device": engine.device.type,
                          "state": engine.generator.get_state()},
            "np_rng": engine._np_rng.bit_generator.state,
            "once": once,
        }
        if mesh is None or mesh.rank == 0:
            path = self._path(engine.epoch)
            tmp = os.path.join(self.directory, f".{os.path.basename(path)}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            if self.max_to_keep is not None:  # None keeps every checkpoint
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
        if mesh is not None:
            mesh.barrier()

    def restore_latest(self, engine) -> Optional[int]:
        """Restore the newest checkpoint into the engine; returns its epoch,
        or None when the directory holds none. A checkpoint of another
        device type's generator raises ``ValueError``."""
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self._path(step), weights_only=True,
                             map_location=engine.device)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{self._path(step)}: unknown format")
        saved_dev = payload["generator"]["device"]
        if saved_dev != engine.device.type:
            raise ValueError(
                f"{self._path(step)} holds a {saved_dev} generator state, "
                f"which a {engine.device.type} generator cannot take: the "
                f"draws would differ")
        saved_state = payload["state"]
        if engine.mesh is not None:
            # The file holds the global state: keep this rank's shard.
            shard = shard_train_state(TrainState(**saved_state), engine.shards)
            saved_state = {f.name: getattr(shard, f.name)
                           for f in dataclasses.fields(shard)}
        # Every field is checked before any is written.
        pairs = (_pairs(engine.state, saved_state, "state")
                 + _pairs(engine.sampler_state, payload["sampler"], "sampler"))
        for mine, theirs in pairs:
            mine.copy_(theirs)
        engine.drop_captures()
        engine._np_rng.bit_generator.state = payload["np_rng"]
        engine.epoch = int(payload["epoch"])
        if payload["once"] is not None:
            # Draw the fixed stream from the state it was drawn from.
            engine.generator.set_state(payload["once"].cpu())
            engine.redraw_once_stream()
        engine.generator.set_state(payload["generator"]["state"].cpu())
        return step

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""


def _pairs(target, saved: dict, what: str) -> list:
    """(the engine's tensor, the saved tensor) for every field of
    ``target``; raises ``ValueError`` where the fields present, their
    shapes or their types differ (another configuration)."""
    out = []
    for name, value in saved.items():
        have = getattr(target, name)
        where = f"checkpoint {what}.{name}"
        if isinstance(value, dict) or isinstance(have, dict):
            if (not isinstance(value, dict) or not isinstance(have, dict)
                    or set(value) != set(have)):
                raise ValueError(f"{where} does not match the engine's: "
                                 f"{value!r} against {have!r}")
            pairs = [(have[k], value[k], f"{where}.{k}") for k in value]
        else:
            pairs = [(have, value, where)]
        for mine, theirs, label in pairs:
            if (mine is None) != (theirs is None):
                raise ValueError(f"{label} is present on one side only: "
                                 f"another configuration")
            if mine is None:
                continue
            if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
                raise ValueError(
                    f"{label} is {tuple(theirs.shape)} {theirs.dtype}, the "
                    f"engine's {tuple(mine.shape)} {mine.dtype}")
            out.append((mine, theirs))
    return out
