"""Huge-table training benchmark of the port: the sort-dedup update path.

    python -m heat_tpu_torch.bench_large [--update-mode dedup|direct]
        [--tile T] [--refresh N] [--device cuda|cpu]
        [--users N --items N --clicks N ...]

The port's counterpart of the JAX package's ``bench_large.py``, with its
synthetic dataset (:func:`make_dataset`, the same arrays for the same
seed), its geometry defaults (16M users x 6M items, d = 64, 40M
interactions, batch 32,768, 16 negatives, 10 history items per user: the
``BASELINE.json`` config 5 shape cut to one card) and its configuration:
the tile negative sampler (``--tile``, 0 = auto, which derives 128 at
batch 32,768; ``--refresh``), per-epoch cached history pools
(``his_refresh: subepoch``) and bf16 tables and compute. Both tables are
above ``DENSE_ROWS_THRESHOLD`` rows, so in ``dedup`` mode both take the
sort-dedup row update of ``train/scatter.py`` (segment sums through K3,
writes through S1 and K3); ``direct`` mode adds each occurrence's clipped
step with K3.

Memory held at the default geometry: bf16 tables 2.05 GB (users) +
0.77 GB (items), the (U, d) bf16 pools another 2.05 GB during an epoch,
history ids 0.64 GB + lengths 0.06 GB, pairs 0.32 GB, and the epoch's
batch stream 0.48 GB.

One thing of the JAX script is not run and is listed under ``"reduced"``
in the JSON line: the TPU's 128-wide lane padding of the rows
(``emb_pad``, not ported: rows stay (N, 64)). ``--emb-pad`` above ``--dim``
raises ``NotImplementedError``.

Prints one JSON line with the JAX script's keys. The byte model is the JAX
script's: the per-epoch build of the pools (U x H history rows read, U
pool rows written) and, per step, the user, pool and positive row gathers,
the tile's rows, the user rows' write-back + update and the item rows'
update over B + T rows, each counted read + write, and the ids, at 2 bytes
an element. It is one model for both update modes (it counts no sort,
segment buffer or per-mode write). ``hbm_gbps`` divides it by the epoch's host wall time and
``hbm_peak_frac`` that by the H100's 3.35 TB/s: on a host-bound epoch
they say nothing of the device's bandwidth. They and
``peak_device_bytes`` are None unless the run was on a CUDA device.

``--profile STEPS`` adds a ``"profile"`` object, measured in the same
process after the timed epochs (see :func:`profile_steps`): wall time per
step unprofiled, device time per step by kernel under ``torch.profiler``,
the device's idle share, and the peak memory of the shuffle and of the
steps.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.datasets import ClickDataset
from heat_tpu_torch.train import scatter
from heat_tpu_torch.train.engine import Engine

H100_HBM_GBPS = 3350.0  # NVIDIA H100 SXM data sheet, 3.35 TB/s

REDUCED = [
    "(N, 64) rows in place of emb_pad=128 lane padding (TPU only, not ported)",
]


def make_dataset(
    users: int, items: int, clicks: int, max_his: int, seed: int = 0
) -> ClickDataset:
    """The JAX script's dataset: uniform random pairs and full histories
    of uniform random items, drawn from one numpy generator."""
    rng = np.random.default_rng(seed)
    pairs = np.stack(
        [rng.integers(0, users, clicks), rng.integers(0, items, clicks)],
        axis=1,
    ).astype(np.int32)
    return ClickDataset(
        pairs=pairs,
        his_items=rng.integers(0, items, (users, max_his)).astype(np.int32),
        masks=np.full((users,), max_his, np.int32),
        num_users=users,
        num_items=items,
        max_his=max_his,
        user_items=[],
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--users", type=int, default=16_000_000)
    p.add_argument("--items", type=int, default=6_000_000)
    p.add_argument("--clicks", type=int, default=40_000_000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--negs", type=int, default=16)
    p.add_argument("--max-his", type=int, default=10)
    p.add_argument("--batch", type=int, default=32_768)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument(
        "--update-mode", type=str, default="dedup", choices=("dedup", "direct"),
        help="dedup = sort/segment-sum per-row combine (clip(combined)); "
        "direct = one per-occurrence scatter-add per table",
    )
    p.add_argument(
        "--aggregator", type=str, default="mean",
        choices=("mean", "user_attention"),
        help="history pooling; the attention kinds are not ported (item 12)",
    )
    p.add_argument("--tile", type=int, default=0,
                   help="tile sampler size; <= 0 derives (tile, refresh) "
                   "from the batch size (samplers.derive_tile_params)")
    p.add_argument("--refresh", type=int, default=32_768,
                   help="samples between tile refreshes (used with --tile > 0)")
    p.add_argument("--emb-pad", type=int, default=0,
                   help="TPU lane padding of the rows: not ported")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda)")
    p.add_argument("--profile", type=int, default=0, metavar="STEPS",
                   help="after the timed epochs, time STEPS steps, then "
                   "trace STEPS more with torch.profiler (default 0: off)")
    return p


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def profile_steps(engine: Engine, steps: int, top: int = 12) -> dict:
    """Where a step's time goes, in one process: one epoch's batch stream
    and pools are built (their peak memory is the shuffle's), ``steps`` steps run
    unprofiled between two syncs (wall ms per step, and the steps' peak
    memory), then the next ``steps`` steps run under ``torch.profiler``
    (device ms per step: the sum of the device events, one stream, so no
    overlap; the ``top`` largest by name; and how many device events a
    step made, its launches). The idle share is
    1 - device / unprofiled wall. The profiled wall is reported too: the
    profiler's host overhead inflates it. On the CPU the device numbers
    are None. The steps train the model further."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from heat_tpu_torch.train.train_step import Batch, train_step

    dev = engine.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    users, pos, weight = engine._make_batches(engine.pairs)
    user_means = (
        engine._pooled_history()
        if engine.cfg.his_refresh == "subepoch" else None
    )
    sync()
    shuffle_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if 2 * steps > users.shape[0]:
        raise ValueError(f"--profile {steps}: the epoch has {users.shape[0]} "
                         f"steps, at least {2 * steps} are needed")

    def run(first: int) -> float:
        sync()
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            engine.state, engine.sampler_state, _ = train_step(
                engine.state, engine.sampler_state, engine.generator,
                Batch(users[i], pos[i], weight[i]),
                engine.his_items, engine.his_masks, engine.cfg,
                user_means=user_means,
            )
        sync()
        return (time.perf_counter() - t0) * 1e3 / steps

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    wall_ms = run(0)
    step_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        profiled_wall_ms = run(steps)
    device, launches = {}, 0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CPU:
            device[event.key] = device.get(event.key, 0.0) + (
                event.self_device_time_total / 1e3 / steps
            )
            launches += event.count
    device_ms = sum(device.values()) if on_card else None
    largest = sorted(device.items(), key=lambda kv: -kv[1])[:top]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_wall_ms,
        "device_ms_per_step": device_ms,
        "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
        # Kernels, copies and memsets the device ran, per step.
        "device_launches_per_step": launches / steps if on_card else None,
        "device_ms_per_step_by_kernel": {k[:80]: v for k, v in largest},
        "shuffle_peak_device_bytes": shuffle_peak,
        "step_peak_device_bytes": step_peak,
    }


def run(argv=None) -> dict:
    """Build the dataset and engine, run a warm-up epoch and ``--reps``
    timed epochs; returns the JSON record."""
    args = _parser().parse_args(argv)
    dataset = make_dataset(args.users, args.items, args.clicks, args.max_his)
    cfg = CFConfig(
        emb_dim=args.dim,
        num_negs=args.negs,
        max_his=args.max_his,
        batch_size=args.batch,
        l_r=0.01,
        clip_val=1.0,
        milestones=[10],
        seed=2022,
        neg_sampler=1,
        tile_size=args.tile,
        refresh_interval=args.refresh,
        his_refresh="subepoch",
        compute_dtype="bfloat16",
        param_dtype="bfloat16",
        update_mode=args.update_mode,
        emb_pad=args.emb_pad if args.emb_pad > args.dim else 0,
        aggregator=args.aggregator,
    )
    engine = Engine(cfg, dataset, device=args.device)
    on_card = engine.device.type == "cuda"
    threshold = scatter.DENSE_ROWS_THRESHOLD
    sorted_path = args.update_mode == "dedup" and (
        args.users > threshold and args.items > threshold
    )
    st = engine.state
    slots = list(st.opt_slots.values()) if st.opt_slots else []
    state_bytes = _bytes(
        [st.user_emb, st.item_emb, st.w0, st.user_gacc, st.item_gacc, *slots]
    )
    data_bytes = _bytes([engine.pairs, engine.his_items, engine.his_masks])
    # The per-epoch (U, d) pools, in the tables' type.
    pools_bytes = st.user_emb.numel() * st.user_emb.element_size()
    nb = -(-args.clicks // args.batch)
    stream_bytes = nb * args.batch * 4 * 3  # users, pos (int32), weight (f32)
    if on_card:
        torch.cuda.synchronize(engine.device)
        torch.cuda.reset_peak_memory_stats(engine.device)

    losses = [engine.train_one_epoch()]  # warm-up (reads the loss: syncs)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        losses.append(engine.train_one_epoch())
        times.append(time.perf_counter() - t0)
    epoch_s = float(np.median(times))

    tile = engine.cfg.tile_size
    d, b, elem = args.dim, args.batch, 2  # bf16
    pools_model_bytes = (
        args.users * args.max_his * d * elem + args.users * d * elem
    )
    per_step_bytes = (
        3 * b * d * elem               # user + pool + positive row gathers
        + tile * d * elem              # tile row gather
        + 2 * 2 * b * d * elem         # user rows: write-back + update, r+w
        + 2 * (b + tile) * d * elem    # item rows: update r+w
        + b * 4 * 3 + b * args.negs * 4  # ids, weights and draws
    )
    hbm_gb = (pools_model_bytes + nb * per_step_bytes) / 1e9
    rows_scattered = nb * (b + b + tile)
    rows_gathered = nb * (3 * b + tile) + args.users * args.max_his
    record = {
        "metric": "large_scale_epoch_time",
        "value": round(epoch_s, 3),
        "unit": "s",
        "vs_baseline": None,  # no reference number exists at this scale
        "interactions_per_sec": round(args.clicks / epoch_s),
        "users": args.users,
        "items": args.items,
        "clicks": args.clicks,
        "emb_dim": args.dim,
        "sorted_dedup_path": sorted_path,
        "update_mode": args.update_mode,
        "tile_size": tile,
        "refresh_interval": engine.cfg.refresh_interval,
        "param_dtype": engine.cfg.param_dtype,
        "his_refresh": engine.cfg.his_refresh,
        "losses": [round(l, 4) for l in losses],
        "hbm_gb_modeled": round(hbm_gb, 2),
        "hbm_gbps": round(hbm_gb / epoch_s, 1) if on_card else None,
        "hbm_peak_frac": (
            round(hbm_gb / epoch_s / H100_HBM_GBPS, 4) if on_card else None
        ),
        "rows_scattered": rows_scattered,
        "rows_gathered": rows_gathered,
        "scatter_ns_per_row_budget": round(
            epoch_s * 1e9 / max(1, rows_scattered), 1
        ),
        "device": torch.cuda.get_device_name(engine.device) if on_card else "cpu",
        "epoch_times_s": times,
        "steps": int(engine.state.step),
        "state_bytes": state_bytes,
        "data_bytes": data_bytes,
        "pools_bytes": pools_bytes,
        "epoch_stream_bytes": stream_bytes,
        "peak_device_bytes": (
            torch.cuda.max_memory_allocated(engine.device) if on_card else None
        ),
        "reduced": REDUCED,
    }
    if args.profile:
        record["profile"] = profile_steps(engine, args.profile)
    return record


def main(argv=None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
