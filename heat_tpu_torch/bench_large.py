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
0.77 GB (items), the (U, d) bf16 pools another 2.05 GB (dropped over each
epoch's shuffle, whose temporaries take its memory, and taken again after
it: the captured step reads its address), history ids
0.64 GB + lengths 0.06 GB, pairs 0.32 GB, and the batch stream's buffers
0.48 GB.

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

The epochs run as the engine runs them: on the card each step is one
replay of the captured step (``Engine.train_one_epoch``).

``--profile STEPS`` adds a ``"profile"`` object, measured in the same
process after the timed epochs (see :func:`profile_steps`): wall time per
step unprofiled, device time per step by kernel under ``torch.profiler``,
the device's idle share, and the peak memory of the shuffle and of the
steps, for the eager steps and for the replayed ones.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch

from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.datasets import ClickDataset
from heat_tpu_torch.ops.cuda import gather as cuda_gather
from heat_tpu_torch.ops.cuda import scatter as cuda_scatter
from heat_tpu_torch.ops.cuda import topk as cuda_topk
from heat_tpu_torch.train import scatter
from heat_tpu_torch.train.engine import Engine

H100_HBM_GBPS = 3350.0  # NVIDIA H100 SXM data sheet, 3.35 TB/s
PROFILE_MARGIN_S = 0.01  # host pause at each edge of the traced window

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
        help="history pooling: the mean (K1), or user attention over the "
        "per-epoch pools (the history rows read by K2, pooled with the user "
        "rows as queries). self_attention needs his_refresh=step, not this "
        "harness's cached-pools shape",
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


# The port's kernels by family: the names a device trace gives their CUDA
# kernels, and the wrappers (launch counters) that launch them.
KERNEL_FAMILIES = {
    "K1": (("history_mean_kernel",), ("history_mean_gather",)),
    "K2": (("gather_rows_kernel",), ("gather_rows", "gather_blocks")),
    "K2_multi": (("gather_rows_multi_kernel",), ("gather_rows_multi",)),
    "K3": (("scatter_add_kernel",), ("scatter_add_rows", "scatter_add_update")),
    "S1": (("scatter_set_kernel", "scatter_copy_kernel"),
           ("scatter_set_rows", "scatter_set_update")),
    "K4": (("window_extract_kernel",), ("window_extract",)),
}
_FAMILY_OF_KERNEL = {k: fam for fam, (kernels, _) in KERNEL_FAMILIES.items()
                     for k in kernels}
_KERNEL_WORD = re.compile(r"\b(\w+_kernel)\b")


def kernel_family(event_name: str):
    """The family of KERNEL_FAMILIES a device event's name belongs to, or
    None for a kernel of PyTorch's own."""
    for word in _KERNEL_WORD.findall(event_name):
        if word in _FAMILY_OF_KERNEL:
            return _FAMILY_OF_KERNEL[word]
    return None


def wrapper_launches() -> dict:
    """The kernel wrappers' launch counts so far, summed by family."""
    counts = {**cuda_gather.LAUNCHES, **cuda_scatter.LAUNCHES, **cuda_topk.LAUNCHES}
    return {fam: sum(counts[w] for w in wrappers)
            for fam, (_, wrappers) in KERNEL_FAMILIES.items()}


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def profile_steps(engine: Engine, steps: int, top: int = 12) -> dict:
    """Where a step's time goes, in one process, in two forms: ``"eager"``,
    the steps one by one (``train_step`` per batch), and ``"replayed"``,
    each step one replay of the engine's captured step (on the card only;
    None on the CPU). One epoch's batch stream (under sub-epochs, the first
    sub-epoch's of a new partition, with its negative pool) and pools are
    built into the engine's buffers (their peak memory is the shuffle's).
    Per form,
    ``steps`` steps run unprofiled between two syncs (wall ms per step, and
    the steps' peak memory), then, after one step in the profiler's
    warm-up, the next ``steps`` steps of the stream run under
    ``torch.profiler`` (device ms per step: the sum of the device
    events, one stream, so no overlap; the ``top`` largest by name; how
    many device events a step made, its launches; and of those, the port's
    kernels by family of ``KERNEL_FAMILIES``, ``port_kernels_per_step``,
    beside the wrappers' launch counts over the same steps,
    ``wrapper_launches_per_step``: equal for the eager steps, 0 for the
    replayed ones, whose kernels only the trace sees). The idle share is
    1 - device / unprofiled wall. The profiled wall is reported too: the
    profiler's host overhead inflates it. The replayed form first runs one
    step untimed, which captures the graph if the epochs before have not;
    ``graph_pool_bytes`` is what the capture's memory pool holds beside the
    tensors in use, measured right after the capture. The two forms run
    the same batches; the steps train the model further. The top-level keys
    are the eager form's. On the CPU the device numbers are None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = engine.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    dedup, pool = None, (None, None)
    if engine.cfg.num_subepochs > 1:
        # The first sub-epoch of a new partition, in the buffers its replays
        # read (the grow-only stream buffers, the negative pool).
        streams = engine._bucketed_streams()
        nb, pool = next(streams)
        streams.close()
    else:
        nb = engine._make_batches(engine.pairs)[0].shape[0]
        dedup = engine._history_dedup(engine.pairs, engine._stream[0][:nb])
    users, pos, weight = engine._stream
    user_means = (
        engine._pooled_history(out=engine._pools_buffer())
        if engine.cfg.his_refresh == "subepoch" else None
    )
    sync()
    shuffle_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if 2 * steps + 1 > nb:
        raise ValueError(f"--profile {steps}: the stream has {nb} steps, at "
                         f"least {2 * steps + 1} are needed")

    def run(fn, first: int, count: int = steps) -> float:
        sync()
        t0 = time.perf_counter()
        engine.state, engine.sampler_state, _ = fn(
            engine.state, engine.sampler_state, engine.generator,
            users, pos, weight, engine.his_items, engine.his_masks,
            user_means=user_means,
            uniq_users=dedup[0] if dedup else None,
            uniq_inverse=dedup[1] if dedup else None,
            uniq_first=(dedup[2] if dedup and engine.cfg.aggregator != "mean"
                        else None),
            neg_candidates=pool[0], neg_candidates_size=pool[1],
            first=first, count=count,
        )
        sync()
        return (time.perf_counter() - t0) * 1e3 / max(1, count)

    def measure(fn) -> dict:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        wall_ms = run(fn, 0)
        step_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        # The device tracing starts in the profiler's warm-up, one step
        # that is run and not kept: an eager trace whose window opened on a
        # traced step once missed that step's first kernels.
        with profile(activities=activities, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            run(fn, steps, 1)
            prof.step()
            # The traced window is cut by host time, the kernels are stamped
            # by the device's: a replayed step's first kernels start a few
            # microseconds after the window opens, and one was once counted
            # out of it (one K2 multi launch of 50 replayed 16M x 6M direct
            # steps on an H100). The idle device waits out the skew on
            # either side.
            time.sleep(PROFILE_MARGIN_S)
            wrappers = wrapper_launches()
            profiled_wall_ms = run(fn, steps + 1)
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        wrappers = {fam: n - wrappers[fam]
                    for fam, n in wrapper_launches().items()}
        device, launches = {}, 0
        port = dict.fromkeys(KERNEL_FAMILIES, 0)
        for event in prof.key_averages():
            # The schedule's step annotation ("ProfilerStep#n") spans the
            # traced window on the device timeline too: it is no device work.
            if (event.device_type != DeviceType.CPU
                    and not event.key.startswith("ProfilerStep")):
                device[event.key] = device.get(event.key, 0.0) + (
                    event.self_device_time_total / 1e3 / steps
                )
                launches += event.count
                fam = kernel_family(event.key)
                if fam is not None:
                    port[fam] += event.count
        device_ms = sum(device.values()) if on_card else None
        largest = sorted(device.items(), key=lambda kv: -kv[1])[:top]
        return {
            "wall_ms_per_step": wall_ms,
            "profiled_wall_ms_per_step": profiled_wall_ms,
            "device_ms_per_step": device_ms,
            "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
            # Kernels, copies and memsets the device ran, per step.
            "device_launches_per_step": launches / steps if on_card else None,
            "device_ms_per_step_by_kernel": {k[:80]: v for k, v in largest},
            "port_kernels_per_step": (
                {f: n / steps for f, n in port.items()} if on_card else None),
            "wrapper_launches_per_step": {
                f: n / steps for f, n in wrappers.items()},
            "step_peak_device_bytes": step_peak,
        }

    eager = measure(engine._epoch_fn(False))
    replayed = None
    if on_card:
        fn = engine._epoch_fn(True)
        torch.cuda.reset_peak_memory_stats(dev)
        capture_ms = run(fn, 0, 1)  # captures unless the epochs already did
        capture_peak = torch.cuda.max_memory_allocated(dev)
        replayed = measure(fn)
        replayed.update(first_step_ms=capture_ms,
                        first_step_peak_device_bytes=capture_peak,
                        graph_pool_bytes=fn.graph_pool_bytes)
    return {
        "steps": steps,
        **eager,
        "shuffle_peak_device_bytes": shuffle_peak,
        "eager": eager,
        "replayed": replayed,
    }


def make_config(args: argparse.Namespace) -> CFConfig:
    """The training configuration of parsed arguments (see the module
    docstring)."""
    return CFConfig(
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


def run(argv=None) -> dict:
    """Build the dataset and engine, run a warm-up epoch and ``--reps``
    timed epochs; returns the JSON record."""
    args = _parser().parse_args(argv)
    dataset = make_dataset(args.users, args.items, args.clicks, args.max_his)
    engine = Engine(make_config(args), dataset, device=args.device)
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
        "aggregator": engine.cfg.aggregator,
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
        # Captures of the step (one unless an input's address moved).
        "captures": engine._epoch_fns[True].captures if on_card else None,
        "reduced": REDUCED,
    }
    if args.profile:
        record["profile"] = profile_steps(engine, args.profile)
    return record


def main(argv=None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
