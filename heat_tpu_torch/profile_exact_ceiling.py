"""Exact-mode gather ceiling: table width, and R contiguous rows per id.

    python -m heat_tpu_torch.profile_exact_ceiling [--iters N]
        [--device cuda|cpu]

The port's counterpart of ``scripts/profile_exact_ceiling.py`` and the one
caller of the block-gather kernel S2 (``ops/cuda/gather.py``
``gather_blocks``), as that script is the one caller of the Pallas kernel.
At the script's shapes (91,599 items, H = 100, B = 8,192) it measures:

  a) the (B, H) = 819,200-row f32 history gather (kernel K2) and the fused
     history mean (kernel K1) at table width 64 and 128, in ms a step and
     ns a row;
  b) S2 gathering 65,536 f32 rows of width 128 from a 91,600-row table as
     65,536 / r blocks of r contiguous rows, r in {1, 2, 4, 8, 16}, in ns a
     row and ns a block: what the exact-mode history gather could reach at
     best IF random history ids had r-contiguity (they do not: this bounds
     the idea from above), beside K2 and ``index_select`` reading the same
     rows one at a time; then the same on a bf16 table of that width (the
     table type of the bench's fast path; the JAX script is f32 only).

Each S2 result is checked bit-equal against ``gather_blocks_ref`` before it
is timed. Times are medians of ``--iters`` CUDA-event timings after 3
warm-up calls; fresh ids are drawn for every call, outside the timed
region. Prints one JSON line. With ``--device cpu`` the plain versions run
and host-clock times are reported under the same keys, with ``"device":
"cpu"``: they say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from heat_tpu_torch.ops.cuda.gather import (
    gather_blocks,
    gather_blocks_ref,
    gather_rows,
    gather_rows_ref,
    history_mean_gather,
)

ITEMS, USERS, HIS, BATCH = 91_599, 52_643, 100, 8192
BLOCK_WIDTH = 128  # the f32 row width of part (b)
BLOCK_ROWS = 64 * 1024  # rows gathered per call in part (b)
BLOCK_R = (1, 2, 4, 8, 16)


def _median_ms(fn, make_args, iters: int, device: torch.device) -> float:
    """Median ms of fn(*make_args()) over ``iters`` calls after 3 warm-ups;
    the arguments are made outside the timed region."""
    times = []
    for i in range(iters + 3):
        args = make_args()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
        if i >= 3:
            times.append(ms)
    return statistics.median(times)


def history_part(device, iters, items=ITEMS, users=USERS, his=HIS,
                 batch=BATCH) -> list[dict]:
    """(a): K2 over the batch's (B, H) history ids and K1's fused mean, at
    table width 64 and 128, f32."""
    g = torch.Generator(device=device).manual_seed(7)
    his_items = torch.randint(0, items, (users, his), generator=g,
                              device=device, dtype=torch.int32)
    masks = torch.full((users,), his, dtype=torch.int32, device=device)
    rows = batch * his
    out = []
    for d in (64, 128):
        table = torch.randn(items, d, generator=g, device=device)

        def batch_ids():
            u = torch.randint(0, users, (batch,), generator=g, device=device)
            return his_items.index_select(0, u), masks.index_select(0, u)

        raw = _median_ms(
            lambda ids, _: gather_rows(table, ids.reshape(-1)),
            batch_ids, iters, device,
        )
        fused = _median_ms(
            lambda ids, lens: history_mean_gather(table, ids, lens),
            batch_ids, iters, device,
        )
        out.append({
            "width": d, "rows": rows,
            "gather_rows_ms": raw, "gather_rows_ns_per_row": raw * 1e6 / rows,
            "history_mean_ms": fused,
            "history_mean_ns_per_row": fused * 1e6 / rows,
        })
    return out


def blocks_part(device, iters, items=ITEMS, width=BLOCK_WIDTH,
                rows_total=BLOCK_ROWS, rs=BLOCK_R,
                dtype=torch.float32) -> list[dict]:
    """(b): S2 at r contiguous rows per id, beside K2 and index_select on
    the same rows, on a table of ``dtype``."""
    g = torch.Generator(device=device).manual_seed(1)
    n = items // 16 * 16 + 16  # a multiple of every r
    table = torch.randn(n, width, generator=g, device=device).to(dtype)
    out = []
    for r in rs:
        n_blocks, m = n // r, rows_total // r

        def ids():
            return (torch.randint(0, n_blocks, (m,), generator=g,
                                  device=device, dtype=torch.int32),)

        (block_ids,) = ids()
        got = gather_blocks(table, block_ids, r)
        if not torch.equal(got, gather_blocks_ref(table, block_ids, r)):
            raise AssertionError(
                f"gather_blocks disagrees with its plain version at r = {r}"
            )
        del got

        def row_ids():
            (b,) = ids()
            offs = torch.arange(r, device=device, dtype=torch.int32)
            return ((b[:, None] * r + offs[None, :]).reshape(-1).contiguous(),)

        ms = _median_ms(lambda b: gather_blocks(table, b, r), ids, iters, device)
        k2 = _median_ms(lambda i: gather_rows(table, i), row_ids, iters, device)
        lib = _median_ms(lambda i: gather_rows_ref(table, i), row_ids, iters,
                         device)
        out.append({
            "r": r, "blocks": m, "rows": m * r,
            "gather_blocks_ms": ms,
            "ns_per_row": ms * 1e6 / (m * r),
            "ns_per_block": ms * 1e6 / m,
            "gather_rows_ms": k2,
            "index_select_ms": lib,
        })
    return out


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50,
                   help="timed calls per measurement (default 50)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda)")
    # Sizes, for runs at a toy size; the defaults are the script's shapes.
    p.add_argument("--items", type=int, default=ITEMS)
    p.add_argument("--users", type=int, default=USERS)
    p.add_argument("--his", type=int, default=HIS)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--block-rows", type=int, default=BLOCK_ROWS)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False (pass --device cpu to run the plain versions)"
        )
    return {
        "metric": "exact_gather_ceiling",
        "device": (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
        "iters": args.iters,
        "history": history_part(device, args.iters, args.items, args.users,
                                args.his, args.batch),
        "blocks": blocks_part(device, args.iters, args.items,
                              rows_total=args.block_rows),
        "blocks_bf16": blocks_part(device, args.iters, args.items,
                                   rows_total=args.block_rows,
                                   dtype=torch.bfloat16),
    }


def main(argv=None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
