"""What one kernel launch costs the host, piece by piece.

    python -m heat_tpu_torch.profile_launch [--calls 20000]

For kernels of a few microseconds the host's path to the launch is what a
caller pays. This script times, on the host clock and per call, the pieces
that path is or was made of, so that each design decision of
``ops/cuda/_build.py`` has its number:

* the device guard as a Python context manager (``torch.cuda.device``)
  against none (the C entry points compare ``cudaGetDevice`` instead);
* PyTorch's current stream as a ``Stream`` object
  (``torch.cuda.current_stream().cuda_stream``) against the raw handle
  (``torch._C._cuda_getCurrentRawStream``);
* the C entry point looked up by a formatted name on the library against
  one dictionary lookup;
* the wrappers' contract checks alone, the three ``data_ptr`` reads, and
  the foreign call alone, without and with the kernel launch;
* the whole wrappers (K2, K3, S1 and the update entries) beside the one
  PyTorch call of each (``index_select``, ``index_add_``, ``index_copy_``)
  on 8,192 ids of a (52,643, 64) table, with the device kept busy-free (a
  synchronise every 500 calls keeps the launch queue from filling).

Prints one JSON object: microseconds per call, the card's name.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from heat_tpu_torch.ops.cuda import _build, gather, scatter


def per_call_us(fn, calls: int, sync_every: int = 500) -> float:
    """Host microseconds per call of fn(), the device drained every
    ``sync_every`` calls outside the clock."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    done = 0
    while done < calls:
        n = min(sync_every, calls - done)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
        done += n
    return total * 1e6 / calls


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=20000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_launch measures launches: it needs a CUDA device")
    dev = torch.device("cuda", 0)
    funcs = _build.library()
    n, m, d = 52_643, 8_192, 64
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "calls": args.calls}

    def t(name, fn):
        out[name] = per_call_us(fn, args.calls)

    def guarded():
        with torch.cuda.device(dev):
            pass

    t("guard_python_context_us", guarded)
    t("stream_object_us", lambda: torch.cuda.current_stream().cuda_stream)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        t("stream_raw_handle_us", lambda: raw(0))
    t("symbol_dict_lookup_us", lambda: funcs["heat_scatter_add_rows_f32"])
    # As a loaded library holds a resolved symbol: an instance attribute.
    holder = argparse.Namespace(**funcs)
    t("symbol_format_getattr_us",
      lambda: getattr(holder, f"heat_scatter_add_rows_{gather.SUFFIX[torch.float32]}"))

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        table = torch.randn(n, d, generator=g, device=dev).to(dtype)
        ids = torch.randint(0, n, (m,), generator=g, device=dev, dtype=torch.int32)
        long_ids = ids.long()
        rows = (0.01 * torch.randn(m, d, generator=g, device=dev)).to(dtype)
        grads = torch.randn(m, d, generator=g, device=dev)
        lr = torch.tensor(0.01, device=dev)

        def checks():
            gather._check("scatter_add_rows", table, ids)
            scatter._check_rows("scatter_add_rows", table, ids, rows, "deltas",
                                own_type=True)

        t(f"checks_only_scatter_add_rows_{tag}_us", checks)
        t(f"three_data_ptrs_{tag}_us",
          lambda: (table.data_ptr(), ids.data_ptr(), rows.data_ptr()))
        fn = funcs["heat_scatter_add_rows_" + tag]
        ptrs = (table.data_ptr(), ids.data_ptr(), rows.data_ptr())
        # The foreign call alone: M = 0 returns after the device guard.
        t(f"ctypes_call_no_launch_{tag}_us",
          lambda: fn(ptrs[0], n, d, ptrs[1], ptrs[2], 0, 0, None))
        stream = torch.cuda.current_stream().cuda_stream
        t(f"ctypes_call_and_launch_{tag}_us",
          lambda: fn(ptrs[0], n, d, ptrs[1], ptrs[2], m, 0, stream))
        t(f"gather_rows_{tag}_us", lambda: gather.gather_rows(table, ids))
        t(f"index_select_{tag}_us", lambda: table.index_select(0, long_ids))
        t(f"scatter_add_rows_{tag}_us",
          lambda: scatter.scatter_add_rows(table, ids, rows))
        t(f"index_add_{tag}_us", lambda: table.index_add_(0, long_ids, rows))
        t(f"scatter_set_rows_{tag}_us",
          lambda: scatter.scatter_set_rows(table, ids, rows))
        t(f"index_copy_{tag}_us", lambda: table.index_copy_(0, long_ids, rows))
        t(f"scatter_add_update_{tag}_us",
          lambda: scatter.scatter_add_update(
              table, ids, grads, lr=lr, clip_val=1.0, clip_first=True))
        t(f"scatter_set_update_{tag}_us",
          lambda: scatter.scatter_set_update(
              table, ids, grads, grads, lr=lr, clip_val=1.0))

        def unfused_add():
            inc = torch.clamp(grads, -1.0, 1.0).mul_(-lr).to(dtype)
            scatter.scatter_add_rows(table, ids, inc)

        t(f"unfused_add_update_{tag}_us", unfused_add)
    return out


def main(argv=None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
