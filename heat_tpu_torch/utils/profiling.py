"""Phase-level profiling with the reference's phase taxonomy.

The counterpart of ``heat_tpu/utils/profiling.py``: ``REFERENCE_PHASES``,
``PhaseTimer`` and ``performance_breakdown`` are copied verbatim; ``trace``
is ``torch.profiler`` where the JAX package has ``jax.profiler``.

The reference accumulates wall-clock per phase into ThreadBuffer::time_map —
15 named phases (data, f_b, forward, backward, read_emb, dot, norm, loss,
aggr_f, read_his, his_mm, grad, reg, write_emb, aggr_b) stamped inside the
kernel (thread_buffer.hpp:32-46) and reported as a percentage tree by
Engine::performance_breakdown (engine.cpp:22-65). Two tools here:

* PhaseTimer — host-side accumulation for the phases that are host-visible
  (the engine's ``data``, ``f_b`` and ``eval``), with the reference's
  percentage-tree report format. The engine ends each phase with a read of
  a device value or one ``torch.cuda.synchronize``, so a phase's time is
  the device's work in it, not the host's launch time;
* ``trace(dir)`` wraps a region in a ``torch.profiler`` trace (CPU and, on
  a card, CUDA activities), written into ``dir`` as a Chrome trace. The
  train step's regions carry the reference phase names as
  ``torch.profiler.record_function`` labels (``train/train_step.py``:
  data, read_emb, read_his, aggr_f, his_mm, dot, loss, grad, aggr_b,
  write_emb), the names the JAX step gives its ``jax.named_scope`` labels.
  The labels run in Python, so they show on eager steps (the CPU, the
  eager oracle) and on the capture's warm-up step. A step replayed from
  its CUDA graph runs no Python: its trace shows the graph's kernels by
  name (the port's CUDA kernels among them), without the labels.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

# Seconds of idle device at each edge of a trace's window (``trace``).
TRACE_MARGIN_S = 0.01

# The reference phase names (thread_buffer.hpp:32-46), for record_function.
REFERENCE_PHASES = (
    "data", "f_b", "forward", "backward", "read_emb", "dot", "norm",
    "loss", "aggr_f", "read_his", "his_mm", "grad", "reg", "write_emb",
    "aggr_b",
)


class PhaseTimer:
    """Accumulates wall-clock per named phase (host-visible phases)."""

    def __init__(self) -> None:
        self.time_map: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.time_map[name] += time.perf_counter() - t0

    def reset(self) -> None:
        self.time_map.clear()


def performance_breakdown(timer: PhaseTimer) -> str:
    """Percentage tree over accumulated phases (engine.cpp:22-65 format)."""
    total = sum(timer.time_map.values())
    if total <= 0:
        return "no phases recorded"
    lines = [f"total: {total:.3f}s"]
    for name, t in sorted(
        timer.time_map.items(), key=lambda kv: -kv[1]
    ):
        lines.append(f"  {name}: {t:.3f}s ({t / total * 100.0:.1f}%)")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profiler trace of the enclosed region (CPU activity, and CUDA
    activity when a card is present), written into ``log_dir`` as a Chrome
    trace (``*.pt.trace.json``, for TensorBoard or Perfetto). Yields the
    profiler."""
    os.makedirs(log_dir, exist_ok=True)
    card = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        # The device's events are traced from a little after the profiler
        # starts: an idle pause at each edge keeps the region's first and
        # last kernels inside the window (a replayed epoch's first two
        # steps were once missing from it).
        if card:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        yield prof
        if card:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
