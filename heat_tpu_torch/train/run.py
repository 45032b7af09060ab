"""The reference's whole run: epochs with a ranking evaluation at the
reference's epochs.

``reference_schedule`` is ``heat_tpu/train/run.py``'s, copied verbatim
(that module imports JAX, which this package does not).
``Engine.run_epochs_with_eval`` runs its segments: the counterpart of the
JAX package's ``make_run_fn`` with the evaluation not captured.
"""

from __future__ import annotations


def reference_schedule(
    epochs: int, eval_interval: int, start_epoch: int = 0
) -> tuple[tuple[int, bool], ...]:
    """The reference driver's epoch/eval schedule (cf/main.py:106-124):
    after epoch ``e`` (0-based), evaluate iff ``e > 0 and
    e % eval_interval == 0``. Returns ((n_epochs, eval_after), ...) with
    n_epochs summing to ``epochs``.

    ``start_epoch`` anchors the schedule at ABSOLUTE epoch indices so a
    checkpoint-resumed run evaluates at the same epochs as an
    uninterrupted one (resume at epoch 3 of 10 with interval 2 still
    evals after epochs 4, 6, 8 — not 5, 7, 9)."""
    segments: list[tuple[int, bool]] = []
    run = 0
    for e in range(start_epoch, start_epoch + epochs):
        run += 1
        if e > 0 and e % eval_interval == 0:
            segments.append((run, True))
            run = 0
    if run:
        segments.append((run, False))
    return tuple(segments)
