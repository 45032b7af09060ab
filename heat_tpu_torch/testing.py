"""The comparison rule for two training states computed in different
summation orders: the CPU tests against the JAX package and
``chip_smoke.py``'s step on the card against the CPU both hold each state
array to it, so the two cannot drift apart.
"""

from __future__ import annotations

import numpy as np

SHARE = 0.995  # least share of elements within rtol / atol


def is_gradient_array(name: str) -> bool:
    """Arrays that hold gradients (the accum mode's rows, the optimizer
    slots) rather than parameters."""
    return name.endswith(("gacc", "_m", "_v"))


def assert_state_array_close(
    got, want, name: str, *, lr: float, clip_val: float,
    rtol: float = 1e-5, atol: float = 1e-7,
) -> float:
    """Raise AssertionError unless at least SHARE of the elements of ``got``
    are within ``atol + rtol * |want|`` and none is off by more than a cap:
    1e-4 * lr for tables and ``w0``, 1e-3 * clip_val for gradient arrays.

    Why a share and a cap: the per-occurrence gradients reach ~1e2 and
    cancel, and Adagrad and Adam divide a combined gradient by its own
    norm, so a few elements in a thousand carry summation-order noise
    above rtol; a wrong update moves a row by ~lr * clip_val (SGD) or ~lr
    (Adam), a wrong accumulation by ~clip_val, far above the cap.

    Returns the largest absolute difference."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    if diff.size == 0:
        return 0.0
    within = float((diff <= atol + rtol * np.abs(want)).mean())
    cap = 1e-3 * clip_val if is_gradient_array(name) else 1e-4 * lr
    worst = float(diff.max())
    if within < SHARE or not worst <= cap:  # a NaN fails the cap
        raise AssertionError(
            f"{name}: differs by up to {worst:.3g} (cap {cap:.3g}); "
            f"{within:.4f} of the elements within rtol {rtol} / atol {atol} "
            f"(at least {SHARE} required)"
        )
    return worst
