"""SGD learning-rate schedules (host-side, applied at epoch start).

Matches the reference Optimizer (optimizer.cpp:24-38) and its dispatch in the
engine (engine.cpp:156-160): multi-step decay if more than one milestone is
configured, otherwise periodic step decay with the single milestone as the
step size. The reference mutates its lr in place epoch by epoch; here the
schedule is a pure function of (base_lr, epoch) so resume-from-checkpoint
reproduces the same lr without replaying history.
"""

from __future__ import annotations

from typing import Sequence


def step_lr(base_lr: float, epoch: int, step_size: int, gamma: float) -> float:
    """lr decayed by gamma every ``step_size`` epochs (optimizer.cpp:24-30).

    The reference applies ``lr *= gamma`` at every epoch e > 0 with
    e % step_size == 0, cumulatively; the closed form is
    base_lr * gamma ** (epoch // step_size).
    """
    if step_size <= 0:
        return base_lr
    return base_lr * gamma ** (epoch // step_size)


def multi_step_lr(
    base_lr: float, epoch: int, milestones: Sequence[int], gamma: float
) -> float:
    """lr decayed by gamma at each milestone epoch (optimizer.cpp:32-38)."""
    return base_lr * gamma ** sum(1 for m in milestones if 0 < m <= epoch)


def scheduled_lr(
    base_lr: float, epoch: int, milestones: Sequence[int], gamma: float
) -> float:
    """Engine dispatch (engine.cpp:156-160): multi-step iff len > 1."""
    if len(milestones) > 1:
        return multi_step_lr(base_lr, epoch, milestones, gamma)
    if len(milestones) == 1:
        return step_lr(base_lr, epoch, milestones[0], gamma)
    return base_lr
